"""The FLOP counts behind ``mfu_pct`` and the byte count behind
``qg_step_roofline_pct`` against counts made by hand."""
import json
import math

import pytest

from perfbench import harness, tree_paths, yardstick


def _conf(name):
    return json.loads((harness.ROOT / "perfbench" / "configs" /
                       f"{name}.json").read_text())


def _mix(name):
    return json.loads((harness.ROOT / "perfbench" / "traffic" /
                       f"{name}.json").read_text())


def _family(conf):
    return harness.Cell("t", harness.ROOT, conf, {}, {}, 1, [], []).family


def test_resnet20_flops():
    # multiply-adds of one 32x32 image: stem 442,368; stage 1 six convs
    # 14,155,776; stages 2 and 3 13,107,200 each (a stride-2 conv, a 1x1
    # projection, five 3x3 convs); the head 640
    macs = 442_368 + 14_155_776 + 2 * 13_107_200 + 640
    conf = _conf("resnet20-cifar10")
    got = _family(conf).flops_per_step(conf, _mix("ring16_b32"))
    assert got == 2 * macs * 3 * 16 * 32 == 125_378_101_248


@pytest.mark.parametrize("mix, tokens", [("ring8_b1x1024", 8_192),
                                         ("ring16_b2x128", 4_096)])
def test_mamba2_flops(mix, tokens):
    # weights a token: in_proj 768 x 3352, conv 4 x 1792, out_proj 1536 x
    # 768, over 24 layers, and the tied head 768 x 50277
    weights = 24 * (2_574_336 + 7_168 + 1_179_648) + 38_612_736
    assert weights == 128_880_384
    scan = 24 * 24 * (5 * 128 * 64 + 3 * 64 + 2)
    conf = _conf("mamba2-130m")
    got = _family(conf).flops_per_step(conf, _mix(mix))
    assert got == (6 * weights + 3 * scan) * tokens


@pytest.mark.parametrize("name, per_node", [("resnet20-cifar10", 272_970),
                                            ("mamba2-130m", 129_020_352)])
def test_tree_elements(name, per_node):
    """The weights' tree has the element count counted by hand (ResNet-20:
    convs 270,256, 19 EvoNorms 2,064, the head 650; mamba2-130m: the
    embedding 50432 x 768, 24 layers of 3,761,992, the final norm 768),
    and ``qg_step`` moves 20 bytes an element."""
    conf = _conf(name)
    params, _ = _family(conf).init_params(conf, None, "meta")
    got = sum(math.prod(v.shape) for v in
              tree_paths.flatten(params).values())
    assert got == per_node
    assert yardstick.qg_step_bytes(16 * got) == 20 * 16 * per_node
