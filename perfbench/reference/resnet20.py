"""ResNet-20 with EvoNorm-S0 on CIFAR-shaped images: the benchmark's
weights, its plain reference and its model FLOPs.

The network (He et al., arXiv:1512.03385 §4.2: n = 3, 16/32/64 channels,
a 3x3 stem, three stages of three two-conv residual blocks, the first of
stages 2 and 3 at stride 2 with a 1x1 projection, global average pool,
one linear layer) with EvoNorm-S0 (Liu et al., arXiv:2004.02967:
``x * sigmoid(v * x) / std_group(x) * scale + bias``, no activation of its
own after it) as the paper's CV protocol runs it: two channel groups, the
biased variance, eps 1e-5 inside the root, and convs padded as XLA's
``SAME`` (a stride-2 conv on an even size pads (0, 1)).

The parameter tree is the one the port's ``resnet20`` model takes, leaf for
leaf (conv weights HWIO ``[k, k, cin, cout]``), so that the same weights
are handed to the program and to this reference. The reference is one
node's model on ``[B, C, H, W]`` images with plain ``F.conv2d``; it
imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _blocks():
    """(name, stage, stride) of the nine residual blocks."""
    return [(f"s{s}b{b}", s, 2 if (s > 0 and b == 0) else 1)
            for s in range(3) for b in range(3)]


def _leaves(config: dict):
    """(path, shape, rule) of every leaf, in the tree's order: ``he`` and
    ``head`` draw normals, ``one`` and ``zero`` are constants."""
    c_in, stages = config["channels"], config["stage_channels"]
    out = [(("stem",), (3, 3, c_in, stages[0]), "he")]
    norm = lambda path, c: [(path + ("scale",), (c,), "one"),
                            (path + ("bias",), (c,), "zero"),
                            (path + ("v",), (c,), "one")]
    out += norm(("stem_norm",), stages[0])
    cin = stages[0]
    for name, s, stride in _blocks():
        cout = stages[s]
        out.append(((name, "conv1"), (3, 3, cin, cout), "he"))
        out += norm((name, "norm1"), cout)
        out.append(((name, "conv2"), (3, 3, cout, cout), "he"))
        out += norm((name, "norm2"), cout)
        if stride != 1 or cin != cout:
            out.append(((name, "proj"), (1, 1, cin, cout), "he"))
        cin = cout
    out.append((("head",), (cin, config["classes"]), "head"))
    out.append((("head_b",), (config["classes"],), "zero"))
    return out


def init_params(config: dict, generator: torch.Generator, device) -> tuple:
    """One node's ``(params, model_state)``: He-normal convs, a
    ``1/sqrt(64)`` normal head, EvoNorm's scale and v at 1 and its bias at
    0, drawn with one normal call on ``device`` from ``generator``."""
    leaves = _leaves(config)
    drawn = [l for l in leaves if l[2] in ("he", "head")]
    noise = torch.randn(sum(math.prod(s) for _, s, _ in drawn),
                        generator=generator, device=device)
    params: dict = {}
    off = 0
    for path, shape, rule in leaves:
        if rule in ("he", "head"):
            fan_in = math.prod(shape[:-1])
            scale = math.sqrt(2.0 / fan_in) if rule == "he" \
                else 1.0 / math.sqrt(fan_in)
            n = math.prod(shape)
            leaf = noise[off:off + n].reshape(shape) * scale
            off += n
        else:
            leaf = torch.full(shape, 1.0 if rule == "one" else 0.0,
                              device=device)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    # EvoNorm keeps no statistics: the model state the program takes is
    # an empty tree a norm
    state = {"stem_norm": {}}
    state.update({name: {"norm1": {}, "norm2": {}} for name, _, _ in
                  _blocks()})
    return params, state


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(h, w, stride: int = 1):
    """``h`` [B, cin, H, W] through HWIO ``w``, padded as ``SAME``."""
    k = w.shape[0]
    top, bottom = _same_pads(h.shape[2], k, stride)
    left, right = _same_pads(h.shape[3], k, stride)
    h = F.pad(h, (left, right, top, bottom))
    return F.conv2d(h, w.permute(3, 2, 0, 1), stride=stride)


def _evonorm(h, p, groups: int = 2, eps: float = 1e-5):
    b, c, hh, ww = h.shape
    var = h.reshape(b, groups, c // groups, hh, ww).var(
        dim=(2, 3, 4), correction=0)
    std = torch.sqrt(var + eps).repeat_interleave(c // groups, dim=1)
    chan = lambda t: t.reshape(1, c, 1, 1)
    y = h * torch.sigmoid(chan(p["v"]) * h) / std[:, :, None, None]
    return y * chan(p["scale"]) + chan(p["bias"])


def node_loss(config: dict, params: dict, batch: tuple) -> torch.Tensor:
    """One node's mean cross-entropy over its images ``x`` [B, H, W, C]
    with labels ``y`` [B]."""
    x, y = batch
    h = _evonorm(_conv(x.permute(0, 3, 1, 2), params["stem"]),
                 params["stem_norm"])
    for name, _, stride in _blocks():
        p = params[name]
        out = _evonorm(_conv(h, p["conv1"], stride), p["norm1"])
        out = _evonorm(_conv(out, p["conv2"]), p["norm2"])
        h = out + (_conv(h, p["proj"], stride) if "proj" in p else h)
    logits = h.mean(dim=(2, 3)) @ params["head"] + params["head_b"]
    return F.cross_entropy(logits, y.long())


def flops_per_step(config: dict, mix: dict) -> float:
    """Model FLOPs of one training step of every node: 2 a multiply-add
    of every conv and of the classifier, forward, times 3 for forward and
    backward, times the images of all nodes. Norms, adds and the pool are
    not counted."""
    hw, c_in, stages = (config["image_hw"], config["channels"],
                        config["stage_channels"])
    macs = hw * hw * 9 * c_in * stages[0]
    cin, size = stages[0], hw
    for _, s, stride in _blocks():
        cout = stages[s]
        out = -(-size // stride)
        macs += out * out * 9 * cin * cout + out * out * 9 * cout * cout
        if stride != 1 or cin != cout:
            macs += out * out * cin * cout
        cin, size = cout, out
    macs += cin * config["classes"]
    return 2.0 * macs * 3 * mix["nodes"] * mix["batch"]
