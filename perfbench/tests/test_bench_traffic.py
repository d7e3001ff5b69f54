"""Each traffic generator repeats exactly for one seed and differs for
another, and the first three steps read rows that all differ."""
import json

import numpy as np
import pytest

from perfbench import harness

MIXES = sorted(p.stem for p in (harness.ROOT / "perfbench" /
                                "traffic").glob("*.json"))
CONFIG_OF = {"images": "resnet20-cifar10", "tokens": "mamba2-130m"}


def _small(mix_name):
    mix = json.loads((harness.ROOT / "perfbench" / "traffic" /
                      f"{mix_name}.json").read_text())
    conf = json.loads((harness.ROOT / "perfbench" / "configs" /
                       f"{CONFIG_OF[mix['generator']]}.json").read_text())
    mix["distinct_batches"] = 4
    if "pool" in mix:
        mix["pool"] = 2048
    if "seq_len" in mix:
        mix["seq_len"] = min(mix["seq_len"], 64)
    gen = harness.Cell("t", harness.ROOT, conf, mix, {}, 1, [], []).traffic
    return lambda seed: gen.batches(mix, conf, seed), mix


@pytest.mark.parametrize("mix_name", MIXES)
def test_seed_repeats_and_differs(mix_name):
    make, mix = _small(mix_name)
    a, b, c = make(2**31 + 5), make(2**31 + 5), make(7)
    assert len(a) == mix["distinct_batches"]
    for x, y, z in zip(a, b, c):
        for u, v, w in zip(x, y, z):
            assert u.shape[:2] == (mix["nodes"], mix["batch"])
            np.testing.assert_array_equal(u, v)
        assert not all(np.array_equal(u, w) for u, w in zip(x, z))


@pytest.mark.parametrize("mix_name", MIXES)
def test_first_steps_rows_differ(mix_name):
    make, mix = _small(mix_name)
    first = np.concatenate([b[0].reshape(mix["nodes"] * mix["batch"], -1)
                            for b in make(11)[:harness.CHECKED_STEPS]])
    assert len(np.unique(first, axis=0)) == len(first)
