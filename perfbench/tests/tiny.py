"""Cells of the benchmark's configurations at sizes a CPU test holds:
the same families, generators and limits, cut in width and depth."""
from __future__ import annotations

import copy
import json

from perfbench import harness


def _load(path):
    with open(harness.ROOT / path) as f:
        return json.load(f)


def resnet_cell() -> harness.Cell:
    config = _load("perfbench/configs/resnet20-cifar10.json")
    config["image_hw"] = 8
    mix = _load("perfbench/traffic/ring16_b32.json")
    mix.update(nodes=4, batch=4, pool=256, distinct_batches=6)
    return _cell("tiny_resnet", config, mix, "r20_cifar10_ring16_b32")


def mamba_cell() -> harness.Cell:
    config = _load("perfbench/configs/mamba2-130m.json")
    config.update(d_model=128, n_layer=2, d_state=16, headdim=16,
                  vocab_size=512, vocab_rows=512)
    config["program"]["model"]["kwargs"] = {
        "arch": "mamba2-130m", "reduced": True, "ssd_chunk": 16,
        "overrides": {"tie_embeddings": True}}
    mix = _load("perfbench/traffic/ring16_b2x128.json")
    mix.update(nodes=4, batch=2, seq_len=32, domains=4, distinct_batches=6)
    return _cell("tiny_mamba", config, mix, "mamba2_130m_ring16_b2x128")


def _cell(name, config, mix, limits_of) -> harness.Cell:
    bench = _load("BENCHMARK.json")
    return harness.Cell(
        name=name, root=harness.ROOT, config=copy.deepcopy(config), mix=mix,
        limits=_load(f"perfbench/limits/{limits_of}.json"), chips=1,
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
