"""Preset registry: the paper's scenarios as named, serializable specs.

Port of ``repro/api/presets.py``, every preset of the reference: the
quickstart pair (the main path), the CV protocol, the social and
time-varying topologies, the compressed-gossip variants, the thousand-node
scenarios and the LM:

| preset                            | scenario                              |
|-----------------------------------|---------------------------------------|
| quickstart_ring16_alpha0.1_dsgdm  | quickstart grid: DSGDm-N baseline     |
| quickstart_ring16_alpha0.1_qg     | quickstart grid: QG-DSGDm-N (Table 1) |
| cifar_ring16_alpha0.1_qg          | ResNet-20/EvoNorm CV protocol (T.1)   |
| social32_alpha0.1_qg              | Davis social graph n=32 (Table 3)     |
| exp16_alpha0.1_qg                 | time-varying 1-peer exp graph (T.4)   |
| choco_topk0.01_ring16_qg          | QG-DSGDm-N + CHOCO top-1% gossip      |
| ef_signnorm_ring16_qg             | QG-DSGDm-N + EF sign+norm gossip      |
| n1024_ring                        | 1024 nodes on a ring                  |
| n1024_powerlaw                    | 1024 nodes on a power-law graph       |
| n1024_churn                       | 1024 nodes + sampling/churn scenario  |
| lm100m_ring8_alpha0.1_qg          | ~63M-param LM a node, 8 on a ring     |

The compressed presets say ``comm.backend='jnp'``, as the reference's do,
so they run the unfused path; ``--set comm.backend=auto`` puts them on the
kernels.
"""
from __future__ import annotations

from typing import Callable

from .spec import (CommSpec, DataSpec, EvalSpec, ExperimentSpec, LoopSpec,
                   ModelSpec, OptimSpec, ScenarioSpec, TopologySpec)

__all__ = ["PRESETS", "register_preset", "get", "names"]

PRESETS: dict[str, Callable[[], ExperimentSpec]] = {}


def register_preset(name: str):
    def deco(fn):
        PRESETS[name] = fn
        return fn
    return deco


def get(name: str) -> ExperimentSpec:
    """A fresh, validated spec for ``name``."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {names()}")
    return PRESETS[name]().validate()


def names() -> list[str]:
    return sorted(PRESETS)


def _quickstart(method: str, name: str, **kw) -> ExperimentSpec:
    return ExperimentSpec(
        name=name, seed=0,
        data=DataSpec(dataset="classification", alpha=0.1, batch=16,
                      n_data=4096, n_classes=20, hw=8, noise=2.5,
                      train_frac=0.5),
        topology=TopologySpec(name="ring", n=16),
        optim=OptimSpec(name=method, lr=0.1, weight_decay=1e-4),
        loop=LoopSpec(steps=150, chunk=25, log_every=50),
        model=ModelSpec(name="mlp", kwargs={"init": "quickstart"}),
        **kw)


@register_preset("quickstart_ring16_alpha0.1_dsgdm")
def _qs_dsgdm():
    return _quickstart("dsgdm_n", "quickstart_ring16_alpha0.1_dsgdm")


@register_preset("quickstart_ring16_alpha0.1_qg")
def _qs_qg():
    return _quickstart("qg_dsgdm_n", "quickstart_ring16_alpha0.1_qg")


@register_preset("cifar_ring16_alpha0.1_qg")
def _cifar():
    return ExperimentSpec(
        name="cifar_ring16_alpha0.1_qg", seed=0,
        data=DataSpec(dataset="classification", alpha=0.1, batch=8,
                      n_data=1024, n_classes=10, hw=16, noise=1.2,
                      train_frac=0.75),
        topology=TopologySpec(name="ring", n=16),
        optim=OptimSpec(name="qg_dsgdm_n", lr=0.03, weight_decay=1e-4),
        loop=LoopSpec(steps=60, warmup=5, decay_at=(0.5, 0.75)),
        model=ModelSpec(name="resnet20", kwargs={"norm": "evonorm"}))


def _bench_task(name: str, topo: TopologySpec, **kw) -> ExperimentSpec:
    steps = kw.pop("steps", 150)
    return ExperimentSpec(
        name=name, seed=0,
        data=DataSpec(dataset="classification", alpha=0.1, batch=16,
                      n_data=4096, n_classes=20, hw=8, noise=2.5),
        topology=topo,
        optim=OptimSpec(name="qg_dsgdm_n", lr=0.1, weight_decay=1e-4),
        loop=LoopSpec(steps=steps, warmup=max(1, steps // 20),
                      decay_at=(0.5, 0.75)),
        model=ModelSpec(name="mlp"),
        **kw)


@register_preset("social32_alpha0.1_qg")
def _social():
    return _bench_task("social32_alpha0.1_qg", TopologySpec(name="social", n=32))


@register_preset("exp16_alpha0.1_qg")
def _exp16():
    return _bench_task("exp16_alpha0.1_qg", TopologySpec(name="exp", n=16))


@register_preset("choco_topk0.01_ring16_qg")
def _choco():
    return _quickstart(
        "qg_dsgdm_n", "choco_topk0.01_ring16_qg",
        comm=CommSpec(compressor="topk:0.01"))


@register_preset("ef_signnorm_ring16_qg")
def _ef():
    return _quickstart(
        "qg_dsgdm_n", "ef_signnorm_ring16_qg",
        comm=CommSpec(compressor="signnorm", gamma=0.3,
                      error_feedback=True))


def _n1024(name: str, topo_name: str, **kw) -> ExperimentSpec:
    """1024-node base: Dirichlet(0.1) over 20 classes is unsatisfiable by
    resampling at this scale, so the partition uses deterministic
    redistribution; without a mesh it runs on the vmap runtime."""
    return ExperimentSpec(
        name=name, seed=0,
        data=DataSpec(dataset="classification", alpha=0.1, batch=4,
                      n_data=8192, n_classes=20, hw=8, noise=2.5,
                      train_frac=0.75, ensure_min="redistribute"),
        topology=TopologySpec(name=topo_name, n=1024),
        optim=OptimSpec(name="qg_dsgdm_n", lr=0.1, weight_decay=1e-4),
        loop=LoopSpec(steps=40, log_every=10),
        eval=EvalSpec(batch=1024),
        model=ModelSpec(name="mlp"),
        **kw)


@register_preset("n1024_ring")
def _n1024_ring():
    return _n1024("n1024_ring", "ring")


@register_preset("n1024_powerlaw")
def _n1024_powerlaw():
    return _n1024("n1024_powerlaw", "powerlaw:2.5")


@register_preset("n1024_churn")
def _n1024_churn():
    return _n1024(
        "n1024_churn", "powerlaw:2.5",
        scenario=ScenarioSpec(enabled=True, seed=7, participation=0.8,
                              dropout=0.1, churn_window=5, straggler=0.05))


@register_preset("lm100m_ring8_alpha0.1_qg")
def _lm100m():
    """The NLP protocol as the repo runs it: 8 nodes on a ring, each a
    TinyLlama-shaped LM of 8 layers at d_model 768 (62,927,616 parameters),
    on Dirichlet(0.1)-split bigram domains."""
    return ExperimentSpec(
        name="lm100m_ring8_alpha0.1_qg", seed=0,
        data=DataSpec(dataset="lm_domains", alpha=0.1, batch=2, seq_len=128),
        topology=TopologySpec(name="ring", n=8),
        optim=OptimSpec(name="qg_dsgdm_n", lr=0.02, weight_decay=1e-4),
        loop=LoopSpec(steps=200, chunk=10, warmup=10, decay_at=(0.5, 0.75),
                      log_every=20),
        eval=EvalSpec(enabled=False),
        model=ModelSpec(name="transformer", kwargs={
            "arch": "tinyllama-1.1b",
            "overrides": {"name": "llama-100m", "n_layers": 8,
                          "d_model": 768, "n_heads": 12, "n_kv_heads": 4,
                          "head_dim": 64, "d_ff": 2048, "vocab_size": 8192,
                          "mesh_divisor": 1},
            "chunk": 128}))
