"""Step builders shared by the dry run and the launchers.

Port of ``repro/launch/steps.py``.  Three step kinds, matching the input
shapes:

  train_step   decentralized QG-DSGDm-N step: per-node grads (the loss
               mapped over the node axis) -> local QG half-step -> gossip ->
               buffer update.  n_nodes=1 degrades to QHM (paper §4.2) for
               the archs whose per-node copies exceed a card (DESIGN.md §5).
  prefill_step tokens [B,S] -> (last logits, KV caches)
  decode_step  one token + caches (seq_len capacity) -> (logits, caches)

The builders are closures over a :class:`StepConfig`; the spec functions
give the inputs as ``meta`` tensors (shapes and dtypes, nothing allocated),
which the dry run (``launch/dryrun.py``) traces.

Per-node gradients are ``torch.autograd.grad`` of the node losses' sum (the
loss mapped over the node axis with ``torch.func.vmap``; node i's loss
depends on node i's params only, so the sum differentiates to exact
per-node grads), as the runtimes' ``_stage_compute`` takes them.  The
reference's ``vmap(value_and_grad)`` maps to ``torch.func.vmap`` of
``torch.func.grad_and_value`` in form, but that differentiates with
``create_graph=True``, which holds every saved tensor and the backward's
own graph to the end: 2.2x the peak memory of the same step (a 4-layer
d-1024 TinyLlama cut on the CPU), and it cancels ``remat``.

The TPU knobs of the reference's ``StepConfig``, one rule each:

* ``remat="full"`` (the default, as the reference's) recomputes each
  period in the backward (``models/transformer.py``'s ``_PeriodRemat``);
  ``"none"`` keeps the activations.  The values are the same bit for bit;
  only the peak memory and the flops move.
* ``unroll``, ``cache_shard_features``, ``pin_decode_cache``,
  ``shard_tie_break_last``, ``shard_activations``, ``megatron_attn``,
  ``repeat_kv`` and ``pin_moe_dispatch`` (:data:`IGNORED_KNOBS`) steer XLA's
  scan and its sharding over a ``model`` axis.  On one card they change no
  value and no launch: they are accepted and do nothing, and every dry-run
  record lists them under ``"ignored"``.
* ``remat_attention`` and ``skip_masked_chunks`` change what the attention
  computes in the reference; the port has neither, so ``True`` raises.
* ``decode_lowp`` reaches ``tf.decode_step`` as in the reference.
* ``param_dtype`` also picks the optimizer's route (:func:`make_opt`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import gossip, topology as topo_lib
from repro_torch.core.optim import make_optimizer
from repro_torch.models import transformer as tf
from repro_torch.runtime.sharded import node_leaf_spec
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

from .roofline import H100

__all__ = ["HBM_BYTES", "NODE_BUDGET", "H100_HBM_BYTES", "H100_NODE_BUDGET",
           "IGNORED_KNOBS", "StepConfig", "choose_n_nodes",
           "train_batch_specs", "params_shape", "opt_state_shape",
           "prefill_specs", "decode_specs", "make_opt", "step_topology",
           "train_loss_fn", "node_grads", "build_train_step",
           "build_prefill_step", "build_decode_step"]

PyTree = Any

# the reference's per-chip budget that decides decentralized feasibility
# (TPU v5e: 16 GB HBM; headroom for activations); its rows only
HBM_BYTES = 16e9
NODE_BUDGET = 14e9

# the card's: H100 SXM5 data sheet, 80 GB HBM3 (``roofline.H100``); 16 GB
# of headroom for activations and the caching allocator's slack
H100_HBM_BYTES = H100.hbm_bytes
H100_NODE_BUDGET = 64e9

#: StepConfig fields that steer XLA (scan unrolling, sharding over a
#: 'model' axis) and change nothing on one card
IGNORED_KNOBS = ("unroll", "cache_shard_features", "pin_decode_cache",
                 "shard_tie_break_last", "shard_activations",
                 "megatron_attn", "repeat_kv", "pin_moe_dispatch")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    cfg: ModelConfig
    shape: InputShape
    n_nodes: int
    lr: float = 0.1
    beta: float = 0.9
    weight_decay: float = 1e-4
    chunk: int = 1024          # attention kv-chunk
    ssd_chunk: int = 256
    unroll: bool = False
    remat: str = "full"
    param_dtype: Any = torch.bfloat16
    gossip_schedule: str = "dense"   # dense | ring_ppermute | sparse_ppermute
    topology: str = "ring"           # any core/topology.get_topology name
    runtime: str = "vmap"            # vmap | sharded: 'sharded' runs one
                                     # node a rank over a NodeMesh
    skip_masked_chunks: bool = False
    cache_shard_features: bool = True
    remat_attention: bool = False
    pin_decode_cache: bool = False
    shard_tie_break_last: bool = False
    decode_lowp: bool = False           # decode attn in the cache dtype
    shard_activations: bool = False
    repeat_kv: bool = False
    megatron_attn: bool = False
    pin_moe_dispatch: bool = False


def _refuse_unported(sc: StepConfig) -> None:
    for knob in ("remat_attention", "skip_masked_chunks"):
        if getattr(sc, knob):
            raise ValueError(
                f"StepConfig.{knob}=True has no counterpart in the port: its "
                "attention computes every chunk and keeps what autograd "
                f"saves; set {knob}=False")
    if sc.remat not in tf.REMAT_MODES:
        raise ValueError(f"StepConfig.remat must be one of "
                         f"{tf.REMAT_MODES}, got {sc.remat!r}")


def choose_n_nodes(cfg: ModelConfig, mesh, *, budget: float = NODE_BUDGET,
                   param_bytes: int = 2) -> int:
    """Decentralization arity for a mesh (DESIGN.md §5 feasibility table).

    ``mesh`` is a ``launch/mesh.NodeMesh`` or a ``MeshShape``; its
    ``data`` axis carries the node index, one node a rank.  The port has
    no 'model' axis and no FSDP, so a node's x + m_hat + grads
    (``param_bytes`` each) all sit on its rank: ``n`` nodes when they fit
    ``budget``, else one (QHM).  ``budget`` is the reference's v5e figure
    by default; the dry run passes :data:`H100_NODE_BUDGET`.  A 'pod'
    axis (pods as clients, FSDP over each pod's data axis) raises."""
    axes = dict(mesh.shape)
    if "pod" in axes:
        raise ValueError(
            "a 'pod' axis makes each pod one node with its weights sharded "
            "over the pod's data axis (FSDP); the port has no FSDP: one "
            "node a rank over the 'data' axis")
    if axes.get("model", 1) != 1:
        raise ValueError(
            f"a 'model' axis of {axes['model']} shards each node's weights "
            "(tensor parallelism); the port has none: one node a rank")
    if "data" not in axes:
        warnings.warn(
            f"mesh axes {sorted(axes)} have no 'data' axis to carry the "
            "node index; falling back to n_nodes=1 (pure local QHM)")
        return 1
    n = axes["data"]
    per_rank = cfg.n_params() * param_bytes * 3
    return n if per_rank <= budget else 1


# ---------------------------------------------------------------------------
# input specs (meta tensors; nothing allocated)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(sc: StepConfig) -> dict:
    cfg, shape = sc.cfg, sc.shape
    n = sc.n_nodes
    assert shape.global_batch % n == 0
    b = shape.global_batch // n
    batch = {"tokens": _meta((n, b, shape.seq_len), torch.int32),
             "labels": _meta((n, b, shape.seq_len), torch.int32)}
    if cfg.n_image_tokens:
        batch["image_embeds"] = _meta(
            (n, b, cfg.n_image_tokens, cfg.d_model), sc.param_dtype)
    return batch


def params_shape(sc: StepConfig, *, node_stacked: bool) -> PyTree:
    base = tf.init_lm(None, sc.cfg, dtype=sc.param_dtype, device="meta")
    if not node_stacked:
        return base
    return tree_map(lambda l: _meta((sc.n_nodes,) + tuple(l.shape), l.dtype),
                    base)


def opt_state_shape(sc: StepConfig, params: PyTree) -> PyTree:
    return make_opt(sc).init(params)


def prefill_specs(sc: StepConfig) -> dict:
    cfg, shape = sc.cfg, sc.shape
    out = {"tokens": _meta((shape.global_batch, shape.seq_len), torch.int32)}
    if cfg.n_image_tokens:
        out["img"] = _meta((shape.global_batch, cfg.n_image_tokens,
                            cfg.d_model), sc.param_dtype)
    return out


def decode_specs(sc: StepConfig) -> dict:
    cfg, shape = sc.cfg, sc.shape
    return {"token": _meta((shape.global_batch, 1), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   dtype=sc.param_dtype, device="meta")}


# ---------------------------------------------------------------------------
# optimizers / gossip
# ---------------------------------------------------------------------------

def make_opt(sc: StepConfig):
    """Chain-built optimizer from the registry (``core/transforms.py``):
    QHM is the n_nodes=1 reduction (zero mix sites); QG-DSGDm-N otherwise.
    Non-dense schedules are installed by the step builder.

    The dtype rule: the optimizer kernels take fp32 leaves only, and a
    non-fp32 leaf on a CUDA device raises in the fused chain (there is no
    quiet plain path on the card).  So an fp32 ``param_dtype`` keeps
    ``fused='auto'`` (the kernels on CUDA tensors: one ``qg_step`` launch
    a plan slice on the dense mix) and any other dtype builds the chain
    with ``fused='off'``, stage by stage.  A rule on the dtype, fixed when
    the optimizer is built; nothing falls back at run time."""
    fused = "auto" if sc.param_dtype == torch.float32 else "off"
    if sc.n_nodes == 1:
        return make_optimizer("qhm", lr=sc.lr, beta=sc.beta,
                              weight_decay=sc.weight_decay, fused=fused)
    return make_optimizer("qg_dsgdm_n", lr=sc.lr, beta=sc.beta,
                          weight_decay=sc.weight_decay,
                          mix_fn=gossip.mix_dense, fused=fused)


def step_topology(sc: StepConfig) -> topo_lib.Topology:
    """The StepConfig's topology (n_nodes=1 degrades to the trivial ring)."""
    if sc.n_nodes == 1:
        return topo_lib.ring(1)
    return topo_lib.get_topology(sc.topology, sc.n_nodes)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def train_loss_fn(sc: StepConfig):
    """One node's loss ``loss(params, batch) -> 0-d``: ``tf.train_loss``
    at the StepConfig's chunks and ``remat``."""
    cfg = sc.cfg

    def loss_fn(p, batch):
        return tf.train_loss(p, batch, cfg, chunk=sc.chunk,
                             ssd_chunk=sc.ssd_chunk, remat=sc.remat)

    return loss_fn


def node_grads(sc: StepConfig, params, batch):
    """``(losses [n], grads)`` of node-stacked ``params`` on ``batch``:
    the train step's gradient half, as :func:`build_train_step` takes
    it."""
    _refuse_unported(sc)
    return _node_grads(train_loss_fn(sc), params, batch)


def _node_grads(loss_fn, params, batch):
    """``(losses [n], grads)``: the loss mapped over the node axis, and the
    gradient of the losses' sum (exact per-node grads), contiguous."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        losses = torch.func.vmap(loss_fn)(tree_unflatten(treedef, leaves),
                                          batch)
        grads = torch.autograd.grad(losses.sum(), leaves)
    return losses.detach(), tree_unflatten(
        treedef, [g.contiguous() for g in grads])


class _OnDevice:
    """The builder's constants (the mixing matrix ``W(0)``, a compiled
    plan) made once a device, on first use: the step takes its device from
    the params it is given."""

    def __init__(self, make):
        self._make, self._made = make, {}

    def __call__(self, device):
        key = torch.device(device)
        if key not in self._made:
            self._made[key] = self._make(key)
        return self._made[key]


def build_train_step(sc: StepConfig, *, mesh=None,
                     node_axis: str | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    mean loss)`` on node-stacked trees (``[n, ...]``; with
    ``runtime='sharded'`` see :func:`_build_sharded_train_step`)."""
    _refuse_unported(sc)
    topo = step_topology(sc)
    # the builder's step is phase-static (it passes t=0), so time-varying
    # topologies contribute their first phase here
    w_np = np.asarray(topo.w(0), np.float32)
    w_on = _OnDevice(lambda dev: torch.as_tensor(w_np, device=dev))
    opt = make_opt(sc)
    loss_fn = train_loss_fn(sc)

    if sc.runtime == "sharded":
        return _build_sharded_train_step(sc, topo, w_on, loss_fn, opt,
                                         mesh=mesh, node_axis=node_axis)
    if sc.runtime != "vmap":
        raise ValueError(f"StepConfig.runtime must be 'vmap' or 'sharded', "
                         f"got {sc.runtime!r}")

    # schedule selection lives in ONE resolver shared with the trainer; the
    # dense kind keeps the optimizer's gossip.mix_dense (the hook the fused
    # dispatcher matches to one qg_step launch), a compiled schedule runs as
    # local gathers over the stack, as the vmap runtime installs it
    resolved = gossip.resolve_gossip(topo, schedule=sc.gossip_schedule,
                                     mesh=mesh, node_axis=node_axis)
    plan_on = None
    if resolved.kind != "dense":
        sched = resolved.schedule or gossip.compile_gossip_schedule(topo)
        bsched = gossip.compile_block_schedule(sched, 1)
        plan_on = _OnDevice(lambda dev: bsched.on_rank(0, dev))

    def train_step(params, opt_state, batch):
        dev = tree_flatten(params)[0][0].device
        w = w_on(dev)
        step_opt = opt
        if plan_on is not None:
            step_opt = dataclasses.replace(
                opt, mix_fn=gossip.make_block_mix_fn(plan_on(dev), mesh=None,
                                                     w_ref=w, t=0))
        losses, grads = _node_grads(loss_fn, params, batch)
        with torch.no_grad():
            new_params, new_opt = step_opt.step(params, grads, opt_state,
                                                w=w, lr=sc.lr, t=0)
        return new_params, new_opt, torch.mean(losses)

    return train_step


def _build_sharded_train_step(sc: StepConfig, topo, w_on, loss_fn, opt, *,
                              mesh, node_axis):
    """The sharded-runtime variant: one node a rank over a
    ``launch/mesh.NodeMesh`` (DESIGN.md §9).  Each rank computes only its
    own node: per-node grad, the transform chain, and the compiled gossip
    rounds over the process group (``gossip.make_local_mix_fn``).

    ``train_step`` takes node-stacked trees, global (a leaf with ``n``
    rows, which it cuts to this rank's row by
    ``runtime/sharded.node_leaf_spec``, the runtimes' layout rule) or this
    rank's block (``[1, ...]``), and returns this rank's block of the new params and opt state and the loss
    averaged over the ranks; ``mesh.gather_nodes`` stacks a block back to
    ``[n, ...]``."""
    if mesh is None or node_axis is None:
        raise ValueError("StepConfig.runtime='sharded' needs mesh= and "
                         "node_axis=")
    n = topo.n
    if dict(mesh.shape).get(node_axis) != n:
        raise ValueError(
            f"runtime='sharded': mesh axis {node_axis!r} has size "
            f"{dict(mesh.shape).get(node_axis)}, topology has n={n}")
    resolved = gossip.resolve_gossip(topo, schedule=sc.gossip_schedule,
                                     mesh=mesh, node_axis=node_axis)
    if resolved.kind == "dense":
        schedule = None           # every site: the all-gather contraction
    elif resolved.schedule is not None:
        schedule = resolved.schedule
    else:                         # 'ring' carries no schedule
        schedule = gossip.compile_gossip_schedule(topo)

    def local(tree):
        return tree_map(
            lambda l: (l[mesh.rank:mesh.rank + 1]
                       if node_leaf_spec(l, n=n, axis_name=node_axis)
                       else l), tree)

    def train_step(params, opt_state, batch):
        params, opt_state, batch = local(params), local(opt_state), \
            local(batch)
        w = w_on(tree_flatten(params)[0][0].device)
        losses, grads = _node_grads(loss_fn, params, batch)
        mix = gossip.make_local_mix_fn(schedule, mesh=mesh, w_ref=w, t=0)
        with torch.no_grad():
            new_params, new_opt = dataclasses.replace(opt, mix_fn=mix).step(
                params, grads, opt_state, w=w, lr=sc.lr, t=0, n_nodes=n,
                mesh=mesh)
        loss = mesh.all_reduce(torch.mean(losses)) / n
        return new_params, new_opt, loss

    return train_step


def build_prefill_step(sc: StepConfig, *, mesh=None):
    """``prefill_step(params, tokens, img=None) -> (last logits, caches)``;
    ``mesh`` is accepted as the reference's and shards nothing."""
    _refuse_unported(sc)
    cfg = sc.cfg

    def prefill_step(params, tokens, img=None):
        return tf.prefill(params, tokens, cfg, img=img, chunk=sc.chunk,
                          ssd_chunk=sc.ssd_chunk,
                          cache_len=sc.shape.seq_len)

    return prefill_step


def build_decode_step(sc: StepConfig, *, cache_constraint=None):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``, the
    cache written in place.  ``cache_constraint`` (the reference's
    sharding pin on the decode write) has no meaning on one card: a
    non-None value raises."""
    _refuse_unported(sc)
    if cache_constraint is not None:
        raise ValueError(
            "cache_constraint pins the KV cache's sharding over a TPU mesh; "
            "the port keeps a cache whole on one card and has no sharding "
            "constraint: pass None")
    cfg = sc.cfg

    def decode_step(params, token, pos, cache):
        return tf.decode_step(params, token, pos, cache, cfg,
                              decode_lowp=sc.decode_lowp)

    return decode_step
