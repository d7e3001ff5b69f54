"""Model/loss plugins for the declarative experiment layer.

Port of ``repro/api/models.py``: the MLP, ResNet-20 and the transformer
LM (any ``configs/`` arch).  A plugin is a
factory ``factory(spec, task) -> ModelBundle`` registered under a name.
Where the reference writes one node's functions and vmaps them, the port's
work on the node-stacked layout directly:

* ``init_fn(generator) -> (params, model_state)`` for ONE node, drawn on the
  CPU from the ``torch.Generator`` (the trainer stacks it to ``[n, ...]``);
* ``loss_fn(params, mstate, batch) -> (loss [n], (mstate, metrics))`` with
  params ``[n, ...]`` and batch ``[n, B, ...]``;
* ``eval_fn(params, mstate, batch) -> {metric_sums [n]..., 'count' [n]}``
  with one batch ``[B, ...]`` shared by every node.

``jax.random`` draws cannot be reproduced in torch, so standalone runs draw
the init from a ``torch.Generator`` at the reference's scales, and parity
runs inject the reference's init (``repro_torch.interop``).  The
``transformer`` plugin writes one node's loss and maps it over the node
axis with ``torch.func.vmap``, so each matrix product runs once for all
nodes, batched.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["ModelBundle", "MODELS", "MODEL_DATASETS", "register_model",
           "model_vocab", "resolve_transformer_config"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    init_fn: Callable
    loss_fn: Callable
    eval_fn: Optional[Callable] = None


MODELS: dict[str, Callable[..., ModelBundle]] = {}

#: datasets each built-in plugin can consume (spec.validate() cross-check)
MODEL_DATASETS: dict[str, tuple[str, ...]] = {
    "mlp": ("classification",),
    "resnet20": ("classification",),
    "transformer": ("lm_domains",),
}


def register_model(name: str):
    def deco(fn):
        MODELS[name] = fn
        return fn
    return deco


def _pop_kwargs(spec, allowed: dict) -> dict:
    kw = dict(spec.model.kwargs)
    out = {k: kw.pop(k, default) for k, default in allowed.items()}
    if kw:
        raise ValueError(
            f"model {spec.model.name!r}: unknown kwargs {sorted(kw)}; "
            f"valid: {sorted(allowed)}")
    return out


def _ce(logits, yb):
    """Mean cross-entropy over the batch axis: logits [n, B, C], yb [n, B]
    -> [n]."""
    picked = torch.gather(logits, -1, yb.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, -1) - picked, dim=-1)


@register_model("mlp")
def _mlp(spec, task) -> ModelBundle:
    """One-hidden-layer ReLU MLP on flattened images.  ``init='lecun'``
    (1/sqrt(fan-in)) or ``init='quickstart'`` (the quickstart's fixed
    scales)."""
    kw = _pop_kwargs(spec, {"width": 64, "init": "lecun"})
    width, init = int(kw["width"]), kw["init"]
    d_in, classes = task.d_in, task.n_classes
    if init == "quickstart":
        s1, s2 = 0.05, 0.1
    elif init == "lecun":
        s1, s2 = 1.0 / np.sqrt(d_in), 1.0 / np.sqrt(width)
    else:
        raise ValueError(f"mlp: unknown init {init!r}; 'lecun' | 'quickstart'")

    def init_fn(generator):
        return ({"w1": torch.randn(d_in, width, generator=generator) * s1,
                 "b1": torch.zeros(width),
                 "w2": torch.randn(width, classes, generator=generator) * s2,
                 "b2": torch.zeros(classes)}, {})

    def apply(p, xb):
        """Images [..., hw, hw, c] (node-stacked or shared) -> logits
        [n, B, classes]."""
        h = torch.relu(torch.matmul(xb.flatten(-3), p["w1"])
                       + p["b1"][:, None, :])
        return torch.matmul(h, p["w2"]) + p["b2"][:, None, :]

    def loss_fn(p, ms, batch):
        xb, yb = batch
        return _ce(apply(p, xb), yb), ({}, {})

    def eval_fn(p, ms, batch):
        xb, yb = batch
        logits = apply(p, xb)
        yi = yb.long().expand(logits.shape[:2])
        nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                            yi[..., None])[..., 0]
        n = logits.shape[0]
        return {"acc": torch.sum(torch.argmax(logits, -1) == yi, dim=-1),
                "eval_loss": torch.sum(nll, dim=-1),
                "count": torch.full((n,), float(yb.shape[0]),
                                    device=logits.device)}

    return ModelBundle(init_fn, loss_fn, eval_fn)


@register_model("resnet20")
def _resnet20(spec, task) -> ModelBundle:
    """The paper's CV substrate: ResNet-20 with EvoNorm, GN or BN (BN's
    running statistics per node, in the model state, never gossiped)."""
    from repro_torch.models import resnet

    kw = _pop_kwargs(spec, {"norm": "evonorm", "width": 1})
    norm, width = kw["norm"], int(kw["width"])

    def init_fn(generator):
        return resnet.init_resnet20(generator, norm=norm, width=width,
                                    num_classes=task.n_classes)

    def loss_fn(p, s, batch):
        xb, yb = batch
        logits, ns = resnet.apply_resnet20(p, s, xb, norm=norm, train=True)
        return _ce(logits, yb), (tree_map(torch.Tensor.detach, ns), {})

    def eval_fn(p, s, batch):
        xb, yb = batch
        logits, _ = resnet.apply_resnet20(p, s, xb, norm=norm, train=False)
        n = logits.shape[0]
        return {"acc": torch.sum(torch.argmax(logits, -1) == yb.long(),
                                 dim=-1),
                "count": torch.full((n,), float(yb.shape[0]),
                                    device=logits.device)}

    return ModelBundle(init_fn, loss_fn, eval_fn)


_TRANSFORMER_KW = {"arch": "tinyllama-1.1b", "reduced": False,
                   "overrides": None, "chunk": None, "ssd_chunk": None}


def resolve_transformer_config(model_spec):
    """ModelSpec -> ModelConfig (arch lookup, ``reduced``, field
    overrides).  Shared with the ``lm_domains`` data builder, which reads
    the vocab off it, and with the serving export."""
    from repro_torch.configs import get_config

    kw = dict(model_spec.kwargs)
    arch = kw.get("arch", _TRANSFORMER_KW["arch"])
    cfg = get_config(arch, reduced=bool(kw.get("reduced", False)))
    overrides = kw.get("overrides") or {}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def model_vocab(spec) -> int | None:
    """The vocab the model expects, for data builders (None: no vocab)."""
    if spec.model.name == "transformer":
        return resolve_transformer_config(spec.model).vocab_size
    return None


@register_model("transformer")
def _transformer(spec, task) -> ModelBundle:
    """A decoder LM trained on next-token cross-entropy.  Batches are
    ``(tokens [n, B, S+1],)``: inputs are the first S positions, labels the
    last S.  Training runs the plain chunked attention under autograd (the
    flash kernel has no backward), as the reference trains without
    ``use_pallas``; the MoE balance loss enters each node's loss through
    ``train_loss``, and a VLM sees a numpy image stub drawn from the task's
    seed, as in the reference.  There is no eval protocol."""
    from repro_torch.models import transformer as tf

    kw = _pop_kwargs(spec, _TRANSFORMER_KW)
    cfg = resolve_transformer_config(spec.model)
    fwd_kw = {}
    if kw["chunk"] is not None:
        fwd_kw["chunk"] = int(kw["chunk"])
    if kw["ssd_chunk"] is not None:
        fwd_kw["ssd_chunk"] = int(kw["ssd_chunk"])

    # the VLM's image embeddings: a stub drawn as the reference draws it
    # (bit-equal), shared by every node and batch row
    img = None
    if cfg.n_image_tokens:
        rng = np.random.default_rng(task.seed)
        img = torch.from_numpy(rng.normal(
            size=(cfg.n_image_tokens, cfg.d_model)).astype(np.float32))

    def init_fn(generator):
        return tf.init_lm(generator, cfg), {}

    def node_loss(p, toks, *image):
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if image:
            batch["image_embeds"] = image[0].expand(toks.shape[0],
                                                    *image[0].shape)
        return tf.train_loss(p, batch, cfg, **fwd_kw)

    per_node = torch.func.vmap(node_loss, in_dims=(0, 0) + (None,) * (
        img is not None))
    on_device = {}

    def loss_fn(params, ms, batch):
        (toks,) = batch
        image = ()
        if img is not None:
            if toks.device not in on_device:
                on_device[toks.device] = img.to(toks.device)
            image = (on_device[toks.device],)
        return per_node(params, toks.long(), *image), ({}, {})

    return ModelBundle(init_fn, loss_fn, eval_fn=None)
