"""Consensus checkpoint export: node-stacked training state -> one model.

Port of ``repro/serve/export.py``.  The paper's end product is the
consensus model x_bar = (1/n) sum_i x_i, the node average every
decentralized optimizer drives the fleet toward; params are node-stacked
``[n, ...]``, so consensus is a mean over the leading axis of every leaf.

* :func:`export_consensus` -- from a ``save_train_state`` ``.npz`` on disk
  (the reference's format), an ``api.Result`` with its final state, a
  node-stacked state (anything with ``.params``) or a bare node-stacked
  params tree; the mean is taken on the state's device.
* :func:`save_serving_checkpoint` / :func:`load_serving_checkpoint` -- the
  ``serve-v1`` npz: consensus params under ``|``-joined key paths
  (``k:params|k:blocks|i:0|k:attn|k:wq``) plus a ``__meta__`` JSON string
  holding the resolved ``ModelConfig``, so ``python -m repro_torch.serve
  --checkpoint x.npz`` needs no spec file.  The two packages read each
  other's files.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..configs.base import ModelConfig, MoEConfig, SSMConfig
from ..train.checkpoint import SEP as _SEP
from ..train.checkpoint import flatten_paths as _flatten
from ..train.checkpoint import npz_path as _npz
from ..train.checkpoint import tree_from_paths as _tree_from_paths
from ..tree import tree_map

__all__ = ["consensus_params", "export_consensus",
           "params_from_train_checkpoint", "resolve_config",
           "save_serving_checkpoint", "load_serving_checkpoint",
           "config_to_dict", "config_from_dict", "SERVE_FORMAT"]

# key-path prefix of the params subtree inside a save_train_state npz:
# {"state": TrainState, "rng": ...} -> DictKey('state') + GetAttrKey('params')
_PARAMS_PREFIX = f"k:state{_SEP}x:.params{_SEP}"

SERVE_FORMAT = "serve-v1"


def params_from_train_checkpoint(path: str, *, device="cpu"):
    """Only the node-stacked params subtree of a full-TrainState
    checkpoint (the reference's ``save_train_state`` format), as tensors on
    ``device``; the structure is rebuilt from the stored key paths (opt,
    comm state and the rng carry are ignored)."""
    data = np.load(_npz(path), allow_pickle=False)
    items = [(k[len(_PARAMS_PREFIX):].split(_SEP), data[k])
             for k in data.files if k.startswith(_PARAMS_PREFIX)]
    if not items:
        raise ValueError(
            f"{path}: no '{_PARAMS_PREFIX}*' leaves -- not a "
            f"save_train_state checkpoint")
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    _tree_from_paths(items))


# ---------------------------------------------------------------------------
# consensus
# ---------------------------------------------------------------------------

def consensus_params(params):
    """Mean over the node axis of every leaf: [n, ...] -> [...], summed in
    fp32 so that bf16 fleets average without precision loss."""
    return tree_map(lambda x: torch.mean(x.float(), dim=0).to(x.dtype),
                    params)


def resolve_config(spec) -> ModelConfig | None:
    """The ``ModelConfig`` of an experiment spec (or its ``to_dict()``
    form); None for the other models (their consensus exports still work,
    they just cannot be served by the token engine)."""
    from ..api.models import resolve_transformer_config
    from ..api.spec import ExperimentSpec

    if isinstance(spec, dict):
        spec = ExperimentSpec.from_dict(spec)
    if spec.model.name != "transformer":
        return None
    return resolve_transformer_config(spec.model)


def export_consensus(source, *, state=None, spec=None):
    """Consensus-average a node-stacked run into ``(params, cfg)``.

    ``source`` is one of:

    * a ``save_train_state`` checkpoint path -- pass ``spec`` to also
      resolve the ModelConfig (the train checkpoint stores none);
    * an ``api.Result`` -- pass the final state of ``run(spec,
      with_state=True)`` as ``state=``; cfg resolves from ``result.spec``;
    * a state with ``.params`` or a bare node-stacked params tree.
    """
    if isinstance(source, str):
        stacked = params_from_train_checkpoint(source)
    elif hasattr(source, "spec") and hasattr(source, "history"):  # Result
        if state is None:
            raise ValueError(
                "export_consensus(result) needs state=: run the spec with "
                "with_state=True and pass the returned final state")
        spec = source.spec if spec is None else spec
        stacked = state.params
    elif hasattr(source, "params"):
        stacked = source.params
    else:
        stacked = source
    cfg = resolve_config(spec) if spec is not None else None
    return consensus_params(stacked), cfg


# ---------------------------------------------------------------------------
# serving checkpoint format (params + embedded ModelConfig)
# ---------------------------------------------------------------------------

def config_to_dict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ModelConfig:
    d = dict(d)
    d["period"] = tuple(d["period"])
    if d.get("moe") is not None:
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("ssm") is not None:
        d["ssm"] = SSMConfig(**d["ssm"])
    return ModelConfig(**d)


def save_serving_checkpoint(path: str, params, cfg: ModelConfig) -> None:
    """Consensus params + ModelConfig in one npz, the reference's
    ``serve-v1`` layout; round-trips through :func:`load_serving_checkpoint`
    (and the reference's) with no side-channel spec."""
    flat = {f"k:params{_SEP}{k}": v.detach().cpu().numpy()
            for k, v in _flatten(params).items()}
    meta = {"step": 0, "extra": {"format": SERVE_FORMAT,
                                 "model_config": config_to_dict(cfg)}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_serving_checkpoint(path: str, *, device="cuda"):
    """``(params, cfg)`` from a ``serve-v1`` npz, params as tensors on
    ``device`` in ``init_lm``'s structure (checked leaf by leaf against the
    embedded config's shapes)."""
    from ..models import transformer as tf

    data = np.load(_npz(path), allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    extra = meta.get("extra", {})
    if extra.get("format") != SERVE_FORMAT:
        raise ValueError(
            f"{path}: not a serving checkpoint (format="
            f"{extra.get('format')!r}); export one with "
            f"save_serving_checkpoint")
    cfg = config_from_dict(extra["model_config"])
    # restore into init_lm's structure, built on the meta device (shapes
    # only): leaf-less containers (an empty tail tuple) leave no key paths
    like = tf.init_lm(None, cfg, device="meta")
    prefix = f"k:params{_SEP}"
    leaves = {}
    for key, leaf in _flatten(like).items():
        name = prefix + key
        if name not in data:
            raise KeyError(f"{path}: serving checkpoint missing leaf {name}")
        arr = data[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape mismatch at {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)} -- "
                             f"checkpoint and embedded ModelConfig disagree")
        leaves[key] = torch.from_numpy(np.array(arr)).to(device)
    return _rebuild(like, leaves, ""), cfg


def _rebuild(like, leaves: dict, prefix: str):
    """``like``'s structure with the leaf at each key path from ``leaves``."""
    def key(part):
        return f"{prefix}{_SEP}{part}" if prefix else part
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, key(f"k:{k}"))
                for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(_rebuild(v, leaves, key(f"i:{i}"))
                     for i, v in enumerate(like))
    return leaves[prefix]
