"""Carry the reference's arrays into the port.

``jax.random`` streams cannot be reproduced in torch, so a run that is to be
held against the JAX package takes that package's init (or any state) as
numpy and starts from it.  The functions take nested dicts of numpy arrays
with the JAX package's key names (and, for the LM, the tuples it keeps per
period position); the caller converts on the JAX side (``np.asarray``), so
this module needs nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.train.trainer import TrainState
from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "train_state_from_numpy"]


def params_from_numpy(tree, device):
    """A tree (dicts, and tuples as the LM keeps per period position) of
    numpy arrays -> the same tree of tensors on ``device`` (dtypes kept,
    data copied)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def train_state_from_numpy(params, opt_state, t, device,
                           comm_state=None, model_state=None) -> TrainState:
    """A :class:`TrainState` on ``device`` from the reference's node-stacked
    ``params`` (an LM's with its tuples), its ``opt_state``, step counter
    ``t``, for compressed gossip its ``comm_state`` (a list of per-site
    dicts of numpy trees), and its ``model_state`` (BN's per-node running
    statistics; None: empty, as for the MLP)."""
    if comm_state is not None:
        comm_state = [params_from_numpy(site, device) for site in comm_state]
    return TrainState(params=params_from_numpy(params, device),
                      opt_state=params_from_numpy(opt_state, device),
                      model_state=params_from_numpy(model_state or {},
                                                    device),
                      t=torch.tensor(int(t), dtype=torch.int32,
                                     device=device),
                      comm_state=comm_state)
