"""Per-round client sampling (partial participation) for scenario runs.

Port of ``repro/scenario/sampling.py``.  Each node participates in a round
with probability ``p``, independently.  The mask is a pure function of
``(scenario seed, step, node id)``: the round key folds the stream tag and
the step into the scenario key, then each node's global id, and draws one
scalar Bernoulli from the node's key.  Any id subset is computable without
the full ``[n]`` mask (``ids=``), and node ``g`` sees the same draw either
way.

The reference draws through ``jax.random`` (threefry2x32).  This module
computes the same integer function with numpy, so its masks equal the
reference's bit for bit under JAX's default
``jax_threefry_partitionable=True``:

* ``PRNGKey(s)`` is the pair ``(0, s)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* a scalar Bernoulli takes ``bits = b0 ^ b1`` of ``threefry2x32(k, (0,
  0))``, ``u = float32((bits >> 9) | 0x3F800000) - 1`` and ``draw = u <
  p``.

Every function broadcasts over arrays of keys, steps and ids, so a chunk's
masks (``[k steps, n]``) are one vectorised call on the host.
"""
from __future__ import annotations

import numpy as np

__all__ = ["participation_mask", "per_node_bernoulli", "threefry2x32",
           "prng_key", "fold_in"]

# stream tag: keeps the participation draw independent of the churn /
# straggler draws that fold the same scenario key (see faults.py)
_TAG = 0x5A3B

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, count: tuple) -> tuple:
    """Threefry-2x32 (20 rounds) of the counter pair ``count`` under the key
    pair ``key`` (``[..., 2]`` uint32); every operand broadcasts.  Returns
    the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    k2 = k0 ^ k1 ^ _U32(0x1BD11BDA)
    ks = (k0, k1, k2)
    with np.errstate(over="ignore"):
        x0 = np.asarray(count[0], _U32) + k0
        x1 = np.asarray(count[1], _U32) + k1
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): ``(0, seed)``."""
    return np.array([0, seed], _U32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``[..., 2]`` keys, ``data`` any
    int32 array broadcast against the keys' leading shape."""
    data = np.asarray(data).astype(np.int32).view(_U32)
    b0, b1 = threefry2x32(key, (np.zeros_like(data), data))
    return np.stack(np.broadcast_arrays(b0, b1), axis=-1)


def per_node_bernoulli(k: np.ndarray, ids, p: float) -> np.ndarray:
    """One Bernoulli(p) draw per node id from round key ``k`` (``[..., 2]``):
    fold each id into the key, draw a scalar.  ``ids`` broadcasts against
    the keys' leading shape (``k[:, None]`` with ``ids`` ``[n]`` gives
    ``[steps, n]``).  Returns float32 0/1."""
    nk = fold_in(k, ids)
    b0, b1 = threefry2x32(nk, (_U32(0), _U32(0)))
    u = ((b0 ^ b1) >> _U32(9) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return (u < np.float32(p)).astype(np.float32)


def round_key(key: np.ndarray, tag: int, t) -> np.ndarray:
    """The key of round(s) ``t`` of a tagged stream: ``fold_in(fold_in(key,
    tag), t)``, with a trailing node axis (``[..., 1, 2]``) so that
    :func:`per_node_bernoulli` broadcasts it against a node-id vector."""
    k = fold_in(fold_in(key, tag), np.asarray(t, np.int32))
    return k[..., None, :]


def participation_mask(key: np.ndarray, t, n: int, p: float,
                       ids=None) -> np.ndarray:
    """Float mask, 1 = node sampled into round ``t``: ``[n]``, or ``ids``'
    shape for a node-id subset (the same per-node draws either way).  ``t``
    may be an array of steps, giving ``[len(t), n]``."""
    if ids is None:
        ids = np.arange(n)
    return per_node_bernoulli(round_key(key, _TAG, t), np.asarray(ids), p)
