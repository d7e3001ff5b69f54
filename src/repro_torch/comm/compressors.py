"""Gossip-message compressors over node-stacked trees.

Port of ``repro/comm/compressors.py``.  Every compressor maps a node-stacked
leaf ``x[n_nodes, ...]`` to the dense *decompressed* value each neighbour
would reconstruct after receiving the compressed wire message.  Compression
is applied per node and per leaf on the flattened feature axis, so a leaf
``[n, ...]`` is ``n`` independent messages of ``d = prod(shape[1:])``
elements.  Leaves are visited in sorted-key order, as the reference's
``jax.tree`` visits a dict.

Two families, with the constants CHOCO/EF theory needs as methods:

* **contractive** (top-k, sign+norm): ``E||C(x) - x||^2 <= (1-delta)||x||^2``
  with ``delta = self.delta(d) in (0, 1]``;
* **unbiased** (random-k, QSGD): ``E[C(x)] = x`` and
  ``E||C(x) - x||^2 <= omega ||x||^2``; ``C/(1+omega)`` is then contractive
  with ``delta = 1/(1+omega)``, which ``contractive_compress`` returns and
  CHOCO consumes.

``wire_bits(d)`` is the wire cost of one compressed d-element message; the
dense baseline is ``32 * d``.

**Randomness.** The reference draws random-k's mask and QSGD's ``u`` from a
``jax.random`` key split per leaf, a stream torch cannot reproduce.  Here
``noise_2d(gen, x2d)`` draws them from an explicit ``torch.Generator`` on
the tensors' device, leaf after leaf, and every tree method takes either
the generator or ``noise=``, a list of per-leaf draws in leaf order (None
for the compressors that draw nothing), so that a test can hand in the
reference's own draws.

**Backends.** ``backend='jnp'`` is the reference's unfused path: the plain
PyTorch expressions of ``kernels/ref.py``, leaf by leaf, on whatever device.
``'pallas'`` (and ``'auto'``, which ``make_compressor`` resolves to it) goes
through ``kernels/ops.py``: top-k's mask+residual and QSGD's
quantize/dequantize+residual of every leaf of a tree run as one grouped
launch of a CUDA kernel on CUDA tensors, and as the plain version on CPU
tensors.  The two paths agree to the bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

Tree = Any

__all__ = [
    "Compressor", "Identity", "TopK", "RandomK", "SignNorm", "QSGD",
    "make_compressor", "tree_wire_bits", "VALID_COMPRESSOR_FORMS",
]

#: the compressor backends of the reference's ``CommSpec.backend``
BACKENDS = ("jnp", "pallas", "auto")


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] -> [n, d] (node-stacked message matrix)."""
    return x.reshape(x.shape[0], -1)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true fp32 division on ``x``'s device (PyTorch turns
    ``tensor / python_scalar`` into a product with the reciprocal on CUDA,
    which rounds differently from the reference's division)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _per_leaf(tree: Tree, noise: Optional[list]) -> list:
    leaves = tree_leaves(tree)
    if noise is None:
        return [None] * len(leaves)
    if len(noise) != len(leaves):
        raise ValueError(f"noise has {len(noise)} entries for "
                         f"{len(leaves)} leaves")
    return list(noise)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base compressor.  Subclasses implement ``compress_2d`` (and
    ``noise_2d`` if they draw); the tree plumbing, residuals and
    contraction damping live here."""

    backend: str = "jnp"  # 'jnp' | 'pallas'
    name: str = "identity"
    unbiased: bool = False

    # -- per-message (2D) implementation -----------------------------------
    def noise_2d(self, gen: Optional[torch.Generator],
                 x2d: torch.Tensor) -> Optional[torch.Tensor]:
        """The random draw one [n, d] message matrix needs (None here)."""
        return None

    def compress_2d(self, x2d: torch.Tensor, noise=None) -> torch.Tensor:
        raise NotImplementedError

    def compress_2d_with_residual(self, x2d: torch.Tensor, noise=None):
        """(C(x), x - C(x)); kernel-backed compressors override this so the
        kernel's residual output is consumed instead of recomputed."""
        q = self.compress_2d(x2d, noise)
        return q, x2d.to(q.dtype) - q

    # -- constants ----------------------------------------------------------
    def delta(self, d: int) -> float:
        """Contraction factor of ``contractive_compress`` on d-element
        messages: E||C(x)-x||^2 <= (1-delta)||x||^2."""
        if self.unbiased:
            return 1.0 / (1.0 + self.omega(d))
        raise NotImplementedError

    def omega(self, d: int) -> float:
        """Relative variance bound for unbiased compressors."""
        raise NotImplementedError(f"{self.name} is biased; use delta()")

    def wire_bits(self, d: int) -> float:
        """Bits on the wire for one compressed d-element message."""
        raise NotImplementedError

    def default_gamma(self, d: int) -> float:
        """Practical CHOCO consensus step size for this compressor."""
        return min(1.0, self.delta(d))

    # -- tree API -------------------------------------------------------------
    def _compress_leaves(self, x2ds: list, noises: list) -> list:
        """``[(C(x), x - C(x)), ...]`` for the [n, d] message matrices of
        one tree, always with the residuals (``compress`` drops them).
        Leaf by leaf here; top-k and QSGD override it to compress the whole
        message in one group call."""
        return [self.compress_2d_with_residual(x, nz)
                for x, nz in zip(x2ds, noises)]

    def _leaves(self, gen, tree: Tree, noise):
        """The tree's leaves, its treedef and ``_compress_leaves`` of the
        leaves, every noise draw made first, leaf after leaf."""
        leaves, treedef = tree_flatten(tree)
        x2ds = [_as_2d(leaf) for leaf in leaves]
        noises = [self.noise_2d(gen, x) if nz is None else nz
                  for x, nz in zip(x2ds, _per_leaf(tree, noise))]
        return leaves, treedef, self._compress_leaves(x2ds, noises)

    def compress(self, gen, tree: Tree, *, noise=None) -> Tree:
        """Dense simulation of one encode->decode round."""
        leaves, treedef, out = self._leaves(gen, tree, noise)
        return tree_unflatten(treedef, [
            q.reshape(leaf.shape).to(leaf.dtype)
            for leaf, (q, _) in zip(leaves, out)])

    def compress_with_residual(self, gen, tree: Tree, *,
                               noise=None) -> tuple[Tree, Tree]:
        """(C(tree), tree - C(tree)) in one pass: the EF14 hot path."""
        leaves, treedef, out = self._leaves(gen, tree, noise)
        qs = [q.reshape(leaf.shape).to(leaf.dtype)
              for leaf, (q, _) in zip(leaves, out)]
        rs = [r.reshape(leaf.shape).to(leaf.dtype)
              for leaf, (_, r) in zip(leaves, out)]
        return tree_unflatten(treedef, qs), tree_unflatten(treedef, rs)

    def contractive_compress(self, gen, tree: Tree, *, noise=None) -> Tree:
        """The operator CHOCO consumes: C itself when biased-contractive,
        C/(1+omega) per leaf when unbiased (Koloskova'19 Rem. 3)."""
        q = self.compress(gen, tree, noise=noise)
        if not self.unbiased:
            return q
        qs, treedef = tree_flatten(q)
        out = []
        for ql in qs:
            d = int(ql.numel() // ql.shape[0]) if ql.dim() else 1
            out.append(_div(ql, 1.0 + self.omega(max(d, 1))))
        return tree_unflatten(treedef, out)


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """Dense baseline: full-precision messages, no compression."""

    name: str = "dense"
    unbiased: bool = True

    def compress_2d(self, x2d, noise=None):
        return x2d

    def omega(self, d):
        return 0.0

    def delta(self, d):
        return 1.0

    def wire_bits(self, d):
        return 32.0 * d


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Keep the ceil(frac*d) largest-magnitude entries per message (every
    entry tied with the k-th magnitude too, as the reference keeps them).

    Deterministic and biased; contraction delta = k/d >= frac.  Wire format:
    k (value, index) pairs -> k * (32 + 32) bits.
    """

    frac: float = 0.01
    name: str = "topk"
    unbiased: bool = False

    def _k(self, d: int) -> int:
        return max(1, int(math.ceil(self.frac * d)))

    def _threshold(self, x2d: torch.Tensor) -> torch.Tensor:
        """Magnitude of the k-th largest entry per row, shape [n].  A
        selection, not arithmetic: it equals the reference's ``lax.top_k``
        value exactly."""
        k = self._k(x2d.shape[1])
        mags = x2d.to(torch.float32).abs()
        return torch.topk(mags, k, dim=1).values[:, -1].contiguous()

    def compress_2d(self, x2d, noise=None):
        return self.compress_2d_with_residual(x2d)[0]

    def compress_2d_with_residual(self, x2d, noise=None):
        return self._compress_leaves([x2d], [noise])[0]

    def _compress_leaves(self, x2ds, noises):
        thrs = [self._threshold(x) for x in x2ds]
        if self.backend == "pallas":
            return ops.threshold_mask_group(x2ds, thrs)
        return ref.threshold_mask_group(x2ds, thrs)

    def delta(self, d):
        return self._k(d) / d

    def default_gamma(self, d):
        # a gaussian message's top k/d magnitudes carry far more than k/d of
        # its energy, so a multiple of the worst-case delta is still stable;
        # piecewise fit of the reference's stability sweep
        f = self.delta(d)
        return min(1.0, max(2.0 * f, 4.0 * f - 0.02))

    def wire_bits(self, d):
        return self._k(d) * (32.0 + 32.0)


@dataclasses.dataclass(frozen=True)
class RandomK(Compressor):
    """Bernoulli(frac) sparsification rescaled by 1/frac: unbiased, with
    omega = (1-frac)/frac.  Wire format ~ frac*d (value, index) pairs.  The
    noise is the keep mask (bool, [n, d])."""

    frac: float = 0.05
    name: str = "randk"
    unbiased: bool = True

    def noise_2d(self, gen, x2d):
        return torch.rand(x2d.shape, generator=gen, device=x2d.device) \
            < self.frac

    def compress_2d(self, x2d, noise=None):
        return torch.where(noise, _div(x2d, self.frac), 0.0)

    def omega(self, d):
        return (1.0 - self.frac) / self.frac

    def default_gamma(self, d):
        # the damped operator's innovations are tiny (x frac) while the
        # sampling noise is not: half the contraction factor keeps it stable
        return min(1.0, 0.5 * self.delta(d))

    def wire_bits(self, d):
        return self.frac * d * (32.0 + 32.0)


@dataclasses.dataclass(frozen=True)
class SignNorm(Compressor):
    """Scaled sign: C(x) = (||x||_1 / d) * sign(x) (1 bit/element + norm).

    Biased; its realized contraction is ||x||_1^2 / (d ||x||^2), and
    delta() returns the worst case over dense vectors, 1/d.
    """

    name: str = "signnorm"
    unbiased: bool = False

    def compress_2d(self, x2d, noise=None):
        xf = x2d.to(torch.float32)
        scale = torch.mean(xf.abs(), dim=1, keepdim=True)
        return torch.sign(xf) * scale

    def delta(self, d):
        return 1.0 / d

    def default_gamma(self, d):
        # realized contraction on dense messages is ||x||_1^2/(d||x||^2),
        # ~2/pi for gaussian entries: nowhere near the 1/d worst case
        return 0.3

    def wire_bits(self, d):
        return 1.0 * d + 32.0


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD-style stochastic quantization (Alistarh'17, max-norm variant).

    L = 2^bits - 1 positive levels; q = sign(x) * scale * xi / L with
    xi = floor(|x|/scale * L + u), u ~ U[0,1): stochastic rounding, so
    E[q] = x.  omega <= min(d/L^2, sqrt(d)/L).  Wire format: (bits+1) per
    element + one fp32 scale.  The noise is ``u`` (fp32, [n, d]).
    """

    bits: int = 4
    name: str = "qsgd"
    unbiased: bool = True

    @property
    def levels(self) -> int:
        return 2 ** self.bits - 1

    def noise_2d(self, gen, x2d):
        return torch.rand(x2d.shape, generator=gen, dtype=torch.float32,
                          device=x2d.device)

    def compress_2d(self, x2d, noise=None):
        return self.compress_2d_with_residual(x2d, noise)[0]

    def compress_2d_with_residual(self, x2d, noise=None):
        return self._compress_leaves([x2d], [noise])[0]

    def _compress_leaves(self, x2ds, noises):
        xfs = [x.to(torch.float32) for x in x2ds]
        scales = [x.abs().amax(dim=1) for x in xfs]  # [n] each
        if self.backend == "pallas":
            return ops.quantize_dequantize_group(xfs, scales, noises,
                                                 levels=self.levels)
        return ref.quantize_dequantize_group(xfs, scales, noises,
                                             levels=self.levels)

    def omega(self, d):
        s = self.levels
        return min(d / s ** 2, math.sqrt(d) / s)

    def wire_bits(self, d):
        return (self.bits + 1.0) * d + 32.0


# ---------------------------------------------------------------------------
# factory + accounting
# ---------------------------------------------------------------------------

VALID_COMPRESSOR_FORMS = (
    "dense", "topk:<frac in (0,1]>", "randk:<frac in (0,1]>", "signnorm",
    "qsgd:<bits in [1,16]>")


def make_compressor(spec: str, *, backend: str = "jnp") -> Compressor:
    """Parse 'dense' | 'topk:<frac>' | 'randk:<frac>' | 'signnorm' |
    'qsgd:<bits>' into a compressor instance.

    ``backend`` is 'jnp' (the plain expressions), or 'pallas' / 'auto' (the
    kernels through ``kernels/ops.py``, which pick by device: the CUDA
    kernel for CUDA tensors, the plain version for CPU ones).

    Every malformed spec (an empty argument ``'topk:'``, a non-numeric or
    out-of-range argument ``'qsgd:0'``, an argument where none is taken, an
    unknown name) raises ``ValueError`` listing the valid forms.
    """
    def bad(why: str):
        raise ValueError(
            f"malformed compressor spec {spec!r}: {why}; valid forms: "
            + " | ".join(VALID_COMPRESSOR_FORMS))

    if backend not in BACKENDS:
        raise ValueError(f"compressor backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "auto":
        backend = "pallas"
    if not isinstance(spec, str):
        bad(f"expected a string, got {type(spec).__name__}")
    kind, sep, arg = spec.partition(":")
    kind, arg = kind.strip().lower(), arg.strip()
    if sep and not arg:
        bad("empty argument after ':'")
    if kind in ("dense", "identity", "none"):
        if arg:
            bad(f"{kind!r} takes no argument")
        return Identity(backend=backend)
    if kind in ("topk", "randk"):
        default = 0.01 if kind == "topk" else 0.05
        try:
            frac = float(arg) if arg else default
        except ValueError:
            bad(f"fraction {arg!r} is not a number")
        if not 0.0 < frac <= 1.0:
            bad(f"fraction must be in (0, 1], got {frac}")
        cls = TopK if kind == "topk" else RandomK
        return cls(frac=frac, backend=backend)
    if kind == "signnorm":
        if arg:
            bad("'signnorm' takes no argument")
        return SignNorm(backend=backend)
    if kind == "qsgd":
        try:
            bits = int(arg) if arg else 4
        except ValueError:
            bad(f"bit width {arg!r} is not an integer")
        if not 1 <= bits <= 16:
            bad(f"bit width must be in [1, 16], got {bits}")
        return QSGD(bits=bits, backend=backend)
    bad(f"unknown compressor {kind!r}")


def tree_wire_bits(compressor: Compressor, tree: Tree) -> float:
    """Bits one node puts on the wire to transmit the whole (per-node slice
    of the) node-stacked ``tree`` once."""
    total = 0.0
    for leaf in tree_leaves(tree):
        d = int(leaf.numel() // leaf.shape[0]) if leaf.dim() > 0 else 1
        total += compressor.wire_bits(max(d, 1))
    return total
