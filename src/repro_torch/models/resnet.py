"""The paper's CV models: ResNet-20 (BN / GN / EvoNorm-S0) and VGG-11.

Port of ``repro/models/resnet.py``.  The param and state trees are the
reference's, key for key, with conv weights in its HWIO layout
``[k, k, cin, cout]``, so the optimizer, ``qg_step``'s leaf plan, interop
and checkpoints line up leaf for leaf.  Where the reference writes one
node's model and vmaps it, these functions work on the node-stacked layout:
params ``[n, ...]``, images ``[n, B, H, W, C]`` (or ``[B, H, W, C]`` shared
by every node, for evaluation), logits ``[n, B, classes]``.

Inside, activations are ``[B, n * C, H, W]``, node-major on the channel
axis, and each conv of all n nodes is one grouped ``F.conv2d`` (``groups =
n``) with the weights permuted to ``[n * cout, cin, k, k]``.  Convs pad as
XLA's ``SAME``: a stride-2 conv on an even size pads (0, 1), not (1, 1).
The norms are written out as the reference's ``_apply_norm`` computes them
(biased variances, eps inside the square root, GN and EvoNorm over 2
contiguous channel groups, BN's running statistics ``0.9 * old + 0.1 *
batch`` with the biased batch variance, kept per node and never gossiped).
Init draws from a ``torch.Generator`` at the reference's scales (He for
convs, ``1/sqrt(cin)`` for the head); parity runs inject the reference's
arrays (``repro_torch.interop``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["init_resnet20", "apply_resnet20", "init_vgg11", "apply_vgg11"]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(h, w, stride: int = 1):
    """``h`` [B, n*cin, H, W] through node-stacked HWIO weights ``w`` [n, k,
    k, cin, cout]: one grouped conv, [B, n*cout, H', W']."""
    n, k, _, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, k, k)
    top, bottom = _same_pads(h.shape[2], k, stride)
    left, right = _same_pads(h.shape[3], k, stride)
    if top == bottom and left == right:
        return F.conv2d(h, wt, stride=stride, padding=(top, left), groups=n)
    return F.conv2d(F.pad(h, (left, right, top, bottom)), wt, stride=stride,
                    groups=n)


def _conv_init(gen, k: int, cin: int, cout: int):
    # He init (paper: He et al. 2015)
    return torch.randn(k, k, cin, cout, generator=gen) * math.sqrt(
        2.0 / (k * k * cin))


def _head_init(gen, cin: int, classes: int):
    return torch.randn(cin, classes, generator=gen) / math.sqrt(cin)


def _images(x, n: int):
    """Images [n, B, H, W, C], or [B, H, W, C] shared by the n nodes ->
    [B, n*C, H, W]."""
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2).repeat(1, n, 1, 1)
    b, hh, ww, c = x.shape[1:]
    return x.permute(1, 0, 4, 2, 3).reshape(b, x.shape[0] * c, hh, ww)


def _head(h, w, b):
    """Global average pool of [B, n*C, H, W] and the per-node linear head
    ``w`` [n, C, classes], ``b`` [n, classes] -> [n, B, classes]."""
    n = w.shape[0]
    pooled = h.mean(dim=(2, 3))
    pooled = pooled.reshape(pooled.shape[0], n, -1).transpose(0, 1)
    return torch.bmm(pooled, w) + b[:, None, :]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _init_norm(norm: str, c: int):
    p = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    if norm == "evonorm":
        p["v"] = torch.ones(c)
    s = {}
    if norm == "bn":
        s = {"mean": torch.zeros(c), "var": torch.ones(c)}
    return p, s


def _apply_norm(norm: str, p, s, h, train: bool, momentum=0.9, groups=2,
                eps=1e-5):
    """One norm of all n nodes on ``h`` [B, n*C, H, W]; ``p`` and ``s``
    leaves are [n, C].  Returns (output, new state)."""
    if norm == "none":
        return h, s
    b, nc, hh, ww = h.shape
    n = p["scale"].shape[0]
    chan = lambda t: t.reshape(1, nc, 1, 1)
    if norm == "bn":
        if train:
            mean = h.mean(dim=(0, 2, 3))
            var = h.var(dim=(0, 2, 3), correction=0)
            new_s = {
                "mean": momentum * s["mean"]
                + (1 - momentum) * mean.reshape(n, -1),
                "var": momentum * s["var"]
                + (1 - momentum) * var.reshape(n, -1)}
        else:
            mean, var = s["mean"].reshape(nc), s["var"].reshape(nc)
            new_s = s
        y = (h - chan(mean)) * chan(torch.rsqrt(var + eps))
        return y * chan(p["scale"]) + chan(p["bias"]), new_s
    if norm in ("gn", "evonorm"):
        hg = h.reshape(b, n, groups, nc // (n * groups), hh, ww)
        var = hg.var(dim=(3, 4, 5), keepdim=True, correction=0)
        if norm == "gn":
            mean = hg.mean(dim=(3, 4, 5), keepdim=True)
            y = (hg - mean) * torch.rsqrt(var + eps)
        else:  # EvoNorm-S0: x * sigmoid(v x) / group std
            num = h * torch.sigmoid(chan(p["v"]) * h)
            y = num.reshape(hg.shape) / torch.sqrt(var + eps)
        y = y.reshape(b, nc, hh, ww)
        return y * chan(p["scale"]) + chan(p["bias"]), s
    raise ValueError(norm)


# ---------------------------------------------------------------------------
# ResNet-20 (width-scalable: the paper's ResNet-20-x2 for ImageNet-32)
# ---------------------------------------------------------------------------

def _blocks():
    """(name, stage, stride) of the nine residual blocks."""
    return [(f"s{s}b{b}", s, 2 if (s > 0 and b == 0) else 1)
            for s in range(3) for b in range(3)]


def init_resnet20(generator, *, norm: str = "evonorm", width: int = 1,
                  num_classes: int = 10):
    """One node's ``(params, state)`` drawn from ``generator`` (CPU)."""
    base = (16 * width, 32 * width, 64 * width)
    params = {"stem": _conv_init(generator, 3, 3, base[0])}
    state = {}
    params["stem_norm"], state["stem_norm"] = _init_norm(norm, base[0])
    cin = base[0]
    for name, s_idx, stride in _blocks():
        cout = base[s_idx]
        blk, blk_s = {}, {}
        blk["conv1"] = _conv_init(generator, 3, cin, cout)
        blk["norm1"], blk_s["norm1"] = _init_norm(norm, cout)
        blk["conv2"] = _conv_init(generator, 3, cout, cout)
        blk["norm2"], blk_s["norm2"] = _init_norm(norm, cout)
        if stride != 1 or cin != cout:
            blk["proj"] = _conv_init(generator, 1, cin, cout)
        params[name], state[name] = blk, blk_s
        cin = cout
    params["head"] = _head_init(generator, cin, num_classes)
    params["head_b"] = torch.zeros(num_classes)
    return params, state


def apply_resnet20(params, state, x, *, norm: str = "evonorm",
                   train: bool = True):
    """Node-stacked ``params``/``state`` on images ``x`` ([n, B, H, W, C],
    or [B, H, W, C] for every node) -> (logits [n, B, classes], new
    state)."""
    relu = norm != "evonorm"
    new_state = {}
    h = _conv(_images(x, params["stem"].shape[0]), params["stem"])
    h, new_state["stem_norm"] = _apply_norm(
        norm, params["stem_norm"], state["stem_norm"], h, train)
    if relu:
        h = torch.relu(h)
    for name, _, stride in _blocks():
        blk, blk_s = params[name], state[name]
        ns = {}
        y = _conv(h, blk["conv1"], stride)
        y, ns["norm1"] = _apply_norm(norm, blk["norm1"], blk_s["norm1"], y,
                                     train)
        if relu:
            y = torch.relu(y)
        y = _conv(y, blk["conv2"])
        y, ns["norm2"] = _apply_norm(norm, blk["norm2"], blk_s["norm2"], y,
                                     train)
        sc = h if "proj" not in blk else _conv(h, blk["proj"], stride)
        h = torch.relu(y + sc) if relu else y + sc
        new_state[name] = ns
    return _head(h, params["head"], params["head_b"]), new_state


# ---------------------------------------------------------------------------
# VGG-11 (width factor 1/2, no normalization -- Table 1 bottom)
# ---------------------------------------------------------------------------

_VGG11 = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


def init_vgg11(generator, *, width_factor: float = 0.5,
               num_classes: int = 10):
    """One node's ``(params, {})``; ``params['convs']`` is a tuple, as the
    reference's."""
    convs = []
    cin = 3
    for v in _VGG11:
        if v == "M":
            continue
        cout = int(v * width_factor)
        convs.append(_conv_init(generator, 3, cin, cout))
        cin = cout
    return {"convs": tuple(convs),
            "head": _head_init(generator, cin, num_classes),
            "head_b": torch.zeros(num_classes)}, {}


def apply_vgg11(params, state, x, *, train: bool = True):
    """Node-stacked VGG-11 on ``x`` as :func:`apply_resnet20` takes it ->
    (logits [n, B, classes], state); 2x2 VALID max pools."""
    convs = iter(params["convs"])
    h = _images(x, params["head"].shape[0])
    for v in _VGG11:
        if v == "M":
            h = F.max_pool2d(h, 2, 2)
        else:
            h = torch.relu(_conv(h, next(convs)))
    return _head(h, params["head"], params["head_b"]), state
