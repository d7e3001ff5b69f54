"""Token batches of a skewed domain mix for decentralized LM training.

The generator of the ``generator: tokens`` traffic mixes. There are
``domains`` domains; each draws its tokens from a Zipf(``zipf_s``) law over
a permutation of the whole vocabulary of its own, and repeats the token
``copy_lag`` positions back with probability ``copy_prob`` (a short
context a model can learn). Each node draws its domain mix from
Dirichlet(``alpha``), and each of its sequences one domain from that mix:
the LM analogue of the label skew of the image mixes. Nothing is
``vocab x vocab``: a step's tokens cost one draw each.

Mix parameters: ``nodes``, ``batch`` (sequences a node a step),
``seq_len`` (tokens a sequence; each row carries one more, its last
label), ``alpha``, ``domains``, ``zipf_s``, ``copy_prob``, ``copy_lag``,
``distinct_batches``. The configuration gives ``vocab_size``.
"""
from __future__ import annotations

import numpy as np


def batches(mix: dict, config: dict, seed: int) -> list[tuple]:
    """``mix['distinct_batches']`` host batches ``(tokens [n, B, S + 1]
    int32,)``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    vocab = int(config["vocab_size"])
    nodes, b, s = int(mix["nodes"]), int(mix["batch"]), int(mix["seq_len"])
    domains = int(mix["domains"])
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1) ** float(mix["zipf_s"]))
    cdf /= cdf[-1]
    perms = np.stack([rng.permutation(vocab) for _ in range(domains)])
    node_mix = rng.dirichlet(np.full(domains, float(mix["alpha"])),
                             size=nodes)
    lag, p_copy = int(mix["copy_lag"]), float(mix["copy_prob"])
    out = []
    for _ in range(int(mix["distinct_batches"])):
        dom = np.stack([rng.choice(domains, size=b, p=q) for q in node_mix])
        ranks = np.minimum(np.searchsorted(cdf, rng.random((nodes, b, s + 1))),
                           vocab - 1)
        toks = perms[dom[..., None], ranks]
        copy = rng.random((nodes, b, s + 1)) < p_copy
        copy[..., :lag] = False
        toks[..., lag:] = np.where(copy[..., lag:], toks[..., :-lag],
                                   toks[..., lag:])
        out.append((toks.astype(np.int32),))
    return out
