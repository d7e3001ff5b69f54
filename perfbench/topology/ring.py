"""The undirected ring of ``topology: ring`` mixes, as the paper weights
it: 1/3 to the node and to each neighbour, halves for two nodes.

A topology module gives ``mixing(n)``, the graph's n x n mixing matrix W
for n nodes, worked out here again from the graph and not taken from the
program.
"""
from __future__ import annotations

import numpy as np


def mixing(n: int) -> np.ndarray:
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        return np.full((2, 2), 0.5)
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = w[i, (i - 1) % n] = w[i, (i + 1) % n] = 1.0 / 3.0
    return w
