"""Union-find over host integer indices: the connectivity that track
merging, the averagers' component restriction and spanning checks, and
the pipeline's pose-graph gate share."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


class UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:        # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # keep the smaller index as root so merged tracks inherit the
            # FIRST (file-order) feature's identity deterministically
            if rb < ra:
                ra, rb = rb, ra
            self.parent[rb] = ra


def component_labels(edges: Iterable[Tuple[int, int]], n: int) -> np.ndarray:
    """(n,) int: each node's component root (its smallest member) under
    ``edges``."""
    uf = UnionFind(n)
    for a, b in edges:
        uf.union(int(a), int(b))
    return np.array([uf.find(k) for k in range(n)], np.int64)


def spans(edges: Iterable[Tuple[int, int]], n: int) -> bool:
    """Whether ``edges`` join all ``n`` nodes into one component."""
    return n == 0 or bool((component_labels(edges, n) == 0).all())
