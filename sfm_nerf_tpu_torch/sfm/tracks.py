"""Track merging across matching files (a numpy copy of
sfm_nerf_tpu/sfm/tracks.py).

The reference assigns every row of every ``matching{i}.txt`` its own global
feature index (Phase1/Wrapper.py:150-176): a physical 3D point detected in
image 1 (listed in matching1.txt as 1<->3) and re-listed in matching2.txt
(2<->3) becomes TWO world points that are never reconciled — the map grows
duplicates and bundle adjustment cannot couple their observations.

``merge_tracks`` reconciles them: features are merged (union-find) whenever
they share an observation — the same image seen at the same pixel (within
``tol``).  Matching files come from one detector run per image, so
re-detections carry identical coordinates; ``tol`` only absorbs the float
formatting of the files.

This is an ADDITION over the reference (its per-file namespace never
merges, SURVEY ROADMAP item), off by default for parity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


class _UnionFind:
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


def merge_tracks(
    matches_dict: Dict[Tuple[int, int], np.ndarray],
    tracks: List[Dict[int, Tuple[float, float]]],
    tol: float = 0.5,
) -> Tuple[Dict, List[Dict], np.ndarray, np.ndarray]:
    """Merge duplicate feature tracks; remap everything consistently.

    Returns ``(matches_dict', tracks', visibility', old_to_new)`` where the
    f_idx column of every match row is rewritten through ``old_to_new`` and
    the visibility matrix is rebuilt from the merged tracks.  Unions are
    conflict-aware: a merge that would give one track two different pixels
    in the same image (a transitive chain through a wrong match) is
    refused, so every emitted track is self-consistent within ``tol``.
    """
    n = len(tracks)
    uf = _UnionFind(n)
    # Conflict-aware union: the raw matching files contain wrong matches,
    # so transitively chaining features through shared pixels can unite
    # DISTINCT 3D points (measured: 27% of naive merges on the bundled
    # dataset carry >0.5px-conflicting observations).  Standard track
    # building (Bundler/COLMAP) rejects inconsistent tracks; here a union
    # that would put two different pixels of the same image into one track
    # is simply refused, keeping every emitted track self-consistent.
    obs_of: Dict[int, Dict[int, Tuple[float, float]]] = {
        f: dict(t) for f, t in enumerate(tracks)
    }

    def try_union(a: int, b: int) -> None:
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:
            return
        oa, ob = obs_of[ra], obs_of[rb]
        small, big = (oa, ob) if len(oa) <= len(ob) else (ob, oa)
        for img, (u, v) in small.items():
            if img in big:
                ub, vb = big[img]
                if abs(ub - u) > tol or abs(vb - v) > tol:
                    return                      # inconsistent — refuse
        uf.union(ra, rb)
        root = uf.find(ra)
        merged = big
        for img, uv in small.items():
            merged.setdefault(img, uv)
        obs_of[root] = merged

    # spatial hash per image: cell -> [(f, u, v)]
    cells: Dict[Tuple[int, int, int], list] = {}
    inv = 1.0 / max(tol, 1e-9)
    for f, obs in enumerate(tracks):
        for img, uv in obs.items():
            u, v = float(uv[0]), float(uv[1])
            cu, cv = math.floor(u * inv), math.floor(v * inv)
            for du in (-1, 0, 1):
                for dv in (-1, 0, 1):
                    for g, ug, vg in cells.get((img, cu + du, cv + dv), ()):
                        if abs(ug - u) <= tol and abs(vg - v) <= tol:
                            try_union(f, g)
            cells.setdefault((img, cu, cv), []).append((f, u, v))

    # new indices in order of first appearance of each root
    old_to_new = np.full(n, -1, dtype=np.int64)
    merged_tracks: List[Dict[int, Tuple[float, float]]] = []
    for f in range(n):
        root = uf.find(f)
        if old_to_new[root] < 0:
            old_to_new[root] = len(merged_tracks)
            merged_tracks.append({})
        old_to_new[f] = old_to_new[root]
        dst = merged_tracks[old_to_new[f]]
        for img, uv in tracks[f].items():
            dst.setdefault(img, uv)          # first observation wins

    new_matches = {}
    for pair, rows in matches_dict.items():
        rows = np.array(rows, copy=True)
        if rows.size:
            rows[:, 4] = old_to_new[rows[:, 4].astype(np.int64)]
        new_matches[pair] = rows

    max_img = max((img for t in merged_tracks for img in t), default=0)
    visibility = np.zeros((max_img + 1, len(merged_tracks)))
    for fi, obs in enumerate(merged_tracks):
        for img in obs:
            visibility[img][fi] = 1
    return new_matches, merged_tracks, visibility, old_to_new
