"""Feature tracks across views, host-side numpy (a copy of
coloc_tpu.sfm.tracks, which imports no JAX; the port keeps its own).

Reference parity: OpenMVG TracksBuilder as used in
Reconstructor.hpp:166-173 — union-find over pairwise matches, filtered to
tracks of length >= 2, exported as per-view feature-index maps. It runs
once a bootstrap, on the host; its fixed-capacity table is what the
reconstruction reads.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, i: int) -> int:
        root = i
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[i] != root:
            self.parent[i], i = root, self.parent[i]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(
    pair_matches: Dict[Tuple[int, int], np.ndarray],
    num_views: int,
    capacity_per_view: int,
    max_tracks: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Union-find track building.

    pair_matches[(i, j)] is an int array (K_i,) mapping view-i feature index
    -> view-j feature index (or -1), i.e. the Matches.idx convention.

    Returns (table (max_tracks, num_views) int32 with -1 for absent, valid
    (max_tracks,) bool). Tracks with inconsistent merges (two different
    features of the same view in one track) are dropped, like OpenMVG's
    TracksBuilder filter step.
    """
    n = num_views * capacity_per_view
    uf = _UnionFind(n)

    def nid(view: int, feat: int) -> int:
        return view * capacity_per_view + feat

    for (i, j), idx in pair_matches.items():
        idx = np.asarray(idx)
        for qi in np.nonzero(idx >= 0)[0]:
            uf.union(nid(i, int(qi)), nid(j, int(idx[qi])))

    # group members by root
    groups: Dict[int, list] = {}
    for (i, j), idx in pair_matches.items():
        for qi in np.nonzero(np.asarray(idx) >= 0)[0]:
            for node in (nid(i, int(qi)), nid(j, int(np.asarray(idx)[qi]))):
                root = uf.find(node)
                groups.setdefault(root, [])
                if node not in groups[root]:
                    groups[root].append(node)

    table = np.full((max_tracks, num_views), -1, np.int32)
    valid = np.zeros(max_tracks, bool)
    t = 0
    for members in groups.values():
        if t >= max_tracks:
            break
        views = [m // capacity_per_view for m in members]
        if len(set(views)) != len(views):
            continue  # inconsistent track (same view twice) — drop
        if len(views) < 2:
            continue
        for m in members:
            table[t, m // capacity_per_view] = m % capacity_per_view
        valid[t] = True
        t += 1
    return table, valid
