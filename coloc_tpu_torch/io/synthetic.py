"""Synthetic workload made with numpy (counterpart of consistent_mapdb in
coloc_tpu.io.synthetic, plus a frontend-free feature generator).

Arrays come out in the reference's layout (uint32 descriptors);
convert.features_from_numpy / mapdb_from_numpy make the port's tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from coloc_tpu_torch.types import DESC_WORDS


class FeaturesArrays(NamedTuple):
    xy: np.ndarray      # (K, 2) float32
    score: np.ndarray   # (K,) float32
    scale: np.ndarray   # (K,) int32
    angle: np.ndarray   # (K,) float32
    desc: np.ndarray    # (K, 16) uint32
    valid: np.ndarray   # (K,) bool


class MapDBArrays(NamedTuple):
    X: np.ndarray       # (L, 3) float32
    desc: np.ndarray    # (L, 16) uint32
    valid: np.ndarray   # (L,) bool


def _random_desc(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, (n, DESC_WORDS), dtype=np.uint64).astype(np.uint32)


def random_features(h: int, w: int, kp: int,
                    rng: np.random.Generator) -> FeaturesArrays:
    """kp valid keypoints uniform over a w x h image with random 512-bit
    descriptors (stands in for the frontend, which is not ported yet).
    Draws, in order: xy, score, angle, desc."""
    xy = rng.uniform((0.0, 0.0), (w - 1.0, h - 1.0), (kp, 2)).astype(np.float32)
    score = rng.uniform(0.0, 1.0, kp).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, kp).astype(np.float32)
    return FeaturesArrays(xy=xy, score=score, scale=np.zeros(kp, np.int32),
                          angle=angle, desc=_random_desc(rng, kp),
                          valid=np.ones(kp, bool))


def consistent_mapdb(feats, K: np.ndarray, num_landmarks: int,
                     rng: np.random.Generator,
                     depth_range: Tuple[float, float] = (5.0, 14.0)
                     ) -> MapDBArrays:
    """Geometrically consistent map for a frame: the first kp landmarks sit
    on the frame's feature bearings at random depths (X = d K^-1 [u, v, 1])
    with the frame's own descriptors; the rest are random landmarks with
    random descriptors. Same recipe and rng call order as coloc_tpu's, so
    one seed gives one map in both packages."""
    kp = int(feats.xy.shape[0])
    L = int(num_landmarks)
    pad = max(L - kp, 0)
    uv = np.asarray(feats.xy)
    depths = rng.uniform(*depth_range, (kp, 1)).astype(np.float32)
    dirs = (np.linalg.inv(np.asarray(K))
            @ np.c_[uv, np.ones(kp)].T).T.astype(np.float32)
    X = np.concatenate(
        [dirs * depths, rng.uniform(-3, 3, (pad, 3)).astype(np.float32)],
        axis=0,
    )[:L]
    desc = np.concatenate([np.asarray(feats.desc, np.uint32),
                           _random_desc(rng, pad)])[:L]
    return MapDBArrays(X=X.astype(np.float32), desc=desc, valid=np.ones(L, bool))
