"""Planted edge inputs of the ladder rank (B3), numpy only, shared by the
CPU parity test, the card's kernel test and chip_smoke.py.

Every value is a small dyadic number (or NaN, or float32(1e-9) and its
neighbour below), so each product and sum of the rank's arithmetic is exact
and no FMA contraction can change a residual: the rank is one exact value
that every implementation must reproduce. With thr_sq = 1, jmax = 2 and 5
rungs the thresholds are 1/16, 1/4, 1, 4, 16 times t0.
"""

import numpy as np

THR_SQ = 1.0
_Z_EPS = np.float32(1e-9)

# models: rows of [R | t] as (3, 4), flattened to 12
_MODELS = [
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]],      # identity
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0]],      # Z plane exactly 0
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0]],     # Z flipped: front and behind swap
    [[2, 0, 0, 0], [0, 2, 0, 0], [0, 0, 1, 0]],      # residuals x4
    [[1, 0, 0, 1], [0, 1, 0, 0], [0, 0, 1, 0]],      # u shifted by x3
    [[0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 0.5, 0]],
]

# points: (x0, x1, x2, x3, obs_x, obs_y, mask); under the identity model
# u = x0 - obs_x x2, v = x1 - obs_y x2, Z = x2
_POINTS = [
    (2, 0, 1, 0, 0, 0, 1),          # s = 4 = rung j=1 exactly: not counted
    (0.5, 0, 1, 0, 0, 0, 1),        # s = 1/4 = rung j=-1 exactly
    (8, 0, 2, 0, 0, 0, 1),          # s = 64 = t0 * 16, the top rung exactly
    (1, 1, 2, -1, 0.5, 0.5, 1),     # s = 0: every rung
    (1, 0, -1, 0, 0, 0, 1),         # behind the camera (counted in "nonzero")
    (0, 0, -2, 0, 0.25, 0, 1),      # behind, |Z| = 2
    (0, 0, _Z_EPS, 0, 0, 0, 1),     # |Z| = 1e-9: alive in both zmodes
    (0, 0, np.nextafter(_Z_EPS, np.float32(0)), 0, 0, 0, 1),  # just below
    (2, 0, 1, 0, 0, 0, 0),          # masked
    (np.nan, np.nan, np.nan, np.nan, 0, 0, 1),  # a NaN column
    (1, 0, 1, 0, np.nan, 0, 1),     # a NaN observation
    (3, 1, 1, 1, 1, 1, 1),
    (0.75, -0.5, 0.5, 1, 1, -1, 1),
]


def planted_rank_operands(reps: int = 1):
    """(eflat (6, 12), xh (4, M), obs (2, M), maskf (M,)) float32 with
    M = 13 * reps: the planted points repeated reps times."""
    eflat = np.asarray(_MODELS, np.float32).reshape(len(_MODELS), 12)
    pts = np.tile(np.asarray(_POINTS, np.float32), (reps, 1))
    return (eflat, np.ascontiguousarray(pts[:, :4].T), np.ascontiguousarray(pts[:, 4:6].T),
            np.ascontiguousarray(pts[:, 6]))
