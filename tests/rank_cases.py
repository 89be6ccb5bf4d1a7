"""Planted edge inputs of the ladder rank (B3), the epipolar rank (B9) and
the two-stage group prefilter (B12), numpy only, shared by the CPU parity
tests, the card's kernel tests and chip_smoke.py.

For B3, every value is a small dyadic number (or NaN, or float32(1e-9) and its
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


# ---- the epipolar rank (B9) ----------------------------------------------
#
# Model rows are [A block | den2 block | den1 block] (9 each), data rows the
# same. Values are 0, +-1/2, +-1 in the A block and 0, 1/2, 1 in the den
# blocks, so every product, sum, A^2, lhs and rhs is exact in float32 (at
# most 19 significant bits) and no FMA contraction can change a count.
# With EPI_C = 16, jmax = 2 and 5 rungs the thresholds are 1, 4, 16, 64,
# 256 times rhs.

EPI_C = 16.0

# planted models: e[0], e[9], e[18] (A = e0 x, s2 = e9 y, s1 = e18 z at a
# planted point), every other entry 0
_EPI_MODELS = [(1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (0.5, 1.0, 0.5)]

# planted points (x, y, z) in d[0], d[9], d[18]; under model 0:
# lhs = x^2 (y + z), rhs = y z, compared with 16 4^j rhs
_EPI_POINTS = [
    (4.0, 2.0, 2.0),           # lhs 64 = 16 rhs exactly: rung j=0 not counted
    (2.0, 2.0, 2.0),           # lhs 16 = 4 rhs: rung j=-1 exactly
    (8.0, 2.0, 2.0),           # lhs 256 = 64 rhs: the top rung exactly
    (0.0, 1.0, 1.0),           # lhs 0: every rung
    (1.0, 0.0, 2.0),           # den2 = 0: rhs 0, no rung
    (1.0, -1.0, 2.0),          # den2 clamped from -1 to 0
    (np.nan, 1.0, 1.0),        # a NaN in the A row
    (1.0, np.nan, 1.0),        # a NaN in a den row
    (0.25, 1.0, 1.0),
    (16.0, 1.0, 1.0),          # lhs 512 > 256 rhs: no rung
]


def planted_epi_operands(Hm: int, M: int, seed: int = 0, odd_mask: bool = False):
    """(emat (Hm, 27), dmat (27, M), maskf (M,), c (1,)) float32: the planted
    models, then random ones; the planted points (those that fit in M),
    then random ones with a masked band of M // 8 points from M // 2 and
    every seventh point masked. With odd_mask, three points carry a mask of
    1/2 (the kernel's float path; still exact)."""
    rng = np.random.default_rng(seed)
    emat = np.concatenate([rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (Hm, 9)),
                           rng.choice([0.0, 0.5, 1.0], (Hm, 18))], axis=1)
    for i, (a, b, g) in enumerate(_EPI_MODELS[:Hm]):
        emat[i] = 0.0
        emat[i, [0, 9, 18]] = a, b, g
    dmat = np.concatenate([rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (9, M)),
                           rng.choice([0.0, 0.5, 1.0], (18, M))], axis=0)
    for i, (x, y, z) in enumerate(_EPI_POINTS[:M]):
        dmat[:, i] = 0.0
        dmat[[0, 9, 18], i] = x, y, z
    mask = np.ones(M)
    mask[M // 2:M // 2 + M // 8] = 0.0
    mask[len(_EPI_POINTS)::7] = 0.0
    if odd_mask:
        mask[[M // 3, M // 3 + 1, M - 1]] = 0.5
    return (np.ascontiguousarray(emat, np.float32), np.ascontiguousarray(dmat, np.float32),
            mask.astype(np.float32), np.array([EPI_C], np.float32))


# ---- the two-stage group prefilter (B12) -----------------------------------

def twostage_edge_case(Q: int, T: int, seed: int = 0):
    """(q_desc (Q, 16), t_desc (T, 16)) uint32 and t_valid (T,) bool for
    T >= 2: group 0 holds one valid row (row 7, or T - 1 below 8 rows);
    group 1, where T > 4096, none; row T - 1, alone in the last group where
    T % 2048 == 1, a copy of that valid row; a row duplicated within its
    group and in another group;
    all-zero and all-ones rows. Queries: a bank row (dot 128 against it and
    its duplicates), the all-zero and all-ones descriptors, bank rows with
    40 bits flipped, random rows."""
    rng = np.random.default_rng(seed)
    td = rng.integers(0, 2 ** 32, (T, 16), dtype=np.uint64).astype(np.uint32)
    tv = rng.random(T) > 0.1
    one = 7 if T > 7 else T - 1
    tv[:min(T, 2048)] = False
    tv[one] = True
    if T > 4096:
        tv[2048:4096] = False
    td[min(3, T - 1)] = 0
    td[min(4, T - 1)] = 0xFFFFFFFF
    td[T - 1] = td[one]                             # in the last group
    if T > 2048 + 20:
        td[2048 + 10] = td[2048 + 19]               # within one group
        td[T - 2] = td[2048 + 19]
    rows = rng.integers(0, T, Q)
    qd = td[rows].copy()
    flips = rng.integers(0, 512, (Q, 40))
    for j in range(flips.shape[1]):
        qd[np.arange(Q), flips[:, j] // 32] ^= np.uint32(1) << (flips[:, j] % 32).astype(np.uint32)
    qd[Q - Q // 4:] = rng.integers(0, 2 ** 32, (Q // 4, 16), dtype=np.uint64).astype(np.uint32)
    fixed = [td[one], np.zeros(16, np.uint32), np.full(16, 0xFFFFFFFF, np.uint32),
             td[min(2048 + 19, T - 1)]]
    for i, row in enumerate(fixed[:Q]):
        qd[i] = row
    return qd, td, tv
