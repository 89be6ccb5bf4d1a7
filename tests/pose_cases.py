"""Pose-only LM problems (numpy and the port only, no jax): the CPU tests
of the LM's loop exit and the card tests of the pose kernels read them.

`lanes()` gives three drones' problems that stop at different iterations,
one of them at the damping cap; `frame_lanes(D, L, seed, ...)` gives D
lanes of L correspondences at the reference camera (752x480) with Huber
outliers, masked rows and optional radial distortion; `clear_lanes` says
which lanes' first LM decisions lie clear of float32 rounding.
"""

import numpy as np
import torch

from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.sfm import ba

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
H, W = 480, 752
K_REF = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)


def pose_problem(seed, L, noise, rot):
    """A pose-only problem that converges: points 3-8 m ahead seen at the
    identity with `noise` px, the initial pose `rot` away."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-2, 2, (L, 2)), rng.uniform(3, 8, (L, 1))].astype(np.float32)
    uv = (X[:, :2] / X[:, 2:] * 300 + [160, 120]
          + rng.normal(0, noise, (L, 2))).astype(np.float32)
    R0 = so3.exp(torch.from_numpy(rng.normal(0, rot, 3).astype(np.float32))).numpy()
    C0 = rng.normal(0, rot, 3).astype(np.float32)
    return X, uv, R0, C0, np.zeros(3, np.float32)


def capped_problem():
    """Pixels unrelated to the points, a far initial pose and strong
    distortion: the LM rejects its steps until the damping reaches its
    1e8 cap (found by a search over such problems)."""
    rng = np.random.default_rng(713)
    L = int(rng.integers(4, 40))
    X = np.c_[rng.uniform(-2, 2, (L, 2)), rng.uniform(2, 8, (L, 1))].astype(np.float32)
    uv = rng.uniform(0, 320, (L, 2)).astype(np.float32)
    R0 = so3.exp(torch.from_numpy(rng.normal(0, 1.0, 3).astype(np.float32))).numpy()
    C0 = rng.normal(0, 1, 3).astype(np.float32)
    return X, uv, R0, C0, np.array([-0.5, 0.3, 0.1], np.float32)


def lanes():
    """Three drones' problems of 21 points: -> (R0, C0, X, uv, inliers, Ks,
    dists), CPU tensors, each with a leading axis of 3."""
    capped = capped_problem()
    L = capped[0].shape[0]
    probs = [pose_problem(1, L, 0.5, 0.01), pose_problem(2, L, 1.0, 0.2), capped]
    X, uv, R0, C0, dist = (torch.from_numpy(np.stack([p[i] for p in probs]))
                           for i in range(5))
    return (R0, C0, X, uv, torch.ones(3, L, dtype=torch.bool),
            torch.from_numpy(np.stack([K] * 3)), dist)


def _distort(xy, d):
    r2 = (xy * xy).sum(axis=-1, keepdims=True)
    return xy * (1.0 + r2 * (d[0] + r2 * (d[1] + r2 * d[2])))


def frame_lanes(D, L, seed, dist=(0.0, 0.0, 0.0), outliers=0.1, masked=0.1, rot=0.02,
                shift=0.05):
    """D lanes of L correspondences at K_REF: landmarks 5-14 m ahead of the
    identity view seen with 0.5 px noise through `dist`, a share `outliers`
    of them moved 1-3 m (Huber's regime), a share `masked` not inliers; the
    initial pose `rot` rad and `shift` m away (normal, per axis). -> (R0,
    C0, X, uv, inliers, Ks, dists), CPU tensors."""
    rng = np.random.default_rng(seed)
    d = np.asarray(dist, np.float32)
    Xs, uvs, inls, R0s, C0s = [], [], [], [], []
    for _ in range(D):
        px = rng.uniform((0.0, 0.0), (W - 1.0, H - 1.0), (L, 2))
        xy = (px - K_REF[:2, 2]) / K_REF[[0, 1], [0, 1]]
        X = np.c_[xy, np.ones(L)] * rng.uniform(5.0, 14.0, (L, 1))
        uv = (_distort(xy, d) * K_REF[[0, 1], [0, 1]] + K_REF[:2, 2]
              + rng.normal(0.0, 0.5, (L, 2)))
        moved = rng.random(L) < outliers
        n_moved = int(moved.sum())
        X[moved] += rng.uniform(1.0, 3.0, (n_moved, 3)) * rng.choice([-1, 1], (n_moved, 3))
        Xs.append(X)
        uvs.append(uv)
        inls.append(rng.random(L) >= masked)
        R0s.append(so3.exp(torch.from_numpy(rng.normal(0, rot, 3).astype(np.float32))).numpy())
        C0s.append(rng.normal(0.0, shift, 3))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f32(R0s), f32(C0s), f32(Xs), f32(uvs), torch.from_numpy(np.asarray(inls)),
            f32(np.stack([K_REF] * D)), f32(np.stack([d] * D)))


def _cost64(case, delta_sq):
    """The LM's weighted cost of `case`'s lanes at poses (R, C), in float64."""
    _, _, X, uv, inl, Ks, dists = (t.double() if t.is_floating_point() else t for t in case)
    cam = ba._pose_cam(Ks, dists)

    def cost(R, C):
        r = ba._project_residual(R.double(), C.double(), cam, X, uv)
        w = ba._huber_weights((r * r).sum(dim=-1), delta_sq) * inl
        return ((r * w[..., None]) ** 2).sum(dim=(-2, -1))
    return cost


def clear_lanes(case, opts, n):
    """Lanes of `case` (frame_lanes' tuple, on any device) whose first n LM
    decisions lie clear of float32 rounding: ba's plain twin in float64,
    one iteration at a time, takes each of its steps below
    opts.max_iterations, and each lowers the weighted cost by at least 1e-4
    of it. A float32 cost rounds at ~1e-6 of itself at these L, and the
    relative-improvement exit is 1.1e-6, so there every float32 form takes
    the same steps and stops at the same iteration; on the other lanes an
    accept may flip at the rounding floor. -> (D,) bool."""
    cost = _cost64(case, opts.huber_delta_sq)
    st = ba.PoseLM(*(t.double() if t.is_floating_point() else t
                     for t in ba.pose_lm_init(case[0], case[1])))
    X, uv, inl, Ks, dists = (t.double() if t.is_floating_point() else t for t in case[2:])
    clear = torch.ones(case[0].shape[0], dtype=torch.bool, device=case[0].device)
    for _ in range(min(n, opts.max_iterations)):
        nxt = ba._pose_lm_steps_plain(st, X, uv, inl, Ks, dists, opts, 1)
        c0, c1 = cost(st.R, st.C), cost(nxt.R, nxt.C)
        clear &= st.active & (c0 - c1 >= 1e-4 * c0)
        st = nxt
    return clear


# A float32 cost's rounding at these L, relative: a pose whose float64
# cost lies this close to the float64 twin's is as good as float32 can tell
# (the float32 twin's own converged poses read up to 2.2e-7 above it).
COST_FLOOR = 1e-6


def cost_excess(case, opts, got, exact):
    """Per lane, how far the float64 cost at `got`'s pose lies above the
    cost at `exact`'s (the float64 twin's), relative to the latter. Where
    an accept flipped at the rounding floor a lane stops or stands one step
    from the twin's pose, up to a few 1e-5 in C along a flat valley, at a
    cost ~1e-7 above it: below COST_FLOOR."""
    cost = _cost64(case, opts.huber_delta_sq)
    ce = cost(exact.R, exact.C)
    return (cost(got.R, got.C) - ce) / ce
