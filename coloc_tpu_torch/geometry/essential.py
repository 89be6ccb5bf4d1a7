"""Essential-matrix residuals, decomposition and manifold refinement
(counterpart of the model-E part of coloc_tpu.geometry.essential).

Reference parity: OpenMVG SymmetricEpipolarDistanceError inside the
ACRANSAC essential kernel (RobustMatcher.hpp:161-171) and
RelativePoseFromEssential's cheirality vote (RobustMatcher.hpp:180).
Convention: x_cam2 = R (x_cam1 - C), t = -R C.

refine_relative_pose is Gauss-Newton over (R in SO(3), t on S^2). Its
Jacobian comes from torch.func.jacfwd, as coloc_tpu's from jax.jacfwd, and
its early exit is coloc_tpu's lax.while_loop in done-mask form: a stopped
loop changes nothing, and the host reads whether it stopped every
`check_every` steps. torch.func's forward-mode levels are process-wide,
so a lock lets one thread at a time take the Jacobian (sessions stepping
on two threads, as distributed.DronePeers in one process do, would
otherwise enter and leave each other's levels).

Model F's solvers take pixels: seven_point (OpenMVG's SevenPointSolver,
RobustMatcher.hpp:134-150; up to 3 candidates a sample) and the
Hartley-normalized fundamental_8pt of the least-squares re-fit;
eight_point is the linear E. Each takes a leading batch axis. A null
space from QR or eigh has a free sign (and QR's 2-D basis a free
rotation), which torch and LAPACK-through-XLA may pick differently: the
candidate set of F is the same up to sign and scale, not its order.
"""

from __future__ import annotations

import math
import threading
from typing import Tuple

import torch

from coloc_tpu_torch.geometry import so3

_JACFWD_LOCK = threading.Lock()


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def _epipolar_design_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of the epipolar constraint x2^T E x1 = 0: (..., N, 2) -> (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """(..., 9) eigenvector of the least eigenvalue of A^T A, as (..., 3, 3)."""
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0].reshape(A.shape[:-2] + (3, 3))


def eight_point(x1, x2, weights=None) -> torch.Tensor:
    """Linear 8-point E from (..., N >= 8, 2) normalized coords: the least
    eigenvector of A^T A, projected to singular values (s, s, 0)."""
    A = _epipolar_design_rows(x1, x2)
    if weights is not None:
        A = A * weights[..., None]
    U, sv, Vt = torch.linalg.svd(_smallest_eigvec(A))
    sig = (sv[..., 0] + sv[..., 1]) / 2.0
    diag = torch.stack([sig, sig, torch.zeros_like(sig)], dim=-1)
    return U @ (diag[..., None] * Vt)


def _hartley(x: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor):
    """Weighted Hartley normalization of (..., N, 2) -> (x', T (..., 3, 3))."""
    mean = (x * w[..., None]).sum(dim=-2) / wsum[..., None]
    dist = torch.linalg.norm(x - mean[..., None, :], dim=-1)
    scale = 2.0 ** 0.5 / ((dist * w).sum(dim=-1) / wsum + 1e-9)
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, z, -scale * mean[..., 0]], dim=-1),
                     torch.stack([z, scale, -scale * mean[..., 1]], dim=-1),
                     torch.stack([z, z, o], dim=-1)], dim=-2)
    return (x - mean[..., None, :]) * scale[..., None, None], T


def fundamental_8pt(x1, x2, weights=None) -> torch.Tensor:
    """8-point F with Hartley normalization and the rank-2 projection, from
    (..., N, 2) pixels; `weights` (..., N) gives the least-squares re-fit
    over an inlier set. Scaled so F[2, 2] = 1."""
    w = torch.ones_like(x1[..., 0]) if weights is None else weights
    wsum = w.sum(dim=-1) + 1e-9
    x1n, T1 = _hartley(x1, w, wsum)
    x2n, T2 = _hartley(x2, w, wsum)
    U, sv, Vt = torch.linalg.svd(_smallest_eigvec(_epipolar_design_rows(x1n, x2n)
                                                  * w[..., None]))
    sv = torch.cat([sv[..., :2], torch.zeros_like(sv[..., 2:])], dim=-1)
    F = T2.transpose(-1, -2) @ (U @ (sv[..., None] * Vt)) @ T1
    return F / (F[..., 2:3, 2:3] + 1e-12)


def seven_point(x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """7-point F: (..., 7, 2) pixels -> (..., 3, 3, 3) candidates and
    (..., 3) valid. The 2-D null space of the Hartley-normalized design
    matrix (the last two columns of a complete QR of A^T) spans F1 + lam
    F2; det = 0 is a cubic in lam, its coefficients from the determinants
    at lam = 0, 1, -1, 2 by a Vandermonde solve, its roots by the
    trigonometric form (three real) or Cardano (one real, the other two
    slots invalid). Each candidate is denormalized and scaled to unit
    Frobenius norm."""
    w = torch.ones_like(x1[..., 0])
    wsum = w.sum(dim=-1)
    # the mean and the mean distance, as coloc_tpu's unweighted form
    x1n, T1 = _hartley(x1, w, wsum)
    x2n, T2 = _hartley(x2, w, wsum)
    A = _epipolar_design_rows(x1n, x2n)                        # (..., 7, 9)
    q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    lead = A.shape[:-2]
    F1 = q[..., :, 7].reshape(lead + (3, 3))
    F2 = q[..., :, 8].reshape(lead + (3, 3))
    dev = A.device
    ts = torch.tensor([0.0, 1.0, -1.0, 2.0], dtype=A.dtype, device=dev)
    ds = torch.linalg.det(F1[..., None, :, :] + ts[:, None, None] * F2[..., None, :, :])
    V = torch.stack([ts ** 0, ts, ts ** 2, ts ** 3], dim=1)
    c = torch.linalg.solve_ex(V.expand(lead + (4, 4)), ds[..., None])[0][..., 0]
    c3 = torch.where(c[..., 3].abs() < 1e-12, 1e-12, c[..., 3])
    a, b_, cc = c[..., 2] / c3, c[..., 1] / c3, c[..., 0] / c3
    # the depressed cubic t^3 + p t + q, lam = t - a / 3
    p = b_ - a * a / 3.0
    q_ = 2.0 * a ** 3 / 27.0 - a * b_ / 3.0 + cc
    disc = (q_ / 2.0) ** 2 + (p / 3.0) ** 3
    m = 2.0 * torch.sqrt(torch.clamp(-p / 3.0, min=1e-12))
    arg = torch.clamp(3.0 * q_ / (p * m + 1e-12), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    k = torch.arange(3, dtype=A.dtype, device=dev)
    t_trig = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(v):
        return torch.sign(v) * v.abs() ** (1.0 / 3.0)

    t_card = cbrt(-q_ / 2.0 + sq) + cbrt(-q_ / 2.0 - sq)
    three_real = (disc <= 0)[..., None]
    t_roots = torch.where(three_real, t_trig, t_card[..., None].expand_as(t_trig))
    valid = three_real | (k == 0)
    lams = t_roots - a[..., None] / 3.0                         # (..., 3)
    Fs = (T2.transpose(-1, -2)[..., None, :, :]
          @ (F1[..., None, :, :] + lams[..., None, None] * F2[..., None, :, :])
          @ T1[..., None, :, :])
    Fs = Fs / (torch.linalg.norm(Fs, dim=(-2, -1), keepdim=True) + 1e-12)
    return Fs, valid


def symmetric_epipolar_distance_sq(E, x1, x2, s1_sq=1.0, s2_sq=1.0) -> torch.Tensor:
    """Squared symmetric point-to-epipolar-line distance, (M,); s1_sq /
    s2_sq scale each image's side (the squared focals give pixels)."""
    h1, h2 = _homog(x1), _homog(x2)
    Ex1 = h1 @ E.T                  # epipolar line of x1 in image 2
    Etx2 = h2 @ E                   # epipolar line of x2 in image 1
    num = (h2 * Ex1).sum(dim=-1) ** 2
    d_img2 = num / (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + 1e-12)
    d_img1 = num / (Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2 + 1e-12)
    return s2_sq * d_img2 + s1_sq * d_img1


def symmetric_epipolar_distance_sq_batch(Es, x1, x2, s1_sq=1.0, s2_sq=1.0
                                         ) -> torch.Tensor:
    """All models at once, (Hm, M): three (Hm, 9) x (9, M) products of
    quadratic forms and an epilogue; the denominators clamp at 1e-12."""
    Hm, M = Es.shape[0], x1.shape[0]
    h1, h2 = _homog(x1), _homog(x2)
    O = (h2[:, :, None] * h1[:, None, :]).reshape(M, 9)
    A = Es.reshape(Hm, 9) @ O.T
    num = A * A
    rows = Es[:, :2, :]
    S1 = torch.einsum("had,hak->hdk", rows, rows).reshape(Hm, 9)
    cols = Es[:, :, :2]
    S2 = torch.einsum("hda,hka->hdk", cols, cols).reshape(Hm, 9)
    P1 = (h1[:, :, None] * h1[:, None, :]).reshape(M, 9)
    P2 = (h2[:, :, None] * h2[:, None, :]).reshape(M, 9)
    den2 = torch.clamp(S1 @ P1.T, min=1e-12)
    den1 = torch.clamp(S2 @ P2.T, min=1e-12)
    return s2_sq * num / den2 + s1_sq * num / den1


def sampson_distance_sq(E, x1, x2) -> torch.Tensor:
    """First-order geometric (Sampson) epipolar error, (M,)."""
    h1, h2 = _homog(x1), _homog(x2)
    Ex1 = h1 @ E.T
    Etx2 = h2 @ E
    num = (h2 * Ex1).sum(dim=-1) ** 2
    denom = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / (denom + 1e-12)


def hat3(w: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(w[0])
    return torch.stack([torch.stack([zero, -w[2], w[1]]),
                        torch.stack([w[2], zero, -w[0]]),
                        torch.stack([-w[1], w[0], zero])])


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(3, 2) orthonormal basis of the plane orthogonal to unit t."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where(t[0].abs() < 0.9, ex, ey)
    b1 = a - t * torch.dot(a, t)
    b1 = b1 / (torch.linalg.norm(b1) + 1e-12)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=1)


def _weighted_sampson(R, t, x1, x2, weights):
    return torch.sqrt(sampson_distance_sq(hat3(t) @ R, x1, x2) + 1e-12) * weights


def refine_relative_pose(R, t, x1, x2, weights, iters: int = 8,
                         check_every: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on the essential manifold: weighted Sampson error over
    5 DoF (so planar scenes stay well-posed). Stops on a rejected step, a
    step below 1e-6 or a relative improvement below 1e-7, as coloc_tpu;
    the host reads whether it stopped every `check_every` steps."""
    p0 = torch.zeros(5, dtype=R.dtype, device=R.device)
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)
    active = torch.ones((), dtype=torch.bool, device=R.device)
    for it in range(1, iters + 1):
        B = _tangent_basis(t)

        def resid(p):
            tp = t + B @ p[3:]
            tp = tp / (torch.linalg.norm(tp) + 1e-12)
            # a batch of one: under jacfwd a 0-dim tensor meeting a Python
            # float promotes to float64
            return _weighted_sampson(so3.exp(p[None, :3])[0] @ R, tp, x1, x2,
                                     weights)

        r = resid(p0)
        with _JACFWD_LOCK:
            J = torch.func.jacfwd(resid)(p0)                 # (M, 5)
        # solve_ex: singular normal equations (degenerate inliers) give a
        # non-finite step that the cost test rejects, as jnp.linalg.solve's
        # does in coloc_tpu, where linalg.solve raises (on the card)
        p = -torch.linalg.solve_ex(J.T @ J + 1e-8 * eye5, J.T @ r).result
        R_new = so3.exp(p[:3]) @ R
        t_new = t + B @ p[3:]
        t_new = t_new / (torch.linalg.norm(t_new) + 1e-12)
        c_old = (r ** 2).sum()
        c_new = (_weighted_sampson(R_new, t_new, x1, x2, weights) ** 2).sum()
        better = active & (c_new < c_old)
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        done = (~better | ((p * p).sum() < 1e-12)
                | (c_old - c_new < 1e-7 * (c_old + 1e-20)))
        active = active & ~done
        if it % check_every == 0 and it < iters and not bool(active):
            break
    return R, t


def decompose_essential(E, x1, x2, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """E -> (R, t) of most cheirality votes over the masked correspondences:
    the closed-form extraction of coloc_tpu (t the largest cross product of
    two columns, R = -[t]x E + Cof(E) and its twisted mate, one polar
    step), then the 4 candidates vote by two-view depth signs; the first
    of equal votes wins (jnp.argmax)."""
    c0, c1, c2 = E[:, 0], E[:, 1], E[:, 2]
    crosses = torch.stack([torch.linalg.cross(c0, c1), torch.linalg.cross(c0, c2),
                           torch.linalg.cross(c1, c2)])
    norms = (crosses * crosses).sum(dim=1)
    t = crosses[torch.argmax(norms)]          # torch.argmax: first maximum
    t = t / (torch.linalg.norm(t) + 1e-12)
    Es = E * (2.0 ** 0.5 / (torch.linalg.norm(E) + 1e-12))
    cof = torch.stack([torch.linalg.cross(Es[:, 1], Es[:, 2]),
                       torch.linalg.cross(Es[:, 2], Es[:, 0]),
                       torch.linalg.cross(Es[:, 0], Es[:, 1])], dim=1)
    tx = hat3(t)

    def polar_fix(R):
        return 1.5 * R - 0.5 * R @ (R.T @ R)

    R1 = polar_fix(-tx @ Es + cof)
    R2 = polar_fix(tx @ Es + cof)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])

    h1, h2 = _homog(x1), _homog(x2)
    Rx1 = torch.einsum("cij,mj->cmi", Rs, h1)                # (4, M, 3)
    cr = torch.linalg.cross(h2.expand_as(Rx1), Rx1)
    ct = torch.linalg.cross(h2[None].expand_as(Rx1), ts[:, None, :].expand_as(Rx1))
    z1 = -(cr * ct).sum(dim=-1) / ((cr * cr).sum(dim=-1) + 1e-12)
    z2 = (z1[..., None] * Rx1 + ts[:, None, :])[..., 2]
    votes = ((z1 > 0) & (z2 > 0) & mask[None]).to(torch.int32).sum(dim=1)
    k = torch.argmax(votes)
    return Rs[k], ts[k]
