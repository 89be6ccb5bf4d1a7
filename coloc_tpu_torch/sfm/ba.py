"""Pose-only Levenberg-Marquardt refinement + pose covariance (counterpart
of refine_pose_only in coloc_tpu.sfm.ba).

Reference parity: Refiner.hpp — Huber loss delta^2 = 16 (:122), Marquardt
damping relative to the Hessian diagonal, Ceres-style function / gradient /
parameter tolerances, and ceres::Covariance for the 6x6 pose block
(:177-202). Pose perturbations are (w, dC): rotation tangent and CENTER
shift, and the covariance is returned in that order.

Two forms differ from coloc_tpu's and give the same result:
  - Jacobians are analytic (coloc_tpu takes them with jax.jacfwd);
    tests/test_torch_localize.py holds them against jacfwd.
  - The LM loop exits when the host reads `done` after each step (one
    device sync per iteration) where coloc_tpu uses lax.while_loop.
The generic multi-view `refine` (Schur complement) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from coloc_tpu_torch.config import RefinerOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import so3


class BAResult(NamedTuple):
    Rs: torch.Tensor
    Cs: torch.Tensor
    X: torch.Tensor
    cov: torch.Tensor      # (6, 6) pose covariance of view 1
    rmse: torch.Tensor     # () float32
    n_obs: torch.Tensor    # () int32


# Marquardt damping diagonal clamp (Ceres min_diagonal/max_diagonal parity)
_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32
# relative parameter tolerance of the small-step exit (see coloc_tpu.sfm.ba)
_STEP_TOL = 1e-5


def _project_residual(R, C, cam: cam_ops.Camera, X, uv) -> torch.Tensor:
    return cam_ops.project(cam, R, C, X) - uv


def _huber_weights(res_sq: torch.Tensor, delta_sq: float) -> torch.Tensor:
    """IRLS sqrt-weights for the Huber loss."""
    w = torch.where(res_sq <= delta_sq, 1.0,
                    torch.sqrt(delta_sq / torch.clamp(res_sq, min=1e-12)))
    return torch.sqrt(w)


def _spd_inv(M: torch.Tensor, rel_floor: float = 1e-6) -> torch.Tensor:
    """Inverse of symmetric PSD blocks via eigh with a RELATIVE eigenvalue
    floor (robust where an LU inverse NaNs out). (..., n, n)."""
    evals, evecs = torch.linalg.eigh(M)
    floor = rel_floor * evals.abs().amax(dim=-1, keepdim=True) + 1e-12
    inv_evals = 1.0 / torch.maximum(evals, floor)
    return torch.einsum("...ij,...j,...kj->...ik", evecs, inv_evals, evecs)


def _jac_res(R, C, cam: cam_ops.Camera, X, uv
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residuals r (L, 2) and their Jacobians (L, 2, 6) with respect to the
    pose perturbation (w, dC) at zero, where the perturbed pose is
    (exp(w) R, C + dC): dXc/dw = -[Xc]_x, dXc/ddC = -R, then the chain
    through the clamped perspective divide and the radial distortion."""
    Xc = (X - C) @ R.T                                   # (L, 3)
    z = Xc[:, 2]
    zc = torch.clamp(z, min=1e-9)
    inv = 1.0 / zc
    xy = Xc[:, :2] * inv[:, None]
    k1, k2, k3 = cam.dist[0], cam.dist[1], cam.dist[2]
    r2 = (xy * xy).sum(dim=-1)
    dfac = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)          # d factor / d r2
    fac = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))

    L = X.shape[0]
    zero = torch.zeros_like(z)
    through_z = torch.where(z > 1e-9, inv, zero)         # the clamp cuts dz
    d_xy = torch.stack([
        torch.stack([inv, zero, -xy[:, 0] * through_z], dim=-1),
        torch.stack([zero, inv, -xy[:, 1] * through_z], dim=-1),
    ], dim=1)                                            # (L, 2, 3)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    d_dist = (fac[:, None, None] * eye2
              + 2.0 * dfac[:, None, None] * xy[:, :, None] * xy[:, None, :])
    f = torch.stack([cam.fx, cam.fy])
    d_pix = f[None, :, None] * (d_dist @ d_xy)           # (L, 2, 3)
    d_pose = torch.cat([-so3.hat(Xc), -R.expand(L, 3, 3)], dim=-1)  # (L, 3, 6)
    J = d_pix @ d_pose                                   # (L, 2, 6)
    return J, _project_residual(R, C, cam, X, uv)


def refine_pose_only(
    R0: torch.Tensor,       # (3, 3) initial rotation
    C0: torch.Tensor,       # (3,) initial center
    X: torch.Tensor,        # (L, 3) fixed structure
    uv: torch.Tensor,       # (L, 2) distorted pixel observations
    inliers: torch.Tensor,  # (L,) bool
    K: torch.Tensor,
    dist: torch.Tensor,
    opts: RefinerOptions,
) -> BAResult:
    """Single-pose LM with structure fixed (Localizer.hpp:132-133). The 6x6
    damped system is solved by Cholesky per step; the eigh-based PSD inverse
    runs once at the end for the covariance. Rs/Cs stack a fixed identity
    view 0 with the refined pose at index 1 (cov_view=1 convention)."""
    delta_sq = opts.huber_delta_sq
    dev = R0.device
    mask_f = inliers.to(torch.float32)
    n_obs = inliers.to(torch.int32).sum()
    cam = cam_ops.Camera(K=K, dist=dist)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def weighted_cost(R, C):
        r = _project_residual(R, C, cam, X, uv)
        w = _huber_weights((r * r).sum(dim=-1), delta_sq) * mask_f
        return ((r * w[:, None]) ** 2).sum()

    R, C = R0, C0
    lam = torch.tensor(1e-3, device=dev)
    nu = torch.tensor(4.0, device=dev)
    g0_norm = None
    for _ in range(opts.max_iterations):
        J, r = _jac_res(R, C, cam, X, uv)
        w = _huber_weights((r * r).sum(dim=-1), delta_sq) * mask_f
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        cost = (rw * rw).sum()
        U = torch.einsum("lri,lrj->ij", Jw, Jw)
        g = -torch.einsum("lri,lr->i", Jw, rw)
        # Marquardt scaling: damping RELATIVE to the Hessian diagonal
        U_d = U + lam * torch.diag(torch.clamp(torch.diagonal(U), _DIAG_MIN, _DIAG_MAX))
        chol, info = torch.linalg.cholesky_ex(U_d + 1e-12 * eye6)
        dp = torch.cholesky_solve(g[:, None], chol)[:, 0]
        dp = torch.where(torch.isfinite(dp) & (info == 0), dp, 0.0)
        Rn = so3.exp(dp[:3]) @ R
        Cn = C + dp[3:]
        new_cost = weighted_cost(Rn, Cn)
        accept = new_cost < cost
        rel_improve = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        done = accept & (rel_improve < opts.tolerance * 10.0 + 1e-6)
        # gradient tolerance, relative to the first step's gradient
        g_norm = g.abs().amax()
        g0_norm = g_norm if g0_norm is None else g0_norm
        done = done | (g_norm <= 1e-6 * g0_norm + 1e-12)
        # parameter tolerance: a step below the relative floor has converged
        step_norm = torch.sqrt((dp * dp).sum())
        done = done | (step_norm <= _STEP_TOL * (torch.sqrt((C * C).sum() + 1.0)
                                                 + _STEP_TOL))
        R = torch.where(accept, Rn, R)
        C = torch.where(accept, Cn, C)
        # Nielsen-style escalation on consecutive rejections
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                              torch.clamp(lam * nu, max=1e8))
        nu = torch.where(accept, 4.0, torch.clamp(nu * 2.0, max=1e4))
        lam = lam_new
        if bool(done | (lam_new >= 1e8)):
            break

    # covariance + rmse at the solution (undamped; PSD-robust inverse once)
    J, r = _jac_res(R, C, cam, X, uv)
    res_sq = (r * r).sum(dim=-1)
    Jw = J * (_huber_weights(res_sq, delta_sq) * mask_f)[:, None, None]
    cov = _spd_inv(torch.einsum("lri,lrj->ij", Jw, Jw))
    rmse = torch.sqrt((res_sq * mask_f).sum() / torch.clamp(n_obs, min=1))
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    return BAResult(
        Rs=torch.stack([eye3, R]), Cs=torch.stack([torch.zeros_like(C), C]),
        X=X, cov=cov, rmse=rmse, n_obs=n_obs)
