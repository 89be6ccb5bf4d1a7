"""Bundle adjustment: Levenberg-Marquardt with the Schur complement, the
pose-only refinement and the pose covariance (counterpart of
coloc_tpu.sfm.ba).

Reference parity: Refiner.hpp — Huber loss delta^2 = 16 (:122), Marquardt
damping relative to the Hessian diagonal (SPARSE_SCHUR, :158-173),
Ceres-style function / parameter tolerances, and ceres::Covariance for the
6x6 pose block (:177-202). Pose perturbations are (w, dC): rotation tangent
and CENTER shift, and the covariance is returned in that order.

  refine            — full BA over V views and L landmarks (first pose
                      fixed at the bootstrap, Reconstructor.hpp:150-161),
                      or poses only (optimize_structure=False)
  refine_pose_only  — one pose, structure fixed (Localizer.hpp:132-133)

Three forms differ from coloc_tpu's and give the same result:
  - Jacobians are analytic (coloc_tpu takes them with jax.jacfwd);
    tests/test_torch_localize.py and tests/test_torch_bootstrap.py hold
    them against torch.func.jacfwd.
  - The LM loops exit when the host reads `done` after each step (one
    device sync per iteration) where coloc_tpu uses lax.while_loop.
  - Masked observations are selected out (torch.where) rather than
    multiplied by 0, and a landmark block with no observation is the
    identity before the eigh inverse, so nothing non-finite reaches
    torch.linalg.eigh; neither changes a step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from coloc_tpu_torch.config import RefinerOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import so3


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem: V views, L landmarks; obs[v, l] is the
    distorted pixel of landmark l in view v where obs_mask[v, l]."""

    Rs: torch.Tensor        # (V, 3, 3)
    Cs: torch.Tensor        # (V, 3)
    X: torch.Tensor         # (L, 3)
    obs: torch.Tensor       # (V, L, 2)
    obs_mask: torch.Tensor  # (V, L) bool
    Ks: torch.Tensor        # (V, 3, 3) intrinsics (held constant)
    dists: torch.Tensor     # (V, 3) radial k1, k2, k3


class BAResult(NamedTuple):
    Rs: torch.Tensor
    Cs: torch.Tensor
    X: torch.Tensor
    cov: torch.Tensor      # (6, 6) pose covariance of `cov_view`
    rmse: torch.Tensor     # () float32
    n_obs: torch.Tensor    # () int32
    iterations: int = 0    # LM iterations run (read on the host)


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


def _jacobians(R, C, cam: cam_ops.Camera, X, uv
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals r (L, 2) and their Jacobians with respect to the pose
    perturbation (w, dC) at zero, (L, 2, 6), and to the landmark, (L, 2, 3).
    The perturbed pose is (exp(w) R, C + dC): dXc/dw = -[Xc]_x,
    dXc/ddC = -R, dXc/dX = R, then the chain through the clamped
    perspective divide and the radial distortion."""
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
    return d_pix @ d_pose, d_pix @ R, _project_residual(R, C, cam, X, uv)


def _jac_res(R, C, cam: cam_ops.Camera, X, uv
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose Jacobians (L, 2, 6) and residuals r (L, 2)."""
    Jp, _, r = _jacobians(R, C, cam, X, uv)
    return Jp, r


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
    iterations = 0
    for iterations in range(1, opts.max_iterations + 1):
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
        X=X, cov=cov, rmse=rmse, n_obs=n_obs, iterations=iterations)


def _linearize(problem: BAProblem, Rs, Cs, X, delta_sq: float,
               free: torch.Tensor):
    """Huber-weighted Jacobians of every observation: Jp (V, L, 2, 6) (zero
    for fixed poses), Jx (V, L, 2, 3), weighted residuals rw (V, L, 2)."""
    Jps, Jxs, rs = [], [], []
    for v in range(Rs.shape[0]):
        cam = cam_ops.Camera(K=problem.Ks[v], dist=problem.dists[v])
        Jp, Jx, r = _jacobians(Rs[v], Cs[v], cam, X, problem.obs[v])
        Jps.append(Jp)
        Jxs.append(Jx)
        rs.append(r)
    Jp, Jx, r = torch.stack(Jps), torch.stack(Jxs), torch.stack(rs)
    m = problem.obs_mask
    w = _huber_weights((r * r).sum(dim=-1), delta_sq)
    Jp = torch.where(m[..., None, None], Jp * w[..., None, None], 0.0)
    Jx = torch.where(m[..., None, None], Jx * w[..., None, None], 0.0)
    rw = torch.where(m[..., None], r * w[..., None], 0.0)
    return Jp * free[:, None, None, None], Jx, rw


def _masked_residuals(problem: BAProblem, Rs, Cs, X) -> torch.Tensor:
    """(V, L, 2) reprojection residuals, masked entries zero."""
    r = torch.stack([
        _project_residual(Rs[v], Cs[v],
                          cam_ops.Camera(K=problem.Ks[v], dist=problem.dists[v]),
                          X, problem.obs[v])
        for v in range(Rs.shape[0])])
    return torch.where(problem.obs_mask[..., None], r, 0.0)


def _weighted_cost(problem: BAProblem, Rs, Cs, X, delta_sq: float):
    r = _masked_residuals(problem, Rs, Cs, X)
    w = _huber_weights((r * r).sum(dim=-1), delta_sq)
    return ((r * w[..., None]) ** 2).sum()


def _landmark_inv(Vb: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """PSD inverse of the (L, 3, 3) landmark blocks; a landmark seen by no
    view gets the identity (its Wb and gx are zero, so its step is too)."""
    eye = torch.eye(3, dtype=Vb.dtype, device=Vb.device)
    return _spd_inv(torch.where(observed[:, None, None], Vb, eye))


def _reduced_system(U, Wb, Vinv, free_mask):
    """The (6V, 6V) reduced camera system U - W V^-1 W^T (U alone when Wb is
    None), with identity rows and columns for fixed poses."""
    V = U.shape[0]
    idx = torch.arange(V, device=U.device)
    if Wb is None:
        S = torch.zeros((V, V, 6, 6), dtype=U.dtype, device=U.device)
        WVinv = None
    else:
        WVinv = torch.einsum("vlij,ljk->vlik", Wb, Vinv)            # (V, L, 6, 3)
        S = -torch.einsum("vlik,wljk->vwij", WVinv, Wb)             # (V, V, 6, 6)
    S[idx, idx] = S[idx, idx] + U
    S_full = S.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
    S_full = S_full * free_mask[:, None] * free_mask[None, :]
    S_full = S_full + torch.diag(torch.where(free_mask > 0, 0.0, 1.0))
    return S_full, WVinv


def refine(problem: BAProblem, opts: RefinerOptions, fix_pose: torch.Tensor,
           optimize_structure: bool = True, cov_view: int = 1) -> BAResult:
    """LM bundle adjustment -> refined poses and structure, the 6x6
    covariance of pose `cov_view`, rmse. `fix_pose` (V,) bool holds poses
    constant. The Schur complement eliminates the (L, 3, 3) landmark
    blocks; the (6V, 6V) system is solved by the eigh-floored PSD inverse,
    as in coloc_tpu. Exits as coloc_tpu's while_loop: an accepted step with
    a relative improvement below 10 tol + 1e-6, a step below _STEP_TOL of
    the state, or damping at its 1e8 cap."""
    V = problem.Rs.shape[0]
    dev = problem.X.device
    delta_sq = opts.huber_delta_sq
    free = (~fix_pose).to(torch.float32)
    free_mask = free.repeat_interleave(6)
    observed = problem.obs_mask.any(dim=0)
    n_obs = problem.obs_mask.to(torch.int32).sum()

    def step(Rs, Cs, X, lam):
        Jp, Jx, rw = _linearize(problem, Rs, Cs, X, delta_sq, free)
        cost = (rw * rw).sum()
        U = torch.einsum("vlri,vlrj->vij", Jp, Jp)
        gp = -torch.einsum("vlri,vlr->vi", Jp, rw)
        # Marquardt scaling: damping relative to the clamped diagonal
        U_d = U + lam * torch.diag_embed(
            torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), _DIAG_MIN, _DIAG_MAX))
        if not optimize_structure:
            S_full, _ = _reduced_system(U_d, None, None, free_mask)
            dp = (_spd_inv(S_full) @ (gp.reshape(-1) * free_mask)).reshape(V, 6)
            return dp, torch.zeros_like(X), cost
        Wb = torch.einsum("vlri,vlrj->vlij", Jp, Jx)
        Vb = torch.einsum("vlri,vlrj->lij", Jx, Jx)
        gx = -torch.einsum("vlri,vlr->li", Jx, rw)
        Vb_d = Vb + lam * torch.diag_embed(
            torch.clamp(torch.diagonal(Vb, dim1=-2, dim2=-1), _DIAG_MIN, _DIAG_MAX))
        Vinv = _landmark_inv(Vb_d, observed)
        S_full, WVinv = _reduced_system(U_d, Wb, Vinv, free_mask)
        rhs = gp - torch.einsum("vlik,lk->vi", WVinv, gx)
        dp = (_spd_inv(S_full) @ (rhs.reshape(-1) * free_mask)).reshape(V, 6)
        dX = torch.einsum("lij,lj->li", Vinv,
                          gx - torch.einsum("vlij,vi->lj", Wb, dp))
        return dp, dX, cost

    Rs, Cs, X = problem.Rs, problem.Cs, problem.X
    lam = torch.tensor(1e-3, device=dev)
    nu = torch.tensor(4.0, device=dev)
    iterations = 0
    for iterations in range(1, opts.max_iterations + 1):
        dp, dX, cost = step(Rs, Cs, X, lam)
        Rn = so3.exp(dp[:, :3]) @ Rs
        Cn = Cs + dp[:, 3:]
        Xn = X + dX
        new_cost = _weighted_cost(problem, Rn, Cn, Xn, delta_sq)
        accept = new_cost < cost
        rel_improve = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        done = accept & (rel_improve < opts.tolerance * 10.0 + 1e-6)
        # parameter tolerance: a step below the relative floor has converged
        step_norm = torch.sqrt((dp * dp).sum() + (dX * dX).sum())
        state_norm = torch.sqrt((Cs * Cs).sum() + (X * X).sum() + V)
        done = done | (step_norm <= _STEP_TOL * (state_norm + _STEP_TOL))
        Rs = torch.where(accept, Rn, Rs)
        Cs = torch.where(accept, Cn, Cs)
        X = torch.where(accept, Xn, X)
        # Nielsen-style escalation on consecutive rejections
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                              torch.clamp(lam * nu, max=1e8))
        nu = torch.where(accept, 4.0, torch.clamp(nu * 2.0, max=1e4))
        lam = lam_new
        if bool(done | (lam_new >= 1e8)):
            break

    cov = _pose_covariance(problem, Rs, Cs, X, free, free_mask, observed,
                           optimize_structure, cov_view, delta_sq)
    r = _masked_residuals(problem, Rs, Cs, X)
    rmse = torch.sqrt((r * r).sum() / torch.clamp(n_obs, min=1))
    return BAResult(Rs=Rs, Cs=Cs, X=X, cov=cov, rmse=rmse, n_obs=n_obs,
                    iterations=iterations)


def _pose_covariance(problem, Rs, Cs, X, free, free_mask, observed,
                     optimize_structure, cov_view, delta_sq) -> torch.Tensor:
    """6x6 block `cov_view` of the inverse undamped reduced camera system
    (ceres::Covariance parity, Refiner.hpp:177-202)."""
    Jp, Jx, _ = _linearize(problem, Rs, Cs, X, delta_sq, free)
    U = torch.einsum("vlri,vlrj->vij", Jp, Jp)
    if optimize_structure:
        Wb = torch.einsum("vlri,vlrj->vlij", Jp, Jx)
        Vinv = _landmark_inv(torch.einsum("vlri,vlrj->lij", Jx, Jx), observed)
        S_full, _ = _reduced_system(U, Wb, Vinv, free_mask)
    else:
        S_full, _ = _reduced_system(U, None, None, free_mask)
    i = cov_view * 6
    return _spd_inv(S_full)[i:i + 6, i:i + 6]
