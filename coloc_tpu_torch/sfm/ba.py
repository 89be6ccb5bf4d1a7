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
  refine_pose_only  — one pose per drone, structure fixed
                      (Localizer.hpp:132-133), over a leading drone axis;
                      pose_lm_init / pose_lm_steps / pose_lm_finish are its
                      three parts, which a captured frame step replays.
                      For CUDA tensors pose_lm_steps is one launch of
                      csrc/pose_lm.cu's LM kernel (a call's iterations) and
                      pose_lm_finish one of its covariance kernel; the
                      PyTorch forms here are their plain twins (the CPU path)

The LM loops are in done-mask form, coloc_tpu's lax.while_loop written
out: a lane (a drone, or the one problem of `refine`) carries `active`,
changes its state only while active, and stops with the reference's tests
and constants; the iteration in which it stops still applies its update.
The host reads `active.any()` only every `check_every` iterations, and a
masked iteration changes nothing, so every `check_every` gives the same
bits; `check_every` = max_iterations reads nothing.

Four forms differ from coloc_tpu's and give the same result:
  - Jacobians are analytic (coloc_tpu takes them with jax.jacfwd);
    tests/test_torch_localize.py and tests/test_torch_bootstrap.py hold
    them against torch.func.jacfwd.
  - The pose-only 6x6 damped system is solved by Cholesky and two
    triangular solves, its covariance inverse by a cyclic Jacobi
    eigensolver with a fixed sweep count (`_spd_inv_jacobi`): neither reads
    the host. `refine` keeps torch.linalg.eigh (`_spd_inv`) for its
    landmark blocks of condition ~1e11, where the floor bites.
  - Masked observations are selected out (torch.where) rather than
    multiplied by 0, and a landmark block with no observation is the
    identity before the eigh inverse, so nothing non-finite reaches
    torch.linalg.eigh; neither changes a step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from coloc_tpu_torch.config import RefinerOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.ops import _build, dispatch
from coloc_tpu_torch.profiling import span


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
    # LM iterations each lane ran, int32 on the device: (D,) for
    # refine_pose_only's drone axis, () for refine
    iterations: torch.Tensor


# Marquardt damping diagonal clamp (Ceres min_diagonal/max_diagonal parity)
_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32
# relative parameter tolerance of the small-step exit (see coloc_tpu.sfm.ba)
_STEP_TOL = 1e-5
# cyclic Jacobi on 6x6: 5 rounds of 3 disjoint pairs cover the 15 pairs
_JACOBI_ROUNDS = (((0, 1), (2, 3), (4, 5)), ((0, 2), (1, 4), (3, 5)),
                  ((0, 3), (1, 5), (2, 4)), ((0, 4), (1, 3), (2, 5)),
                  ((0, 5), (1, 2), (3, 4)))
# sweeps of the 5 rounds: float32 6x6 blocks up to cond 1e8 converge in 4
# (tests/test_torch_loop_exit.py), 6 leave a margin
_JACOBI_SWEEPS = 6


def _project_residual(R, C, cam: cam_ops.Camera, X, uv) -> torch.Tensor:
    """(..., L, 2) residuals of X (..., L, 3) through poses R (..., 3, 3),
    C (..., 3) against uv (..., L, 2)."""
    Xc = (X - C[..., None, :]) @ R.transpose(-1, -2)
    return cam_ops.project_cam(cam, Xc) - uv


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


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _jacobi_tables(device: torch.device):
    """Per round: the flat (6x6) positions of (a_pp, a_qq, a_pq) of its 3
    pairs (9,), and of the rotation's (c, c, s, -s) entries (12,)."""
    out = []
    for pairs in _JACOBI_ROUNDS:
        p = [a for a, _ in pairs]
        q = [b for _, b in pairs]
        read = [6 * a + a for a in p] + [6 * b + b for b in q] + [6 * a + b for a, b in zip(p, q)]
        write = ([6 * a + a for a in p] + [6 * b + b for b in q]
                 + [6 * a + b for a, b in zip(p, q)] + [6 * b + a for a, b in zip(p, q)])
        out.append((torch.tensor(read, device=device), torch.tensor(write, device=device)))
    return tuple(out)


def _jacobi_eigh(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (..., 6) and eigenvectors (columns, (..., 6, 6)) of
    symmetric 6x6 blocks by the cyclic Jacobi method: _JACOBI_SWEEPS sweeps
    of 5 rounds, each round rotating 3 disjoint pairs (p, q) at once,
    A <- J^T A J with tan 2 theta = 2 a_pq / (a_qq - a_pp). A fixed count
    of tensor operations, no host read."""
    lead = M.shape[:-2]
    A = M
    V = torch.eye(6, dtype=M.dtype, device=M.device).expand(lead + (6, 6))
    eye = torch.eye(6, dtype=M.dtype, device=M.device).reshape(36)
    for _ in range(_JACOBI_SWEEPS):
        for read, write in _jacobi_tables(M.device):
            a = A.reshape(lead + (36,))[..., read]
            app, aqq, apq = a[..., 0:3], a[..., 3:6], a[..., 6:9]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c, s = torch.cos(theta), torch.sin(theta)
            J = eye.expand(lead + (36,)).index_copy(
                -1, write, torch.cat([c, c, s, -s], dim=-1)).reshape(lead + (6, 6))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def _spd_inv_jacobi(M: torch.Tensor, rel_floor: float = 1e-6) -> torch.Tensor:
    """_spd_inv of (..., 6, 6) blocks on _jacobi_eigh: the same relative
    eigenvalue floor (rel_floor max|lambda| + 1e-12), no host read."""
    evals, evecs = _jacobi_eigh(M)
    floor = rel_floor * evals.abs().amax(dim=-1, keepdim=True) + 1e-12
    inv_evals = 1.0 / torch.maximum(evals, floor)
    return (evecs * inv_evals[..., None, :]) @ evecs.transpose(-1, -2)


def _jacobians(R, C, cam: cam_ops.Camera, X, uv
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals r (..., L, 2) and their Jacobians with respect to the pose
    perturbation (w, dC) at zero, (..., L, 2, 6), and to the landmark,
    (..., L, 2, 3), for poses R (..., 3, 3), C (..., 3). The perturbed pose
    is (exp(w) R, C + dC): dXc/dw = -[Xc]_x, dXc/ddC = -R, dXc/dX = R, then
    the chain through the clamped perspective divide and the radial
    distortion. A camera of a drone axis holds K (D, 1, 3, 3), dist (D, 1, 3)."""
    Xc = (X - C[..., None, :]) @ R.transpose(-1, -2)     # (..., L, 3)
    z = Xc[..., 2]
    zc = torch.clamp(z, min=1e-9)
    inv = 1.0 / zc
    xy = Xc[..., :2] * inv[..., None]
    k1, k2, k3 = cam.dist[..., 0], cam.dist[..., 1], cam.dist[..., 2]
    r2 = (xy * xy).sum(dim=-1)
    dfac = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)          # d factor / d r2
    fac = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))

    zero = torch.zeros_like(z)
    through_z = torch.where(z > 1e-9, inv, zero)         # the clamp cuts dz
    d_xy = torch.stack([
        torch.stack([inv, zero, -xy[..., 0] * through_z], dim=-1),
        torch.stack([zero, inv, -xy[..., 1] * through_z], dim=-1),
    ], dim=-2)                                           # (..., L, 2, 3)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    d_dist = (fac[..., None, None] * eye2
              + 2.0 * dfac[..., None, None] * xy[..., :, None] * xy[..., None, :])
    f = torch.stack([cam.fx, cam.fy], dim=-1)
    d_pix = f[..., None] * (d_dist @ d_xy)               # (..., L, 2, 3)
    Rl = R[..., None, :, :]
    d_pose = torch.cat([-so3.hat(Xc), -Rl.expand(Xc.shape + (3,))], dim=-1)  # (..., L, 3, 6)
    return d_pix @ d_pose, d_pix @ Rl, cam_ops.project_cam(cam, Xc) - uv


def _jac_res(R, C, cam: cam_ops.Camera, X, uv
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose Jacobians (..., L, 2, 6) and residuals r (..., L, 2)."""
    Jp, _, r = _jacobians(R, C, cam, X, uv)
    return Jp, r


class PoseLM(NamedTuple):
    """The pose-only LM's state over D drones (coloc_tpu's while_loop
    carry, plus the done mask)."""

    R: torch.Tensor           # (D, 3, 3)
    C: torch.Tensor           # (D, 3)
    lam: torch.Tensor         # (D,) damping
    nu: torch.Tensor          # (D,) rejection escalation
    g0: torch.Tensor          # (D,) first iteration's gradient max-norm
    active: torch.Tensor      # (D,) bool, False once a lane has stopped
    iterations: torch.Tensor  # (D,) int32 iterations each lane ran
    it: torch.Tensor          # () int32 iterations stepped (the loop index)


def pose_lm_init(R0: torch.Tensor, C0: torch.Tensor) -> PoseLM:
    D = R0.shape[0]
    dev = R0.device
    return PoseLM(R=R0, C=C0, lam=torch.full((D,), 1e-3, device=dev),
                  nu=torch.full((D,), 4.0, device=dev),
                  g0=torch.zeros(D, device=dev),
                  active=torch.ones(D, dtype=torch.bool, device=dev),
                  iterations=torch.zeros(D, dtype=torch.int32, device=dev),
                  it=torch.zeros((), dtype=torch.int32, device=dev))


def _pose_cam(K: torch.Tensor, dist: torch.Tensor) -> cam_ops.Camera:
    """(D, 3, 3), (D, 3) -> a camera that broadcasts over (D, L) points."""
    return cam_ops.Camera(K=K[:, None], dist=dist[:, None])


def pose_lm_steps(state: PoseLM, X, uv, inliers, K, dist, opts: RefinerOptions,
                  n: int) -> PoseLM:
    """`n` masked LM iterations of every drone (X (D, L, 3), uv (D, L, 2),
    inliers (D, L), K (D, 3, 3), dist (D, 3)). An iteration past
    opts.max_iterations, or of a stopped lane, changes nothing but `it`.
    One kernel launch for CUDA tensors, the plain twin for CPU tensors."""
    if dispatch.use_kernel(X):
        return _pose_lm_steps_cuda(state, X, uv, inliers, K, dist, opts, n)
    return _pose_lm_steps_plain(state, X, uv, inliers, K, dist, opts, n)


def _problem_operands(X, uv, inliers, K, dist):
    D, L = X.shape[0], X.shape[1]
    dev = X.device
    ops = (X.contiguous(), uv.contiguous(), inliers.contiguous(), K.contiguous(),
           dist.contiguous())
    for t, name, dtype, shape in zip(
            ops, ("X", "uv", "inliers", "K", "dist"),
            (torch.float32, torch.float32, torch.bool, torch.float32, torch.float32),
            ((D, L, 3), (D, L, 2), (D, L), (D, 3, 3), (D, 3))):
        dispatch.check_operand(t, name, dtype, shape, dev)
    return ops


def _pose_lm_steps_cuda(state: PoseLM, X, uv, inliers, K, dist, opts: RefinerOptions,
                        n: int) -> PoseLM:
    """pose_lm_steps as one pose_lm_kernel launch into a new PoseLM."""
    D, L = X.shape[0], X.shape[1]
    dev = X.device
    problem = _problem_operands(X, uv, inliers, K, dist)
    ins = PoseLM(*(t.contiguous() for t in state))
    for t, name, dtype, shape in zip(
            ins, PoseLM._fields,
            (torch.float32,) * 5 + (torch.bool, torch.int32, torch.int32),
            ((D, 3, 3), (D, 3), (D,), (D,), (D,), (D,), (D,), ())):
        dispatch.check_operand(t, name, dtype, shape, dev)
    outs = PoseLM(*(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in ins))
    _build.launch("coloc_pose_lm", *(t.data_ptr() for t in ins),
                  *(t.data_ptr() for t in problem), *(t.data_ptr() for t in outs),
                  D, L, n, opts.max_iterations, opts.huber_delta_sq,
                  opts.tolerance * 10.0 + 1e-6, dev.index, dispatch.stream_handle(dev))
    dispatch.count_launch("pose_lm")
    return outs


def _pose_lm_steps_plain(state: PoseLM, X, uv, inliers, K, dist, opts: RefinerOptions,
                         n: int) -> PoseLM:
    delta_sq = opts.huber_delta_sq
    mask_f = inliers.to(torch.float32)
    cam = _pose_cam(K, dist)
    eye6 = torch.eye(6, dtype=torch.float32, device=X.device)
    R, C, lam, nu, g0, active, iterations, it = state

    def weighted_cost(Rp, Cp):
        r = _project_residual(Rp, Cp, cam, X, uv)
        w = _huber_weights((r * r).sum(dim=-1), delta_sq) * mask_f
        return ((r * w[..., None]) ** 2).sum(dim=(-2, -1))

    for _ in range(n):
        active = active & (it < opts.max_iterations)
        J, r = _jac_res(R, C, cam, X, uv)
        w = _huber_weights((r * r).sum(dim=-1), delta_sq) * mask_f
        Jw = J * w[..., None, None]
        rw = r * w[..., None]
        cost = (rw * rw).sum(dim=(-2, -1))
        U = torch.einsum("dlri,dlrj->dij", Jw, Jw)
        g = -torch.einsum("dlri,dlr->di", Jw, rw)
        # Marquardt scaling: damping RELATIVE to the Hessian diagonal
        U_d = U + lam[:, None, None] * torch.diag_embed(
            torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), _DIAG_MIN, _DIAG_MAX))
        chol, info = torch.linalg.cholesky_ex(U_d + 1e-12 * eye6)
        y = torch.linalg.solve_triangular(chol, g[..., None], upper=False)
        dp = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)[..., 0]
        dp = torch.where(torch.isfinite(dp) & (info == 0)[:, None], dp, 0.0)
        Rn = so3.exp(dp[:, :3]) @ R
        Cn = C + dp[:, 3:]
        new_cost = weighted_cost(Rn, Cn)
        accept = new_cost < cost
        rel_improve = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        done = accept & (rel_improve < opts.tolerance * 10.0 + 1e-6)
        # gradient tolerance, relative to the first iteration's gradient
        g_norm = g.abs().amax(dim=-1)
        g0 = torch.where(it == 0, g_norm, g0)
        done = done | (g_norm <= 1e-6 * g0 + 1e-12)
        # parameter tolerance: a step below the relative floor has converged
        step_norm = torch.sqrt((dp * dp).sum(dim=-1))
        done = done | (step_norm <= _STEP_TOL * (torch.sqrt((C * C).sum(dim=-1) + 1.0)
                                                 + _STEP_TOL))
        # Nielsen-style escalation on consecutive rejections
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                              torch.clamp(lam * nu, max=1e8))
        nu_new = torch.where(accept, 4.0, torch.clamp(nu * 2.0, max=1e4))
        step = active & accept
        R = torch.where(step[:, None, None], Rn, R)
        C = torch.where(step[:, None], Cn, C)
        lam = torch.where(active, lam_new, lam)
        nu = torch.where(active, nu_new, nu)
        iterations = iterations + active.to(torch.int32)
        active = active & ~(done | (lam_new >= 1e8))
        it = it + 1
    return PoseLM(R, C, lam, nu, g0, active, iterations, it)


def pose_lm_finish(state: PoseLM, X, uv, inliers, K, dist,
                   opts: RefinerOptions) -> BAResult:
    """Covariance (undamped, the floored PSD inverse) and rmse at the LM's
    solution -> BAResult with a leading drone axis: Rs/Cs stack a fixed
    identity view 0 with the refined pose at index 1 (cov_view=1). The
    covariance, rmse and inlier count are one kernel launch for CUDA
    tensors, the plain twin for CPU tensors."""
    R, C = state.R, state.C
    if dispatch.use_kernel(X):
        cov, rmse, n_obs = _pose_cov_cuda(R, C, X, uv, inliers, K, dist,
                                          opts.huber_delta_sq)
    else:
        cov, rmse, n_obs = _pose_cov_plain(R, C, X, uv, inliers, K, dist,
                                           opts.huber_delta_sq)
    eye3 = torch.eye(3, dtype=torch.float32, device=R.device).expand(R.shape)
    return BAResult(
        Rs=torch.stack([eye3, R], dim=1),
        Cs=torch.stack([torch.zeros_like(C), C], dim=1),
        X=X, cov=cov, rmse=rmse, n_obs=n_obs, iterations=state.iterations)


def _pose_cov_cuda(R, C, X, uv, inliers, K, dist, delta_sq: float):
    """_pose_cov_plain as one pose_cov_kernel launch."""
    D, L = X.shape[0], X.shape[1]
    dev = X.device
    problem = _problem_operands(X, uv, inliers, K, dist)
    R, C = R.contiguous(), C.contiguous()
    dispatch.check_operand(R, "R", torch.float32, (D, 3, 3), dev)
    dispatch.check_operand(C, "C", torch.float32, (D, 3), dev)
    cov = torch.empty((D, 6, 6), dtype=torch.float32, device=dev)
    rmse = torch.empty(D, dtype=torch.float32, device=dev)
    n_obs = torch.empty(D, dtype=torch.int32, device=dev)
    _build.launch("coloc_pose_cov", R.data_ptr(), C.data_ptr(),
                  *(t.data_ptr() for t in problem), cov.data_ptr(), rmse.data_ptr(),
                  n_obs.data_ptr(), D, L, delta_sq, dev.index, dispatch.stream_handle(dev))
    dispatch.count_launch("pose_cov")
    return cov, rmse, n_obs


def _pose_cov_plain(R, C, X, uv, inliers, K, dist, delta_sq: float):
    """-> cov (D, 6, 6), rmse (D,), n_obs (D,) int32 at (R, C)."""
    mask_f = inliers.to(torch.float32)
    n_obs = inliers.to(torch.int32).sum(dim=-1)
    J, r = _jac_res(R, C, _pose_cam(K, dist), X, uv)
    res_sq = (r * r).sum(dim=-1)
    Jw = J * (_huber_weights(res_sq, delta_sq) * mask_f)[..., None, None]
    cov = _spd_inv_jacobi(torch.einsum("dlri,dlrj->dij", Jw, Jw))
    rmse = torch.sqrt((res_sq * mask_f).sum(dim=-1) / torch.clamp(n_obs, min=1))
    return cov, rmse, n_obs


def refine_pose_only(
    R0: torch.Tensor,       # (D, 3, 3) initial rotations, or (3, 3)
    C0: torch.Tensor,       # (D, 3) initial centres, or (3,)
    X: torch.Tensor,        # (D, L, 3) fixed structure, or (L, 3)
    uv: torch.Tensor,       # (D, L, 2) distorted pixel observations
    inliers: torch.Tensor,  # (D, L) bool
    K: torch.Tensor,        # (D, 3, 3)
    dist: torch.Tensor,     # (D, 3)
    opts: RefinerOptions,
    check_every: int = 1,
) -> BAResult:
    """Pose-only LM of D drones at once, structure fixed
    (Localizer.hpp:132-133). The 6x6 damped system is solved by Cholesky
    per step; the floored PSD inverse runs once at the end for the
    covariance. Rs/Cs stack a fixed identity view 0 with the refined pose
    at index 1 (cov_view=1 convention). The host reads whether any lane is
    still active every `check_every` iterations. Without the drone axis
    (R0 (3, 3)) it is the one-drone call and returns no drone axis."""
    if R0.dim() == 2:
        res = refine_pose_only(R0[None], C0[None], X[None], uv[None], inliers[None],
                               K[None], dist[None], opts, check_every)
        return BAResult(*(t[0] for t in res))
    state = pose_lm_run(pose_lm_init(R0, C0), X, uv, inliers, K, dist, opts,
                        check_every)
    return pose_lm_finish(state, X, uv, inliers, K, dist, opts)


def pose_lm_run(state: PoseLM, X, uv, inliers, K, dist, opts: RefinerOptions,
                check_every: int) -> PoseLM:
    """The LM loop from pose_lm_init's `state` to its end: `check_every`
    masked iterations at a time, then one host read of whether any lane is
    still active (a `coloc.lm.exit_read` span each)."""
    done_its = 0
    while done_its < opts.max_iterations:
        n = min(check_every, opts.max_iterations - done_its)
        state = pose_lm_steps(state, X, uv, inliers, K, dist, opts, n)
        done_its += n
        if done_its < opts.max_iterations:
            with span("coloc.lm.exit_read"):
                active = bool(state.active.any())
            if not active:
                break
    return state


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
           optimize_structure: bool = True, cov_view: int = 1,
           check_every: int = 1) -> BAResult:
    """LM bundle adjustment -> refined poses and structure, the 6x6
    covariance of pose `cov_view`, rmse. `fix_pose` (V,) bool holds poses
    constant. The Schur complement eliminates the (L, 3, 3) landmark
    blocks; the (6V, 6V) system is solved by the eigh-floored PSD inverse,
    as in coloc_tpu. Exits as coloc_tpu's while_loop: an accepted step with
    a relative improvement below 10 tol + 1e-6, a step below _STEP_TOL of
    the state, or damping at its 1e8 cap. The host reads whether the loop
    is still active every `check_every` iterations."""
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
    lam = torch.full((), 1e-3, device=dev)
    nu = torch.full((), 4.0, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(1, opts.max_iterations + 1):
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
        step_ok = active & accept
        Rs = torch.where(step_ok, Rn, Rs)
        Cs = torch.where(step_ok, Cn, Cs)
        X = torch.where(step_ok, Xn, X)
        # Nielsen-style escalation on consecutive rejections
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                              torch.clamp(lam * nu, max=1e8))
        nu = torch.where(active, torch.where(accept, 4.0, torch.clamp(nu * 2.0, max=1e4)),
                         nu)
        lam = torch.where(active, lam_new, lam)
        iterations = iterations + active.to(torch.int32)
        active = active & ~(done | (lam_new >= 1e8))
        if (it % check_every == 0 and it < opts.max_iterations
                and not bool(active)):
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
