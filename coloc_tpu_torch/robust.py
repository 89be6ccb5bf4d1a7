"""Robust two-view and absolute pose (counterpart of coloc_tpu.robust).

Reference parity: RobustMatcher.hpp computeRelativePose (:372-424) for
the geometric models 'E', 'F' and 'H', and Localizer.hpp:77-108 —
AC-RANSAC P3P (256 hypotheses); each accepts iff inliers >= 2.5 x the
minimal sample. Failure is a `success` flag, never an exception.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from coloc_tpu_torch.config import RansacOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import essential as ess
from coloc_tpu_torch.geometry import fivept
from coloc_tpu_torch.geometry import homography as homog
from coloc_tpu_torch.geometry import p3p as p3p_ops
from coloc_tpu_torch.ops import ransac_rank
from coloc_tpu_torch.ransac import ransac
from coloc_tpu_torch.types import Pose, TwoViewGeometry


def _mean_focal(cam: cam_ops.Camera) -> torch.Tensor:
    return (cam.fx + cam.fy) * 0.5


def _point_log_alpha0(cam: cam_ops.Camera) -> torch.Tensor:
    """log10 constant for POINT error in pixels: alpha_k = (pi / A) e_k^2."""
    A = (2.0 * cam.cx) * (2.0 * cam.cy)
    return torch.log10(math.pi / A)


def _p3p_batch_residuals(flats: torch.Tensor, Xw: torch.Tensor,
                         bearings: torch.Tensor,
                         focal: torch.Tensor) -> torch.Tensor:
    """All-models P3P reprojection residuals of D drones, (D, Hm, M): each
    camera-frame coordinate plane is one (Hm, 4) x (4, M) product a drone,
      err = f^2 ((Xc_x - ox z)^2 + (Xc_y - oy z)^2) / z^2,
    and err = 1e12 where z <= 0. flats (D, Hm, 12), Xw and bearings (D, M,
    3), focal (D, 1)."""
    D, Hm = flats.shape[:2]
    R = flats[..., :9].reshape(D, Hm, 3, 3)
    C = flats[..., 9:]
    t = torch.einsum("dmkc,dmc->dmk", R, C)            # (D, Hm, 3) = R_m C_m
    E = torch.cat([R, t[..., None]], dim=-1)           # (D, Hm, 3, 4)
    Xh = torch.cat([Xw, -torch.ones_like(Xw[..., :1])], dim=-1).transpose(1, 2)  # (D, 4, M)
    A0 = E[:, :, 0] @ Xh                               # Xc_x
    A1 = E[:, :, 1] @ Xh                               # Xc_y
    Z = E[:, :, 2] @ Xh                                # Xc_z
    obs = bearings[..., :2] / torch.clamp(bearings[..., 2:3], min=1e-9)
    u = A0 - obs[:, None, :, 0] * Z
    v = A1 - obs[:, None, :, 1] * Z
    zc = torch.clamp(Z, min=1e-9)
    err = (u * u + v * v) / (zc * zc) * focal[..., None] ** 2
    return torch.where(Z <= 0, 1e12, err)


def _p3p_residuals(flat: torch.Tensor, Xw: torch.Tensor, bearings: torch.Tensor,
                   focal: torch.Tensor) -> torch.Tensor:
    """One model a drone: (D, M) squared reprojection residuals in pixels
    (the angle-to-pixel form of the reference scorer); 1e12 behind the
    camera. flat (D, 12), Xw and bearings (D, M, 3), focal (D, 1)."""
    R = flat[:, :9].reshape(-1, 3, 3)
    C = flat[:, 9:]
    Xc = (Xw - C[:, None, :]) @ R.transpose(1, 2)
    proj = Xc / torch.clamp(Xc[..., 2:3], min=1e-9)
    obs = bearings / torch.clamp(bearings[..., 2:3], min=1e-9)
    err = ((proj[..., :2] - obs[..., :2]) ** 2).sum(dim=-1) * focal ** 2
    return torch.where(Xc[..., 2] <= 0, 1e12, err)


def relative_pose_essential(
    uv1: torch.Tensor,       # (M, 2) distorted pixels, camera 1
    uv2: torch.Tensor,       # (M, 2) distorted pixels, camera 2
    mask: torch.Tensor,      # (M,) bool valid correspondences
    cam1: cam_ops.Camera,
    cam2: cam_ops.Camera,
    opts: RansacOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,
    check_every: int = 1,
) -> TwoViewGeometry:
    """Model 'E': five-point AC-RANSAC (256 samples x 30 candidates), the
    cheirality decomposition, Gauss-Newton on the essential manifold, a
    revert if the refined model keeps fewer inliers, and a second
    cheirality vote on the final E (the Sampson objective is blind to the
    +-t / twisted-pair ambiguity).

    The five-point solver (csrc/fivept_{front,dk,polish}.cu) and the
    epipolar pre-rank (csrc/epi_rank.cu) run as kernels on a CUDA device.
    Residuals are in pixels, each side scaled by its own camera's focal.
    The host reads the Gauss-Newton exit every `check_every` steps."""
    x1 = cam_ops.undistort(cam1, cam_ops.normalize(cam1, uv1))
    x2 = cam_ops.undistort(cam2, cam_ops.normalize(cam2, uv2))
    f1_sq = _mean_focal(cam1) ** 2
    f2_sq = _mean_focal(cam2) ** 2
    thr_sq = opts.essential_threshold ** 2

    def scorer(E, a1, a2):
        return ess.symmetric_epipolar_distance_sq(E, a1, a2, f1_sq, f2_sq)

    def batch_scorer(Es, a1, a2):
        return ess.symmetric_epipolar_distance_sq_batch(Es, a1, a2, f1_sq, f2_sq)

    def rank_fn(Es, valid_c, a1, a2):
        return ransac_rank.epipolar_ladder_rank(Es, a1, a2, valid_c, f1_sq,
                                                f2_sq, thr_sq)

    # log_alpha0 of a point-to-line error in pixels
    A_px = (2.0 * cam1.cx) * (2.0 * cam1.cy)
    D_px = torch.sqrt((2.0 * cam1.cx) ** 2 + (2.0 * cam1.cy) ** 2)
    res = ransac(
        (x1, x2), mask, fivept.five_point_batch, scorer, batch_scorer,
        sample_size=5, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq, inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=torch.log10(2.0 * D_px / A_px),
        error_dim=1.0, rank_fn=rank_fn, generator=generator,
        sample_idx=sample_idx,
    )

    R, t = ess.decompose_essential(res.model, x1, x2, res.inliers)
    R, t = ess.refine_relative_pose(R, t, x1, x2, res.inliers.to(torch.float32),
                                    check_every=check_every)
    E_ref = ess.hat3(t) @ R
    refined_inl = (scorer(E_ref, x1, x2) < res.threshold_sq) & mask
    # a refinement that lands in a worse basin reverts model AND inliers
    keep = refined_inl.to(torch.int32).sum() >= res.n_inliers
    inliers = torch.where(keep, refined_inl, res.inliers)
    E_final = torch.where(keep, E_ref, res.model)
    R, t = ess.decompose_essential(E_final, x1, x2, inliers)
    return TwoViewGeometry(R=R, t=t, inliers=inliers,
                           n_inliers=inliers.sum(dtype=torch.int32),
                           success=res.success)


def _refit(res, refit_model, scorer, mask):
    """coloc_tpu's keep-if-better least-squares re-fit: the re-fit model
    and its inliers replace RANSAC's where they keep at least as many."""
    refit_inl = (scorer(refit_model) < res.threshold_sq) & mask
    n_refit = refit_inl.sum(dtype=torch.int32)
    better = n_refit >= res.n_inliers
    return (torch.where(better, refit_model, res.model),
            torch.where(better, refit_inl, res.inliers),
            torch.where(better, n_refit, res.n_inliers))


def relative_pose_fundamental(
    uv1: torch.Tensor, uv2: torch.Tensor, mask: torch.Tensor,
    cam1: cam_ops.Camera, cam2: cam_ops.Camera, opts: RansacOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (B, 7)
    check_every: int = 1,
) -> TwoViewGeometry:
    """Model 'F' (RobustMatcher.hpp:134-150): seven-point AC-RANSAC on
    undistorted pixels (256 samples x 3 candidates), ranked by the
    epipolar ladder in pixel units (csrc/epi_rank.cu on a CUDA device),
    the Hartley 8-point re-fit over the inliers kept if it keeps as many,
    then E = K2^T F K1 and the cheirality decomposition. `check_every` is
    accepted for the common signature; this path has no loop to read."""
    u1 = cam_ops.undistort_pixel(cam1, uv1)
    u2 = cam_ops.undistort_pixel(cam2, uv2)
    thr_sq = opts.essential_threshold ** 2

    def scorer(F, a1, a2):
        return ess.symmetric_epipolar_distance_sq(F, a1, a2)

    def batch_scorer(Fs, a1, a2):
        return ess.symmetric_epipolar_distance_sq_batch(Fs, a1, a2)

    def rank_fn(Fs, valid_c, a1, a2):
        return ransac_rank.epipolar_ladder_rank(Fs, a1, a2, valid_c, 1.0, 1.0,
                                                thr_sq)

    # log_alpha0 of a point-to-line error in pixels
    A_px = (2.0 * cam1.cx) * (2.0 * cam1.cy)
    D_px = torch.sqrt((2.0 * cam1.cx) ** 2 + (2.0 * cam1.cy) ** 2)
    res = ransac(
        (u1, u2), mask, ess.seven_point, scorer, batch_scorer,
        sample_size=7, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq, inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=torch.log10(2.0 * D_px / A_px),
        error_dim=1.0, rank_fn=rank_fn, generator=generator,
        sample_idx=sample_idx,
    )
    F, inliers, n_inliers = _refit(
        res, ess.fundamental_8pt(u1, u2, weights=res.inliers.to(torch.float32)),
        lambda F: scorer(F, u1, u2), mask)
    E = cam2.K.T @ F @ cam1.K
    R, t = ess.decompose_essential(E, cam_ops.normalize(cam1, u1),
                                   cam_ops.normalize(cam2, u2), inliers)
    return TwoViewGeometry(R=R, t=t, inliers=inliers, n_inliers=n_inliers,
                           success=res.success)


def relative_pose_homography(
    uv1: torch.Tensor, uv2: torch.Tensor, mask: torch.Tensor,
    cam1: cam_ops.Camera, cam2: cam_ops.Camera, opts: RansacOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (B, 4)
    check_every: int = 1,
) -> TwoViewGeometry:
    """Model 'H' (RobustMatcher.hpp:188-206, :39-126): four-point
    AC-RANSAC on normalized coords with the forward transfer error in
    camera 2's pixels, ranked by the ladder in its "nonzero" mode
    (csrc/ransac_rank.cu on a CUDA device), the weighted DLT re-fit over
    the inliers kept if it keeps as many, then the Euclidean
    decomposition; success also needs the chirality vote's margin.
    `check_every` is accepted for the common signature."""
    x1 = cam_ops.undistort(cam1, cam_ops.normalize(cam1, uv1))
    x2 = cam_ops.undistort(cam2, cam_ops.normalize(cam2, uv2))
    # the transfer error lives in image 2: camera 2's focal
    f2 = _mean_focal(cam2)
    f2_sq = f2 ** 2
    thr_sq = opts.homography_threshold ** 2

    def solver(s1, s2):
        H = homog.four_point(s1, s2)
        return H[:, None], torch.ones(H.shape[:1] + (1,), dtype=torch.bool,
                                      device=H.device)

    def scorer(H, a1, a2):
        return f2_sq * homog.transfer_error_sq(H, a1, a2)

    def batch_scorer(Hs, a1, a2):
        return f2_sq * homog.transfer_error_sq_batch(Hs, a1, a2)

    def rank_fn(Hs, valid_c, a1, a2):
        return ransac_rank.homography_ladder_rank(Hs, a1, a2, valid_c, f2, thr_sq)

    # log_alpha0 of a point transfer error in image 2's pixels
    A_px = (2.0 * cam2.cx) * (2.0 * cam2.cy)
    res = ransac(
        (x1, x2), mask, solver, scorer, batch_scorer,
        sample_size=4, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq, inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=torch.log10(math.pi / A_px),
        error_dim=2.0, rank_fn=rank_fn, generator=generator,
        sample_idx=sample_idx,
    )
    Hm, inliers, n_inliers = _refit(
        res, homog.four_point(x1, x2, weights=res.inliers.to(torch.float32)),
        lambda H: scorer(H, x1, x2), mask)
    R, t, _n, chirality_ok = homog.decompose_homography(
        Hm, x1, x2, inliers, opts.chirality_ratio)
    return TwoViewGeometry(R=R, t=t, inliers=inliers, n_inliers=n_inliers,
                           success=res.success & chirality_ok)


def relative_pose(model: str, uv1, uv2, mask, cam1, cam2, opts: RansacOptions,
                  **kw) -> TwoViewGeometry:
    """The two-view estimator of geometric model `model` (coloc_tpu's
    dispatch over relative_pose_{essential,fundamental,homography}); `kw`
    goes to it."""
    fns = {"E": relative_pose_essential, "F": relative_pose_fundamental,
           "H": relative_pose_homography}
    if model not in fns:
        raise ValueError(f"unknown geometric model {model!r}")
    return fns[model](uv1, uv2, mask, cam1, cam2, opts, **kw)


def absolute_pose_p3p(
    X_world: torch.Tensor,   # (D, M, 3) landmark positions
    uv: torch.Tensor,        # (D, M, 2) distorted pixel observations
    mask: torch.Tensor,      # (D, M) bool
    cam: cam_ops.Camera,     # K (D, 3, 3), dist (D, 3)
    opts: RansacOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (D, B, 3)
    uniforms: Optional[torch.Tensor] = None,     # (D, B, 3)
) -> Tuple[Pose, torch.Tensor, torch.Tensor, torch.Tensor]:
    """P3P RANSAC of D drones -> (pose (D, ...), inliers (D, M), n_inliers
    (D,), success (D,)); without the drone axis (mask (M,), K (3, 3)) the
    one-drone call.

    The P3P solver (csrc/p3p.cu, all D x B samples in one launch) and the
    NFA pre-rank (csrc/ransac_rank.cu, the drone axis in its grid) run as
    kernels on a CUDA device."""
    if mask.dim() == 1:
        pose, inl, n, ok = absolute_pose_p3p(
            X_world[None], uv[None], mask[None],
            cam_ops.Camera(K=cam.K[None], dist=cam.dist[None]), opts, generator,
            None if sample_idx is None else sample_idx[None],
            None if uniforms is None else uniforms[None])
        return Pose(R=pose.R[0], C=pose.C[0]), inl[0], n[0], ok[0]
    cam = cam_ops.Camera(K=cam.K[:, None], dist=cam.dist[:, None])   # per drone
    b = cam_ops.bearing(cam, uv)
    focal = _mean_focal(cam)                                        # (D, 1)
    thr_sq = opts.p3p_threshold ** 2

    def scorer(flat, Xw, bearings):
        return _p3p_residuals(flat, Xw, bearings, focal)

    def batch_scorer(flats, Xw, bearings):
        return _p3p_batch_residuals(flats, Xw, bearings, focal)

    def rank_fn(flats, valid_c, Xw, bearings):
        return ransac_rank.p3p_ladder_rank(flats, Xw, bearings, valid_c,
                                           focal, thr_sq)

    res = ransac(
        (X_world, b), mask, p3p_ops.p3p_flats_batch, scorer, batch_scorer,
        sample_size=3, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq, inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=_point_log_alpha0(cam)[..., None],
        error_dim=2.0, rank_fn=rank_fn, generator=generator,
        sample_idx=sample_idx, uniforms=uniforms,
    )
    D = mask.shape[0]
    pose = Pose(R=res.model[:, :9].reshape(D, 3, 3), C=res.model[:, 9:])
    return pose, res.inliers, res.n_inliers, res.success
