"""Robust absolute pose (counterpart of the P3P part of coloc_tpu.robust).

Reference parity: Localizer.hpp:77-108 — AC-RANSAC P3P (256 hypotheses)
with the `inliers >= 2.5 x 3` gate. Failure is a `success` flag, never an
exception. The E/F/H two-view paths are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from coloc_tpu_torch.config import RansacOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import p3p as p3p_ops
from coloc_tpu_torch.ops import ransac_rank
from coloc_tpu_torch.ransac import ransac
from coloc_tpu_torch.types import Pose


def _mean_focal(cam: cam_ops.Camera) -> torch.Tensor:
    return (cam.fx + cam.fy) * 0.5


def _point_log_alpha0(cam: cam_ops.Camera) -> torch.Tensor:
    """log10 constant for POINT error in pixels: alpha_k = (pi / A) e_k^2."""
    A = (2.0 * cam.cx) * (2.0 * cam.cy)
    return torch.log10(math.pi / A)


def _p3p_batch_residuals(flats: torch.Tensor, Xw: torch.Tensor,
                         bearings: torch.Tensor,
                         focal: torch.Tensor) -> torch.Tensor:
    """All-models P3P reprojection residuals, (Hm, M): each camera-frame
    coordinate plane is one (Hm, 4) x (4, M) product,
      err = f^2 ((Xc_x - ox z)^2 + (Xc_y - oy z)^2) / z^2,
    and err = 1e12 where z <= 0."""
    Hm = flats.shape[0]
    R = flats[:, :9].reshape(Hm, 3, 3)
    C = flats[:, 9:]
    t = torch.einsum("mkd,md->mk", R, C)               # (Hm, 3) = R_m C_m
    E = torch.cat([R, t[:, :, None]], dim=2)           # (Hm, 3, 4)
    Xh = torch.cat([Xw, -torch.ones_like(Xw[:, :1])], dim=-1).T   # (4, M)
    A0 = E[:, 0] @ Xh                                  # Xc_x
    A1 = E[:, 1] @ Xh                                  # Xc_y
    Z = E[:, 2] @ Xh                                   # Xc_z
    obs = bearings[:, :2] / torch.clamp(bearings[:, 2:3], min=1e-9)
    u = A0 - obs[:, 0][None, :] * Z
    v = A1 - obs[:, 1][None, :] * Z
    zc = torch.clamp(Z, min=1e-9)
    err = (u * u + v * v) / (zc * zc) * focal ** 2
    return torch.where(Z <= 0, 1e12, err)


def _p3p_residuals(flat: torch.Tensor, Xw: torch.Tensor, bearings: torch.Tensor,
                   focal: torch.Tensor) -> torch.Tensor:
    """One model's (M,) squared reprojection residual in pixels (the
    angle-to-pixel form of the reference scorer); 1e12 behind the camera."""
    R = flat[:9].reshape(3, 3)
    C = flat[9:]
    Xc = (Xw - C) @ R.T
    proj = Xc / torch.clamp(Xc[:, 2:3], min=1e-9)
    obs = bearings / torch.clamp(bearings[:, 2:3], min=1e-9)
    err = ((proj[:, :2] - obs[:, :2]) ** 2).sum(dim=-1) * focal ** 2
    return torch.where(Xc[:, 2] <= 0, 1e12, err)


def absolute_pose_p3p(
    X_world: torch.Tensor,   # (M, 3) landmark positions
    uv: torch.Tensor,        # (M, 2) distorted pixel observations
    mask: torch.Tensor,      # (M,) bool
    cam: cam_ops.Camera,
    opts: RansacOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,
) -> Tuple[Pose, torch.Tensor, torch.Tensor, torch.Tensor]:
    """P3P RANSAC -> (pose, inliers (M,), n_inliers, success).

    The P3P solver (csrc/p3p.cu) and the NFA pre-rank (csrc/ransac_rank.cu)
    run as kernels on a CUDA device."""
    b = cam_ops.bearing(cam, uv)
    focal = _mean_focal(cam)
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
        scoring=opts.scoring, log_alpha0=_point_log_alpha0(cam),
        error_dim=2.0, rank_fn=rank_fn, generator=generator,
        sample_idx=sample_idx,
    )
    pose = Pose(R=res.model[:9].reshape(3, 3), C=res.model[9:])
    return pose, res.inliers, res.n_inliers, res.success
