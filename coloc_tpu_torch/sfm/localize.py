"""Map-based absolute localization (counterpart of coloc_tpu.sfm.localize).

Reference parity: Localizer.hpp — setupTracks (:59-75) builds 2D-3D
correspondences from map matches, localizeImage (:77-108) runs AC-RANSAC
P3P, and refine (:110-177) a pose-only BA with the reprojection RMSE and
pose covariance. Failure is `success=False` with an identity pose and an
identity covariance (coloc.hpp:246-257), never an exception.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from coloc_tpu_torch.config import RansacOptions, RefinerOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.robust import absolute_pose_p3p
from coloc_tpu_torch.sfm.ba import refine_pose_only
from coloc_tpu_torch.types import Features, MapDB, Matches, Pose, PoseWithCov


def localize_image(
    feats: Features,
    map_matches: Matches,      # frame features vs map landmarks
    mapdb: MapDB,
    cam: cam_ops.Camera,
    ransac_opts: RansacOptions,
    refiner_opts: RefinerOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,
) -> Tuple[PoseWithCov, torch.Tensor]:
    """-> (PoseWithCov, inlier mask over frame features).

    `generator` draws the RANSAC samples (torch's default generator of the
    device when None); `sample_idx` (B, 3) injects them instead."""
    # 2D-3D correspondences. A rejected match has idx -1, which selects the
    # LAST landmark, as coloc_tpu's gather does; the masks drop those rows.
    L = mapdb.X.shape[0]
    idx = map_matches.idx.to(torch.int64)
    X = mapdb.X[torch.where(idx < 0, idx + L, idx)]     # (K, 3)
    uv = feats.xy
    corr_mask = map_matches.mask & feats.valid

    pose0, inliers, n_inl, success = absolute_pose_p3p(
        X, uv, corr_mask, cam, ransac_opts, generator=generator,
        sample_idx=sample_idx)

    res = refine_pose_only(pose0.R, pose0.C, X, uv, inliers, cam.K, cam.dist,
                           refiner_opts)
    eye3 = torch.eye(3, dtype=torch.float32, device=X.device)
    pose = Pose(R=torch.where(success, res.Rs[1], eye3),
                C=torch.where(success, res.Cs[1], torch.zeros_like(res.Cs[1])))
    cov = torch.where(success, res.cov,
                      torch.eye(6, dtype=torch.float32, device=X.device))
    rmse = torch.where(success, res.rmse, torch.zeros_like(res.rmse))
    return (
        PoseWithCov(pose=pose, cov=cov, rmse=rmse, n_tracks=n_inl,
                    success=success),
        inliers,
    )
