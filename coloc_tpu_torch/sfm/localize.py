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
from coloc_tpu_torch.sfm import ba
from coloc_tpu_torch.types import Features, MapDB, Matches, Pose, PoseWithCov


def correspondences(feats: Features, map_matches: Matches, mapdb: MapDB):
    """2D-3D correspondences -> (X (..., K, 3), uv (..., K, 2), mask). A
    rejected match has idx -1, which selects the LAST landmark, as
    coloc_tpu's gather does; the mask drops those rows."""
    L = mapdb.X.shape[0]
    idx = map_matches.idx.to(torch.int64)
    X = mapdb.X[torch.where(idx < 0, idx + L, idx)]
    return X, feats.xy, map_matches.mask & feats.valid


def finish(res: ba.BAResult, n_inl, success) -> PoseWithCov:
    """PoseWithCov of D drones from the refinement: a failed drone gets the
    identity pose and covariance and rmse 0 (coloc.hpp:246-257)."""
    dev = res.cov.device
    ok3 = success[:, None, None]
    pose = Pose(R=torch.where(ok3, res.Rs[:, 1], torch.eye(3, device=dev)),
                C=torch.where(success[:, None], res.Cs[:, 1], 0.0))
    cov = torch.where(ok3, res.cov, torch.eye(6, dtype=torch.float32, device=dev))
    rmse = torch.where(success, res.rmse, 0.0)
    return PoseWithCov(pose=pose, cov=cov, rmse=rmse, n_tracks=n_inl, success=success)


def localize_image(
    feats: Features,           # (D, K, ...) or (K, ...)
    map_matches: Matches,      # frame features vs map landmarks
    mapdb: MapDB,
    cam: cam_ops.Camera,       # K (D, 3, 3), dist (D, 3)
    ransac_opts: RansacOptions,
    refiner_opts: RefinerOptions,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    check_every: int = 1,
) -> Tuple[PoseWithCov, torch.Tensor]:
    """D drones' frames against one map -> (PoseWithCov (D, ...), inlier
    mask over frame features (D, K)); without the drone axis (feats.xy (K,
    2), K (3, 3)) the one-drone call.

    `generator` draws the RANSAC samples (torch's default generator of the
    device when None); `uniforms` (D, B, 3) are the uniforms to draw them
    with, `sample_idx` (D, B, 3) injects the draws instead. The pose LM
    reads its exit on the host every `check_every` iterations."""
    if feats.xy.dim() == 2:
        pwc, inl = localize_image(
            Features(*(t[None] for t in feats)), Matches(*(t[None] for t in map_matches)),
            mapdb, cam_ops.Camera(K=cam.K[None], dist=cam.dist[None]), ransac_opts,
            refiner_opts, generator, None if sample_idx is None else sample_idx[None],
            None if uniforms is None else uniforms[None], check_every)
        return (PoseWithCov(Pose(pwc.pose.R[0], pwc.pose.C[0]),
                            *(t[0] for t in pwc[1:])), inl[0])
    X, uv, corr_mask = correspondences(feats, map_matches, mapdb)
    pose0, inliers, n_inl, success = absolute_pose_p3p(
        X, uv, corr_mask, cam, ransac_opts, generator=generator,
        sample_idx=sample_idx, uniforms=uniforms)
    res = ba.refine_pose_only(pose0.R, pose0.C, X, uv, inliers, cam.K, cam.dist,
                              refiner_opts, check_every)
    return finish(res, n_inl, success), inliers
