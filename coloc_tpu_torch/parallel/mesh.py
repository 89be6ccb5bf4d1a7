"""Inter-drone relative pose and fusion, the compute core of coloc_tpu's
parallel.mesh (inter_pose_device, InterDiag, InterPoseOut).

Reference parity: interPoseEstimator (coloc.hpp:274-392). coloc_tpu runs
this one masked device function both from session.inter_pose (a host event)
and inside its sharded ring exchange; here session.inter_pose and
distributed.DronePeer.inter_fuse call it.
The rest of coloc_tpu's mesh module (collaborative_step(_scan),
sharded_inter_step, sharded_map_match, shard_inputs) is the multi-device
slice, not ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from coloc_tpu_torch import matching, robust, utils
from coloc_tpu_torch.config import ColocConfig
from coloc_tpu_torch.fusion import covint
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.sfm import reconstruct
from coloc_tpu_torch.types import Features, MapDB, Pose


class InterDiag(NamedTuple):
    """Diagnostics of inter_pose_device for host-side logging (guided
    epipolar residuals, CSV rows)."""

    geo_R: torch.Tensor        # (3, 3) robust relative rotation (pre-refine)
    geo_t: torch.Tensor        # (3,) robust unit translation
    n_inliers: torch.Tensor    # () int32 geometric inliers
    n_common: torch.Tensor     # () int32 common landmarks map <-> temp
    rmse: torch.Tensor         # () refine reprojection RMSE
    omega: torch.Tensor        # () ICI weight
    trace: torch.Tensor        # () fused covariance trace
    obs_src: torch.Tensor      # (L, 2) temp src-view obs per map landmark
    obs_dst: torch.Tensor      # (L, 2) temp dst-view obs per map landmark
    guided_mask: torch.Tensor  # (L,) bool valid guided-residual entries
    cov_rel: torch.Tensor      # (3, 3) refine covariance CENTRE block, the
    #                            `cov` the reference adds to the source
    #                            covariance before ICI (coloc.hpp:366-367)


class InterPoseOut(NamedTuple):
    fused_pos: torch.Tensor    # (3,)
    fused_cov: torch.Tensor    # (3, 3)
    ok: torch.Tensor           # () bool
    rel: Pose                  # refined relative pose (dst in src frame)
    scale: torch.Tensor        # () monocular scale factor applied
    diag: InterDiag


def inter_pose_device(
    f_dst: Features,           # my (destination) frame features
    f_src: Features,           # partner (source) frame features
    cam_src: Camera,
    cam_dst: Camera,
    Ks_pair: torch.Tensor,     # (2, 3, 3) [src, dst]
    dists_pair: torch.Tensor,  # (2, 3)
    src_pose: Pose,            # partner's current (filtered) world pose
    src_cov3: torch.Tensor,    # (3, 3) partner's intra position covariance
    dst_pos: torch.Tensor,     # (3,) my current position estimate
    dst_cov3: torch.Tensor,    # (3, 3) my intra position covariance
    mapdb: MapDB,              # the shared map
    config: ColocConfig,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (B, 5)
    check_every: int = 1,
) -> InterPoseOut:
    """interPoseEstimator stage for stage (coloc.hpp:274-392), masked: no
    host branch decides what is computed.

      1. pairwise match src -> dst          (:287  computeMatchesPair)
      2. robust relative pose               (:296  filterMatchesPair)
      3. temp two-view scene, src-anchored  (:306  interReconstruct)
      4. map-to-map descriptor match        (:317-323 setupMapDatabase(1)
                                                   + matchMapFeatures)
      5. monocular scale alignment          (:331-336 computeScaleDifference
                                                   + rescaleMap)
      6. pose-only refine -> covariance     (:339-341 refinePose)
      7. compose src o rel, then ICI        (:351-389 CovIntersection)

    The reference's early returns become a mask: where the relative pose
    fails or fewer than 2 common landmarks exist, the outputs are the
    drone's own intra estimate. `generator` draws the five-point samples,
    or `sample_idx` injects them (coloc_tpu's `key`); the host reads the
    Gauss-Newton and LM exits every `check_every` iterations. B1 runs twice
    (frame against frame, map against temp map), B6-B9 once."""
    cfg = config
    dev = dst_pos.device
    # 1. pairwise putative match (query = src, train = dst)
    m = matching.match_pair(f_src, f_dst, cfg.matcher)

    # 2. robust relative pose src -> dst (geometric model E, F or H)
    geo = robust.relative_pose(
        cfg.model, f_src.xy, f_dst.xy[m.idx.long()], m.mask, cam_src, cam_dst,
        cfg.ransac, generator=generator, sample_idx=sample_idx, check_every=check_every)

    # 3. temporary two-view scene, src-anchored at unit scale
    origin = Pose(R=torch.eye(3, device=dev), C=torch.zeros(3, device=dev))
    temp = reconstruct.two_view_scene(
        f_src, f_dst, m, geo.inliers, geo.R, geo.t, origin, 1.0, cam_src, cam_dst,
        num_landmarks=cfg.max_landmarks)
    temp_db = reconstruct.scene_to_mapdb(temp)

    # 4. map-to-map descriptor match against the shared map
    mm = matching.match_maps(mapdb, temp_db, cfg.matcher)
    n_common = (mm.mask & mapdb.valid).sum(dtype=torch.int32)

    # 5. monocular scale alignment between the maps
    scale = utils.compute_scale_difference(mapdb, temp_db, mm)
    Xs, Cs = utils.rescale_map(temp.X, temp.Cs, scale)
    temp = temp._replace(X=Xs, Cs=Cs)

    # 6. pose-only refinement of the scaled relative pose -> 6x6 covariance;
    #    the structure is held (Structure NONE, coloc.hpp:339) and the src
    #    anchor view fixed, which with the structure held is the same
    #    problem up to gauge
    temp, ba_res = reconstruct.refine_scene(
        temp, Ks_pair, dists_pair, cfg.refiner,
        fix_pose=torch.tensor([True, False], device=dev), cov_view=1,
        optimize_structure=False, check_every=check_every)

    # 7. the fused candidate, ICI-fused with my intra estimate
    rel = Pose(R=temp.Rs[1], C=temp.Cs[1])
    cand_C = src_pose.C + src_pose.R.T @ rel.C
    eye = 1e-6 * torch.eye(3, device=dev)
    C_intra = dst_cov3 + eye
    C_cand = src_cov3 + ba_res.cov[3:6, 3:6] + eye
    fused = covint.fuse(C_intra, C_cand, dst_pos, cand_C)

    ok = geo.success & (n_common >= 2)
    idx = mm.idx.long()
    diag = InterDiag(
        geo_R=geo.R, geo_t=geo.t, n_inliers=geo.n_inliers, n_common=n_common,
        rmse=ba_res.rmse, omega=fused.omega, trace=fused.trace,
        obs_src=temp.obs[0][idx], obs_dst=temp.obs[1][idx],
        guided_mask=mm.mask & mapdb.valid & temp.X_valid[idx],
        cov_rel=ba_res.cov[3:6, 3:6])
    return InterPoseOut(
        fused_pos=torch.where(ok, fused.pos, dst_pos),
        fused_cov=torch.where(ok, fused.cov, C_intra),
        ok=ok, rel=rel, scale=scale, diag=diag)
