"""Scene reconstruction and the map database (counterpart of
coloc_tpu.sfm.reconstruct).

Reference parity: Reconstructor.hpp — DLT triangulation with the world
origin at the seed view and the relative pose scaled by `scale`
(:185-239; gates depth > 0 in both views and |Z| < 100, :227-231), P3P
resection of the other views (resectionCamera :259-415: new landmarks
gated by a ray angle >= 2 deg, depth > 0, |Z| < 1000 and a 4 px
reprojection), the final BA with the first pose fixed (:150-161);
colocData.hpp:89-121 setupMapDatabase: the descriptor bank is the first
observation of each landmark.

The scene has a fixed capacity and gates are validity-mask updates. In
the two-view scene landmark slot l is feature l of the seed view; in
reconstruct_scene (D > 2) it is track l. reconstruct_scene drives its
events from the host, as coloc_tpu does: the tracks in numpy, the
resection order and each resection's success read back.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from coloc_tpu_torch import robust
from coloc_tpu_torch.config import RansacOptions, RefinerOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import se3
from coloc_tpu_torch.geometry import triangulation as tri
from coloc_tpu_torch.sfm import tracks
from coloc_tpu_torch.sfm.ba import BAProblem, BAResult, refine, refine_pose_only
from coloc_tpu_torch.types import Features, MapDB, Matches, Pose, TwoViewGeometry

_MAX_Z_BOOTSTRAP = 100.0   # Reconstructor.hpp:227-231
_MAX_Z_RESECTION = 1000.0  # Reconstructor.hpp:383
_MIN_RAY_ANGLE_DEG = 2.0   # Reconstructor.hpp:380


class Scene(NamedTuple):
    """Fixed-capacity SfM scene: V views, L landmark slots."""

    Rs: torch.Tensor        # (V, 3, 3)
    Cs: torch.Tensor        # (V, 3)
    X: torch.Tensor         # (L, 3)
    X_valid: torch.Tensor   # (L,) bool
    obs: torch.Tensor       # (V, L, 2) distorted pixel observations
    obs_mask: torch.Tensor  # (V, L) bool
    desc: torch.Tensor      # (L, 16) int32 first-observation descriptors

    @property
    def num_views(self) -> int:
        return self.Rs.shape[0]

    @property
    def capacity(self) -> int:
        return self.X.shape[0]


def _fit(a: torch.Tensor, L: int) -> torch.Tensor:
    """First L rows of `a`, zero-padded to L (slots beyond L are dropped)."""
    if a.shape[0] >= L:
        return a[:L]
    pad = torch.zeros((L - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad])


def two_view_scene(
    feats_i: Features,
    feats_j: Features,
    matches: Matches,          # query = view i, train = view j
    inliers: torch.Tensor,     # (K,) bool from robust geometry
    rel_R: torch.Tensor,       # relative motion i -> j
    rel_t: torch.Tensor,       # unit translation of the relative pose
    pose_i: Pose,              # world pose of view i
    scale: float,
    cam_i: cam_ops.Camera,
    cam_j: cam_ops.Camera,
    num_landmarks: int,
) -> Scene:
    """Bootstrap a two-view scene by DLT triangulation of the inlier
    matches; landmark slot l is feature l of view i."""
    L = num_landmarks
    rel = Pose(R=rel_R, C=-rel_R.T @ rel_t)
    pose_j = se3.relative_to_absolute(rel, pose_i, scale=scale)

    uv_i = feats_i.xy
    # an unmatched slot (idx -1) reads the last feature, as jnp indexing
    # does; the mask drops it below
    uv_j = feats_j.xy[matches.idx.long()]
    x_i = cam_ops.undistort(cam_i, cam_ops.normalize(cam_i, uv_i))
    x_j = cam_ops.undistort(cam_j, cam_ops.normalize(cam_j, uv_j))
    X = tri.triangulate_points(pose_i.R, pose_i.C, x_i, pose_j.R, pose_j.C,
                               x_j, mask=matches.mask)

    d_i = tri.depth_in_view(pose_i.R, pose_i.C, X)
    d_j = tri.depth_in_view(pose_j.R, pose_j.C, X)
    gates = (d_i > 0.0) & (d_j > 0.0) & (X[:, 2].abs() < _MAX_Z_BOOTSTRAP)
    valid = matches.mask & inliers & feats_i.valid & gates

    X_valid = _fit(valid, L)
    return Scene(
        Rs=torch.stack([pose_i.R, pose_j.R]),
        Cs=torch.stack([pose_i.C, pose_j.C]),
        X=torch.where(X_valid[:, None], _fit(X, L), 0.0),
        X_valid=X_valid,
        obs=torch.stack([_fit(uv_i, L), _fit(uv_j, L)]),
        obs_mask=torch.stack([X_valid, X_valid]),
        desc=_fit(feats_i.desc, L),
    )


def refine_scene(scene: Scene, cams_K: torch.Tensor, cams_dist: torch.Tensor,
                 opts: RefinerOptions, fix_pose: torch.Tensor,
                 cov_view: int = 1, optimize_structure: bool = True,
                 check_every: int = 1) -> Tuple[Scene, BAResult]:
    """BA over the scene (Reconstructor.hpp:150-161). optimize_structure
    False holds the landmarks (the poses-only call of coloc.hpp:339); the
    host reads the LM's exit every `check_every` iterations."""
    problem = BAProblem(
        Rs=scene.Rs, Cs=scene.Cs, X=scene.X, obs=scene.obs,
        obs_mask=scene.obs_mask & scene.X_valid[None, :],
        Ks=cams_K, dists=cams_dist)
    res = refine(problem, opts, fix_pose, optimize_structure=optimize_structure,
                 cov_view=cov_view, check_every=check_every)
    return scene._replace(Rs=res.Rs, Cs=res.Cs, X=res.X), res


def scene_to_mapdb(scene: Scene) -> MapDB:
    """setupMapDatabase parity: the bank is scene.desc by construction."""
    return MapDB(X=scene.X, desc=scene.desc, valid=scene.X_valid)


def _triangulate_pair(Ra, Ca, Rb, Cb, cam_a: cam_ops.Camera, cam_b: cam_ops.Camera,
                      uv_a: torch.Tensor, uv_b: torch.Tensor, vis: torch.Tensor,
                      max_z: float, min_angle_deg: float, reproj_max_sq: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked DLT of one view pair, uv_a/uv_b (L, 2) distorted pixels and
    vis (L,) the candidates, with the Reconstructor gates: depth > 0 in
    both views, ray angle >= min_angle_deg, |Z| < max_z, reprojection
    below reproj_max_sq px^2 in both (Reconstructor.hpp:225-237 bootstrap:
    100, 0, inf; :354-412 resection: 1000, 2, 16). -> (X (L, 3), zero where
    rejected; ok (L,) bool)."""
    x_a = cam_ops.undistort(cam_a, cam_ops.normalize(cam_a, uv_a))
    x_b = cam_ops.undistort(cam_b, cam_ops.normalize(cam_b, uv_b))
    X = tri.triangulate_points(Ra, Ca, x_a, Rb, Cb, x_b, mask=vis)
    reproj_a = ((cam_ops.project(cam_a, Ra, Ca, X) - uv_a) ** 2).sum(dim=-1)
    reproj_b = ((cam_ops.project(cam_b, Rb, Cb, X) - uv_b) ** 2).sum(dim=-1)
    ok = (vis
          & (tri.depth_in_view(Ra, Ca, X) > 0.0) & (tri.depth_in_view(Rb, Cb, X) > 0.0)
          & (tri.ray_angle_deg(Ca, Cb, X) >= min_angle_deg)
          & (X[:, 2].abs() < max_z)
          & (reproj_a < reproj_max_sq) & (reproj_b < reproj_max_sq))
    return torch.where(ok[:, None], X, 0.0), ok


def _view_order(pair_geo: Dict[Tuple[int, int], TwoViewGeometry], V: int) -> List[int]:
    """reconstruct_scene's row order: the seed pair (the pair of most
    geometric inliers, the first in `pair_geo`'s order among equals,
    Reconstructor.hpp:112-118), then the other views in index order. Row 0,
    the seed pair's first view, is the world frame."""
    i, j = max(pair_geo, key=lambda p: int(pair_geo[p].n_inliers))
    return [i, j] + [v for v in range(V) if v not in (i, j)]


def reconstruct_scene(
    features: List[Features],                          # V banks
    pair_matches: Dict[Tuple[int, int], Matches],      # query view a, train view b
    pair_geo: Dict[Tuple[int, int], TwoViewGeometry],
    cams: List[cam_ops.Camera],
    Ks: torch.Tensor,                                  # (V, 3, 3)
    dists: torch.Tensor,                               # (V, 3)
    scale: float,
    num_landmarks: int,
    refiner_opts: RefinerOptions,
    ransac_opts: RansacOptions,
    generator: Optional[torch.Generator] = None,
    resection_idx: Optional[List[torch.Tensor]] = None,
    check_every: int = 1,
) -> Tuple[Scene, BAResult, List[int]]:
    """Multi-view track-based incremental reconstruction
    (reconstructScene, Reconstructor.hpp:102-164):
      1. union-find tracks over every pair's geometric-inlier matches
         (Reconstructor.hpp:166-173); landmark slot l is track l;
      2. the seed pair (_view_order) triangulated with the world origin at
         its first view and the relative translation scaled by `scale`;
      3. the other views in order of most tracks shared with the map: P3P
         resection (robust.absolute_pose_p3p), the pose-only polish, then
         new landmarks against every posed partner under the resection
         gates; a view whose resection fails keeps no observation;
      4. the final BA, the seed pose fixed and the covariance of row 1.
    Returns the refined scene, its BAResult and `order`: the scene's row r
    is view order[r] (Ks in that order; order[:2] the seed pair, row 0 the
    world frame). `resection_idx`: injected (B, 3) P3P draws, one per
    resection in resection order; otherwise `generator` draws them. The
    LMs read their exits every `check_every` iterations."""
    V = len(features)
    cap = features[0].capacity
    L = num_landmarks
    dev = Ks.device

    gated = {}
    for (a, b), m in pair_matches.items():
        idx = m.idx.cpu().numpy()
        ok = idx >= 0
        if (a, b) in pair_geo:
            ok &= pair_geo[(a, b)].inliers.cpu().numpy()
        gated[(a, b)] = np.where(ok, idx, -1)
    table, tvalid = tracks.build_tracks(gated, V, cap, L)     # (L, V), (L,)

    order = _view_order(pair_geo, V)
    i, j = order[:2]
    geo = pair_geo[(i, j)]

    # per-slot observations from the track table (row r = view order[r])
    obs = np.zeros((V, L, 2), np.float32)
    obs_mask = np.zeros((V, L), bool)
    desc = np.zeros((L, features[0].desc.shape[-1]), np.int32)
    desc_set = np.zeros(L, bool)
    for r, v in enumerate(order):
        fi = table[:, v]
        safe = np.clip(fi, 0, cap - 1)
        has = tvalid & (fi >= 0) & features[v].valid.cpu().numpy()[safe]
        obs[r] = np.where(has[:, None], features[v].xy.cpu().numpy()[safe], 0.0)
        obs_mask[r] = has
        newly = has & ~desc_set                   # the first observation's
        desc[newly] = features[v].desc.cpu().numpy()[safe[newly]]
        desc_set |= newly
    obs_t = torch.from_numpy(obs).to(dev)
    om = torch.from_numpy(obs_mask).to(dev)

    origin = Pose(R=torch.eye(3, device=dev), C=torch.zeros(3, device=dev))
    pose_j = se3.relative_to_absolute(Pose(R=geo.R, C=-geo.R.T @ geo.t), origin,
                                      scale=scale)
    Rs = torch.eye(3, device=dev).repeat(V, 1, 1)
    Cs = torch.zeros((V, 3), device=dev)
    Rs[1], Cs[1] = pose_j.R, pose_j.C

    X, X_valid = _triangulate_pair(
        Rs[0], Cs[0], Rs[1], Cs[1], cams[i], cams[j], obs_t[0], obs_t[1],
        om[0] & om[1], _MAX_Z_BOOTSTRAP, 0.0, float("inf"))
    posed = [True, True] + [False] * (V - 2)

    remaining = list(range(2, V))
    n_resected = 0
    while remaining:
        overlap = (om[remaining] & X_valid).sum(dim=1).tolist()
        r = remaining[overlap.index(max(overlap))]
        remaining.remove(r)
        v = order[r]
        corr = om[r] & X_valid
        draws = None if resection_idx is None else resection_idx[n_resected]
        n_resected += 1
        pose_v, inl, _, success = robust.absolute_pose_p3p(
            X, obs_t[r], corr, cams[v], ransac_opts, generator=generator,
            sample_idx=draws)
        if not bool(success):
            om[r] = False              # a failed view adds nothing to the BA
            continue
        res_v = refine_pose_only(pose_v.R, pose_v.C, X, obs_t[r], inl, cams[v].K,
                                 cams[v].dist, refiner_opts, check_every)
        Rs[r], Cs[r] = res_v.Rs[1], res_v.Cs[1]
        posed[r] = True
        # new landmarks: still-empty tracks shared with any posed partner
        for w in [rw for rw in range(V) if posed[rw] and rw != r]:
            vis = om[w] & om[r] & ~X_valid
            if not bool(vis.any()):
                continue
            Xn, okn = _triangulate_pair(
                Rs[w], Cs[w], Rs[r], Cs[r], cams[order[w]], cams[v], obs_t[w],
                obs_t[r], vis, _MAX_Z_RESECTION, _MIN_RAY_ANGLE_DEG, 16.0)
            X = torch.where(okn[:, None], Xn, X)
            X_valid = X_valid | okn

    scene = Scene(Rs=Rs, Cs=Cs, X=X, X_valid=X_valid, obs=obs_t, obs_mask=om,
                  desc=torch.from_numpy(desc).to(dev))
    order_idx = torch.tensor(order, device=dev)
    fix = torch.tensor([True] + [not posed[r] for r in range(1, V)], device=dev)
    scene, ba_res = refine_scene(scene, Ks[order_idx], dists[order_idx], refiner_opts,
                                 fix, cov_view=1, check_every=check_every)
    return scene, ba_res, order
