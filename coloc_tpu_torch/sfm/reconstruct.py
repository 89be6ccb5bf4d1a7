"""Two-view scene bootstrap and the map database (counterpart of the
two-view part of coloc_tpu.sfm.reconstruct).

Reference parity: Reconstructor.hpp — DLT triangulation with the world
origin at the seed view and the relative pose scaled by `scale`
(:185-239; gates depth > 0 in both views and |Z| < 100, :227-231), the
final BA with the first pose fixed (:150-161); colocData.hpp:89-121
setupMapDatabase: the descriptor bank is the first observation of each
landmark.

The scene has a fixed capacity: landmark slot l is feature l of the seed
view, and gates are validity-mask updates. The D > 2 reconstruction
(reconstruct_scene, resection, tracks) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from coloc_tpu_torch.config import RefinerOptions
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import se3
from coloc_tpu_torch.geometry import triangulation as tri
from coloc_tpu_torch.sfm.ba import BAProblem, BAResult, refine
from coloc_tpu_torch.types import Features, MapDB, Matches, Pose

_MAX_Z_BOOTSTRAP = 100.0   # Reconstructor.hpp:227-231


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
