"""numpy <-> port state.

The reference's state (Features, Matches, MapDB, Camera, FilterBank, a
Scene of any number of views, TwoViewGeometry, a session's map and
filter), taken out of JAX as numpy arrays, becomes the port's state here
and back. Descriptors cross as a
bit-preserving view: uint32 in coloc_tpu, int32 in the port (types.py).
Inputs are any object with the reference's field names whose fields
np.asarray accepts, so a coloc_tpu NamedTuple can be passed as it is.

`device` None means cuda:0 and raises where there is none; the CPU is used
only when the caller asks for it (dispatch.default_device).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from coloc_tpu_torch.fusion.kalman import FilterBank
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.ops.dispatch import default_device
from coloc_tpu_torch.sfm.reconstruct import Scene
from coloc_tpu_torch.types import (Features, MapDB, Matches, Pose, PoseWithCov,
                                   TwoViewGeometry)


def _desc_to_torch(desc, device) -> torch.Tensor:
    words = np.ascontiguousarray(np.asarray(desc, np.uint32)).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device=device)


def _bool(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, bool), device=device)


def features_from_numpy(feats: Any, device=None) -> Features:
    device = default_device(device)
    return Features(
        xy=_f32(feats.xy, device),
        score=_f32(feats.score, device),
        scale=_i32(feats.scale, device),
        angle=_f32(feats.angle, device),
        desc=_desc_to_torch(feats.desc, device),
        valid=_bool(feats.valid, device),
    )


def mapdb_from_numpy(mapdb: Any, device=None) -> MapDB:
    device = default_device(device)
    return MapDB(
        X=_f32(mapdb.X, device),
        desc=_desc_to_torch(mapdb.desc, device),
        valid=_bool(mapdb.valid, device),
    )


def matches_from_numpy(matches: Any, device=None) -> Matches:
    device = default_device(device)
    return Matches(idx=_i32(matches.idx, device), best=_i32(matches.best, device),
                   second=_i32(matches.second, device))


def camera_from_numpy(K, dist=None, device=None) -> Camera:
    device = default_device(device)
    dist = np.zeros(3, np.float32) if dist is None else dist
    return Camera(K=_f32(K, device), dist=_f32(dist, device))


def filter_bank_from_numpy(fb: Any, device=None) -> FilterBank:
    device = default_device(device)
    return FilterBank(x=_f32(fb.x, device), P=_f32(fb.P, device),
                      steps=_i32(fb.steps, device))


def scene_from_numpy(scene: Any, device=None) -> Scene:
    device = default_device(device)
    return Scene(
        Rs=_f32(scene.Rs, device), Cs=_f32(scene.Cs, device),
        X=_f32(scene.X, device), X_valid=_bool(scene.X_valid, device),
        obs=_f32(scene.obs, device), obs_mask=_bool(scene.obs_mask, device),
        desc=_desc_to_torch(scene.desc, device),
    )


def two_view_from_numpy(geo: Any, device=None) -> TwoViewGeometry:
    device = default_device(device)
    return TwoViewGeometry(
        R=_f32(geo.R, device), t=_f32(geo.t, device),
        inliers=_bool(geo.inliers, device),
        n_inliers=_i32(geo.n_inliers, device),
        success=_bool(geo.success, device),
    )


def pose_with_cov_from_numpy(p: Any, device=None) -> PoseWithCov:
    device = default_device(device)
    return PoseWithCov(
        pose=Pose(R=_f32(p.pose.R, device), C=_f32(p.pose.C, device)),
        cov=_f32(p.cov, device), rmse=_f32(p.rmse, device),
        n_tracks=_i32(p.n_tracks, device), success=_bool(p.success, device),
    )


def session_state_from_numpy(session: Any, target) -> None:
    """Carry a session's state (`mapdb`, `scene`, `filter_bank`,
    `lm_support`, `lm_last_seen`, `frame`, `map_ready`, and `last_pose`, a
    dict drone -> PoseWithCov) from `session`, a coloc_tpu ColocSession or
    any object with those attributes, into the port's ColocSession
    `target`, on the target's device."""
    dev = target.device
    target.mapdb = (None if session.mapdb is None
                    else mapdb_from_numpy(session.mapdb, dev))
    target.scene = (None if session.scene is None
                    else scene_from_numpy(session.scene, dev))
    target.filter_bank = filter_bank_from_numpy(session.filter_bank, dev)
    for name in ("lm_support", "lm_last_seen"):
        value = getattr(session, name)
        setattr(target, name, None if value is None else _i32(value, dev))
    target.last_pose = {int(d): pose_with_cov_from_numpy(p, dev)
                        for d, p in session.last_pose.items()}
    target.frame = int(session.frame)
    target.map_ready = bool(session.map_ready)


def to_numpy(x: Any) -> Any:
    """Tensor -> ndarray; NamedTuple (nested ones too, as InterPoseOut's
    `rel` and `diag`) -> the same NamedTuple of ndarrays, with a `desc`
    field viewed back to the reference's uint32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        out = {f: to_numpy(getattr(x, f)) for f in x._fields}
        if "desc" in out:
            out["desc"] = np.ascontiguousarray(out["desc"]).view(np.uint32)
        return type(x)(**out)
    if isinstance(x, tuple):
        return tuple(to_numpy(v) for v in x)
    return x
