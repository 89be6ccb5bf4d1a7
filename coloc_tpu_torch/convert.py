"""numpy <-> port state.

The reference's state (Features, MapDB, Camera, FilterBank), taken out of
JAX as numpy arrays, becomes the port's state here and back. Descriptors
cross as a
bit-preserving view: uint32 in coloc_tpu, int32 in the port (types.py).
Inputs are any object with the reference's field names whose fields
np.asarray accepts, so a coloc_tpu NamedTuple can be passed as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from coloc_tpu_torch.fusion.kalman import FilterBank
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.types import Features, MapDB


def _desc_to_torch(desc, device) -> torch.Tensor:
    words = np.ascontiguousarray(np.asarray(desc, np.uint32)).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def features_from_numpy(feats: Any, device="cpu") -> Features:
    return Features(
        xy=_f32(feats.xy, device),
        score=_f32(feats.score, device),
        scale=torch.tensor(np.asarray(feats.scale, np.int32), device=device),
        angle=_f32(feats.angle, device),
        desc=_desc_to_torch(feats.desc, device),
        valid=torch.tensor(np.asarray(feats.valid, bool), device=device),
    )


def mapdb_from_numpy(mapdb: Any, device="cpu") -> MapDB:
    return MapDB(
        X=_f32(mapdb.X, device),
        desc=_desc_to_torch(mapdb.desc, device),
        valid=torch.tensor(np.asarray(mapdb.valid, bool), device=device),
    )


def camera_from_numpy(K, dist=None, device="cpu") -> Camera:
    dist = np.zeros(3, np.float32) if dist is None else dist
    return Camera(K=_f32(K, device), dist=_f32(dist, device))


def filter_bank_from_numpy(fb: Any, device="cpu") -> FilterBank:
    return FilterBank(
        x=_f32(fb.x, device),
        P=_f32(fb.P, device),
        steps=torch.tensor(np.asarray(fb.steps, np.int32), device=device),
    )


def to_numpy(x: Any) -> Any:
    """Tensor -> ndarray; NamedTuple -> the same NamedTuple of ndarrays, with
    a `desc` field viewed back to the reference's uint32."""
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
