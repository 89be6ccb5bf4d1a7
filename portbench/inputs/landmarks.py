"""The resident map that a cell localizes against, made by the benchmark
from the seed's scene: the reference frontend's keypoints (that of the
configuration's detector backend, in float32) of the scene's reference
view (the identity pose), as many as the map has slots, each placed at
the depth of the plane it lies on. Every slot holds a landmark of the
scene, one per scene point."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.inputs import scene as scene_mod
from portbench.reference import judge, pipeline, trip


def build(scene: scene_mod.Scene, det: dict, slots: int, device
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (X (slots, 3) float32, descriptor words (slots, 16) int32, valid
    (slots,) bool) on `device`; slots past the view's keypoints are
    invalid."""
    eye = np.eye(3, dtype=np.float32)[None]
    view = scene_mod.render(scene, eye, np.zeros((1, 3), np.float32), device)
    with pipeline.precision(False):
        kp = judge.reference_frontend(view, det, k=slots)
    valid = kp.valid[0]
    xy = kp.xy[0].double().cpu().numpy()
    Z = scene_mod.plane_depth(scene, xy)
    Kinv = np.linalg.inv(np.asarray(scene.K, np.float64))
    X = (Kinv @ np.c_[xy, np.ones(len(xy))].T).T * Z[:, None]
    X = np.where(valid.cpu().numpy()[:, None], X, 0.0)
    return (torch.as_tensor(X, dtype=torch.float32, device=device),
            trip.bits_to_words(kp.bits[0]), valid)
