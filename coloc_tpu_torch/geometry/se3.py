"""SE(3) pose algebra in the OpenMVG (rotation, center) convention
(counterpart of coloc_tpu.geometry.se3).

x_cam = R (X - C), t = -R C. Relative poses compose to absolute as
pose_j = relative * pose_i (Reconstructor.hpp:215-221).
"""

from __future__ import annotations

import torch

from coloc_tpu_torch.ops.dispatch import default_device
from coloc_tpu_torch.types import Pose


def identity(device=None) -> Pose:
    """The identity pose, on cuda:0 unless `device` says otherwise."""
    device = default_device(device)
    return Pose(R=torch.eye(3, device=device), C=torch.zeros(3, device=device))


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> Pose:
    """From (R, t) with x_cam = R X + t: C = -R^T t."""
    return Pose(R=R, C=-R.T @ t)


def transform(pose: Pose, X: torch.Tensor) -> torch.Tensor:
    """World -> camera frame. X: (..., 3)."""
    return (X - pose.C) @ pose.R.T


def inverse(pose: Pose) -> Pose:
    """Camera -> world as a Pose: R' = R^T, C' = -R C."""
    return Pose(R=pose.R.T, C=-pose.R @ pose.C)


def compose(p2: Pose, p1: Pose) -> Pose:
    """(p2 * p1)(X) = p2(p1(X)): apply p1 first (Pose3::operator*)."""
    return Pose(R=p2.R @ p1.R, C=p1.C + p1.R.T @ p2.C)


def relative(pose_i: Pose, pose_j: Pose) -> Pose:
    """The relative pose taking cam_i's frame to cam_j's: pose_j *
    pose_i^-1 (RobustMatcher.hpp:312-316)."""
    return Pose(R=pose_j.R @ pose_i.R.T, C=pose_i.R @ (pose_j.C - pose_i.C))


def relative_to_absolute(rel: Pose, pose_i: Pose, scale: float = 1.0) -> Pose:
    """Absolute pose_j from pose_i and a relative pose whose translation is
    scaled by `scale` first (monocular scale injection at bootstrap)."""
    C_rel = rel.C * scale
    return Pose(R=rel.R @ pose_i.R, C=pose_i.C + pose_i.R.T @ C_rel)
