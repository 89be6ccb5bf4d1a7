"""SE(3) pose algebra in the OpenMVG (rotation, center) convention
(counterpart of coloc_tpu.geometry.se3).

x_cam = R (X - C), t = -R C. Relative poses compose to absolute as
pose_j = relative * pose_i (Reconstructor.hpp:215-221).
"""

from __future__ import annotations

import torch

from coloc_tpu_torch.types import Pose


def transform(pose: Pose, X: torch.Tensor) -> torch.Tensor:
    """World -> camera frame. X: (..., 3)."""
    return (X - pose.C) @ pose.R.T


def inverse(pose: Pose) -> Pose:
    """Camera -> world as a Pose: R' = R^T, C' = -R C."""
    return Pose(R=pose.R.T, C=-pose.R @ pose.C)


def compose(p2: Pose, p1: Pose) -> Pose:
    """(p2 * p1)(X) = p2(p1(X)): apply p1 first (Pose3::operator*)."""
    return Pose(R=p2.R @ p1.R, C=p1.C + p1.R.T @ p2.C)


def relative_to_absolute(rel: Pose, pose_i: Pose, scale: float = 1.0) -> Pose:
    """Absolute pose_j from pose_i and a relative pose whose translation is
    scaled by `scale` first (monocular scale injection at bootstrap)."""
    C_rel = rel.C * scale
    return Pose(R=rel.R @ pose_i.R, C=pose_i.C + pose_i.R.T @ C_rel)
