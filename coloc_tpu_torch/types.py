"""Fixed-capacity data model (counterpart of coloc_tpu.types).

Same fields, fixed capacity and validity masks as the reference, as
NamedTuples of tensors. One deliberate change: descriptors are (N, 16)
int32 holding the uint32 bit layout of coloc_tpu (bit 0 of word 0 first),
because torch has no CUDA bitwise ops on uint32. convert.py moves them
across with a bit-preserving `.view`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coloc_tpu_torch.ops.dispatch import default_device

DESC_WORDS = 16  # 512-bit binary descriptors as 16 x 32-bit words


class Features(NamedTuple):
    """Detected keypoints + binary descriptors for one image."""

    xy: torch.Tensor       # (K, 2) float32, full-resolution pixel coords
    score: torch.Tensor    # (K,) float32 detector response
    scale: torch.Tensor    # (K,) int32 pyramid level
    angle: torch.Tensor    # (K,) float32 orientation, radians
    desc: torch.Tensor     # (K, DESC_WORDS) int32 packed binary descriptor
    valid: torch.Tensor    # (K,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


class Matches(NamedTuple):
    """2-NN match result, one entry per query descriptor (-1 = rejected)."""

    idx: torch.Tensor      # (Q,) int32 train index, -1 if rejected
    best: torch.Tensor     # (Q,) int32 best Hamming distance
    second: torch.Tensor   # (Q,) int32 second-best Hamming distance

    @property
    def mask(self) -> torch.Tensor:
        return self.idx >= 0


class Pose(NamedTuple):
    """SE(3) pose as (rotation, center): x_cam = R @ (X_world - C)."""

    R: torch.Tensor        # (3, 3)
    C: torch.Tensor        # (3,)

    @property
    def t(self) -> torch.Tensor:
        return -self.R @ self.C


class PoseWithCov(NamedTuple):
    """Pose + 6x6 covariance ((w, dC) order) + fit quality."""

    pose: Pose
    cov: torch.Tensor      # (6, 6)
    rmse: torch.Tensor     # () float32 reprojection RMSE
    n_tracks: torch.Tensor  # () int32 inlier/track count
    success: torch.Tensor  # () bool


class TwoViewGeometry(NamedTuple):
    """Relative pose from robust two-view estimation (RelativePose_Info)."""

    R: torch.Tensor        # (3, 3) rotation, camera 1 -> camera 2
    t: torch.Tensor        # (3,) unit translation, x2 = R x1 + t
    inliers: torch.Tensor  # (K,) bool over the putative matches
    n_inliers: torch.Tensor  # () int32
    success: torch.Tensor  # () bool


class MapDB(NamedTuple):
    """Landmark map + resident descriptor bank."""

    X: torch.Tensor        # (L, 3) float32 landmark positions
    desc: torch.Tensor     # (L, DESC_WORDS) int32 first-observation descriptors
    valid: torch.Tensor    # (L,) bool

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


def empty_features(capacity: int, device=None) -> Features:
    """`capacity` zero keypoints, all invalid, on `device` (None: cuda:0,
    raising where there is none)."""
    dev = default_device(device)
    return Features(
        xy=torch.zeros((capacity, 2), dtype=torch.float32, device=dev),
        score=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        scale=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        angle=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        desc=torch.zeros((capacity, DESC_WORDS), dtype=torch.int32, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def empty_mapdb(capacity: int, device=None) -> MapDB:
    """A map of `capacity` free slots on `device` (None: cuda:0)."""
    dev = default_device(device)
    return MapDB(
        X=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
        desc=torch.zeros((capacity, DESC_WORDS), dtype=torch.int32, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )
