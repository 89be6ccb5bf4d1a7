"""Pinhole camera with radial-K3 distortion (counterpart of
coloc_tpu.geometry.camera).

Forward distortion x_d = x_u (1 + k1 r^2 + k2 r^4 + k3 r^6) in normalized
coords; undistortion by the same 10-step fixed-point iteration. All
functions take (..., 2) pixel tensors. A camera of D drones holds K (D, 1,
3, 3) and dist (D, 1, 3): its intrinsics then broadcast against (D, M, 2)
pixels (the drone axis of the batched frame step).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    K: torch.Tensor     # (..., 3, 3) intrinsics
    dist: torch.Tensor  # (..., 3) radial k1, k2, k3

    @property
    def fx(self):
        return self.K[..., 0, 0]

    @property
    def fy(self):
        return self.K[..., 1, 1]

    @property
    def cx(self):
        return self.K[..., 0, 2]

    @property
    def cy(self):
        return self.K[..., 1, 2]


_UNDISTORT_ITERS = 10


def normalize(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized image coords (no distortion removal)."""
    f = torch.stack([cam.fx, cam.fy], dim=-1)
    c = torch.stack([cam.cx, cam.cy], dim=-1)
    return (uv - c) / f


def denormalize(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    f = torch.stack([cam.fx, cam.fy], dim=-1)
    c = torch.stack([cam.cx, cam.cy], dim=-1)
    return xy * f + c


def _radial_factor(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    r2 = (xy * xy).sum(dim=-1, keepdim=True)
    k1, k2, k3 = cam.dist[..., 0:1], cam.dist[..., 1:2], cam.dist[..., 2:3]
    return 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))


def distort(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    return xy * _radial_factor(cam, xy)


def undistort(cam: Camera, xy_d: torch.Tensor) -> torch.Tensor:
    """Invert radial distortion by fixed-point iteration (fixed trip count)."""
    xy = xy_d
    for _ in range(_UNDISTORT_ITERS):
        xy = xy_d / _radial_factor(cam, xy)
    return xy


def undistort_pixel(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """get_ud_pixel parity: distorted pixel -> undistorted pixel."""
    return denormalize(cam, undistort(cam, normalize(cam, uv)))


def bearing(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel -> unit bearing vector in the camera frame, (..., 3)."""
    xy = undistort(cam, normalize(cam, uv))
    v = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def project_cam(cam: Camera, X_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point -> distorted pixel. X_cam: (..., 3)."""
    xy = X_cam[..., :2] / torch.clamp(X_cam[..., 2:3], min=1e-9)
    return denormalize(cam, distort(cam, xy))


def project(cam: Camera, R: torch.Tensor, C: torch.Tensor,
            X: torch.Tensor) -> torch.Tensor:
    """World point -> distorted pixel through pose (R, C). X: (..., 3)."""
    return project_cam(cam, (X - C) @ R.T)


def depth(R: torch.Tensor, C: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Z coordinate in the camera frame (positive = in front)."""
    return ((X - C) @ R.T)[..., 2]
