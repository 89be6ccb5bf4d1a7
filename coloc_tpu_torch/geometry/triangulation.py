"""Batched DLT triangulation (counterpart of coloc_tpu.geometry.triangulation).

Reference parity: OpenMVG TriangulateDLT at Reconstructor.hpp:225 (two-view
bootstrap) and :378-380 (resection). One 4x4 symmetric eigensolve a track,
the smallest eigenvector of A^T A, in normalized (undistorted, unit-focal)
coordinates.

torch.linalg.eigh may raise on a non-finite matrix where jnp.linalg.eigh
returns NaN, so a masked-out track's A^T A is replaced by the identity
before the solve: its X is finite and is never read.
"""

from __future__ import annotations

from typing import Optional

import torch


def _projection_rows(R: torch.Tensor, C: torch.Tensor,
                     xy: torch.Tensor) -> torch.Tensor:
    """Two DLT rows a view: R (..., 3, 3), C (..., 3), xy (..., 2)
    normalized coords -> (..., 2, 4)."""
    t = -(R @ C[..., None])                                  # (..., 3, 1)
    P = torch.cat([R, t], dim=-1)                            # (..., 3, 4)
    return torch.stack([xy[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                        xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=-2)


def _solve(AtA: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Smallest eigenvector of (N, 4, 4) A^T A -> euclidean X (N, 3)."""
    if mask is not None:
        eye = torch.eye(4, dtype=AtA.dtype, device=AtA.device)
        AtA = torch.where(mask[:, None, None], AtA, eye)
    _, vecs = torch.linalg.eigh(AtA)
    Xh = vecs[:, :, 0]
    w = Xh[:, 3]
    # |w| < 1e-12 (a point at infinity): w -> +-1e-12, the sign of w kept
    tiny = torch.where(w == 0, 1e-12, torch.sign(w) * 1e-12)
    w = torch.where(w.abs() < 1e-12, tiny, w)
    return Xh[:, :3] / w[:, None]


def triangulate_two_view(R1, C1, xy1, R2, C2, xy2) -> torch.Tensor:
    """DLT of one correspondence, xy1/xy2 (2,) normalized undistorted
    coords -> euclidean X (3,)."""
    return triangulate_points(R1, C1, xy1[None], R2, C2, xy2[None])[0]


def triangulate_points(R1, C1, x1, R2, C2, x2,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-view DLT of N correspondences: poses (3, 3)/(3,), x1/x2 (N, 2)
    normalized undistorted coords -> X (N, 3). `mask` (N,) bool: tracks
    whose X is used; the others solve the identity instead."""
    A = torch.cat([_projection_rows(R1, C1, x1), _projection_rows(R2, C2, x2)],
                  dim=-2)                                    # (N, 4, 4)
    return _solve(A.transpose(-1, -2) @ A, mask)


def triangulate_nview(Rs: torch.Tensor, Cs: torch.Tensor, xys: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Masked N-view DLT of one track: Rs (V, 3, 3), Cs (V, 3), xys (V, 2),
    mask (V,) bool -> X (3,). A^T A accumulates over the observing views."""
    rows = _projection_rows(Rs, Cs, xys) * mask[:, None, None].to(Rs.dtype)
    A = rows.reshape(-1, 4)
    _, vecs = torch.linalg.eigh(A.T @ A)
    Xh = vecs[:, 0]
    w = torch.where(Xh[3].abs() < 1e-12, 1e-12, Xh[3])
    return Xh[:3] / w


def ray_angle_deg(C1: torch.Tensor, C2: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """Angle between the viewing rays at X, degrees."""
    r1, r2 = X - C1, X - C2
    c = (r1 * r2).sum(dim=-1) / (torch.linalg.norm(r1, dim=-1)
                                 * torch.linalg.norm(r2, dim=-1) + 1e-12)
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def depth_in_view(R: torch.Tensor, C: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return ((X - C) @ R.T)[..., 2]
