"""SO(3) maps (counterpart of coloc_tpu.geometry.so3): hat and exp.

Batched over leading dimensions: w (..., 3) -> (..., 3, 3).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [w]_x, (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: angle-axis (..., 3) -> rotation (..., 3, 3), with the
    reference's series fallbacks below theta^2 = 1e-8."""
    theta_sq = (w * w).sum(dim=-1)
    theta = torch.sqrt(theta_sq + _EPS)
    big = theta_sq > 1e-8
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta_sq / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta_sq,
                    0.5 - theta_sq / 24.0)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)
