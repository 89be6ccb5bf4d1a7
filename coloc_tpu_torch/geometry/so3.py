"""SO(3) maps (counterpart of coloc_tpu.geometry.so3): Euler conversions
in the reference convention, hat and exp.

Batched over leading dimensions: w (..., 3) -> (..., 3, 3), R (..., 3, 3)
-> (..., 3).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> (bank, attitude, heading) (..., 3), the
    colocUtils.hpp convention with its |m10| > 0.998 pole branches."""
    m00, m02 = R[..., 0, 0], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m22 = R[..., 2, 0], R[..., 2, 2]
    north = m10 > 0.998
    polar = north | (m10 < -0.998)
    half_pi = torch.full_like(m10, math.pi / 2)
    bank = torch.where(polar, 0.0, torch.atan2(-m12, m11))
    attitude = torch.where(polar, torch.where(north, half_pi, -half_pi),
                           torch.asin(torch.clamp(m10, -1.0, 1.0)))
    heading = torch.where(polar, torch.atan2(m02, m22), torch.atan2(-m20, m00))
    return torch.stack([bank, attitude, heading], dim=-1)


def euler_to_rot(euler: torch.Tensor) -> torch.Tensor:
    """(bank, attitude, heading) (..., 3) -> rotation (..., 3, 3)
    (colocUtils.hpp:102-141)."""
    b, a, h = euler[..., 0], euler[..., 1], euler[..., 2]
    cb, sb = torch.cos(b), torch.sin(b)
    ca, sa = torch.cos(a), torch.sin(a)
    ch, sh = torch.cos(h), torch.sin(h)
    return torch.stack([
        torch.stack([ch * ca, sh * sb - ch * sa * cb, ch * sa * sb + sh * cb], -1),
        torch.stack([sa, ca * cb, -ca * sb], -1),
        torch.stack([-sh * ca, sh * sa * cb + ch * sb, -sh * sa * sb + ch * cb], -1),
    ], dim=-2)


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
