"""SO(3) maps (counterpart of coloc_tpu.geometry.so3): Euler conversions
in the reference convention, hat, exp and log, the quaternion, and the
projection onto SO(3).

Batched over leading dimensions: w (..., 3) -> (..., 3, 3), R (..., 3, 3)
-> (..., 3), or (..., 4) for the quaternion.
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


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (w, x, y, z) (..., 4),
    Shepperd's method: all four candidate extractions, the one with the
    largest pivot kept (stable for every rotation, theta = pi included),
    sign canonical with w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # candidate pivots: 1+tr, 1+2*m00-tr, 1+2*m11-tr, 1+2*m22-tr (each 4*q_i^2)
    pw = 1.0 + tr
    px = 1.0 + 2.0 * m00 - tr
    py = 1.0 + 2.0 * m11 - tr
    pz = 1.0 + 2.0 * m22 - tr
    cand = torch.stack([
        torch.stack([pw, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, px, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, py, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, pz], dim=-1),
    ], dim=-2)                                              # (..., 4, 4)
    k = torch.argmax(torch.stack([pw, px, py, pz], dim=-1), dim=-1)
    q = torch.take_along_dim(cand, k[..., None, None].expand(*k.shape, 1, 4),
                             dim=-2)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> angle-axis (..., 3), through the quaternion
    (stable near 0 and pi)."""
    q = to_quaternion(R)
    w, v = q[..., 0], q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    # theta / vn with its limit 2 / w for small vn
    scale = torch.where(vn > 1e-7, theta / (vn + _EPS), 2.0 / torch.clamp(w, min=_EPS))
    return scale[..., None] * v


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (..., 3, 3) to M by SVD (used after linear
    solvers): U diag(1, 1, sign det(U Vt)) Vt."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return U @ D @ Vt
