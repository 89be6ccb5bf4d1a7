"""Batched Grunert P3P absolute-pose solver (counterpart of
coloc_tpu.geometry.p3p).

Each minimal sample (3 world points + 3 unit bearings) yields up to 4 poses
as RANSAC-ready "flats" (row-major R | C, 12 floats) with a validity mask.
The quartic is solved in closed form (Ferrari resolvent with both cubic
branches selected by the discriminant, then 2 Newton steps on the cubic and
2 on the quartic) and each root becomes a pose by a triad Horn alignment.

  p3p_flats_batch  — the entry RANSAC calls: the CUDA kernel csrc/p3p.cu on
                     a CUDA tensor, p3p_flats_plain on CPU
  p3p_flats_plain  — the kernel's plain twin: the TPU kernel's arithmetic
                     (polynomial acos, same guards and evaluation order)
  p3p_grunert      — the reference's per-sample form (true acos), batched
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from coloc_tpu_torch.ops import _build, dispatch
from coloc_tpu_torch.types import Pose

_PI_F32 = float(np.float32(np.pi))
# Division by a constant is multiplication by its float32 reciprocal, as
# the reference's compiled kernel evaluates it (XLA rewrites x / c into
# x * (1/c) and folds 2 x / 27 into x * (2/27)); P3P is ill-conditioned
# enough in float32 that the two roundings move poses by up to 1e-2.
_THIRD = float(np.float32(1.0 / 3.0))
_TWO_27THS = float(np.float32(2.0 / 27.0))


def _acos_poly(x: torch.Tensor) -> torch.Tensor:
    """arccos by Abramowitz & Stegun 4.4.45 (|err| <= 5e-5 rad); the TPU
    kernel's form, which the resolvent's Newton steps absorb."""
    ax = x.abs()
    p = ((-0.0187293 * ax + 0.0742610) * ax - 0.2121144) * ax + 1.5707288
    r = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x < 0.0, _PI_F32 - r, r)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _sub(a, b):
    return [a[k] - b[k] for k in range(3)]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _unit(a):
    n = torch.sqrt(_dot(a, a)) + 1e-12
    return [a[k] / n for k in range(3)]


def _triad(p1, p2, p3):
    u1 = _unit(_sub(p2, p1))
    u2 = _unit(_cross(u1, _sub(p3, p1)))
    return u1, u2, _cross(u1, u2)            # columns


def _p3p_core(X_world: torch.Tensor, bearings: torch.Tensor,
              acos: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,3,3) x2 -> ((B,4,12) flats, (B,4) valid), elementwise on (B,)
    tensors in the TPU kernel's evaluation order."""
    P = [[X_world[:, i, j] for j in range(3)] for i in range(3)]
    F = [[bearings[:, i, j] for j in range(3)] for i in range(3)]

    a2 = _dot(_sub(P[1], P[2]), _sub(P[1], P[2]))
    b2 = torch.clamp(_dot(_sub(P[0], P[2]), _sub(P[0], P[2])), min=1e-12)
    c2 = _dot(_sub(P[0], P[1]), _sub(P[0], P[1]))
    cos_a = _dot(F[1], F[2])
    cos_b = _dot(F[0], F[2])
    cos_g = _dot(F[0], F[1])
    ab = a2 / b2
    cb = c2 / b2

    # u = N(v) / D(v); quartic N^2 - 2 cos_g N D + K1 D^2 = 0
    N0, N1, N2 = -(1.0 + ab - cb), 2.0 * cos_b * (ab - cb), (1.0 - ab + cb)
    D0, D1 = -2.0 * cos_g, 2.0 * cos_a
    K0, K1c, K2 = (1.0 - cb), 2.0 * cb * cos_b, -cb
    NN = [N0 * N0, 2 * N0 * N1, N1 * N1 + 2 * N0 * N2, 2 * N1 * N2, N2 * N2]
    ND = [N0 * D0, N0 * D1 + N1 * D0, N1 * D1 + N2 * D0, N2 * D1]
    DD = [D0 * D0, 2 * D0 * D1, D1 * D1]
    KDD = [K0 * DD[0], K0 * DD[1] + K1c * DD[0],
           K0 * DD[2] + K1c * DD[1] + K2 * DD[0],
           K1c * DD[2] + K2 * DD[1], K2 * DD[2]]
    q = [NN[k] - 2.0 * cos_g * ND[k] + KDD[k] for k in range(4)]
    q.append(NN[4] + KDD[4])

    # Ferrari closed form
    lead = torch.where(q[4].abs() < 1e-20, 1e-20, q[4])
    c = [qq / lead for qq in q]
    a3q, a2q, a1q, a0q = c[3], c[2], c[1], c[0]
    a3q_2 = a3q * a3q
    sh = a3q / 4.0
    p = a2q - 3.0 * a3q * a3q / 8.0
    qd = a1q - a3q * a2q / 2.0 + a3q * a3q_2 / 8.0
    r = (a0q - a3q * a1q / 4.0 + a3q * a3q * a2q / 16.0
         - 3.0 * (a3q_2 * a3q_2) / 256.0)
    cbq = p
    ccq = p * p / 4.0 - r
    cdq = -qd * qd / 8.0
    Pq = ccq - cbq * cbq * _THIRD
    Qq = cdq - cbq * ccq * _THIRD + (cbq * (cbq * cbq)) * _TWO_27THS
    Qh, P3 = Qq / 2.0, Pq * _THIRD
    disc = Qh * Qh + P3 * (P3 * P3)
    Pn = torch.clamp(Pq, max=-1e-20)
    # a true division: torch evaluates `scalar / tensor` as
    # reciprocal(tensor) * scalar, which rounds twice
    theta = acos(torch.clamp(
        (3.0 * Qq) / (2.0 * Pn) * torch.sqrt(torch.full_like(Pn, -3.0) / Pn),
        -1.0, 1.0))
    w_trig = 2.0 * torch.sqrt(-Pn * _THIRD) * torch.cos(theta * _THIRD)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    w = torch.where(disc > 0.0,
                    _cbrt(-Qq / 2.0 + sq) + _cbrt(-Qq / 2.0 - sq), w_trig)
    m = w - cbq * _THIRD
    for _ in range(2):
        f_m = ((m + cbq) * m + ccq) * m + cdq
        df_m = (3.0 * m + 2.0 * cbq) * m + ccq
        m = m - f_m / torch.where(df_m.abs() < 1e-12, 1e-12, df_m)
    m = torch.clamp(m, min=0.0)
    s = torch.sqrt(2.0 * m + 1e-20)
    half = (p + 2.0 * m) / 2.0
    qs = qd / (2.0 * s)
    dA = s * s - 4.0 * (half - qs)
    dB = s * s - 4.0 * (half + qs)
    rA = torch.sqrt(torch.clamp(dA, min=0.0))
    rB = torch.sqrt(torch.clamp(dB, min=0.0))
    roots_y = [(-s + rA) / 2.0, (-s - rA) / 2.0,
               (s + rB) / 2.0, (s - rB) / 2.0]
    tol = 1e-3 * (1.0 + s * s + half.abs() + qs.abs())
    realness = [dA > -tol, dA > -tol, dB > -tol, dB > -tol]

    # root-independent pieces of the Horn alignment
    A1, A2, A3 = _triad(P[0], P[1], P[2])
    meanP = [(P[0][k] + P[1][k] + P[2][k]) * _THIRD for k in range(3)]

    flats, valid = [], []
    for ridx in range(4):
        x = roots_y[ridx] - sh
        for _ in range(2):
            poly = ((((x + c[3]) * x + c[2]) * x + c[1]) * x) + c[0]
            dpoly = ((4.0 * x + 3.0 * c[3]) * x + 2.0 * c[2]) * x + c[1]
            x = x - poly / (dpoly + 1e-12)
        is_real = realness[ridx] & torch.isfinite(x)
        v = x
        Nv = (N2 * v + N1) * v + N0
        Dv = D1 * v + D0
        u = Nv / torch.where(Dv.abs() < 1e-9, 1e-9, Dv)
        s1 = torch.sqrt(b2 / torch.clamp(1.0 + v * v - 2.0 * v * cos_b,
                                         min=1e-12))
        s2 = u * s1
        s3 = v * s1
        X1 = [F[0][k] * s1 for k in range(3)]
        X2 = [F[1][k] * s2 for k in range(3)]
        X3 = [F[2][k] * s3 for k in range(3)]
        B1, B2, B3 = _triad(X1, X2, X3)
        R = [[B1[i] * A1[j] + B2[i] * A2[j] + B3[i] * A3[j]
              for j in range(3)] for i in range(3)]
        meanX = [(X1[k] + X2[k] + X3[k]) * _THIRD for k in range(3)]
        C = [meanP[j] - (R[0][j] * meanX[0] + R[1][j] * meanX[1]
                         + R[2][j] * meanX[2]) for j in range(3)]
        flats.append(torch.stack([R[i][j] for i in range(3)
                                  for j in range(3)] + C, dim=-1))
        valid.append((v > 0) & (u > 0) & (s1 > 0) & is_real)
    return torch.stack(flats, dim=1), torch.stack(valid, dim=1)


def p3p_flats_plain(X_world: torch.Tensor, bearings: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of csrc/p3p.cu: (B,3,3) x2 -> ((B,4,12), (B,4))."""
    return _p3p_core(X_world, bearings, _acos_poly)


def _p3p_flats_cuda(X_world, bearings):
    dev = X_world.device
    B = X_world.shape[0]
    dispatch.check_operand(X_world, "X_world", torch.float32, (B, 3, 3), dev)
    dispatch.check_operand(bearings, "bearings", torch.float32, (B, 3, 3), dev)
    flats = torch.empty((B, 4, 12), dtype=torch.float32, device=dev)
    valid = torch.empty((B, 4), dtype=torch.bool, device=dev)
    _build.launch("coloc_p3p", X_world.data_ptr(), bearings.data_ptr(),
                  flats.data_ptr(), valid.data_ptr(), B, dev.index,
                  dispatch.stream_handle(dev))
    dispatch.count_launch("p3p")
    return flats, valid


def p3p_flats_batch(X_world: torch.Tensor, bearings: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Grunert P3P emitting RANSAC-ready (B,4,12) flats + (B,4) valid."""
    if dispatch.use_kernel(X_world):
        return _p3p_flats_cuda(X_world.contiguous(), bearings.contiguous())
    return p3p_flats_plain(X_world, bearings)


def p3p_grunert(X_world: torch.Tensor, bearings: torch.Tensor
                ) -> Tuple[Pose, torch.Tensor]:
    """(B,3,3) x2 -> (Pose of (B,4,3,3) / (B,4,3), valid (B,4)), with the
    true arccos in the resolvent's trigonometric branch."""
    flats, valid = _p3p_core(X_world, bearings, torch.acos)
    B = flats.shape[0]
    return Pose(R=flats[..., :9].reshape(B, 4, 3, 3), C=flats[..., 9:]), valid
