"""Inverse Covariance Intersection (ICI) fusion of two position estimates
(counterpart of coloc_tpu.fusion.covint).

Reference parity: CovIntersection.hpp, which despite its class name
implements inverse covariance intersection:
  C_fused(w) = (CA^-1 + CB^-1 - (w CA + (1-w) CB)^-1)^-1            (:27,42)
  w* = argmin_{w in [0,1]} tr(C_fused(w))                            (:34-38)
  K = C_f (CA^-1 - w* M), L = C_f (CB^-1 - (1-w*) M), x = K a + L b  (:40-49)

The 1-D minimization is coloc_tpu's fixed golden-section search: 40 steps,
unrolled here with no host read, the two trial points of a step evaluated
as one batch. Inverses are torch.linalg.inv_ex, which leaves its error
flag on the device (torch.linalg.inv reads it back to the host). Inputs
may carry leading batch axes.

The trace near its minimum is flat to below float32 resolution, so which
trial point wins a step follows each implementation's 3x3-inverse
rounding: the port's w* and fused position agree with a float64 ICI as
closely as coloc_tpu's do, not element-wise with coloc_tpu's (ROADMAP C15).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_GOLDEN = 0.6180339887498949  # 1/phi
_ITERS = 40


class FusionResult(NamedTuple):
    cov: torch.Tensor    # (..., 3, 3) fused covariance
    pos: torch.Tensor    # (..., 3) fused position
    omega: torch.Tensor  # (...) optimal weight
    trace: torch.Tensor  # (...) minimized trace


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A).inverse


def _trace(A: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def _fused_cov(w, CA_inv, CB_inv, CA, CB):
    """C_fused(w) for weights w (...) against CA, CB (..., 3, 3)."""
    w = w[..., None, None]
    M = _inv(w * CA + (1.0 - w) * CB)
    return _inv(CA_inv + CB_inv - M)


def fuse(CA: torch.Tensor, CB: torch.Tensor, a: torch.Tensor, b: torch.Tensor
         ) -> FusionResult:
    """ICI fusion (loadData + optimize + computeFusedValues parity): CA, CB
    (..., 3, 3) covariances of the positions a, b (..., 3)."""
    CA_inv, CB_inv = _inv(CA), _inv(CB)
    lo = torch.zeros(CA.shape[:-2], dtype=CA.dtype, device=CA.device)
    hi = torch.ones_like(lo)
    for _ in range(_ITERS):
        m1 = hi - _GOLDEN * (hi - lo)
        m2 = lo + _GOLDEN * (hi - lo)
        f = _trace(_fused_cov(torch.stack([m1, m2]), CA_inv, CB_inv, CA, CB))
        first = f[0] < f[1]
        lo = torch.where(first, lo, m1)
        hi = torch.where(first, m2, hi)
    w = (lo + hi) / 2.0

    wm = w[..., None, None]
    M = _inv(wm * CA + (1.0 - wm) * CB)
    C_f = _inv(CA_inv + CB_inv - M)
    K = C_f @ (CA_inv - wm * M)
    L = C_f @ (CB_inv - (1.0 - wm) * M)
    pos = (K @ a[..., None] + L @ b[..., None])[..., 0]
    return FusionResult(cov=C_f, pos=pos, omega=w, trace=_trace(C_f))
