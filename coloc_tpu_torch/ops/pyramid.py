"""Scale pyramid + box smoothing (counterpart of coloc_tpu.ops.pyramid).

Reference parity: CUDALERP — bilinear downscale of the base image to 8
levels at 1.2x steps. Each level resizes from the previous one with two
dense float32 matmuls against static resample matrices (the same numpy
matrices as coloc_tpu). TF32 is off (coloc_tpu_torch/__init__.py), so the
products are full float32 on the card; their summation order is cuBLAS's,
not XLA's, so levels agree with coloc_tpu to ~1e-4 on 0-255 values, not
bit for bit.

Images carry any leading batch dimensions: (..., H, W).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(height: int, width: int, num_levels: int,
                 scale_factor: float) -> List[Tuple[int, int]]:
    """Static (H_l, W_l) per level; level 0 is full resolution."""
    shapes = []
    for l in range(num_levels):
        f = scale_factor ** l
        shapes.append((max(int(round(height / f)), 8),
                       max(int(round(width / f)), 8)))
    return shapes


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bilinear resample matrix: output i samples input
    at (i+0.5)*n_in/n_out - 0.5, triangle kernel radius 1, edge clamped
    (jax.image.resize(method="linear", antialias=False) positions)."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - f)
    np.add.at(m, (np.arange(n_out), hi), f)
    return m


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _resize_tensor(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (shape, device), not one per frame
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def resize_bilinear(image: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., shape[0], shape[1]), two float32 matmuls."""
    h, w = image.shape[-2:]
    mh = _resize_tensor(h, shape[0], image.device)
    mw = _resize_tensor(w, shape[1], image.device)
    return torch.matmul(torch.matmul(mh, image), mw.T)


def build_pyramid_batch(images: torch.Tensor, num_levels: int,
                        scale_factor: float) -> List[torch.Tensor]:
    """(B, H, W) float32 -> list of (B, H_l, W_l). Each level resamples the
    previous one (a geometric series of work, as in coloc_tpu)."""
    h, w = images.shape[-2:]
    shapes = level_shapes(h, w, num_levels, scale_factor)
    levels = [images]
    for l in range(1, num_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def build_pyramid(image: torch.Tensor, num_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """(H, W) float32 -> list of (H_l, W_l)."""
    return [l[0] for l in build_pyramid_batch(image[None], num_levels,
                                              scale_factor)]


def _edge_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def box_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box blur over the last two dims, edge-replicated
    (descriptor pre-smoothing)."""
    k = 2 * radius + 1
    x = _running_mean(_edge_pad(image, radius, -2), k, -2)
    return _running_mean(_edge_pad(x, radius, -1), k, -1)


def _running_mean(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Mean over k consecutive entries along dim (output length n-k+1):
    shifted adds in coloc_tpu's order for k <= 7, a cumsum difference
    above."""
    n = x.shape[dim]
    if k <= 7:
        acc = x.narrow(dim, 0, n - k + 1)
        for s in range(1, k):
            acc = acc + x.narrow(dim, s, n - k + 1)
        return acc / k
    csum = torch.cumsum(x, dim=dim)
    csum = torch.cat([torch.zeros_like(csum.narrow(dim, 0, 1)), csum], dim=dim)
    return (csum.narrow(dim, k, n - k + 1) - csum.narrow(dim, 0, n - k + 1)) / k
