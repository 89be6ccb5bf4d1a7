"""M-LDB binary descriptor (486 bits) + AKAZE main orientation (counterpart
of coloc_tpu.ops.mldb).

Reference parity: the AKAZE-MLDB describer of the reference's CPU path
(AKAZE.hpp, ComputeMLDBDescriptor):

  - orientation: the dominant gradient direction. (Lx, Ly) samples in a
    disc of radius 6 sigma go into a 30-bin histogram of gradient angle
    (sums by a one-hot product), a sliding 60-degree window (5 bins,
    circular) is swept, and the window with the largest vector sum wins
    (first index on ties);
  - descriptor: three grids (2x2, 3x3, 4x4) over a patch of half-size
    5 sigma rotated by the orientation; each cell averages L and the
    steered Lx, Ly over a fixed n x n sample grid, and every cell pair of a
    grid compares each channel: (6 + 36 + 120) x 3 = 486 bits, zero padded
    to 512 so the Hamming kernels are shared with TRIP-512.

`sampler(lx, ly)` is the caller's closure over ops/patches.sample_raster_flat
(B11). The tables _DISC and _grid_cells are regenerated here by coloc_tpu's
numpy code, which the port cannot import, and a test pins them equal.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from coloc_tpu_torch.ops.hamming import pack_bits

_ORI_BINS = 30
_PATCH_HALF = 5.0   # patch half-size in units of sigma
_CELL_SAMPLES = 4   # sample points per cell axis (the NORMAL preset)


def _disc_offsets(radius: float = 6.0, rings: int = 3):
    """Fixed disc sampling pattern (unit-sigma units), (P, 2) float32."""
    pts = [(0.0, 0.0)]
    for r in range(1, rings + 1):
        rad = radius * r / rings
        n = 8 * r
        for k in range(n):
            a = 2 * np.pi * k / n
            pts.append((rad * np.cos(a), rad * np.sin(a)))
    return np.asarray(pts, np.float32)


_DISC = _disc_offsets()


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _disc_on(device: torch.device) -> torch.Tensor:
    """_DISC on `device`, copied once per device, not every frame (a
    captured step may not copy from the host). Read only."""
    return torch.from_numpy(_DISC).to(device)


def orientation(sampler, kp_x, kp_y, kp_sigma_px, w_l, h_l, col0,
                row0_local) -> torch.Tensor:
    """Dominant-gradient orientation per keypoint, (K,) radians.

    `sampler(lx, ly)` -> (2, K, P) Lx / Ly samples at window-local
    coordinates; kp_* are level-local, w_l / h_l the levels' extents
    (float), col0 / row0_local the windows' level-local origins."""
    disc = _disc_on(kp_x.device)
    sx = kp_x[:, None] + kp_sigma_px[:, None] * disc[None, :, 0]
    sy = kp_y[:, None] + kp_sigma_px[:, None] * disc[None, :, 1]
    sx = torch.minimum(torch.clamp(sx, min=0.0), (w_l - 1.0)[:, None])
    sy = torch.minimum(torch.clamp(sy, min=0.0), (h_l - 1.0)[:, None])
    lx = sx - col0.to(torch.float32)[:, None]
    ly = sy - row0_local.to(torch.float32)[:, None]
    gx, gy = sampler(lx, ly)                                # (K, P) each

    ang = torch.atan2(gy, gx)
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * _ORI_BINS).to(torch.int64)
    bins = torch.clamp(bins, 0, _ORI_BINS - 1)
    onehot = (bins[:, :, None] == torch.arange(_ORI_BINS, device=bins.device)
              ).to(torch.float32)                           # (K, P, 30)
    sum_x = torch.bmm(gx[:, None, :], onehot)[:, 0]         # (K, 30)
    sum_y = torch.bmm(gy[:, None, :], onehot)[:, 0]

    def win(a):     # sliding 60-degree window: 5 consecutive 12-degree bins
        out = 0
        for s in range(5):
            out = out + torch.roll(a, -s, dims=1)
        return out

    wx, wy = win(sum_x), win(sum_y)
    best = torch.argmax(wx * wx + wy * wy, dim=1, keepdim=True)
    return torch.atan2(wy.gather(1, best)[:, 0], wx.gather(1, best)[:, 0])


@functools.lru_cache(maxsize=None)
def _grid_cells(cell_samples: int = _CELL_SAMPLES):
    """Static sample layout: per grid {2, 3, 4}, per cell, per sample point
    -> normalised patch coordinates in [-1, 1]. Returns (coords (N, 2),
    cell_id (N,), cell pairs (162, 2), number of cells)."""
    coords, cell_of = [], []
    cell_base = 0
    grids = []
    for g in (2, 3, 4):
        cells_this = []
        for cy in range(g):
            for cx in range(g):
                cid = cell_base + cy * g + cx
                cells_this.append(cid)
                for iy in range(cell_samples):
                    for ix in range(cell_samples):
                        u = (cx + (ix + 0.5) / cell_samples) / g * 2 - 1
                        v = (cy + (iy + 0.5) / cell_samples) / g * 2 - 1
                        coords.append((u, v))
                        cell_of.append(cid)
        pairs = []
        for a in range(len(cells_this)):
            for b in range(a + 1, len(cells_this)):
                pairs.append((cells_this[a], cells_this[b]))
        grids.append(pairs)
        cell_base += g * g
    all_pairs = [p for g in grids for p in g]
    return (
        np.asarray(coords, np.float32),
        np.asarray(cell_of, np.int64),
        np.asarray(all_pairs, np.int64),
        cell_base,
    )


class _GridTables(NamedTuple):
    """_grid_cells on one device: what describe_mldb reads of it."""

    coords: torch.Tensor     # (N, 2) float32 normalised patch coordinates
    pool: torch.Tensor       # (N, cells) float32 one-hot over cell_of / count
    pair_a: torch.Tensor     # (162,) int64 first cell of each compared pair
    pair_b: torch.Tensor     # (162,) int64 second cell


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _grid_on(device: torch.device, cell_samples: int) -> _GridTables:
    """_grid_cells(cell_samples) on `device`, made once per device and not
    every frame (a captured step may not copy from the host); the pooling
    matrix is normalised on the device, as each call did. Read only."""
    coords, cell_of, pairs, num_cells = _grid_cells(cell_samples)
    onehot = (torch.from_numpy(cell_of).to(device)[:, None]
              == torch.arange(num_cells, device=device)[None, :]).to(torch.float32)
    return _GridTables(
        coords=torch.from_numpy(coords).to(device),
        pool=onehot / onehot.sum(dim=0, keepdim=True),
        pair_a=torch.from_numpy(pairs[:, 0]).to(device),
        pair_b=torch.from_numpy(pairs[:, 1]).to(device))


def describe_mldb(sampler, kp_x, kp_y, kp_sigma_px, kp_angle, w_l, h_l,
                  col0, row0_local, cell_samples: int = _CELL_SAMPLES
                  ) -> torch.Tensor:
    """-> (K, 16) int32 words: 486 MLDB bits + 26 zero padding bits.

    `sampler(lx, ly)` -> (3, K, N) L / Lx / Ly samples. Cell means are one
    float32 product with the normalised pooling matrix (TF32 off,
    coloc_tpu_torch/__init__.py), as coloc_tpu's `L @ cell_onehot`."""
    grid = _grid_on(kp_x.device, cell_samples)
    coords = grid.coords
    ca, sa = torch.cos(kp_angle), torch.sin(kp_angle)

    half = _PATCH_HALF * kp_sigma_px
    u = coords[None, :, 0] * half[:, None]
    v = coords[None, :, 1] * half[:, None]
    rx = ca[:, None] * u - sa[:, None] * v
    ry = sa[:, None] * u + ca[:, None] * v
    sx = torch.minimum(torch.clamp(kp_x[:, None] + rx, min=0.0), (w_l - 1.0)[:, None])
    sy = torch.minimum(torch.clamp(kp_y[:, None] + ry, min=0.0), (h_l - 1.0)[:, None])
    lx = sx - col0.to(torch.float32)[:, None]
    ly = sy - row0_local.to(torch.float32)[:, None]

    L, Gx, Gy = sampler(lx, ly)                             # (K, N) each
    Dx = ca[:, None] * Gx + sa[:, None] * Gy                # steered derivatives
    Dy = -sa[:, None] * Gx + ca[:, None] * Gy

    pool = grid.pool
    mL, mX, mY = L @ pool, Dx @ pool, Dy @ pool             # (K, cells)

    pa, pb = grid.pair_a, grid.pair_b
    bits = torch.cat([mL[:, pa] > mL[:, pb], mX[:, pa] > mX[:, pb],
                      mY[:, pa] > mY[:, pb]], dim=1)        # (K, 486)
    bits = torch.nn.functional.pad(bits.to(torch.int32), (0, 512 - bits.shape[1]))
    return pack_bits(bits)
