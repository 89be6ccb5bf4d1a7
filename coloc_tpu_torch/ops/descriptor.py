"""TRIP-512 steered triplet descriptor (counterpart of
coloc_tpu.ops.descriptor).

Per keypoint, POOL_SIZE sample points in a disc of radius 24 px are
steered by the keypoint's angle and sampled at nearest pixels of the
smoothed patch; each of the 512 bits compares two pool points against an
anchor, (a - p1)^2 > (a - p2)^2. The pool and triplet tables come from the
same numpy generator, seed and call order as coloc_tpu's, so both packages
hold the same tables (pinned by tests/test_torch_frontend.py). Bits pack
as ops/hamming.pack_bits (bit 0 of word 0 first).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from coloc_tpu_torch.ops import patches as patch_ops
from coloc_tpu_torch.ops.hamming import pack_bits

DESC_BITS = 512
POOL_SIZE = 192
_TABLE_SEED = 20240816
_SUPPORT_RADIUS = 24.0  # spatial support, px
_MIN_SEP = 3.0          # keep compared pool points distinct


def _make_tables(seed: int = _TABLE_SEED):
    """Returns (pool (P, 2) float32 offsets, triplets (512, 3) int32)."""
    rng = np.random.default_rng(seed)
    pool = np.zeros((POOL_SIZE, 2), np.float32)
    i = 0
    while i < POOL_SIZE:
        p = rng.normal(0.0, _SUPPORT_RADIUS / 2.5, size=2)
        if np.linalg.norm(p) > _SUPPORT_RADIUS:
            continue
        pool[i] = p
        i += 1

    triplets = np.zeros((DESC_BITS, 3), np.int64)
    seen = set()
    i = 0
    while i < DESC_BITS:
        a, p1, p2 = rng.integers(0, POOL_SIZE, 3)
        if len({a, p1, p2}) < 3:
            continue
        if np.linalg.norm(pool[p1] - pool[p2]) < _MIN_SEP:
            continue
        key = (a, min(p1, p2), max(p1, p2))
        if key in seen:
            continue
        seen.add(key)
        triplets[i] = (a, p1, p2)
        i += 1
    return pool, triplets.astype(np.int32)


_POOL, _TRIPLETS = _make_tables()


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device):
    """The pool (float32) and triplets (int64) on `device`: one
    host-to-device copy per device, not one per frame."""
    return (torch.from_numpy(_POOL).to(device),
            torch.from_numpy(_TRIPLETS).to(device).to(torch.int64))


def describe_from_patches(
    patches: torch.Tensor,     # (K, PH, PW) box-smoothed per-keypoint windows
    kp_x: torch.Tensor,        # (K,) level-local x
    kp_y: torch.Tensor,        # (K,) level-local y
    kp_angle: torch.Tensor,    # (K,) radians
    w_l: torch.Tensor,         # (K,) level width/height (float, clamping)
    h_l: torch.Tensor,
    col0: torch.Tensor,        # (K,) patch origin (level-local col / row)
    row0_local: torch.Tensor,
) -> torch.Tensor:
    """-> (K, 16) int32 packed 512-bit descriptors."""
    dev = patches.device
    pool, tri = _tables_on(dev)
    ca, sa = torch.cos(kp_angle)[:, None], torch.sin(kp_angle)[:, None]
    ox, oy = pool[None, :, 0], pool[None, :, 1]
    rx = ca * ox - sa * oy                                  # (K, P)
    ry = sa * ox + ca * oy
    gx = torch.minimum(torch.clamp(kp_x[:, None] + rx, min=0.0), (w_l - 1.0)[:, None])
    gy = torch.minimum(torch.clamp(kp_y[:, None] + ry, min=0.0), (h_l - 1.0)[:, None])
    vals = patch_ops.sample_nearest(
        patches, gx - col0.to(torch.float32)[:, None],
        gy - row0_local.to(torch.float32)[:, None])         # (K, P)
    va, v1, v2 = vals[:, tri[:, 0]], vals[:, tri[:, 1]], vals[:, tri[:, 2]]
    return pack_bits((va - v1) ** 2 > (va - v2) ** 2)
