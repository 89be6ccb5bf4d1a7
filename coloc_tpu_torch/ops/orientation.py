"""Keypoint orientation by weighted intensity centroid (counterpart of
coloc_tpu.ops.orientation).

Reference parity: FeatureAngle.h — a 7x7 intensity centroid with a
distance taper, then atan2. The window is sampled from the per-keypoint
patches of the smoothed stack (ops/patches.sample_nearest), as in
coloc_tpu.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from coloc_tpu_torch.ops import patches as patch_ops

_RADIUS = 3  # 7x7 window


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _moment_tables_on(radius: int, device: torch.device):
    # one host-to-device copy per radius and device, not one per frame
    return moment_tables(radius, device)


def moment_tables(radius: int = _RADIUS, device="cpu"):
    """(49,) window offsets and weighted moment vectors: weights
    w = radius+1-max(|dx|,|dy|), moments wx = dx*w, wy = dy*w."""
    r = radius
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    wgt = r + 1 - np.maximum(np.abs(xs), np.abs(ys))
    return tuple(torch.tensor(a.reshape(-1), dtype=torch.float32, device=device)
                 for a in (xs, ys, xs * wgt, ys * wgt))


def orientation_from_patches(
    patches: torch.Tensor,     # (K, PH, PW) per-keypoint windows
    kp_x: torch.Tensor,        # (K,) level-local float
    kp_y: torch.Tensor,
    w_l: torch.Tensor,         # (K,) level width/height (float, for clamping)
    h_l: torch.Tensor,
    col0: torch.Tensor,        # (K,) patch origins (level-local col,
    row0_local: torch.Tensor,  #  level-local row)
) -> torch.Tensor:
    """Intensity-centroid angle per keypoint -> (K,) radians."""
    offs_x, offs_y, wx, wy = _moment_tables_on(_RADIUS, patches.device)
    gx = torch.minimum(torch.clamp(torch.round(kp_x)[:, None] + offs_x, min=0.0),
                       (w_l - 1.0)[:, None])
    gy = torch.minimum(torch.clamp(torch.round(kp_y)[:, None] + offs_y, min=0.0),
                       (h_l - 1.0)[:, None])
    vals = patch_ops.sample_nearest(
        patches, gx - col0.to(torch.float32)[:, None],
        gy - row0_local.to(torch.float32)[:, None])          # (K, 49)
    return torch.atan2(vals @ wy, vals @ wx)
