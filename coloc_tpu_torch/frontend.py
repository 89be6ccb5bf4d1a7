"""Feature frontend: multi-scale detect + orient + describe (counterpart of
coloc_tpu.frontend, the TRIP backend).

Reference parity: GPUDetector.hpp detectAndDescribe — the KORAL pipeline
(pyramid -> FAST per level -> angle -> 512-bit binary descriptor). Stages,
as in coloc_tpu:

  1. pyramid + box pre-smooth (ops/pyramid.py);
  2. levels, and the images of a batch, stacked vertically into ONE raster
     (ops/patches.stack_levels_batch), so FAST + NMS is one launch of B4
     and the selection is one exact top-k per image;
  3. per-keypoint (64, 256) windows of the smoothed stack (B5); orientation
     and the steered TRIP-512 pool sample those windows.

Keypoint coords are rescaled to full resolution by scale_factor**level.
Output is a fixed-capacity Features bank (max_keypoints + validity mask).
coloc_tpu specialises B == 1 for TPU speed with identical results; the
port has one path for every B.

DetectorOptions(backend="akaze") selects the AKAZE-MLDB backend
(akaze.py, the reference's CPU detector) instead; any other name runs
TRIP, as in coloc_tpu.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from coloc_tpu_torch import akaze
from coloc_tpu_torch.config import DetectorOptions
from coloc_tpu_torch.ops import descriptor as desc_ops
from coloc_tpu_torch.ops import dispatch
from coloc_tpu_torch.ops import fast as fast_ops
from coloc_tpu_torch.ops import orientation as orient_ops
from coloc_tpu_torch.ops import patches as patch_ops
from coloc_tpu_torch.ops import pyramid as pyr_ops
from coloc_tpu_torch.types import Features

_MIN_BORDER = 8  # floor: the 7x7 orientation window must fit

Mark = Optional[Callable[[str], None]]


def _no_mark(stage: str) -> None:
    pass


def detect_and_describe(image: torch.Tensor, opts: DetectorOptions) -> Features:
    """image (H, W) uint8/float32 grayscale -> Features (fixed capacity)."""
    feats = detect_and_describe_batch(image[None], opts)
    return Features(*(a[0] for a in feats))


def detect_and_describe_batch(images: torch.Tensor,
                              opts: DetectorOptions) -> Features:
    """(B, H, W) -> Features with a leading batch axis."""
    if opts.backend == "akaze":
        return akaze.detect_and_describe_akaze_batch(images, opts)
    return _detect_and_describe_trip_batch(images, opts)


@functools.lru_cache(maxsize=32)
def _detection_mask(row_base, heights, widths, wp, total_rows,
                    border, scale_factor, batch=1) -> np.ndarray:
    """Static (batch * R, WP) keep mask: per-level borders (the keep-out
    border scaled per level, floored at _MIN_BORDER) double as the guard
    against cross-level and cross-image ring contamination in the stacked
    FAST pass."""
    mask = np.zeros((total_rows, wp), np.float32)
    for l, (rb, h, w) in enumerate(zip(row_base, heights, widths)):
        b = max(_MIN_BORDER, int(round(border / scale_factor ** l)))
        if h > 2 * b and w > 2 * b:
            mask[rb + b:rb + h - b, b:w - b] = 1.0
    return np.tile(mask, (batch, 1)) if batch > 1 else mask


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _detection_mask_on(device: torch.device, *args) -> torch.Tensor:
    # one host-to-device copy per geometry and device, not one per frame
    return torch.from_numpy(_detection_mask(*args)).to(device)


def _detect_and_describe_trip_batch(images: torch.Tensor, opts: DetectorOptions,
                                    mark: Mark = None) -> Features:
    """(B, H, W) -> Features with a leading batch axis. `mark(stage)`, when
    given, is called after each stage (chip_smoke.py times stages with it)."""
    mark = mark or _no_mark
    images = images.to(torch.float32)
    levels = pyr_ops.build_pyramid_batch(images, opts.num_levels,
                                         opts.scale_factor)
    smoothed = [pyr_ops.box_blur(lvl, opts.smoothing_radius) for lvl in levels]
    mark("pyramid")
    return _describe_from_levels(levels, smoothed, opts, mark)


def _describe_from_levels(levels: List[torch.Tensor],
                          smoothed: List[torch.Tensor], opts: DetectorOptions,
                          mark: Mark = None) -> Features:
    """The frontend after its pyramid stage: raw and smoothed levels, each
    (B, H_l, W_l) -> Features (B, k, ...)."""
    mark = mark or _no_mark
    B = levels[0].shape[0]
    k = opts.max_keypoints
    dev = levels[0].device
    sp_raw = patch_ops.stack_levels_batch(levels)
    sp_sm = patch_ops.stack_levels_batch(smoothed)
    wp, R = sp_raw.wp, sp_raw.img_rows
    # the level tables, made once per geometry and device
    rb = dispatch.constant(tuple(int(r) for r in sp_raw.row_base), dev, torch.int64)
    heights = dispatch.constant(tuple(int(h) for h in sp_raw.heights), dev, torch.int32)
    widths = dispatch.constant(tuple(int(w) for w in sp_raw.widths), dev, torch.int32)

    # detection: FAST + NMS over the batched raster, exact top-k per image
    raw, nms = fast_ops.fast_nms(sp_raw.stacked, opts.fast_threshold)
    mark("fast_nms")
    mask = _detection_mask_on(
        dev, tuple(int(r) for r in sp_raw.row_base),
        tuple(int(h) for h in sp_raw.heights),
        tuple(int(w) for w in sp_raw.widths),
        wp, R, opts.border, opts.scale_factor, B)
    top_s, top_i = fast_ops.topk_desc((nms * mask).reshape(B, R * wp), k)
    mark("topk")
    boff = torch.arange(B, device=dev).repeat_interleave(k) * R   # (B*k,)
    top_s = top_s.reshape(B * k)
    top_i = top_i.reshape(B * k)
    valid = top_s > 0
    row_img = top_i // wp            # within-image stacked row
    col = top_i % wp
    kp_l = (row_img[:, None] >= rb[None, 1:]).sum(dim=1)

    # subpixel offsets on the raster-global raw map, added to LOCAL coords
    dx, dy = fast_ops.subpixel_offsets(raw, col, row_img + boff)
    kp_x = col.to(torch.float32) + dx
    kp_y = (row_img - rb[kp_l]).to(torch.float32) + dy
    mark("subpixel")

    w_l = widths[kp_l].to(torch.float32)
    h_l = heights[kp_l].to(torch.float32)
    row0, col0 = patch_ops.patch_origins(sp_sm, kp_x, kp_y, kp_l)
    P = patch_ops.extract_patches(sp_sm.stacked, row0 + boff.to(torch.int32),
                                  col0)
    row0_local = row0 - rb[kp_l].to(torch.int32)
    mark("extract")
    kp_angle = orient_ops.orientation_from_patches(P, kp_x, kp_y, w_l, h_l,
                                                   col0, row0_local)
    mark("orientation")
    desc = desc_ops.describe_from_patches(P, kp_x, kp_y, kp_angle, w_l, h_l,
                                          col0, row0_local)
    mark("descriptor")

    # full-resolution coordinates (GPUDetector.hpp:172-182 parity)
    scale = torch.pow(dispatch.constant(float(opts.scale_factor), dev),
                      kp_l.to(torch.float32))
    xy = torch.stack([kp_x * scale, kp_y * scale], dim=-1)
    feats = Features(
        xy=torch.where(valid[:, None], xy, 0.0),
        score=torch.where(valid, top_s, 0.0),
        scale=torch.where(valid, kp_l, 0).to(torch.int32),
        angle=torch.where(valid, kp_angle, 0.0),
        desc=desc,
        valid=valid,
    )
    return Features(*(a.reshape((B, k) + a.shape[1:]) for a in feats))
