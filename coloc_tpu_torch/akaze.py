"""AKAZE-MLDB frontend, the reference's CPU detector backend (counterpart of
coloc_tpu.akaze).

Reference parity: CPUDetector.hpp + AKAZE.hpp, OpenMVG AKAZE with the MLDB
describer (NORMAL preset): nonlinear diffusion scale space (B10, one
launch an octave), sigma^4-normalised Hessian-determinant detection with
subpixel refinement, the dominant-gradient orientation and the 486-bit
MLDB descriptor packed into the shared 512-bit bank; both emit `Features`,
so matching, RANSAC and mapping are those of the TRIP path.

Stages, as in coloc_tpu:
  1. the scale space (ops/diffusion.build_scale_space_batch);
  2. per level a response threshold and 3x3 NMS, then cross-scale
     suppression in raster space: level li+1's peaks are brought to li's
     grid, max-dilated by the sigma radius and compared, so a peak dies
     where a strictly stronger adjacent-level peak lies within the radius,
     and ties kill the coarser level;
  3. one exact top-k per image over the stacked level rasters, subpixel
     offsets on the stacked response;
  4. L, Lx, Ly stacked into one bf16 raster with 64-lane-shifted copies;
     per keypoint a 64x128 window (48 rows, Lx/Ly only, for orientation)
     of the plain or the shifted copy, chosen so the sample span fits, and
     nearest samples through B11 (ops/patches.sample_raster_flat);
  5. orientation and the MLDB descriptor (ops/mldb); coordinates back to
     base resolution by 2^octave.

The window selection and the bf16 source are semantics here, not layout:
each sample coordinate is clipped to its window before it is rounded, so a
different window reads a different pixel wherever a clip bites.

coloc_tpu selects with lax.top_k or approx_max_k; both give the exact
order on the CPU, which ops/fast.topk_desc reproduces (ROADMAP C2). The
stacked NMS raster is >= 0, as topk_desc needs. Select with
DetectorOptions(backend="akaze").
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from coloc_tpu_torch.config import DetectorOptions
from coloc_tpu_torch.ops import diffusion, mldb
from coloc_tpu_torch.ops import fast as fast_ops
from coloc_tpu_torch.ops import patches as patch_ops
from coloc_tpu_torch.profiling import span
from coloc_tpu_torch.types import Features

_DETECT_BORDER = 10
_RESPONSE_THRESHOLD = 1e-4   # AKAZE's default, on the [0, 1] image

Mark = Optional[Callable[[str], None]]


def _no_mark(stage: str) -> None:
    pass


@functools.lru_cache(maxsize=16)
def _akaze_mask(row_base, heights, widths, wp, rows, border, batch=1):
    """Static keep mask for the stacked NMS raster: zero outside each
    level's detection border and on padding rows. The >= border margins
    also guard against NMS and suppression leaking across levels and, in
    the batched raster, across images."""
    m = np.zeros((rows, wp), np.float32)
    for rb, h, w in zip(row_base, heights, widths):
        m[rb + border:rb + h - border, border:w - border] = 1.0
    return np.tile(m, (batch, 1)) if batch > 1 else m


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _akaze_mask_on(device: torch.device, *args) -> torch.Tensor:
    # one host-to-device copy per geometry and device, not one per frame
    return torch.from_numpy(_akaze_mask(*args)).to(device)


class _LevelTables(NamedTuple):
    """Per-level constants of the stacked rasters, on one device."""

    row_base: torch.Tensor   # (L,) int64 first stacked row
    sigma: torch.Tensor      # (L,) float32 sigma in level-local pixels
    widths: torch.Tensor     # (L,) int32
    heights: torch.Tensor    # (L,) int32
    up: torch.Tensor         # (L,) float32 2^octave, level to base pixels


# unbounded: a captured CUDA graph reads these tensors, and an evicted
# entry's memory would be reused under it
@functools.lru_cache(maxsize=None)
def _level_tables(device: torch.device, row_base, heights, widths,
                  scales) -> _LevelTables:
    """The levels' tables (row_base, heights, widths: tuples of ints;
    scales: (sigma, octave) a level) made once per geometry and device,
    not copied to the device every frame, which a captured step may not
    do. Read only: every caller shares them."""
    def on(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device)

    return _LevelTables(
        row_base=on(row_base, torch.int64),
        sigma=on([s / (2.0 ** o) for s, o in scales], torch.float32),
        widths=on(widths, torch.int32), heights=on(heights, torch.int32),
        up=on([2.0 ** o for _, o in scales], torch.float32))


def _num_octaves(opts: DetectorOptions) -> int:
    return min(opts.num_levels // 2, 4) if opts.num_levels >= 4 else 2


def _check_knobs(opts: DetectorOptions) -> None:
    # the orientation sampler's 48-row window covers a 6 sigma disc only
    # while the largest level-local sigma stays <= 17/6 px; sigma_local max
    # = sigma0 * 2^((n-1)/n) crosses that at n = 6 (2.85 * 6 = 17.1 px).
    # cell_samples must give a non-empty table.
    num_sub = opts.akaze_sublevels
    if not 1 <= num_sub <= 5:
        raise ValueError(
            f"akaze_sublevels must be in [1, 5] (got {num_sub}); >= 6 "
            "violates the orientation window margin (see sampler2 note)"
        )
    if not 1 <= opts.akaze_cell_samples <= 8:
        raise ValueError(
            f"akaze_cell_samples must be in [1, 8] "
            f"(got {opts.akaze_cell_samples})"
        )


def _maxpool(x: torch.Tensor, rad: int) -> torch.Tensor:
    """(2 rad + 1)^2 max-dilation of (B, h, w), separable. coloc_tpu's
    reduce_window pads with its init 0.0, F.max_pool2d with -inf: the same
    here only because NMS values are >= 0 and every window holds a pixel."""
    if rad <= 0:
        return x
    w = 2 * rad + 1
    x = F.max_pool2d(x, (w, 1), stride=1, padding=(rad, 0))
    return F.max_pool2d(x, (1, w), stride=1, padding=(0, rad))


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """2x nearest upsample of (B, hb, wb), cropped to (h, w)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :h, :w]


def _cross_scale_suppress(levels, nms):
    """Suppress the weaker of each close pair of adjacent-level peaks, in
    level order; ties suppress the coarser level. The square window
    over-reaches the Euclidean radius by sqrt(2) in its corners (+1 px
    upsample slack across octaves), as in coloc_tpu."""
    nms = list(nms)
    for li in range(len(levels) - 1):
        a, b = nms[li], nms[li + 1]
        oa, ob = levels[li].octave, levels[li + 1].octave
        r_base = max(levels[li].sigma, levels[li + 1].sigma)   # base px
        ra_px = math.ceil(r_base / (2.0 ** oa)) + (1 if ob > oa else 0)
        ha, wa = a.shape[1:]
        b_at_a = _up2(b, ha, wa) if ob > oa else b
        sup_a = _maxpool(b_at_a, ra_px) > a
        dil_a = _maxpool(a, ra_px)
        if ob > oa:   # 2x2 max-downsample back to b's grid, zero padded
            hb, wb = b.shape[1:]
            dil_a = F.max_pool2d(F.pad(dil_a, (0, 2 * wb - wa, 0, 2 * hb - ha)),
                                 2, stride=2)
        sup_b = dil_a >= b
        nms[li] = torch.where(sup_a, 0.0, a)
        nms[li + 1] = torch.where(sup_b, 0.0, b)
    return nms


def detect_and_describe_akaze(image: torch.Tensor, opts: DetectorOptions) -> Features:
    """image (H, W) grayscale -> Features (fixed capacity, packed MLDB)."""
    feats = detect_and_describe_akaze_batch(image[None], opts)
    return Features(*(a[0] for a in feats))


def detect_and_describe_akaze_batch(images: torch.Tensor, opts: DetectorOptions,
                                    mark: Mark = None) -> Features:
    """(B, H, W) grayscale -> Features with a leading batch axis, one launch
    of each kernel a stage for the whole batch. `mark(stage)`, when given,
    is called after each stage (chip_smoke.py times stages with it).
    Spans (profiling.span), one after another: `coloc.akaze.scale_space`
    (B10), `.detect` (threshold, NMS, cross-scale suppression, top-k,
    subpixel), `.sample` (the stacked bf16 source, its shifted copies and
    the windows B11 reads) and `.describe` (orientation and MLDB, which
    launch B11). A captured graph's replay runs none of them."""
    mark = mark or _no_mark
    _check_knobs(opts)
    B = images.shape[0]
    k = opts.max_keypoints
    dev = images.device
    num_sub = opts.akaze_sublevels

    with span("coloc.akaze.scale_space"):
        levels = diffusion.build_scale_space_batch(
            images, num_octaves=_num_octaves(opts), num_sublevels=num_sub,
            tau_max=opts.akaze_fed_tau_max)
        mark("scale_space")

    with span("coloc.akaze.detect"):
        # detection: per-level threshold + NMS, then cross-scale suppression
        nms = [fast_ops.nms3(torch.where(ev.response > _RESPONSE_THRESHOLD,
                                         ev.response, 0.0)) for ev in levels]
        nms = _cross_scale_suppress(levels, nms)
        mark("detect")

        # one exact top-k per image over the stacked level rasters
        sp_nms = patch_ops.stack_levels_batch(nms)
        sp_resp = patch_ops.stack_levels_batch([ev.response for ev in levels])
        wp, R = sp_nms.wp, sp_nms.img_rows
        geom = (tuple(int(r) for r in sp_nms.row_base), tuple(int(h) for h in sp_nms.heights),
                tuple(int(w) for w in sp_nms.widths))
        mask = _akaze_mask_on(dev, *geom, wp, R, _DETECT_BORDER, B)
        tables = _level_tables(dev, *geom, tuple((ev.sigma, ev.octave) for ev in levels))
        top_s, top_i = fast_ops.topk_desc((sp_nms.stacked * mask).reshape(B, R * wp), k)
        boff = torch.arange(B, device=dev).repeat_interleave(k) * R      # (B*k,)
        top_s = top_s.reshape(B * k)
        top_i = top_i.reshape(B * k)
        valid = top_s > 0
        row = top_i // wp                  # within-image stacked row
        col = top_i % wp
        rb = tables.row_base
        kp_l = (row[:, None] >= rb[None, 1:]).sum(dim=1)

        # subpixel offsets on the stacked raw response, added to LOCAL coords
        dx, dy = fast_ops.subpixel_offsets(sp_resp.stacked, col, row + boff)
        kp_x = col.to(torch.float32) + dx
        kp_y = (row - rb[kp_l]).to(torch.float32) + dy          # level-local y
        kp_sig = tables.sigma[kp_l]        # sigma in level-local pixels
        mark("topk")

    with span("coloc.akaze.sample"):
        # the bf16 sampling source: L, Lx, Ly and their 64-lane-shifted copies
        # (first 64 lanes dropped, zero tail), row-stacked
        sp_l = patch_ops.stack_levels_batch([ev.L for ev in levels])
        sp_lx = patch_ops.stack_levels_batch([ev.Lx for ev in levels])
        sp_ly = patch_ops.stack_levels_batch([ev.Ly for ev in levels])
        R_tot = sp_l.stacked.shape[0]      # = B * R rows a channel

        def shift64(x):
            return F.pad(x[:, 64:], (0, 64))

        src6 = torch.cat([sp_l.stacked, sp_lx.stacked, sp_ly.stacked,
                          shift64(sp_l.stacked), shift64(sp_lx.stacked),
                          shift64(sp_ly.stacked)], dim=0).to(torch.bfloat16)
        # sp_l's levels have sp_nms's shapes, so the same tables
        w_l = tables.widths[kp_l].to(torch.float32)
        h_l = tables.heights[kp_l].to(torch.float32)
        row0, _ = patch_ops.patch_origins(sp_l, kp_x, kp_y, kp_l)
        row0_local = row0 - rb[kp_l].to(torch.int32)
        # narrow-window column selection: leftmost needed column a; the plain
        # copy iff the 52-px span fits its 128-column tile, else the shifted one
        xi = torch.round(kp_x).to(torch.int32)
        a = torch.clamp(xi - 26, min=0)
        shift = (a % 128) > 75
        c0 = torch.where(shift, ((a - 64) // 128) * 128, (a // 128) * 128).to(torch.int32)
        col0_eff = c0 + torch.where(shift, 64, 0).to(torch.int32)   # window col 0, level coords
        row0_dma = (row0 + boff.to(torch.int32)
                    + torch.where(shift, 3 * R_tot, 0).to(torch.int32))
        # orientation window: 48 rows of Lx / Ly (base offset + R_tot skips L),
        # 8-aligned inside the 64-row patch so it covers [y - 17, y + 17]
        yi_rel = torch.round(kp_y).to(torch.int32) - row0_local
        ro = torch.clamp(((yi_rel - 17) // 8) * 8, 0, 16).to(torch.int32)
        row0_ori = row0_dma + R_tot + ro
        mark("sampling")

    with span("coloc.akaze.describe"):
        def sampler2(lx, ly):
            return patch_ops.sample_raster_flat(src6, R_tot, row0_ori, c0, lx, ly,
                                                C=2, ph=48, pw=128)

        def sampler3(lx, ly):
            return patch_ops.sample_raster_flat(src6, R_tot, row0_dma, c0, lx, ly,
                                                C=3, pw=128)

        kp_angle = mldb.orientation(sampler2, kp_x, kp_y, kp_sig, w_l, h_l,
                                    col0_eff, row0_local + ro)
        mark("orientation")
        desc = mldb.describe_mldb(sampler3, kp_x, kp_y, kp_sig, kp_angle, w_l, h_l,
                                  col0_eff, row0_local,
                                  cell_samples=opts.akaze_cell_samples)
        mark("descriptor")

        # base-resolution coordinates
        up = tables.up[kp_l]
        xy = torch.stack([kp_x * up, kp_y * up], dim=-1)
        feats = Features(
            xy=torch.where(valid[:, None], xy, 0.0),
            score=torch.where(valid, top_s, 0.0),
            scale=torch.where(valid, kp_l, 0).to(torch.int32),
            angle=torch.where(valid, kp_angle, 0.0),
            desc=desc,
            valid=valid,
        )
    return Features(*(t.reshape((B, k) + t.shape[1:]) for t in feats))
