"""Per-keypoint patch extraction + nearest sampling (counterpart of
coloc_tpu.ops.patches).

Pyramid levels are stacked vertically into one (sum H_l, WP) raster, and
a batch of images stacks its rasters the same way, so one buffer serves
every level of every image. Each keypoint gets one aligned (PH, PW)
window of the smoothed stack (B5), and orientation and descriptor sample
that window at nearest pixels.

  stack_levels(_batch) — the stacked raster and its static level tables
  patch_origins        — 8-row / 128-column aligned window origins
  extract_patches      — B5: the CUDA kernel csrc/extract.cu on a CUDA
                         tensor, extract_patches_plain on CPU
  sample_nearest       — nearest samples rounded to bf16 (a gather)
  sample_raster_flat   — B11, the AKAZE path: nearest samples of C channel
                         windows of a bf16 row-stacked raster, the CUDA
                         kernel csrc/sample_raster.cu on a CUDA tensor,
                         sample_raster_plain on CPU; sample_raster over a
                         (C, R, WP) channel stack
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from coloc_tpu_torch.ops import _build, dispatch

PH = 64           # patch rows (8-aligned; covers +-26 around any row-in-8 kp)
PW = 256          # patch cols (128-aligned; covers +-26 around any lane kp)
_MARGIN = 26      # max sample offset from the keypoint the patch must cover


class StackedPyramid(NamedTuple):
    """Vertically stacked pyramid levels + static geometry tables.

    For a batch of B images `stacked` is (B * R, WP): image b's raster
    holds rows [b * R, (b + 1) * R). The tables describe ONE image, and
    `img_rows` is R."""

    stacked: torch.Tensor   # (B * R, WP) float32
    row_base: np.ndarray    # (L,) int32 first stacked row per level
    heights: np.ndarray     # (L,) int32
    widths: np.ndarray      # (L,) int32
    img_rows: int

    @property
    def wp(self) -> int:
        return self.stacked.shape[1]


def stack_levels_batch(levels: Sequence[torch.Tensor]) -> StackedPyramid:
    """Levels (B, H_l, W_l) -> one (B * R, WP) raster, zero padded. WP is
    max(W_0, PW) rounded up to 128 so every window fits; each level's
    height is padded to a multiple of 8 (at least PH)."""
    wmax = max(max(lvl.shape[2] for lvl in levels), PW)
    wp = ((wmax + 127) // 128) * 128
    rows, row_base, heights, widths = [], [], [], []
    off = 0
    for lvl in levels:
        _, h, w = lvl.shape
        hp = ((max(h, PH) + 7) // 8) * 8
        rows.append(F.pad(lvl, (0, wp - w, 0, hp - h)))
        row_base.append(off)
        heights.append(h)
        widths.append(w)
        off += hp
    stacked = torch.cat(rows, dim=1).reshape(-1, wp)
    return StackedPyramid(stacked, np.asarray(row_base, np.int32),
                          np.asarray(heights, np.int32),
                          np.asarray(widths, np.int32), off)


def stack_levels(levels: Sequence[torch.Tensor]) -> StackedPyramid:
    """Levels (H_l, W_l) of one image -> (R, WP) raster."""
    return stack_levels_batch([lvl[None] for lvl in levels])


def patch_origins(sp: StackedPyramid, kp_x: torch.Tensor, kp_y: torch.Tensor,
                  kp_level: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (row0 (K,), col0 (K,)) int32 aligned window origins in stacked
    coords of one image. Any sample at level-local (x + dx, y + dy) with
    |dx|, |dy| <= _MARGIN (after clamping to the level) falls inside
    [row0, row0 + PH) x [col0, col0 + PW)."""
    dev = kp_x.device
    rb = dispatch.constant(tuple(int(r) for r in sp.row_base), dev, torch.int32)
    hs = dispatch.constant(tuple(int(h) for h in sp.heights), dev, torch.int32)
    xi = torch.round(kp_x).to(torch.int32)
    yi = torch.round(kp_y).to(torch.int32)
    h_l = hs[kp_level]
    # 8-aligned row origin covering [y - 26.5, y + 26.5]: floor8(y - 27)
    r0_local = ((yi - 27) >> 3) << 3
    r0_max = torch.clamp(((h_l - PH + 7) >> 3) << 3, min=0)
    r0_local = torch.minimum(torch.clamp(r0_local, min=0), r0_max)
    row0 = rb[kp_level] + r0_local
    c0 = (torch.clamp(xi - _MARGIN, min=0) >> 7) << 7
    col0 = torch.clamp(c0, 0, sp.wp - PW)
    return row0.to(torch.int32), col0.to(torch.int32)


def _window_starts(src: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor):
    """Origins as the TPU kernel takes them (rounded down to 8 rows and 128
    columns), then clamped so the window lies inside the raster, as
    coloc_tpu's dynamic_slice fallback clamps them. On the frontend's path
    patch_origins makes both steps no-ops."""
    R, WP = src.shape
    r0 = torch.clamp(row0 & -8, 0, R - PH)
    c0 = torch.clamp(col0 & -128, 0, WP - PW)
    return r0, c0


def extract_patches_plain(src: torch.Tensor, row0: torch.Tensor,
                          col0: torch.Tensor) -> torch.Tensor:
    """Plain twin of csrc/extract.cu: (R, WP) + (K,) origins -> (K, PH, PW)."""
    r0, c0 = _window_starts(src, row0, col0)
    rows = r0.to(torch.int64)[:, None] + torch.arange(PH, device=src.device)
    cols = c0.to(torch.int64)[:, None] + torch.arange(PW, device=src.device)
    return src[rows[:, :, None], cols[:, None, :]]


def _extract_patches_cuda(src, row0, col0):
    dev = src.device
    R, WP = src.shape
    K = row0.shape[0]
    dispatch.check_operand(src, "src", torch.float32, (None, None), dev)
    dispatch.check_operand(row0, "row0", torch.int32, (K,), dev)
    dispatch.check_operand(col0, "col0", torch.int32, (K,), dev)
    if R < PH or WP < PW or WP % 128 or src.data_ptr() % 16:
        raise ValueError(f"src {tuple(src.shape)}: needs >= {PH} rows, a "
                         f"width >= {PW} that is a multiple of 128, and a "
                         f"16-byte aligned start")
    out = torch.empty((K, PH, PW), dtype=torch.float32, device=dev)
    _build.launch("coloc_extract", src.data_ptr(), row0.data_ptr(),
                  col0.data_ptr(), out.data_ptr(), R, WP, K, dev.index,
                  dispatch.stream_handle(dev))
    dispatch.count_launch("extract")
    return out


def extract_patches(src: torch.Tensor, row0: torch.Tensor,
                    col0: torch.Tensor) -> torch.Tensor:
    """(R, WP) source + (K,) aligned origins -> (K, PH, PW) patches."""
    if dispatch.use_kernel(src):
        return _extract_patches_cuda(src.contiguous(), row0.contiguous(),
                                     col0.contiguous())
    return extract_patches_plain(src, row0, col0)


def sample_nearest(patches: torch.Tensor, lx: torch.Tensor,
                   ly: torch.Tensor) -> torch.Tensor:
    """Nearest samples (K, PH, PW) x (K, NS) coords -> (K, NS) float32.

    Coordinates are clipped to the patch, then rounded half to even. The
    value is rounded to bf16, as coloc_tpu's one-hot bf16 contraction
    returns it (ROADMAP C1): an f32 gather would flip descriptor bits
    whose triplet contrast is near zero."""
    K, ph, pw = patches.shape
    ci = torch.round(torch.clamp(lx, 0, pw - 1)).to(torch.int64)
    ri = torch.round(torch.clamp(ly, 0, ph - 1)).to(torch.int64)
    vals = patches.reshape(K, ph * pw).gather(1, ri * pw + ci)
    return vals.to(torch.bfloat16).to(torch.float32)


def _sample_windows(src2: torch.Tensor, stride: int, row0: torch.Tensor,
                    col0: torch.Tensor, c: int, ph: int, pw: int):
    """Channel c's (ph, pw) window origins: row0 rounded down to 8 rows plus
    c * stride, col0 rounded down to 128 columns (the TPU kernel's tile
    grid), each clamped so the window lies inside the raster (coloc_tpu's
    dynamic_slice form). On the AKAZE path both steps are no-ops."""
    R, WP = src2.shape
    r0 = torch.clamp((row0 & -8) + c * stride, 0, R - ph)
    c0 = torch.clamp(col0 & -128, 0, WP - pw)
    return r0.to(torch.int64), c0.to(torch.int64)


def sample_raster_plain(src2: torch.Tensor, stride: int, row0: torch.Tensor,
                        col0: torch.Tensor, lx: torch.Tensor, ly: torch.Tensor,
                        C: int, ph: int, pw: int) -> torch.Tensor:
    """Plain twin of csrc/sample_raster.cu: per channel, the keypoint's
    window (_sample_windows), coordinates clipped to it and rounded half to
    even, one element read -> (C, K, NS) float32."""
    ci = torch.round(torch.clamp(lx, 0, pw - 1)).to(torch.int64)
    ri = torch.round(torch.clamp(ly, 0, ph - 1)).to(torch.int64)
    flat = src2.reshape(-1)
    WP = src2.shape[1]
    outs = []
    for c in range(C):
        r0, c0 = _sample_windows(src2, stride, row0, col0, c, ph, pw)
        at = (r0[:, None] + ri) * WP + c0[:, None] + ci
        outs.append(flat[at].to(torch.float32))
    return torch.stack(outs)


def _sample_raster_cuda(src2, stride, row0, col0, lx, ly, C, ph, pw):
    dev = src2.device
    R, WP = src2.shape
    K, NS = lx.shape
    dispatch.check_operand(src2, "src2", torch.bfloat16, (R, WP), dev)
    dispatch.check_operand(row0, "row0", torch.int32, (K,), dev)
    dispatch.check_operand(col0, "col0", torch.int32, (K,), dev)
    dispatch.check_operand(lx, "lx", torch.float32, (K, NS), dev)
    dispatch.check_operand(ly, "ly", torch.float32, (K, NS), dev)
    if R < ph or WP < pw:
        raise ValueError(f"src2 {tuple(src2.shape)} is smaller than a "
                         f"({ph}, {pw}) window")
    out = torch.empty((C, K, NS), dtype=torch.float32, device=dev)
    _build.launch("coloc_sample_raster", src2.data_ptr(), row0.data_ptr(),
                  col0.data_ptr(), lx.data_ptr(), ly.data_ptr(), out.data_ptr(),
                  R, WP, stride, K, NS, C, ph, pw, dev.index,
                  dispatch.stream_handle(dev))
    dispatch.count_launch("sample_raster")
    return out


def sample_raster_flat(src2: torch.Tensor, stride: int, row0: torch.Tensor,
                       col0: torch.Tensor, lx: torch.Tensor, ly: torch.Tensor,
                       C: int = 1, ph: int = PH, pw: int = PW) -> torch.Tensor:
    """Nearest samples of C channels at shared window-local coordinates
    -> (C, K, NS) float32.

    `src2` (n * stride, WP) holds row-stacked rasters; channel c of keypoint
    k reads the (ph, pw) window at (row0[k] + c * stride, col0[k]); lx, ly
    (K, NS) are window-local. `src2` is bfloat16: coloc_tpu casts its raster
    stack to bf16 before sampling, and its one-hot product returns each
    bf16 value exactly (one non-zero term of weight 1.0, float32
    accumulation), so reading the bf16 element and widening it gives
    coloc_tpu's value bit for bit."""
    if dispatch.use_kernel(src2):
        return _sample_raster_cuda(src2.contiguous(), stride, row0.contiguous(),
                                   col0.contiguous(), lx.contiguous(),
                                   ly.contiguous(), C, ph, pw)
    return sample_raster_plain(src2, stride, row0, col0, lx, ly, C, ph, pw)


def sample_raster(srcs: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor,
                  lx: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    """sample_raster_flat over a (C, R, WP) bf16 channel stack with
    full-width (PH, PW) windows."""
    C, R, WP = srcs.shape
    return sample_raster_flat(srcs.reshape(-1, WP), R, row0, col0, lx, ly,
                              C=C, pw=PW)
