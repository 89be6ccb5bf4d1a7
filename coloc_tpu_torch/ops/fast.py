"""FAST-9 corner detection (counterpart of coloc_tpu.ops.fast).

Reference parity: KFAST — per pixel, the score is the max over the 16
9-pixel arcs of the Bresenham ring of the minimum absolute centre
deviation in the arc, bright or dark, kept where it exceeds the threshold;
then a 3x3 non-max suppression with a raster-order tie-break.

  fast_score_map + nms3 — the plain twin of B4
  fast_nms              — B4: the CUDA kernel csrc/fast_nms.cu on a CUDA
                          tensor, the plain twin on CPU
  topk_keypoints        — exact top-k, ties to the lower flat index
  subpixel_offsets      — parabolic 3x3 refinement on the raw score map
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from coloc_tpu_torch.ops import _build, dispatch

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_BORDER = 3   # the raster border fast_score_map zeroes (ring radius)


def _ring_stack(image: torch.Tensor) -> torch.Tensor:
    """(16, H, W): ring pixel k at each centre (edges replicate-padded)."""
    h, w = image.shape
    ys = torch.arange(-3, h + 3, device=image.device).clamp_(0, h - 1)
    xs = torch.arange(-3, w + 3, device=image.device).clamp_(0, w - 1)
    padded = image[ys[:, None], xs[None, :]]
    return torch.stack([padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in RING_OFFSETS])


def _arc_min9(vals: torch.Tensor) -> torch.Tensor:
    """(16, H, W) -> (16, H, W): min over the 9-arc starting at k."""
    def rot(a, s):
        return torch.roll(a, -s, dims=0)

    m2 = torch.minimum(vals, rot(vals, 1))
    m4 = torch.minimum(m2, rot(m2, 2))
    m8 = torch.minimum(m4, rot(m4, 4))
    return torch.minimum(m8, rot(vals, 8))


def fast_score_map(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9 score of an (H, W) raster, 0 where not a corner and
    on the 3-px raster border. The arc minimums double as the
    consecutive-9 test, and the max over arcs is the best arc's score."""
    dev = _ring_stack(image) - image[None]
    score = torch.maximum(_arc_min9(dev).amax(dim=0),
                          _arc_min9(-dev).amax(dim=0))
    score = torch.where(score > threshold, score, 0.0)
    h, w = image.shape
    yy = torch.arange(h, device=image.device)[:, None]
    xx = torch.arange(w, device=image.device)[None, :]
    inb = ((yy >= _BORDER) & (yy < h - _BORDER)
           & (xx >= _BORDER) & (xx < w - _BORDER))
    return torch.where(inb, score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression of (..., h, w) rasters, each zero outside;
    a pixel survives only if no earlier (raster-order) neighbour has an
    equal score. Leading dimensions are a batch (jax.vmap(nms3))."""
    h, w = score.shape[-2:]
    p = F.pad(score, (1, 1, 1, 1))

    def nb(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    neighborhood_max = torch.stack(
        [nb(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).amax(dim=0)
    earlier = torch.stack(
        [nb(dy, dx) for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1))]
    ).amax(dim=0)
    keep = (score >= neighborhood_max) & ~(earlier >= score)
    return torch.where(keep, score, 0.0)


def fast_nms_plain(image: torch.Tensor, threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of csrc/fast_nms.cu: (raw score map, NMS'd map)."""
    raw = fast_score_map(image, threshold)
    return raw, nms3(raw)


def _fast_nms_cuda(image, threshold):
    dev = image.device
    h, w = image.shape
    dispatch.check_operand(image, "image", torch.float32, (h, w), dev)
    raw = torch.empty_like(image)
    nms = torch.empty_like(image)
    _build.launch("coloc_fast_nms", image.data_ptr(), raw.data_ptr(),
                  nms.data_ptr(), h, w, float(threshold), dev.index,
                  dispatch.stream_handle(dev))
    dispatch.count_launch("fast_nms")
    return raw, nms


def fast_nms(image: torch.Tensor, threshold: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FAST-9 + 3x3 NMS of an (H, W) float32 raster -> (raw, nms). The raw
    map feeds subpixel refinement, the NMS'd map feeds top-k."""
    if dispatch.use_kernel(image):
        return _fast_nms_cuda(image.contiguous(), threshold)
    return fast_nms_plain(image, threshold)


def topk_desc(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last dim of scores >= 0, ordered by (score
    descending, index ascending): jax.lax.top_k's order, which coloc_tpu's
    approx_max_k also gives on the CPU (ROADMAP C2). torch.topk on the
    floats promises no order among ties, so it runs on unique int64 keys
    (float bits << 32 | (2^31 - 1 - index)); the bits of a float >= 0
    order like the float. -> (values, int64 indices)."""
    n = scores.shape[-1]
    if n >= 2 ** 31:
        raise ValueError(f"top-k over {n} entries: indices must fit in 31 bits")
    bits = (scores + 0.0).view(torch.int32).to(torch.int64)   # -0.0 -> +0.0
    idx = torch.arange(n, dtype=torch.int64, device=scores.device)
    key = (bits << 32) | (2 ** 31 - 1 - idx)
    top = torch.topk(key, k, dim=-1, sorted=True).values
    top_i = (2 ** 31 - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, top_i), top_i


def topk_keypoints(score: torch.Tensor, k: int, border: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Top-k peaks of an (H, W) score map -> (x, y, score, valid), each (k,).
    Always exact (coloc_tpu's exact=True)."""
    h, w = score.shape
    if border > 0:
        yy = torch.arange(h, device=score.device)[:, None]
        xx = torch.arange(w, device=score.device)[None, :]
        inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
        score = torch.where(inb, score, 0.0)
    vals, idx = topk_desc(score.reshape(-1), k)
    y = (idx // w).to(torch.float32)
    x = (idx % w).to(torch.float32)
    return x, y, vals, vals > 0


def subpixel_offsets(score: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parabolic 3x3 subpixel offsets (dx, dy) on the (pre-NMS) score map:
    d = 0.5 (s[-1] - s[+1]) / (s[-1] - 2 s[0] + s[+1]), clamped to +-0.5.
    Offsets, so callers on stacked rasters add them to image-local
    coordinates (bit-identical at every batch position)."""
    h, w = score.shape
    flat = score.reshape(-1)
    xi = torch.clamp(x.to(torch.int64), 1, w - 2)
    yi = torch.clamp(y.to(torch.int64), 1, h - 2)
    c = yi * w + xi

    def offset(minus, center, plus):
        denom = minus - 2.0 * center + plus
        denom = torch.where(denom.abs() < 1e-6, 1e-6, denom)
        return torch.clamp(0.5 * (minus - plus) / denom, -0.5, 0.5)

    s0 = flat[c]
    return offset(flat[c - 1], s0, flat[c + 1]), offset(flat[c - w], s0, flat[c + w])


def subpixel_refine(score: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refined absolute peak positions (see subpixel_offsets)."""
    dx, dy = subpixel_offsets(score, x, y)
    return x + dx, y + dy


def detect(image: torch.Tensor, threshold: float, k: int, border: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-level FAST: score + NMS -> top-k -> subpixel refine."""
    raw, nms = fast_nms(image, threshold)
    x, y, s, v = topk_keypoints(nms, k, border)
    x, y = subpixel_refine(raw, x, y)
    return x, y, s, v
