"""The port's kernels: how each is named in a device trace, and the least
time an NVIDIA H100 could take for the launches of one frame step, from
the step's shapes and the configuration's detector backend.

A kernel's bound is the larger of its bytes over the HBM rate (each input
byte read once, each output byte written once) and its operations over
the peak rate of their type. The counts are those of PERF.md's kernel
table, taken over every row a launch is handed: a row that the inputs
mask out still counts, so a bound is never below the work the kernel
could skip. They do not depend on how the program splits the step into
launches.

Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

from portbench import common

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
PATCH_ROWS, PATCH_COLS = 64, 256      # B5's window


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def k2nn(Q: int, T: int) -> float:
    """B1: queries, bank rows and the (idx, best, second) out; the 2-NN as
    the +-1 int8 product of 512 bits, 2 Q T 512 operations."""
    return bound_s(Q * 65 + T * 68 + 12 * Q, 2.0 * Q * T * 512, INT8_OPS)


def p3p(samples: int) -> float:
    """B2: 72 bytes in and four 13-float solutions out a sample, ~1500
    flops a sample."""
    return bound_s(samples * 72 + samples * 4 * 52, samples * 1500.0, FP32_FLOPS)


def ransac_rank(problems: int, models: int, points: int) -> float:
    """B3: (Hm, 12) models and their rank, (7, M) point rows a problem;
    ~44 flops a (model, point) pair."""
    return bound_s(problems * (models * 13 + 7 * points) * 4,
                   problems * models * points * 44.0, FP32_FLOPS)


def fast_nms(pixels: int) -> float:
    """B4: the raster in, score and NMS maps out; ~180 operations a pixel."""
    return bound_s(pixels * 12, pixels * 180.0, FP32_FLOPS)


def extract(raster_px: int, keypoints: int) -> float:
    """B5: the raster and the origins in, a (64, 256) float32 window a
    keypoint out; bytes only."""
    return bound_s(raster_px * 4 + keypoints * (PATCH_ROWS * PATCH_COLS * 4 + 8), 0.0,
                   FP32_FLOPS)


def stacked_raster(height: int, width: int, levels: int, factor: float) -> Tuple[int, int]:
    """(rows, columns) of one frame's pyramid stacked into one raster: each
    level's rows padded to a multiple of 8 (at least 64), the columns to a
    multiple of 128 (at least 256)."""
    rows = 0
    for l in range(levels):
        h = max(int(round(height / factor ** l)), 8)
        rows += ((max(h, PATCH_ROWS) + 7) // 8) * 8
    return rows, ((max(width, PATCH_COLS) + 127) // 128) * 128


def trip_step(frames: int, height: int, width: int, levels: int, factor: float,
              keypoints: int, slots: int, hypotheses: int) -> Dict[str, float]:
    """Each TRIP-path kernel's bound, seconds, over one step of `frames`
    frames: the batched frontend (B4, B5), one 2-NN of every keypoint
    against the map (B1), P3P on every draw (B2) and the rank of every
    hypothesis (four a draw) against every keypoint row (B3)."""
    rows, cols = stacked_raster(height, width, levels, factor)
    px = frames * rows * cols
    return {"k2nn": k2nn(frames * keypoints, slots),
            "p3p": p3p(frames * hypotheses),
            "ransac_rank": ransac_rank(frames, 4 * hypotheses, keypoints),
            "fast_nms": fast_nms(px),
            "extract": extract(px, frames * keypoints)}


def fed_octave(frames: int, height: int, width: int, sublevels: int) -> float:
    """B10: one octave of `frames` images of height x width; the images and
    their k^2 in, each sublevel's L, Lx, Ly and response out; bytes only."""
    return bound_s(frames * (height * width * 4 * (1 + 4 * sublevels) + 4), 0.0, FP32_FLOPS)


def sample_raster(keypoints: int, channels: int, samples: int) -> float:
    """B11: one call of `samples` float32 samples a keypoint in each of
    `channels` channels out, two float32 coordinates a sample and the two
    window origins a keypoint in; bytes only. The bf16 source elements
    that the samples read are left out: which they are, and how many
    distinct, depends on the frame."""
    return bound_s(keypoints * (samples * (channels + 2) * 4 + 8), 0.0, FP32_FLOPS)


def akaze_step(frames: int, height: int, width: int, octaves: int, sublevels: int,
               keypoints: int, slots: int, hypotheses: int,
               cell_samples: int) -> Dict[str, float]:
    """Each AKAZE-path kernel's bound, seconds, over one step of `frames`
    frames: the scale space (B10, an octave a launch at 2^-o resolution),
    the orientation's and the descriptor's samples (B11: 2 channels at 49
    points, 3 at 29 cells of cell_samples^2 points), then as trip_step:
    B1, B2 and B3 at M = keypoints."""
    fed, h, w = 0.0, height, width
    for _ in range(octaves):
        fed += fed_octave(frames, h, w, sublevels)
        h, w = (h + 1) // 2, (w + 1) // 2
    K = frames * keypoints
    return {"k2nn": k2nn(K, slots),
            "p3p": p3p(frames * hypotheses),
            "ransac_rank": ransac_rank(frames, 4 * hypotheses, keypoints),
            "fed_octave": fed,
            "sample_raster": sample_raster(K, 2, 49) + sample_raster(K, 3, 29 * cell_samples ** 2)}


def step_bounds(cfg: dict, frames: int, hypotheses: int) -> Dict[str, float]:
    """The bounds of one step of `frames` frames of the configuration (its
    JSON file), by its detector backend."""
    det = cfg["detector"]
    if det.get("backend", "trip") == "akaze":
        p = common.akaze_params(det)
        return akaze_step(frames, det["height"], det["width"], p.octaves, p.sublevels,
                          det["max_keypoints"], cfg["max_landmarks"], hypotheses,
                          p.cell_samples)
    return trip_step(frames, det["height"], det["width"], det["num_levels"], det["scale_factor"],
                     det["max_keypoints"], cfg["max_landmarks"], hypotheses)


KERNELS = {
    "k2nn": ("B1", r"k2nn_mma_kernel"),
    "p3p": ("B2", r"(?<![A-Za-z0-9_])p3p_kernel"),
    "ransac_rank": ("B3", r"(?<![A-Za-z0-9_])rank_kernel"),
    "fast_nms": ("B4", r"fast_nms_tile_kernel"),
    "extract": ("B5", r"(?<![A-Za-z0-9_])extract_kernel"),
    "fed_octave": ("B10", r"fed_octave_kernel"),
    "sample_raster": ("B11", r"sample_raster_kernel"),
}


def kernel_of(trace_name: str):
    """The key of KERNELS whose kernel a trace event names, or None."""
    for key, (_, pattern) in KERNELS.items():
        if re.search(pattern, trace_name):
            return key
    return None
