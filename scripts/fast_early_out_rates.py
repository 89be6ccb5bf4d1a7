"""How many pixels B4's early-out leaves to the FAST cascade, on the CPU.

    python scripts/fast_early_out_rates.py

A property of the data, not of a device: on the bench frame's stacked
8-level pyramid raster (make_scene seed 1 at identity, 752x480, 1.2x, the
D=1 raster of chip_smoke.py phase 4b) at fast_threshold 12, the share of
pixels that
  - pass the compass test of csrc/fast_nms.cu on either side (two
    cyclically adjacent compass points k = 0, 4, 8, 12 beyond the
    threshold), and of those, the share that pass on both sides;
  - pass the full 16-bit run-of-9 test on either side;
  - score above the threshold.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from coloc_tpu_torch.io import synthetic  # noqa: E402
from coloc_tpu_torch.ops import fast, patches, pyramid  # noqa: E402

H, W, LEVELS, THRESHOLD = 480, 752, 8, 12.0


def compass_pass(dev: torch.Tensor) -> torch.Tensor:
    bits = dev[[0, 4, 8, 12]] > THRESHOLD
    return (bits & bits.roll(-1, 0)).any(0)


def run9_pass(dev: torch.Tensor) -> torch.Tensor:
    run = dev > THRESHOLD
    for s in (1, 2, 4):
        run = run & run.roll(-s, 0)
    return (run & (dev > THRESHOLD).roll(-8, 0)).any(0)


def main() -> None:
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    scene = synthetic.make_scene(H, W, K, seed=1)
    frame = synthetic.render(scene, np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32)).astype(np.float32)
    levels = pyramid.build_pyramid_batch(torch.from_numpy(frame)[None], LEVELS, 1.2)
    raster = patches.stack_levels_batch(levels).stacked
    dev = fast._ring_stack(raster) - raster[None]
    bright, dark = compass_pass(dev), compass_pass(-dev)
    either = bright | dark
    n = raster.numel()
    raw = fast.fast_score_map(raster, THRESHOLD)
    print(f"raster {tuple(raster.shape)}, threshold {THRESHOLD}")
    print(f"compass test passes {float(either.sum()) / n:.4f} of pixels; "
          f"{float((bright & dark).sum()) / float(either.sum()):.4f} of those on both sides")
    print(f"16-bit run-of-9 test passes "
          f"{float((run9_pass(dev) | run9_pass(-dev)).sum()) / n:.4f} of pixels")
    print(f"score > threshold at {float((raw > 0).sum()) / n:.4f} of pixels")


if __name__ == "__main__":
    main()
