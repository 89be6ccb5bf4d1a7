"""coloc_tpu_torch — PyTorch/CUDA port of coloc_tpu for NVIDIA Hopper.

The JAX package `coloc_tpu` is the reference; this package mirrors its module
names and layout so each counterpart is found by name. It imports torch and
numpy only, never jax or coloc_tpu.

Idiom: plain functions on tensors, NamedTuples of tensors for the data model
(fixed capacity + validity masks, as in coloc_tpu.types), an explicit
`device` where a function creates tensors, and an explicit torch.Generator
for RANSAC sampling.

Ported so far (match+localize, the TRIP and AKAZE frontends, the session
with its bootstrap, fusion, map lifecycle and plumbing, batched serving,
and the runtime over the topic bus):
  config, types, convert   — options, data model, numpy <-> tensor (a
                             coloc_tpu session's state included)
  ops/dispatch, ops/_build — device dispatch + launch counters, nvcc build
  ops/hamming              — 2-NN against a bank (kernel csrc/k2nn.cu)
  matching                 — margin / ratio accept, match_with_map, match_pair,
                             match_maps
  geometry/{so3,se3,camera}— rotations, poses, the radial camera
  geometry/p3p             — P3P flats (kernel csrc/p3p.cu)
  geometry/fivept          — five-point solver (csrc/fivept_{front,dk,polish}.cu)
  geometry/{essential,triangulation}
                           — epipolar residuals, E decomposition and
                             refinement, DLT triangulation
  ransac, ops/ransac_rank  — NFA RANSAC, ladder pre-ranks (csrc/ransac_rank.cu,
                             csrc/epi_rank.cu)
  robust                   — absolute_pose_p3p, relative_pose_essential
  sfm/{ba,localize,reconstruct}
                           — full and pose-only LM, localize_image, the
                             two-view scene and map database
  ops/{pyramid,orientation,descriptor}
                           — pyramid + blur, intensity-centroid angle, TRIP-512
  ops/fast                 — FAST-9 + NMS (kernel csrc/fast_nms.cu), top-k
  ops/patches              — stacked raster, patch windows (csrc/extract.cu)
  frontend                 — detect_and_describe(_batch), TRIP backend
  fusion/kalman, session   — Kalman bank, intra_all_device_step, ColocSession
  fusion/covint            — inverse covariance intersection (ICI)
  utils, metrics           — map scale and Sim(3) alignment, ATE / RPE
  parallel/mesh            — inter_pose_device, the inter-drone fusion core
  serving                  — make_serve_step, ServingEngine: B streams against
                             one resident map in one step
  checkpoint, profiling    — session save / load in coloc_tpu's format, the
                             stage profiler and trace_to
  io/synthetic             — numpy-only scene renderer and workload generator
  io/{loggers,svg,liveviz,disk}
                           — CSV / PLY logs, SVG overlays, the live view,
                             disk frames and calib.txt
  io/{stream,euroc,kitti}  — live frame queues and time sync, EuRoC and
                             KITTI readers
  io/{transport,native_loader}, native/
                           — the TCP topic bus and its codecs, the
                             prefetching PNG/PGM loader (C++ built by g++)
  serve, distributed, cli  — ServeRunner over the bus, DronePeer / run_peer,
                             the session runner; `python -m` entry points
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is precision-critical: the reference lost 0.04 deg -> 2.5 deg of
# pose error to reduced-precision matmul passes (coloc_tpu/__init__.py).
# Keep every float32 product in full float32 on the card: no TF32 in matmuls
# or cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from coloc_tpu_torch.config import (  # noqa: E402,F401
    ColocConfig,
    DetectorOptions,
    MatcherOptions,
)
