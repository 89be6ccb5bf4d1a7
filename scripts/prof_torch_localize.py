"""Where the time of the port's match+localize op goes, on one CUDA card.

    python scripts/prof_torch_localize.py

The workload is chip_smoke.py's: a 752x480 camera, 1024 keypoints, a
4096-landmark map with 25% of the matched landmarks moved to random far
points, default options (256 hypotheses, NFA scoring). Prints, beside the
card's name and power limit:

  - per-stage latency from CUDA events, p50 over FRAMES frames after one
    warm-up frame: match_with_map, the P3P RANSAC (absolute_pose_p3p) and
    the LM refinement (refine_pose_only), the stages of localize_image;
  - a torch.profiler view of PROFILED frames: device time by kernel, the
    device's busy share of the host's wall time, kernel launches, host
    reads of device values and LM iterations per frame.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from coloc_tpu_torch import config, convert  # noqa: E402
from coloc_tpu_torch.io import synthetic  # noqa: E402
from coloc_tpu_torch.matching import match_with_map, pack_map_bank  # noqa: E402
from coloc_tpu_torch.robust import absolute_pose_p3p  # noqa: E402
from coloc_tpu_torch.sfm.ba import refine_pose_only  # noqa: E402

H, W, KP, LANDMARKS = 480, 752, 1024, 4096
FRAMES, PROFILED = 30, 5


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)

    rng = np.random.default_rng(0)
    fa = synthetic.random_features(H, W, KP, rng)
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    ma = synthetic.consistent_mapdb(fa, K, LANDMARKS, rng)
    X = ma.X.copy()
    X[:KP // 4] = rng.uniform(-50.0, 50.0, (KP // 4, 3)).astype(np.float32)
    feats = convert.features_from_numpy(fa, dev)
    mapdb = convert.mapdb_from_numpy(ma._replace(X=X), dev)
    cam = convert.camera_from_numpy(K, device=dev)
    cfg = config.ColocConfig()
    bank = pack_map_bank(mapdb)

    def frame(seed, events=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        mm = match_with_map(feats, mapdb, cfg.matcher, bank=bank)
        mark(1)
        Xm = mapdb.X[mm.idx.long() % LANDMARKS]
        pose0, inl, _, ok = absolute_pose_p3p(Xm, feats.xy, mm.mask & feats.valid,
                                              cam, cfg.ransac, generator=gen)
        mark(2)
        res = refine_pose_only(pose0.R, pose0.C, Xm, feats.xy, inl, cam.K,
                               cam.dist, cfg.refiner)
        mark(3)
        return ok, res

    frame(0)                                   # warm-up: one-time set-up
    torch.cuda.synchronize()
    stages = defaultdict(list)
    for f in range(FRAMES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ok, _ = frame(1 + f, ev)
        torch.cuda.synchronize()
        if not bool(ok):
            raise RuntimeError(f"frame {f}: localization failed")
        stages["match_with_map"].append(ev[0].elapsed_time(ev[1]))
        stages["absolute_pose_p3p"].append(ev[1].elapsed_time(ev[2]))
        stages["refine_pose_only"].append(ev[2].elapsed_time(ev[3]))
        stages["frame"].append(ev[0].elapsed_time(ev[3]))
    print(f"stage latency, p50 (p10-p90) over {FRAMES} frames, CUDA events:")
    for name, v in stages.items():
        p10, p50, p90 = np.percentile(v, [10, 50, 90])
        print(f"  {name:20s} {p50:8.3f} ms  ({p10:.3f}-{p90:.3f})")

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in range(PROFILED):
            frame(100 + f)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    calls = defaultdict(int)
    for e in prof.events():
        calls[e.name] += 1
    print(f"torch.profiler over {PROFILED} frames: wall {wall_us / PROFILED / 1e3:.3f} "
          f"ms/frame, device busy {busy_us / PROFILED / 1e3:.3f} ms/frame "
          f"({100.0 * busy_us / wall_us:.1f}% busy, "
          f"{100.0 - 100.0 * busy_us / wall_us:.1f}% idle)")
    print(f"  kernel launches/frame {len(kernels) / PROFILED:.0f}, host reads of "
          f"device values/frame {calls['aten::_local_scalar_dense'] / PROFILED:.0f}, "
          f"LM iterations/frame {calls['aten::linalg_cholesky_ex'] / PROFILED:.1f}")
    print("  device time by kernel (us/frame):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / PROFILED:9.1f}  {name[:90]}")
    print("  host time by op, self CPU (us/frame, calls/frame; profiler on):")
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:15]:
        print(f"    {e.self_cpu_time_total / PROFILED:9.1f}  "
              f"{e.count / PROFILED:6.1f}  {e.key[:70]}")
    print(f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
