"""Where the time of the port's two-drone map bootstrap goes, on one CUDA card.

    python scripts/prof_torch_bootstrap.py

The workload is chip_smoke.py's phase 4d: the bench scene (make_scene(480,
752, K, seed=1)) seen by drones 0 and 1 at frame 0 of their trajectories,
the reference configuration (1024 keypoints, 8 levels, fast_threshold 12,
4096 landmarks, model E, NFA, 256 hypotheses). Prints, beside the card's
name and power limit:

  - per-stage latency from CUDA events, p50 over REPS bootstraps after one
    warm-up: the two frontends, match_pair, relative_pose_essential (the
    five-point AC-RANSAC with B6-B9, the essential refinement),
    two_view_scene (triangulation) and refine_scene (the full BA), the
    stages of ColocSession.init_map;
  - a torch.profiler view of PROFILED bootstraps: device time by kernel,
    the device's busy share, launches, host reads of device values, host
    time by op.
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

from coloc_tpu_torch import config, matching, robust  # noqa: E402
from coloc_tpu_torch.frontend import detect_and_describe  # noqa: E402
from coloc_tpu_torch.geometry.camera import Camera  # noqa: E402
from coloc_tpu_torch.io import synthetic  # noqa: E402
from coloc_tpu_torch.sfm import reconstruct  # noqa: E402
from coloc_tpu_torch.types import Pose  # noqa: E402

H, W = 480, 752
REPS, PROFILED = 10, 3
STAGES = ("detect x2", "match_pair", "relative_pose_essential", "two_view_scene",
          "refine_scene (BA)")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)

    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    scene = synthetic.make_scene(H, W, K, seed=1)
    imgs = []
    for d in range(2):
        Rs, Cs = synthetic.trajectory(2, d)
        imgs.append(torch.from_numpy(synthetic.render(scene, Rs[0], Cs[0])
                                     .astype(np.float32)).to(dev))
    cfg = config.ColocConfig(detector=config.DetectorOptions(
        width=W, height=H, max_keypoints=1024, num_levels=8, fast_threshold=12))
    Kt = torch.from_numpy(np.stack([K, K])).to(dev)
    dists = torch.zeros((2, 3), device=dev)
    cam = Camera(K=Kt[0], dist=dists[0])
    origin = Pose(R=torch.eye(3, device=dev), C=torch.zeros(3, device=dev))
    fix = torch.tensor([True, False], device=dev)

    def bootstrap(seed, events=None):
        """ColocSession.init_map's stages, with a CUDA event between each."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        f0 = detect_and_describe(imgs[0], cfg.detector)
        f1 = detect_and_describe(imgs[1], cfg.detector)
        mark(1)
        m = matching.match_pair(f0, f1, cfg.matcher)
        mark(2)
        geo = robust.relative_pose_essential(f0.xy, f1.xy[m.idx.long()], m.mask, cam,
                                             cam, cfg.ransac, generator=gen)
        mark(3)
        sc = reconstruct.two_view_scene(f0, f1, m, geo.inliers, geo.R, geo.t, origin,
                                        cfg.scale, cam, cam, cfg.max_landmarks)
        mark(4)
        sc, ba = reconstruct.refine_scene(sc, Kt, dists, cfg.refiner, fix)
        mark(5)
        return geo, sc, ba

    bootstrap(0)                               # warm-up: one-time set-up
    torch.cuda.synchronize()
    stages, iters = defaultdict(list), []
    for r in range(REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        geo, sc, ba = bootstrap(1 + r, ev)
        torch.cuda.synchronize()
        if not bool(geo.success) or int(sc.X_valid.sum()) < 8:
            raise RuntimeError(f"bootstrap {r} failed")
        for i, name in enumerate(STAGES):
            stages[name].append(ev[i].elapsed_time(ev[i + 1]))
        stages["init_map"].append(ev[0].elapsed_time(ev[5]))
        iters.append(ba.iterations)
    print(f"stage latency, p50 (p10-p90) over {REPS} bootstraps, CUDA events "
          f"(BA LM iterations {min(iters)}-{max(iters)}):")
    for name, v in stages.items():
        p10, p50, p90 = np.percentile(v, [10, 50, 90])
        print(f"  {name:24s} {p50:9.3f} ms  ({p10:.3f}-{p90:.3f})")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(PROFILED):
            bootstrap(100 + r)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    calls = defaultdict(int)
    for e in prof.events():
        calls[e.name] += 1
    n = PROFILED
    print(f"torch.profiler over {n} bootstraps: wall {wall_us / n / 1e3:.3f} ms each, "
          f"device busy {busy_us / n / 1e3:.3f} ms ({100.0 - 100.0 * busy_us / wall_us:.1f}% "
          f"idle), {len(kernels) / n:.0f} launches, "
          f"{calls['aten::_local_scalar_dense'] / n:.0f} host reads of device values")
    print("  device time by kernel (us a bootstrap):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / n:9.1f}  {name[:90]}")
    print("  host time by op, self CPU (us a bootstrap, calls; profiler on):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"    {e.self_cpu_time_total / n:9.1f}  {e.count / n:7.1f}  {e.key[:70]}")
    print(f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
