"""How often the port's LM and Gauss-Newton loops should read their exit
on the host, on one CUDA card.

    python scripts/prof_torch_loop_exit.py

The workload is chip_smoke.py's phase 4d: the bench scene (make_scene(480,
752, K, seed=1)) seen by drones 0 and 1 along their trajectories, the
reference configuration (1024 keypoints, 8 levels, fast_threshold 12, 4096
landmarks, model E, 256 hypotheses), a session bootstrapped on frame 0.
Every loop is in done-mask form, so the period k between two host reads
changes no bit of a result (tests/test_torch_loop_exit.py), only the time.
Prints, beside the card's name and power limit, each k in turns (p50 over
REPS calls, CUDA events):

  - the eager frame step (session.intra_all_device_step) with the pose
    LM's period k, and how many iterations the drones' LMs ran;
  - ColocSession.init_map with the bootstrap's BA and Gauss-Newton period
    k (session.BOOTSTRAP_CHECK_EVERY), with the BA's iterations;
  - the captured step (session._StepGraphs) with k LM
    iterations in its head and middle graphs (session.LM_GRAPH_STEPS):
    replay time and host reads a frame.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from coloc_tpu_torch import config, session  # noqa: E402
from coloc_tpu_torch.io import synthetic  # noqa: E402
from coloc_tpu_torch.sfm import ba  # noqa: E402

H, W = 480, 752
FRAMES, REPS = 12, 10
STEP_KS = (1, 2, 4, 8, 100)
BOOT_KS = (1, 2, 4, 8, 100)
GRAPH_KS = (2, 3, 4, 8)


def p50(v):
    return float(np.percentile(v, 50))


def timed(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


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
    traj = [synthetic.trajectory(FRAMES + 1, d) for d in range(2)]
    frames = torch.from_numpy(np.stack([
        np.stack([synthetic.render(scene, traj[d][0][f], traj[d][1][f]) for d in range(2)])
        for f in range(FRAMES + 1)]).astype(np.float32)).to(dev)
    cfg = config.ColocConfig(num_drones=2, detector=config.DetectorOptions(
        width=W, height=H, max_keypoints=1024, num_levels=8, fast_threshold=12))
    Ks, dists = np.stack([K, K]), np.zeros((2, 3), np.float32)
    sess = session.ColocSession(cfg, Ks, dists, seed=0, device=dev)
    assert sess.init_map({0: frames[0, 0], 1: frames[0, 1]})
    sess._ensure_support()
    bank = sess._map_bank()
    uniforms = [sess._draw(2) for _ in range(FRAMES)]

    # the eager step: LM iterations a drone, then each k in turns
    its = []
    for f in range(FRAMES):
        fr, lm = session._step_head(cfg, frames[f + 1], sess.mapdb, bank, sess.Ks,
                                    sess.dists, uniforms=uniforms[f])
        lm = ba.pose_lm_run(lm, fr.X, fr.uv, fr.inliers, sess.Ks, sess.dists, cfg.refiner,
                            cfg.refiner.max_iterations)
        its += lm.iterations.tolist()
    print(f"[step] pose LM iterations a drone over {FRAMES} frames: min {min(its)}, p50 "
          f"{p50(its):.0f}, max {max(its)}; histogram "
          f"{dict(sorted((i, its.count(i)) for i in set(its)))}")
    ms = {k: [] for k in STEP_KS}
    for r in range(REPS):
        for k in (STEP_KS if r % 2 else STEP_KS[::-1]):
            f = r % FRAMES
            t, _ = timed(lambda: session.intra_all_device_step(
                cfg, frames[f + 1], sess.mapdb, bank, sess.Ks, sess.dists, sess.filter_bank,
                uniforms=uniforms[f], check_every=k))
            ms[k].append(t)
    print("[step] eager intra_all_device_step p50 ms by pose-LM period k: " + ", ".join(
        f"k={k} {p50(v):.3f}" for k, v in ms.items()) + f"  ({card})")

    # init_map: the bootstrap's BA and Gauss-Newton period
    ms, iters = {k: [] for k in BOOT_KS}, {}
    default = session.BOOTSTRAP_CHECK_EVERY
    try:
        for r in range(REPS):
            for k in (BOOT_KS if r % 2 else BOOT_KS[::-1]):
                session.BOOTSTRAP_CHECK_EVERY = k
                s = session.ColocSession(cfg, Ks, dists, seed=0, device=dev)
                t, ok = timed(lambda: s.init_map({0: frames[0, 0], 1: frames[0, 1]}))
                assert ok
                ms[k].append(t)
                iters[k] = int(s.bootstrap_ba.iterations)
    finally:
        session.BOOTSTRAP_CHECK_EVERY = default
    print("[init_map] p50 ms by BA / Gauss-Newton period k: " + ", ".join(
        f"k={k} {p50(v):.3f}" for k, v in ms.items())
        + f"; BA iterations {iters[BOOT_KS[0]]}  ({card})")

    # the captured step, k LM iterations a head or middle graph
    default = session.LM_GRAPH_STEPS
    graphs, ms, reads = {}, {k: [] for k in GRAPH_KS}, {}
    try:
        for k in GRAPH_KS:
            session.LM_GRAPH_STEPS = k
            graphs[k] = session._StepGraphs(sess)
        for r in range(REPS):
            for k in (GRAPH_KS if r % 2 else GRAPH_KS[::-1]):
                g = graphs[k]
                f = r % FRAMES
                g.load(sess)
                t, _ = timed(lambda: g.replay(frames[f + 1], uniforms[f]))
                ms[k].append(t)
        reads = {k: graphs[k].host_reads / REPS for k in GRAPH_KS}
    finally:
        session.LM_GRAPH_STEPS = default
    print("[captured] replay p50 ms a frame by LM period k: " + ", ".join(
        f"k={k} {p50(v):.3f} ({reads[k]:.2f} host reads)" for k, v in ms.items())
        + f"; capture s {', '.join(f'{graphs[k].capture_seconds:.2f}' for k in GRAPH_KS)}"
        f"  ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
