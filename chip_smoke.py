#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (coloc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's headline op, match+localize (resident-bank Hamming 2-NN,
P3P AC-RANSAC, pose-only LM), at the reference workload: a 752x480 camera,
1024 keypoints, a 4096-landmark map, 256 hypotheses, NFA scoring. Phases:

  1. device   — a CUDA device is required (there is no CPU path)
  2. build    — nvcc builds the kernels from coloc_tpu_torch/csrc
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the shapes of the main path, with kernel and plain times
  4. slice    — FRAMES frames through match_with_map + localize_image,
                checked against the identity ground truth, plus frame 0
                through the plain CPU path with the same RANSAC draws
  5. counters — every kernel of the path launched during phase 4

Any failed check raises and the script exits non-zero. The last two lines
of stdout are one JSON object per kernel and the run's result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
H, W, KP, LANDMARKS = 480, 752, 1024, 4096
OUTLIER_FRAC = 0.25
FRAMES = 50
WARMUP, ITERS = 10, 100

KERNEL_INFO = {
    "k2nn": ("coloc_tpu_torch/csrc/k2nn.cu", "coloc_tpu/ops/hamming.py:103"),
    "p3p": ("coloc_tpu_torch/csrc/p3p.cu", "coloc_tpu/geometry/p3p.py:243"),
    "ransac_rank": ("coloc_tpu_torch/csrc/ransac_rank.cu",
                    "coloc_tpu/ops/ransac_rank.py:78"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def workload(np, rng):
    """Random features + a consistent map with OUTLIER_FRAC of the matched
    landmarks moved to random far points (numpy, the reference layout)."""
    from coloc_tpu_torch.io import synthetic

    fa = synthetic.random_features(H, W, KP, rng)
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]],
                 np.float32)
    ma = synthetic.consistent_mapdb(fa, K, LANDMARKS, rng)
    n_out = int(OUTLIER_FRAC * KP)
    X = ma.X.copy()
    X[:n_out] = rng.uniform(-50.0, 50.0, (n_out, 3)).astype(np.float32)
    return fa, ma._replace(X=X), K, n_out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 1

    import numpy as np

    import coloc_tpu_torch
    from coloc_tpu_torch import config, convert
    from coloc_tpu_torch.geometry import camera as cam_ops
    from coloc_tpu_torch.geometry import p3p
    from coloc_tpu_torch.matching import match_with_map, pack_map_bank
    from coloc_tpu_torch.ops import _build, dispatch, hamming, ransac_rank
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.sfm.localize import localize_image

    # the port must come from this checkout, so its kernels build from here
    pkg = Path(coloc_tpu_torch.__file__).resolve().parent
    check(pkg.parent == Path(__file__).resolve().parent,
          f"coloc_tpu_torch imported from {pkg}, not from this checkout")

    # ---- phase 1: device ------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    print(card)

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds:.2f} s) -> {_build.library_path(_build._nvcc()).name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())

    rng = np.random.default_rng(SEED)
    fa, ma, K, n_out = workload(np, rng)
    feats = convert.features_from_numpy(fa, dev)
    mapdb = convert.mapdb_from_numpy(ma, dev)
    cam = convert.camera_from_numpy(K, device=dev)
    cfg = config.ColocConfig()
    results = {}

    # ---- phase 3: kernels against their plain twins -------------------
    # B1: Q=1024 x T=4096, duplicates of query 0 planted in other bank
    # tiles, a band of invalid rows that holds query 5's own row
    t_desc = mapdb.desc.clone()
    t_desc[2100] = t_desc[0]
    t_desc[3900] = t_desc[0]
    t_valid = mapdb.valid.clone()
    t_valid[3:40] = False
    bank = hamming.pack_bank(t_desc, t_valid)
    q_valid = feats.valid.clone()
    q_valid[7] = False
    out_k = hamming._hamming_2nn_cuda(feats.desc, q_valid, bank)
    out_p = hamming.hamming_2nn_plain(feats.desc, q_valid, bank)
    torch.cuda.synchronize()
    err = max(int((a - b).abs().max()) for a, b in zip(out_k, out_p))
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          f"k2nn differs from its plain twin (max |diff| {err})")
    check(int(out_k[0][0]) == 0 and int(out_k[1][0]) == 0
          and int(out_k[2][0]) == 0, "k2nn duplicate semantics")
    check(int(out_k[1][7]) == 2048, "k2nn invalid-query semantics")
    results["k2nn"] = dict(
        max_abs_err=float(err),
        ms=cuda_ms(lambda: hamming._hamming_2nn_cuda(feats.desc, q_valid, bank)),
        plain_ms=cuda_ms(lambda: hamming.hamming_2nn_plain(feats.desc, q_valid, bank)))

    # B2: 256 minimal samples of the frame's 2D-3D correspondences
    corr = torch.ones(KP, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = sample_indices(corr, cfg.ransac.num_hypotheses, 3, gen)
    Xc = mapdb.X[:KP]
    bc = cam_ops.bearing(cam, feats.xy)
    Xs, bs = Xc[idx].contiguous(), bc[idx].contiguous()
    fk, vk = p3p._p3p_flats_cuda(Xs, bs)
    fp, vp = p3p.p3p_flats_plain(Xs, bs)
    torch.cuda.synchronize()
    both = vk & vp
    valid_agree = float((vk == vp).all(dim=1).float().mean())
    diff = (fk - fp).abs()[both]
    rel = (diff / (1.0 + fp.abs()[both])).max() if both.any() else torch.tensor(0.0)
    results["p3p"] = dict(
        max_abs_err=float(diff.max()) if both.any() else 0.0,
        ms=cuda_ms(lambda: p3p._p3p_flats_cuda(Xs, bs)),
        plain_ms=cuda_ms(lambda: p3p.p3p_flats_plain(Xs, bs)))
    exact = float((fk == fp).all(dim=2)[both].float().mean()) if both.any() else 1.0
    print(f"[3 p3p] valid masks agree on {valid_agree:.4f} of samples, "
          f"{int(both.sum())} poses valid in both, {exact:.4f} of them bit-equal")
    check(valid_agree >= 0.99, f"p3p valid masks agree on {valid_agree:.4f} < 0.99")
    check(float(rel) <= 1e-4, f"p3p flats differ by {float(rel):.3e} (1+|x|)-relative")

    # B3: Hm=1024 models (the 256 samples' flats) x M=1024 correspondences
    focal = (cam.fx + cam.fy) * 0.5
    ops = ransac_rank.p3p_operands(fk.reshape(-1, 12), Xc, bc, corr, focal)
    ops = tuple(t.contiguous() for t in ops)
    thr_sq = cfg.ransac.p3p_threshold ** 2
    rank_err = 0.0
    for zmode in ("pos", "nonzero"):
        rk = ransac_rank._ladder_rank_cuda(*ops, thr_sq, zmode, 2, 5)
        rp = ransac_rank.ladder_rank_plain(*ops, thr_sq, zmode)
        torch.cuda.synchronize()
        d = (rk - rp).abs()
        equal = float((d == 0).float().mean())
        check(equal >= 0.999, f"rank[{zmode}] equal on {equal:.4f} < 0.999")
        check(float(d.max()) <= 2.0, f"rank[{zmode}] differs by {float(d.max())}")
        rank_err = max(rank_err, float(d.max()))
        print(f"[3 ransac_rank] zmode={zmode}: equal on {equal:.4f} of "
              f"{rk.numel()} models, max |diff| {float(d.max())}")
    results["ransac_rank"] = dict(
        max_abs_err=rank_err,
        ms=cuda_ms(lambda: ransac_rank._ladder_rank_cuda(*ops, thr_sq, "pos", 2, 5)),
        plain_ms=cuda_ms(lambda: ransac_rank.ladder_rank_plain(*ops, thr_sq, "pos")))
    for name, r in results.items():
        print(f"[3 {name}] kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"max |err| {r['max_abs_err']:.3e}  ({card})")

    # ---- phase 4: the slice end to end ----------------------------------
    bank = pack_map_bank(mapdb)
    eye = torch.eye(3, device=dev)
    lat_ms = []
    dispatch.reset_launch_counts()
    for f in range(FRAMES):
        gen = torch.Generator(device=dev).manual_seed(1000 + f)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mm = match_with_map(feats, mapdb, cfg.matcher, bank=bank)
        pwc, inl = localize_image(feats, mm, mapdb, cam, cfg.ransac,
                                  cfg.refiner, generator=gen)
        end.record()
        torch.cuda.synchronize()
        lat_ms.append(start.elapsed_time(end))
        R, C = pwc.pose.R, pwc.pose.C
        rot_err = float(torch.arccos(torch.clamp(
            (torch.trace(R.T @ eye) - 1.0) / 2.0, -1.0, 1.0)))
        c_err = float(torch.linalg.norm(C))
        n = int(pwc.n_tracks)
        check(bool(pwc.success), f"frame {f}: localization failed")
        check(700 <= n <= 800, f"frame {f}: n_tracks {n} outside [700, 800]")
        check(rot_err < 1e-3, f"frame {f}: rotation error {rot_err:.3e} rad")
        check(c_err < 1e-2, f"frame {f}: center error {c_err:.3e} m")
        check(bool(torch.isfinite(pwc.cov).all()) and pwc.cov.shape == (6, 6),
              f"frame {f}: covariance not finite (6, 6)")
        check(not bool(inl[:n_out].any()), f"frame {f}: a moved landmark is an inlier")
    counts = dispatch.launch_counts()
    # frame 0 pays the one-time set-up of the ops it is first to run
    steady = np.asarray(lat_ms[1:])
    print(f"[4 slice] {FRAMES} frames ok; per-frame latency after frame 0: "
          f"p50 {np.percentile(steady, 50):.3f} ms, p99 "
          f"{np.percentile(steady, 99):.3f} ms; frame 0 {lat_ms[0]:.3f} ms  ({card})")

    # frame 0 again, on the card and through the plain CPU path, with the
    # same RANSAC draws: the two paths must agree
    draw = sample_indices(mm.mask & feats.valid, cfg.ransac.num_hypotheses, 3,
                          torch.Generator(device=dev).manual_seed(1000))
    mm_g = match_with_map(feats, mapdb, cfg.matcher, bank=bank)
    pg, _ = localize_image(feats, mm_g, mapdb, cam, cfg.ransac, cfg.refiner,
                           sample_idx=draw)
    cpu = torch.device("cpu")
    feats_c = convert.features_from_numpy(fa, cpu)
    mapdb_c = convert.mapdb_from_numpy(ma, cpu)
    mm_c = match_with_map(feats_c, mapdb_c, cfg.matcher)
    pc, _ = localize_image(feats_c, mm_c, mapdb_c,
                           convert.camera_from_numpy(K, device=cpu),
                           cfg.ransac, cfg.refiner, sample_idx=draw.cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(mm_g, mm_c)),
          "matches differ between the card and the CPU path")
    check(bool(pg.success) and bool(pc.success), "reference frame failed")
    check(abs(int(pg.n_tracks) - int(pc.n_tracks)) <= 1,
          f"n_tracks {int(pg.n_tracks)} on the card vs {int(pc.n_tracks)} on CPU")
    dR = float((pg.pose.R.cpu() - pc.pose.R).abs().max())
    dC = float((pg.pose.C.cpu() - pc.pose.C).abs().max())
    check(dR < 1e-4 and dC < 1e-4, f"pose card vs CPU: |dR| {dR:.2e}, |dC| {dC:.2e}")
    print(f"[4 reference] frame 0 card vs CPU plain path: n_tracks "
          f"{int(pg.n_tracks)} / {int(pc.n_tracks)}, |dR| {dR:.2e}, |dC| {dC:.2e}")

    # ---- phase 5: the main path went through every kernel --------------
    print(f"[5 counters] launches during phase 4: {counts}")
    for name in dispatch.KERNELS:
        check(counts[name] > 0, f"kernel {name} was never launched in phase 4")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": counts[name],
         "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"]}
        for name in dispatch.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
