"""Entry points of the port for an external harness (counterpart of __graft_entry__.py).

    python -m coloc_tpu_torch.graft_entry [--ranks N] [--cpu]

entry(device=None)          -> (fn, example_args): the single-device forward
                               on tensors (frame -> features -> map match ->
                               P3P localization -> refined pose and
                               covariance) at tiny shapes.
dryrun_multichip(n, device=None)
                            -> n ranks (parallel/mesh.spawn) build a
                               drone-axis mesh and run coloc_tpu's dry-run
                               programs once on tiny shapes: the
                               collaborative step (inter "full"), the scan
                               over 2 frames, sharded serving with 2 streams
                               a rank and, for an even n >= 4, the map
                               match on a (2, n / 2) drone x map mesh; rank
                               0 prints "dryrun[<program>] ok (<s>)" after
                               each.

Both run on the card unless the caller asks for the CPU (device="cpu",
--cpu); with no CUDA device and no device they raise. Where the host has
fewer cards than ranks, the ranks share them over gloo (make_mesh says
so). The kernels are built in the calling process before the ranks start,
so n ranks do not each run nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from coloc_tpu_torch import convert, matching, serving
from coloc_tpu_torch.config import ColocConfig, DetectorOptions, RansacOptions
from coloc_tpu_torch.frontend import detect_and_describe
from coloc_tpu_torch.fusion import kalman
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.ops import _build, dispatch
from coloc_tpu_torch.parallel import mesh as pmesh
from coloc_tpu_torch.sfm import localize
from coloc_tpu_torch.types import Features, MapDB


def _tiny_setup(num_drones: int, device, h: int = 64, w: int = 96, kp: int = 64,
                landmarks: int = 128):
    """coloc_tpu's dry-run inputs (the same numpy draws): config, images
    (D, h, w), Ks (D, 3, 3), dists (D, 3), a fresh filter bank and a map
    of random landmarks, on `device`."""
    rng = np.random.default_rng(0)
    config = ColocConfig(
        num_drones=num_drones,
        detector=DetectorOptions(width=w, height=h, max_keypoints=kp, num_levels=2,
                                 fast_threshold=20),
        # a small hypothesis budget: the dry run checks the mesh and its
        # collectives on tiny shapes, not the estimator's quality
        ransac=RansacOptions(num_hypotheses=64),
        max_landmarks=landmarks)
    images = torch.tensor(rng.uniform(0, 255, (num_drones, h, w)), dtype=torch.float32,
                          device=device)
    K = torch.tensor([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], device=device)
    Ks = K.expand(num_drones, 3, 3).contiguous()
    dists = torch.zeros((num_drones, 3), device=device)
    fb = kalman.init(num_drones, config.filter, device)
    mapdb = convert.mapdb_from_numpy(synthetic.MapDBArrays(
        X=rng.uniform(-3, 3, (landmarks, 3)).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (landmarks, 16), dtype=np.uint64).astype(np.uint32),
        valid=np.ones(landmarks, bool)), device)
    return config, images, Ks, dists, fb, mapdb


def entry(device=None):
    """The single-device forward step and its example arguments:
    fn(generator, image, K, dist, map_X, map_desc, map_valid) -> (C, R,
    cov, success); the generator draws the RANSAC samples (coloc_tpu's
    key)."""
    device = dispatch.default_device(device)
    config, images, Ks, dists, _fb, mapdb = _tiny_setup(1, device)

    def forward(generator, image, K, dist, map_X, map_desc, map_valid):
        mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
        feats = detect_and_describe(image, config.detector)
        mm = matching.match_with_map(feats, mapdb, config.matcher)
        pwc, _ = localize.localize_image(feats, mm, mapdb, Camera(K=K, dist=dist),
                                         config.ransac, config.refiner, generator=generator)
        return pwc.pose.C, pwc.pose.R, pwc.cov, pwc.success

    example_args = (torch.Generator(device=device).manual_seed(0), images[0], Ks[0],
                    dists[0], *mapdb)
    return forward, example_args


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _dryrun_rank(rank: int, n: int, devices) -> None:
    """One rank of dryrun_multichip: every program once, checked on rank 0
    after a gather of the outputs (shapes, finite values)."""
    if devices == "cpu":
        # n ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    m = pmesh.make_mesh(devices)
    config, images, Ks, dists, fb, mapdb = _tiny_setup(n, m.device)
    gen = pmesh.rank_generator(m)
    tick = time.time()

    def mark(name):
        nonlocal tick
        now = time.time()
        if rank == 0:
            print(f"dryrun[{name}] ok ({now - tick:.0f}s)", flush=True)
        tick = now

    # the full collaborative step: the per-drone step with the Kalman update,
    # then the ring exchange and interPoseEstimator on every rank
    args = pmesh.shard_inputs(m, images, Ks, dists, fb, mapdb)
    out = pmesh.collaborative_step(m, config, inter="full")(*args, generator=gen)
    fused_pos, inter_ok = pmesh.gather(m, (out[3], out[5]))
    _check(fused_pos.shape == (n, 3) and bool(torch.isfinite(fused_pos).all())
           and inter_ok.shape == (n,), f"step: fused_pos {tuple(fused_pos.shape)}")
    mark("step")

    # two frames through the per-drone step, the exchange on the last
    F = 2
    images_f = args[0].expand(F, 1, *args[0].shape[1:])
    sout = pmesh.collaborative_step_scan(m, config)(images_f, *args[1:], generator=gen)
    pos, iok = pmesh.gather(m, sout[1], dim=1), pmesh.gather(m, sout[6])
    _check(pos.shape == (F, n, 3) and iok.shape == (n,), f"scan: positions "
           f"{tuple(pos.shape)}")
    mark("scan")

    # scale-out serving: 2 streams a rank, each rank's features from its own
    # frame, the map on every rank, no collective
    b = 2
    f0 = detect_and_describe(args[0][0], config.detector)
    feats_b = Features(*(t.expand(b, *t.shape) for t in f0))
    cams = Camera(K=args[1].expand(b, 3, 3), dist=args[2].expand(b, 3))
    run = serving.make_sharded_serve_step(m, config)
    pwc, _, _ = run(feats_b, cams, args[4], matching.pack_map_bank(args[4]), generator=gen)
    C = pmesh.gather(m, pwc.pose.C)
    _check(C.shape == (b * n, 3), f"serving: C {tuple(C.shape)}")
    mark("serving")

    if n >= 4 and n % 2 == 0:
        # the drone axis and the map axis sharded at once: queries over the
        # drone rows, the bank over the map columns
        m2d = pmesh.make_mesh(devices, axis_names=("drone", "map"), shape=(2, n // 2))
        match = pmesh.sharded_map_match(m2d, config.matcher, axis="map", query_axis="drone")
        q = args[4].desc[:64]
        mm = match(q, torch.ones(64, dtype=torch.bool, device=m.device), args[4].desc,
                   args[4].valid)
        idx = pmesh.gather(m2d, mm.idx)
        _check(idx.shape == (64,), f"map2d: idx {tuple(idx.shape)}")
        mark("map2d")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """coloc_tpu's multi-chip dry run on n_devices ranks (module docstring).
    `device` None: the ranks on the host's cards, sharing them over gloo
    where there are fewer than n_devices; "cpu": on the CPU over gloo."""
    if device is None:
        dispatch.default_device(None)      # raises with no CUDA device
        cards = torch.cuda.device_count()
        if cards < n_devices:
            print(f"dryrun_multichip({n_devices}): {cards} card(s) on this host; the "
                  f"{n_devices} ranks share them over gloo", flush=True)
        devices = None
        _build.load()
    else:
        devices = str(dispatch.default_device(device))
        if torch.device(devices).type == "cuda":
            _build.load()
    t0 = time.time()
    pmesh.spawn(_dryrun_rank, n_devices, (n_devices, devices))
    print(f"dryrun_multichip({n_devices}) ok ({time.time() - t0:.0f}s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4, help="ranks of the dry run (default 4)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card, and no card raises)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    fn, example_args = entry(device)
    out = fn(*example_args)
    print(f"entry() ok on {out[0].device}:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(args.ranks, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
