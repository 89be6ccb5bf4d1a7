"""Readings of the reference frontend against the program's, at a
configuration's own size, from which a cell's feature and match limits
are set (not run by the benchmark's own runs).

    python3 -m portbench.frontend_gap --config <configuration file> --seeds 1,2,3

On the first CUDA device, which it needs. For each seed: the scene of the
session mix's parameters, the frames of two drones at a frame step drawn
from the seed, the program's batched frontend on them
(`detect_and_describe_batch`) and its matches against the reference map of
the file's `max_landmarks` slots (`inputs/landmarks.py`), judged as a
cell's check judges them: `keypoints_differ`, `desc_bits_differ`,
`matches_differ` (the reference 2-NN of the program's descriptors) and
`matches_by_position` (of the reference's descriptors at the same
keypoints). Also the map's valid slots, the reference's seconds and the
device's name. One JSON line a seed, then the largest of each number.

Once a cell runs the configuration, `portbench.control` reads these
numbers from the cell's timed path, and this module can go.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import common
from portbench.inputs import landmarks
from portbench.inputs import scene as scene_mod
from portbench.reference import judge, pipeline, trip


def readings(cfg: dict, seed: int, device, frames_per_drone: int = 64,
             drones: int = 2) -> dict:
    from coloc_tpu_torch import config as prog_config
    from coloc_tpu_torch import frontend, matching
    from coloc_tpu_torch.types import Features, MapDB

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    det = cfg["detector"]
    K, _ = common.intrinsics(cfg)
    scene = scene_mod.make_scene(det["height"], det["width"], K, common.derive(seed, "scene"),
                                 (6.0, 12.0), 0.45)
    step = int(np.random.default_rng(common.derive(seed, "step")).integers(frames_per_drone))
    paths = [scene_mod.trajectory(frames_per_drone, d) for d in range(drones)]
    frames = scene_mod.render(scene, np.stack([p[0][step] for p in paths]),
                              np.stack([p[1][step] for p in paths]), device)
    sync()
    t0 = time.perf_counter()
    X, words, valid = landmarks.build(scene, det, cfg["max_landmarks"], device)
    sync()
    t1 = time.perf_counter()
    opts = common.coloc_config(prog_config, cfg, drones)
    feats = frontend.detect_and_describe_batch(frames, opts.detector)
    mapdb = MapDB(X, words, valid)
    idx = torch.stack([matching.match_with_map(Features(*(t[b] for t in feats)), mapdb,
                                               opts.matcher).idx for b in range(drones)])
    sync()
    t2 = time.perf_counter()
    with pipeline.precision(False):
        ref = judge.reference_frontend(frames, det)
        sync()
        t3 = time.perf_counter()
        out = judge.features(feats.xy, feats.valid, ref, trip.words_to_bits(feats.desc))
        out["matches_differ"] = judge.matches(idx.long(), feats.desc, feats.valid, words, valid,
                                              cfg["matcher"])
        out["matches_by_position"] = judge.matches_by_position(
            feats.xy, feats.valid, idx.long(), ref, words, valid, cfg["matcher"])
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return dict(out, step=step, map_valid=int(valid.sum()),
                keypoints=feats.valid.sum(1).tolist(), matched=(idx >= 0).sum(1).tolist(),
                map_s=t1 - t0, reference_s=t3 - t2, device=name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="a configuration file")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cfg = common.load_json(args.config)
    if not torch.cuda.is_available():
        print("frontend_gap: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    worst: dict = {}
    for s in (int(x) for x in args.seeds.split(",")):
        r = readings(cfg, s, dev)
        print(json.dumps({"seed": s, **r}), flush=True)
        common.merge_max(worst, {k: v for k, v in r.items()
                                 if k not in ("step", "keypoints", "matched", "device")})
    print(json.dumps({"largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
