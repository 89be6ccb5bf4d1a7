"""The reference side follows the configuration's detector backend: the
KORAL configuration's map and bounds are those of the TRIP reference
called directly, and an AKAZE detector group, held in memory and in no
file, goes through the frontend, the map and the bounds."""

from __future__ import annotations

import copy

import numpy as np
import torch

from portbench import common, roofline
from portbench.inputs import landmarks
from portbench.inputs import scene as scene_mod
from portbench.reference import judge, trip

CPU = torch.device("cpu")


def small(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["detector"].update(width=320, height=240, max_keypoints=256)
    return cfg


def scene_of(cfg: dict, seed: int):
    K, _ = common.intrinsics(cfg)
    det = cfg["detector"]
    return scene_mod.make_scene(det["height"], det["width"], K, seed, (6.0, 12.0), 0.45)


def koral():
    return common.load_json(common.ROOT / "configs" / "koral-752x480.json")


def test_koral_map_is_trips(cpu_threads):
    cfg = small(koral())
    det = cfg["detector"]
    scene = scene_of(cfg, 11)
    X, words, valid = landmarks.build(scene, det, 512, CPU)
    view = scene_mod.render(scene, np.eye(3, dtype=np.float32)[None],
                            np.zeros((1, 3), np.float32), CPU)
    kp = trip.describe(view, det["num_levels"], det["scale_factor"], 512, det["fast_threshold"],
                       det["border"], det["smoothing_radius"])
    assert torch.equal(valid, kp.valid[0])
    assert torch.equal(words, trip.bits_to_words(kp.bits[0]))
    xy = kp.xy[0].double().numpy()
    Z = scene_mod.plane_depth(scene, xy)
    Xw = (np.linalg.inv(np.asarray(scene.K, np.float64)) @ np.c_[xy, np.ones(len(xy))].T).T
    Xw = np.where(kp.valid[0].numpy()[:, None], Xw * Z[:, None], 0.0)
    assert torch.equal(X, torch.as_tensor(Xw, dtype=torch.float32))
    ref = judge.reference_frontend(view, det)
    direct = trip.describe(view, det["num_levels"], det["scale_factor"], det["max_keypoints"],
                           det["fast_threshold"], det["border"], det["smoothing_radius"])
    assert all(torch.equal(a, b) for a, b in zip(ref, direct))


def test_koral_bounds_are_trips():
    cfg = koral()
    det = cfg["detector"]
    for frames in (2, 64):
        assert roofline.step_bounds(cfg, frames, 256) == roofline.trip_step(
            frames, det["height"], det["width"], det["num_levels"], det["scale_factor"],
            det["max_keypoints"], cfg["max_landmarks"], 256)


def test_akaze_detector_needs_no_file(cpu_threads):
    cfg = small(koral())
    cfg["detector"].update(backend="akaze", max_keypoints=128)
    cfg["matcher"] = {"mode": "ratio", "dist_ratio": 0.8}
    det = cfg["detector"]
    scene = scene_of(cfg, 12)
    view = scene_mod.render(scene, np.eye(3, dtype=np.float32)[None],
                            np.zeros((1, 3), np.float32), CPU)
    kp = judge.reference_frontend(view, det)
    assert kp.xy.shape == (1, 128, 2) and kp.bits.shape == (1, 128, 512)
    assert bool(kp.valid.all()) and not bool(kp.bits[..., 486:].any())
    X, words, valid = landmarks.build(scene, det, 256, CPU)
    assert X.shape == (256, 3) and words.shape == (256, 16) and int(valid.sum()) == 256
    assert judge.matches_by_position(kp.xy, kp.valid, torch.full((1, 128), -1), kp, words,
                                     valid, cfg["matcher"]) >= 0
    assert common.akaze_params(det) == (4, 4, 0.25, 4)
    b = roofline.step_bounds(cfg, 2, 256)
    assert b == roofline.akaze_step(2, 240, 320, 4, 4, 128, cfg["max_landmarks"], 256, 4)
    assert set(b) == {"k2nn", "p3p", "ransac_rank", "fed_octave", "sample_raster"}
    assert set(b) <= set(roofline.KERNELS)
