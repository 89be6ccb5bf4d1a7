"""The AKAZE deployment (portbench/configs/akaze-752x480.json: the
reference's CPU build, AKAZE-MLDB frontend, Lowe-ratio matcher, P3P
AC-RANSAC, pose refinement and covariance, Kalman bank) through the
port's ColocSession.intra_pose_chunk, eagerly on the CPU, held stage by
stage against the benchmark's plain reference (portbench/reference), and
faults planted in the program that the comparison has to catch.

2 drones at 240x320, 512 keypoints, a 1024-slot map made by the reference
frontend from the seeded scene's reference view. torch and numpy only."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from coloc_tpu_torch import config as prog_config
from coloc_tpu_torch import frontend, session
from coloc_tpu_torch.types import MapDB
from portbench import common, faults
from portbench.drivers.session import read_pose_log
from portbench.inputs import landmarks
from portbench.inputs import scene as scene_mod
from portbench.reference import geometry, judge, pipeline, trip

from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, KP, SLOTS, D, F = 240, 320, 512, 1024, 2, 2
SEED = 2 ** 31 + 23
CPU = torch.device("cpu")

# Each number's tolerance, and why. Read on this scene: 0 keypoints, 0
# bits, 0 matches, inliers 0.0098, 0.0002 standard errors, 2.1e-6
# correlation, 3.6e-8 rad, 1.9e-8 m; with the faults, inliers 0.58
# (inliers_halved) and 0.83 m (state_unchanged).
TOLERANCE = {
    # a keypoint differs only where two responses tie to rounding at a
    # suppression or at the k-th place (the reference's Scharr stencils
    # are convolutions, the program's shifted sums)
    "keypoints_differ": 4,
    # a bit flips where two cell means tie to rounding; an orientation that
    # ties flips about half of one keypoint's 486 bits, and one such fits
    "desc_bits_differ": 300,
    # the reference 2-NN of the program's own descriptors: integers, exact
    "matches_differ": 0,
    # P3P in closed form against Grunert's, 32 ladder-ranked hypotheses
    # against the exact NFA: a point at the threshold may flip
    "inliers_differ_share": 0.25,
    # the LM stops at its tolerance in float32, the reference at the Huber
    # optimum in float64
    "pose_sigma_gap": 0.5,
    # the Jacobi 6x6 inverse in float32 against an eigh floored inverse
    # in float64, in correlation units
    "cov_gap": 1.5e-4,
    # the filter in float32 against the reference's in float64
    "filter_gap_rad": 1e-5,
    "filter_gap_m": 1e-5,
}


@pytest.fixture(scope="module")
def deployment():
    """The configuration at this test's size, its cameras, the frames of
    F frame steps of D drones and the reference's map."""
    cfg_json = copy.deepcopy(common.load_json(common.ROOT / "configs" / "akaze-752x480.json"))
    cfg_json["detector"].update(width=W, height=H, max_keypoints=KP)
    cfg_json["max_landmarks"] = SLOTS
    K, dist = common.intrinsics(cfg_json)
    scene = scene_mod.make_scene(H, W, K, common.derive(SEED, "scene"), (6.0, 12.0), 0.45)
    paths = [scene_mod.trajectory(F, d) for d in range(D)]
    Rs = np.stack([p[0] for p in paths], axis=1).reshape(-1, 3, 3)
    Cs = np.stack([p[1] for p in paths], axis=1).reshape(-1, 3)
    frames = scene_mod.render(scene, Rs, Cs, CPU).reshape(F, D, H, W)
    bank = landmarks.build(scene, cfg_json["detector"], SLOTS, CPU)
    return cfg_json, K, dist, frames, bank


def judged(deployment, tmp_path) -> dict:
    """The chunk through the session, then each stage's numbers."""
    cfg_json, K, dist, frames, (X, words, valid) = deployment
    cfg = common.coloc_config(prog_config, cfg_json, D)
    assert (cfg.detector.backend, cfg.matcher.mode) == ("akaze", "ratio")
    Ks, dists = np.stack([K] * D), np.stack([dist] * D)
    sess = session.ColocSession(cfg, Ks, dists, out_dir=str(tmp_path), device=CPU)
    sess.mapdb = MapDB(X.clone(), words.clone(), valid.clone())
    sess.map_ready = True
    draw_seed = common.derive(SEED, "draws")
    sess.generator.manual_seed(draw_seed)
    out = sess.intra_pose_chunk(frames)
    # the uniforms as the session drew them, frame by frame
    gen = torch.Generator().manual_seed(draw_seed)
    draws = [torch.rand((D, cfg.ransac.num_hypotheses, 3), generator=gen) for _ in range(F)]
    # the last frame step's features and head again (the eager step keeps
    # no frame)
    feats = frontend.detect_and_describe_batch(frames[-1], cfg.detector)
    fr, _ = session._step_head(cfg, frames[-1], sess.mapdb, sess._map_bank(), sess.Ks,
                               sess.dists, uniforms=draws[-1])
    sess.close()
    log = read_pose_log(str(tmp_path / "poses.txt"), D)
    assert log["z"].shape[0] == F
    z, cov3, rmse = (torch.as_tensor(log[k]) for k in ("z", "cov3", "rmse"))

    def stacked(attr):
        return torch.stack([torch.stack([getattr(out[d][f], attr) for d in range(D)])
                            for f in range(F)])
    ok = stacked("success")
    Rf = torch.stack([torch.stack([out[d][f].pose.R for d in range(D)]) for f in range(F)])
    Cf = torch.stack([torch.stack([out[d][f].pose.C for d in range(D)]) for f in range(F)])
    det, m = cfg_json["detector"], cfg_json["matcher"]
    numbers = {}
    with pipeline.precision(False):
        ref = judge.reference_frontend(frames[-1], det)
        numbers.update(judge.features(feats.xy, feats.valid, ref,
                                      trip.words_to_bits(feats.desc)))
        numbers["matches_differ"] = judge.matches(fr.idx.long(), feats.desc, feats.valid,
                                                  words, valid, m)
        numbers.update(judge.localize(
            geometry.rot_of(z[-1, :, 3:].double()), z[-1, :, :3].double(),
            stacked("cov")[-1], ok[-1], fr.inliers, fr.X, fr.uv, fr.matched,
            torch.as_tensor(Ks), torch.as_tensor(dists), draws[-1]))
        numbers.update(judge.filtered(Rf, Cf, z, cov3, rmse, ok, cfg_json["filter"]))
    return numbers, int(ok.sum()), int(feats.valid.sum())


def over(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if v > TOLERANCE[k]}


def test_deployment_against_the_reference(deployment, tmp_path):
    numbers, localized, keypoints = judged(deployment, tmp_path)
    assert set(numbers) == set(TOLERANCE)
    assert localized == D * F and keypoints == D * KP
    assert not over(numbers), numbers


@pytest.mark.parametrize("fault", ["inliers_halved", "state_unchanged"])
def test_planted_fault_fails(deployment, tmp_path, fault):
    """Every other inlier dropped where RANSAC answers, or the filter bank
    left as it was: the stage's number leaves its tolerance."""
    with faults.planted(fault):
        numbers, _, _ = judged(deployment, tmp_path)
    hit = {"inliers_halved": "inliers_differ_share", "state_unchanged": "filter_gap_m"}[fault]
    assert hit in over(numbers), numbers
