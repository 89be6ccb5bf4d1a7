"""The port's ColocSession with the AKAZE backend on the CPU: the D = 2
bootstrap held against coloc_tpu's given the same five-point draws, then
frames of intra_pose_all against the ground truth.

tests/test_session.py's scene and sizes (scene seed 3, 240x320, 4 levels,
512 keypoints, 512 landmarks) with DetectorOptions(backend="akaze") and
Lowe-ratio matching, the reference's CPU configuration. torch cannot
replay jax.random, so the port is handed coloc_tpu's draws.
"""

import jax
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.session import ColocSession as JSession

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch.session import ColocSession as TSession
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, FRAMES = 240, 320, 4
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
DET = dict(width=W, height=H, max_keypoints=512, num_levels=4, backend="akaze")


def _configs():
    return tuple(m.ColocConfig(num_drones=2, detector=m.DetectorOptions(**DET),
                               matcher=m.MatcherOptions(mode="ratio"), max_landmarks=512)
                 for m in (jcfg, tcfg))


def _angle(Ra, Rb):
    """||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), exact near 0."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _dir_angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


@pytest.fixture(scope="module")
def dataset():
    scene = jsyn.make_scene(H, W, K, seed=3)
    frames, gt = {}, {}
    for d in range(2):
        Rs, Cs = jsyn.trajectory(FRAMES, d)
        frames[d] = [jsyn.render(scene, Rs[f], Cs[f]).astype(np.float32)
                     for f in range(FRAMES)]
        gt[d] = (Rs, Cs)
    return frames, gt


@pytest.fixture(scope="module")
def bootstrap(dataset):
    """coloc_tpu's AKAZE session bootstrapped on frame 0, and the port's
    bootstrapped with the five-point draws coloc_tpu's init_map made."""
    frames, _ = dataset
    jc, tc = _configs()
    js = JSession(jc, KS, DISTS)
    key = jax.random.split(js.key)[1]          # the key init_map draws with
    m = jmatching.match_pair(js.detect(frames[0][0]), js.detect(frames[1][0]), jc.matcher)
    draws = np.asarray(jransac.sample_indices(key, m.mask, jc.ransac.num_hypotheses, 5))
    first = {0: frames[0][0], 1: frames[1][0]}
    assert js.init_map(first)
    ts = TSession(tc, KS, DISTS, device="cpu")
    ok = ts.init_map(first, sample_idx=torch.from_numpy(draws.copy()))
    return js, ts, ok


def test_akaze_init_map_matches_reference(bootstrap, dataset):
    """The port bootstraps (>= 8 landmarks, a finite 6x6 covariance) and
    drone 1's rotation and baseline direction lie within 1e-2 rad of
    coloc_tpu's. Not closer: the two AKAZE frontends share >= 98% of
    their keypoints, not all, and a matched pair more or less moves the
    two-view solution (tests/test_torch_bootstrap.py holds the TRIP
    bootstrap, whose features are equal, to 3e-3)."""
    js, ts, ok = bootstrap
    _, gt = dataset
    assert ok and ts.map_ready
    assert int(ts.mapdb.valid.sum()) >= 8
    ba = ts.bootstrap_ba
    assert ba.cov.shape == (6, 6) and bool(torch.isfinite(ba.cov).all())
    Rj, Rt = np.asarray(js.scene.Rs[1]), ts.scene.Rs[1].numpy()
    Cj, Ct = np.asarray(js.scene.Cs[1]), ts.scene.Cs[1].numpy()
    assert _angle(Rj, Rt) < 1e-2 and _dir_angle(Cj, Ct) < 1e-2
    (R0, _), (R1, _) = ((gt[d][0][0], gt[d][1][0]) for d in (0, 1))
    assert np.degrees(_angle(Rt, R1 @ R0.T)) < 1.0


def test_akaze_session_localizes_both_drones(bootstrap, dataset):
    """intra_pose_all on the port's bootstrapped AKAZE session, its own
    RANSAC draws: every frame both drones succeed, within 1 degree of the
    ground truth (tests/test_session.py's measure), and the filter counts
    every accepted update."""
    _, ts, _ = bootstrap
    frames, gt = dataset
    accepted = np.zeros(2, np.int32)
    for f in range(1, FRAMES):
        ts.frame = f
        out = ts.intra_pose_all({d: frames[d][f] for d in range(2)})
        for d in range(2):
            assert bool(out[d].success), (f, d)
            R_gt = gt[d][0][f] @ gt[0][0][0].T
            assert np.degrees(_angle(out[d].pose.R.numpy(), R_gt)) < 1.0, (f, d)
        accepted += (~ts.last_rejected.numpy()).astype(np.int32)
        np.testing.assert_array_equal(ts.filter_bank.steps.numpy(), accepted)
