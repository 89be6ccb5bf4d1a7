"""Cases shared by the tests of the port's session plumbing (logs,
checkpoints, debug output, the live view): a small rendered frame, a
session that localizes it without a bootstrap, and seeded step outputs.
numpy and the port only; the tests bring coloc_tpu where they compare.

The frame is tests/test_liveviz.py's scene (96x128, seed 2) rendered at
the identity pose; the session's map is synthetic.consistent_mapdb of the
port's own features of it (their bearings at random depths, plus random
landmarks), so the frame localizes at the identity on the CPU in ~0.1 s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch.frontend import detect_and_describe
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.session import ColocSession

H, W = 96, 128
K = np.array([[80.0, 0, 64], [0, 80.0, 48], [0, 0, 1]], np.float32)
DET = dict(width=W, height=H, max_keypoints=128, num_levels=2, fast_threshold=10)
LANDMARKS = 256


def config(D: int = 2) -> tcfg.ColocConfig:
    return tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**DET),
                            max_landmarks=LANDMARKS)


def cameras(D: int = 2):
    return np.stack([K] * D), np.zeros((D, 3), np.float32)


@functools.lru_cache(maxsize=None)
def scene():
    return synthetic.make_scene(H, W, K, seed=2)


@functools.lru_cache(maxsize=None)
def frame() -> np.ndarray:
    """The scene at the identity pose, float32 (H, W)."""
    return synthetic.render(scene(), np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def map_arrays():
    """The consistent map of the frame's features (reference layout)."""
    feats = convert.to_numpy(detect_and_describe(torch.from_numpy(frame()),
                                                 config().detector))
    return synthetic.consistent_mapdb(feats, K, LANDMARKS, np.random.default_rng(5))


def session(D: int = 2, **kw) -> ColocSession:
    """A CPU session whose map localizes frame() at the identity."""
    s = ColocSession(config(D), *cameras(D), device="cpu", **kw)
    s.mapdb = convert.mapdb_from_numpy(map_arrays(), "cpu")
    s.map_ready = True
    return s


def rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """n random rotations (n, 3, 3) float32, angles well away from 0."""
    w = rng.normal(size=(n, 3)) * 0.8
    return so3.exp(torch.from_numpy(w.astype(np.float32))).numpy()


def spd(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """n random symmetric positive definite (k, k) float32 matrices."""
    a = rng.normal(size=(n, k, k)).astype(np.float32) * 0.1
    return (a @ a.transpose(0, 2, 1) + 1e-2 * np.eye(k, dtype=np.float32)).astype(np.float32)


def step_outputs(rng: np.random.Generator, D: int) -> dict:
    """One frame's seeded step outputs of D drones, numpy: the unfiltered
    pose (R, C), its 6x6 covariance, rmse, n_tracks, success, the filter
    covariance P, the filtered pose (fR, fC), the gate distance and the
    Euler angles of R."""
    R = rotations(rng, D)
    return dict(
        R=R, C=rng.normal(size=(D, 3)).astype(np.float32), cov=spd(rng, D, 6),
        rmse=rng.uniform(0.1, 2.0, D).astype(np.float32),
        n_tracks=rng.integers(10, 500, D).astype(np.int32),
        success=rng.uniform(size=D) < 0.8, P=spd(rng, D, 6), fR=rotations(rng, D),
        fC=rng.normal(size=(D, 3)).astype(np.float32),
        dist_g=rng.uniform(0.0, 20.0, D).astype(np.float32),
        rejected=rng.uniform(size=D) < 0.2,
        eulers=so3.rot_to_euler(torch.from_numpy(R)).numpy())
