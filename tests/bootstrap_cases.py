"""coloc_tpu's init_map with its minimal samples recorded (its
_next_key() draws, around its robust calls) and the port's with the same
samples injected, shared by tests/test_torch_bootstrap_models.py (three
drones) and tests/test_torch_bootstrap_fh.py (models F and H).

Scenes and sizes are tests/test_session.py's (240x320, 4 levels, 512
keypoints, 512 landmarks).
"""

import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import ransac as jransac
from coloc_tpu import robust as jrobust
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.session import ColocSession as JSession

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch.session import ColocSession as TSession

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
DET = dict(width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10)
SAMPLE = {"E": 5, "F": 7, "H": 4}
ROBUST = {"E": "relative_pose_essential", "F": "relative_pose_fundamental",
          "H": "relative_pose_homography"}


def angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def dir_angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


def bootstrap(D, model, depths=(6.0, 12.0), seed=3):
    """coloc_tpu's init_map on frame 0 of D drones with `model`, its
    relative-pose and P3P draws recorded, and the port's with the same
    draws. -> (coloc_tpu's session, the port's, the port's init_map result,
    the ground-truth poses of frame 0)."""
    scene = jsyn.make_scene(H, W, K, seed=seed, depths=depths)
    traj = [jsyn.trajectory(1, d) for d in range(D)]
    images = {d: jsyn.render(scene, traj[d][0][0], traj[d][1][0]) for d in range(D)}
    jc = jcfg.ColocConfig(num_drones=D, detector=jcfg.DetectorOptions(**DET),
                          max_landmarks=512, model=model)
    tc = tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**DET),
                          max_landmarks=512, model=model)
    js = JSession(jc, np.stack([K] * D), np.zeros((D, 3), np.float32))
    pairs, resections = [], []
    rel, p3p = getattr(jrobust, ROBUST[model]), jrobust.absolute_pose_p3p

    def rel_rec(key, uv1, uv2, mask, *a):
        out = rel(key, uv1, uv2, mask, *a)
        pairs.append((np.asarray(jransac.sample_indices(key, mask, 256, SAMPLE[model])), out))
        return out

    def p3p_rec(key, X, uv, mask, *a):
        resections.append(np.asarray(jransac.sample_indices(key, mask, 256, 3)))
        return p3p(key, X, uv, mask, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrobust, ROBUST[model], rel_rec)
        mp.setattr(jrobust, "absolute_pose_p3p", p3p_rec)
        assert js.init_map(images)
    ts = TSession(tc, np.stack([K] * D), np.zeros((D, 3), np.float32), device="cpu")
    if D == 2:
        ok = ts.init_map(images, sample_idx=torch.from_numpy(pairs[0][0]))
    else:
        keys = [(a, b) for a in range(D) for b in range(a + 1, D)]
        ok = ts.init_map(images, sample_idx={p: torch.from_numpy(x[0]) for p, x in zip(keys, pairs)},
                         resection_idx=[torch.from_numpy(r) for r in resections])
    return js, ts, ok, traj, [geo for _, geo in pairs]
