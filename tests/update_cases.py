"""The scene, configuration and update_map recorder shared by the port's
real-rebuild run tests (tests/test_torch_update_run.py and
tests/test_torch_update_auto.py), numpy and the port only.

The scene and sizes are tests/test_session.py's (scene seed 3, 240x320, 4
levels, 512 keypoints, 512 landmarks).
"""

import numpy as np

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch.io import synthetic as syn

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
CFG = tcfg.ColocConfig(num_drones=2, detector=tcfg.DetectorOptions(
    width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10),
    max_landmarks=512)


def frames(n):
    """n rendered frames of drones 0 and 1 of synthetic.trajectory."""
    scene = syn.make_scene(H, W, K, seed=3)
    out = {}
    for d in range(2):
        Rs, Cs = syn.trajectory(n, d)
        out[d] = [syn.render(scene, Rs[f], Cs[f]) for f in range(n)]
    return out


def recording(sess):
    """Record the frame and the result of each of the session's
    update_map calls, with the map before and after it."""
    log = []
    real = sess.update_map

    def update_map(images, **kw):
        before = sess.mapdb
        ok = real(images, **kw)
        log.append((sess.frame, ok, before, sess.mapdb))
        return ok

    sess.update_map = update_map
    return log
