"""The port's run_chunked against its own run on the CPU, as
tests/test_session.py holds coloc_tpu's run_chunked against its run
(tests/test_torch_chunked.py holds both against coloc_tpu's).
"""

import numpy as np
import torch

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import session as tsession
from coloc_tpu_torch.io import synthetic as tsyn
from port_harness import one_torch_thread, time_limit  # noqa: F401


def test_run_chunked_matches_run():
    """The port's run_chunked(chunk=2) against its own run from the same
    seed, as tests/test_session.py asks of coloc_tpu: the same frame count,
    success equal, filtered centres within 0.03. On the CPU both step the
    same code with the same draws, so they also agree bit for bit. The
    scene and sizes are tests/test_session.py's (scene seed 3, 240x320, 4
    levels, 512 keypoints, 512 landmarks, 6 frames)."""
    H, W, frames_n = 240, 320, 6
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
    scene = tsyn.make_scene(H, W, K, seed=3)
    frames = {d: [tsyn.render(scene, *(a[f] for a in tsyn.trajectory(frames_n, d)))
                  for f in range(frames_n)] for d in range(2)}
    tc = tcfg.ColocConfig(num_drones=2, max_landmarks=512, detector=tcfg.DetectorOptions(
        width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10))
    s1 = tsession.ColocSession(tc, KS, DISTS, seed=0, device="cpu")
    r1 = s1.run(frames, inter_every=0)
    s2 = tsession.ColocSession(tc, KS, DISTS, seed=0, device="cpu")
    r2 = s2.run_chunked(frames, chunk=2, inter_every=0)
    for d in range(2):
        assert len(r2[d]) == len(r1[d]) == frames_n - 1
        for a, b in zip(r1[d], r2[d]):
            assert bool(a.success) == bool(b.success)
            if bool(a.success):
                np.testing.assert_allclose(a.pose.C.numpy(), b.pose.C.numpy(), atol=0.03)
            for x, y in zip((a.pose.R, a.pose.C, a.cov, a.rmse, a.n_tracks),
                            (b.pose.R, b.pose.C, b.cov, b.rmse, b.n_tracks)):
                assert torch.equal(x, y)
    for x, y in zip(s1.filter_bank, s2.filter_bank):
        assert torch.equal(x, y)
    assert torch.equal(s1.lm_support, s2.lm_support)
