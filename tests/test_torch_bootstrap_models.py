"""Parity of the port's ColocSession.init_map with coloc_tpu's on the CPU
at three drones (every pair's relative pose, then reconstruct_scene), with
coloc_tpu's minimal samples injected (tests/bootstrap_cases.py). Models F
and H are tests/test_torch_bootstrap_fh.py's.

Scene and sizes are tests/test_session.py's (make_scene seed 3, 240x320, 4
levels, 512 keypoints, 512 landmarks).
"""

import numpy as np
import pytest
import torch

from coloc_tpu.io import synthetic as jsyn

from bootstrap_cases import H, K, W, angle, bootstrap
from port_harness import one_torch_thread, time_limit  # noqa: F401

@pytest.fixture(scope="module")
def three():
    return bootstrap(3, "E")


def test_init_map_three_drones_matches_reference(three):
    """D = 3: landmark slots shared on >= 97% of the valid ones (measured
    110 of 110), every view's rotation within 2e-3 rad and centre within
    1e-2 of coloc_tpu's (measured 1.9e-7 rad and 4.1e-3, the centres
    along their baselines, whose length the BA leaves free), a finite 6x6
    covariance, and the descriptors of the shared slots equal."""
    js, ts, ok, _, _ = three
    assert ok and ts.map_ready and ts.scene.num_views == 3
    jv, tv = np.asarray(js.mapdb.valid), ts.mapdb.valid.numpy()
    assert tv.sum() >= 8 and (jv & tv).sum() / (jv | tv).sum() >= 0.97
    both = jv & tv
    np.testing.assert_array_equal(ts.mapdb.desc.numpy().view(np.uint32)[both],
                                  np.asarray(js.mapdb.desc)[both])
    for r in range(3):
        assert angle(ts.scene.Rs[r].numpy(), np.asarray(js.scene.Rs[r])) < 2e-3
        np.testing.assert_allclose(ts.scene.Cs[r].numpy(), np.asarray(js.scene.Cs[r]),
                                   atol=1e-2)
    ba = ts.bootstrap_ba
    assert ba.cov.shape == (6, 6) and bool(torch.isfinite(ba.cov).all())
    assert ts.lm_support is None and ts.bootstrap_geo.success


def test_three_drone_map_localizes(three):
    """The port's D = 3 map then localizes all three drones on the next
    frame of their trajectories (intra_pose_all, the batched step)."""
    ts = three[1]
    scene = jsyn.make_scene(H, W, K, seed=3)
    images = {}
    for d in range(3):
        Rs, Cs = jsyn.trajectory(2, d)
        images[d] = jsyn.render(scene, Rs[1], Cs[1])
    out = ts.intra_pose_all(images)
    assert all(bool(out[d].success) for d in range(3))
    assert ts.lm_support.shape == (512,) and int(ts.lm_support.sum()) > 0
