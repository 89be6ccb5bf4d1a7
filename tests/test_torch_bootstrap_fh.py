"""Parity of the port's ColocSession.init_map with coloc_tpu's on the CPU
for models F (make_scene seed 3) and H (a one-plane scene, depth 8) at two
drones, with coloc_tpu's minimal samples injected
(tests/bootstrap_cases.py). A file of its own, so that the suite's
workers share it with the three-drone bootstrap.
"""

import numpy as np
import pytest

from bootstrap_cases import angle, bootstrap, dir_angle
from port_harness import one_torch_thread, time_limit  # noqa: F401


@pytest.mark.parametrize("model", ["F", "H"])
def test_init_map_models_match_reference(model):
    """ColocSession(model="F") on the general scene and model="H" on a
    one-plane scene, coloc_tpu's draws injected: inlier counts within 1,
    drone 1's rotation within 1e-3 rad and baseline direction within 5e-3
    rad of coloc_tpu's (measured 1.6e-5 and 2.2e-4, model H), slots shared
    on >= 97% of the valid ones (measured: all), and as close to the
    ground truth as coloc_tpu within 2e-3 rad."""
    js, ts, ok, traj, geos = bootstrap(2, model,
                                        depths=(8.0,) if model == "H" else (6.0, 12.0))
    assert ok and ts.map_ready
    assert abs(int(ts.bootstrap_geo.n_inliers) - int(geos[0].n_inliers)) <= 1
    jv, tv = np.asarray(js.mapdb.valid), ts.mapdb.valid.numpy()
    assert tv.sum() >= 8 and (jv & tv).sum() / (jv | tv).sum() >= 0.97
    Rj, Rt = np.asarray(js.scene.Rs[1]), ts.scene.Rs[1].numpy()
    Cj, Ct = np.asarray(js.scene.Cs[1]), ts.scene.Cs[1].numpy()
    assert angle(Rt, Rj) < 1e-3 and dir_angle(Ct, Cj) < 5e-3
    (R0, C0), (R1, C1) = ((traj[d][0][0], traj[d][1][0]) for d in (0, 1))
    R_gt, C_gt = R1 @ R0.T, R0 @ (C1 - C0)
    assert angle(Rt, R_gt) <= angle(Rj, R_gt) + 2e-3
    assert dir_angle(Ct, C_gt) <= dir_angle(Cj, C_gt) + 2e-3
