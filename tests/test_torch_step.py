"""Parity of the port's drone-batched frame step and its one-drone step
with coloc_tpu on the CPU: intra_all_device_step at D = 3 (one P3P batch
of 3 x 256 samples, one ladder rank over a drone axis, one LM with a done
mask per drone) against coloc_tpu's vmapped _intra_all_device_step, and
ColocSession.intra_pose against coloc_tpu's (its fused one-drone step).

The frames are three views of the bench scene family (make_scene seed 1 at
240x320, 4 levels, 256 keypoints) against a 512-landmark map consistent
with a view near them, a quarter of the matched landmarks moved. torch
cannot replay jax.random, so each drone is handed coloc_tpu's own RANSAC
draws (coloc_tpu.ransac.sample_indices with the drone's key and mask).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu import session as jsession
from coloc_tpu import types as jtypes
from coloc_tpu.frontend import detect_and_describe as j_detect
from coloc_tpu.frontend import detect_and_describe_batch as j_detect_batch
from coloc_tpu.fusion import kalman as jkalman
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.ops import hamming as jhamming

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch import session as tsession
from coloc_tpu_torch.fusion import kalman as tkalman
from coloc_tpu_torch.io import synthetic as tsyn
from coloc_tpu_torch.matching import pack_map_bank
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, LEVELS, KP, L, D = 240, 320, 4, 256, 512, 3
K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K] * D), np.zeros((D, 3), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _det(mod):
    return mod.DetectorOptions(width=W, height=H, max_keypoints=KP, num_levels=LEVELS,
                               fast_threshold=12)


@pytest.fixture(scope="module")
def inputs():
    """Three drones' frames (2 cm right, 5 cm right, 4 cm up of the view
    the map was made from) and the map. At the map's own view every
    residual is float32 rounding (rmse 1e-5 px), where the adaptive
    threshold's count is decided by rounding (measured 191 against
    coloc_tpu's 189 there, before this port's drone axis too: ROADMAP C8),
    so no drone sits there."""
    scene = jsyn.make_scene(H, W, K, seed=1)
    eye = np.eye(3, dtype=np.float32)
    base = jsyn.render(scene, eye, np.zeros(3, np.float32)).astype(np.float32)
    images = np.stack([jsyn.render(scene, eye, np.asarray(c, np.float32))
                       for c in ((0.02, 0, 0), (0.05, 0, 0), (0, 0.04, 0))]).astype(np.float32)
    jc = jcfg.ColocConfig(num_drones=D, detector=_det(jcfg))
    feats = j_detect_batch(jnp.asarray(images), jc.detector)
    f0 = jax.tree_util.tree_map(np.asarray, j_detect(jnp.asarray(base), jc.detector))
    ma = tsyn.consistent_mapdb(f0, K, L, np.random.default_rng(0))
    X = ma.X.copy()
    X[:KP // 4] = np.random.default_rng(1).uniform(-50, 50, (KP // 4, 3))
    ma = ma._replace(X=X.astype(np.float32))
    jmapdb = jtypes.MapDB(X=jnp.asarray(ma.X), desc=jnp.asarray(ma.desc),
                          valid=jnp.asarray(ma.valid))
    return jc, images, ma, jmapdb, feats


def _tols(dn, tol):
    """Per drone: 1e-4 while its inlier counts have agreed, 5e-3 from a
    differing count on (test_torch_bootstrap.py's intra_pose_all test: one
    borderline inlier moves a pose by up to ~2e-3, measured 5.6e-4 and
    6.9e-4 here, and the filter carries it)."""
    return np.where(dn == 0, tol, 5e-3)


def test_batched_step_matches_reference(inputs):
    """Two frames of the D = 3 step at test_torch_session.py's tolerances:
    success equal, n_tracks within one borderline inlier a drone (ROADMAP
    C8) and support counts within those, poses, filter state, Euler angles
    to 1e-4 (5e-3 for a drone once its count differed, _tols), gate
    decisions and accepted-update counts equal."""
    jc, images, ma, jmapdb, jfeats = inputs
    jbank = jmatching.pack_map_bank(jmapdb)
    keys = jax.random.split(jax.random.PRNGKey(4), D)
    q, qv = jfeats.desc.reshape(D * KP, -1), jfeats.valid.reshape(-1)
    mm = jmatching._accept(*jhamming.hamming_2nn_bank(q, qv, jbank), qv,
                           jc.matcher, jc.matcher.margin_threshold)
    corr = (mm.idx >= 0).reshape(D, KP) & jfeats.valid
    draws = np.stack([np.asarray(jransac.sample_indices(keys[d], corr[d],
                                                        jc.ransac.num_hypotheses, 3))
                      for d in range(D)])
    tc = tcfg.ColocConfig(num_drones=D, detector=_det(tcfg))
    tmapdb = convert.mapdb_from_numpy(ma, "cpu")
    tbank = pack_map_bank(tmapdb)
    jfb, tfb = jkalman.init(D, jc.filter), tkalman.init(D, tc.filter, "cpu")
    tol = np.full(D, 1e-4)
    for _ in range(2):
        jpwc, jfb, jfilt, jdist, jrej, jeul, jsup = jsession._intra_all_device_step(
            jc, keys, jnp.asarray(images), jmapdb, jbank, jnp.asarray(KS),
            jnp.asarray(DISTS), jfb)
        tpwc, tfb, tfilt, tdist, trej, teul, tsup = tsession.intra_all_device_step(
            tc, _t(images), tmapdb, tbank, _t(KS), _t(DISTS), tfb, sample_idx=_t(draws))
        np.testing.assert_array_equal(tpwc.success.numpy(), np.asarray(jpwc.success))
        assert tpwc.success.all()
        dn = np.abs(tpwc.n_tracks.numpy() - np.asarray(jpwc.n_tracks))
        assert dn.max() <= 1, dn
        tol = _tols(dn, tol)
        for a, b in ((tpwc.pose.R, jpwc.pose.R), (tpwc.pose.C, jpwc.pose.C),
                     (tfb.x, jfb.x), (tfilt.C, jfilt.C), (teul, jeul)):
            err = np.abs(a.numpy() - np.asarray(b)).reshape(D, -1).max(axis=1)
            assert (err <= tol).all(), (err, tol)
        assert np.abs(tsup.numpy() - np.asarray(jsup)).sum() <= 4 * D
        np.testing.assert_array_equal(trej.numpy(), np.asarray(jrej))
        np.testing.assert_array_equal(tfb.steps.numpy(), np.asarray(jfb.steps))
        np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), rtol=1e-3, atol=1e-4)
    assert not tsup[:KP // 4].any()          # moved landmarks are never inliers
    np.testing.assert_array_equal(tfb.steps.numpy(), [2] * D)


def test_intra_pose_matches_reference(inputs):
    """ColocSession.intra_pose on drones 2, 0 and 2 again, the port handed
    the draws coloc_tpu's intra_pose makes from its key: success equal,
    n_tracks within 1, the filtered pose at _tols' tolerances, the
    covariance and rmse, the one drone's filter updated and the others
    untouched, the support counts and last_pose kept."""
    jc, images, ma, jmapdb, _ = inputs
    js = jsession.ColocSession(jc, KS, DISTS)
    js.mapdb, js.map_ready = jmapdb, True
    tc = tcfg.ColocConfig(num_drones=D, detector=_det(tcfg))
    ts = tsession.ColocSession(tc, KS, DISTS, device="cpu")
    ts.mapdb, ts.map_ready = convert.mapdb_from_numpy(ma, "cpu"), True
    tol = np.full(D, 1e-4)
    for step, d in enumerate((2, 0, 2)):
        js.frame = ts.frame = step
        key = jax.random.split(js.key)[1]          # the key intra_pose draws with
        feats = j_detect(jnp.asarray(images[d]), jc.detector)
        m = jmatching.match_with_map(feats, jmapdb, jc.matcher, bank=js._map_bank())
        draw = np.asarray(jransac.sample_indices(key, (m.idx >= 0) & feats.valid,
                                                 jc.ransac.num_hypotheses, 3))
        j = js.intra_pose(d, images[d])
        t = ts.intra_pose(d, images[d], sample_idx=_t(draw))
        assert bool(t.success) == bool(j.success) and bool(t.success)
        dn = abs(int(t.n_tracks) - int(j.n_tracks))
        assert dn <= 1
        tol[d] = _tols(dn, tol[d])
        for a, b in ((t.pose.R, j.pose.R), (t.pose.C, j.pose.C)):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= tol[d]
        # the step's covariance and rmse on the same inliers as
        # test_torch_localize.py holds them; one inlier more or less moves
        # them by 3.1e-2 and 9.2e-3 here (measured)
        jcov = np.asarray(j.cov)
        cov_tol, rmse_tol = (1e-2, 1e-3) if dn == 0 else (5e-2, 2e-2)
        assert np.linalg.norm(t.cov.numpy() - jcov) <= cov_tol * np.linalg.norm(jcov)
        assert abs(float(t.rmse) - float(j.rmse)) < rmse_tol
        np.testing.assert_array_equal(ts.filter_bank.steps.numpy(),
                                      np.asarray(js.filter_bank.steps))
        err = np.abs(ts.filter_bank.x.numpy() - np.asarray(js.filter_bank.x)).max(axis=1)
        assert (err <= tol).all(), (err, tol)
        assert np.abs(ts.lm_support.numpy() - np.asarray(js.lm_support)).sum() <= 2 * (step + 1)
        assert ts.last_pose[d] is t
    np.testing.assert_array_equal(ts.filter_bank.steps.numpy(), [1, 0, 2])
    assert int((ts.lm_last_seen.numpy() == 2).sum()) > 0
