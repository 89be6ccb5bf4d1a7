"""Parity of the port's map update with coloc_tpu on the CPU: update_map
(ColoC::updateMap: a rebuild from the current frames, matched against the
old map and brought to its scale) after a 3-frame two-drone run, with
coloc_tpu's five-point draws injected; and the map-update schedule of run
and run_chunked (update_map_every, auto_update_map with its patience)
against coloc_tpu's, frame by frame, with the sessions' frame steps and
update_map stubbed so that only the schedule runs.

The scene and sizes are tests/test_session.py's (scene seed 3, 240x320, 4
levels, 512 keypoints, 512 landmarks).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu import robust as jrobust
from coloc_tpu import utils as jutils
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.session import ColocSession as JSession

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch import matching as tmatching
from coloc_tpu_torch import utils as tutils
from coloc_tpu_torch.session import ColocSession as TSession
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
DET = dict(width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10)


def _configs():
    return (jcfg.ColocConfig(num_drones=2, detector=jcfg.DetectorOptions(**DET),
                             max_landmarks=512),
            tcfg.ColocConfig(num_drones=2, detector=tcfg.DetectorOptions(**DET),
                             max_landmarks=512))


@pytest.fixture(scope="module")
def updated():
    """coloc_tpu's session after run() over frames 0-2 (bootstrap on 0),
    carried into the port; then update_map on frame 3 on both, coloc_tpu's
    five-point draws injected into the port's. -> (coloc_tpu's session,
    the port's, the port's result, the old map of each)."""
    scene = jsyn.make_scene(H, W, K, seed=3)
    frames = {}
    for d in range(2):
        Rs, Cs = jsyn.trajectory(4, d)
        frames[d] = [jsyn.render(scene, Rs[f], Cs[f]) for f in range(4)]
    jc, tc = _configs()
    js = JSession(jc, KS, DISTS)
    js.run({d: frames[d][:3] for d in range(2)}, inter_every=0)
    ts = TSession(tc, KS, DISTS, device="cpu")
    convert.session_state_from_numpy(js, ts)
    old = js.mapdb
    draws = []
    rel = jrobust.relative_pose_essential

    def rel_rec(key, uv1, uv2, mask, *a):
        draws.append(np.asarray(jransac.sample_indices(key, mask, 256, 5)))
        return rel(key, uv1, uv2, mask, *a)

    images = {d: frames[d][3] for d in range(2)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrobust, "relative_pose_essential", rel_rec)
        assert js.update_map(images)
    old_t = ts.mapdb
    ok = ts.update_map(images, sample_idx=torch.from_numpy(draws[0]))
    return js, ts, ok, old, old_t


def test_update_map_matches_reference(updated):
    """The rebuilt map: slots shared on >= 97% of the valid ones (measured
    69 of 69), the rescaled landmarks and camera centres within 1e-3
    relative (median) and 2e-2 of coloc_tpu's (measured 1.3e-6 and
    1.2e-5), the map object replaced (so the captured step's graphs are
    captured again), and the scale of the new map against the old one
    within 5% of 1 on both (measured 1.0000 from 17 common landmarks):
    the rescale undid the rebuild's own scale."""
    js, ts, ok, old, old_t = updated
    assert ok and ts.map_ready and ts.mapdb is not old_t
    jv, tv = np.asarray(js.mapdb.valid), ts.mapdb.valid.numpy()
    assert tv.sum() >= 8 and (jv & tv).sum() / (jv | tv).sum() >= 0.97
    both = jv & tv
    jX, tX = np.asarray(js.mapdb.X)[both], ts.mapdb.X.numpy()[both]
    rel = np.linalg.norm(tX - jX, axis=1) / np.linalg.norm(jX, axis=1)
    assert np.median(rel) < 1e-3
    np.testing.assert_allclose(ts.scene.Cs.numpy(), np.asarray(js.scene.Cs), atol=2e-2)
    # after the rescale, the new map measured against the old one has scale ~1
    jc, tc = _configs()
    mm = jmatching.match_maps(js.mapdb, old, jc.matcher)
    assert int(np.sum(np.asarray(mm.mask) & jv)) >= 2
    s_j = float(jutils.compute_scale_difference(js.mapdb, old, mm))
    tm = tmatching.match_maps(ts.mapdb, old_t, tc.matcher)
    s_t = float(tutils.compute_scale_difference(ts.mapdb, old_t, tm))
    assert abs(s_t - 1.0) < 0.05 and abs(s_j - 1.0) < 0.05
    assert ts.lm_support is None                 # a wholesale rebuild


def test_update_map_failure_keeps_the_map(updated):
    """A rebuild that fails (blank frames: no features) returns False and
    leaves the map, the scene and the support as they were."""
    ts = updated[1]
    ts._ensure_support()
    db, scene, sup = ts.mapdb, ts.scene, ts.lm_support
    blank = np.zeros((H, W), np.float32)
    assert not ts.update_map({0: blank, 1: blank})
    assert ts.mapdb is db and ts.scene is scene and ts.lm_support is sup


def _stub(sess, success, log, torch_side):
    """Replace a session's frame steps by scripted success flags (frame f:
    success[f] for every drone) and update_map by a recorder of the frame
    it is called on; the map counts as bootstrapped."""
    D = 2

    def res(ok):
        s = torch.tensor(ok) if torch_side else np.bool_(ok)
        return SimpleNamespace(success=s)

    def intra_pose_all(images):
        return {d: res(success[sess.frame]) for d in range(D)}

    def intra_pose_chunk(block):
        F = len(block)
        out = {d: [res(success[sess.frame + i]) for i in range(F)] for d in range(D)}
        sess.frame += F
        return out

    def update_map(images):
        log.append(sess.frame)
        return True

    sess.intra_pose_all = intra_pose_all
    sess.intra_pose_chunk = intra_pose_chunk
    sess.update_map = update_map
    sess.map_ready = True


@pytest.mark.parametrize("entry,kw", [
    ("run", dict(update_map_every=2)),
    ("run", dict(update_map_every=3, auto_update_map=True, auto_update_patience=2)),
    ("run", dict(auto_update_map=True)),
    ("run_chunked", dict(chunk=2, update_map_every=2)),
    ("run_chunked", dict(chunk=2, update_map_every=3)),
    ("run_chunked", dict(chunk=3, auto_update_map=True, auto_update_patience=2)),
    ("run_chunked", dict(chunk=2, update_map_every=4, auto_update_map=True,
                         auto_update_patience=1)),
])
def test_map_update_schedule_matches_reference(entry, kw):
    """The frames on which run / run_chunked call update_map, with the
    frame steps scripted (frames 3-11 dead, the rest localized; 16 frames):
    the port's equal to coloc_tpu's, for update_map_every alone, the auto
    trigger alone and both, per frame (run) and per chunk rounded up
    (run_chunked, the chunk's last frame, dead chunks counted)."""
    success = [True] * 3 + [False] * 9 + [True] * 4
    frames = {d: [np.zeros((2, 2), np.float32)] * len(success) for d in range(2)}
    jc, tc = _configs()
    logs = {}
    for side, sess in (("jax", JSession(jc, KS, DISTS)),
                       ("torch", TSession(tc, KS, DISTS, device="cpu"))):
        logs[side] = []
        _stub(sess, success, logs[side], side == "torch")
        getattr(sess, entry)(frames, inter_every=0, **kw)
    assert logs["torch"] == logs["jax"] and logs["jax"], logs
