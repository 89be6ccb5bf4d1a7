"""Parity of the port's extend_map with coloc_tpu on the CPU, and the
lifecycle driven by the port's run.

One bootstrap: the port's init_map on frame 0 of drones 0 and 1, its map
handed to a coloc_tpu session (extend_map reads nothing else of the
bootstrap). coloc_tpu's extend_map on frame 3 records its P3P draws (its
`_next_key()` draws, around `sfm/localize.localize_image`), and the port's
extend_map replays them. The scene and sizes are tests/test_session.py's
(scene seed 3, 240x320, 4 levels, 512 keypoints, 512 landmarks), from
tests/update_cases.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import update_cases as uc

from coloc_tpu import config as jcfg
from coloc_tpu import ransac as jransac
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.sfm import localize as jlocalize
from coloc_tpu.types import MapDB as JMapDB

from coloc_tpu_torch import convert
from coloc_tpu_torch.session import ColocSession as TSession
from port_harness import one_torch_thread, time_limit  # noqa: F401

EXTEND_FRAME = 3


def _jconfig():
    return jcfg.ColocConfig(num_drones=2, detector=jcfg.DetectorOptions(
        width=uc.W, height=uc.H, max_keypoints=512, num_levels=4, fast_threshold=10),
        max_landmarks=512)


def _carried(state):
    """A port session with the bootstrap `state` (session_state_from_numpy)."""
    sess = TSession(uc.CFG, uc.KS, uc.DISTS, device="cpu")
    convert.session_state_from_numpy(state, sess)
    return sess


@pytest.fixture(scope="module")
def extended():
    """The port's bootstrap, then extend_map on EXTEND_FRAME in coloc_tpu
    (draws recorded) and in the port (draws replayed). -> namespace of the
    frames, the bootstrap state, the map before, both maps after and both
    counts."""
    frames = uc.frames(5)
    ts = TSession(uc.CFG, uc.KS, uc.DISTS, device="cpu")
    assert ts.init_map({d: frames[d][0] for d in range(2)})
    ts.frame = EXTEND_FRAME
    state = SimpleNamespace(
        mapdb=convert.to_numpy(ts.mapdb), scene=convert.to_numpy(ts.scene),
        filter_bank=convert.to_numpy(ts.filter_bank), lm_support=None,
        lm_last_seen=None, last_pose={}, frame=ts.frame, map_ready=True)
    before = state.mapdb

    js = JSession(_jconfig(), uc.KS, uc.DISTS)
    js.mapdb = JMapDB(*(jnp.asarray(a) for a in before))
    js.map_ready, js.frame = True, EXTEND_FRAME
    draws = []
    real = jlocalize.localize_image

    def localize_rec(key, f, mm, *a):
        draws.append(np.asarray(jransac.sample_indices(key, mm.mask & f.valid, 256, 3)))
        return real(key, f, mm, *a)

    images = {d: frames[d][EXTEND_FRAME] for d in range(2)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlocalize, "localize_image", localize_rec)
        added_j = js.extend_map(images)
    added_t = ts.extend_map(images, sample_idx=torch.from_numpy(np.stack(draws)))
    return SimpleNamespace(frames=frames, state=state, before=before, js=js, ts=ts,
                           added_j=added_j, added_t=added_t)


def test_extend_map_matches_reference(extended):
    """The slots extend_map filled: the same sets in both packages up to
    Jaccard 0.98 (measured 1.0, 67 of 67), the landmarks within 1e-3 of
    their distance from the origin on the common slots (measured 2.1e-4,
    1.8e-3 m at 16 m), the descriptors and support stamps equal there.
    Not exact: the keypoints agree to 6e-5 px (the subpixel step's
    float32 rounding) and P3P's float32 rounding differs between XLA:CPU
    and torch (ROADMAP C8); from the same draws and the same 17 inliers
    drone 1's refined pose ends 3.7e-4 m apart on that flat objective,
    and the triangulated points move with it."""
    e = extended
    assert e.added_t > 0 and e.added_j > 0
    new_j = np.asarray(e.js.mapdb.valid) & ~e.before.valid
    new_t = e.ts.mapdb.valid.numpy() & ~e.before.valid
    assert new_j.sum() == e.added_j and new_t.sum() == e.added_t
    both = new_j & new_t
    assert both.sum() / (new_j | new_t).sum() >= 0.98
    Xt, Xj = e.ts.mapdb.X.numpy()[both], np.asarray(e.js.mapdb.X)[both]
    assert (np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)).max() < 1e-3
    desc_j = np.asarray(e.js.mapdb.desc).view(np.int32)
    assert np.array_equal(e.ts.mapdb.desc.numpy()[both], desc_j[both])
    for name in ("lm_support", "lm_last_seen"):
        assert np.array_equal(getattr(e.ts, name).numpy()[both],
                              np.asarray(getattr(e.js, name))[both]), name
    assert (e.ts.lm_last_seen.numpy()[new_t] == EXTEND_FRAME).all()
    # the old slots are untouched
    old = e.before.valid
    assert np.array_equal(e.ts.mapdb.X.numpy()[old], e.before.X[old])


def test_extend_map_grows_a_map_that_localizes(extended):
    """tests/test_session.py's growth checks on the port: finite new
    landmarks inside the |Z| gate, the next frame localized by both
    drones, and the same frames again adding under a quarter as many."""
    e = extended
    ts = _carried(e.state)
    ts.frame = EXTEND_FRAME
    images = {d: e.frames[d][EXTEND_FRAME] for d in range(2)}
    added = ts.extend_map(images)
    assert added > 0 and int(ts.mapdb.count) == int(e.before.valid.sum()) + added
    X = ts.mapdb.X.numpy()[ts.mapdb.valid.numpy()]
    assert np.isfinite(X).all() and (np.abs(X[:, 2]) < 1000).all()
    res = ts.intra_pose_all({d: e.frames[d][EXTEND_FRAME + 1] for d in range(2)})
    assert all(bool(res[d].success) for d in range(2))
    assert ts.extend_map(images) < max(1, added // 4)


def test_extend_map_respects_capacity(extended):
    """A full map cannot grow: 0, and the map stays the same object."""
    e = extended
    ts = _carried(e.state)
    full = ts.mapdb._replace(valid=torch.ones_like(ts.mapdb.valid))
    ts.mapdb = full
    assert ts.extend_map({d: e.frames[d][EXTEND_FRAME] for d in range(2)}) == 0
    assert ts.mapdb is full


def test_run_extends_and_culls(extended):
    """The port's run over frames 1-4 from the bootstrap (run's frames 0-3)
    with extend_map_every=2, cull_map_every=1, cull_max_age=1 and
    cull_min_support=1: extend_map on frames 0 and 2, then cull_map, on
    every frame, after it; the map grows, landmarks without an inlier for
    two frames are culled, and every frame localizes both drones."""
    e = extended
    ts = _carried(e.state)
    ts.frame = 0
    log = []
    real_extend, real_cull = ts.extend_map, ts.cull_map

    def extend_map(images, **kw):
        log.append(("extend", ts.frame, real_extend(images, **kw)))
        return log[-1][2]

    def cull_map(**kw):
        log.append(("cull", ts.frame, real_cull(**kw)))
        return log[-1][2]

    ts.extend_map, ts.cull_map = extend_map, cull_map
    out = ts.run({d: e.frames[d][1:5] for d in range(2)}, inter_every=0, extend_map_every=2,
                 cull_map_every=1, cull_max_age=1, cull_min_support=1)
    assert [(k, f) for k, f, _ in log] == [("extend", 0), ("cull", 0), ("cull", 1),
                                           ("extend", 2), ("cull", 2), ("cull", 3)]
    assert sum(n for k, _, n in log if k == "extend") > 0
    assert sum(n for k, _, n in log if k == "cull") > 0
    assert all(bool(p.success) for d in range(2) for p in out[d])
