"""Parity of the port's map lifecycle with coloc_tpu on the CPU, without
frames: _stamp_new_slots, cull_map and merge_map_from on synthetic maps and
support arrays set identically in both sessions (coloc_tpu's carried into
the port by convert.session_state_from_numpy), and the extend / cull
schedule of run against coloc_tpu's, frame by frame, with the frame step,
update_map, extend_map and cull_map stubbed.

Slots, `valid`, `desc`, `lm_support` and `lm_last_seen` are held exactly;
landmark positions within 1e-5 of their distance from the origin. The
configuration is tests/test_session.py's (512 landmarks).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import update_cases as uc

from coloc_tpu import config as jcfg
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.types import MapDB as JMapDB

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch.session import ColocSession as TSession
from port_harness import one_torch_thread, time_limit  # noqa: F401

L = 512


def _configs(D=2):
    det = dict(width=uc.W, height=uc.H, max_keypoints=512, num_levels=4, fast_threshold=10)
    return (jcfg.ColocConfig(num_drones=D, detector=jcfg.DetectorOptions(**det),
                             max_landmarks=L),
            tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**det),
                             max_landmarks=L))


def _random_map(rng, n_valid):
    """A MapDB in numpy: landmarks in front of the origin, random
    descriptors (pairwise ~256 bits apart), `n_valid` valid slots at
    random."""
    X = rng.uniform(-4.0, 4.0, (L, 3)).astype(np.float32)
    X[:, 2] += 10.0
    desc = rng.integers(0, 2**32, (L, 16), dtype=np.uint64).astype(np.uint32)
    valid = np.zeros(L, bool)
    valid[rng.choice(L, n_valid, replace=False)] = True
    return SimpleNamespace(X=X, desc=desc, valid=valid)


def _sessions(mapdb, frame, support=None, last=None):
    """coloc_tpu's session with this map, frame and support, and the port's
    carried from it."""
    jc, tc = _configs()
    js = JSession(jc, uc.KS, uc.DISTS)
    js.mapdb = JMapDB(X=jnp.asarray(mapdb.X), desc=jnp.asarray(mapdb.desc),
                      valid=jnp.asarray(mapdb.valid))
    js.map_ready, js.frame = True, frame
    js.lm_support = None if support is None else jnp.asarray(support, jnp.int32)
    js.lm_last_seen = None if last is None else jnp.asarray(last, jnp.int32)
    ts = TSession(tc, uc.KS, uc.DISTS, device="cpu")
    convert.session_state_from_numpy(js, ts)
    return js, ts


def _assert_same(js, ts):
    """The two sessions' maps and support: slots, valid, desc, support
    exactly; X within 1e-5 relative."""
    assert np.array_equal(ts.mapdb.valid.numpy(), np.asarray(js.mapdb.valid))
    assert np.array_equal(ts.mapdb.desc.numpy(), np.asarray(js.mapdb.desc).view(np.int32))
    for name in ("lm_support", "lm_last_seen"):
        assert np.array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name))), name
    Xt, Xj = ts.mapdb.X.numpy(), np.asarray(js.mapdb.X)
    assert (np.linalg.norm(Xt - Xj, axis=1) <= 1e-5 * np.linalg.norm(Xj, axis=1)).all()


@pytest.mark.parametrize("planted", [False, True])
def test_stamp_new_slots_matches_reference(planted):
    """Freshly written slots get zero support and the current frame; with
    no support yet, _ensure_support builds it first (valid slots at the
    current frame, free ones at -1)."""
    rng = np.random.default_rng(1)
    db = _random_map(rng, 300)
    sup = rng.integers(0, 20, L) if planted else None
    last = rng.integers(-1, 30, L) if planted else None
    js, ts = _sessions(db, 31, sup, last)
    slots = np.flatnonzero(~db.valid)[:40]
    for s in (js, ts):
        s._stamp_new_slots(slots)
        s._stamp_new_slots([])
    _assert_same(js, ts)
    assert (ts.lm_support.numpy()[slots] == 0).all()
    assert (ts.lm_last_seen.numpy()[slots] == 31).all()


def _cull_case(name):
    """-> (map, frame, support, last seen, cull_map keywords)."""
    rng = np.random.default_rng(2)
    db = _random_map(rng, 200)
    v = np.flatnonzero(db.valid)
    if name == "grace":          # everything created at the current frame
        return db, 10, np.zeros(L, int), np.where(db.valid, 10, -1), dict(max_age=16)
    sup = np.where(db.valid, rng.integers(0, 12, L), 0)
    last = np.where(db.valid, rng.integers(0, 100, L), -1)
    if name == "stale_unproven":
        return db, 100, sup, last, {}
    # every valid slot stale and unproven; support and recency ties planted
    # so that the spare order (support, then recency, then slot) decides
    sup[v] = rng.integers(0, 3, v.size)
    last[v] = rng.integers(0, 3, v.size)
    if name == "keep_min_ties":
        return db, 500, sup, last, dict(max_age=16, min_support=10, keep_min=40)
    if name == "keep_min_spares_all":
        return db, 500, sup, last, dict(max_age=16, min_support=10, keep_min=v.size + 5)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["grace", "stale_unproven", "keep_min_ties",
                                  "keep_min_spares_all"])
def test_cull_map_matches_reference(name):
    """cull_map on planted support: the count, the surviving slots and the
    freed slots' stamps (support 0, lm_last_seen -1) equal coloc_tpu's;
    the map is replaced only when a slot was culled."""
    db, frame, sup, last, kw = _cull_case(name)
    js, ts = _sessions(db, frame, sup, last)
    before = ts.mapdb
    n_j, n_t = js.cull_map(**kw), ts.cull_map(**kw)
    assert n_t == n_j
    _assert_same(js, ts)
    assert (ts.mapdb is before) == (n_t == 0)
    expected = {"grace": 0, "keep_min_spares_all": 0}
    if name in expected:
        assert n_t == expected[name]
    else:
        assert n_t > 0
        freed = db.valid & ~ts.mapdb.valid.numpy()
        assert (ts.lm_last_seen.numpy()[freed] == -1).all()
        assert (ts.lm_support.numpy()[freed] == 0).all()
    if name == "keep_min_ties":
        assert int(ts.mapdb.count) == 40


def _sim3():
    ang = 0.8
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    return 2.5, R, np.array([1.0, -2.0, 0.5])


def _merge_case(name):
    """-> (this map, the other map (numpy), novel slots of the other map
    and their positions in this map's frame)."""
    rng = np.random.default_rng(3)
    db = _random_map(rng, 180)
    if name == "disjoint":
        return db, _random_map(rng, L), np.zeros(0, int), None
    s, R, t = _sim3()
    valid = db.valid.copy()
    n_valid = int(valid.sum())
    n_novel = 16
    X_novel = rng.uniform(-4, 4, (n_novel, 3))
    other = _random_map(rng, 0)
    other.X[:n_valid] = (s * (R @ db.X[valid].T.astype(np.float64))).T + t
    other.X[n_valid:n_valid + n_novel] = (s * (R @ X_novel.T)).T + t
    other.desc[:n_valid] = db.desc[valid]
    # a near copy of a resident descriptor (3 bits flipped): not novel
    other.desc[n_valid + n_novel] = db.desc[valid][0] ^ np.uint32(0b111)
    other.valid[: n_valid + n_novel + 1] = True
    if name in ("few_free", "full"):
        db.valid[np.flatnonzero(~db.valid)[5 if name == "few_free" else 0:]] = True
    return db, other, np.arange(n_valid, n_valid + n_novel), X_novel


@pytest.mark.parametrize("name", ["sim3", "few_free", "disjoint", "full"])
def test_merge_map_from_matches_reference(name):
    """merge_map_from of a Sim(3)-moved copy of the map plus 16 novel
    landmarks (and one near duplicate of a resident descriptor): the
    alignment recovered, the novel landmarks in the first free slots at
    their positions in this map's frame, as coloc_tpu's; with 5 free slots
    only the first 5 novel ones; a disjoint map (no alignment) or a full
    map adds 0 and leaves mapdb the same object."""
    db, other, novel, X_novel = _merge_case(name)
    js, ts = _sessions(db, 7)
    other_j = JMapDB(X=jnp.asarray(other.X), desc=jnp.asarray(other.desc),
                     valid=jnp.asarray(other.valid))
    other_t = convert.mapdb_from_numpy(other, "cpu")
    before_j, before_t = js.mapdb, ts.mapdb
    n_j, n_t = js.merge_map_from(other_j), ts.merge_map_from(other_t)
    assert n_t == n_j
    if name in ("disjoint", "full"):
        assert n_t == 0 and ts.mapdb is before_t and js.mapdb is before_j
        return
    _assert_same(js, ts)
    want = min(novel.size, int((~db.valid).sum()))
    assert n_t == want
    slots = np.flatnonzero(~db.valid)[:want]
    err = np.linalg.norm(ts.mapdb.X.numpy()[slots] - X_novel[:want], axis=1)
    assert err.max() < 1e-2, err.max()
    assert np.array_equal(ts.mapdb.desc.numpy()[slots],
                          other.desc[novel[:want]].view(np.int32))
    assert (ts.lm_last_seen.numpy()[slots] == 7).all()


def _stub(sess, success, log, torch_side):
    """Script a session's frame step (frame f: success[f] for every drone)
    and record the frames of its update_map, extend_map and cull_map; the
    map counts as bootstrapped."""
    def res(ok):
        return SimpleNamespace(success=torch.tensor(ok) if torch_side else np.bool_(ok))

    def intra_pose_all(images):
        return {d: res(success[sess.frame]) for d in range(sess.config.num_drones)}

    def update_map(images):
        log.append(("update", sess.frame))
        return True

    def extend_map(images):
        log.append(("extend", sess.frame))
        return 1

    def cull_map(max_age=64, min_support=8, keep_min=32):
        log.append(("cull", sess.frame, max_age, min_support))
        return 1

    sess.intra_pose_all, sess.update_map = intra_pose_all, update_map
    sess.extend_map, sess.cull_map = extend_map, cull_map
    sess.map_ready = True


@pytest.mark.parametrize("drones,kw", [
    (2, dict(extend_map_every=2)),
    (2, dict(cull_map_every=3)),
    (2, dict(extend_map_every=3, cull_map_every=2, cull_max_age=5, cull_min_support=1)),
    (2, dict(update_map_every=4, extend_map_every=2, cull_map_every=4)),
    (2, dict(auto_update_map=True, auto_update_patience=2, extend_map_every=3,
             cull_map_every=5)),
    (1, dict(extend_map_every=2, cull_map_every=3)),
])
def test_lifecycle_schedule_matches_reference(drones, kw):
    """The frames on which run calls update_map, extend_map and cull_map
    (with cull_map's age and support), the frame steps scripted (frames
    3-11 dead, the rest localized; 16 frames): the port's equal to
    coloc_tpu's for extend and cull alone, together, with a scheduled or
    an automatic rebuild (which takes the frame's place of extend_map:
    the `elif`), and at one drone (no extend)."""
    success = [True] * 3 + [False] * 9 + [True] * 4
    frames = {d: [np.zeros((2, 2), np.float32)] * len(success) for d in range(drones)}
    jc, tc = _configs(drones)
    Ks, dists = np.stack([uc.K] * drones), np.zeros((drones, 3), np.float32)
    logs = {}
    for side, sess in (("jax", JSession(jc, Ks, dists)),
                       ("torch", TSession(tc, Ks, dists, device="cpu"))):
        logs[side] = []
        _stub(sess, success, logs[side], side == "torch")
        sess.run(frames, inter_every=0, **kw)
    assert logs["torch"] == logs["jax"] and logs["jax"], logs
    if drones == 1:
        assert all(e[0] != "extend" for e in logs["jax"])
