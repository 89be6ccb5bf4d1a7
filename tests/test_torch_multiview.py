"""Parity of the port's D > 2 reconstruction with coloc_tpu on the CPU:
build_tracks (the port's copy of the union-find) exactly on
tests/test_sfm.py-style match chains, and reconstruct_scene from
coloc_tpu's own features, matches and pair geometries at D = 4 (the host
steps, P3P resection and the BA; no frontend on the port's side), with
coloc_tpu's resection draws injected.

The scene is tests/test_session.py's four-drone one (make_scene seed 5,
240x320, 4 levels, 512 keypoints, 512 landmarks). coloc_tpu's
ColocSession.init_map runs once (module scope) with its relative-pose and
P3P calls recorded, so that the port can be handed the same inputs and the
same minimal samples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu import robust as jrobust
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.sfm import tracks as jtracks

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch.geometry import camera as tcam
from coloc_tpu_torch.session import ColocSession as TSession
from coloc_tpu_torch.sfm import reconstruct as trec
from coloc_tpu_torch.sfm import tracks as ttracks
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, D = 240, 320, 4
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
DET = dict(width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10)


def _angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _chain(seed, views, cap, n_chains):
    """Random chains of matches over `views` views: each chain a random
    subset of views, feature indices distinct per view, plus a few
    conflicting matches (two features of one view into one track)."""
    rng = np.random.default_rng(seed)
    pm = {(a, b): np.full(cap, -1) for a in range(views) for b in range(a + 1, views)}
    feats = [rng.permutation(cap) for _ in range(views)]
    used = [0] * views
    for _ in range(n_chains):
        vs = sorted(rng.choice(views, rng.integers(2, views + 1), replace=False))
        ids = []
        for v in vs:
            ids.append(feats[v][used[v]])
            used[v] += 1
        for (a, fa), (b, fb) in zip(zip(vs, ids), zip(vs[1:], ids[1:])):
            pm[(a, b)][fa] = fb
    for (a, b), idx in pm.items():          # conflicts: a second feature of a
        free = np.flatnonzero(idx < 0)[:2]  # into a matched feature of b
        hit = np.flatnonzero(idx >= 0)
        if len(hit) and len(free):
            idx[free[0]] = idx[hit[0]]
    return pm


@pytest.mark.parametrize("case", ["chain", "inconsistent", "pairwise", "random3",
                                  "random4", "capacity"])
def test_build_tracks_equals_reference(case):
    """The port's tracks module against coloc_tpu's: the table and valid
    flags exactly equal, on tests/test_sfm.py's three cases and on random
    chains over 3 and 4 views with conflicts, and with max_tracks below
    the number of tracks."""
    if case == "chain":
        m01, m12 = np.full(8, -1), np.full(8, -1)
        m01[2], m12[5] = 5, 3
        args = ({(0, 1): m01, (1, 2): m12}, 3, 8, 16)
    elif case == "inconsistent":
        m01 = np.full(8, -1)
        m01[1] = m01[2] = 4
        args = ({(0, 1): m01}, 2, 8, 16)
    elif case == "pairwise":
        m01 = np.full(8, -1)
        m01[0], m01[3] = 1, 6
        args = ({(0, 1): m01}, 2, 8, 16)
    elif case == "capacity":
        args = (_chain(7, 4, 64, 40), 4, 64, 10)
    else:
        views = int(case[-1])
        args = (_chain(views, views, 64, 40), views, 64, 64)
    want = jtracks.build_tracks(*args)
    got = ttracks.build_tracks(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum() > 0 or case == "inconsistent"


@pytest.fixture(scope="module")
def reference():
    """coloc_tpu's four-drone init_map on frame 0, with the key and mask of
    every relative-pose and P3P call, and each pair's geometry."""
    scene = jsyn.make_scene(H, W, K, seed=5)
    frames = {}
    for d in range(D):
        Rs, Cs = jsyn.trajectory(2, d)
        frames[d] = [jsyn.render(scene, Rs[f], Cs[f]) for f in range(2)]
    jc = jcfg.ColocConfig(num_drones=D, detector=jcfg.DetectorOptions(**DET),
                          max_landmarks=512)
    js = JSession(jc, np.stack([K] * D), np.zeros((D, 3), np.float32))
    pairs, resections = [], []
    rel, p3p = jrobust.relative_pose_essential, jrobust.absolute_pose_p3p

    def rel_rec(key, uv1, uv2, mask, *a):
        out = rel(key, uv1, uv2, mask, *a)
        pairs.append((np.asarray(jransac.sample_indices(key, mask, 256, 5)), out))
        return out

    def p3p_rec(key, X, uv, mask, *a):
        resections.append(np.asarray(jransac.sample_indices(key, mask, 256, 3)))
        return p3p(key, X, uv, mask, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrobust, "relative_pose_essential", rel_rec)
        mp.setattr(jrobust, "absolute_pose_p3p", p3p_rec)
        assert js.init_map({d: frames[d][0] for d in range(D)})
    feats = [js.detect(frames[d][0]) for d in range(D)]
    return js, jc, frames, feats, pairs, resections


def test_reconstruct_scene_matches_reference(reference):
    """The port's reconstruct_scene on coloc_tpu's features, matches and
    the successful pairs' geometries, its resection draws injected: the
    same seed pair and view order (so the same rows, and obs / obs_mask /
    desc exactly equal, the tracks being exact), landmark slots shared on
    >= 97% of the valid ones (as test_init_map_matches_reference at D =
    2; measured 172 of 172 shared), and every view within 1e-3 rad and
    5e-3 of coloc_tpu's after the BA (measured 1.5e-7 rad and 1.0e-5; the
    margin is for a borderline P3P inlier, ROADMAP C8)."""
    js, jc, _, feats, pairs, resections = reference
    tc = tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**DET),
                          max_landmarks=512)
    pm, pg = {}, {}
    for (a, b), (_, geo) in zip([(a, b) for a in range(D) for b in range(a + 1, D)], pairs):
        if bool(geo.success):
            m = jmatching.match_pair(feats[a], feats[b], jc.matcher)
            pm[(a, b)] = convert.matches_from_numpy(m, "cpu")
            pg[(a, b)] = convert.two_view_from_numpy(geo, "cpu")
    assert len(pm) >= 3 and len(resections) == D - 2
    tf = [convert.features_from_numpy(f, "cpu") for f in feats]
    Ks, dists = torch.from_numpy(np.stack([K] * D)), torch.zeros(D, 3)
    cams = [tcam.Camera(K=Ks[d], dist=dists[d]) for d in range(D)]
    scene, res, order = trec.reconstruct_scene(
        tf, pm, pg, cams, Ks, dists, tc.scale, 512, tc.refiner, tc.ransac,
        resection_idx=[torch.from_numpy(r) for r in resections])
    ref = js.scene
    np.testing.assert_array_equal(scene.obs_mask.numpy(), np.asarray(ref.obs_mask))
    np.testing.assert_array_equal(scene.obs.numpy(), np.asarray(ref.obs))
    np.testing.assert_array_equal(scene.desc.numpy().view(np.uint32), np.asarray(ref.desc))
    jv, tv = np.asarray(ref.X_valid), scene.X_valid.numpy()
    assert tv.sum() >= 8 and (jv & tv).sum() / (jv | tv).sum() >= 0.97
    for r in range(D):
        assert _angle(scene.Rs[r].numpy(), np.asarray(ref.Rs[r])) < 1e-3
        np.testing.assert_allclose(scene.Cs[r].numpy(), np.asarray(ref.Cs[r]), atol=5e-3)
    np.testing.assert_array_equal(scene.Rs[0].numpy(), np.eye(3, dtype=np.float32))
    assert res.cov.shape == (6, 6) and bool(torch.isfinite(res.cov).all())
    assert tuple(order[:2]) == max(pg, key=lambda p: int(pg[p].n_inliers))
    assert sorted(order) == list(range(D))


def test_triangulate_pair_gates_match_reference(reference):
    """_triangulate_pair on two of coloc_tpu's posed rows, both gate sets
    (bootstrap: |Z| < 100, no angle or reprojection gate; resection:
    |Z| < 1000, 2 deg, 16 px^2): the accepted sets equal but for a point
    on a gate's edge (at most 2; measured: equal, 56 points), X to 1e-3
    relative where both accept (measured 2.0e-5)."""
    from coloc_tpu.sfm import reconstruct as jrec

    js = reference[0]
    s = js.scene
    vis = np.asarray(s.obs_mask[0] & s.obs_mask[2])
    cam = js.cams[0]
    tcamera = tcam.Camera(K=torch.from_numpy(K), dist=torch.zeros(3))
    for gates in ((100.0, 0.0, np.inf), (1000.0, 2.0, 16.0)):
        Xj, okj = jrec._triangulate_pair(s.Rs[0], s.Cs[0], s.Rs[2], s.Cs[2], cam, cam,
                                         s.obs[0], s.obs[2], jnp.asarray(vis), *gates)
        Xt, okt = trec._triangulate_pair(
            *(torch.from_numpy(np.asarray(a)) for a in (s.Rs[0], s.Cs[0], s.Rs[2], s.Cs[2])),
            tcamera, tcamera, torch.from_numpy(np.asarray(s.obs[0])),
            torch.from_numpy(np.asarray(s.obs[2])), torch.from_numpy(vis), *gates)
        okj, okt = np.asarray(okj), okt.numpy()
        assert okj.sum() > 20 and (okj != okt).sum() <= 2
        both = okj & okt
        Xj, Xt = np.asarray(Xj)[both], Xt.numpy()[both]
        assert (np.linalg.norm(Xt - Xj, axis=1) <= 1e-3 * np.linalg.norm(Xj, axis=1)).all()


def test_session_state_carries_a_four_view_scene(reference):
    """convert.session_state_from_numpy carries coloc_tpu's V = 4 scene
    and map into the port exactly."""
    js = reference[0]
    ts = TSession(tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**DET),
                                   max_landmarks=512),
                  np.stack([K] * D), np.zeros((D, 3), np.float32), device="cpu")
    convert.session_state_from_numpy(js, ts)
    assert ts.scene.num_views == D and ts.map_ready
    for name in ("Rs", "Cs", "X", "X_valid", "obs", "obs_mask"):
        np.testing.assert_array_equal(getattr(ts.scene, name).numpy(),
                                      np.asarray(getattr(js.scene, name)))
    np.testing.assert_array_equal(ts.mapdb.desc.numpy().view(np.uint32),
                                  np.asarray(js.mapdb.desc))
