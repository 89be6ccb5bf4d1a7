"""Parity of the port's map bootstrap and session with coloc_tpu on the CPU:
full bundle adjustment (Schur complement, covariance), ColocSession.init_map
(the D = 2 model-E bootstrap), intra_pose_all on a carried-over session,
run end to end, and the entry points' device rule.

The scene and sizes are tests/test_session.py's (scene seed 3, 240x320, 4
levels, 512 keypoints, 512 landmarks). torch cannot replay jax.random, so
the port is handed coloc_tpu's own RANSAC draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu import robust as jrobust
from coloc_tpu.frontend import detect_and_describe_batch as j_detect_batch
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.ops import hamming as jhamming
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.sfm import reconstruct as jrec
from coloc_tpu.types import Pose as JPose

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch.fusion import kalman as tkalman
from coloc_tpu_torch.geometry import camera as tcam
from coloc_tpu_torch.geometry import se3 as tse3
from coloc_tpu_torch.session import ColocSession as TSession
from coloc_tpu_torch.sfm import ba as tba
from coloc_tpu_torch.sfm import reconstruct as trec
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, FRAMES = 240, 320, 6
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
DET = dict(width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10)


def _configs(**kw):
    return (jcfg.ColocConfig(num_drones=2, detector=jcfg.DetectorOptions(**DET),
                             max_landmarks=512, **kw),
            tcfg.ColocConfig(num_drones=2, detector=tcfg.DetectorOptions(**DET),
                             max_landmarks=512, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _angle(Ra, Rb):
    """Angle between rotations: ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2),
    exact near 0 where arccos of a float32 trace is not."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _dir_angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


@pytest.fixture(scope="module")
def dataset():
    scene = jsyn.make_scene(H, W, K, seed=3)
    frames, gt = {}, {}
    for d in range(2):
        Rs, Cs = jsyn.trajectory(FRAMES, d)
        frames[d] = [jsyn.render(scene, Rs[f], Cs[f]) for f in range(FRAMES)]
        gt[d] = (Rs, Cs)
    return frames, gt


@pytest.fixture(scope="module")
def bootstrap(dataset):
    """coloc_tpu's session bootstrapped on frame 0, the draws its init_map
    made, and the port's session bootstrapped with the same draws."""
    frames, _ = dataset
    jc, tc = _configs()
    js = JSession(jc, KS, DISTS)
    key = jax.random.split(js.key)[1]          # the key init_map draws with
    f0, f1 = js.detect(frames[0][0]), js.detect(frames[1][0])
    m = jmatching.match_pair(f0, f1, jc.matcher)
    draws = np.asarray(jransac.sample_indices(key, m.mask, jc.ransac.num_hypotheses, 5))
    assert js.init_map({0: frames[0][0], 1: frames[1][0]})
    ts = TSession(tc, KS, DISTS, device="cpu")
    ok = ts.init_map({0: frames[0][0], 1: frames[1][0]},
                     sample_idx=torch.from_numpy(draws))
    return js, ts, ok, (key, f0, f1, m)


def test_init_map_matches_reference(bootstrap, dataset):
    """Landmark slots shared on >= 97% of the valid ones (one borderline
    inlier of ~47 may flip: the f32 five-point models round differently in
    XLA, test_torch_twoview.py). The BA then settles on nearly the same
    drone-1 pose: R within 3e-3 rad and the baseline direction within
    5e-3 rad of coloc_tpu's (measured 1.2e-3 and 3.8e-3: one landmark of
    47 moves the solution that much), both as close to the ground truth as
    coloc_tpu's within 3e-3 rad."""
    js, ts, ok, _ = bootstrap
    _, gt = dataset
    assert ok and ts.map_ready
    jv, tv = np.asarray(js.mapdb.valid), ts.mapdb.valid.numpy()
    assert tv.sum() >= 8
    assert (jv & tv).sum() / (jv | tv).sum() >= 0.97
    np.testing.assert_array_equal(ts.mapdb.desc.numpy().view(np.uint32),
                                  np.asarray(js.mapdb.desc))
    Rj, Rt = np.asarray(js.scene.Rs[1]), ts.scene.Rs[1].numpy()
    Cj, Ct = np.asarray(js.scene.Cs[1]), ts.scene.Cs[1].numpy()
    assert _angle(Rj, Rt) < 3e-3 and _dir_angle(Cj, Ct) < 5e-3
    (R0, C0), (R1, C1) = ((gt[d][0][0], gt[d][1][0]) for d in (0, 1))
    R_gt, C_gt = R1 @ R0.T, R0 @ (C1 - C0)
    assert _angle(Rt, R_gt) <= _angle(Rj, R_gt) + 3e-3
    assert _dir_angle(Ct, C_gt) <= _dir_angle(Cj, C_gt) + 3e-3
    np.testing.assert_array_equal(ts.scene.Rs[0].numpy(), np.eye(3, dtype=np.float32))
    ba = ts.bootstrap_ba
    assert ba.cov.shape == (6, 6) and bool(torch.isfinite(ba.cov).all())
    assert 1 <= ba.iterations <= tcfg.RefinerOptions().max_iterations
    assert float(ba.rmse) < 1.0


@pytest.fixture(scope="module")
def scene_pair(bootstrap):
    """coloc_tpu's two_view_scene of the bootstrap pair, before its BA."""
    js, _, _, (key, f0, f1, m) = bootstrap
    jc, _ = _configs()
    geo = jrobust.relative_pose_essential(key, f0.xy, f1.xy[m.idx], m.mask,
                                          js.cams[0], js.cams[1], jc.ransac)
    return jrec.two_view_scene(f0, f1, m, geo.inliers, geo.R, geo.t,
                               JPose(R=jnp.eye(3), C=jnp.zeros(3)), 1.0,
                               js.cams[0], js.cams[1], num_landmarks=512)


@pytest.mark.parametrize("optimize_structure", [True, False])
def test_ba_refine_matches_reference(bootstrap, scene_pair, optimize_structure):
    """The same scene into both BAs: rotations to 1e-4, landmarks to 1e-3
    median relative, rmse to 1%, the covariance to 1e-2 relative
    (Frobenius). Drone 1's centre: direction to 1e-4 rad, length to 5e-4
    relative, because a two-view BA with one pose fixed leaves the scale
    free (a gauge direction) and the two LM loops stop a last-bit apart
    along it (measured 1.3e-4)."""
    js = bootstrap[0]
    jc, tc = _configs()
    fix = jnp.asarray([True, False])
    _, jres = jrec.refine_scene(scene_pair, js.Ks[:2], js.dists[:2], jc.refiner, fix,
                                optimize_structure=optimize_structure)
    tscene = convert.scene_from_numpy(_np(scene_pair), "cpu")
    _, tres = trec.refine_scene(tscene, torch.from_numpy(KS), torch.from_numpy(DISTS),
                                tc.refiner, torch.tensor([True, False]),
                                optimize_structure=optimize_structure)
    np.testing.assert_allclose(tres.Rs.numpy(), np.asarray(jres.Rs), atol=1e-4)
    Cj, Ct = np.asarray(jres.Cs[1]), tres.Cs[1].numpy()
    assert _dir_angle(Ct, Cj) < 1e-4
    assert abs(np.linalg.norm(Ct) / np.linalg.norm(Cj) - 1.0) < 5e-4
    np.testing.assert_array_equal(tres.Cs[0].numpy(), np.asarray(jres.Cs[0]))
    valid = np.asarray(scene_pair.X_valid)
    jX, tX = np.asarray(jres.X)[valid], tres.X.numpy()[valid]
    rel = np.linalg.norm(tX - jX, axis=1) / np.linalg.norm(jX, axis=1)
    assert np.median(rel) < 1e-3
    np.testing.assert_allclose(float(tres.rmse), float(jres.rmse), rtol=1e-2)
    jcov = np.asarray(jres.cov)
    assert np.linalg.norm(tres.cov.numpy() - jcov) <= 1e-2 * np.linalg.norm(jcov)
    assert int(tres.n_obs) == int(jres.n_obs)


def test_ba_unobserved_landmark_changes_nothing(scene_pair):
    """A landmark slot no view observes, with non-finite observations, is
    kept out of every sum and its block out of eigh: finite, no effect."""
    _, tc = _configs()
    s = convert.scene_from_numpy(_np(scene_pair), "cpu")
    L = s.capacity
    free = int(np.flatnonzero(~s.X_valid.numpy())[0])
    obs = s.obs.clone()
    obs[:, free] = float("nan")
    args = (torch.from_numpy(KS), torch.from_numpy(DISTS), tc.refiner,
            torch.tensor([True, False]))
    _, base = trec.refine_scene(s, *args)
    _, bad = trec.refine_scene(s._replace(obs=obs), *args)
    for a, b in zip(base[:5], bad[:5]):
        assert bool(torch.isfinite(b).all())
        assert torch.equal(a, b)
    assert L == 512


def test_ba_jacobians_match_jacfwd():
    """The analytic pose and landmark Jacobians of the full BA, with
    distortion, against torch.func.jacfwd of the projection."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(np.c_[rng.uniform(-2, 2, (20, 2)),
                               rng.uniform(4, 9, (20, 1))].astype(np.float32))
    uv = torch.from_numpy(rng.uniform(0, 300, (20, 2)).astype(np.float32))
    R = torch.linalg.matrix_exp(torch.tensor([[0, -0.1, 0.05], [0.1, 0, -0.02],
                                              [-0.05, 0.02, 0]]))
    C = torch.tensor([0.3, -0.1, 0.2])
    cam = tcam.Camera(K=torch.from_numpy(K), dist=torch.tensor([-0.1, 0.02, 0.001]))
    Jp, Jx, r = tba._jacobians(R, C, cam, X, uv)
    for i in range(3):
        want = torch.func.jacfwd(
            lambda x: tba._project_residual(R, C, cam, x[None], uv[i:i + 1])[0])(X[i])
        torch.testing.assert_close(Jx[i], want, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(r, tba._project_residual(R, C, cam, X, uv))
    assert Jp.shape == (20, 2, 6)


def _intra_draws(js, jc, images):
    """The P3P draws coloc_tpu's intra_pose_all makes for these images."""
    keys = jax.random.split(jax.random.split(js.key)[1], 2)
    feats = j_detect_batch(jnp.asarray(images), jc.detector)
    kp = jc.detector.max_keypoints
    q, qv = feats.desc.reshape(2 * kp, -1), feats.valid.reshape(-1)
    mm = jmatching._accept(*jhamming.hamming_2nn_bank(q, qv, js._map_bank()), qv,
                           jc.matcher, jc.matcher.margin_threshold)
    corr = (mm.idx >= 0).reshape(2, kp) & feats.valid
    return np.stack([np.asarray(jransac.sample_indices(keys[d], corr[d],
                                                       jc.ransac.num_hypotheses, 3))
                     for d in range(2)])


def test_intra_pose_all_matches_reference(bootstrap, dataset):
    """coloc_tpu's bootstrapped state carried into the port
    (convert.session_state_from_numpy), then 3 frames of intra_pose_all on
    both with the same draws: success equal, n_tracks within 1 a drone (a
    borderline P3P inlier, ROADMAP C8), filtered poses to 1e-4 while the
    inlier counts have agreed. One point of the ~30 this small map gives
    moves the refined pose by ~2e-3 (measured 1.9e-3), and the Kalman
    state carries that into later frames, so from the first differing
    count on: 5e-3."""
    frames, _ = dataset
    jc, tc = _configs()
    js = bootstrap[0]
    ts = TSession(tc, KS, DISTS, device="cpu")
    convert.session_state_from_numpy(js, ts)
    tol = 1e-4
    for f in range(1, 4):
        images = np.stack([frames[0][f], frames[1][f]]).astype(np.float32)
        draws = _intra_draws(js, jc, images)
        js.frame = ts.frame = f
        jout = js.intra_pose_all({0: images[0], 1: images[1]})
        tout = ts.intra_pose_all({0: images[0], 1: images[1]},
                                 sample_idx=torch.from_numpy(draws))
        for d in range(2):
            j, t = jout[d], tout[d]
            assert bool(t.success) == bool(j.success) and bool(t.success)
            dn = abs(int(t.n_tracks) - int(j.n_tracks))
            assert dn <= 1
            tol = tol if dn == 0 else 5e-3
            np.testing.assert_allclose(t.pose.R.numpy(), np.asarray(j.pose.R), atol=tol)
            np.testing.assert_allclose(t.pose.C.numpy(), np.asarray(j.pose.C), atol=tol)
        np.testing.assert_array_equal(ts.filter_bank.steps.numpy(),
                                      np.asarray(js.filter_bank.steps))
        sup_t, sup_j = ts.lm_support.numpy(), np.asarray(js.lm_support)
        assert np.abs(sup_t - sup_j).sum() <= 2 * f
        seen_t, seen_j = ts.lm_last_seen.numpy() >= f, np.asarray(js.lm_last_seen) >= f
        assert (seen_t != seen_j).sum() <= 2 * f


def test_run_end_to_end(dataset):
    """run(frames, inter_every=0) on the port alone: bootstrap, then every
    frame localized, drone 0 moving along +x, rotations within 1 degree of
    the ground truth (tests/test_session.py's measure)."""
    frames, gt = dataset
    _, tc = _configs()
    ts = TSession(tc, KS, DISTS, seed=0, device="cpu")
    results = ts.run(frames, inter_every=0)
    assert ts.map_ready and ts.frame == FRAMES - 1
    for d in (0, 1):
        assert len(results[d]) == FRAMES - 1
        ok = [bool(p.success) for p in results[d]]
        assert sum(ok) >= len(ok) - 1, (d, ok)
    C = np.stack([p.pose.C.numpy() for p in results[0]])
    assert C[-1, 0] > C[0, 0]
    Rs_gt = gt[0][0]
    errs = [np.degrees(_angle(p.pose.R.numpy(), Rs_gt[i + 1] @ Rs_gt[0].T))
            for i, p in enumerate(results[0]) if bool(p.success)]
    assert len(errs) >= 4 and np.median(errs) < 1.0, errs
    assert int(ts.filter_bank.steps.sum()) >= 2 * (FRAMES - 2)


def test_out_dir_writes_the_bootstrap_map_ply(bootstrap, tmp_path):
    """A session with out_dir that takes the port's bootstrapped scene as
    its map writes map.ply as coloc_tpu's writer does for that scene: its
    valid landmarks white, its two camera centres green."""
    from coloc_tpu.io import loggers as jloggers

    _, ts, _, _ = bootstrap
    _, tc = _configs()
    s = TSession(tc, KS, DISTS, out_dir=str(tmp_path / "logs"), device="cpu")
    assert s._set_map(ts.scene, ts.bootstrap_geo, ts.bootstrap_ba, [0, 1])
    jloggers.write_ply(str(tmp_path / "ref.ply"), ts.scene.X.numpy(),
                       ts.scene.X_valid.numpy(), ts.scene.Cs.numpy())
    text = (tmp_path / "logs" / "map.ply").read_text()
    assert text == (tmp_path / "ref.ply").read_text()
    assert f"element vertex {int(ts.scene.X_valid.sum()) + 2}" in text


def _features_stub():
    n = 4
    return type("F", (), dict(xy=np.zeros((n, 2)), score=np.zeros(n), scale=np.zeros(n),
                              angle=np.zeros(n), desc=np.zeros((n, 16), np.uint32),
                              valid=np.ones(n, bool)))()


def _scene_stub():
    L = 4
    return trec.Scene(Rs=np.stack([np.eye(3)] * 2), Cs=np.zeros((2, 3)), X=np.zeros((L, 3)),
                      X_valid=np.ones(L, bool), obs=np.zeros((2, L, 2)),
                      obs_mask=np.ones((2, L), bool), desc=np.zeros((L, 16), np.uint32))


@pytest.mark.parametrize("entry", ["session", "kalman", "features", "mapdb", "camera",
                                   "filter_bank", "scene", "two_view", "matches",
                                   "identity"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """device None means cuda:0: with no CUDA device it raises rather than
    running on the CPU; device="cpu" is the caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _configs()
    calls = {
        "session": lambda **kw: TSession(tc, KS, DISTS, **kw),
        "kalman": lambda **kw: tkalman.init(2, tc.filter, **kw),
        "features": lambda **kw: convert.features_from_numpy(
            _features_stub(), **kw),
        "mapdb": lambda **kw: convert.mapdb_from_numpy(
            type("M", (), dict(X=np.zeros((2, 3)), desc=np.zeros((2, 16), np.uint32),
                               valid=np.ones(2, bool)))(), **kw),
        "camera": lambda **kw: convert.camera_from_numpy(K, **kw),
        "filter_bank": lambda **kw: convert.filter_bank_from_numpy(
            tkalman.init(2, tc.filter, "cpu"), **kw),
        "scene": lambda **kw: convert.scene_from_numpy(_np(_scene_stub()), **kw),
        "two_view": lambda **kw: convert.two_view_from_numpy(
            type("G", (), dict(R=np.eye(3), t=np.ones(3), inliers=np.ones(4, bool),
                               n_inliers=4, success=True))(), **kw),
        "matches": lambda **kw: convert.matches_from_numpy(
            type("M", (), dict(idx=np.array([1, -1]), best=np.zeros(2),
                               second=np.ones(2)))(), **kw),
        "identity": lambda **kw: tse3.identity(**kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    out = calls[entry](device="cpu")
    leaves = [x for x in jax.tree_util.tree_leaves(
        out.__dict__ if isinstance(out, TSession) else out,
        is_leaf=lambda x: isinstance(x, torch.Tensor)) if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device.type == "cpu" for x in leaves)

