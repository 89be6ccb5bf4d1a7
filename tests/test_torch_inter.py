"""Parity of the port's inter-drone relative pose and fusion with coloc_tpu
on the CPU: parallel/mesh.inter_pose_device on tests/test_oracle.py's
config-4 scenario (against the float64 oracle chain and against
coloc_tpu's core, run by coloc_tpu's DronePeer.inter_fuse on a bundle of
the source features), the port's DronePeer.inter_fuse on the same bundle,
ColocSession.inter_pose after a bootstrap and inter_pose_round's pair
policies (run / run_chunked with `inter_every`:
tests/test_torch_inter_run.py).

torch cannot replay jax.random, so the port is handed coloc_tpu's own
five-point draws: jransac.sample_indices(key, m.mask, 256, 5) with m the
pair's match_pair, which is what coloc_tpu's relative_pose_essential draws
from `key`.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from test_oracle import _CAP, _make_inter_scenario, _oracle_inter_chain
from test_oracle import K as K4

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu.distributed import DronePeer as JPeer
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.io import transport as jtransport
from coloc_tpu.parallel import mesh as jmesh
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.types import Pose as JPose
from coloc_tpu.types import PoseWithCov as JPoseWithCov

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch.distributed import DronePeer
from coloc_tpu_torch.fusion import kalman as tkalman
from coloc_tpu_torch.io import transport
from coloc_tpu_torch.parallel import mesh as tmesh
from coloc_tpu_torch.session import ColocSession as TSession
from coloc_tpu_torch.types import Pose, PoseWithCov
from port_harness import one_torch_thread, time_limit  # noqa: F401

NB = 256                       # RansacOptions().num_hypotheses


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    return torch.tensor(np.asarray(a, np.float32))


def _angle(Ra, Rb):
    """Angle between rotations, rad, exact near 0."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


# ------------------------------------------------- config 4: the device core

def _c4_configs():
    det = dict(width=640, height=480, max_keypoints=_CAP)
    return (jcfg.ColocConfig(num_drones=2, detector=jcfg.DetectorOptions(**det),
                             max_landmarks=_CAP),
            tcfg.ColocConfig(num_drones=2, detector=tcfg.DetectorOptions(**det),
                             max_landmarks=_CAP))


def _port_c4(s, tc, draws, mapdb=None):
    cam = convert.camera_from_numpy(K4, device="cpu")
    return tmesh.inter_pose_device(
        convert.features_from_numpy(s["f_dst"], "cpu"),
        convert.features_from_numpy(s["f_src"], "cpu"), cam, cam,
        _f32(np.stack([K4, K4])), torch.zeros(2, 3),
        Pose(R=_f32(s["R_src"]), C=_f32(s["C_src"])), _f32(s["src_cov3"]),
        _f32(s["dst_pos"]), _f32(s["dst_cov3"]),
        mapdb if mapdb is not None else convert.mapdb_from_numpy(s["mapdb"], "cpu"),
        tc, sample_idx=torch.from_numpy(draws))


def _bundle(s):
    """coloc_tpu's bytes for a bundle of the scenario's source features and
    pose (tests/test_torch_transport.py holds the port's codec to them)."""
    f = s["f_src"]
    return jtransport.encode_feature_bundle(
        0, 0, 0.0, np.asarray(f.xy), np.asarray(f.score), np.asarray(f.scale),
        np.asarray(f.angle), np.asarray(f.desc), np.asarray(f.valid), K4, np.zeros(3),
        s["R_src"], s["C_src"], s["src_cov3"])


def _dst_state(s):
    """The destination's pose covariance (6, 6) and centre, float32."""
    cov6 = np.zeros((6, 6), np.float32)
    cov6[3:6, 3:6] = s["dst_cov3"]
    return cov6, np.asarray(s["dst_pos"], np.float32)


@pytest.fixture(scope="module")
def c4():
    """The scenario, the float64 oracle chain, coloc_tpu's inter_pose_device
    (TestConfig4InterFusionVsOracle's inputs, key 4) and the port's with the
    same draws, and what coloc_tpu's DronePeer.inter_fuse returned.

    coloc_tpu's core is run by its DronePeer (drone 1, no node) fusing the
    bundle: the peer's jitted closure is built with jax.jit as the identity,
    so the core runs op by op, as a direct call does, and is compiled once
    in this file."""
    s = _make_inter_scenario()
    golden = _oracle_inter_chain(s)
    jc, tc = _c4_configs()
    key = jax.random.PRNGKey(4)
    cov6, dst_C = _dst_state(s)
    jp = JPeer(1, jc, K4, np.zeros(3), s["mapdb"], node=None)
    jp._last_image, jp.frame, jp._feats_frame, jp._last_feats = (
        np.zeros((480, 640), np.float32), 1, 1, s["f_dst"])
    jp.session.last_pose[0] = JPoseWithCov(
        pose=JPose(R=jnp.eye(3), C=jnp.asarray(dst_C)), cov=jnp.asarray(cov6),
        rmse=jnp.float32(0.0), n_tracks=jnp.int32(0), success=jnp.bool_(True))
    cores, real = [], jmesh.inter_pose_device

    def recording(*args, **kw):
        cores.append(real(*args, **kw))
        return cores[-1]

    with mock.patch.object(jmesh, "inter_pose_device", recording), \
            mock.patch.object(jax, "jit", lambda f: f):
        jp._inter()
    fused = jp.inter_fuse(0, bundle=jtransport.decode_feature_bundle(_bundle(s)), key=key,
                          publish=False)
    assert len(cores) == 1
    m = jmatching.match_pair(s["f_src"], s["f_dst"], jc.matcher)
    draws = np.array(jransac.sample_indices(key, m.mask, NB, 5))
    return s, golden, _np(cores[0]), _port_c4(s, tc, draws), draws, fused


def test_c4_scale_matches_oracle(c4):
    _, golden, _, out, _, _ = c4
    assert bool(out.ok)
    np.testing.assert_allclose(float(out.scale), golden["scale"], rtol=2e-3)


def test_c4_relative_pose_matches_oracle(c4):
    _, golden, _, out, _, _ = c4
    assert oracle.rot_angle_deg(out.rel.R.numpy(), golden["rel_R"]) < 0.1
    np.testing.assert_allclose(out.rel.C.numpy(), golden["rel_C"], atol=2e-3)


def test_c4_fused_position_matches_oracle(c4):
    _, golden, _, out, _, _ = c4
    np.testing.assert_allclose(out.fused_pos.numpy(), golden["fused_pos"], atol=2e-3)


def test_c4_fused_covariance_and_omega_match_oracle(c4):
    _, golden, _, out, _, _ = c4
    np.testing.assert_allclose(out.fused_cov.numpy(), golden["fused_cov"], rtol=0.02,
                               atol=2e-4)
    np.testing.assert_allclose(float(out.diag.omega), golden["omega"], atol=1e-2)


def test_c4_matches_reference(c4):
    """Against coloc_tpu's core with its draws: ok equal; scale, relative
    pose and fused position within 1e-4 (measured 4e-6, 3e-6 and 2.5e-5);
    w* within 4e-3 (C15); one borderline point of 48 may flip in or out of
    the five-point inliers and so of the common landmarks (the exact
    observations put its residual at the adaptive threshold's edge: the
    port keeps 48 inliers, coloc_tpu 47), so the counts within 1 and the
    guided mask on all but one slot, the temp observations equal where
    both masks hold."""
    _, _, ref, out, _, _ = c4
    o = convert.to_numpy(out)
    assert bool(o.ok) == bool(ref.ok)
    np.testing.assert_allclose(o.scale, ref.scale, rtol=1e-4)
    assert _angle(o.rel.R, ref.rel.R) < 1e-4
    np.testing.assert_allclose(o.rel.C, ref.rel.C, atol=1e-4)
    np.testing.assert_allclose(o.fused_pos, ref.fused_pos, atol=1e-4)
    assert abs(float(o.diag.omega) - float(ref.diag.omega)) <= 4e-3
    assert abs(int(o.diag.n_common) - int(ref.diag.n_common)) <= 1
    assert abs(int(o.diag.n_inliers) - int(ref.diag.n_inliers)) <= 1
    both = o.diag.guided_mask & ref.diag.guided_mask
    assert (o.diag.guided_mask != ref.diag.guided_mask).sum() <= 1
    np.testing.assert_allclose(o.diag.obs_src[both], ref.diag.obs_src[both], atol=1e-4)
    np.testing.assert_allclose(o.diag.obs_dst[both], ref.diag.obs_dst[both], atol=1e-4)
    assert _angle(o.diag.geo_R, ref.diag.geo_R) < 1e-4
    np.testing.assert_allclose(o.diag.geo_t, ref.diag.geo_t, atol=1e-4)


def test_c4_to_numpy_and_shapes(c4):
    """convert.to_numpy gives InterPoseOut / InterDiag of ndarrays, nested
    Pose included, with coloc_tpu's shapes and dtypes."""
    _, _, ref, out, _, _ = c4
    o = convert.to_numpy(out)
    assert isinstance(o, tmesh.InterPoseOut) and isinstance(o.diag, tmesh.InterDiag)
    assert isinstance(o.rel, Pose)

    def walk(got, want, path):
        if isinstance(got, tuple):
            assert got._fields == want._fields, path
            for name, g, w in zip(got._fields, got, want):
                walk(g, w, f"{path}.{name}")
            return
        assert isinstance(got, np.ndarray), path
        assert got.shape == want.shape and got.dtype == want.dtype, path
    walk(o, ref, "out")


def test_c4_no_common_landmark_falls_back(c4):
    """With no valid map landmark ok is False and the outputs are the
    drone's own estimate (a torch.where, no host branch)."""
    s, _, _, _, draws, _ = c4
    _, tc = _c4_configs()
    mapdb = convert.mapdb_from_numpy(s["mapdb"], "cpu")
    out = _port_c4(s, tc, draws, mapdb._replace(valid=torch.zeros_like(mapdb.valid)))
    assert not bool(out.ok) and int(out.diag.n_common) == 0
    assert torch.equal(out.fused_pos, _f32(s["dst_pos"]))
    torch.testing.assert_close(out.fused_cov, _f32(s["dst_cov3"]) + 1e-6 * torch.eye(3),
                               rtol=0, atol=0)


# ------------------------------------------- DronePeer.inter_fuse over the wire

@pytest.fixture(scope="module")
def peer_fused(c4):
    """coloc_tpu's DronePeer.inter_fuse (c4) and the port's on the same
    bundle and destination state, the port's with the draws coloc_tpu's
    key 4 makes."""
    s, _, _, _, draws, jres = c4
    _, tc = _c4_configs()
    cov6, dst_C = _dst_state(s)
    tp = DronePeer(1, tc, K4, np.zeros(3), convert.mapdb_from_numpy(s["mapdb"], "cpu"),
                   node=None, device="cpu")
    tp._last_image, tp.frame, tp._feats_frame = np.zeros((480, 640), np.float32), 1, 1
    tp._last_feats = convert.features_from_numpy(s["f_dst"], "cpu")
    tp.session.last_pose[0] = PoseWithCov(
        pose=Pose(R=torch.eye(3), C=torch.from_numpy(dst_C)), cov=torch.from_numpy(cov6),
        rmse=torch.zeros(()), n_tracks=torch.zeros((), dtype=torch.int32),
        success=torch.ones((), dtype=torch.bool))
    tres = tp.inter_fuse(0, bundle=transport.decode_feature_bundle(_bundle(s)),
                         sample_idx=torch.from_numpy(draws), publish=False)
    return jres, tres


def test_both_fuse_the_bundle(peer_fused):
    jres, tres = peer_fused
    assert jres is not None and tres is not None
    cov = tres.cov.numpy().astype(np.float64)
    assert np.isfinite(cov).all() and np.allclose(cov, cov.T, atol=1e-7)
    assert np.linalg.eigvalsh(cov).min() > 0
    np.testing.assert_allclose(float(tres.trace), np.trace(cov), rtol=1e-5)


def test_w_star_agrees_with_reference(peer_fused):
    """w* within 4e-3 of coloc_tpu's DronePeer (C15: the trace is flat near
    its minimum below float32 resolution; measured 0.73156 against
    0.73022), in [0, 1]."""
    jres, tres = peer_fused
    assert abs(float(tres.omega) - float(jres.omega)) <= 4e-3
    assert 0.0 <= float(tres.omega) <= 1.0


def test_peer_fusion_equals_port_core(peer_fused, c4):
    """The port's peer over the decoded bundle gives exactly what the port's
    inter_pose_device gives on the scenario's arrays with the same draws,
    and coloc_tpu's peer what its core gave."""
    jres, tres = peer_fused
    _, _, ref, out, _, _ = c4
    assert torch.equal(tres.pos, out.fused_pos) and torch.equal(tres.cov, out.fused_cov)
    assert torch.equal(tres.omega, out.diag.omega) and torch.equal(tres.trace, out.diag.trace)
    np.testing.assert_array_equal(np.asarray(jres.pos), ref.fused_pos)
    assert float(jres.omega) == float(ref.diag.omega)


# ------------------------------------------------------- the session's entry

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
DET = dict(width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10)


def _configs(D=2):
    return (jcfg.ColocConfig(num_drones=D, detector=jcfg.DetectorOptions(**DET),
                             max_landmarks=512),
            tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**DET),
                             max_landmarks=512))


@pytest.fixture(scope="module")
def dataset():
    """tests/test_session.py's scene (seed 3) along three drones'
    12-frame trajectories, frames 0 and 1 rendered."""
    scene = jsyn.make_scene(H, W, K, seed=3)
    frames, gt = {}, {}
    for d in range(3):
        Rs, Cs = jsyn.trajectory(12, d)
        frames[d] = [jsyn.render(scene, Rs[f], Cs[f]) for f in range(2)]
        gt[d] = (Rs, Cs)
    return frames, gt


class _Capture:
    """Records what a module's inter_pose_device returns while installed."""

    def __init__(self, module):
        self.module, self.real, self.outs = module, module.inter_pose_device, []

    def __enter__(self):
        def wrapped(*args, **kw):
            out = self.real(*args, **kw)
            self.outs.append(out)
            return out
        self.module.inter_pose_device = wrapped
        return self

    def __exit__(self, *exc):
        self.module.inter_pose_device = self.real


KEYS = (12, 13, 14)


@pytest.fixture(scope="module")
def fused(dataset):
    """coloc_tpu's session bootstrapped on frame 0 and stepped on frame 1;
    then, for each key of KEYS, its state carried into a port session
    (last_pose included) and inter_pose(0, 1) on frame 1 on both, coloc_tpu
    with the key and the port with that key's draws, both cores' outputs
    recorded. -> (coloc_tpu's session, {key: (port session, coloc_tpu's
    FusionResult, the port's, coloc_tpu's InterPoseOut, the port's)})."""
    frames, _ = dataset
    jc, tc = _configs()
    js = JSession(jc, KS, DISTS)
    assert js.init_map({0: frames[0][0], 1: frames[1][0]})
    js.frame = 1
    images = {d: frames[d][1] for d in range(2)}
    js.intra_pose_all(images)
    f0, f1 = js.detect(images[0]), js.detect(images[1])
    m = jmatching.match_pair(f0, f1, jc.matcher)
    runs = {}
    for k in KEYS:
        key = jax.random.PRNGKey(k)
        draws = np.array(jransac.sample_indices(key, m.mask, NB, 5))
        ts = TSession(tc, KS, DISTS, device="cpu")
        convert.session_state_from_numpy(js, ts)
        with _Capture(jmesh) as jcap:
            jres = js.inter_pose(0, 1, images, key=key)
        with _Capture(tmesh) as tcap:
            tres = ts.inter_pose(0, 1, images, sample_idx=torch.from_numpy(draws))
        runs[k] = (ts, jres, tres, _np(jcap.outs[0]), convert.to_numpy(tcap.outs[0]))
    return js, runs


def test_session_state_carries_last_pose(fused):
    js, runs = fused
    ts = runs[KEYS[0]][0]
    assert set(ts.last_pose) == set(js.last_pose) == {0, 1}
    for d in (0, 1):
        j, t = js.last_pose[d], ts.last_pose[d]
        assert isinstance(t, PoseWithCov)
        for a, b in ((t.pose.R, j.pose.R), (t.pose.C, j.pose.C), (t.cov, j.cov),
                     (t.rmse, j.rmse), (t.n_tracks, j.n_tracks), (t.success, j.success)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("key", KEYS)
def test_session_inter_pose_matches_reference(fused, dataset, key):
    """Both fuse, from the port's own features and coloc_tpu's draws. Only
    7 landmarks of this ~40-landmark map are common to the map and the
    temp scene, so the scale (a mean over 6 consecutive pairs) is
    sensitive, and one borderline five-point inlier of ~47 may flip (the
    f32 models round differently in XLA, as in
    test_init_map_matches_reference). Where the inlier counts agree
    (keys 13 and 14, measured: rotation 3.4e-6 and 2.6e-4 rad apart, scale
    2e-5 and 5e-3 relative, fused position 4e-5 and 3.5e-3): the refined
    relative rotation within 1e-3 rad of coloc_tpu's, the scale within 2e-2
    relative, the fused position within 1e-2. Where one inlier flipped
    (key 12: the port keeps 47, coloc_tpu 46; measured 4.3e-3 rad, scale
    0.860 against 0.785, fused position 7.4e-2 apart): the rotation within
    6e-3 rad, the scale within 0.15 relative, the fused position within
    0.15. Always: the port's rotation within 1e-2 rad of the ground
    truth's relative rotation (measured 3.0e-3 to 7.1e-3; coloc_tpu's
    2.8e-3 to 3.3e-3); the same common-landmark count; w* within 4e-3 of
    coloc_tpu's (C15) and in [0, 1]; the fused covariance finite and
    symmetric positive definite, its trace the reported one. The result is
    returned, not written into the filter bank."""
    js, runs = fused
    ts, jres, tres, jo, to = runs[key]
    _, gt = dataset
    assert jres is not None and tres is not None
    assert bool(to.ok) and bool(jo.ok)
    same = int(to.diag.n_inliers) == int(jo.diag.n_inliers)
    assert abs(int(to.diag.n_inliers) - int(jo.diag.n_inliers)) <= 1
    assert int(to.diag.n_common) == int(jo.diag.n_common) >= 2
    assert _angle(to.rel.R, jo.rel.R) < (1e-3 if same else 6e-3)
    np.testing.assert_allclose(to.scale, jo.scale, rtol=2e-2 if same else 0.15)
    np.testing.assert_allclose(tres.pos.numpy(), np.asarray(jres.pos),
                               atol=1e-2 if same else 0.15)
    (R0, _), (R1, _) = ((gt[d][0][1], gt[d][1][1]) for d in (0, 1))
    assert _angle(to.rel.R, R1 @ R0.T) < 1e-2
    assert abs(float(tres.omega) - float(jres.omega)) <= 4e-3
    assert 0.0 <= float(tres.omega) <= 1.0
    cov = tres.cov.numpy().astype(np.float64)
    assert np.isfinite(cov).all() and np.allclose(cov, cov.T, atol=1e-7)
    assert np.linalg.eigvalsh(cov).min() > 0
    np.testing.assert_allclose(float(tres.trace), np.trace(cov), rtol=1e-5)
    np.testing.assert_array_equal(ts.filter_bank.steps.numpy(),
                                  np.asarray(js.filter_bank.steps))


def test_session_inter_pose_needs_both_poses(fused, dataset):
    """None where a drone has no pose yet, before any work."""
    frames, _ = dataset
    _, tc = _configs()
    ts = TSession(tc, KS, DISTS, device="cpu")
    convert.session_state_from_numpy(fused[0], ts)
    del ts.last_pose[0]
    state = ts.generator.get_state()
    assert ts.inter_pose(0, 1, {d: frames[d][1] for d in range(2)}) is None
    assert torch.equal(ts.generator.get_state(), state)


def _stub_pairs(sess, traces):
    """Give `sess` poses whose position covariances have `traces`, and
    make its inter_pose record (src, dst) instead of fusing."""
    jax_side = isinstance(sess, JSession)
    arr = jnp.asarray if jax_side else torch.tensor
    P, T = (JPose, JPoseWithCov) if jax_side else (Pose, PoseWithCov)
    for d, tr in enumerate(traces):
        cov = np.eye(6, dtype=np.float32)
        cov[3:6, 3:6] = np.diag([tr / 2, tr / 4, tr / 4]).astype(np.float32)
        sess.last_pose[d] = T(pose=P(R=arr(np.eye(3, dtype=np.float32)),
                                     C=arr(np.zeros(3, np.float32))),
                              cov=arr(cov), rmse=arr(np.float32(0.1)),
                              n_tracks=arr(np.int32(50)), success=arr(True))
    pairs = []
    sess.detect = lambda image: None
    sess.inter_pose = lambda src, dst, images, feats=None, **kw: pairs.append((src, dst))
    return pairs


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("policy", ["auto", "reference", "ring", "best"])
def test_inter_pose_round_pairs_match_reference(D, policy):
    """The pairs of a round, in order, as coloc_tpu's rule picks them:
    auto = reference (0, 1) at D = 2 and ring at D > 2; ring (d - 1) mod D
    -> d; best the other drone with the smallest position-covariance
    trace."""
    jc, tc = _configs(D)
    Ks, dists = np.stack([K] * D), np.zeros((D, 3), np.float32)
    traces = [0.3, 0.1, 0.2][:D]
    js, ts = JSession(jc, Ks, dists), TSession(tc, Ks, dists, device="cpu")
    jp, tp = _stub_pairs(js, traces), _stub_pairs(ts, traces)
    images = {d: None for d in range(D)}
    jout, tout = js.inter_pose_round(images, policy), ts.inter_pose_round(images, policy)
    assert tp == jp and len(tp) > 0
    assert set(tout) == set(jout)


def test_inter_pose_round_unknown_policy_and_one_drone():
    jc, tc = _configs()
    ts = TSession(tc, KS, DISTS, device="cpu")
    _stub_pairs(ts, [0.1, 0.2])
    js = JSession(jc, KS, DISTS)
    _stub_pairs(js, [0.1, 0.2])
    for s in (js, ts):
        with pytest.raises(ValueError, match="unknown inter-pose policy 'nearest'"):
            s.inter_pose_round({0: None, 1: None}, policy="nearest")
    tc1 = tcfg.ColocConfig(num_drones=1, detector=tc.detector, max_landmarks=512)
    assert TSession(tc1, K[None], DISTS[:1], device="cpu").inter_pose_round({0: None}) == {}


def test_inter_pose_round_three_drones(fused, dataset):
    """A real round at D = 3 on a map carried from the D = 2 bootstrap
    (the D = 3 bootstrap is tests/test_torch_bootstrap_models.py's): auto
    is the ring, each drone a destination once, at least two of three
    fused with finite results."""
    frames, _ = dataset
    _, tc3 = _configs(3)
    ts = TSession(tc3, np.stack([K] * 3), np.zeros((3, 3), np.float32), device="cpu")
    convert.session_state_from_numpy(fused[0], ts)
    ts.filter_bank = tkalman.init(3, tc3.filter, "cpu")
    ts.last_pose = {}
    images = {d: frames[d][1] for d in range(3)}
    res = ts.intra_pose_all(images)
    assert sum(bool(r.success) for r in res.values()) >= 2
    rr = ts.inter_pose_round(images)
    assert set(rr) == {0, 1, 2}
    ok = [d for d, r in rr.items() if r is not None]
    assert len(ok) >= 2, ok
    for d in ok:
        assert np.isfinite(rr[d].pos.numpy()).all() and 0 <= float(rr[d].omega) <= 1
