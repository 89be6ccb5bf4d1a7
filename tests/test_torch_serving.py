"""The port's batched serving (serving.make_serve_step, ServingEngine)
against coloc_tpu's on the CPU, and the helpers serving and ingest use:
types.empty_features / empty_mapdb and io/disk.

Serving is held on B = 3 streams of frontend-free features
(synthetic.random_features and its consistent_mapdb, each stream's
features the map's first landmarks projected from its own pose, through a
shared camera or one camera a stream) with coloc_tpu's P3P draws replayed
through `sample_idx` (ROADMAP C3): coloc_tpu's engine splits its key
into one key a stream and draws each stream's samples from its
correspondences, as tests/test_torch_chunked.py's _draws does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import ransac as jransac
from coloc_tpu import serving as jserving
from coloc_tpu import types as jtypes
from coloc_tpu.geometry import camera as jcam
from coloc_tpu.io import disk as jdisk

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert, matching, ransac, robust, serving, types
from coloc_tpu_torch.frontend import detect_and_describe
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.io import disk, synthetic
from coloc_tpu_torch.sfm import localize
from coloc_tpu_torch.types import Features, Matches

import plumbing_cases
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, KP, L, B = 240, 320, 256, 512, 3
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def _streams(per_stream: bool):
    """-> (features (B, KP, ...) numpy in the reference layout, the map,
    cameras K (B, 3, 3), the streams' poses (R (B, 3, 3), C (B, 3)))."""
    rng = np.random.default_rng(11)
    fa = synthetic.random_features(H, W, KP, rng)
    ma = synthetic.consistent_mapdb(fa, K, L, rng)
    Ks = np.stack([K] * B)
    if per_stream:
        Ks[:, 0, 0] *= 1.0 + 0.04 * np.arange(B)
        Ks[:, 1, 2] += 3.0 * np.arange(B)
    Rs = so3.exp(torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32) * 0.02)).numpy()
    Cs = (rng.normal(size=(B, 3)) * 0.1).astype(np.float32)
    Xc = np.einsum("bij,bkj->bki", Rs, ma.X[None, :KP] - Cs[:, None])
    xy = np.einsum("bij,bkj->bki", Ks, Xc / Xc[..., 2:])[..., :2]
    xy = (xy + rng.normal(size=xy.shape) * 0.5).astype(np.float32)
    valid = fa.valid & (rng.uniform(size=(B, KP)) < 0.9)
    feats = synthetic.FeaturesArrays(
        xy=xy, score=np.broadcast_to(fa.score, (B, KP)).copy(),
        scale=np.broadcast_to(fa.scale, (B, KP)).copy(),
        angle=np.broadcast_to(fa.angle, (B, KP)).copy(),
        desc=np.broadcast_to(fa.desc, (B, KP, 16)).copy(), valid=valid)
    return feats, ma, Ks, (Rs, Cs)


@pytest.fixture(scope="module", params=[False, True], ids=["shared_camera", "per_stream"])
def reference(request):
    """coloc_tpu's engine on the streams: its outputs and the P3P draws of
    each stream (B, 256, 3)."""
    per_stream = request.param
    feats, ma, Ks, gt = _streams(per_stream)
    cfg = jcfg.ColocConfig()
    jf = jtypes.Features(*(jnp.asarray(getattr(feats, f)) for f in feats._fields))
    jdb = jtypes.MapDB(X=jnp.asarray(ma.X), desc=jnp.asarray(ma.desc),
                       valid=jnp.asarray(ma.valid))
    cam = (jcam.Camera(K=jnp.asarray(Ks), dist=jnp.zeros((B, 3))) if per_stream
           else jcam.Camera(K=jnp.asarray(K), dist=jnp.zeros(3)))
    key = jax.random.PRNGKey(7)
    pwc, inl, mm = jserving.ServingEngine(jdb, cam, cfg).localize_features(jf, key)
    keys = jax.random.split(key, B)
    corr = (mm.idx >= 0) & jf.valid
    draws = np.stack([np.asarray(jransac.sample_indices(keys[b], corr[b],
                                                        cfg.ransac.num_hypotheses, 3))
                      for b in range(B)])
    out = jax.tree_util.tree_map(np.asarray, (pwc, inl, mm))
    return per_stream, feats, ma, Ks, gt, out, torch.from_numpy(draws)


def _port(per_stream, feats, ma, Ks):
    cam = (Camera(K=torch.from_numpy(Ks), dist=torch.zeros(B, 3)) if per_stream
           else Camera(K=torch.from_numpy(K), dist=torch.zeros(3)))
    eng = serving.ServingEngine(convert.mapdb_from_numpy(ma, "cpu"), cam,
                                tcfg.ColocConfig(), device="cpu")
    return eng, convert.features_from_numpy(feats, "cpu")


def test_localize_features_matches_reference(reference):
    """Matches exactly as coloc_tpu's; with its draws every stream succeeds
    as coloc_tpu's does, n_tracks within one borderline inlier a stream
    (C8: the float32 P3P solutions and NFA residuals round differently),
    the pose within 1e-4 of coloc_tpu's where the inliers agree and 2e-3
    where one differs (8e-4 measured, the points carry 0.5 px noise), and
    within 4b's gate of the stream's true pose (1e-3 rad, 1e-2 m)."""
    per_stream, feats, ma, Ks, (Rs, Cs), (jpwc, jinl, jmm), draws = reference
    eng, tf = _port(per_stream, feats, ma, Ks)
    pwc, inl, mm = eng.localize_features(tf, sample_idx=draws)
    for a, b in zip(mm, jmm):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(pwc.success.numpy(), jpwc.success)
    assert bool(pwc.success.all())
    dn = np.abs(pwc.n_tracks.numpy() - jpwc.n_tracks)
    assert dn.max() <= 1
    np.testing.assert_array_equal((inl.numpy() != jinl).sum(-1) <= dn, True)
    for b in range(B):
        tol = 1e-4 if dn[b] == 0 else 2e-3
        np.testing.assert_allclose(pwc.pose.R[b].numpy(), jpwc.pose.R[b], atol=tol)
        np.testing.assert_allclose(pwc.pose.C[b].numpy(), jpwc.pose.C[b], atol=tol)
    np.testing.assert_allclose(pwc.pose.R.numpy(), Rs, atol=1e-3)
    np.testing.assert_allclose(pwc.pose.C.numpy(), Cs, atol=1e-2)
    # the step function alone gives the engine's result
    step = serving.make_serve_step(tcfg.ColocConfig(), eng.cam)
    again = step(tf, eng.mapdb, matching.pack_map_bank(eng.mapdb), sample_idx=draws)[0]
    assert all(torch.equal(a, b) for a, b in zip((*again.pose, *again[1:]), (*pwc.pose, *pwc[1:])))


def _port_draws(eng, tf):
    """P3P draws (B, 256, 3) for the streams' correspondences, from a
    generator."""
    mm = eng.localize_features(tf, generator=torch.Generator().manual_seed(4))[2]
    return ransac.sample_indices(mm.mask & tf.valid, eng.config.ransac.num_hypotheses, 3,
                                 torch.Generator().manual_seed(5))


def test_stream_equals_single_stream_call():
    """Each stream of the batched step against localize_image on that
    stream's features, matches and draws alone (per-stream cameras): the
    RANSAC (P3P, ranking, inliers, n_tracks, success) bit for bit; the
    LM's batched reductions round apart in float32 at another batch shape,
    so the refined rotation is held within 1e-6, the centre within 2e-5 m,
    the covariance (~4e-5) within 1e-9 and rmse within 5e-6 px (measured
    at most 4.6e-7, 4.2e-6, 7e-11 and 9e-7 on the CPU)."""
    feats, ma, Ks, _ = _streams(True)
    eng, tf = _port(True, feats, ma, Ks)
    draws = _port_draws(eng, tf)
    pwc, inl, mm = eng.localize_features(tf, sample_idx=draws)
    cfg = tcfg.ColocConfig()
    X, uv, corr = localize.correspondences(tf, mm, eng.mapdb)
    cams = serving._stream_cameras(eng.cam, B)
    pose0, inl0, n0, ok0 = robust.absolute_pose_p3p(X, uv, corr, cams, cfg.ransac,
                                                    sample_idx=draws)
    for b in range(B):
        cam = Camera(K=cams.K[b], dist=cams.dist[b])
        p1, i1, n1, ok1 = robust.absolute_pose_p3p(X[b], uv[b], corr[b], cam, cfg.ransac,
                                                   sample_idx=draws[b])
        for x, y in zip((*p1, i1, n1, ok1), (pose0.R[b], pose0.C[b], inl0[b], n0[b], ok0[b])):
            assert torch.equal(x, y)
        one, inl1 = localize.localize_image(
            Features(*(t[b] for t in tf)), Matches(*(t[b] for t in mm)), eng.mapdb, cam,
            cfg.ransac, cfg.refiner, sample_idx=draws[b], check_every=serving.LM_CHECK_EVERY)
        assert torch.equal(inl1, inl[b])
        assert torch.equal(one.n_tracks, pwc.n_tracks[b])
        assert torch.equal(one.success, pwc.success[b])
        for x, y, tol in ((one.pose.R, pwc.pose.R[b], 1e-6), (one.pose.C, pwc.pose.C[b], 2e-5),
                          (one.cov, pwc.cov[b], 1e-9), (one.rmse, pwc.rmse[b], 5e-6)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=tol)


def test_set_map_with_permuted_slots():
    """The same landmarks in permuted slots: the poses stay (atol 1e-4) and
    each match index moves with its landmark."""
    feats, ma, Ks, _ = _streams(False)
    eng, tf = _port(False, feats, ma, Ks)
    draws = _port_draws(eng, tf)
    pwc, _, mm = eng.localize_features(tf, sample_idx=draws)
    perm = np.random.default_rng(3).permutation(L)
    eng.set_map(convert.mapdb_from_numpy(
        synthetic.MapDBArrays(X=ma.X[perm], desc=ma.desc[perm], valid=ma.valid[perm]), "cpu"))
    pwc2, _, mm2 = eng.localize_features(tf, sample_idx=draws)
    inv = np.argsort(perm)
    idx, idx2 = mm.idx.numpy(), mm2.idx.numpy()
    np.testing.assert_array_equal(idx2[idx >= 0], inv[idx[idx >= 0]])
    np.testing.assert_array_equal(idx2 < 0, idx < 0)
    assert bool(pwc2.success.all())
    np.testing.assert_allclose(pwc2.pose.R.numpy(), pwc.pose.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(pwc2.pose.C.numpy(), pwc.pose.C.numpy(), atol=1e-4)


def test_localize_frames_matches_features():
    """Two small frames (tests/plumbing_cases.py's 96x128 frame and map)
    through the batched frontend against the same frames' single-image
    features: both localize, centres within coloc_tpu's 2e-2
    (tests/test_serving.py: the batched top-k may swap a few
    near-threshold keypoints)."""
    cfg = plumbing_cases.config(2)
    img = plumbing_cases.frame()
    eng = serving.ServingEngine(convert.mapdb_from_numpy(plumbing_cases.map_arrays(), "cpu"),
                                Camera(K=torch.from_numpy(plumbing_cases.K),
                                       dist=torch.zeros(3)), cfg, device="cpu")
    pf, _, _ = eng.localize_frames(np.stack([img, img]),
                                   generator=torch.Generator().manual_seed(1))
    f1 = detect_and_describe(torch.from_numpy(img), cfg.detector)
    pe, _, _ = eng.localize_features(Features(*(torch.stack([t, t]) for t in f1)),
                                     generator=torch.Generator().manual_seed(1))
    assert bool(pf.success.all()) and bool(pe.success.all())
    np.testing.assert_allclose(pf.pose.C.numpy(), pe.pose.C.numpy(), atol=2e-2)


def test_empty_features_and_mapdb_equal_reference():
    for tf, jf in ((types.empty_features(7, "cpu"), jtypes.empty_features(7)),
                   (types.empty_mapdb(9, "cpu"), jtypes.empty_mapdb(9))):
        assert tf._fields == jf._fields
        back = convert.to_numpy(tf)
        for name in tf._fields:
            a, b = getattr(back, name), np.asarray(getattr(jf, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b)
    assert types.empty_mapdb(9, "cpu").desc.dtype == torch.int32
    assert int(types.empty_mapdb(9, "cpu").count) == 0


def test_disk_calibration_round_trip(tmp_path):
    """write_calib / read_calib both ways with coloc_tpu's."""
    rng = np.random.default_rng(4)
    Ks = np.stack([K, K * 1.1]).astype(np.float32)
    Ks[:, 2, 2] = 1.0
    dists = rng.normal(size=(2, 3)).astype(np.float32) * 0.01
    disk.write_calib(str(tmp_path / "port.txt"), (W, H), Ks, dists)
    jdisk.write_calib(str(tmp_path / "ref.txt"), (W, H), Ks, dists)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    for reader in (disk.read_calib, jdisk.read_calib):
        size, k2, d2 = reader(str(tmp_path / "port.txt"), 2)
        assert size == (W, H)
        np.testing.assert_array_equal(k2, Ks)
        np.testing.assert_array_equal(d2, dists)


def test_disk_frames_round_trip(tmp_path):
    """Frames on disk under the reference's names (.npy and PNG): counted,
    found and read as coloc_tpu reads them."""
    from PIL import Image

    rng = np.random.default_rng(5)
    imgs = {(d, f): rng.integers(0, 256, (12, 16)).astype(np.float32)
            for d in range(2) for f in range(3 - d)}
    for (d, f), img in imgs.items():
        assert disk.frame_path(str(tmp_path), d, f) == jdisk.frame_path(str(tmp_path), d, f)
        if d == 0:
            np.save(disk.frame_path(str(tmp_path), d, f, "npy"), img)
        else:
            Image.fromarray(img.astype(np.uint8)).save(disk.frame_path(str(tmp_path), d, f))
    assert [disk.num_frames(str(tmp_path), d) for d in range(3)] == [3, 2, 0]
    for (d, f), img in imgs.items():
        got = disk.load_frame(str(tmp_path), d, f)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, jdisk.load_frame(str(tmp_path), d, f))
    with pytest.raises(FileNotFoundError):
        disk.load_frame(str(tmp_path), 1, 5)
