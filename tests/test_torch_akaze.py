"""Parity of the port's AKAZE-MLDB frontend with coloc_tpu on the CPU, end
to end, and of the AKAZE match+localize slice.

tests/test_akaze.py's frame and options (scene seed 3 at identity, 240x320,
512 keypoints, 8 levels) go through coloc_tpu (Pallas kernels interpreted,
as conftest sets; one module-scoped call, ~35 s) and through the port,
whose kernels B10 and B11 run their plain twins on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import ransac as jransac
from coloc_tpu.frontend import detect_and_describe as j_detect
from coloc_tpu.geometry import camera as jcam
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.matching import match_with_map as j_match_with_map
from coloc_tpu.sfm.localize import localize_image as j_localize_image
from coloc_tpu.types import MapDB as JMapDB

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch import frontend as tfront
from coloc_tpu_torch.io import synthetic as tsyn
from coloc_tpu_torch.matching import match_with_map, pack_map_bank
from coloc_tpu_torch.sfm import ba as tba
from coloc_tpu_torch.sfm.localize import localize_image
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
OPTS = dict(width=W, height=H, max_keypoints=512, num_levels=8, backend="akaze")


@pytest.fixture(scope="module")
def img():
    scene = jsyn.make_scene(H, W, K, seed=3)
    return jsyn.render(scene, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def features(img):
    """coloc_tpu's and the port's features of the frame, as numpy."""
    jf = jax.tree_util.tree_map(np.asarray,
                                j_detect(jnp.asarray(img), jcfg.DetectorOptions(**OPTS)))
    tf = convert.to_numpy(tfront.detect_and_describe(torch.from_numpy(img),
                                                     tcfg.DetectorOptions(**OPTS)))
    return jf, tf


def _bits(desc_u32):
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8), axis=-1)


def test_frontend_matches_reference(features):
    """>= 98% of coloc_tpu's keypoints shared (same level, xy within 1e-3
    px), >= 99% of descriptor bits equal on the shared ones, and the
    padding bits 486-511 zero. Not exact: the Scharr sums, the orientation
    histogram and the cell means round in another order than XLA's, so a
    near-tie in a response, an angle bin or a cell comparison may flip."""
    jf, tf = features
    jv, tv = jf.valid, tf.valid
    assert jv.sum() > 100 and tv.sum() > 100
    d = np.abs(jf.xy[jv][:, None, :] - tf.xy[tv][None, :, :]).max(-1)
    d = np.where(jf.scale[jv][:, None] == tf.scale[tv][None, :], d, np.inf)
    pair = d.argmin(axis=1)
    shared = d[np.arange(jv.sum()), pair] <= 1e-3
    assert shared.mean() >= 0.98
    jb, tb = _bits(jf.desc[jv][shared]), _bits(tf.desc[tv][pair[shared]])
    assert (jb == tb).mean() >= 0.99
    assert (tf.desc[:, 15] >> 6 == 0).all()
    assert tf.desc.shape == (512, 16) and tf.xy.dtype == np.float32


def test_batch_equals_single(img):
    """The batched frontend (one FED launch an octave for the batch, the
    images' rasters stacked) equals the single path bit for bit."""
    rng = np.random.default_rng(7)
    img2 = np.clip(img + rng.uniform(-30, 30, img.shape), 0, 255).astype(np.float32)
    imgs = torch.from_numpy(np.stack([img, img2]))
    opts = tcfg.DetectorOptions(**OPTS)
    fb = tfront.detect_and_describe_batch(imgs, opts)
    for i in range(2):
        f1 = tfront.detect_and_describe(imgs[i], opts)
        for a, b in zip(fb, f1):
            assert torch.equal(a[i], b)


@pytest.mark.parametrize("knob,value", [("akaze_sublevels", 0), ("akaze_sublevels", 6),
                                        ("akaze_cell_samples", 0),
                                        ("akaze_cell_samples", 9)])
def test_knob_validation_raises_like_reference(img, knob, value):
    """Out-of-range AKAZE knobs raise ValueError with coloc_tpu's message,
    before any work (and never fall through to TRIP)."""
    with pytest.raises(ValueError) as jerr:
        j_detect(jnp.asarray(img), jcfg.DetectorOptions(**OPTS, **{knob: value}))
    with pytest.raises(ValueError) as terr:
        tfront.detect_and_describe(torch.from_numpy(img),
                                   tcfg.DetectorOptions(**OPTS, **{knob: value}))
    assert str(terr.value) == str(jerr.value)


def _rot_angle(Ra, Rb):
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(np.linalg.norm(w), (np.trace(M) - 1.0) / 2.0))


def test_akaze_match_localize_parity(features):
    """coloc_tpu's AKAZE features against a consistent 1024-landmark map
    (landmarks on half-pixel-noisy bearings, 25% of the frame's moved),
    through coloc_tpu's and the port's ratio match_with_map and
    localize_image, the port handed coloc_tpu's P3P draws: equal matches,
    and the pose within tests/test_torch_localize.py's tolerances on
    coloc_tpu's inlier set."""
    jf, _ = features
    rng = np.random.default_rng(5)
    noisy = jf._replace(xy=jf.xy + rng.normal(0, 0.5, jf.xy.shape).astype(np.float32))
    ma = tsyn.consistent_mapdb(noisy, K, 1024, rng)
    n_out = 128
    X = ma.X.copy()
    X[:n_out] = rng.uniform(-20.0, 20.0, (n_out, 3)).astype(np.float32)
    ma = ma._replace(X=X)

    jmapdb = JMapDB(X=jnp.asarray(ma.X), desc=jnp.asarray(ma.desc),
                    valid=jnp.asarray(ma.valid))
    jfeats = jax.tree_util.tree_map(jnp.asarray, jf)
    jcamera = jcam.Camera(K=jnp.asarray(K), dist=jnp.zeros(3, jnp.float32))
    key = jax.random.PRNGKey(3)
    jopts = jcfg.MatcherOptions(mode="ratio")
    jm = j_match_with_map(jfeats, jmapdb, jopts)
    jpwc, jinl = j_localize_image(key, jfeats, jm, jmapdb, jcamera,
                                  jcfg.RansacOptions(), jcfg.RefinerOptions())
    draws = np.asarray(jransac.sample_indices(key, jm.mask & jfeats.valid, 256, 3))

    feats = convert.features_from_numpy(jf, "cpu")
    mapdb = convert.mapdb_from_numpy(ma, "cpu")
    cam = convert.camera_from_numpy(K, device="cpu")
    tm = match_with_map(feats, mapdb, tcfg.MatcherOptions(mode="ratio"),
                        bank=pack_map_bank(mapdb))
    tpwc, tinl = localize_image(feats, tm, mapdb, cam, tcfg.RansacOptions(),
                                tcfg.RefinerOptions(), sample_idx=torch.from_numpy(draws.copy()))

    for field in ("idx", "best", "second", "mask"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                      np.asarray(getattr(jm, field)))
    assert int(tm.mask.sum()) > 200
    assert bool(tpwc.success) and bool(jpwc.success)
    assert abs(int(tpwc.n_tracks) - int(jpwc.n_tracks)) <= 1
    jinl = np.asarray(jinl)
    assert (tinl.numpy() != jinl).sum() <= 4
    R, C = tpwc.pose.R, tpwc.pose.C
    if not np.array_equal(tinl.numpy(), jinl):
        ref = tba.refine_pose_only(R, C, mapdb.X[tm.idx.long()], feats.xy,
                                   torch.from_numpy(jinl), cam.K, cam.dist,
                                   tcfg.RefinerOptions())
        R, C = ref.Rs[1], ref.Cs[1]
    assert _rot_angle(R.numpy(), np.asarray(jpwc.pose.R)) < 1e-4
    np.testing.assert_allclose(C.numpy(), np.asarray(jpwc.pose.C), atol=1e-4)
    assert not tinl[:n_out].any()
    assert _rot_angle(R.numpy(), np.eye(3)) < 1e-2 and float(C.norm()) < 5e-2
