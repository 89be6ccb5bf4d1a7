"""Parity of the port's TRIP frontend with coloc_tpu on the CPU.

The same numpy inputs go through coloc_tpu (Pallas kernels interpreted,
as conftest sets) and through the port, whose kernels B4 (FAST + NMS) and
B5 (patch extraction) run their plain twins on CPU tensors. Exact where
the arithmetic is the same; otherwise the tolerance says why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import frontend as jfront
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.ops import descriptor as jdesc
from coloc_tpu.ops import fast as jfast
from coloc_tpu.ops import orientation as jorient
from coloc_tpu.ops import patches as jpatch
from coloc_tpu.ops import pyramid as jpyr

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import frontend as tfront
from coloc_tpu_torch.io import synthetic as tsyn
from coloc_tpu_torch.ops import descriptor as tdesc
from coloc_tpu_torch.ops import fast as tfast
from coloc_tpu_torch.ops import orientation as torient
from coloc_tpu_torch.ops import patches as tpatch
from coloc_tpu_torch.ops import pyramid as tpyr
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W, LEVELS, KP = 240, 320, 4, 256
K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
OPTS = dict(width=W, height=H, max_keypoints=KP, num_levels=LEVELS,
            fast_threshold=12)


def _scene_images(n):
    """n renders of the bench scene family (float32), the first at identity."""
    scene = jsyn.make_scene(H, W, K, seed=1)
    Rs, Cs = jsyn.trajectory(max(n, 2), 0)
    imgs = [jsyn.render(scene, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    imgs += [jsyn.render(scene, Rs[i], Cs[i]) for i in range(1, n)]
    return np.stack(imgs).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    return _scene_images(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(desc_u32):
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8), axis=-1)


# ---- pyramid and blur ----------------------------------------------------

@pytest.mark.parametrize("radius", [2, 4])
def test_pyramid_and_blur(images, radius):
    """Resize matmuls sum in another order than XLA's: 1e-3 on 0-255."""
    jl = jpyr.build_pyramid_batch(jnp.asarray(images), LEVELS, 1.2)
    tl = tpyr.build_pyramid_batch(_t(images), LEVELS, 1.2)
    single = tpyr.build_pyramid(_t(images[0]), LEVELS, 1.2)
    for a, b, c in zip(jl, tl, single):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
        np.testing.assert_allclose(c.numpy(), np.asarray(a)[0], atol=1e-3)
    for lvl in jl:
        jb = jax.vmap(lambda im: jpyr.box_blur(im, radius))(lvl)
        tb = tpyr.box_blur(_t(lvl), radius)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3)
    assert tpyr.level_shapes(480, 752, 8, 1.2) == jpyr.level_shapes(480, 752, 8, 1.2)
    np.testing.assert_array_equal(tpyr._resize_matrix(752, 627),
                                  jpyr._resize_matrix(752, 627))


# ---- stacking, masks, origins --------------------------------------------

def test_stack_levels_mask_and_origins(images):
    rng = np.random.default_rng(3)
    jl = jpyr.build_pyramid_batch(jnp.asarray(images), LEVELS, 1.2)
    jsp = jpatch.stack_levels_batch(jl)
    tsp = tpatch.stack_levels_batch([_t(l) for l in jl])
    np.testing.assert_array_equal(tsp.stacked.numpy(), np.asarray(jsp.stacked))
    for f in ("row_base", "heights", "widths"):
        np.testing.assert_array_equal(getattr(tsp, f), getattr(jsp, f))
    assert tsp.img_rows == jsp.img_rows and tsp.wp == jsp.wp
    j1 = jpatch.stack_levels([l[0] for l in jl])
    t1 = tpatch.stack_levels([_t(l[0]) for l in jl])
    np.testing.assert_array_equal(t1.stacked.numpy(), np.asarray(j1.stacked))

    args = (tuple(int(r) for r in jsp.row_base), tuple(int(h) for h in jsp.heights),
            tuple(int(w) for w in jsp.widths), jsp.wp, jsp.img_rows, 16, 1.2)
    for batch in (1, 2):
        np.testing.assert_array_equal(tfront._detection_mask(*args, batch),
                                      jfront._detection_mask(*args, batch=batch))

    n = 300
    lvl = rng.integers(0, LEVELS, n).astype(np.int32)
    w_l, h_l = jsp.widths[lvl], jsp.heights[lvl]
    x = rng.uniform(-0.5, 1.0, n) * w_l
    y = rng.uniform(-0.5, 1.0, n) * h_l
    x[:4], y[:4] = w_l[:4] - 1.0, h_l[:4] - 1.0      # right and bottom edges
    x[4:8], y[4:8] = 0.0, 0.0
    x, y = x.astype(np.float32), y.astype(np.float32)
    jr, jc = jpatch.patch_origins(jsp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lvl))
    tr, tc = tpatch.patch_origins(tsp, _t(x), _t(y), _t(lvl).long())
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---- B4 twin -------------------------------------------------------------

def _planted(rng, h, w):
    """Random texture with planted plateaus of equal FAST scores: bright
    squares on black, whose corners and edges score exactly 255, and a
    corner square touching the raster border."""
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img[8:56, 8:120] = 0.0
    for y0 in range(12, 48, 12):
        for x0 in range(12, 112, 12):
            img[y0:y0 + 5, x0:x0 + 5] = 255.0
    img[:6, :6] = 255.0
    img[h - 10:, w - 10:] = 0.0
    img[h - 4:, w - 4:] = 255.0
    return img


@pytest.mark.parametrize("h,w", [(96, 160), (130, 257)])
def test_fast_nms_twin_matches_reference(h, w):
    img = _planted(np.random.default_rng(h * w), h, w)
    raw, nms = tfast.fast_nms(_t(img), 20.0)
    jraw = jfast.fast_score_map(jnp.asarray(img), 20.0)
    jnms = jfast.nms3(jraw)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    np.testing.assert_array_equal(nms.numpy(), np.asarray(jnms))
    praw, pnms = jfast.fast_nms_pallas(jnp.asarray(img), 20.0, interpret=True)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(praw))
    np.testing.assert_array_equal(nms.numpy(), np.asarray(pnms))
    # the planted plateau really ties: equal scores next to each other,
    # of which NMS keeps one
    r = raw.numpy()
    assert ((r[:, 1:] == r[:, :-1]) & (r[:, 1:] == 255.0)).sum() > 10
    assert (nms.numpy() == 255.0).sum() < (r == 255.0).sum()


# ---- top-k tie order (C2) -------------------------------------------------

@pytest.mark.parametrize("n,k", [(5000, 256), (60000, 1024)])
def test_topk_tie_order_matches_jax(n, k):
    rng = np.random.default_rng(n)
    s = rng.integers(0, 12, (2, n)).astype(np.float32)   # many equal scores
    s[:, rng.integers(0, n, n // 3)] = 0.0
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    av, ai = jax.lax.approx_max_k(jnp.asarray(s), k)
    tv, ti = tfast.topk_desc(_t(s), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ai))
    score = s[0].reshape(50, -1)
    jx, jy, js, jvalid = jfast.topk_keypoints(jnp.asarray(score), k, border=3, exact=True)
    tx, ty, ts, tvalid = tfast.topk_keypoints(_t(score), k, border=3)
    for a, b in ((jx, tx), (jy, ty), (js, ts), (jvalid, tvalid)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_subpixel_offsets_match():
    rng = np.random.default_rng(5)
    score = rng.uniform(0, 50, (40, 60)).astype(np.float32)
    score[10, 10:13] = 7.0                                # flat: denom 0
    x = np.concatenate([rng.integers(0, 60, 50), [0, 59, 11]]).astype(np.int32)
    y = np.concatenate([rng.integers(0, 40, 50), [0, 39, 10]]).astype(np.int32)
    jd = jfast.subpixel_offsets(jnp.asarray(score), jnp.asarray(x), jnp.asarray(y))
    td = tfast.subpixel_offsets(_t(score), _t(x), _t(y))
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---- B5 twin, sampling, orientation, descriptor ---------------------------

def _smoothed_stack(images):
    jl = jpyr.build_pyramid_batch(jnp.asarray(images), LEVELS, 1.2)
    sm = [jax.vmap(lambda im: jpyr.box_blur(im, 2))(l) for l in jl]
    return jpatch.stack_levels_batch(sm)


def test_extract_twin_matches_interpreted_kernel(images):
    sp = _smoothed_stack(images)
    src = np.asarray(sp.stacked)
    R, WP = src.shape
    rng = np.random.default_rng(7)
    n = 40
    row0 = (rng.integers(0, R - tpatch.PH, n) // 8 * 8).astype(np.int32)
    col0 = (rng.integers(0, WP - tpatch.PW, n) // 128 * 128).astype(np.int32)
    # the last level's rows, the last image's last window, the right edge
    last = int(sp.row_base[-1]) + sp.img_rows
    row0[:3] = [last, R - tpatch.PH, R - tpatch.PH]
    col0[:3] = [WP - tpatch.PW, WP - tpatch.PW, 0]
    got = tpatch.extract_patches(_t(src), _t(row0), _t(col0))
    want = jpatch.extract_patches(jnp.asarray(src), jnp.asarray(row0), jnp.asarray(col0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (n, tpatch.PH, tpatch.PW)


def _frontend_inputs(images):
    """The reference frontend's own intermediates for both images: patches,
    keypoints, origins and angles (coloc_tpu run step by step)."""
    opts = jcfg.DetectorOptions(**OPTS)
    feats = jfront.detect_and_describe_batch(jnp.asarray(images), opts)
    sp = _smoothed_stack(images)
    n = int(np.asarray(feats.valid).sum())
    lvl = np.asarray(feats.scale)[np.asarray(feats.valid)]
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    img_of = np.repeat(np.arange(images.shape[0]), KP)[np.asarray(feats.valid).reshape(-1)]
    scale = np.power(np.float32(1.2), lvl.astype(np.float32))
    kx, ky = (xy[:, 0] / scale).astype(np.float32), (xy[:, 1] / scale).astype(np.float32)
    row0, col0 = jpatch.patch_origins(sp, jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(lvl))
    row0 = np.asarray(row0)
    P = jpatch.extract_patches(sp.stacked, jnp.asarray(row0 + img_of * sp.img_rows),
                               col0)
    rb = sp.row_base[lvl]
    return dict(P=np.asarray(P), kx=kx, ky=ky, w=sp.widths[lvl].astype(np.float32),
                h=sp.heights[lvl].astype(np.float32), col0=np.asarray(col0),
                row0_local=(row0 - rb).astype(np.int32), n=n)


def test_sample_nearest_is_bf16_gather():
    rng = np.random.default_rng(11)
    P = rng.uniform(0, 255, (5, 64, 256)).astype(np.float32)
    lx = rng.uniform(-3, 260, (5, 77)).astype(np.float32)
    ly = rng.uniform(-3, 66, (5, 77)).astype(np.float32)
    lx[0, :4] = [0.5, 1.5, 2.5, 255.5]                    # half to even
    ly[0, :4] = [0.5, 1.5, 62.5, 63.5]
    want = jpatch.sample_nearest(jnp.asarray(P), jnp.asarray(lx), jnp.asarray(ly))
    got = tpatch.sample_nearest(_t(P), _t(lx), _t(ly))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_orientation_and_descriptor_given_reference_patches(images):
    d = _frontend_inputs(images)
    j_args = [jnp.asarray(d[k]) for k in ("P", "kx", "ky", "w", "h", "col0", "row0_local")]
    t_args = [_t(d[k]) for k in ("P", "kx", "ky", "w", "h", "col0", "row0_local")]
    ja = jorient.orientation_from_patches(*j_args)
    ta = torient.orientation_from_patches(*t_args)
    assert d["n"] > 300
    assert np.abs(ta.numpy() - np.asarray(ja)).max() <= 1e-5
    # given the reference's angles, bits differ only where a steered sample
    # lands on the other side of a .5 pixel boundary (cos/sin rounding of
    # XLA against torch)
    jd = jdesc.describe_from_patches(*j_args[:3], ja, *j_args[3:])
    td = tdesc.describe_from_patches(*t_args[:3], _t(ja), *t_args[3:])
    same = (_bits(td.numpy().view(np.uint32)) == _bits(np.asarray(jd))).mean()
    assert same >= 0.999, same


def test_descriptor_tables_equal_reference():
    np.testing.assert_array_equal(tdesc._POOL, jdesc._POOL)
    np.testing.assert_array_equal(tdesc._TRIPLETS, jdesc._TRIPLETS)
    assert tdesc._POOL.dtype == np.float32 and tdesc._TRIPLETS.dtype == np.int32
    for a, b in zip(torient.moment_tables(), jorient.moment_tables()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- the frontend end to end ----------------------------------------------

def _compare_same_keypoints(tf, jf):
    """Given the same levels: same valid keypoints in the same order."""
    jv = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), jv)
    np.testing.assert_array_equal(tf.scale.numpy()[jv], np.asarray(jf.scale)[jv])
    np.testing.assert_array_equal(tf.score.numpy()[jv], np.asarray(jf.score)[jv])
    assert np.abs(tf.xy.numpy()[jv] - np.asarray(jf.xy)[jv]).max() <= 1e-3
    assert np.abs(tf.angle.numpy()[jv] - np.asarray(jf.angle)[jv]).max() <= 1e-4
    same = (_bits(tf.desc.numpy().view(np.uint32)[jv])
            == _bits(np.asarray(jf.desc)[jv])).mean()
    assert same >= 0.995, same
    assert jv.sum() >= 0.9 * jv.size


@pytest.mark.parametrize("batch", [1, 2])
def test_frontend_given_reference_levels(images, batch):
    """The port's frontend after its pyramid stage, fed coloc_tpu's raw and
    smoothed levels (the single-image form through coloc_tpu's B == 1
    specialisation)."""
    jopts, topts = jcfg.DetectorOptions(**OPTS), tcfg.DetectorOptions(**OPTS)
    if batch == 1:
        lv = jpyr.build_pyramid(jnp.asarray(images[0]), LEVELS, 1.2)
        levels = [np.asarray(l)[None] for l in lv]
        smoothed = [np.asarray(jpyr.box_blur(l, 2))[None] for l in lv]
        jf = jax.tree_util.tree_map(lambda a: a[None],
                                    jfront.detect_and_describe(jnp.asarray(images[0]), jopts))
    else:
        lv = jpyr.build_pyramid_batch(jnp.asarray(images), LEVELS, 1.2)
        levels = [np.asarray(l) for l in lv]
        smoothed = [np.asarray(jax.vmap(lambda im: jpyr.box_blur(im, 2))(l)) for l in lv]
        jf = jfront.detect_and_describe_batch(jnp.asarray(images), jopts)
    tf = tfront._describe_from_levels([_t(l) for l in levels],
                                      [_t(s) for s in smoothed], topts)
    assert tf.xy.shape == (batch, KP, 2) and tf.desc.shape == (batch, KP, 16)
    _compare_same_keypoints(tf, jf)


@pytest.mark.parametrize("batch", [1, 2])
def test_frontend_from_raw_image(images, batch):
    """Each side builds its own pyramid: pyramid rounding may move a
    threshold or NMS decision, so keypoints are held as a set."""
    jopts, topts = jcfg.DetectorOptions(**OPTS), tcfg.DetectorOptions(**OPTS)
    if batch == 1:
        jf = jax.tree_util.tree_map(lambda a: np.asarray(a)[None],
                                    jfront.detect_and_describe(jnp.asarray(images[0]), jopts))
        tf = tfront.detect_and_describe(_t(images[0]), topts)
        tf = type(tf)(*(a[None] for a in tf))
    else:
        jf = jfront.detect_and_describe_batch(jnp.asarray(images), jopts)
        tf = tfront.detect_and_describe_batch(_t(images), topts)
    for b in range(batch):
        jv, tv = np.asarray(jf.valid)[b], tf.valid.numpy()[b]
        jxy, txy = np.asarray(jf.xy)[b][jv], tf.xy.numpy()[b][tv]
        jl, tl = np.asarray(jf.scale)[b][jv], tf.scale.numpy()[b][tv]
        d = np.abs(jxy[:, None, :] - txy[None, :, :]).max(-1)
        d = np.where(jl[:, None] == tl[None, :], d, np.inf)
        pair = d.argmin(axis=1)
        shared = d[np.arange(len(jxy)), pair] <= 1e-3
        assert shared.mean() >= 0.98, shared.mean()
        jb = _bits(np.asarray(jf.desc)[b][jv][shared])
        tb = _bits(tf.desc.numpy().view(np.uint32)[b][tv][pair[shared]])
        assert (jb == tb).mean() >= 0.99


def test_akaze_backend_raises():
    """backend="akaze" goes to the AKAZE frontend, never TRIP: its knob
    validation raises where TRIP would have run."""
    opts = tcfg.DetectorOptions(**OPTS, backend="akaze", akaze_sublevels=6)
    with pytest.raises(ValueError, match="akaze_sublevels"):
        tfront.detect_and_describe(torch.zeros(H, W), opts)


# ---- the scene generator ---------------------------------------------------

def test_scene_and_render_match_reference():
    js = jsyn.make_scene(H, W, K, seed=2)
    ts = tsyn.make_scene(H, W, K, seed=2)
    for a, b in zip(js.textures, ts.textures):
        np.testing.assert_allclose(b, a, atol=1e-3)
    for a, b in zip(js.alphas, ts.alphas):
        np.testing.assert_array_equal(b, a)
    Rs, Cs = jsyn.trajectory(4, 1)
    tR, tC = tsyn.trajectory(4, 1)
    np.testing.assert_allclose(tR, Rs, atol=1e-6)
    np.testing.assert_array_equal(tC, Cs)
    np.testing.assert_allclose(tsyn.render(ts, Rs[2], Cs[2]),
                               jsyn.render(js, Rs[2], Cs[2]), atol=1e-3)


@pytest.mark.parametrize("n_in,n_out", [(6, 480), (8, 752), (6, 240), (8, 320),
                                        (7, 3), (5, 11)])
def test_nearest_index_matches_jax_resize(n_in, n_out):
    src = np.arange(n_in, dtype=np.float32) * 3 + 1
    want = np.asarray(jax.image.resize(jnp.asarray(src), (n_out,), method="nearest"))
    np.testing.assert_array_equal(src[tsyn._nearest_index(n_in, n_out)], want)
