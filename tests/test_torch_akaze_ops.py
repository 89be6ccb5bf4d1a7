"""Parity of the port's AKAZE building blocks with coloc_tpu on the CPU:
the FED scale space (B10's plain twin), raster sampling (B11's plain
twin), the MLDB tables, orientation and descriptor, and the batched NMS.

The same numpy inputs go through coloc_tpu (Pallas kernels interpreted, as
conftest sets) and through the port, whose kernels run their plain twins
on CPU tensors. Each tolerance says why it is not exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.ops import diffusion as jdiff
from coloc_tpu.ops import fast as jfast
from coloc_tpu.ops import mldb as jmldb
from coloc_tpu.ops import patches as jpatch

from coloc_tpu_torch.ops import diffusion as tdiff
from coloc_tpu_torch.ops import fast as tfast
from coloc_tpu_torch.ops import mldb as tmldb
from coloc_tpu_torch.ops import patches as tpatch
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def images():
    """The AKAZE tests' frame (scene seed 3 at identity) and a noisy copy."""
    scene = jsyn.make_scene(H, W, K, seed=3)
    img = jsyn.render(scene, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rng = np.random.default_rng(7)
    img2 = np.clip(img + rng.uniform(-30, 30, img.shape), 0, 255)
    return np.stack([img, img2]).astype(np.float32)


@pytest.fixture(scope="module")
def levels(images):
    """coloc_tpu's and the port's scale spaces of both images (4 octaves of
    4 sublevels, the AKAZE preset)."""
    jl = jdiff.build_scale_space_batch(jnp.asarray(images))
    tl = tdiff.build_scale_space_batch(_t(images))
    return jl, tl


# ---- the FED scale space ---------------------------------------------------

@pytest.mark.parametrize("tau_max", [0.25, 0.1])
def test_fed_tau_cycle_equals_reference(tau_max):
    for T in (1e-4, 0.5, 1.155, 3.0, 20.0):
        assert tdiff.fed_tau_cycle(T, tau_max) == jdiff.fed_tau_cycle(T, tau_max)


def test_contrast_factor_same_bin(images):
    """The same histogram bin on every test frame, k within 1e-6 relative:
    a one-bin difference would shift every level. On failure the message
    gives each side's gradient maximum hmax (k = hmax (bin + 1) / 300), the
    pixel where it is reached, and the port's k computed again from a
    fresh copy of the frames: which side moved, where, and whether the
    move repeats."""
    img = images / 255.0
    kj = np.asarray(jax.vmap(jdiff.contrast_factor)(jnp.asarray(img)))
    kt = tdiff.contrast_factor(_t(img)).numpy()
    seen = []
    for b in range(2):
        gx, gy = jdiff._scharr(jnp.asarray(img[b]))
        mj = np.asarray(jnp.sqrt(gx * gx + gy * gy))
        tx, ty = tdiff._scharr(_t(img[b]))
        mt = torch.sqrt(tx * tx + ty * ty).numpy()
        hj, ht = float(mj.max()), float(mt.max())
        seen.append(f"frame {b}: coloc_tpu hmax {hj!r} at {np.unravel_index(mj.argmax(), mj.shape)}"
                    f", port hmax {ht!r} at {np.unravel_index(mt.argmax(), mt.shape)}")
        assert round(kj[b] * 300 / hj) == round(kt[b] * 300 / ht), seen[-1]
    if not np.allclose(kt, kj, rtol=1e-6, atol=0.0):
        again = tdiff.contrast_factor(_t(images / 255.0)).numpy()
        seen.append(f"k coloc_tpu {kj.tolist()}, port {kt.tolist()}, port again "
                    f"{again.tolist()}")
    np.testing.assert_allclose(kt, kj, rtol=1e-6, err_msg="; ".join(seen))


def test_contrast_factor_deterministic(images, one_torch_thread):
    """The port's k is a function of the frames alone: bit-identical with
    1, 2 and the default number of torch threads and on repeated calls
    (every op in contrast_factor is one IEEE operation a value, a maximum
    or an integer sum, so no thread split or vector width may move it)."""
    img = _t(images / 255.0)
    threads = torch.get_num_threads()
    want = tdiff.contrast_factor(img.clone())
    try:
        for n in (1, 2, one_torch_thread):
            torch.set_num_threads(n)
            for _ in range(3):
                assert torch.equal(tdiff.contrast_factor(img.clone()), want), n
    finally:
        torch.set_num_threads(threads)


def _octave_inputs(h, w):
    rng = np.random.default_rng(h * w)
    L = rng.uniform(0, 1, (2, h, w)).astype(np.float32)
    k2 = np.array([0.01, 0.04], np.float32)
    cycles = tuple(tuple(jdiff.fed_tau_cycle(dt)) for dt in (1.155, 0.53, 0.75, 1.06))
    return L, k2, cycles, (1.0, 1.7, 2.9, 5.1)


@pytest.mark.parametrize("h,w", [(120, 188), (37, 61)])
def test_fed_octave_plain_matches_interpreted_kernel(h, w):
    """B=2 with distinct k^2, odd sizes: atol 1e-6 on all four planes, the
    tolerance coloc_tpu holds its own two forms to (XLA:CPU may contract a
    multiply-add into an FMA where the port rounds both)."""
    L, k2, cycles, s4 = _octave_inputs(h, w)
    want = jdiff.fed_octave_pallas(jnp.asarray(L), jnp.asarray(k2), h, w, cycles,
                                   s4, interpret=True)
    got = tdiff.fed_octave(_t(L), _t(k2), cycles, s4)
    for g, wnt, name in zip(got, want, ("L", "Lx", "Ly", "response")):
        assert g.shape == (2, 4, h, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-6, err_msg=name)


def test_fed_octave_plain_matches_step_form():
    """The port's twin against its own copy of coloc_tpu's XLA per-step form
    (_diffusion_step, _hessian_response): the two Scharr summation orders
    agree to 1e-6."""
    L, k2, cycles, s4 = _octave_inputs(37, 61)
    got = tdiff.fed_octave_plain(_t(L), _t(k2), cycles, s4)
    for b in range(2):
        Lr = _t(L[b])
        for s, taus in enumerate(cycles):
            gx, gy = tdiff._scharr(Lr)
            g = 1.0 / (1.0 + (gx * gx + gy * gy) / float(k2[b]))
            for tau in taus:
                Lr = tdiff._diffusion_step(Lr, g, tau)
            resp, Lx, Ly = tdiff._hessian_response(Lr, s4[s] ** 0.25)
            for plane, want in zip(got, (Lr, Lx, Ly, resp)):
                np.testing.assert_allclose(plane[b, s].numpy(), want.numpy(), atol=1e-6)


def test_build_scale_space_matches_reference(levels):
    """Every level of the batched scale space within 1e-5 at 240x320: 16
    levels of chained FED steps, each 1e-7 apart."""
    jl, tl = levels
    assert len(tl) == len(jl) == 16
    for a, b in zip(jl, tl):
        assert (b.sigma, b.octave) == (a.sigma, a.octave)
        for x, y in zip(a[:4], b[:4]):
            assert y.shape == x.shape
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
    assert [tuple(ev.L.shape[1:]) for ev in tl[::4]] == [(240, 320), (120, 160),
                                                        (60, 80), (30, 40)]


def test_build_scale_space_single_equals_batch(images, levels):
    _, tl = levels
    single = tdiff.build_scale_space(_t(images[1]))
    for a, b in zip(tl, single):
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x[1], y)


# ---- raster sampling (B11) -------------------------------------------------

def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _sample_case(C, ph, K, seed):
    """A bf16 source of 6 rasters of `stride` rows, origins (unaligned, in
    range), window-local coordinates with .5 ties and samples outside the
    window."""
    rng = np.random.default_rng(seed)
    stride, WP, pw = 200, 384, 128
    src = _bf16(rng.uniform(-3, 3, (6 * stride, WP)).astype(np.float32))
    NS = 49 if C == 2 else 464
    row0 = rng.integers(0, 6 * stride - (C - 1) * stride - ph + 1, K).astype(np.int32)
    col0 = rng.integers(0, WP - pw + 1, K).astype(np.int32)
    lx = rng.uniform(-6, pw + 5, (K, NS)).astype(np.float32)
    ly = rng.uniform(-6, ph + 5, (K, NS)).astype(np.float32)
    lx[:, :6] = [0.5, 1.5, 2.5, 126.5, 127.5, -0.5]
    ly[:, :6] = [0.5, 1.5, ph - 1.5, ph - 0.5, 3.5, -0.5]
    return src, stride, row0, col0, lx, ly, pw


@pytest.mark.parametrize("C,ph", [(2, 48), (3, 64)])
def test_sample_raster_plain_matches_interpreted_kernel(C, ph):
    """Both AKAZE sampler shapes (orientation: 2 channels, 48 rows, 49
    samples; descriptor: 3 channels, 64 rows, 464 samples), K = 37 (not a
    multiple of the kernel's 32): exactly equal."""
    src, stride, row0, col0, lx, ly, pw = _sample_case(C, ph, 37, C)
    want = jpatch._sample_raster_pallas(
        jnp.asarray(src.float().numpy()).astype(jnp.bfloat16), jnp.asarray(row0),
        jnp.asarray(col0), jnp.asarray(lx), jnp.asarray(ly), C, stride, ph, pw,
        interpret=True)
    got = tpatch.sample_raster_flat(src, stride, _t(row0), _t(col0), _t(lx), _t(ly),
                                    C=C, ph=ph, pw=pw)
    assert got.shape == (C, 37, lx.shape[1]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_raster_plain_clamps_origins_like_reference():
    """Origins past the raster's end: rounded to the tile grid, then
    clamped, as coloc_tpu's dynamic_slice + sample_nearest composition
    does. (Origins are never negative: patch_origins clamps them at 0, and
    dynamic_slice would wrap a negative start where the kernel clamps.)"""
    C, ph, pw = 3, 64, 128
    src, stride, row0, col0, lx, ly, _ = _sample_case(C, ph, 9, 5)
    R, WP = src.shape
    row0[:5] = [R + 17, R, R - ph - 3, 2 * stride + 5, 7]
    col0[:5] = [WP, 2 * WP + 5, WP - pw + 7, 1, 300]
    srcj = jnp.asarray(src.float().numpy()).astype(jnp.bfloat16)
    want = []
    for c in range(C):
        P = jax.vmap(lambda r, cc, c=c: jax.lax.dynamic_slice(
            srcj, ((r // 8) * 8 + c * stride, (cc // 128) * 128), (ph, pw)))(
                jnp.asarray(row0), jnp.asarray(col0))
        want.append(np.asarray(jpatch.sample_nearest(P, jnp.asarray(lx), jnp.asarray(ly))))
    got = tpatch.sample_raster_flat(src, stride, _t(row0), _t(col0), _t(lx), _t(ly),
                                    C=C, ph=ph, pw=pw)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


# ---- MLDB tables, orientation, descriptor ----------------------------------

@pytest.mark.parametrize("cell_samples", [1, 2, 3, 4])
def test_mldb_tables_equal_reference(cell_samples):
    np.testing.assert_array_equal(tmldb._DISC, jmldb._DISC)
    assert tmldb._DISC.dtype == np.float32 and tmldb._DISC.shape == (49, 2)
    for a, b in zip(tmldb._grid_cells(cell_samples), jmldb._grid_cells(cell_samples)):
        np.testing.assert_array_equal(a, b)


def _angle_diff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


def test_orientation_and_descriptor_given_same_samples(levels):
    """Both describers sample the same bf16 raster (L, Lx, Ly of coloc_tpu's
    level 1, image 0) at 300 keypoints, each through its own sampler (equal,
    above). The one-hot sums and cell means are float32 products whose
    summation order differs from XLA's, so a near-tie may flip: angles within
    1e-5 rad on >= 99% of keypoints, >= 99.9% of descriptor bits equal given
    the same angles."""
    jl, _ = levels
    ev = jl[1]
    raster = np.zeros((3 * H, 384), np.float32)
    for c, plane in enumerate((ev.L, ev.Lx, ev.Ly)):
        raster[c * H:(c + 1) * H, :W] = np.asarray(plane[0])
    src = _bf16(raster)
    rng = np.random.default_rng(9)
    n = 300
    kx = rng.uniform(27, 100, n).astype(np.float32)
    ky = rng.uniform(20, H - 20, n).astype(np.float32)
    sig = rng.uniform(1.6, 2.7, n).astype(np.float32)
    w_l, h_l = np.full(n, W, np.float32), np.full(n, H, np.float32)
    col0 = np.zeros(n, np.int32)
    row0 = np.clip(((np.round(ky).astype(np.int32) - 27) >> 3) << 3, 0, H - 64).astype(np.int32)
    srcj = jnp.asarray(raster).astype(jnp.bfloat16)

    def jsampler(first, C):
        def f(lx, ly):
            return jnp.stack([jpatch.sample_nearest(
                jax.vmap(lambda r, c=c: jax.lax.dynamic_slice(
                    srcj, (r + (first + c) * H, 0), (64, 128)))(jnp.asarray(row0)),
                lx, ly) for c in range(C)])
        return f

    def tsampler(first, C):
        return lambda lx, ly: tpatch.sample_raster_flat(
            src, H, _t(row0 + first * H), _t(col0), lx, ly, C=C, ph=64, pw=128)

    jargs = [jnp.asarray(a) for a in (kx, ky, sig, w_l, h_l, col0, row0)]
    targs = [_t(a) for a in (kx, ky, sig, w_l, h_l, col0, row0)]
    ja = np.asarray(jmldb.orientation(jsampler(1, 2), *jargs))
    ta = tmldb.orientation(tsampler(1, 2), *targs).numpy()
    assert (_angle_diff(ta, ja) <= 1e-5).mean() >= 0.99
    jd = np.asarray(jmldb.describe_mldb(jsampler(0, 3), *jargs[:3], jnp.asarray(ja),
                                        *jargs[3:]))
    td = tmldb.describe_mldb(tsampler(0, 3), *targs[:3], _t(ja), *targs[3:])
    td = td.numpy().view(np.uint32)
    bits = lambda d: np.unpackbits(np.ascontiguousarray(d).view(np.uint8), axis=-1)
    assert (bits(td) == bits(jd)).mean() >= 0.999
    assert (td[:, 15] >> 6 == 0).all()             # bits 486-511 are zero


# ---- batched NMS -------------------------------------------------------------

def test_nms3_batch_equals_per_image_loop():
    """nms3 over (B, h, w) equals nms3 of each image, and coloc_tpu's
    jax.vmap(nms3), plateaus included."""
    rng = np.random.default_rng(4)
    s = rng.integers(0, 4, (3, 40, 57)).astype(np.float32)   # many equal scores
    got = tfast.nms3(_t(s))
    for b in range(3):
        assert torch.equal(got[b], tfast.nms3(_t(s[b])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.vmap(jfast.nms3)(jnp.asarray(s))))
