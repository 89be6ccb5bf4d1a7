"""Parity of the port's two-view path with coloc_tpu on the CPU: the
five-point solver's three stages (B6-B8 plain twins), the epipolar ladder
rank (B9 plain twin), the essential-matrix residuals, decomposition and
refinement, triangulation, SE(3), match_pair and relative_pose_essential.

coloc_tpu's Pallas kernels run in interpret mode (tests/conftest.py).
XLA:CPU contracts multiply-adds into FMAs where torch does not (ROADMAP
C8), so float32 results differ in the last bits and the five-point
solver's Gauss-Jordan and degree-10 polynomial amplify that: those stages
are held by what they are for (the solutions captured) and by their
distance to a float64 evaluation, with each tolerance's reason beside it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu import robust as jrobust
from coloc_tpu.frontend import detect_and_describe as j_detect
from coloc_tpu.geometry import camera as jcam
from coloc_tpu.geometry import essential as jess
from coloc_tpu.geometry import fivept as jfp
from coloc_tpu.geometry import se3 as jse3
from coloc_tpu.geometry import so3 as jso3
from coloc_tpu.geometry import triangulation as jtri
from coloc_tpu.io import synthetic as jsyn
from coloc_tpu.ops import ransac_rank as jrank
from coloc_tpu.types import Pose as JPose

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch import matching as tmatching
from coloc_tpu_torch import robust as trobust
from coloc_tpu_torch.csrc import gen_fivept_constraints
from coloc_tpu_torch.geometry import essential as tess
from coloc_tpu_torch.geometry import fivept as tfp
from coloc_tpu_torch.geometry import se3 as tse3
from coloc_tpu_torch.geometry import triangulation as ttri
from coloc_tpu_torch.io import synthetic as tsyn
from coloc_tpu_torch.ops import ransac_rank as trank
from coloc_tpu_torch.types import Pose
from port_harness import one_torch_thread, time_limit  # noqa: F401

B = 37  # not a multiple of the TPU kernels' 128-lane tile


def _t(a):
    return torch.from_numpy(np.array(a))


def _samples(seed=0, n=8):
    """B samples of n correspondences between two views, the second half on
    a plane (the twin-solution regime), as tests/test_robust.py."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-3, 3, (B * n, 2)), rng.uniform(5, 15, (B * n, 1))].reshape(B, n, 3)
    X[B // 2:, :, 2] = 8.0
    Xc = X - [0.3, 0.05, 0.0]
    return ((X[..., :2] / X[..., 2:]).astype(np.float32),
            (Xc[..., :2] / Xc[..., 2:]).astype(np.float32))


def _pack(x1, x2):
    return np.concatenate([x1[:, :5, 0], x1[:, :5, 1], x2[:, :5, 0], x2[:, :5, 1]], axis=1)


def _jax_front(xs):
    """coloc_tpu's B6 on (B, 20) packed samples, as _five_point_batch_pallas
    launches it (lane-padded to 128)."""
    T = jfp._LANE_TILE
    xsT = np.pad(xs, ((0, T - xs.shape[0]), (0, 0))).T
    spec = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * (len(shape) - 1) + (i,))
    outs = pl.pallas_call(
        jfp._front_kernel, grid=(1,), in_specs=[spec(20, T)],
        out_specs=[spec(36, T), spec(40, 20, T), spec(40, T), spec(11, T)],
        out_shape=[jax.ShapeDtypeStruct(s, jnp.float32)
                   for s in ((36, T), (40, 20, T), (40, T), (11, T))],
        interpret=True)(jnp.asarray(xsT))
    return [np.asarray(o)[..., :xs.shape[0]] for o in outs]


@pytest.fixture(scope="module")
def front_outputs():
    x1, x2 = _samples()
    xs = _pack(x1, x2)
    port = [a.numpy() for a in tfp.front_plain(_t(xs.T))]
    f64 = [a.numpy() for a in tfp.front_plain(_t(xs.T).double())]
    return _jax_front(xs), port, f64


def test_constraint_header_is_generated():
    """csrc/fivept_constraints.cuh is the generator's output for the twin's
    _constraint_rows: the kernel expands in the twin's order."""
    assert gen_fivept_constraints.render() == gen_fivept_constraints.HEADER.read_text()


def _header_functions():
    """The generated header's device functions: name -> statement lines."""
    text = gen_fivept_constraints.HEADER.read_text()
    return {m.group(1): m.group(2).splitlines()
            for m in re.finditer(r"void (\w+)\(.*?\) \{\n(.*?)\n\}", text, re.S)}


_ARITH = {"+": np.add, "-": np.subtract, "*": np.multiply}


def _run_header(lines, **inputs):
    """One generated function's statements, each run as one float32 IEEE
    operation on (N,) numpy arrays, as the kernel runs them (-fmad=false).
    inputs: the function's arrays as nested lists. -> its out[] values."""
    env, out = {}, {}

    def val(tok):
        if tok in env:
            return env[tok]
        if tok.endswith("f") and not tok[0].isalpha():
            return np.float32(float(tok[:-1]))
        name, *idx = re.findall(r"\w+", tok)
        v = inputs[name]
        for i in idx:
            v = v[int(i)]
        return v

    for line in lines:
        m = re.fullmatch(r"\s*const float (t\d+) = (.+);", line)
        if m:
            parts = m.group(2).split(" ")
            env[m.group(1)] = (np.negative(val(parts[0][1:])) if len(parts) == 1 else
                               _ARITH[parts[1]](val(parts[0]), val(parts[2]), dtype=np.float32))
            continue
        i, tok = re.fullmatch(r"\s*out\[(\d+)\] = (\S+);", line).groups()
        out[int(i)] = val(tok)
    return [out[i] for i in range(len(out))]


def _same_bits(got, want):
    """Equal NaN positions, and equal float32 bits elsewhere (signed zeros
    count)."""
    got, want = np.ascontiguousarray(got, np.float32), np.ascontiguousarray(want, np.float32)
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32)))


@pytest.mark.parametrize("case", ["ordinary", "edges"])
def test_lane_split_constraints_equal_front_plain(case):
    """B6 spreads the constraint expansion over a warp's lanes: lane 3 r + c
    runs the header's eet_entry, then row_entry on (E E^T)[r][k] and the
    diagonal gathered from the other lanes; lanes 9-11 run det_term, one
    cofactor term of det E each, and lane 9 det_combine; each row's lane
    runs md_rows. Run statement by statement in numpy float32 on the
    twin's null bases, that split gives front_plain's M and MD bit for bit,
    so it keeps the twin's order of operations. ordinary: B samples,
    half planar; edges: io/synthetic.five_point_edge_samples (repeated and
    collinear points, all-zero coordinates, a NaN)."""
    if case == "ordinary":
        x1, x2 = _samples(seed=2)
    else:
        x1, x2 = tsyn.five_point_edge_samples()
    basis, md, _, _ = tfp.front_plain(_t(_pack(x1, x2).T))
    nb = basis.numpy().reshape(4, 9, -1)
    fns = _header_functions()

    def rows_of(r):     # [v][k]: basis v at (r, k)
        return [[nb[v][3 * r + k] for k in range(3)] for v in range(4)]

    eet = {(r, c): _run_header(fns["eet_entry"], a=rows_of(r), c=rows_of(c))
           for r in range(3) for c in range(3)}
    # det E: cofactor term j on lane 9 + j, (a, b) = (1, 2), (0, 2), (0, 1)
    terms = [_run_header(fns["det_term"], d=[[nb[v][3 * r + c] for v in range(4)]
                                             for r, c in ((0, j), (1, a), (2, b), (1, b), (2, a))])
             for j, (a, b) in enumerate(((1, 2), (0, 2), (0, 1)))]
    M = [_run_header(fns["det_combine"], t=terms)]
    for r in range(3):
        for c in range(3):
            M.append(_run_header(
                fns["row_entry"], er=[eet[r, k] for k in range(3)],
                dg=[eet[k, k] for k in range(3)],
                ec=[[nb[v][3 * k + c] for k in range(3)] for v in range(4)],
                e=[nb[v][3 * r + c] for v in range(4)]))
    M = np.stack([np.stack(np.broadcast_arrays(*row)) for row in M])      # (10, 20, N)
    MD = np.zeros((30, 20, M.shape[2]), np.float32)
    for i in range(10):
        d = np.stack(np.broadcast_arrays(*_run_header(fns["md_rows"], m=list(M[i]))))
        for a in range(3):
            MD[10 * a + i] = d[20 * a:20 * a + 20]
    assert _same_bits(M, md.numpy()[:10])
    assert _same_bits(MD, md.numpy()[10:])


def test_constants_match_reference():
    assert tfp._MONOMIALS == jfp._MONOMIALS
    np.testing.assert_array_equal(tfp._DIFF_MATS, np.asarray(jfp._DIFF_MATS))
    assert tfp._DIFF_TERMS == jfp._DIFF_TERMS
    assert tfp._SEEDS <= jfp._SEED_ROWS


def _per_sample_rel(a, b, scale):
    a, b, scale = (x.reshape(-1, B) for x in (a, b, scale))
    return np.abs(a - b).max(axis=0) / np.abs(scale).max(axis=0)


@pytest.mark.parametrize("name,i,tol", [("basis", 0, 1e-5), ("md", 1, 5e-5)])
def test_front_basis_and_md_match_reference(front_outputs, name, i, tol):
    """Per sample, relative to its largest entry. The basis agrees to 1e-5;
    MD is the cubic expansion of the basis, so its last-bit differences
    (FMA contraction in XLA) grow about threefold: 5e-5."""
    jo, to, _ = front_outputs
    assert _per_sample_rel(to[i], jo[i], jo[i]).max() <= tol


@pytest.mark.parametrize("name,i", [("coef", 2), ("npoly", 3)])
def test_front_polynomials_as_accurate_as_reference(front_outputs, name, i):
    """Gauss-Jordan and the 3x3 polynomial determinant cancel heavily, so
    float32 coefficients differ from the float64 evaluation by up to ~1e-2
    (coef) and O(1) (npoly, relative to its largest coefficient) in BOTH
    packages, and a last-bit difference between them is amplified alike.
    Element-wise equality is meaningless there: the port's front must be
    as close to the float64 evaluation as coloc_tpu's kernel is (median and
    worst sample within 2x); test_five_point_captures_reference_solutions
    holds the end result."""
    jo, to, f64 = front_outputs
    ej = _per_sample_rel(jo[i], f64[i], f64[i])
    et = _per_sample_rel(to[i], f64[i], f64[i])
    assert np.median(et) <= 2.0 * np.median(ej)
    assert et.max() <= 2.0 * ej.max()


def test_dk_roots_match_reference(front_outputs):
    """Same coefficients into both DK stages. Masks agree. 24 float32 DK
    iterations + 3 Newton steps leave some roots unconverged at ~1e-3 (a
    clustered pair at ~3e-2), identically in both packages, so a last-bit
    difference moves them: >= 95% of the real roots agree to 1e-4
    relative and all to 5e-2; the polish's 5 GN steps converge them."""
    npoly = front_outputs[0][3]
    jr, jm = jfp._dk_roots_batch(jnp.asarray(npoly.T))
    c, s = tfp.dk_normalise(_t(npoly))
    tr, tm = tfp.dk_roots_plain(c, s)
    jr, jm = np.asarray(jr).T, np.asarray(jm).T
    np.testing.assert_array_equal(tm.numpy(), jm)
    rel = (np.abs(tr.numpy() - jr) / (np.abs(jr) + 1e-6))[jm]
    assert (rel <= 1e-4).mean() >= 0.95
    assert rel.max() <= 5e-2


def _jax_polish(md, coef, basis, seeds, svalid):
    """coloc_tpu's B8 on the front's outputs and (30, B) seeds, as
    _five_point_batch_pallas launches it (seed rows padded to 32, lanes to
    128). -> (E (B, 30, 9), valid (B, 30))."""
    T, R, nb = jfp._LANE_TILE, jfp._SEED_ROWS, md.shape[-1]

    def pad(a, rows=None):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, T - nb)]
        if rows is not None:
            widths[0] = (0, rows - a.shape[0])
        return jnp.asarray(np.pad(a, widths))

    spec = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * (len(shape) - 1) + (i,))
    es, val = pl.pallas_call(
        jfp._polish_kernel, grid=(1,),
        in_specs=[spec(40, 20, T), spec(40, T), spec(36, T), spec(R, T), spec(R, T)],
        out_specs=[spec(9, R, T), spec(R, T)],
        out_shape=[jax.ShapeDtypeStruct((9, R, T), jnp.float32),
                   jax.ShapeDtypeStruct((R, T), jnp.float32)],
        interpret=True)(pad(md), pad(coef), pad(basis), pad(seeds, R),
                        pad(svalid.astype(np.float32), R))
    return (np.asarray(es)[:, :30, :nb].transpose(2, 1, 0),
            np.asarray(val)[:30, :nb].T > 0.5)


def test_polish_as_accurate_as_reference(front_outputs):
    """B8 on identical inputs in both packages: coloc_tpu's front outputs
    and the split seeds of the port's DK on its polynomials, through
    coloc_tpu's Pallas polish (interpret mode) and the port's twin, with
    the twin in float64 as the yardstick. Element-wise equality is
    meaningless here: an unconverged seed's 5 Gauss-Newton steps amplify
    XLA's FMA contraction, so on these samples the two valid masks differ
    on ~90 of 1110 seeds and only ~73% of the seeds valid in both agree to
    1e-4. The two are equally far from float64: the port's share of seeds
    (valid in all three) within 1e-4 of it is at least coloc_tpu's less
    0.03 (~75% and ~74%). Per sample, as in
    test_five_point_captures_reference_solutions: every sample that
    coloc_tpu solves (best held-out residual < 1e-4) the port solves too,
    but for at most one marginal sample whose reference best lies above
    1e-6."""
    basis, md, coef, npoly = front_outputs[0]
    c, s = tfp.dk_normalise(_t(npoly))
    roots, is_real = tfp.dk_roots_plain(c, s)
    delta = 0.01 * (roots.abs() + 1.0)
    seeds = torch.cat([roots, roots + delta, roots - delta]).numpy()
    svalid = is_real.repeat(3, 1).numpy()
    Ej, vj = _jax_polish(md, coef, basis, seeds, svalid)
    args = [_t(a) for a in (md, coef, basis, seeds)]
    Et, vt = (a.numpy() for a in tfp.polish_plain(*args, _t(svalid)))
    E64, v64 = (a.numpy() for a in tfp.polish_plain(*(a.double() for a in args), _t(svalid)))
    assert Et.shape == Ej.shape == (B, 30, 9) and vt.shape == vj.shape == (B, 30)
    all3 = vj & vt & v64
    assert all3.sum() > 0.5 * all3.size
    near_j = (np.abs(Ej - E64).max(-1)[all3] <= 1e-4).mean()
    near_t = (np.abs(Et - E64).max(-1)[all3] <= 1e-4).mean()
    assert near_t >= near_j - 0.03, (near_t, near_j)

    x1, x2 = _samples()

    def best(Es, val):
        r = jax.vmap(lambda E, a, b: jax.vmap(
            lambda e: jess.symmetric_epipolar_distance_sq(e, a, b).max())(E))(
            jnp.asarray(Es.reshape(B, 30, 3, 3)), jnp.asarray(x1), jnp.asarray(x2))
        return np.asarray(jnp.where(jnp.asarray(val), r, jnp.inf).min(axis=1))

    bj, bt = best(Ej, vj), best(Et, vt)
    lost = (bj < 1e-4) & ~(bt < 1e-4)
    assert lost.sum() <= 1 and (bj[lost] > 1e-6).all(), (
        np.argwhere(lost).ravel(), bj[lost], bt[lost])


def test_five_point_captures_reference_solutions():
    """Per sample, every solution coloc_tpu's Pallas path finds (best
    held-out residual < 1e-4) the port finds too, but for at most one
    marginal sample: one that coloc_tpu itself only just solves (best
    above 1e-6, a near-degenerate planar polynomial whose certificate a
    last-bit difference flips)."""
    x1, x2 = _samples(seed=1)
    Ej, vj = jfp._five_point_batch_pallas(jnp.asarray(x1[:, :5]), jnp.asarray(x2[:, :5]))
    Et, vt = tfp.five_point_batch(_t(x1[:, :5]), _t(x2[:, :5]))
    assert Et.shape == (B, 30, 3, 3) and vt.shape == (B, 30)

    def best(Es, val):
        r = jax.vmap(lambda E, a, b: jax.vmap(
            lambda e: jess.symmetric_epipolar_distance_sq(e, a, b).max())(E))(
            jnp.asarray(Es), jnp.asarray(x1), jnp.asarray(x2))
        return np.asarray(jnp.where(jnp.asarray(val), r, jnp.inf).min(axis=1))

    bj, bt = best(np.asarray(Ej), np.asarray(vj)), best(Et.numpy(), vt.numpy())
    lost = (bj < 1e-4) & ~(bt < 1e-4)
    assert lost.sum() <= 1 and (bj[lost] > 1e-6).all(), (
        np.argwhere(lost).ravel(), bj[lost], bt[lost])


def test_epipolar_ladder_rank_matches_reference():
    """Hm = 30 x 37 models, M = 300 correspondences with invalid rows and
    unequal focals: equal ranks except at exact rung ties."""
    rng = np.random.default_rng(5)
    Es = rng.normal(size=(30 * B, 3, 3)).astype(np.float32)
    M = 300
    p1 = rng.uniform(-0.6, 0.6, (M, 2)).astype(np.float32)
    p2 = (p1 + rng.normal(0, 0.01, (M, 2))).astype(np.float32)
    valid = rng.random(M) > 0.2
    s1, s2 = 451.2 ** 2, 480.0 ** 2
    want = np.asarray(jrank.epipolar_ladder_rank(
        jnp.asarray(Es), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        s1, s2, 16.0))
    got = trank.epipolar_ladder_rank(_t(Es), _t(p1), _t(p2), _t(valid), s1, s2,
                                     16.0).numpy()
    d = np.abs(got - want)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2.0
    assert want.max() > 0


# ---- essential-matrix geometry -------------------------------------------

def _two_view(seed=3, M=200):
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-3, 3, (M, 2)), rng.uniform(4, 12, (M, 1))]
    R = np.asarray(jso3.exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    C = np.array([0.8, 0.1, 0.05])
    x1 = X[:, :2] / X[:, 2:]
    Xc = (X - C) @ R.T
    x2 = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (M, 2))
    t = -R @ C
    t = t / np.linalg.norm(t)
    return (x1.astype(np.float32), x2.astype(np.float32), R.astype(np.float32),
            t.astype(np.float32))


def test_epipolar_residuals_match_reference():
    x1, x2, R, t = _two_view()
    E = np.asarray(jess.hat3(jnp.asarray(t))) @ R
    Es = np.random.default_rng(0).normal(size=(7, 3, 3)).astype(np.float32)
    Es[0] = E
    for fn_j, fn_t, args in [
        (jess.symmetric_epipolar_distance_sq, tess.symmetric_epipolar_distance_sq,
         (E, x1, x2, 400.0 ** 2, 450.0 ** 2)),
        (jess.symmetric_epipolar_distance_sq_batch,
         tess.symmetric_epipolar_distance_sq_batch, (Es, x1, x2, 400.0 ** 2, 450.0 ** 2)),
        (jess.sampson_distance_sq, tess.sampson_distance_sq, (E, x1, x2)),
    ]:
        want = np.asarray(fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                 for a in args)))
        got = fn_t(*(_t(a) if isinstance(a, np.ndarray) else a for a in args)).numpy()
        # rtol 1e-4: the smallest residuals are differences of near-equal terms
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tess.hat3(_t(t)).numpy(), np.asarray(jess.hat3(jnp.asarray(t))))


@pytest.mark.parametrize("flip", [False, True])
def test_decompose_essential_matches_reference(flip):
    x1, x2, R, t = _two_view()
    E = np.asarray(jess.hat3(jnp.asarray(t))) @ R * (-1.0 if flip else 1.0)
    E = (E + np.random.default_rng(1).normal(0, 1e-4, (3, 3))).astype(np.float32)
    mask = np.ones(len(x1), bool)
    mask[::7] = False
    Rj, tj = jess.decompose_essential(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(mask))
    Rt, tt = tess.decompose_essential(_t(E), _t(x1), _t(x2), _t(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert float(tt @ _t(t)) > 0.99                  # the cheirality vote


def test_refine_relative_pose_matches_reference():
    x1, x2, R, t = _two_view()
    R0 = np.asarray(jso3.exp(jnp.asarray([0.01, 0.005, -0.01], jnp.float32))) @ R
    t0 = t + np.array([0.02, -0.03, 0.01], np.float32)
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    w = (np.random.default_rng(2).random(len(x1)) > 0.1).astype(np.float32)
    Rj, tj = jess.refine_relative_pose(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(x1),
                                       jnp.asarray(x2), jnp.asarray(w))
    Rt, tt = tess.refine_relative_pose(_t(R0), _t(t0), _t(x1), _t(x2), _t(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert np.abs(Rt.numpy() - R).max() < 5e-3      # it did converge


def test_tangent_basis_matches_reference():
    for t in ([0.0, 0.0, 1.0], [0.95, 0.1, np.sqrt(1 - 0.95 ** 2 - 0.01)]):
        t = np.asarray(t, np.float32)
        np.testing.assert_allclose(tess._tangent_basis(_t(t)).numpy(),
                                   np.asarray(jess._tangent_basis(jnp.asarray(t))),
                                   atol=1e-6)


# ---- triangulation and SE(3) ----------------------------------------------

def test_triangulation_matches_reference():
    x1, x2, R, t = _two_view(M=64)
    C = -R.T @ t
    x2 = x2.copy()
    x2[5] = x1[5]                                    # parallel rays
    I, Z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    want = np.asarray(jtri.triangulate_points(I, Z, jnp.asarray(x1), jnp.asarray(R),
                                              jnp.asarray(C), jnp.asarray(x2)))
    got = ttri.triangulate_points(_t(I), _t(Z), _t(x1), _t(R), _t(C), _t(x2)).numpy()
    ok = np.abs(want).max(axis=1) < 1e4              # not the far parallel-ray point
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-4)
    assert np.isfinite(got).all()
    # an all-masked slot (here: non-finite coordinates) stays finite and
    # changes no other slot
    bad = x2.copy()
    bad[9] = np.nan
    mask = np.ones(len(x1), bool)
    mask[9] = False
    masked = ttri.triangulate_points(_t(I), _t(Z), _t(x1), _t(R), _t(C), _t(bad),
                                     mask=_t(mask)).numpy()
    assert np.isfinite(masked).all()
    np.testing.assert_array_equal(masked[mask], got[mask])
    for fn_j, fn_t, args in [
        (jtri.depth_in_view, ttri.depth_in_view, (R, C, want[ok])),
        (jtri.ray_angle_deg, ttri.ray_angle_deg, (Z, C, want[ok])),
    ]:
        np.testing.assert_allclose(fn_t(*map(_t, args)).numpy(),
                                   np.asarray(fn_j(*map(jnp.asarray, args))),
                                   rtol=1e-4, atol=1e-4)
    Rs = np.stack([I, R, R]).astype(np.float32)
    Cs = np.stack([Z, C, C + 0.3]).astype(np.float32)
    xys = np.stack([x1[0], x2[0], x2[3]]).astype(np.float32)
    vm = np.array([True, True, False])
    np.testing.assert_allclose(
        ttri.triangulate_nview(_t(Rs), _t(Cs), _t(xys), _t(vm)).numpy(),
        np.asarray(jtri.triangulate_nview(*map(jnp.asarray, (Rs, Cs, xys, vm)))),
        rtol=1e-4, atol=1e-4)


def test_se3_matches_reference():
    rng = np.random.default_rng(4)
    R1, R2 = (np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)))
              for _ in range(2))
    C1, C2 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    p1j, p2j = JPose(R=jnp.asarray(R1), C=jnp.asarray(C1)), JPose(R=jnp.asarray(R2), C=jnp.asarray(C2))
    p1t, p2t = Pose(R=_t(R1), C=_t(C1)), Pose(R=_t(R2), C=_t(C2))
    X = rng.normal(size=(5, 3)).astype(np.float32)
    for got, want in [
        (tse3.compose(p2t, p1t), jse3.compose(p2j, p1j)),
        (tse3.inverse(p1t), jse3.inverse(p1j)),
        (tse3.relative_to_absolute(p2t, p1t, 2.5), jse3.relative_to_absolute(p2j, p1j, 2.5)),
    ]:
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-6)
        np.testing.assert_allclose(got.C.numpy(), np.asarray(want.C), atol=1e-5)
    np.testing.assert_allclose(tse3.transform(p1t, _t(X)).numpy(),
                               np.asarray(jse3.transform(p1j, jnp.asarray(X))), atol=1e-5)


# ---- match_pair and relative_pose_essential --------------------------------

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def _angle(Ra, Rb):
    """Angle between rotations: ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2),
    exact near 0 where arccos of a float32 trace is not."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _dir_angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


def test_relative_pose_essential_matches_reference():
    """The bootstrap pair of the session tests (drone 0 and drone 1 at frame
    0 of scene seed 3, 240x320, 4 levels, 512 keypoints), both packages fed
    coloc_tpu's five-point draws of two keys.

    The f32 five-point models differ in the last bits (module docstring),
    and RANSAC over ~50 matches can then pick a different one of several
    near-equal NFA winners, which moves R by a few 1e-3 rad. So for every
    key: success equal, inlier sets within one borderline point (Jaccard
    >= 0.97), and the port's R and t as close to the ground truth as
    coloc_tpu's (within 3e-3 rad more). Where the same winner is picked
    (key 7), the strict tolerances: R 2e-3 rad, t 5e-3 rad, Jaccard 0.98."""
    scene = jsyn.make_scene(H, W, K, seed=3)
    (R0, C0), (R1, C1) = ((Rs[0], Cs[0]) for Rs, Cs in
                          (jsyn.trajectory(6, d) for d in (0, 1)))
    imgs = [jsyn.render(scene, R0, C0), jsyn.render(scene, R1, C1)]
    R_gt = R1 @ R0.T
    t_gt = -R_gt @ (R0 @ (C1 - C0))
    det = dict(width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10)
    jc = jcfg.ColocConfig(detector=jcfg.DetectorOptions(**det))
    tc = tcfg.ColocConfig(detector=tcfg.DetectorOptions(**det))
    jf = [j_detect(jnp.asarray(im), jc.detector) for im in imgs]
    jm = jmatching.match_pair(jf[0], jf[1], jc.matcher)
    tf = [convert.features_from_numpy(jax.tree_util.tree_map(np.asarray, f), "cpu")
          for f in jf]
    tm = tmatching.match_pair(tf[0], tf[1], tc.matcher)
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    jcam_ = jcam.Camera(K=jnp.asarray(K), dist=jnp.zeros(3))
    tcam = convert.camera_from_numpy(K, device="cpu")
    for k in (7, 8):
        key = jax.random.PRNGKey(k)
        draws = jransac.sample_indices(key, jm.mask, jc.ransac.num_hypotheses, 5)
        jgeo = jrobust.relative_pose_essential(key, jf[0].xy, jf[1].xy[jm.idx], jm.mask,
                                               jcam_, jcam_, jc.ransac)
        tgeo = trobust.relative_pose_essential(tf[0].xy, tf[1].xy[tm.idx.long()],
                                               tm.mask, tcam, tcam, tc.ransac,
                                               sample_idx=_t(draws))
        assert bool(tgeo.success) == bool(jgeo.success) and bool(tgeo.success)
        Rj, Rt = np.asarray(jgeo.R), tgeo.R.numpy()
        tj, tt = np.asarray(jgeo.t), tgeo.t.numpy()
        ji, ti = np.asarray(jgeo.inliers), tgeo.inliers.numpy()
        jacc = (ji & ti).sum() / (ji | ti).sum()
        assert int(tgeo.n_inliers) == ti.sum()
        assert jacc >= 0.97, (k, ji.sum(), ti.sum())
        assert _angle(Rt, R_gt) <= _angle(Rj, R_gt) + 3e-3, k
        assert _dir_angle(tt, t_gt) <= _dir_angle(tj, t_gt) + 3e-3, k
        if k == 7:
            assert _angle(Rj, Rt) < 2e-3 and _dir_angle(tj, tt) < 5e-3
            assert jacc >= 0.98


def test_refine_relative_pose_singular_normal_equations(monkeypatch):
    """A Jacobian of rank one whose normal equations are singular in
    float32 (every entry 1e3: the 1e-8 damping is below their rounding):
    the Gauss-Newton step is non-finite and rejected, and R, t come back
    as they went in, as jnp.linalg.solve's step is in coloc_tpu; the port
    raised here on the card before (torch.linalg.solve checks for
    singularity)."""
    M = 40
    monkeypatch.setattr(torch.func, "jacfwd", lambda f: (lambda p: torch.full((M, 5), 1e3)))
    rng = np.random.default_rng(0)
    x1 = torch.from_numpy(rng.normal(size=(M, 2)).astype(np.float32))
    x2 = x1 + 0.01
    R, t = torch.eye(3), torch.tensor([1.0, 0.0, 0.0])
    R2, t2 = tess.refine_relative_pose(R, t, x1, x2, torch.ones(M))
    assert torch.equal(R2, R) and torch.equal(t2, t)
