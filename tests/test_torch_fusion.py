"""Parity of the port's fusion helpers with coloc_tpu on the CPU: ICI
(fusion/covint), the map-alignment utilities (utils), the trajectory
metrics (metrics) and map-against-map matching (matching.match_maps).

ICI (ROADMAP C15): the trace C_fused(w) is flat near its minimum to below
float32 resolution, so the golden-section search's `f1 < f2` comparisons
follow each implementation's own 3x3-inverse rounding. On random SPD pairs
of the config-4 oracle's magnitude, w* of the port and of coloc_tpu differ
by up to ~1.4e-3 and their fused positions by up to ~1e-3 |a - b|, while both
sit within ~1.3e-3 of a float64 ICI in w*, within ~1.2e-3 |a - b| in
position and within ~4e-7 relative in the trace (300 pairs). So the port's ICI is held to the
float64 ICI of tests/oracle.py (trace tight, w* and position loose), and
to coloc_tpu's only in w*.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import metrics as jmetrics
from coloc_tpu import utils as jutils
from coloc_tpu.fusion import covint as jcovint
from coloc_tpu.types import MapDB as JMapDB
from coloc_tpu.types import Matches as JMatches

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch import matching as tmatching
from coloc_tpu_torch import metrics as tmetrics
from coloc_tpu_torch import utils as tutils
from coloc_tpu_torch.fusion import covint as tcovint
from coloc_tpu_torch.types import Matches as TMatches
from port_harness import one_torch_thread, time_limit  # noqa: F401

N_PAIRS = 48


def _spd(rng):
    """A position covariance of the config-4 oracle's magnitude."""
    A = rng.normal(0.0, 0.1, (3, 3))
    return A @ A.T + np.diag(rng.uniform(0.01, 0.05, 3))


@pytest.fixture(scope="module")
def ici_cases():
    """N_PAIRS random (CA, CB, a, b) and the float64 ICI of each."""
    rng = np.random.default_rng(15)
    cases = []
    for _ in range(N_PAIRS):
        CA, CB = _spd(rng), _spd(rng)
        a = rng.uniform(-1.0, 1.0, 3)
        b = a + rng.normal(0.0, 0.3, 3)
        cases.append((CA, CB, a, b))
    f32 = [np.stack([c[i] for c in cases]).astype(np.float32) for i in range(4)]
    gold = [oracle.covariance_intersection(*(x.astype(np.float64) for x in c))
            for c in zip(*f32)]
    return f32, gold


@pytest.fixture(scope="module")
def port_ici(ici_cases):
    f32, _ = ici_cases
    return tcovint.fuse(*(torch.from_numpy(x) for x in f32))


def test_fuse_matches_float64_ici(ici_cases, port_ici):
    """Trace within 1e-5 relative of the float64 ICI's, w* within 2e-3,
    the fused position within 2e-3 |a - b|, the covariance within 1e-3
    relative (Frobenius: it moves with w* at first order where the trace
    does not; measured up to 3.5e-4 for the port and 3.2e-4 for coloc_tpu
    on 300 such pairs)."""
    f32, gold = ici_cases
    for i, (cov_o, pos_o, w_o) in enumerate(gold):
        tr_o = np.trace(cov_o)
        assert abs(float(port_ici.trace[i]) - tr_o) <= 1e-5 * tr_o, i
        assert abs(float(port_ici.omega[i]) - w_o) <= 2e-3, i
        gap = np.linalg.norm(f32[2][i] - f32[3][i])
        assert np.abs(port_ici.pos[i].numpy() - pos_o).max() <= 2e-3 * gap, i
        assert np.linalg.norm(port_ici.cov[i].numpy() - cov_o) <= 1e-3 * np.linalg.norm(cov_o)


def test_fuse_omega_matches_reference(ici_cases, port_ici):
    """w* within 4e-3 of coloc_tpu's covint.fuse (C15: not element-wise)."""
    f32, _ = ici_cases
    ref = jax.jit(jax.vmap(jcovint.fuse))(*(jnp.asarray(x) for x in f32))
    np.testing.assert_allclose(port_ici.omega.numpy(), np.asarray(ref.omega), atol=4e-3)
    assert np.all((port_ici.omega.numpy() >= 0.0) & (port_ici.omega.numpy() <= 1.0))


def test_fuse_batch_equals_single_calls(ici_cases, port_ici):
    """A leading batch axis computes each pair as a call of its own does."""
    f32, _ = ici_cases
    for i in (0, 7, N_PAIRS - 1):
        one = tcovint.fuse(*(torch.from_numpy(x[i]) for x in f32))
        for a, b in zip(one, port_ici):
            torch.testing.assert_close(a, b[i], rtol=1e-6, atol=1e-7)


def _maps(rng, L=64, n_valid=50):
    """Two maps over L slots and their matches: map_b a scaled, shifted
    copy of map_a with noise, slots permuted; some matches rejected
    (idx -1), some map_a slots invalid."""
    Xa = rng.uniform(-3.0, 3.0, (L, 3)).astype(np.float32)
    perm = rng.permutation(L)
    Xb = np.empty_like(Xa)
    Xb[perm] = (0.4 * Xa + np.float32([1.0, -2.0, 0.5])
                + rng.normal(0, 0.01, (L, 3))).astype(np.float32)
    va = np.zeros(L, bool)
    va[rng.choice(L, n_valid, replace=False)] = True
    idx = perm.astype(np.int32)
    idx[rng.random(L) < 0.2] = -1
    return Xa, va, Xb, idx


def _scale_both(Xa, va, Xb, idx):
    L = Xa.shape[0]
    desc = np.zeros((L, 16), np.uint32)
    zeros = np.zeros(L, np.int32)
    jm = JMatches(idx=jnp.asarray(idx), best=jnp.asarray(zeros), second=jnp.asarray(zeros))
    ja, jb = (JMapDB(X=jnp.asarray(X), desc=jnp.asarray(desc), valid=jnp.asarray(v))
              for X, v in ((Xa, va), (Xb, np.ones(L, bool))))
    tm = TMatches(idx=torch.from_numpy(idx), best=torch.from_numpy(zeros),
                  second=torch.from_numpy(zeros))
    ta, tb = (convert.mapdb_from_numpy(m, "cpu") for m in (ja, jb))
    return (float(jutils.compute_scale_difference(ja, jb, jm)),
            tutils.compute_scale_difference(ta, tb, tm))


@pytest.mark.parametrize("case", ["general", "no_common_pair", "one_common_pair",
                                  "coincident_b", "last_slot_unmatched"])
def test_compute_scale_difference_matches_reference(case):
    """To 1e-6 relative; 1.0 with no consecutive pair; the stable sort
    keeps slot order (an unstable one would pair other landmarks)."""
    rng = np.random.default_rng(3)
    Xa, va, Xb, idx = _maps(rng)
    if case == "no_common_pair":
        idx[:] = -1
    elif case == "one_common_pair":
        keep = np.flatnonzero(va & (idx >= 0))[:2]
        idx = np.where(np.isin(np.arange(idx.size), keep), idx, -1).astype(np.int32)
    elif case == "coincident_b":
        Xb[:] = Xb[0]          # every d_b = 0: no pair qualifies
    elif case == "last_slot_unmatched":
        idx[-1] = -1           # the -1 gather reads map_b's last row
        va[-1] = True
    want, got = _scale_both(Xa, va, Xb, idx)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if case in ("no_common_pair", "one_common_pair", "coincident_b"):
        n_pairs = 1 if case == "one_common_pair" else 0
        assert (float(got) == 1.0) == (n_pairs == 0)
    if case == "general":
        np.testing.assert_allclose(float(got), 2.5, rtol=0.05)


def test_rescale_map_matches_reference():
    rng = np.random.default_rng(4)
    X, Cs = rng.normal(size=(20, 3)).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32)
    jX, jC = jutils.rescale_map(jnp.asarray(X), jnp.asarray(Cs), jnp.float32(0.37))
    tX, tC = tutils.rescale_map(torch.from_numpy(X), torch.from_numpy(Cs),
                                torch.tensor(0.37))
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tC.numpy(), np.asarray(jC))


def test_guided_match_residuals_matches_reference():
    """|x2^T F x1| under a known relative pose, to 1e-6 relative of the
    largest residual; 0 where masked."""
    rng = np.random.default_rng(5)
    K1 = np.array([[310.0, 0, 170], [0, 305.0, 118], [0, 0, 1]], np.float32)
    K2 = np.array([[290.0, 0, 155], [0, 292.0, 125], [0, 0, 1]], np.float32)
    w = rng.normal(0, 0.1, 3)
    R = oracle.rodrigues(w).astype(np.float32)
    t = rng.normal(0, 1.0, 3).astype(np.float32)
    uv1 = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    mask = rng.random(40) > 0.3
    args = (K1, K2, R, t, uv1, uv2, mask)
    want = np.asarray(jutils.guided_match_residuals(*(jnp.asarray(a) for a in args)))
    got = tutils.guided_match_residuals(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.all(got[~mask] == 0.0)


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_exhaustive_pairs_match_reference(n):
    assert tutils.exhaustive_pairs(n) == jutils.exhaustive_pairs(n)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)


def _flip(rng, desc, bits):
    """desc with `bits` random bits flipped in each row."""
    out = desc.copy()
    rows = np.arange(desc.shape[0])
    for _ in range(bits):
        b = rng.integers(0, 512, desc.shape[0])
        out[rows, b // 32] ^= np.uint32(1) << (b % 32).astype(np.uint32)
    return out


def _map_pair(seed, L=96, T=128):
    """map_a of L slots (10% invalid); map_b of T slots holding a
    similarity-moved copy of 70 of map_a's landmarks (20 bits of each
    descriptor flipped, 5 of them moved by ~2 m: outliers), the rest
    invalid rows like a temp map's, or random descriptors."""
    rng = np.random.default_rng(seed)
    da = _desc(rng, L)
    Xa = rng.uniform(-4.0, 4.0, (L, 3)).astype(np.float32)
    va = rng.random(L) > 0.1
    db = _desc(rng, T)
    Xb = rng.uniform(-4.0, 4.0, (T, 3)).astype(np.float32)
    vb = np.zeros(T, bool)
    src = rng.choice(L, 70, replace=False)
    dst = rng.choice(T, 70, replace=False)
    R = oracle.rodrigues([0.3, -0.2, 0.5])
    s, t = 0.6, np.array([0.5, -1.0, 2.0])
    db[dst] = _flip(rng, da[src], 20)
    # X_a = s R X_b + t  <=>  X_b = R^T (X_a - t) / s
    Xb[dst] = ((Xa[src] - t) @ R / s).astype(np.float32)
    Xb[dst[:5]] += rng.normal(0.0, 2.0, (5, 3)).astype(np.float32)
    vb[dst] = True
    vb[rng.choice(T, 10)] = True
    maps = [JMapDB(X=jnp.asarray(X), desc=jnp.asarray(d), valid=jnp.asarray(v))
            for X, d, v in ((Xa, da, va), (Xb, db, vb))]
    return maps, (s, R, t)


def test_match_maps_matches_reference():
    """idx and mask equal to coloc_tpu's match_maps; best and second only
    where accepted (the kernel's sentinels differ where the best row is
    invalid, ops/hamming.hamming_2nn)."""
    (ja, jb), _ = _map_pair(8)
    opts_j, opts_t = jcfg.MatcherOptions(), tcfg.MatcherOptions()
    jm = jmatching.match_maps(ja, jb, opts_j)
    tm = tmatching.match_maps(convert.mapdb_from_numpy(ja, "cpu"),
                              convert.mapdb_from_numpy(jb, "cpu"), opts_t)
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    acc = np.asarray(jm.mask)
    assert acc.sum() >= 50
    np.testing.assert_array_equal(tm.best.numpy()[acc], np.asarray(jm.best)[acc])
    np.testing.assert_array_equal(tm.second.numpy()[acc], np.asarray(jm.second)[acc])


@pytest.mark.parametrize("min_matches", [12, 500])
def test_align_maps_matches_reference(min_matches):
    """The same similarity, inlier count and matched_b as coloc_tpu's (the
    same host numpy over equal matches), the planted similarity recovered
    through the outliers; None on both under `min_matches`."""
    (ja, jb), (s0, R0, t0) = _map_pair(9)
    want = jutils.align_maps(ja, jb, jcfg.MatcherOptions(), min_matches=min_matches)
    got = tutils.align_maps(convert.mapdb_from_numpy(ja, "cpu"),
                            convert.mapdb_from_numpy(jb, "cpu"), tcfg.MatcherOptions(),
                            min_matches=min_matches)
    if min_matches > 100:
        assert want is None and got is None
        return
    s, R, t, n, matched = got
    assert s == want[0] and n == want[3]
    np.testing.assert_array_equal(R, want[1])
    np.testing.assert_array_equal(t, want[2])
    np.testing.assert_array_equal(matched, want[4])
    assert n < int(matched.sum())       # the reweighting dropped the outliers
    np.testing.assert_allclose(s, s0, rtol=1e-4)
    np.testing.assert_allclose(R, R0, atol=1e-4)
    np.testing.assert_allclose(t, t0, atol=1e-3)


def test_metrics_equal_reference():
    """The port's copy of metrics gives coloc_tpu's numbers exactly."""
    rng = np.random.default_rng(6)
    gt = np.cumsum(rng.normal(0, 0.1, (30, 3)), axis=0)
    R = oracle.rodrigues([0.1, 0.2, -0.3])
    est = (1.7 * (R @ gt.T)).T + 0.5 + rng.normal(0, 0.01, (30, 3))
    for fn in ("umeyama_alignment", "ate_rmse"):
        for scale in (True, False):
            got = getattr(tmetrics, fn)(est, gt, scale)
            want = getattr(jmetrics, fn)(est, gt, scale)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    ids = np.r_[np.arange(10), np.arange(12, 30)]
    for kw in ({}, {"delta": 3}, {"frame_ids": ids}):
        e, g_ = (est[ids], gt[ids]) if "frame_ids" in kw else (est, gt)
        got, want = tmetrics.rpe_translation(e, g_, **kw), jmetrics.rpe_translation(e, g_, **kw)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
