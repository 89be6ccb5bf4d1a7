"""Parity of the port's RANSAC pre-rank and NFA harness with coloc_tpu on CPU.

The rank's plain twin (of csrc/ransac_rank.cu) is held against coloc_tpu's
Pallas rank kernel (interpret mode) on the same models and correspondences,
in both zmodes: ranks equal on >= 99.9% of models and within 2 elsewhere
(float rounding at an exact rung boundary), and exactly on planted inputs
whose arithmetic is exact. The NFA
scores and Floyd sampling are compared on the same inputs / the same
uniforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import ransac as jransac
from coloc_tpu.geometry import p3p as jp3p
from coloc_tpu.ops import ransac_rank as jrr

from coloc_tpu_torch import ransac as transac
from coloc_tpu_torch.ops import ransac_rank as trr
from rank_cases import THR_SQ, planted_epi_operands, planted_rank_operands
from port_harness import one_torch_thread, time_limit  # noqa: F401

F = 451.2


def _p3p_problem(seed, n_samples=64, M=128):
    """Models: P3P flats of minimal samples of a noisy scene (Hm = 4 *
    n_samples); correspondences: the scene, 20% outliers, 10% invalid."""
    rng = np.random.default_rng(seed)
    Xc = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                   rng.uniform(4, 12, M)], -1).astype(np.float32)
    bear = Xc + rng.normal(0, 0.004, Xc.shape).astype(np.float32)
    out = rng.random(M) < 0.2
    bear[out] = rng.normal(0, 1, (out.sum(), 3)).astype(np.float32) + [0, 0, 3]
    bear /= np.linalg.norm(bear, axis=-1, keepdims=True)
    valid = rng.random(M) > 0.1
    idx = np.stack([rng.choice(M, 3, replace=False) for _ in range(n_samples)])
    flats, _ = jp3p.p3p_flats_batch(jnp.asarray(Xc[idx]), jnp.asarray(bear[idx]))
    return np.array(flats).reshape(-1, 12), Xc, bear.astype(np.float32), valid


def _assert_ranks_agree(got, want):
    d = np.abs(got - want)
    assert (d == 0).mean() >= 0.999
    assert d.max() <= 2.0


@pytest.mark.parametrize("seed", [0, 1])
def test_p3p_rank_matches_reference(seed):
    flats, X, bear, valid = _p3p_problem(seed)
    want = np.asarray(jrr.p3p_ladder_rank(
        jnp.asarray(flats), jnp.asarray(X), jnp.asarray(bear), jnp.asarray(valid),
        jnp.float32(F), 16.0))
    got = trr.p3p_ladder_rank(torch.from_numpy(flats), torch.from_numpy(X),
                              torch.from_numpy(bear), torch.from_numpy(valid),
                              F, 16.0).numpy()
    assert got.shape == (flats.shape[0],) and want.max() > 0
    _assert_ranks_agree(got, want)


def test_nonzero_zmode_matches_reference_homography_rank():
    """zmode "nonzero" is the homography transfer user of the same kernel:
    build the operands as coloc_tpu's homography_ladder_rank does."""
    rng = np.random.default_rng(2)
    Hm, M = 200, 150
    Hs = (np.eye(3) + rng.normal(0, 0.05, (Hm, 3, 3))).astype(np.float32)
    Hs[:, 2, :] *= rng.choice([-1.0, 1.0], (Hm, 1)).astype(np.float32)
    x1 = rng.uniform(-0.6, 0.6, (M, 2)).astype(np.float32)
    h = np.c_[x1, np.ones(M, np.float32)] @ Hs[0].T
    x2 = (h[:, :2] / h[:, 2:] + rng.normal(0, 0.003, (M, 2))).astype(np.float32)
    valid = rng.random(M) > 0.1
    want = np.asarray(jrr.homography_ladder_rank(
        jnp.asarray(Hs), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
        jnp.float32(F), 16.0))
    t = torch.from_numpy
    scale = torch.tensor([F, F, 1.0])[None, :, None]
    eflat = torch.cat([t(Hs) * scale, torch.zeros(Hm, 3, 1)], dim=2).reshape(Hm, 12)
    xh = torch.cat([t(x1), torch.ones(M, 1), torch.zeros(M, 1)], dim=1).T
    obs = (t(x2) * F).T
    got = trr.ladder_rank(eflat, xh, obs, t(valid).float(), 16.0, "nonzero").numpy()
    assert want.max() > 0
    _assert_ranks_agree(got, want)


@pytest.mark.parametrize("zmode", ["pos", "nonzero"])
def test_planted_edges_equal_reference_exactly(zmode):
    """The planted edge inputs (tests/rank_cases.py: a Z plane exactly 0,
    points behind the camera, |Z| at 1e-9 and just below, a masked point, a
    NaN column and a NaN observation, residuals exactly on a rung) through
    the twin and through coloc_tpu's rank kernel (interpreted, operands
    padded as its wrappers pad them): the values are exact, so the ranks
    are equal."""
    eflat, xh, obs, maskf = planted_rank_operands()
    ep, (xp, op, mp), Hm, _ = jrr._pad_operands(
        jnp.asarray(eflat), [jnp.asarray(xh), jnp.asarray(obs), jnp.asarray(maskf)[None]])
    want = np.asarray(jrr._p3p_ladder_rank_pallas(
        ep[None], xp[None], op[None], mp[None], THR_SQ, 2, 5, zmode=zmode,
        interpret=True))[0, :Hm]
    got = trr.ladder_rank_plain(*(torch.from_numpy(a) for a in (eflat, xh, obs, maskf)),
                                THR_SQ, zmode, 2, 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0] > 0 and want[1] == 0       # the identity counts, Z = 0 never


@pytest.mark.parametrize("Hm,M,n_rungs,odd_mask", [(1, 5, 5, False), (33, 301, 4, True)])
def test_epi_rank_planted_edges_match_reference(Hm, M, n_rungs, odd_mask):
    """B9's twin against coloc_tpu's epipolar rank kernel (interpreted,
    operands padded as its wrapper pads them) on tests/rank_cases.py's
    planted epipolar inputs: compares exactly on a rung, zero and clamped
    denominators, NaN data, a masked band, masks of 1/2, M off the 4-point
    grid, Hm = 1 and the generic rung count. Held at the statistical
    tolerance of the reference comparisons (XLA:CPU contracts FMAs)."""
    emat, dmat, maskf, c = planted_epi_operands(Hm, M, odd_mask=odd_mask)
    ep, (dp, mp), Hm_, _ = jrr._pad_operands(jnp.asarray(emat),
                                            [jnp.asarray(dmat), jnp.asarray(maskf)[None]])
    want = np.asarray(jrr._epi_ladder_rank_pallas(
        ep[None], dp[None], mp[None], jnp.asarray(c), 2, n_rungs, interpret=True))[0, :Hm_]
    got = trr.epi_rank_plain(*(torch.from_numpy(a) for a in (emat, dmat, maskf, c)),
                             2, n_rungs).numpy()
    _assert_ranks_agree(got, want)
    assert want[0] > 0


def test_nfa_scores_match_reference():
    rng = np.random.default_rng(3)
    Hm, M = 32, 200
    res = (rng.gamma(1.0, 2.0, (Hm, M)) ** 2).astype(np.float32)
    res[:, :40] *= 1e4                                   # outliers
    valid = rng.random(M) > 0.1
    log_alpha0 = float(np.float32(np.log10(np.pi / (752.0 * 480.0))))
    sj, tj = jransac.nfa_scores(jnp.asarray(res), jnp.asarray(valid), 3,
                                jnp.float32(log_alpha0), 2.0)
    st, tt = transac.nfa_scores(torch.from_numpy(res), torch.from_numpy(valid), 3,
                                torch.tensor(log_alpha0), 2.0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_floyd_sampling_matches_reference_given_the_same_uniforms():
    rng = np.random.default_rng(4)
    valid = rng.random(300) > 0.4
    u = rng.random((256, 3)).astype(np.float32)
    n = int(valid.sum())
    order_j = np.asarray(jransac._pack_valid_first(jnp.asarray(valid)))
    pos_j = np.asarray(jax.vmap(lambda uu: jransac._distinct_positions(
        uu, jnp.int32(n)))(jnp.asarray(u)))
    order_t = transac._pack_valid_first(torch.from_numpy(valid)).numpy()
    pos_t = transac._distinct_positions(torch.from_numpy(u), torch.tensor(n)).numpy()
    np.testing.assert_array_equal(order_t, order_j)
    np.testing.assert_array_equal(pos_t, pos_j)
    idx = order_t[pos_t]
    assert valid[idx].all()
    assert all(len(set(row)) == 3 for row in idx)


def test_sample_indices_draws_distinct_valid_entries():
    valid = torch.from_numpy(np.random.default_rng(5).random(50) > 0.5)
    gen = torch.Generator().manual_seed(0)
    idx = transac.sample_indices(valid, 256, 3, gen)
    assert idx.shape == (256, 3)
    assert bool(valid[idx].all())
    assert all(len(set(r.tolist())) == 3 for r in idx)
    again = transac.sample_indices(valid, 256, 3, torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
