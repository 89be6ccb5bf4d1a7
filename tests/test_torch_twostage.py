"""Parity of the port's two-stage large-bank matcher with coloc_tpu on CPU:
the 128-bit group prefilter (B12's plain twin against coloc_tpu's Pallas
kernel, interpreted), the exact 512-bit re-rank, and match_with_map's
choice of bank. Integer keys throughout, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import types as jtypes
from coloc_tpu.ops import hamming as jh

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import matching as tmatching
from coloc_tpu_torch import types as ttypes
from coloc_tpu_torch.ops import hamming as th
from rank_cases import twostage_edge_case
from port_harness import one_torch_thread, time_limit  # noqa: F401


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)


def _t(desc_u32):
    return torch.from_numpy(desc_u32.view(np.int32).copy())


def _matching_shaped(rng, Q, T, n_true):
    """Random bank; query i < n_true has a true match (~40 flipped bits) at
    a random slot (tests/test_hamming.py's construction) -> qd, td, slots."""
    qd, td = _desc(rng, Q), _desc(rng, T)
    slots = rng.choice(T, size=n_true, replace=False)
    for qi in range(n_true):
        d = qd[qi].copy()
        for b in rng.integers(0, 512, 40):
            d[b // 32] ^= np.uint32(1 << (b % 32))
        td[slots[qi]] = d
    return qd, td, slots


def test_pack_bank_twostage_matches_reference():
    """The packed prefilter words hold coloc_tpu's `[:, ::4]` +-1 operand,
    padding rows zero, and the key row is its penalty + reversed column."""
    rng = np.random.default_rng(0)
    T = 2048 + 300
    td = _desc(rng, T)
    tv = rng.random(T) > 0.1
    st_sub, penrcol, _, _, _ = jh.pack_bank_twostage(jnp.asarray(td), jnp.asarray(tv))
    bank = th.pack_bank_twostage(_t(td), torch.from_numpy(tv))
    st = th.unpack_bipolar(bank.pf, torch.float32)
    st[T:] = 0.0
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_sub, np.float32))
    np.testing.assert_array_equal(bank.penrcol.numpy(), np.asarray(penrcol)[0])
    np.testing.assert_array_equal(bank.desc.numpy().view(np.uint32), td)


def test_group_top2_plain_matches_interpreted_kernel():
    """Three groups, the last one partial, 10% invalid rows, a duplicated
    row and queries equal to bank rows: the (idx1, idx2) of every (query,
    group) equal the Pallas kernel's."""
    rng = np.random.default_rng(1)
    Q, T = 40, 2 * 2048 + 700
    td = _desc(rng, T)
    td[4500] = td[9]
    qd = _desc(rng, Q)
    qd[:10] = td[[9, 2047, 2048, 4795, 4796 - 1, 5, 6, 7, 4500, 3000]]
    tv = rng.random(T) > 0.1
    st_sub, penrcol, _, _, _ = jh.pack_bank_twostage(jnp.asarray(td), jnp.asarray(tv))
    sq = jnp.pad(jh.unpack_bipolar(jnp.asarray(qd))[:, ::4], ((0, 512 - Q), (0, 0)))
    want = jh._group_top2_pallas(sq, st_sub, penrcol, interpret=True)
    bank = th.pack_bank_twostage(_t(td), torch.from_numpy(tv))
    got = th.group_top2(th.prefilter_words(_t(qd)), bank)
    for g, w in zip(got, want):
        assert g.shape == (Q, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:Q])


@pytest.mark.parametrize("Q,T", [(5, 2048 + 1), (40, 3 * 2048 + 1)])
def test_group_top2_plain_matches_interpreted_kernel_edges(Q, T):
    """tests/rank_cases.py's B12 edges: a last group of one real row, a
    group with one valid row and (at 3 groups) one with none, a row
    duplicated within a group and across groups, all-zero and all-ones
    rows and queries, a query equal to a bank row, Q below 16."""
    qd, td, tv = twostage_edge_case(Q, T)
    st_sub, penrcol, _, _, _ = jh.pack_bank_twostage(jnp.asarray(td), jnp.asarray(tv))
    sq = jnp.pad(jh.unpack_bipolar(jnp.asarray(qd))[:, ::4], ((0, 512 - Q), (0, 0)))
    want = jh._group_top2_pallas(sq, st_sub, penrcol, interpret=True)
    bank = th.pack_bank_twostage(_t(td), torch.from_numpy(tv))
    got = th.group_top2(th.prefilter_words(_t(qd)), bank)
    for g, w in zip(got, want):
        assert g.shape == (Q, -(-T // 2048))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:Q])
    # query 0 is group 0's one valid row: its best there, its copy (the
    # last group's one real row) best in that group
    assert int(got[0][0, 0]) == 7 and int(got[0][0, -1]) == T - 1


def test_twostage_matches_reference():
    """(idx, best, second) equal coloc_tpu's two-stage matcher exactly, on
    an 8-group bank with planted, random, duplicated and invalid queries
    and invalid rows."""
    rng = np.random.default_rng(2)
    Q, T = 200, 8 * 2048 - 77
    qd, td, _ = _matching_shaped(rng, Q, T, n_true=120)
    td[[10, 9000]] = qd[150]                          # a duplicated best
    qv = rng.random(Q) > 0.05
    tv = rng.random(T) > 0.05
    tv[[10, 9000]] = True
    jbank = jh.pack_bank_twostage(jnp.asarray(td), jnp.asarray(tv))
    want = jh.hamming_2nn_twostage(jnp.asarray(qd), jnp.asarray(qv), jbank,
                                   interpret=True)
    got = th.hamming_2nn_twostage(_t(qd), torch.from_numpy(qv),
                                  th.pack_bank_twostage(_t(td), torch.from_numpy(tv)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if qv[150]:
        assert (int(got[0][150]), int(got[1][150]), int(got[2][150])) == (10, 0, 0)


def test_duplicate_semantics_and_planted_retrieval():
    """tests/test_hamming.py's contract on a one-group bank: planted queries
    retrieve the brute-force best at its exact distance, and a duplicated
    best leaves its twin as second with the lowest index first."""
    rng = np.random.default_rng(3)
    Q, T = 64, 1024
    qd, td, _ = _matching_shaped(rng, Q, T, n_true=32)
    td[7] = td[100] = qd[0]
    qv, tv = np.ones(Q, bool), np.ones(T, bool)
    xi, xb, _ = (np.asarray(a) for a in jh.hamming_2nn_xla(
        jnp.asarray(qd), jnp.asarray(td), jnp.asarray(qv), jnp.asarray(tv)))
    ti, tb, ts = (a.numpy() for a in th.hamming_2nn_twostage(
        _t(qd), torch.from_numpy(qv), th.pack_bank_twostage(_t(td), torch.from_numpy(tv))))
    has_match = xb < 128
    assert has_match.sum() >= 32
    np.testing.assert_array_equal(ti[has_match], xi[has_match])
    np.testing.assert_array_equal(tb[has_match], xb[has_match])
    assert (ti[0], tb[0], ts[0]) == (7, 0, 0)


def test_match_with_map_bank_precedence():
    """twostage_bank wins over bank, bank over packing the map, as in
    coloc_tpu: a map whose descriptors differ from both banks shows which
    one was read."""
    rng = np.random.default_rng(4)
    L, K = 3000, 64
    md, other = _desc(rng, L), _desc(rng, L)
    qd = md[rng.integers(0, L, K)]
    X = rng.normal(size=(L, 3)).astype(np.float32)
    xy = np.zeros((K, 2), np.float32)
    zf, zi = np.zeros(K, np.float32), np.zeros(K, np.int32)
    qv, mv = np.ones(K, bool), np.ones(L, bool)

    jf = jtypes.Features(xy=jnp.asarray(xy), score=jnp.asarray(zf), scale=jnp.asarray(zi),
                         angle=jnp.asarray(zf), desc=jnp.asarray(qd), valid=jnp.asarray(qv))
    jm = jtypes.MapDB(X=jnp.asarray(X), desc=jnp.asarray(md), valid=jnp.asarray(mv))
    jm_other = jm._replace(desc=jnp.asarray(other))
    tf = ttypes.Features(xy=torch.from_numpy(xy), score=torch.from_numpy(zf),
                         scale=torch.from_numpy(zi), angle=torch.from_numpy(zf),
                         desc=_t(qd), valid=torch.from_numpy(qv))
    tm = ttypes.MapDB(X=torch.from_numpy(X), desc=_t(md), valid=torch.from_numpy(mv))
    tm_other = tm._replace(desc=_t(other))
    jopts, topts = jcfg.MatcherOptions(), tcfg.MatcherOptions()

    cases = [
        # (port kwargs, coloc_tpu kwargs) on the map of `other` descriptors
        (dict(twostage_bank=tmatching.pack_map_bank_twostage(tm),
              bank=tmatching.pack_map_bank(tm_other)),
         dict(twostage_bank=jmatching.pack_map_bank_twostage(jm),
              bank=jmatching.pack_map_bank(jm_other))),
        (dict(bank=tmatching.pack_map_bank(tm)), dict(bank=jmatching.pack_map_bank(jm))),
        (dict(), dict()),
    ]
    for i, (tkw, jkw) in enumerate(cases):
        got = tmatching.match_with_map(tf, tm_other, topts, **tkw)
        want = jmatching.match_with_map(jf, jm_other, jopts, **jkw)
        for field in ("idx", "best", "second", "mask"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        # the first two read the true map: every query finds its own row
        assert (int(got.mask.sum()) == K) == (i < 2)


def test_twostage_bank_row_cap():
    """The re-rank key packs the candidate index into 20 bits, so a bank of
    more than 2^20 rows raises, as in coloc_tpu."""
    T = 2 ** 20 + 1
    with pytest.raises(ValueError, match="capped"):
        th.pack_bank_twostage(torch.zeros((T, 16), dtype=torch.int32),
                              torch.ones(T, dtype=torch.bool))
