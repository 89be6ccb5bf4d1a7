"""Parity of the port's Hamming 2-NN and accept test with coloc_tpu on CPU.

The same numpy descriptors go through coloc_tpu's Pallas kernel (interpret
mode) / XLA path and through the port's plain twin of csrc/k2nn.cu; the
(idx, best, second) triples must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu.ops import hamming as jh

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import matching as tmatching
from coloc_tpu_torch.ops import hamming as th
from port_harness import one_torch_thread, time_limit  # noqa: F401


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)


def _t(desc_u32):
    return torch.from_numpy(desc_u32.view(np.int32).copy())


def _port(qd, td, qv, tv):
    bank = th.pack_bank(_t(td), torch.from_numpy(tv))
    return [a.numpy() for a in th.hamming_2nn_bank(_t(qd), torch.from_numpy(qv), bank)]


def _pallas(qd, td, qv, tv):
    return [np.asarray(a) for a in jh.hamming_2nn_pallas(
        jnp.asarray(qd), jnp.asarray(td), jnp.asarray(qv), jnp.asarray(tv),
        interpret=True)]


def _xla(qd, td, qv, tv):
    return [np.asarray(a) for a in jh.hamming_2nn_xla(
        jnp.asarray(qd), jnp.asarray(td), jnp.asarray(qv), jnp.asarray(tv))]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("Q,T,p_invalid", [(100, 300, 0.1), (33, 47, 0.2),
                                           (128, 256, 0.0)])
def test_random_banks_match_pallas_and_xla(Q, T, p_invalid):
    rng = np.random.default_rng(Q * T)
    td = _desc(rng, T)
    qd = _desc(rng, Q)
    qd[: Q // 3] = td[rng.integers(0, T, Q // 3)]      # some exact hits
    qv = rng.random(Q) > 0.05
    tv = rng.random(T) >= p_invalid
    got = _port(qd, td, qv, tv)
    _assert_equal(got, _pallas(qd, td, qv, tv))
    _assert_equal(got, _xla(qd, td, qv, tv))


def test_duplicate_tie_and_invalid_row_semantics():
    """A duplicated best leaves its twin as second, ties go to the lowest
    index (across the Pallas kernel's 2048-row tiles), and an invalid row
    costs hd + 2048 (tests/test_hamming.py's case)."""
    rng = np.random.default_rng(0)
    T = 4200
    td = _desc(rng, T)
    td[2100] = td[7]
    td[4100] = td[7]
    qd = td[[7, 50]].copy()
    qv = np.ones(2, bool)
    tv = np.ones(T, bool)
    tv[30:60] = False                                  # holds query 1's own row
    got = _port(qd, td, qv, tv)
    assert got[0][0] == 7 and got[1][0] == 0 and got[2][0] == 0
    _assert_equal(got, _pallas(qd, td, qv, tv))
    _assert_equal(got, _xla(qd, td, qv, tv))


def test_all_invalid_bank_and_invalid_queries():
    rng = np.random.default_rng(1)
    qd, td = _desc(rng, 8), _desc(rng, 100)
    qv = np.array([True] * 6 + [False] * 2)
    tv = np.zeros(100, bool)
    got = _port(qd, td, qv, tv)
    np.testing.assert_array_equal(got[0], -np.ones(8))
    np.testing.assert_array_equal(got[1], np.full(8, 2048))
    np.testing.assert_array_equal(got[2], np.full(8, 2048))
    _assert_equal(got, _pallas(qd, td, qv, tv))
    # invalid queries in a valid bank: 2048/2048, idx as the kernel found it
    tv[:] = True
    _assert_equal(_port(qd, td, qv, tv), _pallas(qd, td, qv, tv))


def test_pack_unpack_round_trip_matches_reference():
    rng = np.random.default_rng(2)
    d = _desc(rng, 5)
    bits_j = np.asarray(jh.unpack_bipolar(jnp.asarray(d)))
    bits_t = th.unpack_bipolar(_t(d)).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    packed = th.pack_bits(torch.from_numpy((bits_j > 0).astype(np.int32)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), d)


@pytest.mark.parametrize("mode", ["margin", "ratio"])
def test_match_with_map_accept_modes(mode):
    """match_with_map end to end (margin and Lowe-ratio accept, the
    `best <= 512` guard) equals coloc_tpu's, including an invalid band."""
    from coloc_tpu import types as jtypes
    from coloc_tpu_torch import types as ttypes

    rng = np.random.default_rng(3)
    L, K = 256, 128
    md = _desc(rng, L)
    qd = _desc(rng, K)
    qd[:80] = md[rng.integers(0, L, 80)]
    noise = rng.integers(0, 2 ** 32, (20, 16), dtype=np.uint64).astype(np.uint32)
    qd[60:80] ^= noise & (noise >> 3) & (noise >> 7)    # near hits
    mv = np.ones(L, bool)
    mv[100:140] = False
    qv = rng.random(K) > 0.1
    X = rng.normal(size=(L, 3)).astype(np.float32)
    xy = rng.uniform(0, 100, (K, 2)).astype(np.float32)
    zf, zi = np.zeros(K, np.float32), np.zeros(K, np.int32)

    jopts = jcfg.MatcherOptions(mode=mode)
    jf = jtypes.Features(xy=jnp.asarray(xy), score=jnp.asarray(zf), scale=jnp.asarray(zi),
                         angle=jnp.asarray(zf), desc=jnp.asarray(qd), valid=jnp.asarray(qv))
    jm = jtypes.MapDB(X=jnp.asarray(X), desc=jnp.asarray(md), valid=jnp.asarray(mv))
    want = jmatching.match_with_map(jf, jm, jopts, bank=jmatching.pack_map_bank(jm))

    topts = tcfg.MatcherOptions(mode=mode)
    tf = ttypes.Features(xy=torch.from_numpy(xy), score=torch.from_numpy(zf),
                         scale=torch.from_numpy(zi), angle=torch.from_numpy(zf),
                         desc=_t(qd), valid=torch.from_numpy(qv))
    tm = ttypes.MapDB(X=torch.from_numpy(X), desc=_t(md), valid=torch.from_numpy(mv))
    got = tmatching.match_with_map(tf, tm, topts)
    for field in ("idx", "best", "second"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert int(got.mask.sum()) > 40
