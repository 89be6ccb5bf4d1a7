"""The port's sharded_map_match (a 1-D mesh of 2 ranks and a 2 x 2 drone x
map mesh, L and Q uneven too) and make_sharded_serve_step (2 ranks) against
coloc_tpu's on the CPU. coloc_tpu runs its shard_map programs on the
virtual CPU devices (tests/conftest.py); the port runs gloo CPU ranks,
spawned once for each mesh in a module fixture (tests/mesh_cases.py, no
jax). torch cannot replay jax.random, so each serving rank is handed the
samples coloc_tpu draws: its step folds the key with the shard index,
splits that into one key a stream and draws from the stream's
correspondences.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from coloc_tpu import config as jcfg
from coloc_tpu import matching as jmatching
from coloc_tpu import ransac as jransac
from coloc_tpu import serving as jserving
from coloc_tpu import types as jtypes
from coloc_tpu.geometry import camera as jcam
from coloc_tpu.parallel import mesh as jmesh

from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.parallel import mesh

import mesh_cases as mc
from port_harness import one_torch_thread, time_limit  # noqa: F401

D, NB = mc.D, mc.NB
# sharded serving: B streams over the 2 ranks (tests/test_torch_serving.py's
# streams, a camera each)
SH, SW, SKP, SL, SB = 240, 320, 256, 512, 4
SK = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def _jmapdb(ma):
    return jtypes.MapDB(X=jnp.asarray(ma.X), desc=jnp.asarray(ma.desc),
                        valid=jnp.asarray(ma.valid))


def _match_cases(rng, shapes):
    """(Q, L) bank cases: random descriptors, a tenth of the bank invalid,
    some queries planted on bank rows (the last rows too)."""
    cases = []
    for Q, L in shapes:
        td = rng.integers(0, 2 ** 32, (L, 16), dtype=np.uint64).astype(np.uint32)
        qd = rng.integers(0, 2 ** 32, (Q, 16), dtype=np.uint64).astype(np.uint32)
        n = min(Q // 3, 16)
        qd[:n] = td[L - n:]
        qd[n:2 * n] = td[3:3 + n]
        tv = rng.random(L) > 0.1
        tv[L - n:] = True
        cases.append(dict(qd=qd.view(np.int32), qv=np.ones(Q, bool), td=td.view(np.int32),
                          tv=tv))
    return cases


def _jmatch(run, case):
    out = run(*(jnp.asarray(case[k].view(np.uint32) if k in ("qd", "td") else case[k])
                for k in ("qd", "qv", "td", "tv")))
    return [np.asarray(x) for x in out]


def _serve_reference():
    """tests/test_torch_serving.py's per-stream streams (B = SB), coloc_tpu's
    sharded step on 2 devices, and each stream's draws."""
    rng = np.random.default_rng(11)
    fa = synthetic.random_features(SH, SW, SKP, rng)
    ma = synthetic.consistent_mapdb(fa, SK, SL, rng)
    Ks = np.stack([SK] * SB)
    Ks[:, 0, 0] *= 1.0 + 0.04 * np.arange(SB)
    Ks[:, 1, 2] += 3.0 * np.arange(SB)
    Rs = so3.exp(torch.from_numpy(rng.normal(size=(SB, 3)).astype(np.float32) * 0.02)).numpy()
    Cs = (rng.normal(size=(SB, 3)) * 0.1).astype(np.float32)
    Xc = np.einsum("bij,bkj->bki", Rs, ma.X[None, :SKP] - Cs[:, None])
    xy = np.einsum("bij,bkj->bki", Ks, Xc / Xc[..., 2:])[..., :2]
    xy = (xy + rng.normal(size=xy.shape) * 0.5).astype(np.float32)
    valid = fa.valid & (rng.uniform(size=(SB, SKP)) < 0.9)
    feats = synthetic.FeaturesArrays(
        xy=xy, score=np.broadcast_to(fa.score, (SB, SKP)).copy(),
        scale=np.broadcast_to(fa.scale, (SB, SKP)).copy(),
        angle=np.broadcast_to(fa.angle, (SB, SKP)).copy(),
        desc=np.broadcast_to(fa.desc, (SB, SKP, 16)).copy(), valid=valid)
    cfg = jcfg.ColocConfig()
    jf = jtypes.Features(*(jnp.asarray(getattr(feats, f)) for f in feats._fields))
    jdb = _jmapdb(ma)
    cams = jcam.Camera(K=jnp.asarray(Ks), dist=jnp.zeros((SB, 3)))
    key = jax.random.PRNGKey(5)
    bank = jmatching.pack_map_bank(jdb)
    run = jserving.make_sharded_serve_step(jmesh.make_mesh(jax.devices()[:D]), cfg)
    out = jax.tree_util.tree_map(np.asarray, run(key, jf, cams, jdb, bank[0], bank[1]))
    corr = (out[2].idx >= 0) & valid
    b = SB // D
    draws = np.stack([
        np.asarray(jransac.sample_indices(
            jax.random.split(jax.random.fold_in(key, i), b)[j], corr[i * b + j], NB, 3))
        for i in range(D) for j in range(b)])
    return out, dict(feats=feats, map=ma, Ks=Ks, draws=draws)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases_1d = _match_cases(rng, [(96, 1024), (41, 101)])
    cases_2d = _match_cases(rng, [(64, 512), (11, 101)])
    matcher = mc.config(jcfg).matcher
    run_1d = jmesh.sharded_map_match(jmesh.make_mesh(jax.devices()[:D]), matcher)
    m2d = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), axis_names=("drone", "map"))
    run_2d = jmesh.sharded_map_match(m2d, matcher, axis="map", query_axis="drone")
    serve_out, serve = _serve_reference()
    out = tmp_path_factory.mktemp("mesh_sharded")
    mesh.spawn(mc.sharded_programs, D, (str(out), cases_1d, serve))
    mesh.spawn(mc.sharded_programs_2d, 4, (str(out), cases_2d))
    return SimpleNamespace(
        match_1d=[_jmatch(run_1d, c) for c in cases_1d],
        match_2d=[_jmatch(run_2d, c) for c in cases_2d], cases_2d=cases_2d, serve=serve_out,
        ranks=[np.load(out / f"sharded{d}.npz") for d in range(D)],
        ranks_2d=[np.load(out / f"sharded2d{r}.npz") for r in range(4)])


@pytest.mark.parametrize("case", [0, 1], ids=["L1024", "L101_uneven"])
def test_sharded_map_match_1d_equals_reference(reference, case):
    """The bank over the 2 ranks of the drone axis, every query on every
    rank: idx, best and second equal coloc_tpu's exactly."""
    for d in range(D):
        got = mc.leaves(reference.ranks[d], f"match{case}/m")
        for g, w in zip(got, reference.match_1d[case]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", [0, 1], ids=["Q64_L512", "Q11_L101_uneven"])
def test_sharded_map_match_2d_equals_reference(reference, case):
    """The 2 x 2 ("drone", "map") mesh: the queries over the drone rows,
    the bank over the map columns; both ranks of a drone row hold its
    queries' matches, and the rows together equal coloc_tpu's exactly."""
    ranks = [mc.leaves(r, f"match{case}/m") for r in reference.ranks_2d]
    for r in (1, 3):
        for a, b in zip(ranks[r], ranks[r - 1]):
            np.testing.assert_array_equal(a, b)
    Q = len(reference.cases_2d[case]["qv"])
    assert sum(len(ranks[r][0]) for r in (0, 2)) == Q
    for i, w in enumerate(reference.match_2d[case]):
        np.testing.assert_array_equal(np.concatenate([ranks[0][i], ranks[2][i]]), w)


def test_sharded_serving_matches_reference(reference):
    """make_sharded_serve_step on 2 ranks, 2 streams each, with each
    shard's draws: the matches equal coloc_tpu's (idx, best, second),
    success equal, n_tracks within one borderline inlier (C8); the centre
    within 1e-5 where the counts agree (tests/test_serving.py's gate for
    coloc_tpu's sharded step against its single-shard step; measured
    9.2e-7), within tests/test_torch_serving.py's 2e-3 where one differs
    (measured 8.6e-4)."""
    pwc, inl, mm = reference.serve
    b = SB // D
    for d in range(D):
        # leaves: R, C, cov, rmse, n_tracks, success, inliers, idx, best, second
        got = mc.leaves(reference.ranks[d], "serve")
        rows = slice(d * b, (d + 1) * b)
        for g, w in zip(got[7:], mm):
            np.testing.assert_array_equal(g, w[rows])
        np.testing.assert_array_equal(got[5], pwc.success[rows])
        assert got[5].all()
        dn = np.abs(got[4] - pwc.n_tracks[rows])
        assert dn.max() <= 1
        err = np.abs(got[1] - pwc.pose.C[rows]).max(axis=1)
        assert (err <= np.where(dn == 0, 1e-5, 2e-3)).all(), (err, dn)
