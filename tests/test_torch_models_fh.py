"""Parity of the port's geometric models F and H with coloc_tpu on the CPU:
undistort_pixel and camera.depth, the 8-point E, the fundamental 8-point
and 7-point solvers, the 4-point homography, its transfer errors and
decomposition, the homography ladder rank, relative_pose_fundamental and
relative_pose_homography with coloc_tpu's RANSAC draws injected, and the
se3 / triangulation helpers.

Inputs are seeded numpy scenes: a general scene (depths 5-14) and a plane
(depth 8 with a tilt) seen by two cameras of tests/test_session.py's
intrinsics, with pixel noise, outliers and invalid entries. A null vector
from eigh or QR has a free sign, and QR's 2-D null basis a free rotation,
so solver outputs are compared up to sign and seven_point's candidates as
a set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import ransac as jransac
from coloc_tpu import robust as jrobust
from coloc_tpu.config import RansacOptions as JRansac
from coloc_tpu.geometry import camera as jcam
from coloc_tpu.geometry import essential as jess
from coloc_tpu.geometry import homography as jhom
from coloc_tpu.geometry import se3 as jse3
from coloc_tpu.geometry import triangulation as jtri
from coloc_tpu.ops import ransac_rank as jrr
from coloc_tpu.types import Matches as JMatches
from coloc_tpu.types import Pose as JPose

from coloc_tpu_torch import convert
from coloc_tpu_torch import robust as trobust
from coloc_tpu_torch.config import RansacOptions as TRansac
from coloc_tpu_torch.geometry import camera as tcam
from coloc_tpu_torch.geometry import essential as tess
from coloc_tpu_torch.geometry import homography as thom
from coloc_tpu_torch.geometry import se3 as tse3
from coloc_tpu_torch.geometry import triangulation as ttri
from coloc_tpu_torch.ops import ransac_rank as trr
from coloc_tpu_torch.types import Pose as TPose
from port_harness import one_torch_thread, time_limit  # noqa: F401

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
DIST = np.array([-0.08, 0.02, -0.003], np.float32)


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


R_GT = _rot([0.02, -0.12, 0.015])
C_GT = np.array([1.0, 0.12, 0.05], np.float32)


def _project(R, C, X):
    Xc = (X - C) @ R.T
    return (Xc[:, :2] / Xc[:, 2:] * K[0, 0] + K[:2, 2]).astype(np.float32)


def _scene(seed, n=240, plane=False, outliers=0.3, noise=0.3):
    """(uv1, uv2, mask) pixels of two views (camera 1 at the origin,
    camera 2 at R_GT, C_GT), `outliers` of view 2 replaced by uniform
    pixels, 5% of the entries invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, 3, (n, 2))
    z = 8.0 + 0.15 * xy[:, 0] if plane else rng.uniform(5, 14, n)
    X = np.c_[xy, z].astype(np.float32)
    uv1 = _project(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X)
    uv2 = _project(R_GT, C_GT, X)
    uv1 = uv1 + rng.normal(0, noise, uv1.shape).astype(np.float32)
    uv2 = uv2 + rng.normal(0, noise, uv2.shape).astype(np.float32)
    out = rng.random(n) < outliers
    uv2[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2)).astype(np.float32)
    return uv1, uv2, rng.random(n) > 0.05


def _jcam(dist=None):
    return jcam.Camera(K=jnp.asarray(K), dist=jnp.asarray(
        np.zeros(3, np.float32) if dist is None else dist))


def _tcam(dist=None):
    return tcam.Camera(K=torch.from_numpy(K), dist=torch.from_numpy(
        np.zeros(3, np.float32) if dist is None else dist))


def _sign_dist(a, b):
    """Frobenius distance of a and b up to sign, over the last two axes."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.minimum(np.linalg.norm(a - b, axis=(-2, -1)),
                      np.linalg.norm(a + b, axis=(-2, -1)))


def _angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _dir_angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


def test_undistort_pixel_and_depth_match_reference():
    """Pixels across the frame through the 10-step undistortion (atol 1e-3
    px, float32 of the same arithmetic; measured 0), and camera
    depth exactly as coloc_tpu's formula."""
    rng = np.random.default_rng(0)
    uv = rng.uniform([0, 0], [320, 240], (500, 2)).astype(np.float32)
    want = np.asarray(jcam.undistort_pixel(_jcam(DIST), jnp.asarray(uv)))
    got = tcam.undistort_pixel(_tcam(DIST), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert np.abs(got - uv).max() > 1.0            # the distortion is not nil
    X = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.depth(torch.from_numpy(R_GT), torch.from_numpy(C_GT), torch.from_numpy(X)).numpy(),
        np.asarray(jcam.depth(jnp.asarray(R_GT), jnp.asarray(C_GT), jnp.asarray(X))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_eight_point_and_fundamental_8pt_match_reference(weighted):
    """The linear E (up to sign) and the Hartley 8-point F (scaled to F22
    = 1, so sign-free) of the scene's inliers, unweighted and with 0/1
    weights: 1e-3 relative (measured 2.3e-4 for E, 7.3e-6 for F)."""
    uv1, uv2, _ = _scene(1, outliers=0.0)
    w = (np.arange(len(uv1)) % 3 != 0).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    x1 = (uv1 - K[:2, 2]) / K[0, 0]
    x2 = (uv2 - K[:2, 2]) / K[0, 0]
    Ej = np.asarray(jess.eight_point(jnp.asarray(x1), jnp.asarray(x2), jw))
    Et = tess.eight_point(torch.from_numpy(x1), torch.from_numpy(x2), tw).numpy()
    assert _sign_dist(Et, Ej) < 1e-3 * np.linalg.norm(Ej)
    Fj = np.asarray(jess.fundamental_8pt(jnp.asarray(uv1), jnp.asarray(uv2), jw))
    Ft = tess.fundamental_8pt(torch.from_numpy(uv1), torch.from_numpy(uv2), tw).numpy()
    np.testing.assert_allclose(Ft, Fj, rtol=1e-3, atol=1e-3 * np.abs(Fj).max())
    # a batch of the same problem gives the same F
    Fb = tess.fundamental_8pt(torch.from_numpy(uv1)[None].repeat(2, 1, 1),
                              torch.from_numpy(uv2)[None].repeat(2, 1, 1),
                              None if tw is None else tw[None].repeat(2, 1)).numpy()
    np.testing.assert_allclose(Fb[1], Ft, rtol=1e-5, atol=1e-6 * np.abs(Ft).max())


def test_seven_point_candidate_set_matches_reference():
    """256 seven-point samples of the noisy inliers: the port's valid
    candidates against coloc_tpu's as sets of unit-norm F up to sign.
    As many valid candidates as coloc_tpu's (1 or 3, the cubic's real
    roots) on >= 99% of samples (measured: all), and every coloc_tpu
    candidate has a port candidate within 1e-3 (Frobenius, unit norm;
    measured median 2.4e-7, max 2.1e-4: near-double roots of the cubic,
    which float32 rounding of another null basis moves most)."""
    uv1, uv2, _ = _scene(2, outliers=0.0)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(len(uv1), 7, replace=False) for _ in range(256)])
    s1, s2 = uv1[idx], uv2[idx]
    Fj, vj = jax.vmap(jess.seven_point)(jnp.asarray(s1), jnp.asarray(s2))
    Fj, vj = np.asarray(Fj), np.asarray(vj)
    Ft, vt = tess.seven_point(torch.from_numpy(s1), torch.from_numpy(s2))
    Ft, vt = Ft.numpy(), vt.numpy()
    assert Ft.shape == (256, 3, 3, 3) and vt.shape == (256, 3)
    assert (vj.sum(1) == vt.sum(1)).mean() >= 0.99
    dists = []
    for b in range(256):
        for k in np.flatnonzero(vj[b]):
            cand = [_sign_dist(Fj[b, k], Ft[b, c]) for c in np.flatnonzero(vt[b])]
            dists.append(min(cand) if cand else np.inf)
    dists = np.asarray(dists)
    assert (dists < 1e-3).all() and np.median(dists) < 1e-5
    # each candidate satisfies the 7 constraints and det F = 0
    h1 = np.concatenate([s1, np.ones_like(s1[..., :1])], -1)
    h2 = np.concatenate([s2, np.ones_like(s2[..., :1])], -1)
    r = np.einsum("bpi,bkij,bpj->bkp", h2, Ft.astype(np.float64), h1)
    good = vt & (np.abs(np.linalg.det(Ft.astype(np.float64))) < 1e-6)
    assert good[vt].mean() >= 0.97
    assert np.median(np.abs(r)[vt]) < 1e-3


@pytest.mark.parametrize("weighted", [False, True])
def test_four_point_and_transfer_errors_match_reference(weighted):
    """The DLT homography of the plane's inliers (scaled to H22 = 1) to
    1e-3 (measured 2.1e-5); the transfer errors of 64 homographies against every
    point, single and batched, to 1e-3 relative (values near 1e12 where
    |w| < 1e-9 compared as flags)."""
    uv1, uv2, _ = _scene(4, plane=True, outliers=0.0)
    x1 = (uv1 - K[:2, 2]) / K[0, 0]
    x2 = (uv2 - K[:2, 2]) / K[0, 0]
    w = (np.arange(len(uv1)) % 4 != 0).astype(np.float32) if weighted else None
    Hj = np.asarray(jhom.four_point(jnp.asarray(x1), jnp.asarray(x2),
                                    None if w is None else jnp.asarray(w)))
    Ht = thom.four_point(torch.from_numpy(x1), torch.from_numpy(x2),
                         None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-3, atol=1e-3)
    rng = np.random.default_rng(5)
    Hs = (Hj[None] + rng.normal(0, 0.02, (64, 3, 3))).astype(np.float32)
    Hs[3, 2] = 0.0                                 # w = 0 everywhere: flagged
    want = np.asarray(jhom.transfer_error_sq_batch(jnp.asarray(Hs), jnp.asarray(x1),
                                                   jnp.asarray(x2)))
    got = thom.transfer_error_sq_batch(torch.from_numpy(Hs), torch.from_numpy(x1),
                                       torch.from_numpy(x2)).numpy()
    np.testing.assert_array_equal(got >= 1e11, want >= 1e11)
    np.testing.assert_allclose(got[want < 1e11], want[want < 1e11], rtol=1e-3, atol=1e-9)
    one_j = np.asarray(jhom.transfer_error_sq(jnp.asarray(Hs[0]), jnp.asarray(x1),
                                              jnp.asarray(x2)))
    one_t = thom.transfer_error_sq(torch.from_numpy(Hs[0]), torch.from_numpy(x1),
                                   torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(one_t, one_j, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(got[0], one_t, rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompose_homography_on_planted_motions(seed):
    """H = R + t n^T / d of planted motions (rotation up to 0.2 rad, the
    plane in front of both cameras), with its projected points: the port's
    R and unit t equal coloc_tpu's after its chirality vote (1e-3 rad;
    measured ~1e-6), both recover the planted motion, and chirality_ok
    agrees."""
    rng = np.random.default_rng(seed)
    R = _rot(rng.normal(0, 0.1, 3))
    t = rng.normal(0, 1, 3).astype(np.float32)
    t = t / np.linalg.norm(t) * 0.3
    n = np.array([0.1, -0.05, 1.0], np.float32)
    n /= np.linalg.norm(n)
    d = 6.0
    X = np.c_[rng.uniform(-2, 2, (100, 2)), np.zeros(100)].astype(np.float32)
    X[:, 2] = (d - X[:, :2] @ n[:2]) / n[2]                  # n . X = d
    x1 = X[:, :2] / X[:, 2:]
    Xc2 = X @ R.T + t
    x2 = (Xc2[:, :2] / Xc2[:, 2:]).astype(np.float32)
    Hm = (R + np.outer(t, n) / d).astype(np.float32)
    Hm *= np.float32(rng.choice([-1.7, 0.6]))                # scale and sign free
    mask = np.ones(100, bool)
    Rj, tj, nj, okj = (np.asarray(a) for a in jhom.decompose_homography(
        jnp.asarray(Hm), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask)))
    Rt, tt, nt, okt = (a.numpy() for a in thom.decompose_homography(
        torch.from_numpy(Hm), torch.from_numpy(x1), torch.from_numpy(x2),
        torch.from_numpy(mask)))
    assert bool(okt) == bool(okj)
    assert _angle(Rt, Rj) < 1e-3 and _dir_angle(tt, tj) < 1e-3
    assert _angle(Rt, R) < 1e-3 and _dir_angle(tt, t) < 1e-3


def test_homography_ladder_rank_matches_reference():
    """The H entry of the ladder rank (zmode "nonzero"): the port's operand
    build and twin against coloc_tpu's homography_ladder_rank (its Pallas
    kernel interpreted) on 4-point models of the plane: ranks equal on >=
    99.9% of models and within 2 elsewhere (the rank tests' tolerance)."""
    uv1, uv2, valid = _scene(6, plane=True)
    x1 = ((uv1 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    x2 = ((uv2 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    rng = np.random.default_rng(7)
    idx = np.stack([rng.choice(len(x1), 4, replace=False) for _ in range(256)])
    Hs = np.asarray(jhom.four_point_batch(jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
    want = np.asarray(jrr.homography_ladder_rank(
        jnp.asarray(Hs), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
        jnp.float32(300.0), 16.0))
    got = trr.homography_ladder_rank(torch.from_numpy(Hs), torch.from_numpy(x1),
                                     torch.from_numpy(x2), torch.from_numpy(valid),
                                     300.0, 16.0).numpy()
    d = np.abs(got - want)
    assert want.max() > 0 and (d == 0).mean() >= 0.999 and d.max() <= 2.0


def _relative_pose_pair(model, seed, plane):
    uv1, uv2, mask = _scene(seed, plane=plane)
    S = {"F": 7, "H": 4}[model]
    key = jax.random.PRNGKey(seed)
    opts = JRansac()
    draws = np.asarray(jransac.sample_indices(key, jnp.asarray(mask), opts.num_hypotheses, S))
    jfn = {"F": jrobust.relative_pose_fundamental, "H": jrobust.relative_pose_homography}[model]
    j = jfn(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), _jcam(), _jcam(), opts)
    t = trobust.relative_pose(model, torch.from_numpy(uv1), torch.from_numpy(uv2),
                              torch.from_numpy(mask), _tcam(), _tcam(), TRansac(),
                              sample_idx=torch.from_numpy(draws))
    return j, t


@pytest.mark.parametrize("model,seed,plane", [("F", 10, False), ("F", 11, False),
                                              ("H", 12, True), ("H", 13, True)])
def test_relative_pose_models_match_reference(model, seed, plane):
    """relative_pose_fundamental on a general scene and
    relative_pose_homography on a plane, coloc_tpu's draws injected:
    success equal, at most one borderline inlier flipped (float32 models
    round differently in XLA and torch; measured: none), R within 1e-3
    rad and the direction of t within 1e-2 rad of coloc_tpu's (measured
    up to 6.1e-4 and 3.4e-3), and the port as close to the planted motion
    as coloc_tpu within 2e-3 / 1e-2 rad."""
    j, t = _relative_pose_pair(model, seed, plane)
    assert bool(t.success) == bool(j.success) and bool(t.success)
    assert t.inliers.dtype == torch.bool and t.n_inliers.dtype == torch.int32
    assert int(t.n_inliers) == int(t.inliers.sum())
    flips = int((t.inliers.numpy() != np.asarray(j.inliers)).sum())
    assert flips <= 1, flips
    Rj, tj = np.asarray(j.R), np.asarray(j.t)
    Rt, tt = t.R.numpy(), t.t.numpy()
    assert _angle(Rt, Rj) < 1e-3 and _dir_angle(tt, tj) < 1e-2
    t_gt = -R_GT @ C_GT
    assert _angle(Rt, R_GT) <= _angle(Rj, R_GT) + 2e-3
    assert _dir_angle(tt, t_gt) <= _dir_angle(tj, t_gt) + 1e-2


def test_relative_pose_dispatch():
    """relative_pose dispatches models F and H (E is held by
    tests/test_torch_twoview.py) and refuses others."""
    uv1, uv2, mask = _scene(14, outliers=0.0)
    args = (torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(mask),
            _tcam(), _tcam(), TRansac())
    g = torch.Generator().manual_seed(0)
    for model in "FH":
        geo = trobust.relative_pose(model, *args, generator=g)
        assert geo.R.shape == (3, 3) and geo.inliers.shape == mask.shape
    with pytest.raises(ValueError, match="geometric model"):
        trobust.relative_pose("X", *args)


def test_se3_and_triangulation_helpers_match_reference():
    """se3.identity / from_Rt / relative and triangulate_two_view against
    coloc_tpu's (1e-5; the DLT point 1e-4 relative)."""
    Pi = JPose(R=jnp.asarray(_rot([0.1, 0.2, -0.05])), C=jnp.asarray([0.5, -0.2, 1.0]))
    Pj = JPose(R=jnp.asarray(_rot([-0.05, 0.1, 0.3])), C=jnp.asarray([1.5, 0.2, 0.7]))
    ti = TPose(R=torch.from_numpy(np.asarray(Pi.R)), C=torch.from_numpy(np.asarray(Pi.C)))
    tj = TPose(R=torch.from_numpy(np.asarray(Pj.R)), C=torch.from_numpy(np.asarray(Pj.C)))
    for a, b in zip(tse3.relative(ti, tj), jse3.relative(Pi, Pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    tvec = np.array([0.3, -0.1, 0.2], np.float32)
    for a, b in zip(tse3.from_Rt(ti.R, torch.from_numpy(tvec)),
                    jse3.from_Rt(Pi.R, jnp.asarray(tvec))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    ident = tse3.identity("cpu")
    assert ident.R.device.type == "cpu"
    for a, b in zip(ident, jse3.identity()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    X = np.array([0.4, -0.3, 7.0], np.float32)
    xy1 = ((X - np.asarray(Pi.C)) @ np.asarray(Pi.R).T)
    xy2 = ((X - np.asarray(Pj.C)) @ np.asarray(Pj.R).T)
    xy1, xy2 = (xy1[:2] / xy1[2]).astype(np.float32), (xy2[:2] / xy2[2]).astype(np.float32)
    want = np.asarray(jtri.triangulate_two_view(Pi.R, Pi.C, jnp.asarray(xy1),
                                                Pj.R, Pj.C, jnp.asarray(xy2)))
    got = ttri.triangulate_two_view(ti.R, ti.C, torch.from_numpy(xy1), tj.R, tj.C,
                                    torch.from_numpy(xy2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, X, rtol=1e-3)


def test_matches_from_numpy_round_trip():
    """coloc_tpu's Matches into the port and back, exactly; its mask."""
    m = JMatches(idx=jnp.asarray([3, -1, 0], jnp.int32), best=jnp.asarray([5, 9, 0], jnp.int32),
                 second=jnp.asarray([40, 11, 7], jnp.int32))
    t = convert.matches_from_numpy(m, "cpu")
    assert t.idx.dtype == torch.int32 and t.idx.device.type == "cpu"
    for a, b in zip(convert.to_numpy(t), m):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(m.mask))
