"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Each test needs a CUDA device and skips without one (the kernels have no
CPU or interpret mode). This file imports neither jax nor coloc_tpu, so it
runs where jax is absent; there, skip the repo's jax conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from coloc_tpu_torch import convert
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import fivept, p3p
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.ops import diffusion, dispatch, fast, hamming, patches, ransac_rank
from rank_cases import (THR_SQ, planted_epi_operands, planted_rank_operands,
                        twostage_edge_case)
from port_harness import one_torch_thread, time_limit  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _desc(rng, n):
    return torch.from_numpy(
        rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)
        .view(np.int32).copy())


@pytest.mark.parametrize("Q,T", [(1, 1), (33, 300), (1024, 4096), (1000, 4200)])
def test_k2nn_kernel_equals_plain(dev, Q, T):
    rng = np.random.default_rng(Q + T)
    t = _desc(rng, T)
    q = t[torch.from_numpy(rng.integers(0, T, Q))].clone()
    q[Q // 2:] = _desc(rng, Q - Q // 2)            # half exact hits, half random
    if T > 300:
        t[T - 1] = t[7]                              # a duplicate in another tile
        q[0] = t[7]
    t_valid = torch.from_numpy(rng.random(T) > 0.1)
    q_valid = torch.from_numpy(rng.random(Q) > 0.05)
    bank = hamming.pack_bank(t.to(dev), t_valid.to(dev))
    before = dispatch.launch_counts()["k2nn"]
    got = hamming.hamming_2nn_bank(q.to(dev), q_valid.to(dev), bank)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["k2nn"] == before + 1
    want = hamming.hamming_2nn_plain(q, q_valid, hamming.pack_bank(t, t_valid))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_k2nn_kernel_all_invalid_bank(dev):
    rng = np.random.default_rng(1)
    bank = hamming.pack_bank(_desc(rng, 100).to(dev),
                             torch.zeros(100, dtype=torch.bool, device=dev))
    idx, best, second = hamming.hamming_2nn_bank(
        _desc(rng, 8).to(dev), torch.ones(8, dtype=torch.bool, device=dev), bank)
    assert (idx == -1).all() and (best == 2048).all() and (second == 2048).all()


def _flip(row, bits):
    out = row.copy()
    for b in bits:
        out[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


@pytest.mark.parametrize("Q,T", [(1000, 8200), (5000, 8192), (64, 262144)])
def test_k2nn_kernel_splits_ties_invalid(dev, Q, T):
    """B1 across the kernel's bank splits (eighths of its 256-row stages):
    duplicates of query 0's best in three later splits and in the last
    stage (partial at T=8200); two rows at equal distance from query 1 in
    different splits; an invalid band that covers a whole split and holds
    query 5's own row; Q no multiple of the 64-query tile but one."""
    rng = np.random.default_rng(T)
    t = rng.integers(0, 2 ** 32, (T, 16), dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, 2 ** 32, (Q, 16), dtype=np.uint64).astype(np.uint32)
    r0 = T // 16
    t[[3 * T // 8 + 5, 6 * T // 8 + 9, T - 1]] = t[r0]
    q[0] = t[r0]
    tie_a, tie_b = T // 8 + 3, 5 * T // 8 + 1
    t[tie_a] = _flip(q[1], range(0, 10))
    t[tie_b] = _flip(q[1], range(100, 110))
    t_valid = np.ones(T, bool)
    t_valid[T // 4 - 300:3 * T // 8 + 2] = False
    q[5] = t[T // 4]
    q_valid = np.ones(Q, bool)
    q_valid[7] = False
    qt, tt = (torch.from_numpy(a.view(np.int32)) for a in (q, t))
    qv, tv = torch.from_numpy(q_valid), torch.from_numpy(t_valid)
    before = dispatch.launch_counts()["k2nn"]
    got = hamming.hamming_2nn_bank(qt.to(dev), qv.to(dev), hamming.pack_bank(tt.to(dev), tv.to(dev)))
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["k2nn"] == before + 1
    want = hamming.hamming_2nn_plain(qt, qv, hamming.pack_bank(tt, tv))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    idx, best, second = (g.cpu() for g in got)
    assert (int(idx[0]), int(best[0]), int(second[0])) == (r0, 0, 0)
    assert (int(idx[1]), int(best[1]), int(second[1])) == (tie_a, 10, 10)
    assert int(idx[5]) != T // 4
    assert int(best[7]) == int(second[7]) == 2048


def _samples(rng, B):
    fa = synthetic.random_features(480, 752, 1024, rng)
    K = np.array([[451.2, 0, 376], [0, 451.2, 240], [0, 0, 1]], np.float32)
    ma = synthetic.consistent_mapdb(fa, K, 1024, rng)
    cam = convert.camera_from_numpy(K, device="cpu")
    b = cam_ops.bearing(cam, torch.from_numpy(fa.xy))
    idx = torch.from_numpy(np.stack([rng.choice(1024, 3, replace=False)
                                     for _ in range(B)]))
    return torch.from_numpy(ma.X)[idx], b[idx]


def _degenerate(Xs, bs, n):
    """The first n samples with collinear world points (the third the
    midpoint of the first two), the next n with two equal bearings."""
    Xs, bs = Xs.clone(), bs.clone()
    Xs[:n, 2] = (Xs[:n, 0] + Xs[:n, 1]) * 0.5
    bs[n:2 * n, 1] = bs[n:2 * n, 0]
    return Xs, bs


@pytest.mark.parametrize("B,n_degenerate", [(1, 0), (255, 0), (256, 0), (1000, 0), (256, 2)])
def test_p3p_kernel_equals_plain(dev, B, n_degenerate):
    """B2 against its twin: float32 P3P is held statistically (ROADMAP C8),
    valid masks agree on >= 99% of samples and flats within 1e-4 where both
    are valid; B = 255 leaves a partial last sample group of the kernel's
    warp, and degenerate samples (collinear points, equal bearings) sit
    among normal ones."""
    Xs, bs = _samples(np.random.default_rng(B), B)
    Xs, bs = _degenerate(Xs, bs, n_degenerate)
    before = dispatch.launch_counts()["p3p"]
    fk, vk = p3p.p3p_flats_batch(Xs.to(dev), bs.to(dev))
    fp, vp = p3p.p3p_flats_plain(Xs.to(dev), bs.to(dev))
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["p3p"] == before + 1
    assert float((vk == vp).all(dim=1).float().mean()) >= 0.99
    both = vk & vp
    rel = (fk - fp).abs()[both] / (1.0 + fp.abs()[both])
    assert float(rel.max()) <= 1e-4


def _rank_operands(Hm, M):
    rng = np.random.default_rng(Hm + M)
    Xs, bs = _samples(rng, max((Hm + 3) // 4, 1))
    flats, _ = p3p.p3p_flats_plain(Xs, bs)
    flats = flats.reshape(-1, 12)[:Hm]
    X = torch.from_numpy(rng.uniform(-3, 3, (M, 3)).astype(np.float32)) + torch.tensor([0, 0, 8.0])
    b = torch.nn.functional.normalize(X + torch.from_numpy(rng.normal(0, 0.01, (M, 3)).astype(np.float32)), dim=-1)
    valid = torch.from_numpy(rng.random(M) > 0.2)
    return ransac_rank.p3p_operands(flats, X, b, valid, 451.2)


@pytest.mark.parametrize("zmode", ["pos", "nonzero"])
@pytest.mark.parametrize("Hm,M", [(1, 5), (9, 300), (300, 257), (1024, 1024), (1024, 5000)])
def test_rank_kernel_equals_plain(dev, zmode, Hm, M):
    """B3 equals its twin exactly: every value is the twin's operation
    (-fmad=false) and the counts are integers."""
    ops = [t.to(dev) for t in _rank_operands(Hm, M)]
    before = dispatch.launch_counts()["ransac_rank"]
    got = ransac_rank.ladder_rank(*ops, 16.0, zmode)
    want = ransac_rank.ladder_rank_plain(*ops, 16.0, zmode)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["ransac_rank"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("zmode", ["pos", "nonzero"])
@pytest.mark.parametrize("reps,models", [(1, 6), (97, 1000)])
def test_rank_kernel_planted_edges(dev, zmode, reps, models):
    """B3 on tests/rank_cases.py's planted inputs (a Z plane exactly 0,
    points behind, |Z| at 1e-9 and just below, masked points, a NaN column
    and a NaN observation, residuals exactly on a rung), alone and tiled
    over the kernel's point splits and model tiles; and the generic rung
    path (4 rungs)."""
    eflat, xh, obs, maskf = (torch.from_numpy(a) for a in planted_rank_operands(reps))
    eflat = eflat.repeat(-(-models // eflat.shape[0]), 1)[:models].contiguous()
    ops = [t.to(dev) for t in (eflat, xh, obs, maskf)]
    for n_rungs in (5, 4):
        got = ransac_rank.ladder_rank(*ops, THR_SQ, zmode, 2, n_rungs)
        want = ransac_rank.ladder_rank_plain(*ops, THR_SQ, zmode, 2, n_rungs)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert float(got[0]) > 0 and float(got[1]) == 0   # identity counts, Z = 0 never


def _drone_operands(D, Hm, M):
    """D drones' B3 operands, each drone its own models, points and mask."""
    per = [_rank_operands(Hm, M + d) for d in range(D)]
    return [torch.stack([p[i][..., :M] if i else p[i] for p in per]).contiguous()
            for i in range(4)]


@pytest.mark.parametrize("zmode", ["pos", "nonzero"])
@pytest.mark.parametrize("D,Hm,M", [(2, 256, 1024), (3, 1024, 5000), (2, 9, 300)])
def test_rank_kernel_drone_axis(dev, zmode, D, Hm, M):
    """B3 over a drone axis is one launch (the grid's z), and each drone's
    ranks equal a D = 1 launch on that drone's operands and the batched
    twin, bit for bit."""
    ops = [t.to(dev) for t in _drone_operands(D, Hm, M)]
    before = dispatch.launch_counts()["ransac_rank"]
    got = ransac_rank.ladder_rank(*ops, 16.0, zmode)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["ransac_rank"] == before + 1
    assert got.shape == (D, Hm)
    assert torch.equal(got, ransac_rank.ladder_rank_plain(*ops, 16.0, zmode))
    for d in range(D):
        one = ransac_rank.ladder_rank(*(t[d] for t in ops), 16.0, zmode)
        assert torch.equal(got[d], one)


@pytest.mark.parametrize("zmode", ["pos", "nonzero"])
def test_rank_kernel_drone_axis_planted(dev, zmode):
    """tests/rank_cases.py's planted inputs tiled over 3 drones, drone d's
    mask rolled by d: equal to per-drone launches and the twin."""
    eflat, xh, obs, maskf = (torch.from_numpy(a) for a in planted_rank_operands(97))
    eflat = eflat.repeat(-(-1000 // eflat.shape[0]), 1)[:1000]
    ops = [torch.stack([t] * 3).contiguous().to(dev) for t in (eflat, xh, obs)]
    ops.append(torch.stack([maskf.roll(d) for d in range(3)]).contiguous().to(dev))
    for n_rungs in (5, 4):
        got = ransac_rank.ladder_rank(*ops, THR_SQ, zmode, 2, n_rungs)
        want = ransac_rank.ladder_rank_plain(*ops, THR_SQ, zmode, 2, n_rungs)
        assert torch.equal(got, want)
        for d in range(3):
            one = ransac_rank.ladder_rank(*(t[d] for t in ops), THR_SQ, zmode, 2, n_rungs)
            assert torch.equal(got[d], one)


def _session_on(dev, backend="trip"):
    """A D = 2 session on the card at the CPU tests' size (240x320, 4
    levels, 256 keypoints) with a 512-landmark map consistent with the
    identity view, and two drones' frames near it; `backend` "akaze": the
    AKAZE frontend with ratio matching."""
    from coloc_tpu_torch import config
    from coloc_tpu_torch.session import ColocSession

    H, W = 240, 320
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    det = config.DetectorOptions(width=W, height=H, max_keypoints=256, num_levels=4,
                                 fast_threshold=12, backend=backend)
    matcher = config.MatcherOptions(mode="ratio" if backend == "akaze" else "margin")
    cfg = config.ColocConfig(num_drones=2, detector=det, matcher=matcher, max_landmarks=512)
    scene = synthetic.make_scene(H, W, K, seed=1)
    eye = np.eye(3, dtype=np.float32)
    base = synthetic.render(scene, eye, np.zeros(3, np.float32)).astype(np.float32)
    from coloc_tpu_torch.frontend import detect_and_describe
    f0 = convert.to_numpy(detect_and_describe(torch.from_numpy(base).to(dev), det))
    ma = synthetic.consistent_mapdb(f0, K, 512, np.random.default_rng(0))
    sess = ColocSession(cfg, np.stack([K, K]), np.zeros((2, 3), np.float32), device=dev)
    sess.mapdb, sess.map_ready = convert.mapdb_from_numpy(ma, dev), True
    sess._ensure_support()
    images = torch.from_numpy(np.stack([
        synthetic.render(scene, eye, np.asarray(c, np.float32))
        for c in ((0.02, 0, 0), (0, 0.03, 0))]).astype(np.float32)).to(dev)
    return sess, images


# the launches of one replayed frame: TRIP's five kernels once each; AKAZE's
# B10 once an octave (2 at 4 levels) and B11 for orientation and descriptor
STEP_LAUNCHES = {
    "trip": {"k2nn": 1, "p3p": 1, "ransac_rank": 1, "fast_nms": 1, "extract": 1},
    "akaze": {"k2nn": 1, "p3p": 1, "ransac_rank": 1, "fed_octave": 2, "sample_raster": 2},
}


def _captured_step_equals_eager(dev, backend):
    from coloc_tpu_torch import session as sess_mod

    sess, images = _session_on(dev, backend)
    u = torch.rand((2, 2, 256, 3), device=dev, generator=torch.Generator(dev).manual_seed(3))
    g = sess_mod._StepGraphs(sess)
    g.load(sess)
    # the pose LM: one launch a head or middle graph, its covariance one a tail
    assert [r["pose_lm"] for r in g.records] == [1, 1, 0]
    assert [r["pose_cov"] for r in g.records] == [0, 0, 1]
    fb, sup, last = sess.filter_bank, sess.lm_support, sess.lm_last_seen
    for f in range(2):
        before, reads = dispatch.launch_counts(), g.host_reads
        out = g.replay(images, u[f])
        torch.cuda.synchronize()
        after = dispatch.launch_counts()
        for name, n in STEP_LAUNCHES[backend].items():
            assert after[name] - before[name] == n, name
        # a middle replay follows each exit read but a last one that finds
        # every lane stopped
        middles = after["pose_lm"] - before["pose_lm"] - 1
        assert middles in (g.host_reads - reads - 1, g.host_reads - reads)
        assert after["pose_cov"] - before["pose_cov"] == 1
        pwcs, fb, filt, dist_g, rej, eulers, sup_inc = sess_mod.intra_all_device_step(
            sess.config, images, sess.mapdb, sess._map_bank(), sess.Ks, sess.dists, fb,
            uniforms=u[f])
        sup, last = sess_mod._support(sup, last, sup_inc, sess.frame + f)
        for a, b in zip(out, sess_mod._chunk_out(pwcs, filt, rej, dist_g, eulers, fb.P)):
            assert torch.equal(a, b)
        for a, b in zip(g.fb, fb):
            assert torch.equal(a, b)
        assert torch.equal(g.sup, sup) and torch.equal(g.last, last)
        assert bool(out.success.all())


def test_captured_step_equals_eager(dev):
    """The frame step replayed from its CUDA graphs against the eager step
    on the same static inputs and uniforms, two frames from one state:
    torch.equal on every output (pose, covariance, rmse, n_tracks,
    success, gate decisions), the filter bank and the landmark support;
    the graphs' launches counted at each replay."""
    _captured_step_equals_eager(dev, "trip")


def test_captured_akaze_step_equals_eager(dev):
    """The same with the AKAZE frontend: B10's cooperative launches and
    B11 replayed from the graphs, every output equal to the eager step."""
    _captured_step_equals_eager(dev, "akaze")


def _chunk_equals_eager(dev, backend):
    """intra_pose_chunk (captured, the draws injected as minimal samples)
    against intra_pose_all frame by frame with the same samples: equal
    outputs, filter bank, support and frame counter. -> (the captured
    session, the eager one, the block, the samples)."""
    captured, images = _session_on(dev, backend)
    eager, _ = _session_on(dev, backend)
    idx = torch.randint(0, 100, (2, 2, 256, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
    block = torch.stack([images, images.flip(0)])
    out = captured.intra_pose_chunk(block, sample_idx=idx)
    assert captured._graphs is not None and captured._graphs.inject
    for f in range(2):
        eager.frame = f
        res = eager.intra_pose_all({d: block[f, d] for d in range(2)}, sample_idx=idx[f])
        for d in range(2):
            a, b = out[d][f], res[d]
            for x, y in zip((a.pose.R, a.pose.C, a.cov, a.rmse, a.n_tracks, a.success),
                            (b.pose.R, b.pose.C, b.cov, b.rmse, b.n_tracks, b.success)):
                assert torch.equal(x, y)
    for x, y in zip(captured.filter_bank, eager.filter_bank):
        assert torch.equal(x, y)
    assert torch.equal(captured.lm_support, eager.lm_support)
    assert torch.equal(captured.lm_last_seen, eager.lm_last_seen)
    assert captured.frame == 2
    return captured, eager, block, idx


def test_chunk_with_injected_draws_equals_eager(dev):
    """intra_pose_chunk on the card (captured, the draws injected as minimal
    samples) against intra_pose_all frame by frame with the same samples:
    equal outputs, filter bank, support and frame counter; and captured
    again when the map changes."""
    captured, eager, block, idx = _chunk_equals_eager(dev, "trip")
    # a new map (a new MapDB, as init_map makes) is captured again
    old = captured._graphs
    captured.mapdb = eager.mapdb = captured.mapdb._replace(X=captured.mapdb.X + 0.0)
    out = captured.intra_pose_chunk(block[:1], sample_idx=idx[:1])
    assert captured._graphs is not old and captured._graphs.mapdb is captured.mapdb
    res = eager.intra_pose_all({d: block[0, d] for d in range(2)}, sample_idx=idx[0])
    for d in range(2):
        assert torch.equal(out[d][0].pose.C, res[d].pose.C)


def test_akaze_chunk_equals_eager(dev):
    """The same chunk with the AKAZE frontend (ROADMAP A5a-3): every output,
    the filter bank and the support equal to the eager frames."""
    _chunk_equals_eager(dev, "akaze")


def _step_reads_nothing(dev, backend):
    from coloc_tpu_torch import session as sess_mod

    sess, images = _session_on(dev, backend)
    cfg = sess.config
    sess_mod.intra_all_device_step(cfg, images, sess.mapdb, sess._map_bank(), sess.Ks,
                                   sess.dists, sess.filter_bank, uniforms=sess._draw(2))
    idx = torch.randint(0, 100, (2, 256, 3), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sess_mod.intra_all_device_step(
            cfg, images, sess.mapdb, sess._map_bank(), sess.Ks, sess.dists,
            sess.filter_bank, sample_idx=idx, check_every=cfg.refiner.max_iterations)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out[0].pose.R.shape == (2, 3, 3)


def test_step_reads_nothing_on_the_host(dev):
    """One eager frame step with its draws injected on the card and the LM's
    exit left to its done mask: under torch.cuda.set_sync_debug_mode
    ("error") no operation synchronizes with the host."""
    _step_reads_nothing(dev, "trip")


def test_akaze_step_reads_nothing_on_the_host(dev):
    """The same with the AKAZE frontend: its level, disc and MLDB tables are
    per-device constants, so no host-to-device copy is left in the step."""
    _step_reads_nothing(dev, "akaze")


def _squares(h, w, value):
    """value-filled 5x5 squares on black every 12 px: their corners' best
    arcs score exactly `value`."""
    img = np.zeros((h, w), np.float32)
    for y0 in range(8, h - 12, 12):
        for x0 in range(8, w - 12, 12):
            img[y0:y0 + 5, x0:x0 + 5] = value
    return img


def _fast_input(kind, h, w, rng):
    if kind == "at_threshold":
        # corners scoring exactly the threshold (zeroed: the test is
        # strict) beside corners scoring 12.5
        img = _squares(h, w, 12.0)
        img[:, w // 2:] = _squares(h, w - w // 2, 12.5)
        return torch.from_numpy(img)
    if kind == "nan_ring":
        img = _squares(h, w, 255.0)
        img[10, 10] = np.nan       # ring k=6 of the corner (8, 8), off the compass
        img[23, 44] = np.nan       # ring k=8 of the corner (20, 44), a compass point
        img[32, 68] = np.nan       # a centre
        return torch.from_numpy(img)
    if kind in ("squares", "negative_threshold"):
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
        img[10:58, 10:58] = _squares(48, 48, 255.0)
        return torch.from_numpy(img)
    if kind == "zeros":
        return torch.zeros(h, w)
    if kind == "ties":
        # every pixel scores the same where it scores: a checkerboard of
        # 0 / 255 gives equal arcs everywhere
        yy, xx = np.mgrid[0:h, 0:w]
        return torch.from_numpy(((yy + xx) % 2 * 255.0).astype(np.float32))
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img[4:40, 4:100] = 0.0
    img[10:30:8, 10:90:8] = 255.0                    # isolated plateaus
    return torch.from_numpy(img)


@pytest.mark.parametrize("kind,h,w", [("random", 32, 32), ("random", 97, 131),
                                      ("random", 4464, 768), ("zeros", 64, 64),
                                      ("ties", 70, 45), ("random", 5, 7),
                                      ("at_threshold", 100, 200), ("nan_ring", 80, 140),
                                      ("negative_threshold", 97, 131), ("squares", 150, 197),
                                      ("squares", 150, 130), ("squares", 150, 68)])
def test_fast_nms_kernel_equals_plain(dev, kind, h, w):
    """Bit-equal to the twin, including where B4's early-out could go wrong:
    a plateau at exactly the threshold, a negative threshold (both sides
    pass), NaN on a corner's ring and at a centre, and widths that are no
    multiple of its 62-px tile or of 4 (clamped scalar loads)."""
    img = _fast_input(kind, h, w, np.random.default_rng(h * w))
    threshold = -3.0 if kind == "negative_threshold" else 12.0
    before = dispatch.launch_counts()["fast_nms"]
    raw, nms = fast.fast_nms(img.to(dev), threshold)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fast_nms"] == before + 1
    want_raw, want_nms = fast.fast_nms_plain(img, threshold)
    assert torch.equal(raw.cpu(), want_raw)
    assert torch.equal(nms.cpu(), want_nms)


@pytest.mark.parametrize("K", [1, 33, 2048])
def test_extract_kernel_equals_plain(dev, K):
    rng = np.random.default_rng(K)
    R, WP = 2232, 768
    src = torch.from_numpy(rng.uniform(0, 255, (R, WP)).astype(np.float32))
    row0 = rng.integers(0, R - patches.PH + 1, K)
    col0 = rng.integers(0, WP - patches.PW + 1, K)
    if K > 1:
        # the last rows and columns, unaligned and out-of-range origins
        row0[:6] = [R - patches.PH, R - patches.PH, 0, R - patches.PH - 3, R, -9]
        col0[:6] = [WP - patches.PW, 0, WP - patches.PW, WP - patches.PW + 5, 1, WP]
    row0 = torch.from_numpy(row0.astype(np.int32))
    col0 = torch.from_numpy(col0.astype(np.int32))
    before = dispatch.launch_counts()["extract"]
    got = patches.extract_patches(src.to(dev), row0.to(dev), col0.to(dev))
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["extract"] == before + 1
    assert torch.equal(got.cpu(), patches.extract_patches_plain(src, row0, col0))


def _fivept_samples(B, seed=0):
    """B five-point samples of two views, the second half planar (the
    twin-solution regime): x1, x2 (B, 5, 2)."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-3, 3, (B * 5, 2)), rng.uniform(5, 15, (B * 5, 1))].reshape(B, 5, 3)
    X[B // 2:, :, 2] = 8.0
    Xc = X - [0.3, 0.05, 0.0]
    return (torch.from_numpy((X[..., :2] / X[..., 2:]).astype(np.float32)),
            torch.from_numpy((Xc[..., :2] / Xc[..., 2:]).astype(np.float32)))


def _fivept_stages(x1, x2):
    xs = torch.cat([x1[:, :, 0], x1[:, :, 1], x2[:, :, 0], x2[:, :, 1]], dim=1).T.contiguous()
    basis, md, coef, npoly = fivept.front_plain(xs)
    c, s = fivept.dk_normalise(npoly)
    roots, is_real = fivept.dk_roots_plain(c, s)
    delta = 0.01 * (roots.abs() + 1.0)
    seeds = torch.cat([roots, roots + delta, roots - delta]).contiguous()
    return xs, (basis, md, coef, npoly), (c, s), (md, coef, basis, seeds, is_real.repeat(3, 1))


@pytest.mark.parametrize("B", [1, 37, 201, 256, 1000, 2048])
def test_fivept_kernels_equal_plain(dev, B):
    """B6, B7, B8 each against its plain twin on the same card inputs: the
    kernels repeat the twins' arithmetic (-fmad=false), so bit-equal, B8 on
    every seed (E of invalid seeds too, NaN by position). B = 1 and 37
    leave B6's last CTA of 4 samples part empty, 1 and 1000 B7's last warp
    of 3 polynomials; B8 takes two samples a CTA at 201 and 256 on a card
    of 132 SMs (201 leaves the last one part empty), one elsewhere."""
    x1, x2 = _fivept_samples(B)
    xs, front_out, dk_in, polish_in = _fivept_stages(x1.to(dev), x2.to(dev))
    before = dispatch.launch_counts()
    got = fivept.front(xs)
    for g, w in zip(got, front_out):
        assert torch.equal(g, w)
    roots, is_real = fivept.dk_roots(*dk_in)
    want = fivept.dk_roots_plain(*dk_in)
    assert torch.equal(roots, want[0]) and torch.equal(is_real, want[1])
    Es, valid = fivept.polish(*polish_in)
    want = fivept.polish_plain(*polish_in)
    torch.cuda.synchronize()
    assert torch.equal(valid, want[1])
    assert _same_bits(Es, want[0])
    after = dispatch.launch_counts()
    for name in ("fivept_front", "fivept_dk", "fivept_polish"):
        assert after[name] == before[name] + 1


def _same_bits(got, want):
    """NaN where the twin has NaN, the same float32 bits elsewhere (so the
    sign of a zero counts); masks equal."""
    if not want.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


@pytest.mark.parametrize("lead", [0, 37])
def test_fivept_kernels_planted_edges(dev, lead):
    """B6 on io/synthetic.five_point_edge_samples (two identical points,
    five collinear, all at the origin: Gauss-Jordan's 1e-20 pivot floor,
    a NaN coordinate) and B7 on dk_edge_polys (a double root, a leading
    coefficient under dk_normalise's 1e-12 floor, an infinite and a NaN
    coefficient), alone and after `lead` ordinary samples; B8 on the front's
    outputs and DK's seeds of these, then with plant_polish_edges' seed
    rows (NaN, +-inf, +-1e30) and all-zero sample; each against its twin:
    NaN where the twin has NaN, equal bits elsewhere."""
    e1, e2 = synthetic.five_point_edge_samples()
    x1, x2 = _fivept_samples(lead) if lead else (torch.zeros(0, 5, 2), torch.zeros(0, 5, 2))
    x1 = torch.cat([x1, torch.from_numpy(e1)]).to(dev)
    x2 = torch.cat([x2, torch.from_numpy(e2)]).to(dev)
    xs, front_out, _, _ = _fivept_stages(x1, x2)
    before = dispatch.launch_counts()
    got = fivept.front(xs)
    torch.cuda.synchronize()
    for g, w in zip(got, front_out):
        assert _same_bits(g, w)
    npoly = torch.cat([front_out[3][:, :lead], torch.from_numpy(synthetic.dk_edge_polys()).to(dev)],
                      dim=1)
    c, s = fivept.dk_normalise(npoly)
    roots, is_real = fivept.dk_roots(c, s)
    want = fivept.dk_roots_plain(c, s)
    torch.cuda.synchronize()
    assert _same_bits(roots, want[0]) and torch.equal(is_real, want[1])
    assert bool(torch.isnan(want[0][:, -2:]).all()) and not bool(want[1][:, -2:].any())
    delta = 0.01 * (want[0].abs() + 1.0)
    seeds = torch.cat([want[0], want[0] + delta, want[0] - delta]).contiguous()
    polish_in = (front_out[1], front_out[2], front_out[0], seeds,
                 want[1].repeat(3, 1).contiguous())
    planted = synthetic.plant_polish_edges(*(t.clone() for t in polish_in))
    for args in (polish_in, planted):
        Es, valid = fivept.polish(*args)
        want_p = fivept.polish_plain(*args)
        torch.cuda.synchronize()
        assert _same_bits(Es, want_p[0]) and torch.equal(valid, want_p[1])
    after = dispatch.launch_counts()
    for name, n in (("fivept_front", 1), ("fivept_dk", 1), ("fivept_polish", 2)):
        assert after[name] == before[name] + n


def test_five_point_batch_card_against_cpu(dev):
    """The whole solver on the card against the CPU plain path: the plain
    steps between the launches (monic normalisation, pow/exp/log) round
    differently on the two devices, so the two are held by what RANSAC
    needs, the per-sample solutions."""
    x1, x2 = _fivept_samples(256, seed=1)
    Ek, vk = fivept.five_point_batch(x1.to(dev), x2.to(dev))
    Ec, vc = fivept.five_point_batch(x1, x2)
    h1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    h2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)

    def best(Es, valid):
        alg = torch.einsum("bsi,bhij,bsj->bhs", h2, Es.cpu(), h1).abs().amax(-1)
        return torch.where(valid.cpu(), alg, float("inf")).amin(-1)

    solved_c, solved_k = best(Ec, vc) < 1e-4, best(Ek, vk) < 1e-4
    assert int((solved_c & ~solved_k).sum()) <= 1
    assert float((vk.cpu() == vc).float().mean()) >= 0.9


@pytest.mark.parametrize("Hm,M", [(1, 5), (1110, 300), (7680, 1024)])
def test_epi_rank_kernel_equals_plain(dev, Hm, M):
    rng = np.random.default_rng(Hm + M)
    Es = torch.from_numpy(rng.normal(size=(Hm, 3, 3)).astype(np.float32))
    x1 = torch.from_numpy(rng.uniform(-0.6, 0.6, (M, 2)).astype(np.float32))
    x2 = x1 + torch.from_numpy(rng.normal(0, 0.01, (M, 2)).astype(np.float32))
    valid = torch.from_numpy(rng.random(M) > 0.2)
    ops = [t.to(dev).contiguous() for t in ransac_rank.epipolar_operands(
        Es, x1, x2, valid, 451.2 ** 2, 480.0 ** 2, 16.0)]
    before = dispatch.launch_counts()["epi_rank"]
    got = ransac_rank.epi_rank(*ops)
    want = ransac_rank.epi_rank_plain(*ops)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["epi_rank"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("Hm,M,odd_mask", [(1, 5, False), (33, 301, True), (1000, 1027, False),
                                           (70, 2100, True)])
def test_epi_rank_kernel_planted_edges(dev, Hm, M, odd_mask):
    """B9 on tests/rank_cases.py's planted epipolar inputs (compares exactly
    on a rung, zero and clamped denominators, NaN data, a masked band, masks
    of 1/2 on the float path), at Hm = 1 and off the 32-model tile, M = 5,
    off the 4-point grid and over two 1024-point stages; 5 rungs and the
    generic loop (4): equal to the twin, one launch a call."""
    ops = [torch.from_numpy(a).to(dev) for a in planted_epi_operands(Hm, M, odd_mask=odd_mask)]
    for n_rungs in (5, 4):
        before = dispatch.launch_counts()["epi_rank"]
        got = ransac_rank.epi_rank(*ops, 2, n_rungs)
        want = ransac_rank.epi_rank_plain(*ops, 2, n_rungs)
        torch.cuda.synchronize()
        assert dispatch.launch_counts()["epi_rank"] == before + 1
        assert torch.equal(got, want)
        assert float(got[0]) > 0


@pytest.mark.parametrize("h,w", [(37, 61), (120, 188)])
def test_fed_octave_kernel_equals_plain(dev, h, w):
    """B10, B = 2 with distinct k^2 at odd sizes, the default preset's
    octave-0 schedule: the kernel repeats the twin's arithmetic in its
    order (-fmad=false), so all four planes are bit-equal."""
    rng = np.random.default_rng(h * w)
    L = torch.from_numpy(rng.uniform(0, 1, (2, h, w)).astype(np.float32)).to(dev)
    k2 = torch.tensor([0.01, 0.04], device=dev)
    _, cycles, sigma4s = diffusion.octave_schedule(4, 4, 1.6, 0.25)[0]
    before = dispatch.launch_counts()["fed_octave"]
    got = diffusion.fed_octave(L, k2, cycles, sigma4s)
    want = diffusion.fed_octave_plain(L, k2, cycles, sigma4s)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fed_octave"] == before + 1
    for g, w_, name in zip(got, want, ("L", "Lx", "Ly", "response")):
        assert g.shape == (2, 4, h, w)
        assert torch.equal(g, w_), name


@pytest.mark.parametrize("h,w", [(120, 188), (480, 752)])
def test_fed_octave_kernel_captured_equals_eager(dev, h, w):
    """B10's cooperative launch captured into a CUDA graph by
    torch.cuda.graph: each replay writes the planes an eager launch writes,
    bit for bit, for new input written into the static buffers; the
    capture launches nothing, a replay is one launch by the record."""
    rng = np.random.default_rng(h + w)
    _, cycles, sigma4s = diffusion.octave_schedule(4, 4, 1.6, 0.25)[0]
    L = torch.from_numpy(rng.uniform(0, 1, (2, h, w)).astype(np.float32)).to(dev)
    k2 = torch.tensor([0.01, 0.04], device=dev)
    diffusion.fed_octave(L, k2, cycles, sigma4s)       # loads the library
    torch.cuda.synchronize()
    graph, record = torch.cuda.CUDAGraph(), {}
    with dispatch.counted_capture(record), torch.cuda.graph(graph):
        out = diffusion.fed_octave(L, k2, cycles, sigma4s)
    assert record["fed_octave"] == 1
    for trial in range(2):
        L.copy_(torch.from_numpy(rng.uniform(0, 1, (2, h, w)).astype(np.float32)))
        graph.replay()
        want = diffusion.fed_octave(L, k2, cycles, sigma4s)
        torch.cuda.synchronize()
        for g, w_, name in zip(out, want, ("L", "Lx", "Ly", "response")):
            assert torch.equal(g, w_), (trial, name)


def _fed_equal_one_launch(dev, L, k2, cycles, sigma4s):
    """One fed_octave call on the card: one launch, all four planes
    bit-equal to the twin."""
    before = dispatch.launch_counts()["fed_octave"]
    got = diffusion.fed_octave(L, k2, cycles, sigma4s)
    want = diffusion.fed_octave_plain(L, k2, cycles, sigma4s)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["fed_octave"] == before + 1
    for g, w_, name in zip(got, want, ("L", "Lx", "Ly", "response")):
        assert g.shape == (L.shape[0], len(cycles), *L.shape[1:])
        assert torch.equal(g, w_), name


@pytest.mark.parametrize("octave", [0, 3])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 37), (37, 1), (9, 130), (37, 61), (481, 753)])
def test_fed_octave_kernel_edge_shapes(dev, h, w, octave):
    """B10 where its tiles meet the image border: images smaller than the
    halo, one row or column, widths off the tile grid, a frame one pixel
    larger than the bench's; B = 2 with distinct k^2, on octave 0's
    schedule (5 + 4 + 4 + 5 steps) and octave 3's (3 + 4 + 4 + 5)."""
    rng = np.random.default_rng(h * w + octave)
    L = torch.from_numpy(rng.uniform(0, 1, (2, h, w)).astype(np.float32)).to(dev)
    k2 = torch.tensor([0.01, 0.04], device=dev)
    _, cycles, sigma4s = diffusion.octave_schedule(4, 4, 1.6, 0.25)[octave]
    _fed_equal_one_launch(dev, L, k2, cycles, sigma4s)


@pytest.mark.parametrize("h,w", [(9, 130), (37, 61)])
def test_fed_octave_kernel_plan_limits(dev, h, w):
    """B10 at the Plan's limits: 8 sublevels and 128 steps, in cycles of 20
    and 12 steps that the kernel cuts into chunks between grid barriers."""
    rng = np.random.default_rng(h + w)
    L = torch.from_numpy(rng.uniform(0, 1, (2, h, w)).astype(np.float32)).to(dev)
    k2 = torch.tensor([0.01, 0.04], device=dev)
    cycles = ((tuple(diffusion.fed_tau_cycle(30.0)),) * 4
              + (tuple(diffusion.fed_tau_cycle(10.0)),) * 4)
    assert [len(c) for c in cycles] == [20] * 4 + [12] * 4
    _fed_equal_one_launch(dev, L, k2, cycles, tuple(float(i + 1) for i in range(8)))


@pytest.mark.parametrize("C,ph,NS", [(2, 48, 49), (3, 64, 464)])
def test_sample_raster_kernel_equals_plain(dev, C, ph, NS):
    """B11 at K = 77 (no multiple of any tile), with .5 coordinate ties,
    coordinates outside the window and unaligned or out-of-range origins:
    exact (a gather of bf16 values)."""
    rng = np.random.default_rng(C)
    K, stride, WP, pw = 77, 300, 768, 128
    src = torch.from_numpy(rng.uniform(-3, 3, (6 * stride, WP)).astype(np.float32)
                           ).to(torch.bfloat16)
    row0 = rng.integers(0, 6 * stride - (C - 1) * stride - ph + 1, K)
    col0 = rng.integers(0, WP - pw + 1, K)
    row0[:4] = [6 * stride, 6 * stride - ph - 3, 5, 0]
    col0[:4] = [WP + 9, WP - pw + 7, 130, 0]
    lx = rng.uniform(-6, pw + 5, (K, NS)).astype(np.float32)
    ly = rng.uniform(-6, ph + 5, (K, NS)).astype(np.float32)
    lx[:, :6] = [0.5, 1.5, 2.5, 126.5, 127.5, -0.5]
    ly[:, :6] = [0.5, 1.5, ph - 1.5, ph - 0.5, 3.5, -0.5]
    args = [torch.from_numpy(a.astype(np.int32)) for a in (row0, col0)] + [
        torch.from_numpy(lx), torch.from_numpy(ly)]
    before = dispatch.launch_counts()["sample_raster"]
    got = patches.sample_raster_flat(src.to(dev), stride, *(a.to(dev) for a in args),
                                     C=C, ph=ph, pw=pw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["sample_raster"] == before + 1
    want = patches.sample_raster_plain(src, stride, *args, C, ph, pw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("K,NS,C,shift", [(1, 464, 3, 0), (77, 1, 2, 0), (1, 1, 3, 0),
                                           (5, 49, 3, 0), (9, 8, 2, 1)])
def test_sample_raster_kernel_edges(dev, K, NS, C, shift):
    """B11 at K = 1, NS = 1, both, NS off the 4-sample grid, and coordinate
    rows that are not 16-byte aligned (a view at an odd offset): origins
    past the raster's end, .5 ties; exact, one launch a call."""
    rng = np.random.default_rng(K * NS + shift)
    stride, WP, ph, pw = 300, 768, 64, 128
    src = torch.from_numpy(rng.uniform(-3, 3, (C * stride, WP)).astype(np.float32)
                           ).to(torch.bfloat16)
    row0 = torch.from_numpy(rng.integers(0, C * stride + 20, K).astype(np.int32))
    col0 = torch.from_numpy(rng.integers(0, WP + 9, K).astype(np.int32))
    lx = rng.uniform(-6, pw + 5, K * NS + shift).astype(np.float32)
    ly = rng.uniform(-6, ph + 5, K * NS + shift).astype(np.float32)
    lx[shift:shift + 2], ly[shift:shift + 2] = 2.5, ph - 0.5
    lx_d = torch.from_numpy(lx).to(dev)[shift:].view(K, NS)
    ly_d = torch.from_numpy(ly).to(dev)[shift:].view(K, NS)
    before = dispatch.launch_counts()["sample_raster"]
    got = patches.sample_raster_flat(src.to(dev), stride, row0.to(dev), col0.to(dev), lx_d,
                                     ly_d, C=C, ph=ph, pw=pw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["sample_raster"] == before + 1
    want = patches.sample_raster_plain(src, stride, row0, col0, lx_d.cpu(), ly_d.cpu(), C, ph,
                                       pw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("Q,T", [(5, 2048), (100, 5000), (1024, 262144)])
def test_k2nn_group_kernel_equals_plain(dev, Q, T):
    """B12 with a partial last group, invalid rows and a duplicated best
    row: exact (integer keys), then the two-stage match on the card
    against the CPU plain path."""
    rng = np.random.default_rng(Q)
    t = _desc(rng, T)
    q = t[torch.from_numpy(rng.integers(0, T, Q))].clone()
    q[Q // 2:] = _desc(rng, Q - Q // 2)
    t[T - 1] = t[3]                                  # a duplicate in another group
    q[0] = t[3]
    t_valid = torch.from_numpy(rng.random(T) > 0.05)
    t_valid[[3, T - 1]] = True
    q_valid = torch.ones(Q, dtype=torch.bool)
    bank = hamming.pack_bank_twostage(t.to(dev), t_valid.to(dev))
    q_pf = hamming.prefilter_words(q.to(dev))
    before = dispatch.launch_counts()["k2nn_group"]
    got = hamming.group_top2(q_pf, bank)
    want = hamming.group_top2_plain(q_pf, bank)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["k2nn_group"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out = hamming.hamming_2nn_twostage(q.to(dev), q_valid.to(dev), bank)
    ref = hamming.hamming_2nn_twostage(q, q_valid, hamming.pack_bank_twostage(t, t_valid))
    for g, w in zip(out, ref):
        assert torch.equal(g.cpu(), w)
    assert int(out[0][0]) == 3 and int(out[1][0]) == 0 and int(out[2][0]) == 0


@pytest.mark.parametrize("Q,T", [(5, 2049), (130, 6145), (3, 2), (40, 100), (1024, 6145)])
def test_k2nn_group_kernel_edges(dev, Q, T):
    """B12 on tests/rank_cases.py's two-stage edges (a last group of one
    real row, groups with one and no valid rows, duplicates within and
    across groups, all-zero and all-ones rows and queries, a query equal
    to a bank row), Q below 16 and off the 128-query tile: equal to the
    twin, one launch a call."""
    qd, td, tv = twostage_edge_case(Q, T)
    bank = hamming.pack_bank_twostage(torch.from_numpy(td.view(np.int32)).to(dev),
                                      torch.from_numpy(tv).to(dev))
    q_pf = hamming.prefilter_words(torch.from_numpy(qd.view(np.int32)).to(dev))
    before = dispatch.launch_counts()["k2nn_group"]
    got = hamming.group_top2(q_pf, bank)
    want = hamming.group_top2_plain(q_pf, bank)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["k2nn_group"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
