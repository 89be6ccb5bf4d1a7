"""The port's peer-to-peer runtime (coloc_tpu_torch.distributed) on the CPU,
tests/test_distributed.py's layers at tests/plumbing_cases.py's 96x128
scene: the bundle over the codec, DronePeer.inter_fuse over a decoded
bundle against the port's ColocSession.inter_pose (exact: one compute
core), its refusals (stale, capacity, no pose), the injected shared map,
and two OS processes of the `distributed` entry point (run_peer) fusing
each other over a port broker. The comparison with coloc_tpu's DronePeer
is in tests/test_torch_inter.py, beside the fusion core it runs.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from coloc_tpu_torch import checkpoint, config as tcfg
from coloc_tpu_torch.distributed import DronePeer
from coloc_tpu_torch.io import disk, synthetic, transport
from coloc_tpu_torch.matching import match_pair, pack_map_bank
from coloc_tpu_torch.ransac import sample_indices
from coloc_tpu_torch.session import ColocSession
from coloc_tpu_torch.types import MapDB

import plumbing_cases as pc
from port_harness import one_torch_thread, time_limit  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DET = dict(width=pc.W, height=pc.H, max_keypoints=256, num_levels=3, fast_threshold=10)
FRAMES = 4


def make_config(D=2):
    return tcfg.ColocConfig(num_drones=D, detector=tcfg.DetectorOptions(**DET),
                            max_landmarks=512)


@pytest.fixture(scope="module")
def boot():
    """The plumbing scene along two drones' FRAMES-frame trajectories; a
    port session bootstrapped on frame 0 and stepped on frame 1."""
    scene = pc.scene()
    frames = {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(FRAMES, d)
        frames[d] = [synthetic.render(scene, Rs[f], Cs[f]).astype(np.float32)
                     for f in range(FRAMES)]
    s = ColocSession(make_config(), *pc.cameras(2), device="cpu")
    assert s.init_map({d: frames[d][0] for d in range(2)})
    s.frame = 1
    s.intra_pose_all({d: frames[d][1] for d in range(2)})
    return s, frames


def _peer_like(s, frames, drone=1, **kw):
    """An offline DronePeer for `drone` with the session's map, mirroring
    the session's state after its frame-1 step."""
    peer = DronePeer(drone, make_config(), pc.K, np.zeros(3), s.mapdb, node=None,
                     device="cpu", **kw)
    peer._last_image = frames[drone][1]
    peer.frame = 1
    peer.session.last_pose[0] = s.last_pose[drone]
    return peer


def _bundle(s, feats, drone=0, timestamp=0.0):
    lp = s.last_pose[drone]
    return transport.decode_feature_bundle(transport.bundle_from_features(
        drone, 0, timestamp, feats, pc.K, np.zeros(3), lp.pose.R, lp.pose.C,
        lp.cov[3:6, 3:6]))


def test_bundle_codec_roundtrip_bit_exact():
    """tests/test_distributed.py's round trip through the port's codec."""
    rng = np.random.default_rng(0)
    n = 100
    xy = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    score = rng.uniform(0, 255, n).astype(np.float32)
    scale = rng.integers(0, 8, n).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    desc = rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) > 0.3
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    C, cov3 = rng.normal(size=3), np.diag(rng.uniform(0.01, 1, 3))
    payload = transport.encode_feature_bundle(1, 7, 123.25, xy, score, scale, angle, desc,
                                              valid, pc.K, np.array([0.1, -0.05, 0.0]), R,
                                              C, cov3)
    b = transport.decode_feature_bundle(payload)
    assert b["drone"] == 1 and b["frame"] == 7 and b["timestamp"] == 123.25
    for k, v in (("xy", xy), ("score", score), ("scale", scale), ("angle", angle),
                 ("desc", desc), ("valid", valid), ("K", np.asarray(pc.K, np.float64)),
                 ("R", R), ("C", C), ("cov3", cov3)):
        np.testing.assert_array_equal(b[k], v)
    assert len(payload) < 90 * n + 400


def test_inter_fuse_equals_session_inter_pose(boot):
    """Wire-path interPoseEstimator == the in-process session.inter_pose on
    identical inputs (features, poses, map, five-point draws): exactly on
    the CPU. The staleness gate: a bundle stamped an hour ago is refused
    before any work, a fresh one fuses, a per-call max_age overrides."""
    s, frames = boot
    imgs = {d: frames[d][1] for d in range(2)}
    feats = {d: s.detect(imgs[d]) for d in range(2)}
    m = match_pair(feats[0], feats[1], s.config.matcher)
    draws = sample_indices(m.mask, s.config.ransac.num_hypotheses, 5,
                           torch.Generator().manual_seed(7))
    host = s.inter_pose(0, 1, imgs, feats=feats, sample_idx=draws)
    assert host is not None
    peer = _peer_like(s, frames)
    bundle = _bundle(s, feats[0])
    fused = peer.inter_fuse(0, bundle=bundle, sample_idx=draws, publish=False)
    assert fused is not None
    for a, b in zip(fused, host):
        assert torch.equal(a, b)
    stale = dict(bundle, timestamp=time.time() - 3600.0)
    state = peer.session.generator.get_state()
    assert peer.inter_fuse(0, bundle=stale, publish=False) is None
    assert torch.equal(peer.session.generator.get_state(), state)
    fresh = dict(bundle, timestamp=time.time())
    assert peer.inter_fuse(0, bundle=fresh, sample_idx=draws, publish=False) is not None
    assert peer.inter_fuse(0, bundle=fresh, publish=False, max_age=1e-9) is None


def test_capacity_mismatch_and_no_pose_refused(boot):
    """A peer with another keypoint capacity is refused; so is a fusion
    before this peer has a pose; neither draws from the generator."""
    s, frames = boot
    peer = _peer_like(s, frames)
    n = 64  # != the config's capacity of 256
    bundle = transport.decode_feature_bundle(transport.encode_feature_bundle(
        0, 0, 0.0, np.zeros((n, 2), np.float32), np.zeros(n), np.zeros(n, np.int32),
        np.zeros(n), np.zeros((n, 16), np.uint32), np.zeros(n, bool), pc.K, np.zeros(3),
        np.eye(3), np.zeros(3), np.eye(3)))
    state = peer.session.generator.get_state()
    assert peer.inter_fuse(0, bundle=bundle, publish=False) is None
    del peer.session.last_pose[0]
    assert peer.inter_fuse(0, bundle=_bundle(s, s.detect(frames[0][1])), publish=False) is None
    assert torch.equal(peer.session.generator.get_state(), state)
    with pytest.raises(RuntimeError):
        DronePeer(0, make_config(), pc.K, np.zeros(3), s.mapdb, device="cpu").bundle()


def _raw_C(path):
    rows = [ln.split(",") for ln in open(path).read().splitlines()[1:]]
    return np.array([[float(v) for v in r[3:6]] for r in rows]), [int(r[-1]) for r in rows]


def test_injected_map_rebuilds_bank_and_support(boot, tmp_path):
    """Inject a map, step; inject another (the landmarks in permuted slots,
    the world shifted by 5 cm), step the same frame with the same draws:
    the bank is packed for the new map and the support arrays rebuilt for
    its slots, so the step equals that of a peer given the second map from
    the start: the same unfiltered pose (poses.txt), track count and
    support, exactly. With the permutation alone the unfiltered pose equals
    the first map's."""
    s, frames = boot
    L = s.mapdb.X.shape[0]
    perm = torch.randperm(L, generator=torch.Generator().manual_seed(3))
    img = frames[0][1]
    for shift in ([0.0, 0.0, 0.0], [0.05, -0.02, 0.03]):
        moved = MapDB(X=s.mapdb.X[perm] + torch.tensor(shift), desc=s.mapdb.desc[perm],
                      valid=s.mapdb.valid[perm])
        runs = {}
        for tag, first in (("injected", s.mapdb), ("fresh", moved)):
            out = tmp_path / f"{tag}{shift[0]}"
            peer = DronePeer(0, make_config(), pc.K, np.zeros(3), first, device="cpu",
                             out_dir=str(out))
            state = peer.session.generator.get_state()
            if tag == "injected":
                peer.step(img)
                sup_a = peer.session.lm_support.clone()
                peer.set_map(moved)
                assert peer.session.lm_support is None
                peer.session.generator.set_state(state)
            peer.step(img)
            assert peer.session.mapdb.X is moved.X
            assert all(torch.equal(a, b) for a, b in zip(peer.session._map_bank(),
                                                         pack_map_bank(moved)))
            peer.close()
            C, ntracks = _raw_C(out / "poses.txt")
            runs[tag] = (C[-1], ntracks[-1], peer.session.lm_support)
        (Ci, ni, si), (Cf, nf, sf) = runs["injected"], runs["fresh"]
        np.testing.assert_array_equal(Ci, Cf)
        assert ni == nf > 0 and torch.equal(si, sf)
        if shift == [0.0, 0.0, 0.0]:
            np.testing.assert_array_equal(Ci, _raw_C(tmp_path / "injected0.0" / "poses.txt")[0][0])
            assert torch.equal(si, sup_a[perm])


def test_two_process_peers_fuse_each_other(boot, tmp_path):
    """Two OS processes of `python -m coloc_tpu_torch.distributed --cpu`
    (run_peer), one drone each: the shared map from checkpoint.save_mapdb,
    frames from write_dataset, bundles and poses over a port broker; each
    localizes and fuses the other's bundle, and says it ran on the CPU."""
    s, _ = boot
    checkpoint.save_mapdb(str(tmp_path / "map.npz"), s.mapdb)
    data = tmp_path / "data"
    synthetic.write_dataset(str(data), pc.scene(), 2, 3)
    disk.write_calib(str(data / "calib.txt"), (pc.W, pc.H), *pc.cameras(2))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with transport.Broker() as broker:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "coloc_tpu_torch.distributed", "--drone", str(d),
             "--peers", str(1 - d), "--map", str(tmp_path / "map.npz"), "--calib",
             str(data / "calib.txt"), "--folder", str(data), "--broker",
             f"127.0.0.1:{broker.port}", "--maxkp", "256", "--levels", "3",
             "--fast-threshold", "10", "--inter-every", "2", "--cpu"],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for d in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
    for d, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"peer {d}:\n{out}\n{err}"
        line = [ln for ln in out.splitlines() if ln.startswith(f"drone {d} on cpu:")]
        assert line, out
        n_fused = int(line[0].split(",")[1].split()[0])
        assert n_fused >= 1, line[0]


def test_concurrent_threads_refine_and_fuse(boot):
    """Sessions stepping on threads of one process, as DronePeers in one
    process do: torch.func's forward-mode levels are process-wide, so
    essential.refine_relative_pose serialises its jacfwd. Twelve threads
    (more than the cores) with a short switch interval refine the same
    planted motion, and two peers fuse on two threads at once: no thread
    fails and every result equals the one computed alone."""
    import sys
    import threading

    from coloc_tpu_torch.geometry import essential, so3

    rng = np.random.default_rng(4)
    P = np.c_[rng.uniform(-3, 3, (60, 2)), rng.uniform(5, 15, (60, 1))]
    R = so3.exp(torch.tensor([0.02, -0.05, 0.01])).double().numpy()
    t = np.array([0.6, 0.1, 0.05]) / np.linalg.norm([0.6, 0.1, 0.05])
    Pc = (R @ P.T).T + t
    x1 = torch.tensor(P[:, :2] / P[:, 2:], dtype=torch.float32)
    x2 = torch.tensor(Pc[:, :2] / Pc[:, 2:], dtype=torch.float32)
    R0 = so3.exp(torch.tensor([0.025, -0.045, 0.0]))
    t0 = torch.tensor([0.58, 0.12, 0.06])
    t0 = t0 / torch.linalg.norm(t0)
    w = torch.ones(60)
    ref = essential.refine_relative_pose(R0, t0, x1, x2, w)

    s, frames = boot
    imgs = {d: frames[d][1] for d in range(2)}
    feats = {d: s.detect(imgs[d]) for d in range(2)}
    peers = {d: _peer_like(s, frames, drone=d) for d in range(2)}
    bundles = {d: _bundle(s, feats[d], drone=d) for d in range(2)}
    draws = {}
    for d in range(2):
        m = match_pair(feats[1 - d], feats[d], s.config.matcher)
        draws[d] = sample_indices(m.mask, s.config.ransac.num_hypotheses, 5,
                                  torch.Generator().manual_seed(11 + d))
    alone = {d: peers[d].inter_fuse(1 - d, bundle=bundles[1 - d], sample_idx=draws[d],
                                    publish=False) for d in range(2)}
    assert all(v is not None for v in alone.values())

    errors, outs = [], {}

    def refine(i):
        try:
            for _ in range(2):
                outs[("refine", i)] = essential.refine_relative_pose(R0, t0, x1, x2, w)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            errors.append(repr(e))

    def fuse(d):
        try:
            outs[("fuse", d)] = peers[d].inter_fuse(1 - d, bundle=bundles[1 - d],
                                                    sample_idx=draws[d], publish=False)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=refine, args=(i,)) for i in range(12)]
                   + [threading.Thread(target=fuse, args=(d,)) for d in range(2)])
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads), errors
    for i in range(12):
        assert all(torch.equal(a, b) for a, b in zip(outs[("refine", i)], ref))
    for d in range(2):
        assert all(torch.equal(a, b) for a, b in zip(outs[("fuse", d)], alone[d]))
