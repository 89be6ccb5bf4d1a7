"""The port's run and run_chunked with inter-drone fusion rounds on their
`inter_every` schedule, on the CPU (coloc_tpu's schedule: run fuses on
every frame whose index is a multiple of `inter_every`; run_chunked after
every `inter_every` frames rounded up to whole chunks, on the chunk's last
frame). The scene and sizes are tests/test_session.py's (scene seed 3,
240x320, 4 levels, 512 keypoints, 512 landmarks); the port alone, so
numpy and torch only.
"""

import numpy as np
import torch

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch.io import synthetic as tsyn
from coloc_tpu_torch.session import ColocSession
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K, K]), np.zeros((2, 3), np.float32)
CFG = tcfg.ColocConfig(num_drones=2, max_landmarks=512, detector=tcfg.DetectorOptions(
    width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10))


def _frames(n):
    """n frames of drones 0 and 1 and their ground-truth rotations."""
    scene = tsyn.make_scene(H, W, K, seed=3)
    traj = [tsyn.trajectory(n, d) for d in range(2)]
    return ({d: [tsyn.render(scene, traj[d][0][f], traj[d][1][f]) for f in range(n)]
             for d in range(2)}, traj)


def _session():
    return ColocSession(CFG, KS, DISTS, seed=0, device="cpu")


def _counted(sess):
    """Wrap sess.inter_pose_round to record the frame of each round."""
    frames_at, real = [], sess.inter_pose_round

    def wrapped(images, policy="auto"):
        frames_at.append(sess.frame)
        return real(images, policy)
    sess.inter_pose_round = wrapped
    return frames_at


def _angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _check_run(results, traj, n):
    """As test_torch_bootstrap.py::test_run_end_to_end checks run: every
    frame, at most one failure a drone, drone 0 moving along +x, rotation
    error median under 1 degree."""
    for d in (0, 1):
        assert len(results[d]) == n
        ok = [bool(p.success) for p in results[d]]
        assert sum(ok) >= len(ok) - 1, (d, ok)
    C = np.stack([p.pose.C.numpy() for p in results[0]])
    assert C[-1, 0] > C[0, 0]
    Rs_gt = traj[0][0]
    errs = [np.degrees(_angle(p.pose.R.numpy(), Rs_gt[i + 1] @ Rs_gt[0].T))
            for i, p in enumerate(results[0]) if bool(p.success)]
    assert np.median(errs) < 1.0, errs


def test_run_default_inter_every():
    """run(frames) with the reference's default inter_every=10 over 11
    frames: one round, on frame 10, checked as run."""
    frames, traj = _frames(11)
    ts = _session()
    at = _counted(ts)
    out = ts.run(frames)
    assert at == [10] and ts.frame == 10
    _check_run(out, traj, 10)


def test_run_inter_every_3():
    """run(frames, inter_every=3) over 6 frames: one round, on frame 3,
    checked as run; frames 1-3 bit-equal to run(inter_every=0) from the
    same seed (a round reads the map and the poses, draws from the
    generator and writes no state, so only later frames draw
    differently)."""
    frames, traj = _frames(6)
    ts = _session()
    at = _counted(ts)
    out = ts.run(frames, inter_every=3)
    assert at == [3] and ts.frame == 5
    _check_run(out, traj, 5)
    base = _session()
    ref = base.run({d: frames[d][:4] for d in range(2)}, inter_every=0)
    for d in (0, 1):
        for a, b in zip(out[d][:3], ref[d]):
            assert torch.equal(a.pose.C, b.pose.C) and torch.equal(a.cov, b.cov)


def test_run_chunked_inter_every():
    """run_chunked(chunk=2, inter_every=2) over 6 frames: a round after
    every chunk on its last frame (2, 4, then 5 after the partial chunk),
    self.frame one past it; checked as run; on the CPU bit-equal to
    run(inter_every=2), which fuses on the same frames in the same draw
    order (no round after frame 5 there, the last frame)."""
    frames, traj = _frames(6)
    ts = _session()
    at = _counted(ts)
    out = ts.run_chunked(frames, chunk=2, inter_every=2)
    assert at == [2, 4, 5] and ts.frame == 6
    _check_run(out, traj, 5)
    ref = _session()
    ref_out = ref.run(frames, inter_every=2)
    for d in (0, 1):
        for a, b in zip(out[d], ref_out[d]):
            for x, y in zip((a.pose.R, a.pose.C, a.cov, a.n_tracks, a.success),
                            (b.pose.R, b.pose.C, b.cov, b.n_tracks, b.success)):
                assert torch.equal(x, y)
    for x, y in zip(ts.filter_bank, ref.filter_bank):
        assert torch.equal(x, y)
