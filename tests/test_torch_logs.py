"""The port's logs against coloc_tpu's on the CPU: io/loggers on the same
numpy inputs (text-equal, Euler unwrapping across +-pi included),
flush_logs on the same queued step outputs, inter_pose's
guidedmatches2.txt and fused (dest, src) row from the same fusion, and
when each entry point writes its rows: intra_pose at once, intra_pose_all
at flush_logs / close / the context's exit, run every 64 frames and in
`finally`, run_chunked each frame once.

The session cases run the port's real step on tests/plumbing_cases.py's
96x128 frame (no bootstrap); run's flush schedule replaces the step by
one real output replayed (70 frames in ~0.1 s). coloc_tpu's frontend is
not used.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu.io import loggers as jloggers
from coloc_tpu.parallel import mesh as jmesh
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.types import Features as JFeatures
from coloc_tpu.types import Pose as JPose
from coloc_tpu.types import PoseWithCov as JPoseWithCov

from coloc_tpu_torch import convert
from coloc_tpu_torch import session as tsession
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.io import loggers as tloggers
from coloc_tpu_torch.parallel import mesh as tmesh
from coloc_tpu_torch.types import Pose, PoseWithCov

from plumbing_cases import cameras, frame, session, step_outputs
from port_harness import one_torch_thread, time_limit  # noqa: F401

D = 2
FILES = ("poses.txt", "poses_filtered.txt", "mahalanobis.txt")


def _rows(path):
    with open(path) as fh:
        return fh.read().splitlines()


def _assert_csv_close(got_path, want_path, rtol):
    """Same header and row order; the leading index columns (3 in a pose
    log, 1 in mahalanobis.txt, 0 in guidedmatches2.txt) exactly equal, every
    value within `rtol` relative."""
    got, want = _rows(got_path), _rows(want_path)
    assert len(got) == len(want) > 0
    head = 0
    if got[0].startswith("idx,"):
        assert got[0] == want[0]
        got, want, head = got[1:], want[1:], 3
    elif "," in got[0]:
        head = 1
    for g, w in zip(got, want):
        gv, wv = g.split(","), w.split(",")
        assert gv[:head] == wv[:head]
        np.testing.assert_allclose(np.asarray(gv[head:], float), np.asarray(wv[head:], float),
                                   rtol=rtol, atol=0)


def test_pose_logger_text_equals_reference(tmp_path):
    """The same rows through both PoseLoggers: the same text. The Euler
    sequences cross +-pi both ways, so the unwrapping acts (per (dest,
    src) pair)."""
    seq = [(3.1, -0.2, 3.13), (-3.12, -0.1, -3.1), (-3.0, 3.1, 2.9), (3.0, -3.1, -3.13)]
    paths = {}
    for name, mod in (("port", tloggers), ("ref", jloggers)):
        paths[name] = str(tmp_path / f"{name}.txt")
        log = mod.PoseLogger(paths[name])
        for i, e in enumerate(seq):
            for dest, src in ((0, 0), (1, 0)):
                r = np.random.default_rng(i)
                log.log(i, dest, src, r.normal(size=3).astype(np.float32),
                        r.normal(size=(6, 6)).astype(np.float32),
                        np.asarray(e, np.float32) * (1 if dest == 0 else -1),
                        np.float32(0.25 * i), np.int32(7 * i))
    text = open(paths["port"]).read()
    assert text == open(paths["ref"]).read()
    yaw = [float(r.split(",")[17]) for r in text.splitlines()[1::2]]
    assert max(yaw) > np.pi            # unwrapped past +pi
    assert len(text.splitlines()) == 1 + 2 * len(seq)


def test_gate_logger_and_ply_text_equal_reference(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    valid = rng.uniform(size=40) < 0.6
    Cs = rng.normal(size=(2, 3)).astype(np.float32)
    dists = rng.uniform(0, 9, 5).astype(np.float32)
    for name, mod in (("port", tloggers), ("ref", jloggers)):
        gate = mod.GateLogger(str(tmp_path / f"{name}_gate.txt"))
        for d, dist in enumerate(dists):
            gate.log(d % 2, dist)
        mod.write_ply(str(tmp_path / f"{name}.ply"), X, valid, Cs)
    for suffix in ("_gate.txt", ".ply"):
        assert (open(tmp_path / f"port{suffix}").read()
                == open(tmp_path / f"ref{suffix}").read())
    ply = _rows(tmp_path / "port.ply")
    assert f"element vertex {int(valid.sum()) + 2}" in ply
    assert len(ply) == 10 + int(valid.sum()) + 2


def test_flush_logs_equals_reference(tmp_path):
    """Three frames of seeded step outputs queued in both sessions (coloc_tpu's
    entry (frame, pwcs, P, filtered, gate, eulers), the port's (frame,
    _ChunkOut)): the three files have the same header and row order, the
    indices exactly, every value within 1e-6 relative (the filtered Euler
    angles are computed by each package's rot_to_euler in float32)."""
    rng = np.random.default_rng(2)
    jc = jcfg.ColocConfig(num_drones=D)
    js = JSession(jc, *cameras(D), out_dir=str(tmp_path / "ref"))
    ts = session(D, out_dir=str(tmp_path / "port"))
    for frame_idx in (4, 5, 9):
        o = step_outputs(rng, D)
        js._pending_logs.append((
            frame_idx,
            JPoseWithCov(pose=JPose(R=jnp.asarray(o["R"]), C=jnp.asarray(o["C"])),
                         cov=jnp.asarray(o["cov"]), rmse=jnp.asarray(o["rmse"]),
                         n_tracks=jnp.asarray(o["n_tracks"]),
                         success=jnp.asarray(o["success"])),
            jnp.asarray(o["P"]), JPose(R=jnp.asarray(o["fR"]), C=jnp.asarray(o["fC"])),
            jnp.asarray(o["dist_g"]), jnp.asarray(o["eulers"])))
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in o.items()}
        ts._pending_logs.append((frame_idx, tsession._ChunkOut(
            R=t["fR"], C=t["fC"], cov=t["cov"], rmse=t["rmse"], n_tracks=t["n_tracks"],
            success=t["success"], rejected=t["rejected"], raw_C=t["C"], eulers=t["eulers"],
            dist_g=t["dist_g"], P=t["P"])))
    js.flush_logs()
    ts.flush_logs()
    assert not ts._pending_logs
    for name in FILES:
        _assert_csv_close(tmp_path / "port" / name, tmp_path / "ref" / name, rtol=1e-6)
        assert len(_rows(tmp_path / "port" / name)) == 3 * D + (name != "mahalanobis.txt")


def _fusion(rng, L=64):
    """One successful fusion's outputs (numpy): fused position and
    covariance, the relative pose and the diagnostics with L guided
    entries, about half of them valid."""
    R = so3.exp(torch.from_numpy(rng.normal(size=3).astype(np.float32) * 0.2)).numpy()
    t = rng.normal(size=3)
    return dict(
        fused_pos=rng.normal(size=3).astype(np.float32),
        fused_cov=(np.eye(3) * 0.02 + 0.001).astype(np.float32), ok=np.bool_(True),
        rel_R=R, rel_C=rng.normal(size=3).astype(np.float32), scale=np.float32(1.3),
        geo_R=R, geo_t=(t / np.linalg.norm(t)).astype(np.float32),
        n_inliers=np.int32(57), n_common=np.int32(33), rmse=np.float32(0.41),
        omega=np.float32(0.6), trace=np.float32(0.05),
        obs_src=rng.uniform(0, 120, (L, 2)).astype(np.float32),
        obs_dst=rng.uniform(0, 120, (L, 2)).astype(np.float32),
        guided_mask=rng.uniform(size=L) < 0.5, cov_rel=(np.eye(3) * 0.01).astype(np.float32))


def _inter_out(types_mod, pose_cls, arr, o):
    diag = types_mod.InterDiag(**{f: arr(o[f]) for f in types_mod.InterDiag._fields})
    return types_mod.InterPoseOut(
        fused_pos=arr(o["fused_pos"]), fused_cov=arr(o["fused_cov"]), ok=arr(o["ok"]),
        rel=pose_cls(R=arr(o["rel_R"]), C=arr(o["rel_C"])), scale=arr(o["scale"]), diag=diag)


def test_inter_pose_logs_equal_reference(tmp_path, monkeypatch):
    """The same fusion handed to both sessions' inter_pose (their
    inter_pose_device replaced by one returning it): guidedmatches2.txt
    (the guided entries' epipolar residuals, each package's float32 F;
    within 1e-5 relative) and the (dest, src) row appended to
    poses_filtered.txt (within 1e-6) equal coloc_tpu's."""
    rng = np.random.default_rng(3)
    o = _fusion(rng)
    pw = step_outputs(rng, D)
    monkeypatch.setattr(jmesh, "inter_pose_device",
                        lambda *a, **k: _inter_out(jmesh, JPose, jnp.asarray, o))
    monkeypatch.setattr(tsession.mesh, "inter_pose_device",
                        lambda *a, **k: _inter_out(tmesh, Pose, torch.as_tensor, o))
    js = JSession(jcfg.ColocConfig(num_drones=D), *cameras(D), out_dir=str(tmp_path / "ref"))
    ts = session(D, out_dir=str(tmp_path / "port"))
    js.mapdb = object()
    js.frame = ts.frame = 12
    feats_np = convert.to_numpy(ts.detect(frame()))
    jf = JFeatures(*(jnp.asarray(getattr(feats_np, f)) for f in feats_np._fields))
    tf = convert.features_from_numpy(feats_np, "cpu")
    for d in range(D):
        js.last_pose[d] = JPoseWithCov(
            pose=JPose(R=jnp.asarray(pw["R"][d]), C=jnp.asarray(pw["C"][d])),
            cov=jnp.asarray(pw["cov"][d]), rmse=jnp.asarray(pw["rmse"][d]),
            n_tracks=jnp.asarray(pw["n_tracks"][d]), success=jnp.asarray(True))
        ts.last_pose[d] = PoseWithCov(
            pose=Pose(R=torch.from_numpy(pw["R"][d]), C=torch.from_numpy(pw["C"][d])),
            cov=torch.from_numpy(pw["cov"][d]), rmse=torch.tensor(pw["rmse"][d]),
            n_tracks=torch.tensor(pw["n_tracks"][d]), success=torch.tensor(True))
    imgs = {0: frame(), 1: frame()}
    rj = js.inter_pose(0, 1, imgs, feats={0: jf, 1: jf})
    rt = ts.inter_pose(0, 1, imgs, feats={0: tf, 1: tf})
    np.testing.assert_array_equal(rt.pos.numpy(), np.asarray(rj.pos))
    guided = _rows(tmp_path / "port" / "guidedmatches2.txt")
    assert len(guided) == int(o["guided_mask"].sum()) > 0
    _assert_csv_close(tmp_path / "port" / "guidedmatches2.txt",
                      tmp_path / "ref" / "guidedmatches2.txt", rtol=1e-5)
    _assert_csv_close(tmp_path / "port" / "poses_filtered.txt",
                      tmp_path / "ref" / "poses_filtered.txt", rtol=1e-6)
    row = _rows(tmp_path / "port" / "poses_filtered.txt")[1].split(",")
    assert row[:3] == ["12", "1", "0"] and row[-1] == "57"


def _count_rows(out_dir):
    return {name: len(_rows(os.path.join(out_dir, name))) - (name != "mahalanobis.txt")
            for name in FILES}


def test_intra_pose_logs_at_once(tmp_path):
    s = session(D, out_dir=str(tmp_path))
    s.frame = 3
    res = s.intra_pose(1, frame())
    assert bool(res.success)
    assert _count_rows(tmp_path) == {name: 1 for name in FILES}
    row = _rows(tmp_path / "poses_filtered.txt")[1].split(",")
    assert row[:3] == ["3", "1", "1"] and row[-1] == str(int(res.n_tracks))
    np.testing.assert_allclose(np.asarray(row[3:6], float), res.pose.C.numpy(), rtol=1e-6)
    assert not s._pending_logs


@pytest.mark.parametrize("ender", ["flush_logs", "close", "context"])
def test_intra_pose_all_logs_at_flush(tmp_path, ender):
    """intra_pose_all queues its rows on the device; they are written at
    flush_logs, close or the context manager's exit, each frame once."""
    with session(D, out_dir=str(tmp_path)) as s:
        for f in (0, 1):
            s.frame = f
            s.intra_pose_all({d: frame() for d in range(D)})
        assert _count_rows(tmp_path) == {name: 0 for name in FILES}
        assert len(s._pending_logs) == 2
        if ender != "context":
            getattr(s, ender)()
            getattr(s, ender)()          # again: nothing more
    assert _count_rows(tmp_path) == {name: 2 * D for name in FILES}
    idx = [r.split(",")[:3] for r in _rows(tmp_path / "poses.txt")[1:]]
    assert idx == [[str(f), str(d), str(d)] for f in (0, 1) for d in range(D)]


@pytest.fixture()
def replayed_step(monkeypatch):
    """The session module's step replaced by one real output of it,
    replayed: -> the list of frames it was called on (set `fail_at` to
    make a call raise)."""
    s = session(D)
    s._ensure_support()
    imgs = torch.stack([torch.from_numpy(frame())] * D)
    real = tsession.intra_all_device_step(s.config, imgs, s.mapdb, s._map_bank(), s.Ks,
                                          s.dists, s.filter_bank,
                                          uniforms=s._draw(D))
    calls = []

    def step(*a, **k):
        calls.append(len(calls))
        if calls[-1] == getattr(step, "fail_at", -1):
            raise RuntimeError("planted failure")
        return real

    monkeypatch.setattr(tsession, "intra_all_device_step", step)
    return step, calls


def test_run_flushes_every_64_frames_and_at_the_end(tmp_path, replayed_step):
    s = session(D, out_dir=str(tmp_path))
    flushed, real_flush = [], s.flush_logs

    def flush_logs():
        flushed.append(len(s._pending_logs))
        real_flush()

    s.flush_logs = flush_logs
    s.run({d: [frame()] * 70 for d in range(D)}, inter_every=0)
    assert flushed == [64, 6]
    assert _count_rows(tmp_path) == {name: 70 * D for name in FILES}
    assert [int(r.split(",")[0]) for r in _rows(tmp_path / "poses.txt")[1::D]] == \
        list(range(70))


def test_run_flushes_in_finally(tmp_path, replayed_step):
    step, _ = replayed_step
    step.fail_at = 10
    s = session(D, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="planted"):
        s.run({d: [frame()] * 20 for d in range(D)}, inter_every=0)
    assert _count_rows(tmp_path) == {name: 10 * D for name in FILES}
    assert not s._pending_logs


def test_run_chunked_logs_each_frame_once(tmp_path, replayed_step):
    """One chunk of 2 and a last frame alone (intra_pose_all): frames 0, 1,
    2, each drone once a frame, in order."""
    _, calls = replayed_step
    s = session(D, out_dir=str(tmp_path))
    out = s.run_chunked({d: [frame()] * 3 for d in range(D)}, chunk=2)
    assert len(out[0]) == 3 and len(calls) == 3
    assert _count_rows(tmp_path) == {name: 3 * D for name in FILES}
    idx = [r.split(",")[:3] for r in _rows(tmp_path / "poses.txt")[1:]]
    assert idx == [[str(f), str(d), str(d)] for f in range(3) for d in range(D)]
