"""The port's serving runner over the topic bus (coloc_tpu_torch.serve) on
the CPU, on tests/plumbing_cases.py's 96x128 frame and map: what goes out
on the pose topics is what ServingEngine.localize_frames computes from the
same frames and generator state, one host copy a dispatch, stale streams
not re-published, the idle loop, and `main` (the entry point) with its
device rule. The runner's own layer (Euler angles, the covariance slice,
frame ids, timestamps, success, stale streams) is held against coloc_tpu's
ServeRunner: both run over an in-memory node (what a runner asks of
transport.Node, so no native library is loaded), coloc_tpu's engine
answering with the port's engine outputs on the same frames.
"""

import collections
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from coloc_tpu_torch import checkpoint, convert, serve
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.io import disk, transport

import plumbing_cases as pc
from port_harness import one_torch_thread, time_limit  # noqa: F401

B = 3


def _frames():
    """Three streams of uint8 frames: the plumbing frame, shifted by one
    pixel, and darkened."""
    f = np.clip(pc.frame(), 0, 255).astype(np.uint8)
    return [f, np.roll(f, 1, axis=1), (f * 0.9).astype(np.uint8)]


@pytest.fixture()
def bus():
    with transport.Broker() as broker, transport.Node(broker.port) as server, \
            transport.Node(broker.port) as robot:
        runner = serve.ServeRunner(convert.mapdb_from_numpy(pc.map_arrays(), "cpu"),
                                   pc.config(1), pc.K, np.zeros(3, np.float32), server, B,
                                   seed=5, device="cpu")
        for i in range(B):
            robot.subscribe(transport.pose_topic(i), depth=4)
        time.sleep(0.05)
        yield runner, robot


def _publish(robot, frames, streams=range(B)):
    for i in streams:
        robot.publish(transport.image_topic(i), transport.encode_image(i, frames[i], 10.0 + i))


def test_poses_over_the_bus_equal_localize_frames(bus):
    """Every stream's message (C, Euler angles, position covariance,
    success, frame id, the frame's timestamp) equals localize_frames on the
    same frames from the same generator state, exactly; the runner's return
    carries the same values."""
    runner, robot = bus
    frames = _frames()
    assert runner.device == torch.device("cpu")
    for rnd in (1, 2):
        state = runner.generator.get_state()
        _publish(robot, frames)
        fresh = runner.poll(timeout=2.0)
        assert fresh.all()
        out = runner.step(fresh)
        g = torch.Generator().manual_seed(0)
        g.set_state(state)
        pwc, _, _ = runner.engine.localize_frames(
            torch.from_numpy(np.stack(frames)).float(), generator=g)
        rpy = so3.rot_to_euler(pwc.pose.R)
        assert sorted(out) == list(range(B))
        for i in range(B):
            msg = transport.decode_pose(robot.receive(transport.pose_topic(i), timeout=2.0))
            assert msg["drone"] == i and msg["frame"] == rnd and msg["timestamp"] == 10.0 + i
            np.testing.assert_array_equal(msg["C"], pwc.pose.C[i].double().numpy())
            np.testing.assert_array_equal(msg["rpy"], rpy[i].double().numpy())
            np.testing.assert_array_equal(msg["cov3"], pwc.cov[i, 3:6, 3:6].double().numpy())
            assert msg["success"] == bool(pwc.success[i]) == out[i]["success"]
            np.testing.assert_array_equal(out[i]["C"], pwc.pose.C[i].numpy())
            np.testing.assert_array_equal(out[i]["rpy"], rpy[i].numpy())
    assert bool(pwc.success[0])


def test_one_host_copy_per_dispatch(bus, monkeypatch):
    """A dispatch's results reach the host in one copy, with the Euler
    angles of all B streams computed in one call on the device."""
    runner, robot = bus
    copies, eulers = [], []
    real_host, real_euler = serve._host, so3.rot_to_euler
    monkeypatch.setattr(serve, "_host", lambda t: copies.append(t.shape) or real_host(t))
    monkeypatch.setattr(so3, "rot_to_euler",
                        lambda R: eulers.append(tuple(R.shape)) or real_euler(R))
    _publish(robot, _frames())
    runner.step(runner.poll(timeout=2.0))
    assert copies == [(B, 16)] and eulers == [(B, 3, 3)]


def test_stale_streams_not_republished_and_idle_run(bus):
    """A dispatch where only stream 1 delivered publishes only stream 1's
    pose (the others keep their last frame in the batch); with nothing
    fresh, step does nothing and run returns 0 dispatches promptly."""
    runner, robot = bus
    frames = _frames()
    _publish(robot, frames)
    runner.step(runner.poll(timeout=2.0))
    for i in range(B):
        robot.receive(transport.pose_topic(i), timeout=2.0)
    _publish(robot, frames, streams=[1])
    fresh = runner.poll(timeout=0.5)
    assert fresh.tolist() == [False, True, False] and runner.have.all()
    out = runner.step(fresh)
    assert list(out) == [1]
    assert transport.decode_pose(robot.receive(transport.pose_topic(1), timeout=2.0))["frame"] == 2
    assert robot.receive(transport.pose_topic(0), timeout=0.1) is None
    assert runner.step(np.zeros(B, bool)) == {}
    t0 = time.monotonic()
    assert runner.run(max_steps=1, poll_timeout=0.01, idle_timeout=0.05) == 0
    assert time.monotonic() - t0 < 5.0


class _MemoryNode:
    """subscribe / receive / publish of transport.Node, in memory: offer()
    queues a payload on a subscribed topic (depth-bounded, drop-oldest),
    publish() records (topic, payload)."""

    def __init__(self):
        self.queues, self.sent = {}, []

    def subscribe(self, topic, depth=4):
        self.queues[topic] = collections.deque(maxlen=depth)

    def offer(self, topic, payload):
        self.queues[topic].append(payload)

    def receive(self, topic, timeout=0.0):
        q = self.queues.get(topic)
        return q.popleft() if q else None

    def publish(self, topic, payload):
        self.sent.append((topic, bytes(payload)))


def test_published_poses_equal_coloc_tpu_runner(monkeypatch):
    """coloc_tpu's ServeRunner and the port's on the same frames over three
    rounds (every stream, then stream 1 alone with new frames, then
    nothing): the same topics in the same order, and each pose message's
    bytes equal but for the Euler angles, which each package's
    rot_to_euler computes in float32 from the same R: within 1e-6 rad.
    coloc_tpu's engine is handed the port engine's outputs for the frames
    it is given, which must equal the port's."""
    import jax.numpy as jnp

    from coloc_tpu import config as jcfg
    from coloc_tpu import serve as jserve
    from coloc_tpu import types as jtypes

    ma = pc.map_arrays()
    tnode, jnode = _MemoryNode(), _MemoryNode()
    port = serve.ServeRunner(convert.mapdb_from_numpy(ma, "cpu"), pc.config(1), pc.K,
                             np.zeros(3, np.float32), tnode, B, seed=5, device="cpu")
    jc = jcfg.ColocConfig(num_drones=1, detector=jcfg.DetectorOptions(**pc.DET),
                          max_landmarks=pc.LANDMARKS)
    ref = jserve.ServeRunner(jtypes.MapDB(X=jnp.asarray(ma.X), desc=jnp.asarray(ma.desc),
                                          valid=jnp.asarray(ma.valid)),
                             jc, pc.K, np.zeros(3, np.float32), jnode, B, seed=5)
    calls = []
    real = port.engine.localize_frames

    def port_localize(images, generator=None):
        out = real(images, generator=generator)
        calls.append((images.numpy().copy(), out[0]))
        return out

    def ref_localize(images, key):
        seen, pwc = calls[-1]
        np.testing.assert_array_equal(np.asarray(images), seen)
        return SimpleNamespace(pose=SimpleNamespace(R=jnp.asarray(pwc.pose.R.numpy()),
                                                    C=jnp.asarray(pwc.pose.C.numpy())),
                               cov=jnp.asarray(pwc.cov.numpy()),
                               success=jnp.asarray(pwc.success.numpy())), None, None

    monkeypatch.setattr(port.engine, "localize_frames", port_localize)
    monkeypatch.setattr(ref.engine, "localize_frames", ref_localize)
    frames = _frames()
    rounds = [{i: (frames[i], 10.0 + i) for i in range(B)},
              {1: (frames[2], 20.5)},
              {}]
    for rnd in rounds:
        for node in (tnode, jnode):
            for i, (img, ts) in rnd.items():
                node.offer(transport.image_topic(i), transport.encode_image(i, img, ts))
        n_t, n_j = len(tnode.sent), len(jnode.sent)
        fresh_t, fresh_j = port.poll(timeout=0.0), ref.poll(timeout=0.0)
        assert fresh_t.tolist() == fresh_j.tolist() == [i in rnd for i in range(B)]
        out_t, out_j = port.step(fresh_t), ref.step(fresh_j)
        assert sorted(out_t) == sorted(out_j) == sorted(rnd)
        sent_t, sent_j = tnode.sent[n_t:], jnode.sent[n_j:]
        assert [t for t, _ in sent_t] == [t for t, _ in sent_j] == \
            [transport.pose_topic(i) for i in sorted(rnd)]
        for (_, bt), (_, bj) in zip(sent_t, sent_j):
            mt, mj = transport.decode_pose(bt), transport.decode_pose(bj)
            np.testing.assert_allclose(mt["rpy"], mj["rpy"], rtol=0, atol=1e-6)
            mt["rpy"] = mj["rpy"]
            assert transport.encode_pose(**mt) == bj
    assert len(calls) == 2 and transport.decode_pose(jnode.sent[0][1])["success"]


def _write_inputs(tmp_path):
    map_path, calib = tmp_path / "map.npz", tmp_path / "calib.txt"
    checkpoint.save_mapdb(str(map_path), convert.mapdb_from_numpy(pc.map_arrays(), "cpu"))
    disk.write_calib(str(calib), (pc.W, pc.H), pc.K[None], np.zeros((1, 3), np.float32))
    det = ["--maxkp", str(pc.DET["max_keypoints"]), "--levels", str(pc.DET["num_levels"]),
           "--fast-threshold", str(pc.DET["fast_threshold"])]
    return ["--map", str(map_path), "--calib", str(calib), *det]


def test_main_serves_on_the_cpu_when_asked(tmp_path, capsys):
    """`main` with --cpu joins a broker (HOST:PORT), serves --steps
    dispatches to a robot node and returns 0; without --cpu and without a
    CUDA device it raises before touching the bus."""
    args = _write_inputs(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main([*args, "--streams", "2", "--publish", "1", "--steps", "1"])
    frame = _frames()[0]
    with transport.Broker() as broker, transport.Node(broker.port) as robot:
        robot.subscribe(transport.pose_topic(0), depth=4)
        result = {}
        t = threading.Thread(target=lambda: result.setdefault("rc", serve.main(
            [*args, "--streams", "2", "--publish", f"127.0.0.1:{broker.port}", "--steps", "1",
             "--cpu"])))
        t.start()
        got, deadline = None, time.monotonic() + 60.0
        while got is None and t.is_alive() and time.monotonic() < deadline:
            robot.publish(transport.image_topic(0), transport.encode_image(0, frame, 1.0))
            got = robot.receive(transport.pose_topic(0), timeout=0.5)
        t.join(timeout=60.0)
    assert result.get("rc") == 0 and got is not None
    assert transport.decode_pose(got)["success"]
    out = capsys.readouterr().out
    assert "serving 2 streams on cpu" in out and "served 1 dispatches" in out
