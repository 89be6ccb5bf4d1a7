"""The port's topic bus (coloc_tpu_torch.io.transport and io/_native)
against coloc_tpu's on the CPU.

The codecs are held byte for byte against coloc_tpu's pure-Python codecs
(importing coloc_tpu.io.transport loads no library; this file never loads
coloc_tpu's native libraries, whose in-place `make` other test workers may
be running). The native sources are held equal to coloc_tpu/native's, and
the bus itself is driven on the port's own build in coloc_tpu_torch/_build:
tests/test_transport.py's cases, and a second OS process on the port.
"""

import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from coloc_tpu.io import transport as jtransport

from coloc_tpu_torch import convert
from coloc_tpu_torch.io import _native, stream, synthetic, transport
from port_harness import one_torch_thread, time_limit  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def broker():
    with transport.Broker() as b:
        yield b


def _features(rng, n=64, high_bit=True):
    fa = synthetic.random_features(96, 128, n, rng)
    if high_bit:
        desc = fa.desc.copy()
        desc[:, 0] |= np.uint32(0x80000000)
        fa = fa._replace(desc=desc, scale=rng.integers(0, 8, n).astype(np.int32),
                         valid=rng.random(n) > 0.3)
    return fa


# ------------------------------------------------------------ the codecs

def test_pose_codec_bytes_equal_reference():
    """encode_pose: the same bytes as coloc_tpu's for every option; decode
    returns exactly what was sent."""
    rng = np.random.default_rng(0)
    C, rpy, cov = rng.normal(size=3), rng.normal(size=3), rng.normal(size=(3, 3))
    for kw in (dict(rpy=rpy, cov3=cov, success=False), dict(), dict(cov3=cov)):
        a = transport.encode_pose(1, 7, 12.5, C, **kw)
        assert a == jtransport.encode_pose(1, 7, 12.5, C, **kw)
    msg = transport.decode_pose(transport.encode_pose(1, 7, 12.5, C, rpy=rpy, cov3=cov,
                                                      success=False))
    assert msg["drone"] == 1 and msg["frame"] == 7
    assert msg["timestamp"] == 12.5 and msg["success"] is False
    np.testing.assert_array_equal(msg["C"], C)
    np.testing.assert_array_equal(msg["rpy"], rpy)
    np.testing.assert_array_equal(msg["cov3"], cov)
    # float32 tensors from the port go out as the float64 of their values
    Ct = torch.tensor([0.1, -2.0, 3.25])
    assert (transport.encode_pose(0, 1, 0.0, Ct.numpy())
            == jtransport.encode_pose(0, 1, 0.0, Ct.numpy().astype(np.float64)))


def test_image_and_map_codec_bytes_equal_reference():
    img = (np.arange(20 * 30) % 251).astype(np.uint8).reshape(20, 30)
    fimg = img.astype(np.float32) + 0.4
    for x in (img, fimg, fimg * 2.0 - 100.0):
        assert transport.encode_image(3, x, 9.0) == jtransport.encode_image(3, x, 9.0)
    d, out, ts = transport.decode_image(transport.encode_image(3, img, 9.0))
    assert d == 3 and ts == 9.0
    np.testing.assert_array_equal(out, img)
    # float input clips to u8 (mono8 conversion parity)
    np.testing.assert_array_equal(transport.decode_image(transport.encode_image(0, fimg, 0.0))[1],
                                  img)
    X = np.random.default_rng(0).normal(size=(17, 3)).astype(np.float32)
    assert transport.encode_map_points(X) == jtransport.encode_map_points(X)
    np.testing.assert_array_equal(transport.decode_map_points(transport.encode_map_points(X)), X)


def test_bundle_bytes_equal_reference_from_port_features():
    """A bundle of the port's Features (int32 descriptors with the high bit
    set, C5) is the same bytes as coloc_tpu's bundle of the same features
    with uint32 descriptors, through encode_feature_bundle on host arrays
    and through bundle_from_features on tensors with one host copy; decode
    gives the reference layout back exactly, and features_from_bundle the
    port's Features."""
    rng = np.random.default_rng(1)
    fa = _features(rng)
    K = np.array([[300.0, 0, 160], [0, 301.0, 120], [0, 0, 1]], np.float32)
    dist = np.array([0.1, -0.05, 0.0], np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    C = rng.normal(size=3).astype(np.float32)
    cov3 = np.diag(rng.uniform(0.01, 1, 3)).astype(np.float32)
    ref = jtransport.encode_feature_bundle(2, 9, 123.25, fa.xy, fa.score, fa.scale, fa.angle,
                                           fa.desc, fa.valid, K, dist, R, C, cov3)
    feats = convert.features_from_numpy(fa, "cpu")
    assert feats.desc.dtype == torch.int32 and bool((feats.desc < 0).any())
    host = convert.to_numpy(feats)._replace(desc=feats.desc.numpy())
    assert transport.encode_feature_bundle(2, 9, 123.25, host.xy, host.score, host.scale,
                                           host.angle, host.desc, host.valid, K, dist, R, C,
                                           cov3) == ref
    assert transport.bundle_from_features(2, 9, 123.25, feats, K, dist, torch.from_numpy(R),
                                          torch.from_numpy(C), torch.from_numpy(cov3)) == ref
    b, jb = transport.decode_feature_bundle(ref), jtransport.decode_feature_bundle(ref)
    assert b.keys() == jb.keys()
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
        assert np.asarray(b[k]).dtype == np.asarray(jb[k]).dtype
    back = transport.features_from_bundle(b, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(back, feats))
    # ~85 B a keypoint plus the fixed block: 87328 bytes at 1024 keypoints
    assert len(ref) == 20 + 4 + 33 * 8 + 64 * 85


def test_bundle_from_features_one_host_copy(monkeypatch):
    """bundle_from_features copies the features and the pose to the host
    once."""
    rng = np.random.default_rng(2)
    feats = convert.features_from_numpy(_features(rng, 32), "cpu")
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    transport.bundle_from_features(0, 0, 0.0, feats, np.eye(3), np.zeros(3), torch.eye(3),
                                   torch.zeros(3), torch.eye(3))
    assert len(calls) == 1


# ----------------------------------------------------- sources and builds

@pytest.mark.parametrize("name", ["transport.cpp", "loader.cpp"])
def test_native_sources_equal_reference(name):
    """One wire protocol and one image decoder: the port's copies are
    coloc_tpu/native's byte for byte."""
    ours = (REPO / "coloc_tpu_torch" / "native" / name).read_bytes()
    assert ours == (REPO / "coloc_tpu" / "native" / name).read_bytes()


def _tree_state(d: Path):
    return sorted((p.name, p.stat().st_mtime_ns, p.stat().st_size) for p in d.iterdir())


_BUILD_CHILD = r"""
import sys
from pathlib import Path
from coloc_tpu_torch.io import _native
print(_native.build(sys.argv[1], Path(sys.argv[2])))
"""


def test_build_writes_only_its_build_dir(tmp_path):
    """Both libraries built by two processes at once into an empty build
    directory: each process gets the same hash-named file, complete and
    loadable, no temporary file is left, and coloc_tpu/native is not
    touched. The default build directory is coloc_tpu_torch/_build."""
    native = REPO / "coloc_tpu" / "native"
    before = _tree_state(native)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = {}
    for name in ("transport", "loader"):
        procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, name, str(tmp_path)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for _ in range(2)]
        paths = set()
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            paths.add(out.strip())
        assert len(paths) == 1
        path = Path(paths.pop())
        assert path.parent == tmp_path and path.name.startswith(f"libcoloc_{name}-")
        assert path == _native.library_path(name, _native.compiler(), tmp_path)
        outs[name] = path
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(p.name for p in outs.values())
    import ctypes

    assert ctypes.CDLL(str(outs["transport"])).coloc_broker_start is not None
    assert _native.BUILD_DIR == REPO / "coloc_tpu_torch" / "_build"
    assert _native.library_path("transport", "g++").parent == _native.BUILD_DIR
    assert _tree_state(native) == before


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A failed build raises with g++'s output where the library was asked
    for; available() answers False."""
    monkeypatch.setattr(_native, "NATIVE", tmp_path)
    (tmp_path / "transport.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.build("transport", tmp_path / "out")
    assert not (tmp_path / "out").exists() or not any((tmp_path / "out").iterdir())


# --------------------------------------------------------------- the bus

def test_pub_sub_roundtrip_and_ordering(broker):
    with transport.Node(broker.port) as sub, transport.Node(broker.port) as pub:
        sub.subscribe("t/x", depth=16)
        time.sleep(0.05)  # let the SUBSCRIBE land before publishing
        for i in range(5):
            pub.publish("t/x", f"msg{i}".encode())
        assert [sub.receive("t/x", timeout=2.0) for _ in range(5)] == \
            [f"msg{i}".encode() for i in range(5)]
        assert sub.receive("t/x", timeout=0.05) is None


def test_topic_isolation_and_fanout(broker):
    with transport.Node(broker.port) as a, transport.Node(broker.port) as b, \
            transport.Node(broker.port) as pub:
        a.subscribe("t/a")
        b.subscribe("t/a")
        b.subscribe("t/b")
        time.sleep(0.05)
        pub.publish("t/a", b"on-a")
        pub.publish("t/b", b"on-b")
        assert a.receive("t/a", timeout=2.0) == b"on-a"
        assert b.receive("t/a", timeout=2.0) == b"on-a"
        assert b.receive("t/b", timeout=2.0) == b"on-b"
        with pytest.raises(KeyError):
            a.receive("t/b", timeout=0.05)


def test_drop_oldest_when_queue_full(broker):
    with transport.Node(broker.port) as sub, transport.Node(broker.port) as pub:
        sub.subscribe("t/q", depth=2)
        time.sleep(0.05)
        for i in range(6):
            pub.publish("t/q", bytes([i]))
        time.sleep(0.2)  # let the reader thread drain the socket
        assert sub.receive("t/q", timeout=1.0) == bytes([4])
        assert sub.receive("t/q", timeout=1.0) == bytes([5])


def test_oversized_payload_raises_and_feed_survives(broker):
    with transport.Node(broker.port) as sub, transport.Node(broker.port) as pub:
        sub.subscribe("t/big", depth=4)
        time.sleep(0.05)
        pub.publish("t/big", b"x" * 4096)
        pub.publish("t/big", b"ok")
        with pytest.raises(transport.PayloadTooLarge):
            sub.receive("t/big", timeout=2.0, max_bytes=64)
        assert sub.receive("t/big", timeout=2.0) == b"ok"


def test_receive_survives_concurrent_unsubscribe(broker):
    """A blocked receive() whose topic is unsubscribed from another thread
    surfaces KeyError."""
    with transport.Node(broker.port) as node:
        node.subscribe("t/gone", depth=4)
        time.sleep(0.05)
        result = {}

        def rx():
            try:
                result["value"] = node.receive("t/gone", timeout=5.0)
            except Exception as e:  # noqa: BLE001 - recorded for the assert
                result["error"] = e

        t = threading.Thread(target=rx)
        t.start()
        time.sleep(0.2)
        node.unsubscribe("t/gone")
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert isinstance(result.get("error"), KeyError)


def test_transport_publisher_rosutils_parity(broker):
    """TransportPublisher speaks the session's viz surface and lands
    decodable pose and map messages on the ROSUtils topic names, the same
    bytes coloc_tpu's publisher sends."""
    with transport.Node(broker.port) as rx, transport.Node(broker.port) as tx:
        rx.subscribe(transport.pose_topic(0), depth=1)
        rx.subscribe(transport.MAP_TOPIC, depth=1)
        time.sleep(0.05)
        sink = transport.TransportPublisher(tx)
        C, cov = np.array([0.5, 1.0, -2.0]), np.eye(3) * 0.01
        sink.publish_pose(0, C, cov3=cov, success=True, frame=4)
        X = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
        sink.publish_map(X, valid=np.ones(50, bool))
        raw = rx.receive(transport.pose_topic(0), timeout=2.0)
        assert raw == jtransport.encode_pose(0, 4, 0.0, C, cov3=cov, success=True)
        msg = transport.decode_pose(raw)
        assert msg["frame"] == 4 and msg["success"]
        np.testing.assert_array_equal(
            transport.decode_map_points(rx.receive(transport.MAP_TOPIC, timeout=2.0)), X)
        # depth=1 pose topic keeps only the latest (ROS advertise(topic, 1))
        sink.publish_pose(0, C + 1.0, frame=5)
        sink.publish_pose(0, C + 2.0, frame=6)
        time.sleep(0.2)
        last = transport.decode_pose(rx.receive(transport.pose_topic(0), timeout=2.0))
        assert last["frame"] == 6
        np.testing.assert_array_equal(last["C"], C + 2.0)
    assert (jtransport.pose_topic(3), jtransport.features_topic(3), jtransport.image_topic(3),
            jtransport.MAP_TOPIC) == (transport.pose_topic(3), transport.features_topic(3),
                                      transport.image_topic(3), transport.MAP_TOPIC)


def test_image_bridge_feeds_time_sync(broker):
    """Networked frames flow through ImageStreamBridge -> FrameStream ->
    ApproximateTimeSync like the InterfaceROS pair path."""
    fs = stream.FrameStream(num_drones=2)
    with transport.Node(broker.port) as rx, transport.Node(broker.port) as tx:
        bridge = transport.ImageStreamBridge(rx, fs, drones=[0, 1])
        time.sleep(0.05)
        img0, img1 = np.full((8, 8), 10, np.uint8), np.full((8, 8), 20, np.uint8)
        tx.publish(transport.image_topic(0), transport.encode_image(0, img0, 1.00))
        tx.publish(transport.image_topic(1), transport.encode_image(1, img1, 1.02))
        pair = stream.ApproximateTimeSync(fs, 0, 1, slop=0.05).next_pair(timeout=3.0)
        bridge.close()
    assert pair is not None
    (ta, a), (tb, b) = pair
    assert abs(ta - tb) <= 0.05
    np.testing.assert_array_equal(a, img0)
    np.testing.assert_array_equal(b, img1)


def test_image_bridge_drops_oversized_frame_and_continues(broker):
    fs = stream.FrameStream(num_drones=1)
    with transport.Node(broker.port) as rx, transport.Node(broker.port) as tx:
        bridge = transport.ImageStreamBridge(rx, fs, drones=[0], max_bytes=1024)
        time.sleep(0.05)
        big, small = np.zeros((64, 64), np.uint8), np.full((8, 8), 5, np.uint8)
        with pytest.warns(RuntimeWarning, match="oversized"):
            tx.publish(transport.image_topic(0), transport.encode_image(0, big, 1.0))
            tx.publish(transport.image_topic(0), transport.encode_image(0, small, 2.0))
            got = fs.pop(0, timeout=5.0)
        bridge.close()
    assert got is not None and got[0] == 2.0
    np.testing.assert_array_equal(got[1], small)


def test_publisher_degrades_when_bus_dies():
    b = transport.Broker()
    node = transport.Node(b.port)
    sink = transport.TransportPublisher(node)
    sink.publish_pose(0, np.zeros(3))
    b.close()  # kill the bus under the publisher
    time.sleep(0.1)
    with pytest.warns(RuntimeWarning, match="bus connection lost"):
        for _ in range(20):  # socket buffering may absorb the first sends
            sink.publish_pose(0, np.ones(3))
            if sink._dead:
                break
            time.sleep(0.05)
    assert sink._dead
    sink.publish_pose(0, np.ones(3))  # no raise once degraded
    node.close()


def test_node_reconnects_after_broker_restart():
    """reconnect=True nodes survive a broker bounce on the same port:
    redial, resubscribe, and deliver traffic again."""
    b = transport.Broker()
    port = b.port
    sub = transport.Node(port, reconnect=True, reconnect_timeout=15.0)
    pub = transport.Node(port, reconnect=True, reconnect_timeout=15.0)
    sub.subscribe("t/r", depth=4)
    time.sleep(0.05)
    pub.publish("t/r", b"before")
    assert sub.receive("t/r", timeout=5.0) == b"before"
    b.close()
    time.sleep(0.2)
    b2 = transport.Broker(port)
    try:
        got, deadline = None, time.monotonic() + 30.0
        with pytest.warns(RuntimeWarning, match="reconnected to broker"):
            while got is None and time.monotonic() < deadline:
                try:
                    pub.publish("t/r", b"after")
                except OSError:
                    pass
                got = sub.receive("t/r", timeout=1.0)
        assert got == b"after"
    finally:
        sub.close()
        pub.close()
        b2.close()


def test_node_without_reconnect_raises_and_broker_stop_is_clean():
    """A dead broker surfaces TransportClosed on default nodes, and stopping
    a broker with live clients unblocks every receiver."""
    b = transport.Broker()
    nodes = [transport.Node(b.port) for _ in range(3)]
    for i, n in enumerate(nodes):
        n.subscribe(f"t/{i}", depth=2)
    time.sleep(0.05)
    b.close()
    for i, n in enumerate(nodes):
        with pytest.raises(transport.TransportClosed):
            for _ in range(50):  # first receives may drain the closing window
                n.receive(f"t/{i}", timeout=0.1)
        n.close()


_CHILD = r"""
import sys
from coloc_tpu_torch.io import transport

port = int(sys.argv[1])
with transport.Node(port) as node:
    node.subscribe("two/ack", depth=4)
    node.publish("two/hello", b"ready")
    payload = node.receive("two/ack", timeout=30.0)
    assert payload is not None
    img = transport.decode_image(payload)[1]
    node.publish("two/hello", transport.encode_image(9, img[::-1], 2.0))
"""


def test_two_process_roundtrip(broker):
    """A second OS process on the port's bus receives an image and
    publishes a transformed reply."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with transport.Node(broker.port) as node:
        node.subscribe("two/hello", depth=4)
        child = subprocess.Popen([sys.executable, "-c", _CHILD, str(broker.port)], env=env)
        try:
            assert node.receive("two/hello", timeout=60.0) == b"ready"
            img = (np.arange(16 * 16) % 256).astype(np.uint8).reshape(16, 16)
            node.publish("two/ack", transport.encode_image(0, img, 1.0))
            reply = node.receive("two/hello", timeout=60.0)
            assert reply is not None
            d, out, ts = transport.decode_image(reply)
            assert d == 9 and ts == 2.0
            np.testing.assert_array_equal(out, img[::-1])
        finally:
            child.wait(timeout=60)
    assert child.returncode == 0


def test_library_named_by_source_hash():
    """The build's file name follows its source, flags and compiler."""
    src = (_native.NATIVE / "transport.cpp").read_bytes()
    h = hashlib.sha256(src)
    h.update(" ".join((*_native.CXXFLAGS, "-lpthread", "g++")).encode())
    assert _native.library_path("transport", "g++").name == \
        f"libcoloc_transport-{h.hexdigest()[:16]}.so"
