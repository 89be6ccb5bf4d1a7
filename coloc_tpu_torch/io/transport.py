"""Native TCP topic transport (counterpart of coloc_tpu.io.transport): the
ROS pub/sub runtime analog.

Reference parity: inter-robot communication in the reference is ROS topics:
`ROSUtils` publishes per-drone `coloc/drone{i}/pose` PoseStamped messages
and a `coloc/map` point cloud (rosUtils.hpp:21-94), and `InterfaceROS`
ingests camera frames from image topics with message_filters approximate-
time sync (InterfaceROS.hpp:7-44). The native equivalent is
`coloc_tpu_torch/native/transport.cpp`, a copy of coloc_tpu's: a broker-
routed TCP topic bus with named topics, bounded drop-oldest subscriber
queues and many-to-many fan-out, built by io/_native with g++ into
`coloc_tpu_torch/_build/` and bound here with ctypes.

This module provides:
  - `Broker` / `Node`: the bus primitives (start a broker, connect nodes,
    publish/subscribe raw payloads on named topics). Both raise with g++'s
    output where the library cannot be built.
  - pose / image / point-cloud / feature-bundle codecs: fixed little-endian
    layouts, byte for byte coloc_tpu's, so the two packages share one bus.
    Descriptors travel as uint32 words; the port's int32 descriptors (C5)
    are viewed, never converted.
  - `bundle_from_features` / `features_from_bundle`: a frame's Features and
    pose to a bundle with one host copy, and a decoded bundle back to
    Features on a device.
  - `TransportPublisher`: ROSUtils-parity session sink, a drop-in for the
    session's `viz=` slot (the `publish_pose` / `publish_map` surface of
    io/liveviz.LiveViz), publishing to `coloc/drone{i}/pose` + `coloc/map`.
  - `ImageStreamBridge`: subscribes `coloc/drone{i}/image` topics and feeds
    a `FrameStream`, so `StreamInterface` + `ApproximateTimeSync`
    (io/stream.py) run unchanged over the network: the InterfaceROS path.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from coloc_tpu_torch.io import _native, decimate_map_points
from coloc_tpu_torch.types import Features


class TransportClosed(OSError):
    """The node's connection to the broker is gone."""


class PayloadTooLarge(OSError):
    """A received payload exceeded max_bytes (the message is consumed and
    truncated by the C side; the full length is reported)."""


_bound = False


def _load_library() -> ctypes.CDLL:
    """The transport library with its C signatures; raises where it cannot
    be built."""
    global _bound
    lib = _native.load("transport")
    if not _bound:
        lib.coloc_broker_start.restype = ctypes.c_void_p
        lib.coloc_broker_start.argtypes = [ctypes.c_int]
        lib.coloc_broker_port.restype = ctypes.c_int
        lib.coloc_broker_port.argtypes = [ctypes.c_void_p]
        lib.coloc_broker_stop.argtypes = [ctypes.c_void_p]
        lib.coloc_node_connect.restype = ctypes.c_void_p
        lib.coloc_node_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.coloc_node_publish.restype = ctypes.c_int
        lib.coloc_node_publish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.coloc_node_subscribe.restype = ctypes.c_int
        lib.coloc_node_subscribe.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.coloc_node_unsubscribe.restype = ctypes.c_int
        lib.coloc_node_unsubscribe.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.coloc_node_receive.restype = ctypes.c_int
        lib.coloc_node_receive.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_double,
        ]
        lib.coloc_node_close.argtypes = [ctypes.c_void_p]
        _bound = True
    return lib


def available() -> bool:
    """Whether the transport library could be built (coloc_tpu's meaning)."""
    return _native.available("transport")


class Broker:
    """Topic router (the rosmaster analog; data flows through it)."""

    def __init__(self, port: int = 0):
        self._lib = _load_library()
        self._handle = self._lib.coloc_broker_start(port)
        if not self._handle:
            raise OSError(f"failed to start broker on port {port}")

    @property
    def port(self) -> int:
        return self._lib.coloc_broker_port(self._handle)

    def close(self):
        if self._handle:
            self._lib.coloc_broker_stop(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Node:
    """One bus endpoint: publish/subscribe raw payloads on named topics.

    `reconnect=True` makes the node survive a broker restart: on a dead
    connection, publish/receive redial `host:port` (retrying up to
    `reconnect_timeout` seconds) and replay every live subscription before
    retrying the operation once. Messages published while the broker was
    down are gone (topic-bus semantics, as in ROS); the peer layer's
    re-offer loop (distributed.run_peer) restores eventual consistency on
    top.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 reconnect: bool = False, reconnect_timeout: float = 10.0,
                 reconnect_interval: float = 0.25):
        self._lib = _load_library()
        self._host = host
        self._port = port
        self._reconnect = reconnect
        self._reconnect_timeout = reconnect_timeout
        self._reconnect_interval = reconnect_interval
        self._handle = self._lib.coloc_node_connect(host.encode(), port)
        if not self._handle:
            raise OSError(f"failed to connect to broker at {host}:{port}")
        # receive() buffers are per thread (ImageStreamBridge runs one pump
        # thread per drone on a shared node) and reused across calls: a
        # fresh buffer per call would zero-fill max_bytes on every poll
        self._tls = threading.local()
        # topic -> depth, replayed on reconnect; mutations hold _conn_lock
        self._subs: dict = {}
        self._conn_lock = threading.Lock()
        self._gen = 0                  # bumped on every successful redial
        # old handles are never freed: a thread may be blocked inside
        # coloc_node_receive on one at any later point, and coloc_node_close
        # frees the struct under it. A dead handle holds one closed fd and a
        # small struct; reconnects are rare, so the leak is bounded.
        self._dead_handles: list = []

    def _recv_buf(self, max_bytes: int):
        buf = getattr(self._tls, "buf", None)
        if buf is None or len(buf) < max_bytes:
            buf = ctypes.create_string_buffer(max_bytes)
            self._tls.buf = buf
        return buf

    def _try_reconnect(self, gen_seen: int) -> bool:
        """Redial the broker and replay subscriptions. True when the node has
        a live connection newer than `gen_seen` (whether this thread
        redialed or another beat it to the lock)."""
        if not self._reconnect:
            return False
        with self._conn_lock:
            if self._handle is None:
                return False                      # close()d deliberately
            if self._gen != gen_seen:
                return True                       # another thread redialed
            deadline = time.monotonic() + self._reconnect_timeout
            while time.monotonic() < deadline:
                h = self._lib.coloc_node_connect(self._host.encode(), self._port)
                if h:
                    self._dead_handles.append(self._handle)
                    self._handle = h
                    for topic, depth in list(self._subs.items()):
                        self._lib.coloc_node_subscribe(self._handle, topic.encode(), depth)
                    self._gen += 1
                    warnings.warn(
                        f"transport node: reconnected to broker at "
                        f"{self._host}:{self._port} and resubscribed "
                        f"{len(self._subs)} topics", RuntimeWarning)
                    return True
                time.sleep(self._reconnect_interval)
            return False

    def publish(self, topic: str, payload: bytes) -> None:
        gen = self._gen
        rc = self._lib.coloc_node_publish(self._handle, topic.encode(), payload, len(payload))
        if rc != 0 and self._try_reconnect(gen):
            rc = self._lib.coloc_node_publish(self._handle, topic.encode(), payload,
                                              len(payload))
        if rc != 0:
            raise OSError(f"publish to {topic!r} failed")

    def subscribe(self, topic: str, depth: int = 16) -> None:
        rc = self._lib.coloc_node_subscribe(self._handle, topic.encode(), depth)
        if rc != 0:
            raise OSError(f"subscribe to {topic!r} failed")
        with self._conn_lock:
            self._subs[topic] = depth

    def unsubscribe(self, topic: str) -> None:
        self._lib.coloc_node_unsubscribe(self._handle, topic.encode())
        with self._conn_lock:
            self._subs.pop(topic, None)

    def receive(self, topic: str, timeout: float = 1.0,
                max_bytes: int = 16 << 20) -> Optional[bytes]:
        """Next payload on `topic`, or None on timeout.

        Raises KeyError on unsubscribed topics, TransportClosed on closed
        nodes (the C ABI's -2 / -3), PayloadTooLarge past max_bytes. With
        reconnect=True a dead connection is redialed instead of raising;
        the receive is then retried once on the fresh connection."""
        buf = self._recv_buf(max_bytes)
        gen = self._gen
        n = self._lib.coloc_node_receive(self._handle, topic.encode(), buf, max_bytes, timeout)
        if n == -3 and self._try_reconnect(gen):
            n = self._lib.coloc_node_receive(self._handle, topic.encode(), buf, max_bytes,
                                             timeout)
        if n == -1:
            return None
        if n == -2:
            raise KeyError(f"not subscribed to {topic!r}")
        if n == -3:
            raise TransportClosed("transport connection closed")
        if n > max_bytes:
            raise PayloadTooLarge(f"payload ({n} B) exceeds max_bytes ({max_bytes})")
        # the payload's n bytes only: buf.raw would copy all max_bytes first
        return ctypes.string_at(buf, n)

    def close(self):
        with self._conn_lock:
            if self._handle:
                self._lib.coloc_node_close(self._handle)
                self._handle = None
            # dead (pre-reconnect) handles stay allocated on purpose (see
            # __init__): freeing them could race a blocked receive
            self._dead_handles = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Message codecs (fixed little-endian layouts, coloc_tpu's byte for byte)
# ---------------------------------------------------------------------------

_POSE_HDR = struct.Struct("<iid")  # drone, frame, timestamp


def encode_pose(drone: int, frame: int, timestamp: float, C,
                rpy=None, cov3=None, success: bool = True) -> bytes:
    """PoseStamped analog: position + roll/pitch/yaw + 3x3 position cov,
    float64 (ROSUtils::loadPoseIntoMsg, rosUtils.hpp:70-84, plus the
    covariance the reference logs, logUtils.hpp:90-96)."""
    C = np.asarray(C, np.float64).reshape(3)
    rpy = np.zeros(3) if rpy is None else np.asarray(rpy, np.float64).reshape(3)
    cov3 = np.zeros((3, 3)) if cov3 is None else np.asarray(cov3, np.float64).reshape(3, 3)
    return (_POSE_HDR.pack(drone, frame, timestamp)
            + struct.pack("<b", 1 if success else 0)
            + C.tobytes() + rpy.tobytes() + cov3.tobytes())


def decode_pose(payload: bytes) -> dict:
    drone, frame, ts = _POSE_HDR.unpack_from(payload, 0)
    off = _POSE_HDR.size
    success = struct.unpack_from("<b", payload, off)[0] == 1
    off += 1
    vals = np.frombuffer(payload, np.float64, count=3 + 3 + 9, offset=off)
    return {
        "drone": drone, "frame": frame, "timestamp": ts, "success": success,
        "C": vals[:3].copy(), "rpy": vals[3:6].copy(),
        "cov3": vals[6:].reshape(3, 3).copy(),
    }


_IMAGE_HDR = struct.Struct("<iiid")  # drone, height, width, timestamp


def encode_image(drone: int, image: np.ndarray, timestamp: float) -> bytes:
    """sensor_msgs::Image (mono8) analog; float inputs are clipped to u8
    (the reference converts incoming frames to mono8, InterfaceROS.hpp:18)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    return _IMAGE_HDR.pack(drone, h, w, timestamp) + img.tobytes()


def decode_image(payload: bytes):
    """-> (drone, (H, W) uint8 image, timestamp)."""
    drone, h, w, ts = _IMAGE_HDR.unpack_from(payload, 0)
    img = np.frombuffer(payload, np.uint8, count=h * w,
                        offset=_IMAGE_HDR.size).reshape(h, w).copy()
    return drone, img, ts


def encode_map_points(X) -> bytes:
    """coloc/map point-cloud analog (rosUtils.hpp:43-59)."""
    X = np.ascontiguousarray(np.asarray(X, np.float32).reshape(-1, 3))
    return struct.pack("<i", len(X)) + X.tobytes()


def decode_map_points(payload: bytes) -> np.ndarray:
    n = struct.unpack_from("<i", payload, 0)[0]
    return np.frombuffer(payload, np.float32, count=3 * n, offset=4).reshape(n, 3).copy()


_BUNDLE_HDR = struct.Struct("<iidi")  # drone, frame, timestamp, n_keypoints
# fixed f64 block after the header: K (9) + dist (3) + R (9) + C (3) + cov3 (9)
_BUNDLE_F64 = 9 + 3 + 9 + 3 + 9


def _desc_words(desc, n: int) -> np.ndarray:
    """Descriptor words as uint32, (n, W): the port's int32 words (C5) are
    viewed as the bits they carry, never converted."""
    desc = np.ascontiguousarray(np.asarray(desc)).reshape(n, -1)
    if desc.dtype == np.int32:
        return desc.view(np.uint32)
    return np.ascontiguousarray(desc.astype(np.uint32, copy=False))


def encode_feature_bundle(drone: int, frame: int, timestamp: float,
                          xy, score, scale, angle, desc, valid,
                          K, dist, R, C, cov3) -> bytes:
    """The inter-drone exchange payload: one frame's feature bank
    (keypoints + packed binary descriptors) plus the sender's camera
    intrinsics and current filtered pose + position covariance, ~85 B a
    keypoint (a 1024-keypoint bundle is 87328 bytes). The receiver feeds it
    to parallel.mesh.inter_pose_device as the `src` side. Host arrays;
    bundle_from_features makes one from the port's tensors."""
    xy = np.ascontiguousarray(np.asarray(xy, np.float32).reshape(-1, 2))
    n = len(xy)
    score = np.ascontiguousarray(np.asarray(score, np.float32).reshape(n))
    scale = np.ascontiguousarray(np.asarray(scale, np.int32).reshape(n))
    angle = np.ascontiguousarray(np.asarray(angle, np.float32).reshape(n))
    desc = _desc_words(desc, n)
    valid = np.ascontiguousarray(np.asarray(valid, bool).reshape(n))
    f64 = np.concatenate([
        np.asarray(K, np.float64).reshape(9),
        np.asarray(dist, np.float64).reshape(3),
        np.asarray(R, np.float64).reshape(9),
        np.asarray(C, np.float64).reshape(3),
        np.asarray(cov3, np.float64).reshape(9),
    ])
    return (_BUNDLE_HDR.pack(drone, frame, timestamp, n)
            + struct.pack("<i", desc.shape[1])
            + f64.tobytes() + xy.tobytes() + score.tobytes()
            + scale.tobytes() + angle.tobytes() + desc.tobytes()
            + valid.astype(np.uint8).tobytes())


def decode_feature_bundle(payload: bytes) -> dict:
    """-> dict of host arrays in coloc_tpu's layout (descriptors uint32);
    features_from_bundle makes the port's Features of it."""
    drone, frame, ts, n = _BUNDLE_HDR.unpack_from(payload, 0)
    off = _BUNDLE_HDR.size
    words = struct.unpack_from("<i", payload, off)[0]
    off += 4
    f64 = np.frombuffer(payload, np.float64, count=_BUNDLE_F64, offset=off)
    off += _BUNDLE_F64 * 8
    out = {}
    for name, dtype, count, shape in (("xy", np.float32, 2 * n, (n, 2)),
                                      ("score", np.float32, n, (n,)),
                                      ("scale", np.int32, n, (n,)),
                                      ("angle", np.float32, n, (n,)),
                                      ("desc", np.uint32, words * n, (n, words)),
                                      ("valid", np.uint8, n, (n,))):
        out[name] = np.frombuffer(payload, dtype, count=count, offset=off).reshape(shape).copy()
        off += count * np.dtype(dtype).itemsize
    out["valid"] = out["valid"].astype(bool)
    return {
        "drone": drone, "frame": frame, "timestamp": ts, **out,
        "K": f64[0:9].reshape(3, 3), "dist": f64[9:12].copy(),
        "R": f64[12:21].reshape(3, 3), "C": f64[21:24].copy(),
        "cov3": f64[24:33].reshape(3, 3),
    }


def bundle_from_features(drone: int, frame: int, timestamp: float, feats: Features,
                         K, dist, R: torch.Tensor, C: torch.Tensor,
                         cov3: torch.Tensor) -> bytes:
    """encode_feature_bundle of the port's Features and pose tensors (any
    device) with ONE host copy: every field bit-viewed as int32 into one
    flat tensor, copied, and viewed back on the host."""
    n = feats.xy.shape[0]
    words = feats.desc.shape[1]
    i32 = torch.int32

    def bits(t):
        return t.reshape(-1).to(torch.float32).view(i32)

    flat = torch.cat([
        bits(feats.xy), bits(feats.score), feats.scale.reshape(-1), bits(feats.angle),
        feats.desc.reshape(-1), feats.valid.to(i32), bits(R), bits(C), bits(cov3),
    ]).cpu().numpy()
    parts, off = [], 0
    for count in (2 * n, n, n, n, words * n, n, 9, 3, 9):
        parts.append(flat[off:off + count])
        off += count
    xy, score, scale, angle, desc, valid, R_h, C_h, cov_h = parts
    f32 = np.float32
    return encode_feature_bundle(
        drone, frame, timestamp, xy.view(f32).reshape(n, 2), score.view(f32), scale,
        angle.view(f32), desc.reshape(n, words), valid != 0, K, dist, R_h.view(f32),
        C_h.view(f32), cov_h.view(f32))


def features_from_bundle(bundle: dict, device) -> Features:
    """A decoded bundle's keypoints as the port's Features on `device`, the
    uint32 descriptor words viewed as int32 (C5)."""
    desc = np.ascontiguousarray(bundle["desc"], np.uint32).view(np.int32)
    return Features(
        xy=torch.as_tensor(bundle["xy"], device=device),
        score=torch.as_tensor(bundle["score"], device=device),
        scale=torch.as_tensor(bundle["scale"], device=device),
        angle=torch.as_tensor(bundle["angle"], device=device),
        desc=torch.as_tensor(desc, device=device),
        valid=torch.as_tensor(bundle["valid"], device=device),
    )


# ---------------------------------------------------------------------------
# Session integration
# ---------------------------------------------------------------------------

def pose_topic(drone: int) -> str:
    return f"coloc/drone{drone}/pose"


def features_topic(drone: int) -> str:
    return f"coloc/drone{drone}/features"


def image_topic(drone: int) -> str:
    return f"coloc/drone{drone}/image"


MAP_TOPIC = "coloc/map"


class TransportPublisher:
    """ROSUtils-parity session sink over the native bus.

    Presents the surface of io/liveviz.LiveViz (`publish_pose`,
    `publish_map`, `close`), so it drops into ColocSession's `viz=` slot:
    poses go out per update (queue depth 1 per topic matches ROSUtils'
    advertise(topic, 1)), the map cloud on map (re)build."""

    def __init__(self, node: Node, max_map_points: int = 20000):
        self._node = node
        self._max_map_points = max_map_points
        self._frame = 0
        self._dead = False

    def _publish(self, topic: str, payload: bytes):
        # telemetry is advisory: a dying bus degrades this sink and never
        # aborts the session (LiveViz, its sibling in the viz slot, never
        # raises either)
        if self._dead:
            return
        try:
            self._node.publish(topic, payload)
        except OSError:
            self._dead = True
            warnings.warn("transport publisher: bus connection lost; telemetry "
                          "disabled for the rest of the session", RuntimeWarning)

    def publish_pose(self, drone: int, C, cov3=None, success: bool = True,
                     frame: Optional[int] = None):
        if frame is not None:
            self._frame = int(frame)
        self._publish(pose_topic(int(drone)),
                      encode_pose(int(drone), self._frame, 0.0, C, cov3=cov3, success=success))

    def publish_map(self, X, valid=None):
        X = decimate_map_points(X, valid, self._max_map_points)
        self._publish(MAP_TOPIC, encode_map_points(X))

    def close(self):
        pass  # the node's lifetime is the caller's


class ImageStreamBridge:
    """Subscribes `coloc/drone{i}/image` and feeds a FrameStream.

    The receiving side of the InterfaceROS path: frames arriving on the bus
    land in per-drone queues that `StreamInterface` / `ApproximateTimeSync`
    (io/stream.py) consume unchanged."""

    def __init__(self, node: Node, stream, drones: Sequence[int],
                 depth: int = 4, max_bytes: int = 16 << 20):
        self._node = node
        self._stream = stream
        self._max_bytes = max_bytes
        self._drones = list(drones)
        for d in self._drones:
            node.subscribe(image_topic(d), depth=depth)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._pump, args=(d,), daemon=True)
                         for d in self._drones]
        for t in self._threads:
            t.start()

    def _pump(self, drone: int):
        topic = image_topic(drone)
        while not self._stop.is_set():
            try:
                payload = self._node.receive(topic, timeout=0.1, max_bytes=self._max_bytes)
            except PayloadTooLarge as e:
                # that one frame is lost (consumed and truncated by the C
                # side), but the feed survives
                warnings.warn(f"image bridge drone {drone}: dropped oversized frame ({e})",
                              RuntimeWarning)
                continue
            except (TransportClosed, KeyError) as e:
                # unrecoverable: close the stream so consumers see the end
                # instead of blocking on a dead feed
                if not self._stop.is_set():
                    warnings.warn(f"image bridge drone {drone}: feed ended ({e!r}); "
                                  "closing stream", RuntimeWarning)
                    self._stream.close()
                return
            if payload is None:
                continue
            d, img, ts = decode_image(payload)
            self._stream.push(d, img, timestamp=ts)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
