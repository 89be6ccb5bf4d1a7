"""Live streaming ingest (counterpart of coloc_tpu.io.stream).

Reference parity: InterfaceROS.hpp — the USE_STREAM-gated path where frames
arrive on topic callbacks (sensor_msgs::Image -> mono8 -> detector), with
message_filters approximate-time pairing for the two-drone case. ROS itself
is out of scope (not in the target environment); this module provides the
same *interface shape* transport-agnostically:

  - `FrameStream`: thread-safe per-drone frame queues push()ed by any source
    (socket server, camera driver, replay thread).
  - `ApproximateTimeSync`: pairs frames across drones within a time window
    (message_filters::ApproximateTime equivalent).
  - `StreamInterface`: Interface-parity ingest — blocks for the next frame
    (or synced pair) and runs the session's detection (ColocSession.detect,
    on the session's device), mirroring InterfaceROS::processImageSingle /
    processImagePair.

numpy and threading only: frames stay host arrays until detect.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np


class FrameStream:
    """Per-drone timestamped frame queues (the 'topic' equivalent)."""

    def __init__(self, num_drones: int, maxsize: int = 16):
        self._queues = [queue.Queue(maxsize=maxsize) for _ in range(num_drones)]
        self.closed = threading.Event()

    def push(self, drone: int, image: np.ndarray,
             timestamp: Optional[float] = None):
        """Source-side: publish a frame (drops oldest when full)."""
        ts = time.monotonic() if timestamp is None else timestamp
        q = self._queues[drone]
        while True:
            try:
                q.put_nowait((ts, image))
                return
            except queue.Full:
                try:
                    q.get_nowait()  # drop oldest (live-stream semantics)
                except queue.Empty:
                    pass

    def pop(self, drone: int, timeout: Optional[float] = None):
        """-> (timestamp, image) or None on timeout/close."""
        try:
            return self._queues[drone].get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        self.closed.set()


class ApproximateTimeSync:
    """Pair frames from two streams within `slop` seconds
    (message_filters::ApproximateTime equivalent, InterfaceROS.hpp:7-9)."""

    def __init__(self, stream: FrameStream, drone_a: int, drone_b: int,
                 slop: float = 0.05):
        self.stream = stream
        self.a = drone_a
        self.b = drone_b
        self.slop = slop
        self._pend_a = None
        self._pend_b = None

    def next_pair(self, timeout: float = 1.0):
        """-> ((ts_a, img_a), (ts_b, img_b)) or None."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._pend_a is None:
                self._pend_a = self.stream.pop(self.a, timeout=0.01)
            if self._pend_b is None:
                self._pend_b = self.stream.pop(self.b, timeout=0.01)
            if self._pend_a is None or self._pend_b is None:
                continue
            ta, tb = self._pend_a[0], self._pend_b[0]
            if abs(ta - tb) <= self.slop:
                out = (self._pend_a, self._pend_b)
                self._pend_a = self._pend_b = None
                return out
            # drop the older one and retry
            if ta < tb:
                self._pend_a = None
            else:
                self._pend_b = None
        return None


class StreamInterface:
    """Interface-parity live ingest feeding the session's detector.

    Mirrors InterfaceROS: processImageSingle detects on one drone's next
    frame; processImagePair time-syncs two drones and detects both.
    """

    def __init__(self, session, stream: FrameStream):
        self.session = session
        self.stream = stream
        self.frame_number = 0  # Interface::imageNumber parity

    def process_image_single(self, drone: int, timeout: float = 1.0):
        item = self.stream.pop(drone, timeout=timeout)
        if item is None:
            return None
        _, image = item
        self.frame_number += 1
        return self.session.detect(image)

    def process_image_pair(self, drone_a: int, drone_b: int,
                           slop: float = 0.05, timeout: float = 1.0):
        sync = ApproximateTimeSync(self.stream, drone_a, drone_b, slop)
        pair = sync.next_pair(timeout=timeout)
        if pair is None:
            return None
        (ta, img_a), (tb, img_b) = pair
        self.frame_number += 1
        return self.session.detect(img_a), self.session.detect(img_b)
