"""What a message costs on the port's topic bus (coloc_tpu_torch.io.transport),
host only: no card is needed, but run it where the numbers are kept.

    python scripts/prof_torch_bus.py

One broker and two nodes on localhost. For each of the runtime's messages
(a 752x480 mono8 frame as ServeRunner receives it, a 1024-keypoint feature
bundle as DronePeer receives it, a pose) it publishes and receives REPS
messages one at a time and prints the p50 of a publish-then-receive, in
turns between two ways of taking the payload out of the receive buffer:

  - string_at: the port's Node.receive, a copy of the payload's n bytes;
  - raw[:n]: the buffer's whole max_bytes copied first, then sliced (the
    form of coloc_tpu's Node.receive), with the max_bytes each caller
    passes (16 MiB for frames and poses, 64 MiB for bundles).

Then the decode of each message. Prints the host's CPU model, and the
card's name and power limit where nvidia-smi answers.
"""

from __future__ import annotations

import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from coloc_tpu_torch.io import transport  # noqa: E402

REPS, ROUNDS = 40, 2


def cpu_model() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no card"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "no card"


def raw_receive(node: transport.Node, topic: str, max_bytes: int) -> bytes:
    """coloc_tpu's form: the whole buffer copied, then sliced."""
    buf = node._recv_buf(max_bytes)
    n = node._lib.coloc_node_receive(node._handle, topic.encode(), buf, max_bytes, 5.0)
    assert 0 <= n <= max_bytes
    return buf.raw[:n]


def main() -> int:
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (480, 752), dtype=np.uint8)
    n = 1024
    bundle = transport.encode_feature_bundle(
        0, 1, 0.0, rng.uniform(0, 700, (n, 2)), rng.uniform(0, 1, n), np.zeros(n, np.int32),
        rng.uniform(-3, 3, n), rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64)
        .astype(np.uint32), np.ones(n, bool), np.eye(3), np.zeros(3), np.eye(3), np.zeros(3),
        np.eye(3))
    messages = {
        "frame 752x480": (transport.encode_image(0, frame, 1.0), 16 << 20,
                          transport.decode_image),
        "bundle 1024 kp": (bundle, 64 << 20, transport.decode_feature_bundle),
        "pose": (transport.encode_pose(0, 1, 1.0, np.zeros(3)), 16 << 20,
                 transport.decode_pose),
    }
    print(f"host: {cpu_model()}; card: {card()}")
    with transport.Broker() as broker, transport.Node(broker.port) as sub, \
            transport.Node(broker.port) as pub:
        for topic in messages:
            sub.subscribe(topic, depth=4)
        time.sleep(0.1)
        for topic, (payload, max_bytes, decode) in messages.items():
            forms = {"string_at": lambda: sub.receive(topic, timeout=5.0, max_bytes=max_bytes),
                     "raw[:n]": lambda: raw_receive(sub, topic, max_bytes)}
            ms = {k: [] for k in forms}
            for _ in range(ROUNDS):
                for name, recv in list(forms.items()) + list(forms.items())[::-1]:
                    for _ in range(REPS // 2):
                        t0 = time.perf_counter()
                        pub.publish(topic, payload)
                        got = recv()
                        ms[name].append((time.perf_counter() - t0) * 1e3)
                        assert got == payload
            t0 = time.perf_counter()
            for _ in range(REPS):
                decode(payload)
            dec = (time.perf_counter() - t0) * 1e3 / REPS
            print(f"{topic} ({len(payload)} bytes, max_bytes {max_bytes >> 20} MiB): publish "
                  f"and receive p50 " + ", ".join(
                      f"{k} {np.percentile(v, 50):.3f} ms" for k, v in ms.items())
                  + f"; decode {dec:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
