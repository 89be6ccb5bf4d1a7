"""Serving runner: ServingEngine fed by the native TCP topic bus
(counterpart of coloc_tpu.serve).

    python -m coloc_tpu_torch.serve --map map.npz --calib calib.txt \\
        --streams 8 --publish 7777            # start a broker here
    python -m coloc_tpu_torch.serve --map map.npz --calib calib.txt \\
        --streams 8 --publish host:7777       # join a remote broker
    ... --cpu                                 # the plain PyTorch path

Deployment shape with no reference equivalent (the reference runs one
coloc_node per 2-drone session, coloc_node.cpp:59): one card serves B robot
streams against a shared resident map. Robots publish mono8 frames on
``coloc/drone{i}/image`` (transport.encode_image); each dispatch batches the
freshest frame of every stream through ServingEngine.localize_frames (the
batched frontend, one 2-NN pass, P3P RANSAC and the pose LM over the stream
axis) and publishes every fresh stream's pose on ``coloc/drone{i}/pose``
(transport.encode_pose, ROSUtils message parity).

The batch shape is static: streams with no new frame since the last
dispatch keep their previous frame in the batch, but their pose is not
re-published, so a stale stream costs compute, never a wrong output. A
dispatch's results reach the host in one copy: the Euler angles are
computed on the device for the whole batch first. Maps come from
checkpoint.save_mapdb or a session checkpoint and can be swapped with
ServingEngine.set_map. The RANSAC draws come from one torch.Generator on
the engine's device, seeded with `seed` (coloc_tpu's PRNGKey(seed)).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from coloc_tpu_torch.config import ColocConfig, DetectorOptions
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.io import transport
from coloc_tpu_torch.ops.dispatch import default_device
from coloc_tpu_torch.serving import ServingEngine
from coloc_tpu_torch.types import MapDB


def _host(t: torch.Tensor) -> np.ndarray:
    """A dispatch's results, (B, 16) on the device, as one host array."""
    return t.cpu().numpy()


class ServeRunner:
    """Poll image topics -> batched dispatch -> publish poses.

    `node` must be a connected transport.Node; the runner subscribes to the
    B image topics itself (depth 4, drop-oldest: a slow dispatch never
    backs up the bus). `device`: the engine's (None: cuda:0, raising where
    there is none)."""

    def __init__(self, mapdb: MapDB, config: ColocConfig, Ks: np.ndarray,
                 dists: np.ndarray, node: transport.Node, streams: int,
                 seed: int = 0, device=None):
        det = config.detector
        self.config = config
        self.node = node
        self.B = streams
        cams = Camera(
            K=torch.as_tensor(np.broadcast_to(np.asarray(Ks, np.float32),
                                              (streams, 3, 3)).copy()),
            dist=torch.as_tensor(np.broadcast_to(np.asarray(dists, np.float32),
                                                 (streams, 3)).copy()),
        )
        self.engine = ServingEngine(mapdb, cams, config, device=device)
        self.device = self.engine.device
        self.frames = np.zeros((streams, det.height, det.width), np.uint8)
        self.have = np.zeros(streams, bool)       # ever seen a frame
        self.frame_ids = np.zeros(streams, np.int64)
        self.timestamps = np.zeros(streams, np.float64)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        for i in range(streams):
            node.subscribe(transport.image_topic(i), depth=4)

    def poll(self, timeout: float = 0.05) -> np.ndarray:
        """Drain every image topic to its newest frame. Returns the fresh
        mask (streams that delivered at least one new frame)."""
        fresh = np.zeros(self.B, bool)
        deadline = time.monotonic() + timeout
        for i in range(self.B):
            # block only for the remaining budget on the first message,
            # then drain whatever is already queued without waiting
            budget = max(0.0, deadline - time.monotonic())
            while True:
                p = self.node.receive(transport.image_topic(i),
                                      timeout=0.0 if fresh[i] else budget)
                if p is None:
                    break
                _, img, ts = transport.decode_image(p)
                self.frames[i] = img
                self.timestamps[i] = ts
                fresh[i] = True
        self.have |= fresh
        return fresh

    def step(self, fresh: np.ndarray) -> Dict[int, dict]:
        """One batched dispatch; publish and return the poses of the fresh
        streams ({"C", "rpy", "success"} by stream)."""
        if not fresh.any():
            return {}
        images = torch.from_numpy(self.frames).to(self.device).to(torch.float32)
        pwc, _, _ = self.engine.localize_frames(images, generator=self.generator)
        out_d = torch.cat([pwc.pose.C, so3.rot_to_euler(pwc.pose.R),
                           pwc.cov[:, 3:6, 3:6].reshape(self.B, 9),
                           pwc.success[:, None].to(torch.float32)], dim=1)
        res = _host(out_d)
        C, rpy, cov3, ok = res[:, 0:3], res[:, 3:6], res[:, 6:15], res[:, 15] != 0
        out: Dict[int, dict] = {}
        for i in np.flatnonzero(fresh):
            self.frame_ids[i] += 1
            self.node.publish(
                transport.pose_topic(int(i)),
                transport.encode_pose(int(i), int(self.frame_ids[i]),
                                      float(self.timestamps[i]), C[i], rpy=rpy[i],
                                      cov3=cov3[i].reshape(3, 3), success=bool(ok[i])))
            out[int(i)] = {"C": C[i], "rpy": rpy[i], "success": bool(ok[i])}
        return out

    def run(self, max_steps: Optional[int] = None, poll_timeout: float = 0.05,
            idle_timeout: Optional[float] = None) -> int:
        """Serve until max_steps dispatches (None = forever), or until no
        stream has delivered a frame for idle_timeout seconds (None = wait
        forever). Returns the number of dispatches executed."""
        steps = 0
        last_fresh = time.monotonic()
        while max_steps is None or steps < max_steps:
            fresh = self.poll(poll_timeout)
            if fresh.any():
                last_fresh = time.monotonic()
            elif idle_timeout is not None and time.monotonic() - last_fresh > idle_timeout:
                break
            if self.step(fresh):
                steps += 1
        return steps


def main(argv=None) -> int:
    import argparse

    from coloc_tpu_torch import checkpoint
    from coloc_tpu_torch.io import disk

    ap = argparse.ArgumentParser(
        description="Serve B robot streams against a resident map "
                    "(map from checkpoint.save_mapdb)")
    ap.add_argument("--map", required=True, help="map .npz (save_mapdb)")
    ap.add_argument("--calib", required=True, help="calib.txt (shared "
                    "intrinsics; first drone's K is broadcast to all streams)")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--publish", required=True,
                    help="PORT to start a broker, or HOST:PORT to join one")
    ap.add_argument("--maxkp", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--fast-threshold", type=int, default=12)
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after N dispatches (0 = run forever)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (default: cuda:0)")
    args = ap.parse_args(argv)
    device = default_device("cpu" if args.cpu else None)

    (w, h), Ks, dists = disk.read_calib(args.calib, 1)
    config = ColocConfig(detector=DetectorOptions(
        width=w, height=h, max_keypoints=args.maxkp, num_levels=args.levels,
        fast_threshold=args.fast_threshold))
    mapdb = checkpoint.load_mapdb(args.map, device=device)

    broker = None
    if ":" in args.publish:
        host, port = args.publish.rsplit(":", 1)
        port = int(port)
    else:
        broker = transport.Broker(int(args.publish))
        host, port = "127.0.0.1", broker.port
        print(f"broker listening on {port}", flush=True)
    try:
        with transport.Node(port, host) as node:
            runner = ServeRunner(mapdb, config, Ks[0], dists[0], node, args.streams,
                                 device=device)
            print(f"serving {args.streams} streams on {runner.device}", flush=True)
            n = runner.run(max_steps=args.steps or None)
            print(f"served {n} dispatches")
    finally:
        if broker is not None:
            broker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
