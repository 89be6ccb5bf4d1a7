"""Peer-to-peer collaborative localization, one robot per process
(counterpart of coloc_tpu.distributed).

The reference simulates its robot fleet inside one process (a sequential
drone loop, coloc.hpp:128-148) and leaves multi-process deployment to ROS
topics it never exercises. This module is that deployment: each robot runs
a `DronePeer` in its own process, localizing against a shared map locally,
and the collaborative step happens over the wire: peers publish their
feature bundles (keypoints + packed descriptors + camera + filtered pose +
covariance, io/transport.bundle_from_features) on the TCP topic bus, and a
receiving peer runs the full interPoseEstimator (pairwise match -> relative
pose -> temp two-view reconstruction -> scale alignment -> pose-only refine
-> covariance intersection) against the freshest bundle it pulled.

The compute core is parallel.mesh.inter_pose_device, the function the
in-process session path (ColocSession.inter_pose) runs, so the deployment
shapes cannot diverge: from the same features, poses and `sample_idx` a
peer's fusion equals the session's. The bus speaks coloc_tpu's wire format,
so peers of the two packages fuse each other's bundles.

Typical peer process::

    node = transport.Node(broker_port)
    peer = DronePeer(drone_id, config, K, dist, mapdb, node,
                     peers=[other_id, ...])
    for image in frames:
        pwc = peer.step(image)            # intra localization + pose publish
        peer.publish_bundle()             # share features for the others
        fused = peer.inter_fuse(other_id) # collaborative fusion (event)

Where coloc_tpu takes a JAX key, `inter_fuse` takes `sample_idx` (256, 5),
the five-point draws; otherwise the peer session's generator draws them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from coloc_tpu_torch.config import ColocConfig
from coloc_tpu_torch.fusion import covint
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.io import transport
from coloc_tpu_torch.ops.dispatch import default_device
from coloc_tpu_torch.parallel import mesh
from coloc_tpu_torch.session import BOOTSTRAP_CHECK_EVERY, ColocSession
from coloc_tpu_torch.types import Features, MapDB, Pose, PoseWithCov


class DronePeer:
    """One robot's half of a multi-process collaborative session.

    Wraps a single-drone `ColocSession` (local intra localization + Kalman
    filtering against a shared map, typically loaded with
    checkpoint.load_mapdb) and speaks the topic-bus protocol:

      - publishes `coloc/drone{id}/pose` after every step (ROSUtils parity)
      - publishes `coloc/drone{id}/features` on demand (the inter-drone
        exchange payload)
      - subscribes to its peers' feature topics and runs the inter-drone
        relative localization + ICI fusion locally when asked

    `mapdb` must be the same map in every peer (same landmark slots: the
    map is the shared world frame, as the reference's shared map database
    after initMap). `device`: the session's (None: cuda:0, raising where
    there is none).
    """

    def __init__(
        self,
        drone: int,
        config: ColocConfig,
        K: np.ndarray,
        dist: np.ndarray,
        mapdb: MapDB,
        node: Optional[transport.Node] = None,
        peers: Sequence[int] = (),
        out_dir: str = "",
        seed: Optional[int] = None,
        bundle_depth: int = 2,
        bundle_max_age: Optional[float] = 60.0,
        device=None,
    ):
        self.drone = int(drone)
        self.config = config
        self.node = node
        # staleness bound on consumed feature bundles (seconds of wall clock,
        # sender-stamped at encode time): a bundle that sat in a queue past
        # this window describes a pose the sender has long left, and fusing
        # it would inject a phantom relative constraint. None disables the
        # gate. run_peer's re-offer loop keeps republishing fresh bundles,
        # so live peers are never gated. Peers are assumed roughly
        # NTP-synced (the assumption ROS header stamps make).
        self.bundle_max_age = bundle_max_age
        # local session: one drone, the shared map injected (no bootstrap)
        cfg1 = dataclasses.replace(config, num_drones=1)
        self.session = ColocSession(
            cfg1, np.asarray(K, np.float32)[None], np.asarray(dist, np.float32)[None],
            out_dir=out_dir, seed=self.drone if seed is None else seed, device=device)
        self.device = self.session.device
        self.set_map(mapdb)
        self.K = np.asarray(K, np.float64)
        self.dist = np.asarray(dist, np.float64)
        self._last_image = None
        self._last_feats: Optional[Features] = None
        self._feats_frame = -1
        self.frame = 0
        self._bundle_depth = bundle_depth
        for p in peers:
            self.subscribe_peer(p)

    def set_map(self, mapdb: MapDB) -> None:
        """Inject the shared map (coloc_tpu assigns session.mapdb). The
        session's bank is packed anew for it on the next step, and its
        landmark support arrays are rebuilt for its slots."""
        s = self.session
        s.mapdb = MapDB(*(t.to(s.device) for t in mapdb))
        s.map_ready = True
        s.lm_support = s.lm_last_seen = None

    # ------------------------------------------------------------ local step
    def step(self, image, publish: bool = True) -> PoseWithCov:
        """One frame: intra localization + KF locally, pose on the bus."""
        pwc = self.session.intra_pose(0, image)
        self._last_image = image
        self.frame += 1
        self.session.frame = self.frame
        if publish and self.node is not None:
            host = torch.cat([pwc.pose.C, pwc.cov[3:6, 3:6].reshape(9),
                              pwc.success.reshape(1).to(torch.float32)]).cpu().numpy()
            try:
                self.node.publish(
                    transport.pose_topic(self.drone),
                    transport.encode_pose(self.drone, self.frame - 1, time.time(), host[:3],
                                          rpy=None, cov3=host[3:12].reshape(3, 3),
                                          success=bool(host[12])))
            except OSError:
                # pose telemetry is advisory: a bus outage must not stop
                # local localization (reconnect-enabled nodes redial on the
                # next publish/receive)
                pass
        return pwc

    # ----------------------------------------------------------- feature bus
    def _current_feats(self) -> Features:
        """Features of the latest stepped frame (detected once, cached)."""
        if self._last_image is None:
            raise RuntimeError("step() an image before exchanging features")
        if self._feats_frame != self.frame:
            self._last_feats = self.session.detect(self._last_image)
            self._feats_frame = self.frame
        return self._last_feats

    def bundle(self) -> bytes:
        """This peer's inter-drone exchange payload: the latest frame's
        feature bank + camera + current filtered pose + position cov, with
        one host copy."""
        feats = self._current_feats()
        last = self.session.last_pose.get(0)
        if last is None:
            raise RuntimeError("no localized pose yet: step() first")
        return transport.bundle_from_features(
            self.drone, self.frame - 1, time.time(), feats, self.K, self.dist,
            last.pose.R, last.pose.C, last.cov[3:6, 3:6])

    def publish_bundle(self) -> None:
        """Ship this peer's bundle on its features topic."""
        if self.node is None:
            raise RuntimeError("offline peer (node=None) cannot publish")
        self.node.publish(transport.features_topic(self.drone), self.bundle())

    def subscribe_peer(self, drone: int) -> None:
        if self.node is not None:
            self.node.subscribe(transport.features_topic(int(drone)), depth=self._bundle_depth)

    def receive_bundle(self, src: int, timeout: float = 2.0,
                       freshest: bool = True) -> Optional[dict]:
        """Pull a peer's feature bundle off the bus (None on timeout).
        `freshest=True` drains the queue and keeps the newest bundle."""
        if self.node is None:
            return None
        topic = transport.features_topic(int(src))
        try:
            payload = self.node.receive(topic, timeout=timeout, max_bytes=64 << 20)
        except (transport.TransportClosed, TimeoutError):
            return None
        if payload is None:
            return None
        if freshest:
            while True:
                try:
                    nxt = self.node.receive(topic, timeout=0.0, max_bytes=64 << 20)
                except (transport.TransportClosed, TimeoutError):
                    break
                if nxt is None:
                    break
                payload = nxt
        return transport.decode_feature_bundle(payload)

    # --------------------------------------------------------- collaborative
    def inter_fuse(
        self, src: int, timeout: float = 2.0,
        bundle: Optional[dict] = None, publish: bool = True,
        sample_idx: Optional[torch.Tensor] = None,
        max_age: Optional[float] = None,
    ) -> Optional[covint.FusionResult]:
        """interPoseEstimator(src, me) over the wire: pull drone `src`'s
        freshest feature bundle off the bus (or take `bundle`, decoded) and
        fuse it with my intra estimate (coloc.hpp:274-392, peer-to-peer
        deployment shape). `sample_idx` (256, 5): injected five-point draws.

        Returns None when no bundle arrives in `timeout`, the bundle is
        older than the staleness window (`max_age`, defaulting to the
        peer's `bundle_max_age`; timestamp 0.0, unstamped, is exempt), I
        have no pose yet, the peer's keypoint capacity differs from mine,
        or the relative-pose/common-landmark gates fail (the reference's
        early returns)."""
        if bundle is None:
            bundle = self.receive_bundle(src, timeout=timeout)
        if bundle is None:
            return None
        window = self.bundle_max_age if max_age is None else max_age
        if window is not None and bundle.get("timestamp"):
            if time.time() - float(bundle["timestamp"]) > window:
                return None  # stale: the sender has moved on since stamping
        last = self.session.last_pose.get(0)
        if last is None:
            return None
        f_dst = self._current_feats()
        if bundle["xy"].shape[0] != f_dst.xy.shape[0]:
            return None  # capacity mismatch: peers must share a config
        dev = self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        f_src = transport.features_from_bundle(bundle, dev)
        K_src, dist_src = f32(bundle["K"]), f32(bundle["dist"])
        K_dst, dist_dst = self.session.Ks[0], self.session.dists[0]
        out = mesh.inter_pose_device(
            f_dst, f_src, Camera(K=K_src, dist=dist_src), Camera(K=K_dst, dist=dist_dst),
            torch.stack([K_src, K_dst]), torch.stack([dist_src, dist_dst]),
            Pose(R=f32(bundle["R"]), C=f32(bundle["C"])), f32(bundle["cov3"]),
            last.pose.C, last.cov[3:6, 3:6], self.session.mapdb, self.config,
            generator=self.session.generator, sample_idx=sample_idx,
            check_every=BOOTSTRAP_CHECK_EVERY)
        if not bool(out.ok):
            return None
        fused = covint.FusionResult(cov=out.fused_cov, pos=out.fused_pos,
                                    omega=out.diag.omega, trace=out.diag.trace)
        if publish and self.node is not None:
            host = torch.cat([fused.pos, fused.cov.reshape(9)]).cpu().numpy()
            try:
                self.node.publish(
                    transport.pose_topic(self.drone),
                    transport.encode_pose(self.drone, self.frame - 1, time.time(), host[:3],
                                          cov3=host[3:].reshape(3, 3), success=True))
            except OSError:
                # the fusion is the product; the pose topic is telemetry: a
                # bus outage here must not discard a computed result
                pass
        return fused

    # ---------------------------------------------------------------- admin
    def close(self):
        self.session.close()


def run_peer(
    drone: int,
    config: ColocConfig,
    K: np.ndarray,
    dist: np.ndarray,
    mapdb: MapDB,
    broker_port: int,
    frames: Sequence[np.ndarray],
    peers: Sequence[int],
    inter_every: int = 0,
    host: str = "127.0.0.1",
    bundle_every: int = 1,
    inter_timeout: float = 10.0,
    device=None,
    reconnect_timeout: float = 10.0,
) -> Dict[str, object]:
    """Driver of one peer process: step every frame, publish a bundle every
    `bundle_every` frames, and run inter_fuse against each peer every
    `inter_every` frames (0 = never). Returns per-frame results for the
    caller to check or log: "pose" (host centres), "success", "fused"
    ((frame, src, pos, cov) host arrays), and "seconds": the wall time
    spent on "frames" (steps and bundle offers) and on "fusion" rounds
    (waiting for peers included).

    The fusion phase is a re-offer loop: until every peer fused (or
    `inter_timeout` elapses), this peer republishes its own bundle and
    retries each pending peer with a short receive timeout. Peers join the
    bus at different times, and a bundle published before a late peer's
    subscription reached the broker is gone, so a one-shot publish and wait
    deadlocks exactly when fleets are least synchronized. Re-offering makes
    the exchange eventually consistent as long as the peers' fusion windows
    overlap."""
    results = {"pose": [], "success": [], "fused": [],
               "seconds": {"frames": 0.0, "fusion": 0.0}}
    # reconnect=True: a broker restart mid-run redials and resubscribes; the
    # re-offer loop then repopulates the lost bundle queues
    with transport.Node(broker_port, host=host, reconnect=True,
                        reconnect_timeout=reconnect_timeout) as node:
        peer = DronePeer(drone, config, K, dist, mapdb, node, peers=peers, device=device)

        def offer():
            # a broker outage longer than the node's reconnect window makes
            # publish raise; localization is local and must keep going
            try:
                peer.publish_bundle()
                return True
            except OSError:
                return False

        for f, image in enumerate(frames):
            t0 = time.monotonic()
            pwc = peer.step(image)
            res = torch.cat([pwc.pose.C, pwc.success.reshape(1).to(torch.float32)]).cpu()
            results["pose"].append(res[:3].numpy())
            results["success"].append(bool(res[3]))
            if bundle_every and f % bundle_every == 0:
                offer()
            t1 = time.monotonic()
            results["seconds"]["frames"] += t1 - t0
            if inter_every and (f + 1) % inter_every == 0:
                deadline = time.monotonic() + inter_timeout
                pending = set(int(s) for s in peers)
                while pending:
                    offer()  # re-offer for late subscribers
                    for src in sorted(pending):
                        fused = peer.inter_fuse(src, timeout=2.0)
                        if fused is not None:
                            results["fused"].append(
                                (f, src, fused.pos.cpu().numpy(), fused.cov.cpu().numpy()))
                            pending.discard(src)
                    if time.monotonic() >= deadline:
                        break
                results["seconds"]["fusion"] += time.monotonic() - t1
        peer.close()
    return results


def main(argv=None) -> int:
    """One robot's peer process over the reference disk dataset layout::

        # terminal 1 (also starts the broker)
        python -m coloc_tpu_torch.distributed --drone 0 --peers 1 \\
            --map map.npz --calib calib.txt --folder data/ --broker 7777
        # terminal 2 (any machine that reaches the broker)
        python -m coloc_tpu_torch.distributed --drone 1 --peers 0 \\
            --map map.npz --calib calib.txt --folder data/ \\
            --broker HOST:7777

    Maps come from `checkpoint.save_mapdb` (a bootstrapped session's, or
    coloc_tpu's). `--cpu` runs the plain PyTorch path; by default the peer
    runs on cuda:0."""
    import argparse

    from coloc_tpu_torch import checkpoint
    from coloc_tpu_torch.config import DetectorOptions
    from coloc_tpu_torch.io import disk

    ap = argparse.ArgumentParser(
        description="Peer-to-peer collaborative localization: one drone "
                    "per process over the TCP topic bus")
    ap.add_argument("--drone", type=int, required=True)
    ap.add_argument("--peers", type=int, nargs="+", required=True)
    ap.add_argument("--map", required=True, help="map .npz (save_mapdb)")
    ap.add_argument("--calib", required=True)
    ap.add_argument("--folder", required=True,
                    help="dataset folder (img__Quad{d}_{frame:04d}.png)")
    ap.add_argument("--broker", required=True,
                    help="PORT to start a broker here, or HOST:PORT to join")
    ap.add_argument("--frames", type=int, default=0, help="0 = all on disk")
    ap.add_argument("--maxkp", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--fast-threshold", type=int, default=12)
    ap.add_argument("--inter-every", type=int, default=4)
    ap.add_argument("--bundle-every", type=int, default=1)
    ap.add_argument("--reconnect-timeout", type=float, default=10.0,
                    help="seconds a publish redials a lost broker (a peer that "
                         "outlives the broker's owner pays it on every publish)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (default: cuda:0)")
    args = ap.parse_args(argv)
    t_main = time.monotonic()
    device = default_device("cpu" if args.cpu else None)

    # the broker first, so that peers can join while this one loads
    broker = None
    if ":" in args.broker:
        host, port = args.broker.rsplit(":", 1)
        port = int(port)
    else:
        broker = transport.Broker(int(args.broker))
        host, port = "127.0.0.1", broker.port
        print(f"broker listening on {port}", flush=True)
    try:
        n_drones = max([args.drone] + args.peers) + 1
        (w, h), Ks, dists = disk.read_calib(args.calib, n_drones)
        config = ColocConfig(
            num_drones=n_drones,
            detector=DetectorOptions(width=w, height=h, max_keypoints=args.maxkp,
                                     num_levels=args.levels,
                                     fast_threshold=args.fast_threshold),
        )
        mapdb = checkpoint.load_mapdb(args.map, device=device)
        n = args.frames or disk.num_frames(args.folder, args.drone)
        frames = [disk.load_frame(args.folder, args.drone, f) for f in range(n)]
        res = run_peer(args.drone, config, Ks[args.drone], dists[args.drone], mapdb, port,
                       frames, peers=args.peers, inter_every=args.inter_every, host=host,
                       bundle_every=args.bundle_every, device=device,
                       reconnect_timeout=args.reconnect_timeout)
    finally:
        if broker is not None:
            broker.close()
    ok, secs = sum(res["success"]), res["seconds"]
    setup = time.monotonic() - t_main - secs["frames"] - secs["fusion"]
    print(f"drone {args.drone} on {mapdb.X.device}: localized {ok}/{len(frames)} frames, "
          f"{len(res['fused'])} inter-drone fusions; set-up {setup:.1f} s, frames "
          f"{secs['frames']:.1f} s, fusion rounds {secs['fusion']:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
