"""Command-line entry point (counterpart of coloc_tpu.cli; reference:
src/coloc_node.cpp main).

Usage:
  python -m coloc_tpu_torch.cli --folder DATA --calib calib.txt --drones 2 \\
      --frames 50 --out runs/session1
  python -m coloc_tpu_torch.cli --synthetic --frames 20 --out runs/demo
  python -m coloc_tpu_torch.cli ... --cpu     # the plain PyTorch path

Mirrors coloc_node.cpp: reads calib.txt, builds the session, and runs the
main loop over the image folder. Option defaults follow the reference
(coloc_node.cpp:73-89: 1.2x 8-level pyramid, FAST threshold 40, Lowe ratio
0.8, Hamming margin 60, model 'E') except --maxkp, which defaults to 1024
rather than the reference's 5000, as in coloc_tpu; pass --maxkp 5000 for
the reference's capacity.

The session runs on cuda:0, or on the CPU with --cpu; without a CUDA device
and without --cpu the command raises. Frames are read by the native
prefetching loader where it builds, else by io/disk; the command prints
which.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


class _FanoutSink:
    """Duplicates session viz callbacks to several sinks (--viz + --publish)."""

    def __init__(self, sinks):
        self.sinks = sinks

    def publish_pose(self, *a, **kw):
        for s in self.sinks:
            s.publish_pose(*a, **kw)

    def publish_map(self, *a, **kw):
        for s in self.sinks:
            s.publish_map(*a, **kw)

    def close(self):
        for s in self.sinks:
            s.close()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="coloc_tpu_torch session runner")
    ap.add_argument("--folder", default="", help="image folder (img__Quad{d}_{f:04d}.png)")
    ap.add_argument("--calib", default="", help="calib.txt path")
    ap.add_argument("--drones", type=int, default=2)
    ap.add_argument("--frames", type=int, default=0, help="0 = all available")
    ap.add_argument("--out", default="coloc_out")
    ap.add_argument("--model", default="E", choices=["E", "F", "H"])
    ap.add_argument("--maxkp", type=int, default=1024)
    ap.add_argument("--fast-threshold", type=int, default=40,
                    help="FAST corner threshold (reference default 40, "
                         "coloc_node.cpp:81; lower for small/low-contrast frames)")
    ap.add_argument("--inter-every", type=int, default=10)
    ap.add_argument("--extend-map-every", type=int, default=0,
                    help="every N frames grow the map with newly triangulated "
                         "landmarks into free slots (session.extend_map; 0 = off)")
    ap.add_argument("--cull-every", type=int, default=0,
                    help="every N frames retire landmarks with no recent inlier "
                         "support (session.cull_map; 0 = off)")
    ap.add_argument("--cull-max-age", type=int, default=64,
                    help="cull landmarks unseen for this many frames")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate a synthetic dataset instead of reading --folder")
    ap.add_argument("--euroc", nargs="+", metavar="SEQ",
                    help="EuRoC ASL sequence roots, one per drone "
                         "(mav0/cam0/{data,sensor.yaml}); overrides --folder/--calib")
    ap.add_argument("--kitti", nargs="+", metavar="SEQ",
                    help="KITTI odometry sequence dirs, one per drone (image_0/ + "
                         "calib.txt; ground truth from poses/<NN>.txt when present); "
                         "overrides --folder/--calib")
    ap.add_argument("--kitti-cam", default="image_0",
                    help="KITTI camera directory to read (image_0/image_1)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (default: cuda:0)")
    ap.add_argument("--debug-svg", action="store_true",
                    help="emit per-stage SVG feature/match overlays into OUT/debug "
                         "(the reference's #ifdef DEBUG artifacts, coloc.hpp:153-239)")
    ap.add_argument("--viz", nargs="?", const=8765, type=int, default=None,
                    metavar="PORT",
                    help="serve a live pose+map viewer (rosUtils/RViz analog) on PORT "
                         "(default 8765)")
    ap.add_argument("--viz-config", default=None, metavar="JSON",
                    help="viewer layout config (the coloc.rviz analog; defaults to "
                         "coloc.view.json at the repo root)")
    ap.add_argument("--publish", default=None, metavar="HOST:PORT|PORT",
                    help="publish poses+map on the native TCP topic bus (ROS pub/sub "
                         "analog, io/transport.py); a bare PORT starts a broker here "
                         "(0 = ephemeral), HOST:PORT joins an existing one")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.euroc and args.kitti:
        ap.error("--euroc and --kitti are mutually exclusive")

    from coloc_tpu_torch.config import ColocConfig, DetectorOptions
    from coloc_tpu_torch.io import disk, synthetic
    from coloc_tpu_torch.ops.dispatch import default_device
    from coloc_tpu_torch.session import ColocSession

    device = default_device("cpu" if args.cpu else None)

    euroc_frames = None
    euroc_stamps = None
    if args.euroc:
        from coloc_tpu_torch.io import euroc as euroc_io

        args.drones = len(args.euroc)
        euroc_frames, Ks, dists, size, euroc_stamps = euroc_io.load_dataset(
            args.euroc, num_frames=args.frames, with_timestamps=True)
        print(f"loaded {args.drones} EuRoC sequences, {len(euroc_frames[0])} frames each")
    elif args.kitti:
        from coloc_tpu_torch.io import kitti as kitti_io

        args.drones = len(args.kitti)
        euroc_frames, Ks, dists, size, euroc_stamps = kitti_io.load_dataset(
            args.kitti, num_frames=args.frames, cam=args.kitti_cam, with_indices=True)
        print(f"loaded {args.drones} KITTI sequences, {len(euroc_frames[0])} frames each")
    elif args.synthetic:
        h, w = 240, 320
        K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
        Ks = np.stack([K] * args.drones)
        dists = np.zeros((args.drones, 3), np.float32)
        scene = synthetic.make_scene(h, w, K)
        folder = args.folder or tempfile.mkdtemp(prefix="coloc_synth_")
        n = args.frames or 20
        print(f"generating {args.drones}x{n} synthetic frames in {folder}")
        synthetic.write_dataset(folder, scene, args.drones, n)
        args.folder = folder
        size = (w, h)
    else:
        if not args.folder or not args.calib:
            ap.error("--folder and --calib required (or use --synthetic)")
        size, Ks, dists = disk.read_calib(args.calib, args.drones)

    viz = live = None
    if args.viz is not None:
        from coloc_tpu_torch.io.liveviz import LiveViz

        viz = live = LiveViz(port=args.viz, view_config=args.viz_config)
        print(f"live viz: {live.url}")

    bus_broker = bus_node = None
    if args.publish is not None:
        from coloc_tpu_torch.io import transport

        if ":" in args.publish:
            host, port = args.publish.rsplit(":", 1)
            bus_node = transport.Node(int(port), host=host)
            print(f"transport: joined bus at {host}:{port}")
        else:
            bus_broker = transport.Broker(port=int(args.publish))
            bus_node = transport.Node(bus_broker.port)
            print(f"transport: broker on 127.0.0.1:{bus_broker.port}")
        publisher = transport.TransportPublisher(bus_node)
        viz = publisher if viz is None else _FanoutSink([viz, publisher])

    config = ColocConfig(
        num_drones=args.drones,
        model=args.model,
        image_folder=args.folder,
        detector=DetectorOptions(width=size[0], height=size[1], max_keypoints=args.maxkp,
                                 fast_threshold=args.fast_threshold),
    )
    session = ColocSession(
        config, Ks, dists, out_dir=args.out, viz=viz,
        debug_dir=os.path.join(args.out, "debug") if args.debug_svg else "",
        device=device)
    print(f"session on {session.device}")

    from coloc_tpu_torch.io import native_loader

    if euroc_frames is not None:
        frames = euroc_frames
        n = len(frames[0])
    elif native_loader.available():
        n = args.frames or disk.num_frames(args.folder)
        print("frames: native loader")
        # native C++ prefetching loader (PNG/PGM via zlib, decoding overlaps
        # device work); consumed frame-major (all drones per frame) in the
        # prefetcher's decode order
        with native_loader.NativeLoader(args.folder, args.drones, n, size[1], size[0]) as ld:
            frames = {d: [] for d in range(args.drones)}
            for f in range(n):
                for d in range(args.drones):
                    frames[d].append(ld.get(d, f))
    else:
        n = args.frames or disk.num_frames(args.folder)
        from coloc_tpu_torch.io import _native

        print(f"frames: io/disk (the native loader did not build: "
              f"{_native.error('loader')})")
        frames = {d: [disk.load_frame(args.folder, d, f) for f in range(n)]
                  for d in range(args.drones)}

    t0 = time.time()
    results = session.run(frames, inter_every=args.inter_every,
                          extend_map_every=args.extend_map_every,
                          cull_map_every=args.cull_every, cull_max_age=args.cull_max_age)
    dt = time.time() - t0
    n_done = sum(len(v) for v in results.values())
    n_ok = sum(int(bool(p.success)) for v in results.values() for p in v)
    print(f"processed {n_done} frames in {dt:.1f}s ({n_done / max(dt, 1e-9):.1f} fps), "
          f"{n_ok}/{n_done} localized; logs in {args.out}/")

    # trajectory accuracy against the dataset's ground truth where there is one
    if (args.euroc or args.kitti) and euroc_stamps is not None:
        from coloc_tpu_torch import metrics

        if args.euroc:
            from coloc_tpu_torch.io import euroc as gt_io

            roots, gt_what = args.euroc, "state_groundtruth_estimate0"
        else:
            from coloc_tpu_torch.io import kitti as gt_io

            roots, gt_what = args.kitti, "poses/<NN>.txt"
        for d, root in enumerate(roots):
            gt = gt_io.load_groundtruth(root)
            if gt is None:
                print(f"drone {d}: no ground truth in {root} ({gt_what} absent) — "
                      "ATE skipped")
                continue
            traj = results.get(d, [])
            ok_idx = [i for i, p in enumerate(traj) if bool(p.success)]
            if len(ok_idx) < 3:
                print(f"drone {d}: too few localized frames for ATE")
                continue
            est = np.stack([traj[i].pose.C.cpu().numpy() for i in ok_idx])
            # results[d][i] is frame i + (the frames the bootstrap consumed)
            offset = len(euroc_stamps[d]) - len(traj)
            st = [euroc_stamps[d][i + offset] for i in ok_idx]
            gt_pos = gt_io.groundtruth_at(gt[0], gt[1], st)
            ate, _ = metrics.ate_rmse(est, gt_pos, with_scale=True)
            # frame_ids restricts RPE(1) to consecutive frames: across
            # localization dropouts a row-to-row difference would span gaps
            rpe = (metrics.rpe_translation(est, gt_pos, frame_ids=ok_idx)[0]
                   if len(ok_idx) >= 4 else float("nan"))
            span = float(np.linalg.norm(gt_pos.max(0) - gt_pos.min(0)))
            print(f"drone {d}: ATE={ate * 100:.2f} cm "
                  f"({ate / max(span, 1e-9) * 100:.2f}% of trajectory span), "
                  f"RPE(1)={rpe * 100:.2f} cm over {len(ok_idx)} frames "
                  "(similarity-aligned; monocular scale freed)")
    if live is not None:
        if sys.stdin.isatty():
            print(f"live viz still serving at {live.url} — ctrl-c to exit")
            try:
                while True:
                    time.sleep(1)
            except KeyboardInterrupt:
                pass
        live.close()
    if bus_node is not None:
        bus_node.close()
    if bus_broker is not None:
        bus_broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
