"""Collaborative-localization session (counterpart of coloc_tpu.session).

Reference parity: coloc.hpp class ColoC — mainThread (:96-148) bootstraps
the map from the first frame of each drone (initMap :151), then localizes
every drone every frame (intraPoseEstimator :201) and updates the Kalman
bank.

  intra_all_device_step — the body that coloc_tpu's intra_pose_all, run and
      run_chunked call every frame: a batched frontend over D drones, one
      2-NN of all queries against the resident map bank, the drones'
      localization over a leading drone axis (one P3P launch of D x 256
      samples, one B3 launch, one LM with a done mask per drone), landmark
      support counts, the filter bank update
  ColocSession          — init_map (the two-view bootstrap at D = 2, the
      track-based reconstruction at D > 2, models E, F and H), update_map
      (a rebuild brought to the old map's scale), intra_pose_all,
      intra_pose (the same body at D = 1), inter_pose and
      inter_pose_round (inter-drone relative pose and ICI fusion through
      parallel/mesh.inter_pose_device), the map lifecycle (extend_map,
      merge_map_from, cull_map: host numpy over the ported matchers,
      localization and triangulation), run, and intra_pose_chunk /
      run_chunked, which on the card replay the step, TRIP or AKAZE, as a
      captured CUDA graph (coloc_tpu's lax.scan over the jitted step); run
      and run_chunked fuse every `inter_every` frames and rebuild the map
      every `update_map_every` (whole chunks) or after
      `auto_update_patience` dead frames (chunks), eagerly; run also
      extends the map every `extend_map_every` frames and culls it every
      `cull_map_every`

The host drives the events; tensors stay on the session's device, which is
cuda:0 unless the caller asks for another. RANSAC draws are uniforms from
the session's torch.Generator (seeded by `seed`), turned into minimal
samples on the device; `sample_idx` injects the samples instead (how the
parity tests replay coloc_tpu's jax.random draws).

The captured step (_StepGraphs): the step's tensors live in static
buffers, its RANSAC uniforms are drawn outside the graph into one, the
carried state (filter bank, landmark support, frame) is copied in before a
chunk and out after it, and the graphs are captured again when the map
changes. The pose LM's exit is read once a frame: a head graph runs the
step through LM_GRAPH_STEPS iterations, a middle graph runs LM_GRAPH_STEPS
more while the host sees a lane still active, a tail graph finishes the
frame (the covariance, support, the Kalman update, and what a log row
needs: the unfiltered centre, Euler angles, gate distance and filter
covariance). Any masked iteration changes nothing, so the graphs give the
eager step's bits. On the CPU the chunk runs that step eagerly frame by
frame.

The session's plumbing, wired where coloc_tpu wires it:
  out_dir    — poses.txt, poses_filtered.txt and mahalanobis.txt
      (io/loggers); intra_pose writes its rows at once, intra_pose_all
      and intra_pose_chunk queue the step's outputs on the device and
      flush_logs writes them (close, the context manager, and run /
      run_chunked at 64 queued frames and on exit); inter_pose appends
      guidedmatches2.txt and a fused (dest, src) row; init_map writes
      map.ply
  profile    — a StageProfiler (profiling.py) around each frame step
      (intra_step, intra_step_all, intra_chunk: the replay, never the
      capture), printed as it goes
  debug_dir  — io/svg overlays of init_map's features and pairs, of each
      frame's features and map matches (a second detect-and-match pass in
      intra_pose and intra_pose_all) and of inter_pose's putative and
      guided matches, under coloc_tpu's file names
  viz        — an io/liveviz.LiveViz (or any object with publish_pose /
      publish_map): every frame's filtered poses, and the map after
      init_map, update_map, extend_map, merge_map_from and cull_map
checkpoint.py saves and restores the persistent state.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from coloc_tpu_torch import matching, robust, utils
from coloc_tpu_torch.config import ColocConfig
from coloc_tpu_torch.frontend import detect_and_describe, detect_and_describe_batch
from coloc_tpu_torch.fusion import covint, kalman
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.io import loggers, svg
from coloc_tpu_torch.ops import dispatch, hamming
from coloc_tpu_torch.parallel import mesh
from coloc_tpu_torch.profiling import StageProfiler, span
from coloc_tpu_torch.sfm import ba, localize, reconstruct
from coloc_tpu_torch.types import (Features, MapDB, Matches, Pose, PoseWithCov,
                                   TwoViewGeometry)

# LM iterations between two host reads of a loop's exit, chosen by
# measurement (scripts/prof_torch_loop_exit.py, PERF.md §6): the eager pose
# LM and the bootstrap's BA and Gauss-Newton read theirs every iteration (a
# read costs less than a masked iteration's ~100 launches); the captured
# step's head and middle graphs run LM_GRAPH_STEPS iterations each (the
# pose LM mostly stops at its third)
LM_CHECK_EVERY = 1
BOOTSTRAP_CHECK_EVERY = 1
LM_GRAPH_STEPS = 3


class _Frame(NamedTuple):
    """What a frame's LM and tail read of its head: D drones' 2D-3D
    correspondences, the RANSAC result, the map matches."""

    X: torch.Tensor          # (D, K, 3)
    uv: torch.Tensor         # (D, K, 2)
    inliers: torch.Tensor    # (D, K) bool, RANSAC's
    n_inliers: torch.Tensor  # (D,) int32
    success: torch.Tensor    # (D,) bool
    idx: torch.Tensor        # (D, K) int32 map slot, -1 if rejected
    matched: torch.Tensor    # (D, K) bool


def _match_drones(cfg: ColocConfig, feats: Features, bank: hamming.Bank) -> Matches:
    """D drones' features (D, K, ...) against the resident map bank in one
    2-NN -> Matches (D, K): match_with_map of each drone."""
    D, kp = feats.valid.shape
    qv = feats.valid.reshape(-1)
    idx, best, second = hamming.hamming_2nn_bank(feats.desc.reshape(D * kp, -1), qv, bank)
    m = matching._accept(idx, best, second, qv, cfg.matcher, cfg.matcher.margin_threshold)
    return Matches(*(t.reshape(D, kp) for t in m))


def _step_head(cfg: ColocConfig, images, mapdb: MapDB, bank: hamming.Bank, Ks, dists,
               generator=None, sample_idx=None, uniforms=None
               ) -> Tuple[_Frame, ba.PoseLM]:
    """Detect, match and P3P-RANSAC D drones' frames (D, H, W) -> the frame
    and the pose LM's initial state."""
    feats = detect_and_describe_batch(images, cfg.detector)
    mm = _match_drones(cfg, feats, bank)
    X, uv, corr = localize.correspondences(feats, mm, mapdb)
    pose0, inl, n_inl, ok = robust.absolute_pose_p3p(
        X, uv, corr, Camera(K=Ks, dist=dists), cfg.ransac, generator=generator,
        sample_idx=sample_idx, uniforms=uniforms)
    return (_Frame(X, uv, inl, n_inl, ok, mm.idx, mm.mask),
            ba.pose_lm_init(pose0.R, pose0.C))


def _step_lm(cfg: ColocConfig, frame: _Frame, lm: ba.PoseLM, Ks, dists, n: int) -> ba.PoseLM:
    return ba.pose_lm_steps(lm, frame.X, frame.uv, frame.inliers, Ks, dists,
                            cfg.refiner, n)


def _step_tail(cfg: ColocConfig, frame: _Frame, lm: ba.PoseLM, Ks, dists, L: int
               ) -> Tuple[PoseWithCov, torch.Tensor]:
    """The LM's covariance and rmse -> (PoseWithCov (D, ...), sup_inc (L,)
    int32): one count per (drone, landmark) refinement inlier of a drone
    whose localization succeeded; non-hits go to slot L, dropped."""
    res = ba.pose_lm_finish(lm, frame.X, frame.uv, frame.inliers, Ks, dists,
                            cfg.refiner)
    pwcs = localize.finish(res, frame.n_inliers, frame.success)
    hit = frame.inliers & frame.matched & pwcs.success[:, None]
    slot = torch.where(hit, frame.idx, L).reshape(-1).to(torch.int64)
    sup_inc = torch.zeros(L + 1, dtype=torch.int32, device=slot.device)
    sup_inc = sup_inc.scatter_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))[:L]
    return pwcs, sup_inc


def _filter_all(cfg: ColocConfig, pwcs: PoseWithCov, fb: kalman.FilterBank):
    """-> (fb', filtered, gate distances, rejected, eulers) of every drone."""
    zs = kalman.fill_measurement(pwcs.pose)
    fb, filtered, dist_g, rej = kalman.update_all(
        fb, zs, pwcs.cov[:, 3:6, 3:6], pwcs.rmse, pwcs.success, cfg.filter)
    return fb, filtered, dist_g, rej, so3.rot_to_euler(pwcs.pose.R)


def _support(lm_support, lm_last_seen, sup_inc, frame):
    """Landmark support after a frame: the career inlier count and the
    frame (an int or a () int32 tensor) of the last inlier."""
    return (lm_support + sup_inc,
            torch.where(sup_inc > 0, frame, lm_last_seen).to(torch.int32))


def intra_all_device_step(
    cfg: ColocConfig,
    images: torch.Tensor,                 # (D, H, W)
    mapdb: MapDB,
    bank: hamming.Bank,                   # resident bank of mapdb
    Ks: torch.Tensor,                     # (D, 3, 3)
    dists: torch.Tensor,                  # (D, 3)
    fb: kalman.FilterBank,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (D, B, 3)
    uniforms: Optional[torch.Tensor] = None,     # (D, B, 3)
    check_every: int = LM_CHECK_EVERY,
):
    """All drones' frame step -> (pwcs, fb', filtered, gate_dist, rej,
    eulers, sup_inc), each with a leading drone axis except sup_inc, the
    (L,) int32 count of drones that used each landmark as a refinement
    inlier this frame. `generator` draws the RANSAC samples, or `uniforms`
    are the uniforms to draw them with; `sample_idx` injects them instead
    (parity tests). The host reads the pose LM's exit every `check_every`
    iterations; check_every = refiner.max_iterations reads nothing."""
    frame, lm = _step_head(cfg, images, mapdb, bank, Ks, dists, generator,
                           sample_idx, uniforms)
    lm = ba.pose_lm_run(lm, frame.X, frame.uv, frame.inliers, Ks, dists,
                        cfg.refiner, check_every)
    pwcs, sup_inc = _step_tail(cfg, frame, lm, Ks, dists, mapdb.X.shape[0])
    fb, filtered, dist_g, rej, eulers = _filter_all(cfg, pwcs, fb)
    return pwcs, fb, filtered, dist_g, rej, eulers, sup_inc


class _ChunkOut(NamedTuple):
    """A step's per-frame outputs, (D, ...) each, (F, D, ...) over a chunk:
    the filtered pose and what a log row reads besides."""

    R: torch.Tensor         # filtered rotation
    C: torch.Tensor         # filtered centre
    cov: torch.Tensor       # (6, 6) localization covariance
    rmse: torch.Tensor
    n_tracks: torch.Tensor
    success: torch.Tensor
    rejected: torch.Tensor  # the Kalman gate rejected the measurement
    raw_C: torch.Tensor     # unfiltered (localized) centre
    eulers: torch.Tensor    # (3,) Euler angles of the unfiltered rotation
    dist_g: torch.Tensor    # the gate's distance
    P: torch.Tensor         # (6, 6) filter covariance after the update


def _chunk_out(pwcs: PoseWithCov, filtered: Pose, rej, dist_g, eulers, P) -> _ChunkOut:
    return _ChunkOut(filtered.R, filtered.C, pwcs.cov, pwcs.rmse, pwcs.n_tracks,
                     pwcs.success, rej, pwcs.pose.C, eulers, dist_g, P)


class _StepGraphs:
    """The frame step of a session captured as CUDA graphs over static
    buffers, for the session's current map: a head graph (the step through
    LM_GRAPH_STEPS LM iterations), a middle graph (LM_GRAPH_STEPS more,
    replayed while the host reads a lane still active) and a tail graph
    (the covariance, support and Kalman update, the carried state written
    in place). `inject`: the static draws are minimal samples (int64 (D,
    B, 3)) instead of uniforms."""

    def __init__(self, sess: "ColocSession", inject: bool = False):
        cfg = sess.config
        dev = sess.device
        D, B = cfg.num_drones, cfg.ransac.num_hypotheses
        self.cfg, self.inject = cfg, inject
        self.lm_steps = LM_GRAPH_STEPS        # LM iterations a head or middle graph
        self.mapdb, self.bank = sess.mapdb, sess._map_bank()
        self.Ks, self.dists = sess.Ks, sess.dists
        self.images = torch.zeros((D, cfg.detector.height, cfg.detector.width), device=dev)
        self.draws = torch.zeros((D, B, 3), device=dev,
                                 dtype=torch.int64 if inject else torch.float32)
        self.fb = kalman.FilterBank(*(t.clone() for t in sess.filter_bank))
        self.sup = sess.lm_support.clone()
        self.last = sess.lm_last_seen.clone()
        self.frame = torch.zeros((), dtype=torch.int32, device=dev)
        self.host_reads = 0                    # host reads of the LM exit so far
        t0 = time.perf_counter()
        try:
            # the head's outputs are the static state the middle and the
            # tail graphs read
            head, (self.frame_t, self.lm), rec_h = self._graph(self._head)
            middle, _, rec_m = self._graph(self._middle)
            tail, self.out, rec_t = self._graph(self._tail)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the frame step as a CUDA graph failed: {e}") from e
        self.graphs, self.records = (head, middle, tail), (rec_h, rec_m, rec_t)
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0

    def _head(self):
        kw = {"sample_idx" if self.inject else "uniforms": self.draws}
        frame, lm = _step_head(self.cfg, self.images, self.mapdb, self.bank, self.Ks,
                               self.dists, **kw)
        return frame, _step_lm(self.cfg, frame, lm, self.Ks, self.dists, self.lm_steps)

    def _middle(self):
        lm = _step_lm(self.cfg, self.frame_t, self.lm, self.Ks, self.dists, self.lm_steps)
        for old, new in zip(self.lm, lm):
            old.copy_(new)

    def _tail(self) -> _ChunkOut:
        pwcs, sup_inc = _step_tail(self.cfg, self.frame_t, self.lm, self.Ks, self.dists,
                                   self.mapdb.X.shape[0])
        fb, filtered, dist_g, rej, eulers = _filter_all(self.cfg, pwcs, self.fb)
        sup, last = _support(self.sup, self.last, sup_inc, self.frame)
        for old, new in zip(self.fb, fb):
            old.copy_(new)
        self.sup.copy_(sup)
        self.last.copy_(last)
        self.frame.add_(1)
        return _chunk_out(pwcs, filtered, rej, dist_g, eulers, fb.P)

    @staticmethod
    def _graph(fn, warmup: int = 2):
        """Warm fn up on a side stream (caches, library handles), then
        capture it. -> (graph, fn's output, its launch record)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        try:        # kept, so that node_count can read it
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:
            graph = torch.cuda.CUDAGraph()
        record: Dict[str, int] = {}
        with dispatch.counted_capture(record), torch.cuda.graph(graph):
            out = fn()
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        return graph, out, record

    def load(self, sess: "ColocSession") -> None:
        """Copy the session's carried state into the static buffers."""
        for old, new in zip(self.fb, sess.filter_bank):
            old.copy_(new)
        self.sup.copy_(sess.lm_support)
        self.last.copy_(sess.lm_last_seen)
        self.frame.fill_(sess.frame)

    def replay(self, images, draws) -> _ChunkOut:
        """One frame: images (D, H, W) and its draws -> the frame's
        outputs, copied out of the static buffers."""
        with span("coloc.session.step"):
            self.images.copy_(images)
            self.draws.copy_(draws)
            head, middle, tail = self.graphs
            with span("coloc.session.replay.head"):
                head.replay()
            dispatch.count_replay(self.records[0])
            its = self.lm_steps
            while its < self.cfg.refiner.max_iterations:
                self.host_reads += 1
                with span("coloc.lm.exit_read"):
                    active = bool(self.lm.active.any())
                if not active:
                    break
                with span("coloc.session.replay.middle"):
                    middle.replay()
                dispatch.count_replay(self.records[1])
                its += self.lm_steps
            with span("coloc.session.replay.tail"):
                tail.replay()
            dispatch.count_replay(self.records[2])
            return _ChunkOut(*(t.clone() for t in self.out))

    def node_count(self) -> Optional[int]:
        """Nodes of the head and tail graphs (a frame replays each once),
        from the driver's cuGraphGetNodes; None where this PyTorch does not
        hand out the raw graph."""
        return graph_nodes(self.graphs[0], self.graphs[2])


def graph_nodes(*graphs) -> Optional[int]:
    """Nodes of captured torch.cuda.CUDAGraphs (made with keep_graph=True),
    from the driver's cuGraphGetNodes; None where this PyTorch does not hand
    out the raw graph."""
    total = 0
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        for g in graphs:
            n = ctypes.c_size_t(0)
            if lib.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                                   ctypes.byref(n)) != 0:
                return None
            total += n.value
    except (AttributeError, OSError, RuntimeError):
        return None
    return total


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _cov6(P: np.ndarray) -> np.ndarray:
    """A filter covariance (x, y, z, angles) in the logged (w, dC) order."""
    cov6 = np.zeros((6, 6))
    cov6[:3, :3] = P[3:6, 3:6]
    cov6[3:6, 3:6] = P[:3, :3]
    return cov6


class ColocSession:
    """One collaborative-localization session over D drones (class ColoC).

    Attributes as coloc_tpu's: map_ready, mapdb, scene, filter_bank,
    last_pose, frame, lm_support, lm_last_seen, viz, profiler, debug_dir,
    out_dir and its loggers; plus bootstrap_geo and bootstrap_ba, the
    bootstrap's TwoViewGeometry (of the seed pair) and BAResult,
    bootstrap_views, the drone of each scene row (row 0's camera is the
    world frame), and last_rejected, the (D,) gate rejections of the last
    frame. `generator` draws the RANSAC samples (seeded by `seed`)."""

    def __init__(self, config: ColocConfig, Ks, dists, out_dir: str = "",
                 seed: int = 0, profile: bool = False, viz=None,
                 debug_dir: str = "", device=None):
        self.config = config
        self.device = dispatch.default_device(device)
        D = config.num_drones
        self.Ks = torch.as_tensor(np.asarray(Ks, np.float32), device=self.device)
        self.dists = torch.as_tensor(np.asarray(dists, np.float32),
                                     device=self.device)
        self.cams = [Camera(K=self.Ks[d], dist=self.dists[d]) for d in range(D)]
        self.filter_bank = kalman.init(D, config.filter, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.mapdb: Optional[MapDB] = None
        self.scene: Optional[reconstruct.Scene] = None
        self.bootstrap_geo: Optional[TwoViewGeometry] = None
        self.bootstrap_ba = None
        self.bootstrap_views: Optional[list] = None
        self.last_rejected: Optional[torch.Tensor] = None
        self.map_ready = False
        self.frame = 0
        self.last_pose: Dict[int, PoseWithCov] = {}
        # landmark support: career inlier count and frame of the last inlier
        # per map slot, (re)built by _ensure_support
        self.lm_support: Optional[torch.Tensor] = None
        self.lm_last_seen: Optional[torch.Tensor] = None
        self._bank = None
        self._bank_src = None
        self._graphs: Optional[_StepGraphs] = None   # intra_pose_chunk's
        # queued log entries (frame, _ChunkOut of D drones), on the device
        # until flush_logs
        self._pending_logs: list = []
        # the live view (io/liveviz.LiveViz, the rosUtils.hpp publisher's
        # analog); nothing is published when None
        self.viz = viz
        # per-stage spans around each frame step (coloc.hpp:113-144's chrono
        # prints), synchronised with the session's device
        self.profiler = StageProfiler(enabled=profile, printer=print if profile else None,
                                      device=self.device)
        # the reference's #ifdef DEBUG overlays (coloc.hpp:153-159, 171-176,
        # 189-192, 203-209, 232-239, 298-300): an inspection mode that costs a
        # second detect-and-match pass a frame
        self.debug_dir = debug_dir
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.pose_log = loggers.PoseLogger(os.path.join(out_dir, "poses.txt"))
            self.filtered_log = loggers.PoseLogger(
                os.path.join(out_dir, "poses_filtered.txt"))
            self.gate_log = loggers.GateLogger(os.path.join(out_dir, "mahalanobis.txt"))
        else:
            self.pose_log = self.filtered_log = self.gate_log = None

    # ------------------------------------------------ logs, overlays, view
    def _debug_features(self, name: str, image, feats: Features,
                        color: str = "green") -> None:
        """drawFeatures-parity overlay (coloc.hpp:153-159 / :203-209)."""
        if self.debug_dir:
            svg.draw_features(os.path.join(self.debug_dir, name), _host(image),
                              _host(feats.xy), _host(feats.valid), color=color)

    def _debug_matches(self, name: str, img1, img2, xy1, xy2, idx, mask,
                       color: str = "yellow") -> None:
        """drawMatches-parity overlay (coloc.hpp:171-176 / :189-192 /
        :232-239 / :298-300)."""
        if self.debug_dir:
            svg.draw_matches(os.path.join(self.debug_dir, name), _host(img1), _host(img2),
                             _host(xy1), _host(xy2), _host(idx), _host(mask), color=color)

    def _debug_intra(self, drone: int, image) -> None:
        """A frame's overlays: its features and its accepted map matches
        (coloc.hpp:203-209, 232-239), from a second detect-and-match pass
        (the step keeps both on the device)."""
        if not self.debug_dir:
            return
        feats = self.detect(image)
        self._debug_features(f"frame{self.frame:04d}_d{drone}_features.svg", image, feats)
        mm = matching.match_with_map(feats, self.mapdb, self.config.matcher,
                                     bank=self._map_bank())
        self._debug_features(f"frame{self.frame:04d}_d{drone}_map_matches.svg", image,
                             feats._replace(valid=mm.mask), color="red")

    def _publish_map(self) -> None:
        if self.viz is not None:
            self.viz.publish_map(_host(self.mapdb.X), _host(self.mapdb.valid))

    def _publish_poses(self, frame: int, out: _ChunkOut) -> None:
        """Each drone's filtered centre, filter position covariance and
        success of one frame's outputs (D, ...) to the live view."""
        if self.viz is None:
            return
        C, P, ok = _host(out.C), _host(out.P), _host(out.success)
        for d in range(C.shape[0]):
            self.viz.publish_pose(d, C[d], cov3=P[d, :3, :3], success=bool(ok[d]),
                                  frame=frame)

    def _logging(self) -> bool:
        return bool(self.pose_log or self.filtered_log or self.gate_log)

    def flush_logs(self) -> None:
        """Write the queued log entries (intra_pose_all, intra_pose_chunk):
        one copy of each output field to the host for all of them."""
        pending, self._pending_logs = self._pending_logs, []
        if not pending:
            return
        outs = _ChunkOut(*(torch.stack(v).cpu() for v in zip(*(o for _, o in pending))))
        filt_eulers = so3.rot_to_euler(outs.R).numpy()
        o = _ChunkOut(*(t.numpy() for t in outs))
        for i, (frame, _) in enumerate(pending):
            for d in range(o.C.shape[1]):
                if self.pose_log:
                    self.pose_log.log(frame, d, d, o.raw_C[i, d], o.cov[i, d], o.eulers[i, d],
                                      o.rmse[i, d], o.n_tracks[i, d])
                if self.gate_log:
                    self.gate_log.log(d, o.dist_g[i, d])
                if self.filtered_log:
                    self.filtered_log.log(frame, d, d, o.C[i, d], _cov6(o.P[i, d]),
                                          filt_eulers[i, d], o.rmse[i, d], o.n_tracks[i, d])

    def close(self) -> None:
        """Flush the queued log entries. Safe to call again; a session used
        as a context manager flushes on exit."""
        self.flush_logs()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _image(self, image) -> torch.Tensor:
        if isinstance(image, torch.Tensor):
            return image.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(image, np.float32), device=self.device)

    def _draw(self, drones: int) -> torch.Tensor:
        """A frame's RANSAC uniforms, (drones, B, 3), from the session's
        generator."""
        return torch.rand((drones, self.config.ransac.num_hypotheses, 3),
                          generator=self.generator, device=self.device)

    def detect(self, image) -> Features:
        return detect_and_describe(self._image(image), self.config.detector)

    def init_map(self, images, sample_idx=None,
                 resection_idx: Optional[list] = None) -> bool:
        """Bootstrap the shared map from one frame of every drone
        (ColoC::initMap, coloc.hpp:151-199), with the geometric model
        config.model ('E', 'F' or 'H'). Two drones: detect, match the
        pair, AC-RANSAC, triangulate, full BA with drone 0's pose fixed;
        `sample_idx` (256, S) injects the pair's minimal samples. More
        drones: every pair of utils.exhaustive_pairs matched and its
        relative pose estimated, the successful pairs into
        reconstruct.reconstruct_scene (tracks, seed pair, P3P resection,
        BA); `sample_idx` is then a dict (a, b) -> (256, S) and
        `resection_idx` a list of (256, 3) P3P draws, one per resection.
        False if no geometry succeeds or fewer than 8 landmarks survive;
        the map is then left as it was."""
        cfg = self.config
        D = cfg.num_drones
        if D < 2:
            raise ValueError(f"init_map needs two drones or more, not {D}")
        feats = {d: self.detect(images[d]) for d in range(D)}
        for d in range(D):
            self._debug_features(f"init_features_d{d}.svg", images[d], feats[d])
        if D > 2:
            return self._init_map_multiview(images, feats, sample_idx or {}, resection_idx)
        f0, f1 = feats[0], feats[1]
        m = matching.match_pair(f0, f1, cfg.matcher)
        geo = robust.relative_pose(
            cfg.model, f0.xy, f1.xy[m.idx.long()], m.mask, self.cams[0], self.cams[1],
            cfg.ransac, generator=self.generator, sample_idx=sample_idx,
            check_every=BOOTSTRAP_CHECK_EVERY)
        self._debug_pair(images, feats, 0, 1, m, geo)
        if not bool(geo.success):
            return False
        origin = Pose(R=torch.eye(3, device=self.device),
                      C=torch.zeros(3, device=self.device))
        scene = reconstruct.two_view_scene(
            f0, f1, m, geo.inliers, geo.R, geo.t, origin, cfg.scale,
            self.cams[0], self.cams[1], num_landmarks=cfg.max_landmarks)
        scene, ba_res = reconstruct.refine_scene(
            scene, self.Ks[:2], self.dists[:2], cfg.refiner,
            fix_pose=torch.tensor([True, False], device=self.device),
            check_every=BOOTSTRAP_CHECK_EVERY)
        return self._set_map(scene, geo, ba_res, [0, 1])

    def _debug_pair(self, images, feats, a: int, b: int, m: Matches,
                    geo: TwoViewGeometry) -> None:
        """A bootstrap pair's putative and inlier matches."""
        if self.debug_dir:
            self._debug_matches(f"init_putative_{a}_{b}.svg", images[a], images[b],
                                feats[a].xy, feats[b].xy, m.idx, m.mask)
            self._debug_matches(f"init_inlier_{a}_{b}.svg", images[a], images[b],
                                feats[a].xy, feats[b].xy, m.idx, m.mask & geo.inliers,
                                color="lime")

    def _init_map_multiview(self, images, feats: Dict[int, Features], pair_idx: dict,
                            resection_idx: Optional[list]) -> bool:
        """init_map for D > 2 (coloc_tpu's reconstruct_scene branch)."""
        cfg = self.config
        pair_matches, pair_geo = {}, {}
        for a, b in utils.exhaustive_pairs(cfg.num_drones):
            m = matching.match_pair(feats[a], feats[b], cfg.matcher)
            geo = robust.relative_pose(
                cfg.model, feats[a].xy, feats[b].xy[m.idx.long()], m.mask,
                self.cams[a], self.cams[b], cfg.ransac, generator=self.generator,
                sample_idx=pair_idx.get((a, b)), check_every=BOOTSTRAP_CHECK_EVERY)
            self._debug_pair(images, feats, a, b, m, geo)
            if bool(geo.success):
                pair_matches[(a, b)], pair_geo[(a, b)] = m, geo
        if not pair_geo:
            return False
        scene, ba_res, views = reconstruct.reconstruct_scene(
            [feats[d] for d in range(cfg.num_drones)], pair_matches, pair_geo,
            self.cams, self.Ks, self.dists, cfg.scale, cfg.max_landmarks,
            cfg.refiner, cfg.ransac, generator=self.generator,
            resection_idx=resection_idx, check_every=BOOTSTRAP_CHECK_EVERY)
        return self._set_map(scene, pair_geo[tuple(views[:2])], ba_res, views)

    def _set_map(self, scene: reconstruct.Scene, geo: TwoViewGeometry, ba_res,
                 views: list) -> bool:
        """Make a bootstrapped scene the session's map, unless fewer than 8
        landmarks survived (then False, the old map kept); publish it and
        write map.ply."""
        if int(scene.X_valid.sum()) < 8:
            return False
        self.scene = scene
        self.bootstrap_geo, self.bootstrap_ba = geo, ba_res
        self.bootstrap_views = views
        self.mapdb = reconstruct.scene_to_mapdb(scene)
        self.map_ready = True
        # a wholesale (re)build: every slot is a fresh landmark
        self.lm_support = None
        self.lm_last_seen = None
        self._publish_map()
        if self.out_dir:
            loggers.write_ply(os.path.join(self.out_dir, "map.ply"), _host(scene.X),
                              _host(scene.X_valid), _host(scene.Cs))
        return True

    def update_map(self, images, sample_idx=None,
                   resection_idx: Optional[list] = None) -> bool:
        """Rebuild the map from the current frames and bring it to the old
        map's scale (ColoC::updateMap, coloc.hpp:394-459): init_map, then
        match_maps of the new map against the old; with 2 common landmarks
        or more, the new map (landmarks and camera centres) is divided by
        utils.compute_scale_difference. The draws are init_map's. False if
        the rebuild failed (the old map kept)."""
        old_db = self.mapdb
        ok = self.init_map(images, sample_idx, resection_idx)
        if not ok or old_db is None:
            return ok
        mm = matching.match_maps(self.mapdb, old_db, self.config.matcher)
        if int((mm.mask & self.mapdb.valid).sum()) >= 2:
            scale = utils.compute_scale_difference(self.mapdb, old_db, mm)
            X, Cs = utils.rescale_map(self.scene.X, self.scene.Cs,
                                      1.0 / torch.clamp(scale, min=1e-6))
            self.scene = self.scene._replace(X=X, Cs=Cs)
            self.mapdb = reconstruct.scene_to_mapdb(self.scene)
        self._publish_map()
        return True

    def _map_bank(self) -> hamming.Bank:
        """The resident map bank, rebuilt when the map changes."""
        if self._bank_src is not self.mapdb:
            self._bank = matching.pack_map_bank(self.mapdb)
            self._bank_src = self.mapdb
        return self._bank

    def _ensure_support(self) -> None:
        """(Re)build the support arrays when absent or when the map changed
        capacity: valid slots start at zero support with lm_last_seen =
        the current frame, free slots at -1."""
        L = self.mapdb.X.shape[0]
        if self.lm_support is None or self.lm_support.shape[0] != L:
            self.lm_support = torch.zeros(L, dtype=torch.int32, device=self.device)
            self.lm_last_seen = torch.where(
                self.mapdb.valid, self.frame, -1).to(torch.int32)

    def _finish_frame(self, pwcs, fb, filtered, rej, sup_inc) -> Dict[int, PoseWithCov]:
        """Carry a step's state into the session -> dict drone ->
        PoseWithCov (the filtered pose)."""
        self.filter_bank = fb
        self.last_rejected = rej
        self.lm_support, self.lm_last_seen = _support(
            self.lm_support, self.lm_last_seen, sup_inc, self.frame)
        out = {}
        for d in range(self.config.num_drones):
            out[d] = PoseWithCov(
                pose=Pose(R=filtered.R[d], C=filtered.C[d]), cov=pwcs.cov[d],
                rmse=pwcs.rmse[d], n_tracks=pwcs.n_tracks[d],
                success=pwcs.success[d])
            self.last_pose[d] = out[d]
        return out

    def intra_pose_all(self, images, sample_idx: Optional[torch.Tensor] = None
                       ) -> Dict[int, PoseWithCov]:
        """Localize every drone in one step: dict drone -> PoseWithCov with
        the filtered pose, the covariance, rmse, n_tracks and success.
        `sample_idx` (D, 256, 3): injected P3P draws. The log rows are
        queued: call flush_logs or close (run and run_chunked do) before
        reading the files."""
        D = self.config.num_drones
        for d in range(D):
            self._debug_intra(d, images[d])
        imgs = torch.stack([self._image(images[d]) for d in range(D)])
        self._ensure_support()
        with self.profiler.stage("intra_step_all"):
            pwcs, fb, filtered, dist_g, rej, eulers, sup_inc = intra_all_device_step(
                self.config, imgs, self.mapdb, self._map_bank(), self.Ks, self.dists,
                self.filter_bank, sample_idx=sample_idx,
                uniforms=None if sample_idx is not None else self._draw(D))
        res = self._finish_frame(pwcs, fb, filtered, rej, sup_inc)
        out = _chunk_out(pwcs, filtered, rej, dist_g, eulers, fb.P)
        # the rows wait on the device until flush_logs: writing them now
        # would read the frame's outputs on the host every frame
        if self._logging():
            self._pending_logs.append((self.frame, out))
        self._publish_poses(self.frame, out)
        return res

    def intra_pose(self, drone: int, image,
                   sample_idx: Optional[torch.Tensor] = None) -> PoseWithCov:
        """One drone's frame (intraPoseEstimator, coloc.hpp:201-271): the
        step's body at D = 1, then kalman.update of that drone's filter.
        Returns the filtered pose with the covariance, rmse, n_tracks and
        success; its log rows are written at once. `sample_idx` (256, 3):
        injected P3P draws."""
        cfg = self.config
        self._debug_intra(drone, image)
        self._ensure_support()
        d = slice(drone, drone + 1)
        with self.profiler.stage("intra_step"):
            frame, lm = _step_head(
                cfg, self._image(image)[None], self.mapdb, self._map_bank(), self.Ks[d],
                self.dists[d], sample_idx=None if sample_idx is None else sample_idx[None],
                uniforms=None if sample_idx is not None else self._draw(1))
            lm = ba.pose_lm_run(lm, frame.X, frame.uv, frame.inliers, self.Ks[d],
                                self.dists[d], cfg.refiner, LM_CHECK_EVERY)
            pwcs, sup_inc = _step_tail(cfg, frame, lm, self.Ks[d], self.dists[d],
                                       self.mapdb.X.shape[0])
            self.filter_bank, filtered, dist, _ = kalman.update(
                self.filter_bank, drone, kalman.fill_measurement(pwcs.pose)[0],
                pwcs.cov[0, 3:6, 3:6], pwcs.rmse[0], pwcs.success[0], cfg.filter)
        self.lm_support, self.lm_last_seen = _support(
            self.lm_support, self.lm_last_seen, sup_inc, self.frame)
        result = PoseWithCov(pose=filtered, cov=pwcs.cov[0], rmse=pwcs.rmse[0],
                             n_tracks=pwcs.n_tracks[0], success=pwcs.success[0])
        self.last_pose[drone] = result
        if self._logging() or self.viz is not None:
            P = _host(self.filter_bank.P[drone])
            rmse, n_tracks = float(pwcs.rmse[0]), int(pwcs.n_tracks[0])
        if self.pose_log:
            self.pose_log.log(self.frame, drone, drone, _host(pwcs.pose.C[0]),
                              _host(pwcs.cov[0]), _host(so3.rot_to_euler(pwcs.pose.R[0])),
                              rmse, n_tracks)
        if self.gate_log:
            self.gate_log.log(drone, float(dist))
        if self.filtered_log:
            self.filtered_log.log(self.frame, drone, drone, _host(filtered.C), _cov6(P),
                                  _host(so3.rot_to_euler(filtered.R)), rmse, n_tracks)
        if self.viz is not None:
            self.viz.publish_pose(drone, _host(filtered.C), cov3=P[:3, :3],
                                  success=bool(pwcs.success[0]), frame=self.frame)
        return result

    def _captures(self) -> bool:
        """Whether intra_pose_chunk replays a captured graph: on the card."""
        return self.device.type == "cuda"

    def _step_graphs(self, inject: bool) -> _StepGraphs:
        """The captured step for the current map and draw kind, captured
        again when the map (and so its bank) changed."""
        g = self._graphs
        if g is None or g.mapdb is not self.mapdb or g.inject != inject:
            self._graphs = None    # free the old graphs' memory first
            self._graphs = _StepGraphs(self, inject)
        return self._graphs

    def intra_pose_chunk(self, images, sample_idx: Optional[torch.Tensor] = None
                         ) -> Dict[int, list]:
        """An (F, D, H, W) chunk of frames -> dict drone -> [PoseWithCov per
        frame] (coloc_tpu's lax.scan over the all-drones step, the filter
        bank and landmark support carried from frame to frame); self.frame
        advances by F. On a CUDA device the step replays as a captured CUDA
        graph (a capture that fails raises); on the CPU it runs eagerly
        frame by frame. `sample_idx` (F, D, 256, 3): injected P3P draws.
        The log rows are queued, as intra_pose_all's, and the live view
        gets every frame. Spans (profiling.span): `coloc.session.chunk`
        over the call, holding `.inputs`, a `.step` a frame and
        `.outputs`."""
        with span("coloc.session.chunk"):
            return self._intra_pose_chunk(images, sample_idx)

    def _intra_pose_chunk(self, images, sample_idx: Optional[torch.Tensor]) -> Dict[int, list]:
        cfg = self.config
        D = cfg.num_drones
        captures = self._captures()
        with span("coloc.session.inputs"):
            imgs = self._image(images)
            F = imgs.shape[0]
            self._ensure_support()
            if captures:
                # captured (or found) before the stage: a stage never sits
                # inside a capture
                g = self._step_graphs(sample_idx is not None)
                draws = (sample_idx.to(device=self.device, dtype=torch.int64)
                         if sample_idx is not None
                         else torch.stack([self._draw(D) for _ in range(F)]))
                g.load(self)
        frame0 = self.frame
        if not captures:    # the plain path: eager, frame by frame
            outs = []
            with self.profiler.stage("intra_chunk"):
                for f in range(F):
                    with span("coloc.session.step"):
                        self.frame = frame0 + f
                        pwcs, fb, filtered, dist_g, rej, eulers, sup_inc = intra_all_device_step(
                            cfg, imgs[f], self.mapdb, self._map_bank(), self.Ks, self.dists,
                            self.filter_bank,
                            sample_idx=None if sample_idx is None else sample_idx[f],
                            uniforms=None if sample_idx is not None else self._draw(D))
                        self._finish_frame(pwcs, fb, filtered, rej, sup_inc)
                        outs.append(_chunk_out(pwcs, filtered, rej, dist_g, eulers, fb.P))
        else:
            with self.profiler.stage("intra_chunk"):
                outs = [g.replay(imgs[f], draws[f]) for f in range(F)]
        with span("coloc.session.outputs"):
            res = _ChunkOut(*(torch.stack(v) for v in zip(*outs)))
            if captures:
                self.filter_bank = kalman.FilterBank(*(t.clone() for t in g.fb))
                self.lm_support, self.lm_last_seen = g.sup.clone(), g.last.clone()
                self.last_rejected = res.rejected[-1]
            if self._logging():
                self._pending_logs.extend(
                    (frame0 + f, _ChunkOut(*(t[f] for t in res))) for f in range(F))
            for f in range(F):
                self._publish_poses(frame0 + f, _ChunkOut(*(t[f] for t in res)))
            out = {d: [] for d in range(D)}
            for f in range(F):
                for d in range(D):
                    out[d].append(PoseWithCov(
                        pose=Pose(R=res.R[f, d], C=res.C[f, d]), cov=res.cov[f, d],
                        rmse=res.rmse[f, d], n_tracks=res.n_tracks[f, d],
                        success=res.success[f, d]))
            for d in range(D):
                self.last_pose[d] = out[d][-1]
            self.frame = frame0 + F
        return out

    def inter_pose_round(self, images, policy: str = "auto"
                         ) -> Dict[int, Optional[covint.FusionResult]]:
        """One inter-drone fusion round over all drones: dict dst ->
        FusionResult or None. The reference fuses (0, 1) for its two-drone
        demo (coloc.hpp:141); as in coloc_tpu the pairs follow `policy`:
          - "auto": D = 2 -> "reference", the single (0, 1); D > 2 -> "ring";
          - "ring": every drone d fused with partner (d - 1) mod D;
          - "best": every drone fused with the other drone whose intra
            position covariance has the smallest trace.
        Each drone's features are detected once and shared by the round's
        pairs."""
        D = self.config.num_drones
        if D < 2:
            return {}
        if policy == "auto":
            policy = "reference" if D == 2 else "ring"
        if policy == "reference":
            pairs = [(0, 1)]
        elif policy == "ring":
            pairs = [((d - 1) % D, d) for d in range(D)]
        elif policy == "best":
            traces = {d: float(torch.trace(self.last_pose[d].cov[3:6, 3:6]))
                      if d in self.last_pose else float("inf") for d in range(D)}
            pairs = [(min((d for d in range(D) if d != dst), key=lambda d: traces[d]), dst)
                     for dst in range(D)]
        else:
            raise ValueError(f"unknown inter-pose policy {policy!r}")
        feats = {d: self.detect(images[d]) for d in range(D)}
        return {dst: self.inter_pose(src, dst, images, feats=feats) for src, dst in pairs}

    def inter_pose(self, src: int, dst: int, images,
                   feats: Optional[Dict[int, Features]] = None,
                   sample_idx: Optional[torch.Tensor] = None
                   ) -> Optional[covint.FusionResult]:
        """Inter-drone relative localization and ICI fusion of drone `dst`
        with partner `src` (interPoseEstimator, coloc.hpp:274-392) through
        mesh.inter_pose_device. None where either drone has no pose yet or
        the fusion failed; the result is returned, not written into the
        filter bank. `feats`: detected features to reuse, by drone.
        `sample_idx` (256, 5): injected five-point draws (coloc_tpu's
        `key`); otherwise the session's generator draws them. With out_dir
        a fusion appends its guided residuals to guidedmatches2.txt and a
        (dest, src) row to poses_filtered.txt."""
        if src not in self.last_pose or dst not in self.last_pose:
            return None
        feats = feats or {}
        f_src = feats[src] if src in feats else self.detect(images[src])
        f_dst = feats[dst] if dst in feats else self.detect(images[dst])
        if self.debug_dir:
            # the pair's putative matches (coloc.hpp:298-300), recomputed: the
            # fused core keeps them on the device
            m_dbg = matching.match_pair(f_src, f_dst, self.config.matcher)
            self._debug_matches(f"inter{self.frame:04d}_s{src}_d{dst}_putative.svg",
                                images[src], images[dst], f_src.xy, f_dst.xy, m_dbg.idx,
                                m_dbg.mask)
        pose_src, pose_dst = self.last_pose[src], self.last_pose[dst]
        out = mesh.inter_pose_device(
            f_dst, f_src, self.cams[src], self.cams[dst],
            torch.stack([self.Ks[src], self.Ks[dst]]),
            torch.stack([self.dists[src], self.dists[dst]]),
            pose_src.pose, pose_src.cov[3:6, 3:6], pose_dst.pose.C,
            pose_dst.cov[3:6, 3:6], self.mapdb, self.config,
            generator=self.generator, sample_idx=sample_idx,
            check_every=BOOTSTRAP_CHECK_EVERY)
        if not bool(out.ok):
            return None
        diag = out.diag
        # each matched landmark's observation in the temp scene's two views:
        # the guided map-to-map matches (RobustMatcher::matchMaps parity)
        self._debug_matches(f"inter{self.frame:04d}_s{src}_d{dst}_guided.svg",
                            images[src], images[dst], diag.obs_src, diag.obs_dst,
                            np.arange(diag.obs_dst.shape[0]), diag.guided_mask, color="lime")
        if self.out_dir:
            # their epipolar residuals under the robust src -> dst motion, the
            # reference's guidedmatches2.txt
            res = _host(utils.guided_match_residuals(
                self.cams[src].K, self.cams[dst].K, diag.geo_R, diag.geo_t, diag.obs_src,
                diag.obs_dst, diag.guided_mask))
            with open(os.path.join(self.out_dir, "guidedmatches2.txt"), "a") as fh:
                for r in res[_host(diag.guided_mask)]:
                    fh.write(f"{float(r)}\n")
        fused = covint.FusionResult(cov=out.fused_cov, pos=out.fused_pos,
                                    omega=diag.omega, trace=diag.trace)
        if self.filtered_log:
            cov6 = np.zeros((6, 6), np.float32)
            cov6[3:6, 3:6] = _host(fused.cov)
            self.filtered_log.log(self.frame, dst, src, _host(fused.pos), cov6,
                                  _host(so3.rot_to_euler(pose_dst.pose.R)),
                                  float(diag.rmse), int(diag.n_inliers))
        return fused

    # ------------------------------------------------------ the map lifecycle
    def extend_map(self, images, novelty_min_dist: int = 64,
                   sample_idx: Optional[torch.Tensor] = None) -> int:
        """Grow the map: triangulate new landmarks from the current frames
        into free MapDB slots (coloc_tpu's extend_map, after the
        reference's resection triangulation, Reconstructor.hpp:354-412):
          1. every drone detected, matched against the resident bank and
             P3P-localized in one step over the drone axis;
          2. candidates: valid features unmatched and farther than
             `novelty_min_dist` from every map descriptor;
          3. each pair of localized drones (utils.exhaustive_pairs):
             match_pair on the candidates, one landmark per train feature
             (the lowest query keeps it), reconstruct._triangulate_pair
             with the resection gates;
          4. survivors into free slots with the first view's descriptor, up
             to capacity; their features are consumed, so later pairs
             cannot add them again.
        Returns the number added. `sample_idx` (D, 256, 3) injects each
        drone's P3P draws.
        The pair loop is host numpy, as in coloc_tpu: map maintenance, not
        the frame step."""
        cfg = self.config
        if not self.map_ready or self.mapdb is None:
            return 0
        valid_np = self.mapdb.valid.cpu().numpy().copy()
        free = np.flatnonzero(~valid_np)
        if free.size == 0:
            return 0
        D = cfg.num_drones
        feats = detect_and_describe_batch(
            torch.stack([self._image(images[d]) for d in range(D)]), cfg.detector)
        mm = _match_drones(cfg, feats, self._map_bank())
        pwcs, _ = localize.localize_image(
            feats, mm, self.mapdb, Camera(K=self.Ks, dist=self.dists), cfg.ransac,
            cfg.refiner, sample_idx=sample_idx,
            uniforms=None if sample_idx is not None else self._draw(D),
            check_every=LM_CHECK_EVERY)
        loc_ok = pwcs.success.cpu().numpy()
        cand = (feats.valid & ~mm.mask & (mm.best > novelty_min_dist)).cpu().numpy()

        X_np = self.mapdb.X.cpu().numpy().copy()
        desc_np = self.mapdb.desc.cpu().numpy().copy()
        added = 0
        for a, b in utils.exhaustive_pairs(D):
            if added >= free.size or not (loc_ok[a] and loc_ok[b]):
                continue
            if not cand[a].any() or not cand[b].any():
                continue
            fa, fb = (Features(*(t[d] for t in feats))._replace(
                valid=torch.from_numpy(cand[d]).to(self.device)) for d in (a, b))
            idx = matching.match_pair(fa, fb, cfg.matcher).idx.cpu().numpy()
            safe = np.clip(idx, 0, fb.capacity - 1)
            ok = (idx >= 0) & cand[a] & cand[b][safe]
            # injectivity: one new landmark per train feature, the lowest
            # query keeps it
            q = np.flatnonzero(ok)
            ok[q] = False
            ok[q[np.unique(idx[q], return_index=True)[1]]] = True
            if not ok.any():
                continue
            Xn, okn = reconstruct._triangulate_pair(
                pwcs.pose.R[a], pwcs.pose.C[a], pwcs.pose.R[b], pwcs.pose.C[b],
                self.cams[a], self.cams[b], fa.xy,
                fb.xy[torch.from_numpy(safe).long().to(self.device)],
                torch.from_numpy(ok).to(self.device), reconstruct._MAX_Z_RESECTION,
                reconstruct._MIN_RAY_ANGLE_DEG, 16.0)
            take = np.flatnonzero(okn.cpu().numpy())[: free.size - added]
            if take.size == 0:
                continue
            slots = free[added: added + take.size]
            X_np[slots] = Xn.cpu().numpy()[take]
            desc_np[slots] = fa.desc.cpu().numpy()[take]
            valid_np[slots] = True
            # consume the features so that later pairs cannot re-add them
            cand[a][take] = False
            cand[b][idx[take]] = False
            added += take.size
        if added:
            self._set_slots(X_np, desc_np, valid_np)
            self._stamp_new_slots(free[:added])
            self._publish_map()
        return added

    def merge_map_from(self, other: MapDB, novelty_min_dist: int = 64,
                       min_matches: int = 12) -> int:
        """Merge another session's map into this one (coloc_tpu's
        merge_map_from): utils.align_maps finds the Sim(3) taking `other`
        into this map's frame from matched landmarks; `other`'s landmarks
        unmatched both ways and farther than `novelty_min_dist` from every
        descriptor here (match_maps(other, mapdb)) are moved by s R X + t
        and written to free slots, up to capacity. Returns the number
        added; 0, with `mapdb` the same object, when no alignment exists
        (fewer than `min_matches` common landmarks), no slot is free or
        nothing is novel. A map of coloc_tpu's arrives through
        convert.mapdb_from_numpy."""
        cfg = self.config
        if not self.map_ready or self.mapdb is None:
            return 0
        aln = utils.align_maps(self.mapdb, other, cfg.matcher, min_matches)
        if aln is None:
            return 0
        s, R, t, _, matched_b = aln
        valid_np = self.mapdb.valid.cpu().numpy().copy()
        free = np.flatnonzero(~valid_np)
        if free.size == 0:
            return 0
        mrev = matching.match_maps(other, self.mapdb, cfg.matcher)
        novel = (other.valid.cpu().numpy() & ~matched_b & ~mrev.mask.cpu().numpy()
                 & (mrev.best.cpu().numpy() > novelty_min_dist))
        take = np.flatnonzero(novel)[: free.size]
        if take.size == 0:
            return 0
        Xb = other.X.cpu().numpy()[take]
        X_np = self.mapdb.X.cpu().numpy().copy()
        desc_np = self.mapdb.desc.cpu().numpy().copy()
        slots = free[: take.size]
        X_np[slots] = ((s * (R @ Xb.T)).T + t).astype(np.float32)
        desc_np[slots] = other.desc.cpu().numpy()[take]
        valid_np[slots] = True
        self._set_slots(X_np, desc_np, valid_np)
        self._stamp_new_slots(slots)
        self._publish_map()
        return int(take.size)

    def _set_slots(self, X: np.ndarray, desc: np.ndarray, valid: np.ndarray) -> None:
        """A new MapDB from host arrays (the bank and the captured step
        follow it through their identity checks)."""
        self.mapdb = MapDB(*(torch.from_numpy(a).to(self.device) for a in (X, desc, valid)))

    def _stamp_new_slots(self, slots) -> None:
        """Freshly written slots: zero support, the current frame as their
        creation stamp (cull_map's grace window)."""
        if len(slots) == 0:
            return
        self._ensure_support()
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        self.lm_support = self.lm_support.index_fill(0, idx, 0)
        self.lm_last_seen = self.lm_last_seen.index_fill(0, idx, self.frame)

    def cull_map(self, max_age: int = 64, min_support: int = 8,
                 keep_min: int = 32) -> int:
        """Retire landmarks that stopped earning inliers (coloc_tpu's
        cull_map): a valid slot is culled when it is stale (frame -
        lm_last_seen > max_age; new slots are stamped with their creation
        frame) and unproven (lm_support < min_support). If fewer than
        `keep_min` valid landmarks would remain, the strongest candidates
        are spared: highest support first, then the most recent. Freed
        slots get support 0 and lm_last_seen -1. Returns the number
        culled; a cull replaces `mapdb` (its `valid`)."""
        if not self.map_ready or self.mapdb is None:
            return 0
        self._ensure_support()
        valid = self.mapdb.valid.cpu().numpy().copy()
        sup = self.lm_support.cpu().numpy()
        last = self.lm_last_seen.cpu().numpy()
        cull = valid & (self.frame - last > max_age) & (sup < min_support)
        n_valid, n_cull = int(valid.sum()), int(cull.sum())
        if n_cull == 0:
            return 0
        if n_valid - n_cull < keep_min:
            spare = min(keep_min - (n_valid - n_cull), n_cull)
            cand = np.flatnonzero(cull)
            order = np.lexsort((-last[cand], -sup[cand]))   # strongest first
            cull[cand[order[:spare]]] = False
            n_cull -= spare
            if n_cull == 0:
                return 0
        self.mapdb = self.mapdb._replace(valid=torch.from_numpy(valid & ~cull).to(self.device))
        freed = torch.from_numpy(np.flatnonzero(cull)).to(self.device)
        self.lm_support = self.lm_support.index_fill(0, freed, 0)
        self.lm_last_seen = self.lm_last_seen.index_fill(0, freed, -1)
        self._publish_map()
        return n_cull

    def _bootstrap(self, frames: Dict[int, list], num_frames: int) -> int:
        """init_map on the first frames that succeed -> the next frame."""
        f = 0
        while not self.map_ready and f < num_frames:
            self.init_map({d: frames[d][f] for d in range(self.config.num_drones)})
            f += 1
        return f

    def run(self, frames: Dict[int, list], inter_every: int = 10,
            update_map_every: int = 0, auto_update_map: bool = False,
            auto_update_patience: int = 3, extend_map_every: int = 0,
            cull_map_every: int = 0, cull_max_age: int = 64,
            cull_min_support: int = 8) -> Dict[int, list]:
        """mainThread parity (coloc.hpp:96-148): bootstrap on the first
        frames that succeed, then intra_pose_all every frame, an
        inter_pose_round on every frame whose index is a multiple of
        `inter_every` (0: never), and update_map on every frame whose
        index is a multiple of `update_map_every` (0: never) or, with
        `auto_update_map`, after `auto_update_patience` consecutive frames
        in which no drone localized; on a frame without a rebuild,
        extend_map every `extend_map_every` frames (D >= 2); then, on its
        own schedule, cull_map(cull_max_age, cull_min_support) every
        `cull_map_every` frames. The queued log rows are flushed every 64
        frames and when the run ends, also by an exception. Returns the
        per-drone lists of filtered poses."""
        cfg = self.config
        D = cfg.num_drones
        num_frames = min(len(v) for v in frames.values())
        out = {d: [] for d in range(D)}
        f = self._bootstrap(frames, num_frames)
        if not self.map_ready:
            return out
        dead = 0
        # flushed in `finally`: a failure mid-run keeps the frames already
        # stepped (up to 64 queued)
        try:
            for frame_idx in range(f, num_frames):
                self.frame = frame_idx
                images = {d: frames[d][frame_idx] for d in range(D)}
                res = self.intra_pose_all(images)
                for d in range(D):
                    out[d].append(res[d])
                if inter_every and frame_idx % inter_every == 0 and D >= 2:
                    self.inter_pose_round(images)
                trigger = bool(update_map_every) and frame_idx % update_map_every == 0
                if auto_update_map:
                    # reads the success flags from the device, only when asked
                    dead = dead + 1 if not any(bool(res[d].success) for d in range(D)) else 0
                    if dead >= auto_update_patience:
                        trigger, dead = True, 0
                if trigger:
                    self.update_map(images)
                elif extend_map_every and frame_idx % extend_map_every == 0 and D >= 2:
                    self.extend_map(images)
                if cull_map_every and frame_idx % cull_map_every == 0:
                    self.cull_map(max_age=cull_max_age, min_support=cull_min_support)
                # a bounded queue, flushed in bulk
                if len(self._pending_logs) >= 64:
                    self.flush_logs()
        finally:
            self.flush_logs()
        return out

    def run_chunked(self, frames: Dict[int, list], chunk: int = 16,
                    inter_every: int = 0, update_map_every: int = 0,
                    auto_update_map: bool = False,
                    auto_update_patience: int = 3) -> Dict[int, list]:
        """mainThread with chunked stepping (coloc_tpu's run_chunked):
        bootstrap, then frames in (chunk, D, H, W) blocks through
        intra_pose_chunk, the last partial chunk frame by frame through
        intra_pose_all so no frame is dropped. A fusion round follows every
        `inter_every` frames and update_map every `update_map_every`
        frames, each rounded up to whole chunks (coloc_tpu's documented
        deviation from run's per-frame schedule), on the chunk's last
        frame; `auto_update_map` counts the chunks in which no drone
        localized on any frame and rebuilds the map after
        `auto_update_patience` such chunks in a row. The log rows are
        flushed as run's. Returns the per-drone lists of filtered poses."""
        cfg = self.config
        D = cfg.num_drones
        num_frames = min(len(v) for v in frames.values())
        out = {d: [] for d in range(D)}
        f = self._bootstrap(frames, num_frames)
        if not self.map_ready:
            return out
        inter_chunks = max(1, -(-inter_every // chunk)) if inter_every else 0
        update_chunks = max(1, -(-update_map_every // chunk)) if update_map_every else 0
        chunks_done = dead = 0
        try:
            while f < num_frames:
                n = min(chunk, num_frames - f)
                if n == chunk:
                    block = torch.stack([torch.stack([self._image(frames[d][f + i])
                                                      for d in range(D)]) for i in range(n)])
                    self.frame = f
                    res = self.intra_pose_chunk(block)
                else:
                    res = {d: [] for d in range(D)}
                    for i in range(n):
                        self.frame = f + i
                        r = self.intra_pose_all({d: frames[d][f + i] for d in range(D)})
                        for d in range(D):
                            res[d].append(r[d])
                for d in range(D):
                    out[d].extend(res[d])
                f += n
                chunks_done += 1
                if inter_chunks and chunks_done % inter_chunks == 0 and D >= 2:
                    # the round's frame is the chunk's last
                    self.frame = f - 1
                    self.inter_pose_round({d: frames[d][f - 1] for d in range(D)})
                    self.frame = f
                trigger = bool(update_chunks) and chunks_done % update_chunks == 0
                if auto_update_map:
                    # one read of the chunk's success flags, only when asked
                    alive = bool(torch.stack([p.success for d in range(D)
                                              for p in res[d]]).any())
                    dead = 0 if alive else dead + 1
                    if dead >= auto_update_patience:
                        trigger, dead = True, 0
                if trigger:
                    self.update_map({d: frames[d][f - 1] for d in range(D)})
                if len(self._pending_logs) >= 64:
                    self.flush_logs()
        finally:
            self.flush_logs()
        return out
