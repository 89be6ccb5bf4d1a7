#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (coloc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at the reference workload (a 752x480 camera, an
8-level 1.2x pyramid, 1024 keypoints, a 4096-landmark map, 256
hypotheses, NFA scoring): the headline match+localize op, the full-frame
op (camera frame in, pose out), the session's D=2 frame step and the
session itself (two drones' frames in, a bootstrapped map, filtered poses
out); then the same with the AKAZE-MLDB frontend at the reference's CPU
preset (bench.py's _bench_akaze and its AKAZE session), and the two-stage
matcher against a 262144-row bank. Phases:

  1. device   — a CUDA device is required (there is no CPU path)
  2. build    — nvcc builds the kernels from coloc_tpu_torch/csrc
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the shapes of the main path, with kernel and plain times;
                B1 also at the AKAZE frame's and the large map's shapes,
                B1 at the fusion round's map against a temp map (4096 x
                4096, most temp slots invalid),
                B2 at B=1000, B3 at the AKAZE frame's M=5000, at small
                shapes and on planted edge inputs, over a drone axis
                against per-drone launches, B4 on the D=1
                raster, B10 at the frame's four octaves, at B=2 and at
                edge shapes, B11 on the frame's two sampler calls and
                at K=1 and NS=1, B9 and B12 on the planted edge inputs of
                tests/rank_cases.py, B12 also at a bank with a partial
                last group, B6, B7 and B8 at B = 1, 37, 201, 1000 and 2048
                and on io/synthetic's planted edges (NaN held by position), with
                wrapper and profiler device times, and with --parent DIR
                (a directory holding the parent commit's k2nn.cu,
                fast_nms.cu, p3p.cu, ransac_rank.cu, fed_octave.cu,
                sample_raster.cu, epi_rank.cu, k2nn_group.cu,
                fivept_front.cu with its fivept_constraints.cuh,
                fivept_dk.cu and fivept_polish.cu) the parent's kernels
                timed in turns with these on the same inputs, B2, B10, B11
                and B12 held bit for bit against the parent's, and B6-B9
                against the parent's wherever the parent equals the twin
  3p pose LM  — the pose LM's kernels (pose_lm.cu: the LM's iterations of a
                call, the covariance) against their twins at the session's
                shapes (D = 2, L = 1024 and 5000) and serving's (D = 64,
                L = 1024): one launch a call; one iteration and a call of
                LM_GRAPH_STEPS iterations (near and far starts, and
                max_iterations inside the call) held to the card tests'
                tolerances; the planted lanes to their end; wrapper and
                device times beside the twin's and the bound
  4. slice    — FRAMES frames through match_with_map + localize_image on
                random features, checked against the identity ground
                truth, plus frame 0 through the plain CPU path with the
                same RANSAC draws
  4b frame    — FULL_FRAMES rendered frames through detect_and_describe +
                match_with_map + localize_image, stage times by CUDA
                events, and the frame's features on the card against the
                plain CPU path
  4c step     — STEPS session steps (intra_all_device_step) for 2 drones
                with the Kalman bank, batched over the drones (one P3P and
                one B3 launch a step), with kernel launches and host reads
                a step, timed in turns with the per-drone form (2 calls of
                the D=1 body)
  4d session  — ColocSession: init_map on frame 0 of two drones (model-E
                five-point AC-RANSAC, triangulation, full BA), then
                SESSION_FRAMES frames of intra_pose_all, checked against
                the ground-truth trajectory; init_map again through the
                plain CPU path with the same five-point draws; B9 timed
                at the correspondence count init_map passed it
  4i fusion   — inter-drone relative pose and ICI fusion on 4d's session:
                inter_pose_round on its last frame (B1 frame against
                frame and map against temp map, B6-B9), checked against
                the ground-truth relative rotation and a float64 ICI; the
                pair with injected draws on the card and through the plain
                CPU path; inter_pose and round p50/p99, launches, host
                reads, device kernels, idle share and B1/B6-B9's device
                time a round; run(frames) with the reference's default
                inter_every=10 and run_chunked(chunk=CHUNK,
                inter_every=CHUNK) over 4h's trajectory, the rounds where
                the schedule puts them
  4e akaze    — AKAZE_FRAMES frames of the AKAZE frame op (5000 keypoints,
                Lowe-ratio matching against 8192 landmarks, P3P), stage
                times, a profile, and the card's features against the
                plain CPU path
  4f akaze session — ColocSession with the AKAZE frontend (1024
                keypoints, ratio matching, 4096 landmarks): init_map, then
                SESSION_FRAMES frames of intra_pose_all
  4g large map — match_with_map through the two-stage matcher and through
                brute force on one 262144-row bank: equal accepted sets,
                both ops' latency
  4h chunked  — the sync check (one eager step with its draws injected,
                TRIP and AKAZE, raises nothing under torch.cuda's sync
                debug mode "error"), then run_chunked(chunk=CHUNK) on 4d's
                trajectory from the bootstrap on CUDA graphs, checked as 4d
                and against the same frames stepped eagerly; the captured
                step equal to the eager step (torch.equal, every output)
                from identical inputs and draws, CHECKED frames; frames/s, step
                p50/p99 captured against eager in turns, graph nodes and
                host reads a frame, the idle share, capture time; then the
                AKAZE step on CUDA graphs on 4f's session: one CHUNK-frame
                chunk through run_chunked (B10's cooperative launches and
                B11 captured), CHECKED frames equal to the eager step,
                captured and eager frames timed in turns, graph nodes, host
                reads, capture time
  4j bootstrap — the rest of the bootstrap: init_map over four drones
                (6 pairs with B6-B9, 2 P3P resections with B2/B3; launches,
                host reads, a profile, p50), J_FRAMES eager frames, a
                CHUNK-frame chunk from CUDA graphs equal to the eager step,
                a ring round; models F and H at D=2 against the ground
                truth and the plain CPU path, B9 and B3 "nonzero" at their
                shapes; update_map's rescale, run(update_map_every=10) and
                run_chunked(chunk=CHUNK, update_map_every=CHUNK) equal to
                an eager run
  4k lifecycle — the map lifecycle on 4d's configuration and bootstrap:
                extend_map on frame K_FRAME of 4h's trajectory (growth, the
                |Z| gate, the next frame localized, a second extend adding
                under a quarter as many; its launches counted alone) and,
                on K_REF_FRAMES, against the plain CPU path from the same
                features and draws (Jaccard >= 0.98 of the added slots, the
                poses as 4i holds them, X within 5e-3 of |X|, and within
                1e-3 m with the card's poses given to the CPU);
                merge_map_from of a Sim(3)-moved copy plus 16 novel
                landmarks (its launches counted alone); cull_map of 64
                planted junk landmarks after the grace window and its
                keep_min floor; run(extend_map_every=10, cull_map_every=10)
                over 4h's frames; each method's p50, launches (equal to the
                counted call's), host reads and device kernels a call
  4l plumbing — on 4d's configuration and bootstrap: a session with
                out_dir, profile, debug_dir and a LiveViz through init_map,
                L_EAGER eager frames, a checkpoint, run_chunked(chunk=CHUNK)
                on CUDA graphs and a fusion; the checkpoint loaded into a
                fresh session and stepped eagerly over the chunk's frames,
                every output torch.equal and every log row text-equal to
                the captured chunk's; CSV row counts, map.ply, the SVG
                names, state.json, the profiler's stages, a trace_to file;
                the sync check with out_dir set; host reads and graph nodes
                a captured frame with and without out_dir; a CPU-written
                checkpoint loaded on the card (seeded from its key); the
                p50 of save_session, load_session and flush_logs
  4m serving  — ServingEngine on 4b's bench map with the scene's depths and
                SERVE_POSES renders of the bench scene: localize_frames and
                localize_features within 4b's pose gate, each stream against
                a single-stream localize_image with the same draws, set_map
                with permuted slots; at SERVE_SIZES streams p50/p99 a
                dispatch, streams/s, launches, host reads, device kernels,
                the idle share, and B1 at Q = B x 1024 with its bound
  4n runtime  — the runtime over the topic bus: the native transport and
                loader libraries built with g++; ServeRunner at B=N_SERVE on
                4m's map over an in-process broker (every pose received,
                equal to the runner's return and to localize_frames from the
                same generator state, within 4m's gate; round-trip p50/p99
                beside localize_frames alone, host reads and launches a
                dispatch); two DronePeers on two threads sharing 4d's saved
                map over 4d's frames (poses equal to a one-drone session's,
                each fuses the other's bundle; with injected draws
                inter_fuse over the wire equal to session.inter_pose, 4i's
                gates; bundle bytes, p50 beside inter_pose); then
                `python -m coloc_tpu_torch.{serve,distributed,cli}` as
                subprocesses on the card (serve fed by a robot node, two
                peers over a write_dataset folder, the synthetic CLI run)
  4o mesh     — the multi-device forms (parallel/mesh): ranks spawned by
                parallel.mesh.spawn, NCCL at world size 1 and gloo worlds
                of 2 and 4 ranks sharing cuda:0; collaborative_step "full"
                and "ici" over O_FRAMES of 4d's frames on 4d's map and the
                scan over O_SCAN, every rank's outputs equal to the
                single-process composition, inside 4i's gates; sharded
                serving at B = O_SERVE (4m's renders) equal per shard to
                ServingEngine; sharded_map_match on 4g's bank over 2 ranks
                and a 2 x 2 mesh equal to one hamming_2nn; each rank's
                launches, p50s, spawn and init seconds and staged
                exchanges; `python -m coloc_tpu_torch.graft_entry` (4 ranks)
  5. counters — every kernel of each path launched during its phase

Any failed check raises and the script exits non-zero. The last two lines
of stdout are one JSON object per kernel and the run's result line.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
H, W, KP, LANDMARKS = 480, 752, 1024, 4096
OUTLIER_FRAC = 0.25
FRAMES = 50
# the full-frame op: the bench scene (make_scene seed 1) at identity
LEVELS, FAST_THRESHOLD, SCENE_SEED = 8, 12, 1
FULL_FRAMES, STAGED_FRAMES, PROFILED_FRAMES = 30, 10, 3
STEP_DRONES, STEPS = 2, 12
SESSION_FRAMES = 10
# the chunked session (4h): run_chunked over two chunks of CHUNK frames,
# then ROUNDS timed chunks in turns with as many eager frames
CHUNK, CHUNKS, ROUNDS = 16, 2, 3
# frames of 4h held to the eager step bit for bit
CHECKED = 4
# timed calls of inter_pose and of inter_pose_round (4i)
FUSION_CALLS = 10
# 4j: eager frames after each bootstrap, timed calls of init_map and update_map
J_FRAMES, INIT_CALLS = 10, 5
# 4k: the frame of 4h's trajectory that extend_map grows the map from, and
# timed calls of each lifecycle method
K_FRAME, LIFECYCLE_CALLS = 8, 5
# 4k: the frames whose extend_map is held to the plain CPU path
K_REF_FRAMES = (K_FRAME, 4)
# 4l: eager frames before the checkpoint, timed calls of save_session,
# load_session and flush_logs
L_EAGER, L_CALLS = 3, 5
# 4m: rendered poses of the bench scene, bench.py's stream counts and the
# timed dispatches at each
SERVE_POSES, SERVE_SIZES, SERVE_CALLS = 16, (8, 16, 32, 64), 20
# 4m: a stream's pose against its truth, 4b's gate (rotation rad, centre m)
SERVE_GATE = (1e-3, 1e-2)
# 4n: ServeRunner's streams, its timed round trips, the serve entry point's
# dispatches, and the timed fusions over the wire
N_SERVE, SERVE_ROUNDS, SERVE_STEPS, FUSE_CALLS = 8, 10, 3, 5
PEER_FRAMES = 4       # 4n(d): the joining peer's frames; the broker's owner steps one more
# 4o: 4d's frames through the mesh's step, the scan's frames, sharded
# serving's streams, and the timed calls of the scan, serving and the match
O_FRAMES, O_SCAN, O_SERVE, O_CALLS = 5, 4, 8, 5
# host threads that render the synthetic sessions' frames
RENDER_THREADS = 4
WARMUP, ITERS = 10, 100
# the AKAZE frame op at the reference's CPU preset (bench.py _bench_akaze)
# and the AKAZE session (bench.py config_akaze)
AKAZE_KP, AKAZE_LANDMARKS = 5000, 8192
AKAZE_FRAMES, AKAZE_STAGED, AKAZE_PROFILED = 20, 5, 2
# the two-stage matcher: planted queries against a bank at its design size
TWOSTAGE_Q, TWOSTAGE_T, TWOSTAGE_CALLS = 1024, 262144, 20
TWOSTAGE_PARTIAL_T = 100000     # 48 whole groups and one of 1696 rows
# the least time of a kernel's work on an H100 SXM at 700 W: HBM bytes/s,
# fp32 FLOP/s outside the tensor cores, int8 tensor-core OP/s
HBM_BPS, FP32_FLOPS, INT8_OPS = 3.35e12, 67e12, 1979e12
# the kernels --parent builds from the parent commit's sources
PARENT_KERNELS = ("k2nn", "fast_nms", "p3p", "ransac_rank", "fed_octave",
                  "sample_raster", "epi_rank", "k2nn_group", "fivept_front", "fivept_dk",
                  "fivept_polish")
# B3 at the AKAZE frame's correspondence count (4e)
AKAZE_RANK_M = 5000

KERNEL_INFO = {
    "k2nn": ("coloc_tpu_torch/csrc/k2nn.cu", "coloc_tpu/ops/hamming.py:103"),
    "p3p": ("coloc_tpu_torch/csrc/p3p.cu", "coloc_tpu/geometry/p3p.py:243"),
    "ransac_rank": ("coloc_tpu_torch/csrc/ransac_rank.cu",
                    "coloc_tpu/ops/ransac_rank.py:78"),
    "fast_nms": ("coloc_tpu_torch/csrc/fast_nms.cu", "coloc_tpu/ops/fast.py:182"),
    "extract": ("coloc_tpu_torch/csrc/extract.cu", "coloc_tpu/ops/patches.py:152"),
    "fivept_front": ("coloc_tpu_torch/csrc/fivept_front.cu",
                     "coloc_tpu/geometry/fivept.py:690"),
    "fivept_dk": ("coloc_tpu_torch/csrc/fivept_dk.cu", "coloc_tpu/geometry/fivept.py:785"),
    "fivept_polish": ("coloc_tpu_torch/csrc/fivept_polish.cu",
                      "coloc_tpu/geometry/fivept.py:483"),
    "epi_rank": ("coloc_tpu_torch/csrc/epi_rank.cu", "coloc_tpu/ops/ransac_rank.py:272"),
    "fed_octave": ("coloc_tpu_torch/csrc/fed_octave.cu", "coloc_tpu/ops/diffusion.py:193"),
    "sample_raster": ("coloc_tpu_torch/csrc/sample_raster.cu",
                      "coloc_tpu/ops/patches.py:216"),
    "k2nn_group": ("coloc_tpu_torch/csrc/k2nn_group.cu", "coloc_tpu/ops/hamming.py:360"),
    "pose_lm": ("coloc_tpu_torch/csrc/pose_lm.cu",
                "none: coloc_tpu/sfm/ba.py refine_pose_only is XLA ops"),
    "pose_cov": ("coloc_tpu_torch/csrc/pose_lm.cu",
                 "none: coloc_tpu/sfm/ba.py refine_pose_only is XLA ops"),
}
FRAME_KERNELS = ("k2nn", "p3p", "ransac_rank", "fast_nms", "extract")
# the pose LM's kernels: every path that refines a pose launches both
POSE_KERNELS = ("pose_lm", "pose_cov")
AKAZE_KERNELS = ("k2nn", "p3p", "ransac_rank", "fed_octave", "sample_raster")
BOOTSTRAP_KERNELS = ("fivept_front", "fivept_dk", "fivept_polish", "epi_rank")
# the kernels each driven path must launch
PATH_KERNELS = {
    "4 slice": ("k2nn", "p3p", "ransac_rank") + POSE_KERNELS,
    "4b frame": FRAME_KERNELS + POSE_KERNELS,
    "4c step": FRAME_KERNELS + POSE_KERNELS,
    "4d session": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4e akaze frame": AKAZE_KERNELS + POSE_KERNELS,
    "4f akaze session": AKAZE_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4g large map": ("k2nn_group", "k2nn"),
    "4h chunked": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4h akaze chunked": AKAZE_KERNELS + POSE_KERNELS,
    "4i fusion": ("k2nn",) + BOOTSTRAP_KERNELS,
    "4j bootstrap": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4j model F": ("k2nn", "fast_nms", "extract", "epi_rank"),
    "4j model H": ("k2nn", "fast_nms", "extract", "ransac_rank"),
    "4k extend_map": FRAME_KERNELS + POSE_KERNELS,
    "4k merge_map_from": ("k2nn",),
    "4l plumbing": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4m serving": FRAME_KERNELS + POSE_KERNELS,
    "4n serve runner": FRAME_KERNELS + POSE_KERNELS,
    "4n peers": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4o step": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4o scan": FRAME_KERNELS + BOOTSTRAP_KERNELS + POSE_KERNELS,
    "4o serving": FRAME_KERNELS + POSE_KERNELS,
    "4o match": ("k2nn",),
}
# the phase whose launches the kernels line reports
LAUNCH_PHASE = {**{name: "4b frame" for name in FRAME_KERNELS},
                **{name: "4d session" for name in BOOTSTRAP_KERNELS},
                "fed_octave": "4e akaze frame", "sample_raster": "4e akaze frame",
                "k2nn_group": "4g large map",
                **{name: "4h chunked" for name in POSE_KERNELS}}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, calls: int = 20):
    """Mean device milliseconds of the kernels whose name holds `kernel`
    over `calls` calls of fn(), from torch.profiler's key_averages(); None
    when the profiler saw none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += ev.device_time_total
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def timed_pair(tag, new, old, kernel, card, bnd=None):
    """Wrapper ms (cuda_ms) and device ms (profiler) of this tree's kernel
    and, when the parent's is given, of the parent's on the same inputs, in
    turns (old, new, new, old) on one card. -> dict of the new kernel's
    ms and device_ms, and the parent's parent_ms and parent_device_ms."""
    order = (("old", old), ("new", new), ("new", new), ("old", old)) if old else \
        (("new", new),)
    ms = {"old": [], "new": []}
    dev = {"old": [], "new": []}
    for which, fn in order:
        ms[which].append(cuda_ms(fn))
        dev[which].append(device_ms(fn, kernel))

    def mean(v):
        return None if not v or None in v else sum(v) / len(v)

    out = dict(ms=mean(ms["new"]), device_ms=mean(dev["new"]),
               parent_ms=mean(ms["old"]), parent_device_ms=mean(dev["old"]))
    b = "" if bnd is None else f"; bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']})"
    p = "not given (--parent)" if old is None else (
        f"wrapper {fmt_ms(out['parent_ms'])}, device {fmt_ms(out['parent_device_ms'])} "
        f"(old, new, new, old in one call)")
    print(f"[3 {tag}] wrapper {fmt_ms(out['ms'])}, device {fmt_ms(out['device_ms'])}; "
          f"parent kernel {p}{b}  ({card})")
    return out


def build_parent(src_dir: Path, names=PARENT_KERNELS):
    """The parent commit's launchers of `names` (name.cu in src_dir,
    common.cuh from there or from this checkout), built by nvcc into a
    temporary directory and loaded with ctypes. Prints ptxas' registers and
    spills of each. -> {name: the C function coloc_<name>}."""
    import tempfile

    from coloc_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    work = Path(tempfile.mkdtemp(prefix="coloc-parent-"))
    objs, procs = [], []
    for name in names:
        obj = work / f"{name}.o"
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-I{src_dir}", f"-I{_build.CSRC}", "-c", "-o",
               str(obj), str(src_dir / f"{name}.cu")]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    for cmd, proc in procs:
        out = proc.communicate()[0]
        check(proc.returncode == 0, f"parent build failed: {' '.join(cmd)}\n{out}")
        print_ptxas(f"parent {Path(cmd[-1]).name}", out)
    lib_path = work / "libparent.so"
    proc = subprocess.run([nvcc, *_build._ARCH, "-shared", "-o", str(lib_path), *objs],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"parent link failed: {proc.stdout}{proc.stderr}")
    for fn, (_, n_local) in sass_scan(lib_path, nvcc).items():
        print(f"    parent SASS {fn}: {n_local} local-memory loads and stores")
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for name in names:
        fn = getattr(lib, f"coloc_{name}")
        fn.argtypes = _build._SIGNATURES[f"coloc_{name}"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def print_ptxas(tag, log):
    """ptxas' lines of each kernel: its entry, registers, stack and spills."""
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print(f"    {tag}: {line.strip()}")


def sass_scan(lib_path: Path, nvcc: str) -> dict:
    """{kernel function: (sorted MMA opcodes, count of local-memory loads
    and stores)} from `cuobjdump -sass` of the built library."""
    import re

    proc = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr.strip()}")
    found, local, fn = {}, {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            found.setdefault(fn, set())
            local.setdefault(fn, 0)
            continue
        # an instruction line: /*addr*/ [@predicate] OPCODE[.modifiers] operands
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn is None or not op:
            continue
        base = op.group(1).split(".")[0]
        if base.endswith("MMA"):
            found[fn].add(op.group(1))
        if base in ("LDL", "STL"):
            local[fn] += 1
    return {f: (sorted(ops), local[f]) for f, ops in found.items()}


def tests_module(stem: str):
    """tests/<stem>.py of this checkout, loaded by its path: the planted B3
    inputs (rank_cases) or the pose LM's problems (pose_cases) that the
    tests use too."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"coloc_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_3p(torch, np, dev, card, results):
    """The pose LM's kernels against their plain twins (ba's PyTorch form
    on the same card tensors) at the session's shapes (D = 2; L = 1024,
    TRIP's keypoints, and 5000, AKAZE's) and serving's (D = 64, L = 1024),
    on tests/pose_cases.frame_lanes problems: one launch a call; one
    iteration's bookkeeping equal and poses within 1e-5; a call of
    n = LM_GRAPH_STEPS iterations (a head or middle graph's), from the
    session-like start, from a farther one and with max_iterations 2 inside
    the call, held as tests/test_torch_pose_lm.py holds it: each lane's pose
    no farther from a float64 twin than twice the float32 twin's distance
    plus 1e-5 (a lane not clear of the rounding floor may instead stand a
    step away at a float64 cost within pose_cases.COST_FLOOR of the
    twin's), iterations and
    active equal on the lanes whose decisions are clear of the floor
    (pose_cases.clear_lanes; the far start must have some); the planted
    lanes (pose_cases.lanes, one stops at the damping cap) run to their end
    in calls of n; the covariance at the twin's solution within 1e-4. Wrapper and device ms of the LM at n and
    of the covariance, beside the twin's and the bound. Fills
    results["pose_lm"] and results["pose_cov"] at D = 2, L = 5000."""
    from contextlib import contextmanager
    from dataclasses import replace

    from coloc_tpu_torch.config import RefinerOptions
    from coloc_tpu_torch.ops import dispatch
    from coloc_tpu_torch.session import LM_GRAPH_STEPS
    from coloc_tpu_torch.sfm import ba

    cases = tests_module("pose_cases")
    opts = RefinerOptions()
    n = LM_GRAPH_STEPS

    @contextmanager
    def plain():
        use = dispatch.use_kernel
        dispatch.use_kernel = lambda t: False
        try:
            yield
        finally:
            dispatch.use_kernel = use

    def lane_gap(a, b):
        """Per lane: max |dR| and max |dC| / sqrt(|C|^2 + 1), in float64."""
        dR = (a.R.double() - b.R.double()).abs().flatten(1).amax(dim=1)
        dC = ((a.C.double() - b.C.double()).abs().amax(dim=1)
              / torch.sqrt((b.C.double() ** 2).sum(dim=1) + 1.0))
        return dR, dC

    def f64(ts):
        return tuple(t.double() if t.is_floating_point() else t for t in ts)

    def n_steps(case, o, label, need_clear):
        """One call of n iterations on the kernel, the twin and the twin in
        float64, held as the docstring says."""
        st = ba.pose_lm_init(case[0], case[1])
        got = ba.pose_lm_steps(st, *case[2:], o, n)
        with plain():
            want = ba.pose_lm_steps(st, *case[2:], o, n)
            exact = ba.pose_lm_steps(ba.PoseLM(*f64(st)), *f64(case[2:]), o, n)
        clear = cases.clear_lanes(case, o, n)
        kR, kC = lane_gap(got, exact)
        pR, pC = lane_gap(want, exact)
        excess = cases.cost_excess(case, o, got, exact)
        close = (kR <= 2 * pR + 1e-5) & (kC <= 2 * pC + 1e-5)
        near = bool((close | (~clear & (excess <= cases.COST_FLOOR))).all())
        agree = (got.iterations == want.iterations) & (got.active == want.active)
        same = bool(agree[clear].all())
        print(f"[3p pose_lm {label}] n={n}, max_iterations {o.max_iterations}: from the "
              f"float64 twin |dR| {float(kR.max()):.3e} (float32 twin {float(pR.max()):.3e}), "
              f"|dC| {float(kC.max()):.3e} ({float(pC.max()):.3e}); {int((~close).sum())} "
              f"lanes farther, float64 cost above the twin's by at most "
              f"{float(excess[~close].max()) if bool((~close).any()) else 0.0:.3e}; iterations "
              f"and active equal on {int(agree[clear].sum())} of {int(clear.sum())} clear lanes "
              f"({int(agree.sum())} of {agree.numel()} in all)")
        check(near and same and (bool(clear.any()) or not need_clear),
              f"pose_lm {label}: n={n} (max_iterations {o.max_iterations}): poses within "
              f"2x the twin's distance + 1e-5 of the float64 twin, or at the floor within "
              f"{cases.COST_FLOOR:g} of its cost, {near}; bookkeeping equal on the clear lanes "
              f"{same}, "
              f"{int(clear.sum())} clear lanes")

    lanes = tuple(t.to(dev) for t in cases.lanes())
    got = ba.pose_lm_run(ba.pose_lm_init(lanes[0], lanes[1]), *lanes[2:], opts, n)
    with plain():
        want = ba.pose_lm_run(ba.pose_lm_init(lanes[0], lanes[1]), *lanes[2:], opts, n)
    dR, dC = lane_gap(got, want)
    check(torch.equal(got.iterations, want.iterations) and torch.equal(got.active, want.active)
          and not bool(got.active.any()) and float(dR[:2].max()) < 1e-5
          and float(dC[:2].max()) < 1e-5,
          f"pose_lm planted lanes in calls of {n}: iterations {got.iterations.tolist()} "
          f"(twin {want.iterations.tolist()}), |dR| {float(dR[:2].max()):.3e}, "
          f"|dC| {float(dC[:2].max()):.3e}")
    print(f"[3p pose_lm lanes] calls of {n} to the end: iterations {got.iterations.tolist()} "
          f"equal to the twin's, all stopped, |dR| {float(dR[:2].max()):.3e}, "
          f"|dC| {float(dC[:2].max()):.3e} on the converging lanes")

    for D, L in ((2, 1024), (2, 5000), (64, 1024)):
        tag = f"D={D} L={L}"
        case = tuple(t.to(dev) for t in cases.frame_lanes(D, L, seed=SEED + 7 * D + L))
        R0, C0, X, uv, inl, Ks, dists = case
        st = ba.pose_lm_init(R0, C0)
        before = dispatch.launch_counts()
        one = ba.pose_lm_steps(st, X, uv, inl, Ks, dists, opts, 1)
        with plain():
            one_p = ba.pose_lm_steps(st, X, uv, inl, Ks, dists, opts, 1)
            sol = ba.pose_lm_run(st, X, uv, inl, Ks, dists, opts, 1)
            cov_p = ba.pose_lm_finish(sol, X, uv, inl, Ks, dists, opts)
        cov_k = ba.pose_lm_finish(sol, X, uv, inl, Ks, dists, opts)
        torch.cuda.synchronize()
        after = dispatch.launch_counts()
        check(after["pose_lm"] == before["pose_lm"] + 1
              and after["pose_cov"] == before["pose_cov"] + 1,
              f"pose kernels {tag}: launches {after['pose_lm'] - before['pose_lm']} LM, "
              f"{after['pose_cov'] - before['pose_cov']} covariance (want 1, 1)")
        same = all(torch.equal(getattr(one, f), getattr(one_p, f))
                   for f in ("active", "iterations", "it", "lam", "nu"))
        dR1, dC1 = (float(v.max()) for v in lane_gap(one, one_p))
        check(same and dR1 < 1e-5 and dC1 < 1e-5,
              f"pose_lm {tag}: one iteration differs from the twin (bookkeeping equal "
              f"{same}, |dR| {dR1:.3e}, |dC| {dC1:.3e})")
        n_steps(case, opts, tag, need_clear=False)
        far = tuple(t.to(dev) for t in cases.frame_lanes(
            D, L, seed=SEED + 7 * D + L + 1, rot=0.1, shift=0.3))
        n_steps(far, opts, f"{tag} far", need_clear=True)
        n_steps(far, replace(opts, max_iterations=2), f"{tag} far", need_clear=True)
        cov_err = max(float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))
                      for a, b in zip(cov_k.cov, cov_p.cov))
        rmse_err = float(((cov_k.rmse - cov_p.rmse).abs() / cov_p.rmse.abs()).max())
        check(cov_err < 1e-4 and rmse_err < 1e-5 and torch.equal(cov_k.n_obs, cov_p.n_obs),
              f"pose_cov {tag}: cov {cov_err:.3e}, rmse {rmse_err:.3e} from the twin")
        # bounds: each input byte read once; the twin's ~290 flops a point an
        # iteration (linearization, weights, U, g, the cost at the candidate)
        # and ~250 a point for the covariance's linearization
        nbytes = D * L * 21 + D * 4 * (9 + 3 + 9 + 3)
        lm = dict(ms=cuda_ms(lambda: ba._pose_lm_steps_cuda(st, X, uv, inl, Ks, dists, opts, n)),
                  device_ms=device_ms(lambda: ba._pose_lm_steps_cuda(
                      st, X, uv, inl, Ks, dists, opts, n), "pose_lm_kernel"),
                  plain_ms=cuda_ms(lambda: ba._pose_lm_steps_plain(
                      st, X, uv, inl, Ks, dists, opts, n), warmup=3, iters=20),
                  max_abs_err=max(dR1, dC1), library_ms=None,
                  **bound(nbytes, n * D * L * 290.0, FP32_FLOPS))
        cv = dict(ms=cuda_ms(lambda: ba._pose_cov_cuda(sol.R, sol.C, X, uv, inl, Ks, dists,
                                                       opts.huber_delta_sq)),
                  device_ms=device_ms(lambda: ba._pose_cov_cuda(
                      sol.R, sol.C, X, uv, inl, Ks, dists, opts.huber_delta_sq),
                      "pose_cov_kernel"),
                  plain_ms=cuda_ms(lambda: ba._pose_cov_plain(
                      sol.R, sol.C, X, uv, inl, Ks, dists, opts.huber_delta_sq),
                      warmup=3, iters=20),
                  max_abs_err=cov_err, library_ms=None,
                  **bound(nbytes + D * 4 * 38, D * L * 250.0, FP32_FLOPS))
        print(f"[3p pose_lm {tag}] n={n}: wrapper {fmt_ms(lm['ms'])}, device "
              f"{fmt_ms(lm['device_ms'])}, plain {fmt_ms(lm['plain_ms'])}, bound "
              f"{lm['bound_ms']:.5f} ms ({lm['bound_by']}); one iteration equal to the twin's "
              f"bookkeeping, |dR| {dR1:.3e}, |dC| {dC1:.3e}  ({card})")
        print(f"[3p pose_cov {tag}] wrapper {fmt_ms(cv['ms'])}, device {fmt_ms(cv['device_ms'])}, "
              f"plain {fmt_ms(cv['plain_ms'])}, bound {cv['bound_ms']:.5f} ms "
              f"({cv['bound_by']}); cov {cov_err:.3e}, rmse {rmse_err:.3e} from the twin  "
              f"({card})")
        if (D, L) == (2, 5000):
            results["pose_lm"], results["pose_cov"] = lm, cv


def k2nn_case(np, torch, dev, Q, T, seed):
    """A B1 input of Q queries against T rows (tests/test_hamming.py's
    matching shape: most queries a bank row with ~20 bits flipped, the rest
    random): query 0's best row duplicated in two later bank splits of the
    kernel (eighths of the stages) and in its last stage, a band of 40
    invalid rows that holds query 5's own row, query 7 invalid.
    -> (q, q_valid, bank, best row of query 0, query 5's own row)."""
    from coloc_tpu_torch.ops import hamming

    rng = np.random.default_rng(seed)
    td = rng.integers(0, 2 ** 32, (T, 16), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, T, Q)
    qd = td[rows].copy()
    flips = rng.integers(0, 512, (Q, 20))
    for j in range(flips.shape[1]):
        qd[np.arange(Q), flips[:, j] // 32] ^= np.uint32(1) << (flips[:, j] % 32).astype(np.uint32)
    qd[Q - Q // 5:] = rng.integers(0, 2 ** 32, (Q // 5, 16), dtype=np.uint64).astype(np.uint32)
    r0 = T // 16
    for r in (3 * T // 8 + 5, 6 * T // 8 + 9, T - 1):
        td[r] = td[r0]
    qd[0] = td[r0]
    tv = np.ones(T, bool)
    band = T // 2 + 100
    tv[band:band + 40] = False
    qd[5] = td[band + 10]
    qv = np.ones(Q, bool)
    qv[7] = False
    bank = hamming.pack_bank(torch.from_numpy(td.view(np.int32)).to(dev),
                             torch.from_numpy(tv).to(dev))
    return (torch.from_numpy(qd.view(np.int32)).to(dev), torch.from_numpy(qv).to(dev), bank,
            r0, band + 10)


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the HBM rate and its operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def rank_bound(ops_c):
    """B3: bytes of the (Hm, 12) models, (7, M) data and (Hm,) rank; ~44
    flops a pair, counted over the points whose mask is not 0 (a masked
    point adds nothing)."""
    Hm_c, M_c = ops_c[0].shape[-2], ops_c[1].shape[-1]
    return bound((Hm_c * 13 + 7 * M_c) * 4,
                 Hm_c * int((ops_c[3] != 0).sum()) * 44.0, FP32_FLOPS)


def epi_bound(ops_c):
    """B9: bytes of the operands and rank; ~70 flops a pair, counted over the
    points whose mask is not 0 (a masked point adds nothing)."""
    Hm_c, M_c = ops_c[0].shape[0], ops_c[1].shape[1]
    return bound((Hm_c * 28 + 28 * M_c + 1) * 4,
                 Hm_c * int((ops_c[2] != 0).sum()) * 70.0, FP32_FLOPS)


def print_stages(torch, np, tag, run, n):
    """Stage times of run(f, mark) over n frames: CUDA events recorded by
    the path's `mark(stage)` hook after each stage, p50 per stage."""
    stage_ms = {}
    for f in range(n):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        run(f, mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            stage_ms.setdefault(name, []).append(a.elapsed_time(b))
    print(f"[{tag} stages] p50 over {n} frames, CUDA events: " + ", ".join(
        f"{k} {np.percentile(v, 50):.3f}" for k, v in stage_ms.items())
        + f" ms; sum {sum(np.percentile(v, 50) for v in stage_ms.values()):.3f} ms")


def device_kernels(torch, prof):
    """[(name, us)] of the device's events in a torch.profiler trace, read
    from its raw kineto events: the ones and times that prof.events()
    gives with device type CUDA, without the host-side event tree that
    prof.events() builds first (seconds for a trace of a bootstrap)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not getattr(e, "is_hidden_event", lambda: False)()]


def profile_frames(torch, tag, run, n, per=1, unit="frame"):
    """run(f) for n calls of `per` frames each under torch.profiler: device
    kernels a frame, device busy and idle share, the largest device
    kernels; `unit` names what one of the n x per counts is."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(n):
            run(f)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n *= per
    kernels = device_kernels(torch, prof)
    busy_us = sum(us for _, us in kernels)
    if busy_us <= 0:
        print(f"[{tag} profile] the profiler saw no device time: not measured")
        return
    print(f"[{tag} profile] {len(kernels) / n:.0f} device kernels a {unit}, device "
          f"busy {busy_us / n / 1e3:.3f} ms of {wall_us / n / 1e3:.3f} ms a {unit} "
          f"({100.0 - 100.0 * busy_us / wall_us:.1f}% idle, profiler on)")
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[{tag} profile] device us a {unit}, largest kernels: " + "; ".join(
        f"{us / n:.1f} {name[:60]}" for name, us in top))
    # the port's own kernels are the ones in an anonymous namespace at the
    # top level (a template's name starts with its return type, void);
    # PyTorch has such templates too, instantiated on its own types
    ours = {name.split("::", 1)[1].split("(", 1)[0]: us for name, us in by_name.items()
            if name.removeprefix("void ").startswith("(anonymous namespace)::")
            and "at::" not in name}
    print(f"[{tag} profile] the port's kernels, device us a {unit}: " + "; ".join(
        f"{name} {us / n:.1f}" for name, us in sorted(ours.items(), key=lambda kv: -kv[1])))


def host_reads(torch, fn):
    """fn() under torch.cuda's sync debug mode "warn" -> (its result, the
    number of operations that synchronised the host with the card)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def percentiles(np, ms):
    return f"p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms"


def pose_errors(torch, R, C):
    """Rotation (rad) and centre (m) error against the identity pose."""
    eye = torch.eye(3, device=R.device)
    rot = float(torch.arccos(torch.clamp((torch.trace(R.T @ eye) - 1.0) / 2.0,
                                         -1.0, 1.0)))
    return rot, float(torch.linalg.norm(C))


def shared_features(np, a, b):
    """Share of a's valid keypoints that b has too (same level, xy within
    1e-3 px), and the share of equal descriptor bits over those pairs."""
    av, bv = a.valid, b.valid
    axy, bxy = a.xy[av], b.xy[bv]
    d = np.abs(axy[:, None, :] - bxy[None, :, :]).max(-1)
    d = np.where(a.scale[av][:, None] == b.scale[bv][None, :], d, np.inf)
    pair = d.argmin(axis=1)
    shared = d[np.arange(len(axy)), pair] <= 1e-3
    bits = [np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1)
            for x in (a.desc[av][shared], b.desc[bv][pair[shared]])]
    return float(shared.mean()), float((bits[0] == bits[1]).mean())


def render_frames(np, synthetic, scene, trajs, n):
    """Frames 0..n-1 of each trajectory (R (F, 3, 3), C (F, 3)) as float32
    images, {i: [image, ...]} for trajs[i], rendered by RENDER_THREADS host
    threads (numpy's array passes release the GIL; each image is the same
    as a serial render's)."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(R[f], C[f]) for R, C in trajs for f in range(n)]
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        imgs = list(pool.map(lambda j: synthetic.render(scene, *j).astype(np.float32), jobs))
    return {i: imgs[i * n:(i + 1) * n] for i in range(len(trajs))}


def bench_scene(np, K):
    """The bench frame (make_scene(480, 752, K, seed=1) rendered at
    identity) and a second view of the same scene."""
    from coloc_tpu_torch.io import synthetic

    scene = synthetic.make_scene(H, W, K, seed=SCENE_SEED)
    frame = synthetic.render(scene, np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32)).astype(np.float32)
    Rs, Cs = synthetic.trajectory(30, 0)
    second = synthetic.render(scene, Rs[10], Cs[10]).astype(np.float32)
    return frame, second


def workload(np, rng):
    """Random features + a consistent map with OUTLIER_FRAC of the matched
    landmarks moved to random far points (numpy, the reference layout)."""
    from coloc_tpu_torch.io import synthetic

    fa = synthetic.random_features(H, W, KP, rng)
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]],
                 np.float32)
    ma = synthetic.consistent_mapdb(fa, K, LANDMARKS, rng)
    n_out = int(OUTLIER_FRAC * KP)
    X = ma.X.copy()
    X[:n_out] = rng.uniform(-50.0, 50.0, (n_out, 3)).astype(np.float32)
    return fa, ma._replace(X=X), K, n_out


def rotation_error(torch, R, R_ref):
    """Angle between two rotations, rad: ||R - R_ref||_F = 2 sqrt(2)
    sin(angle / 2), exact near 0 where arccos of the trace is not."""
    d = torch.linalg.norm((R - R_ref).double()) / (2.0 * 2.0 ** 0.5)
    return float(2.0 * torch.asin(torch.clamp(d, max=1.0)))


def chunk_timing(torch, np, tag, sess_c, sess_e, block, card):
    """ROUNDS rounds in turns of intra_pose_chunk(block) on sess_c (each
    frame's replay timed by CUDA events) and the block's frames through
    sess_e.intra_pose_all: step p50/p99 and frames/s of each, printed."""
    from coloc_tpu_torch import session

    n = block.shape[0]
    replay_ms, real_replay = [], session._StepGraphs.replay

    def timed_replay(self, images, draws):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_replay(self, images, draws)
        end.record()
        replay_ms.append((start, end))
        return out

    cap_ms, eager_ms, cap_wall, eager_wall = [], [], [], []
    session._StepGraphs.replay = timed_replay
    try:
        for r in range(ROUNDS):
            replay_ms.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess_c.intra_pose_chunk(block)
            torch.cuda.synchronize()
            cap_wall.append((time.perf_counter() - t0) * 1e3 / n)
            cap_ms += [a.elapsed_time(b) for a, b in replay_ms]
            t0 = time.perf_counter()
            for f in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                sess_e.intra_pose_all({d: block[f, d] for d in range(block.shape[1])})
                end.record()
                torch.cuda.synchronize()
                eager_ms.append(start.elapsed_time(end))
            eager_wall.append((time.perf_counter() - t0) * 1e3 / n)
    finally:
        session._StepGraphs.replay = real_replay
    print(f"[{tag}] {ROUNDS} rounds of a {n}-frame chunk and {n} eager frames in "
          f"turns: captured step {percentiles(np, cap_ms)}, {1e3 / np.mean(cap_wall):.1f} "
          f"frames/s; eager intra_pose_all {percentiles(np, eager_ms)}, "
          f"{1e3 / np.mean(eager_wall):.1f} frames/s; eager / captured p50 "
          f"{np.percentile(eager_ms, 50) / np.percentile(cap_ms, 50):.2f}  ({card})")


def phase_4h(torch, np, dev, card, cfg_d, Ks2, dists2, frames, traj, counts):
    """The chunked session on CUDA graphs: run_chunked(chunk=CHUNK) from the
    bootstrap over CHUNKS chunks, checked as 4d checks intra_pose_all and
    against the same frames stepped eagerly (intra_pose_all); the captured
    step held to the eager step with torch.equal from identical static
    inputs and draws; frames/s and step p50/p99 captured
    against eager in turns, graph nodes and host reads a frame, the idle
    share, capture time. -> the session."""
    from coloc_tpu_torch import session
    from coloc_tpu_torch.ops import dispatch

    n_frames = CHUNK * CHUNKS + 1

    def tensors(p):
        return (p.pose.R, p.pose.C, p.cov, p.rmse, p.n_tracks, p.success)

    sess_c = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED)
    sess_e = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out_c = sess_c.run_chunked(frames, chunk=CHUNK, inter_every=0)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    counts["4h chunked"] = dispatch.launch_counts()
    g = sess_c._graphs
    check(g is not None, "run_chunked did not step a captured graph")
    check([r["pose_lm"] for r in g.records] == [1, 1, 0]
          and [r["pose_cov"] for r in g.records] == [0, 0, 1],
          f"4h: pose kernels a head, middle and tail graph "
          f"{[(r['pose_lm'], r['pose_cov']) for r in g.records]}, want one LM launch a head "
          f"or middle graph and one covariance a tail")
    errs, accepted = [], torch.zeros(2, dtype=torch.int32)
    out_e = {0: [], 1: []}
    equal = True
    check(sess_e.init_map({d: frames[d][0] for d in range(2)}), "4h eager init_map failed")
    for f in range(1, n_frames):
        sess_e.frame = f
        res = sess_e.intra_pose_all({d: frames[d][f] for d in range(2)})
        accepted += torch.stack([res[d].success for d in range(2)]).cpu().int() \
            * (~sess_e.last_rejected.cpu()).int()
        for d in range(2):
            out_e[d].append(res[d])
            pc = out_c[d][f - 1]
            check(bool(pc.success), f"4h frame {f} drone {d}: localization failed")
            R_gt = torch.from_numpy(traj[d][0][f] @ traj[0][0][0].T).to(dev)
            errs.append(rotation_error(torch, pc.pose.R, R_gt))
            check(float(torch.linalg.norm(pc.pose.C - res[d].pose.C)) < 0.03,
                  f"4h frame {f} drone {d}: captured and eager centres > 0.03 apart")
            equal = equal and all(torch.equal(a, b) for a, b in zip(tensors(pc),
                                                                     tensors(res[d])))
    check(len(out_c[0]) == n_frames - 1, f"4h: {len(out_c[0])} frames of {n_frames - 1}")
    check(torch.equal(sess_e.filter_bank.steps.cpu(), accepted),
          f"4h eager: filter steps {sess_e.filter_bank.steps.tolist()} != accepted "
          f"{accepted.tolist()}")
    check(torch.equal(sess_c.filter_bank.steps, sess_e.filter_bank.steps),
          f"4h: captured filter steps {sess_c.filter_bank.steps.tolist()}, eager "
          f"{sess_e.filter_bank.steps.tolist()}")
    errs_deg = np.degrees(np.asarray(errs))
    check(np.median(errs_deg) < 1.0 and errs_deg.max() < 2.0,
          f"4h rotation error median {np.median(errs_deg):.3f}, max {errs_deg.max():.3f} deg")
    print(f"[4h chunked] run_chunked(chunk={CHUNK}): init_map then {n_frames - 1} frames of 2 "
          f"drones ok in {wall_c:.3f} s; rotation error median {np.median(errs_deg):.4f}, max "
          f"{errs_deg.max():.4f} deg; filter steps {sess_c.filter_bank.steps.tolist()}; every "
          f"frame bit-equal to the eager run from the same seed: {equal}; capture "
          f"{g.capture_seconds:.3f} s; host reads {g.host_reads / (n_frames - 1):.2f} a frame")

    # the captured step against the eager step, identical static inputs and
    # draws (uniforms), frame by frame from one state
    block = torch.stack([torch.stack([torch.from_numpy(frames[d][f]) for d in range(2)])
                         for f in range(1, CHECKED + 1)]).to(dev)
    u = torch.stack([sess_c._draw(2) for _ in range(CHECKED)])
    g.load(sess_c)
    reads0 = g.host_reads
    fb, sup, last = sess_c.filter_bank, sess_c.lm_support, sess_c.lm_last_seen
    lm_launches = 0
    for f in range(CHECKED):
        before = dispatch.launch_counts()
        out = g.replay(block[f], u[f])
        after = dispatch.launch_counts()
        lm_launches += after["pose_lm"] - before["pose_lm"]
        check(after["pose_cov"] - before["pose_cov"] == 1,
              f"4h: frame {f} launched {after['pose_cov'] - before['pose_cov']} covariances")
        pwcs, fb, filt, dist_g, rej, eulers, sup_inc = session.intra_all_device_step(
            cfg_d, block[f], sess_c.mapdb, sess_c._map_bank(), sess_c.Ks, sess_c.dists, fb,
            uniforms=u[f])
        sup, last = session._support(sup, last, sup_inc, sess_c.frame + f)
        want = session._chunk_out(pwcs, filt, rej, dist_g, eulers, fb.P)
        for name, a, b in zip(want._fields, out, want):
            check(torch.equal(a, b), f"4h: captured {name} of frame {f} differs from the "
                  f"eager step's")
        for name, a, b in zip(("filter x", "filter P", "filter steps"), g.fb, fb):
            check(torch.equal(a, b), f"4h: captured {name} of frame {f} differs from eager")
        check(torch.equal(g.sup, sup) and torch.equal(g.last, last),
              f"4h: captured landmark support of frame {f} differs from eager")
    nodes = g.node_count()
    print(f"[4h equal] {CHECKED} frames: the captured step equal to the eager step on every "
          f"output, the filter bank and the support (torch.equal); "
          f"{nodes if nodes is not None else 'not measured'} graph nodes a frame (head and "
          f"tail), {(g.host_reads - reads0) / CHECKED:.2f} host reads a frame, "
          f"{lm_launches / CHECKED:.2f} pose_lm launches a frame (one a head or middle "
          f"replay), 1 pose_cov  ({card})")

    # frames/s and step p50/p99: captured chunks and eager frames in turns
    block_c = torch.stack([torch.stack([torch.from_numpy(frames[d][f]) for d in range(2)])
                           for f in range(1, CHUNK + 1)]).to(dev)
    chunk_timing(torch, np, "4h timing", sess_c, sess_e, block_c, card)
    profile_frames(torch, f"4h captured, a {CHUNK}-frame chunk",
                   lambda f: sess_c.intra_pose_chunk(block_c), 1, CHUNK)
    profile_frames(torch, "4h eager",
                   lambda f: sess_e.intra_pose_all({d: block_c[f, d] for d in range(2)}),
                   min(4, CHUNK))
    return sess_c


def phase_4h_akaze(torch, np, dev, card, cfg_a, sess_a, frames_h, traj_h, counts):
    """The AKAZE step on CUDA graphs, on 4f's session (its filter bank
    reset, its map kept): run_chunked over one CHUNK-frame chunk of 4h's
    frames 1-CHUNK, captured, every frame localized and checked against
    the ground truth; CHECKED frames of the captured step held to the eager
    step with torch.equal from identical inputs and uniforms; captured
    chunks and eager frames timed in turns, graph nodes and host reads a
    frame, capture seconds, a profile of a captured chunk."""
    from coloc_tpu_torch import session
    from coloc_tpu_torch.fusion import kalman
    from coloc_tpu_torch.ops import dispatch

    sess_a.filter_bank = kalman.init(2, cfg_a.filter, dev)
    sess_a.last_pose = {}
    frames = {d: frames_h[d][1:CHUNK + 1] for d in range(2)}
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = sess_a.run_chunked(frames, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["4h akaze chunked"] = dispatch.launch_counts()
    g = sess_a._graphs
    check(g is not None and g.mapdb is sess_a.mapdb,
          "4h AKAZE: run_chunked did not step a captured graph")
    errs = []
    for d in range(2):
        check(len(out[d]) == CHUNK, f"4h AKAZE: {len(out[d])} frames of {CHUNK}")
        for f, p in enumerate(out[d], start=1):
            check(bool(p.success), f"4h AKAZE frame {f} drone {d}: localization failed")
            R_gt = torch.from_numpy(traj_h[d][0][f] @ traj_h[0][0][0].T).to(dev)
            errs.append(rotation_error(torch, p.pose.R, R_gt))
    errs_deg = np.degrees(np.asarray(errs))
    check(np.median(errs_deg) < 1.0 and errs_deg.max() < 2.0,
          f"4h AKAZE rotation error median {np.median(errs_deg):.3f}, max "
          f"{errs_deg.max():.3f} deg")
    print(f"[4h akaze chunked] run_chunked(chunk={CHUNK}) with the AKAZE frontend on 4f's map: "
          f"{CHUNK} frames of 2 drones ok in {wall:.3f} s (capture included); rotation error "
          f"median {np.median(errs_deg):.4f}, max {errs_deg.max():.4f} deg; capture "
          f"{g.capture_seconds:.3f} s; launches {counts['4h akaze chunked']}  ({card})")

    block = torch.stack([torch.stack([torch.from_numpy(frames[d][f]) for d in range(2)])
                         for f in range(CHUNK)]).to(dev)
    u = torch.stack([sess_a._draw(2) for _ in range(CHECKED)])
    g.load(sess_a)
    reads0 = g.host_reads
    fb, sup, last = sess_a.filter_bank, sess_a.lm_support, sess_a.lm_last_seen
    check([r["pose_lm"] for r in g.records] == [1, 1, 0]
          and [r["pose_cov"] for r in g.records] == [0, 0, 1],
          f"4h AKAZE: pose kernels a head, middle and tail graph "
          f"{[(r['pose_lm'], r['pose_cov']) for r in g.records]}")
    lm_launches = 0
    for f in range(CHECKED):
        before = dispatch.launch_counts()
        got = g.replay(block[f], u[f])
        after = dispatch.launch_counts()
        lm_launches += after["pose_lm"] - before["pose_lm"]
        check(after["pose_cov"] - before["pose_cov"] == 1,
              f"4h AKAZE: frame {f} launched {after['pose_cov'] - before['pose_cov']} "
              f"covariances")
        pwcs, fb, filt, dist_g, rej, eulers, sup_inc = session.intra_all_device_step(
            cfg_a, block[f], sess_a.mapdb, sess_a._map_bank(), sess_a.Ks, sess_a.dists, fb,
            uniforms=u[f])
        sup, last = session._support(sup, last, sup_inc, sess_a.frame + f)
        want = session._chunk_out(pwcs, filt, rej, dist_g, eulers, fb.P)
        for name, a, b in zip(want._fields, got, want):
            check(torch.equal(a, b), f"4h AKAZE: captured {name} of frame {f} differs from "
                  f"the eager step's")
        for name, a, b in zip(("filter x", "filter P", "filter steps"), g.fb, fb):
            check(torch.equal(a, b), f"4h AKAZE: captured {name} of frame {f} differs")
        check(torch.equal(g.sup, sup) and torch.equal(g.last, last),
              f"4h AKAZE: captured landmark support of frame {f} differs from eager")
    nodes = g.node_count()
    print(f"[4h akaze equal] {CHECKED} frames: the captured AKAZE step equal to the eager step "
          f"on every output, the filter bank and the support (torch.equal); "
          f"{nodes if nodes is not None else 'not measured'} graph nodes a frame (head and "
          f"tail), {(g.host_reads - reads0) / CHECKED:.2f} host reads a frame, "
          f"{lm_launches / CHECKED:.2f} pose_lm launches a frame (one a head or middle "
          f"replay), 1 pose_cov  ({card})")
    chunk_timing(torch, np, "4h akaze timing", sess_a, sess_a, block, card)
    profile_frames(torch, f"4h akaze captured, a {CHUNK}-frame chunk",
                   lambda f: sess_a.intra_pose_chunk(block), 1, CHUNK)


def phase_4k(torch, np, dev, card, cfg_d, Ks2, dists2, frames_h, traj_h, counts):
    """The map lifecycle on the card, on 4d's configuration and bootstrap
    (its seed and frame 0 of 4h's trajectory, which is 4d's frame 0):
    extend_map on frame K_FRAME (growth, finite landmarks inside the |Z|
    gate, the next frame localized, a second extend adding under a quarter
    as many) and, on K_REF_FRAMES, against the plain CPU path from the
    same features and draws; merge_map_from of a Sim(3)-moved copy of the
    map plus 16 novel landmarks; one call of each of the two counted alone
    into counts; cull_map of planted junk after its grace window, and its
    keep_min floor; run over 4h's frames with extend_map_every=10 and
    cull_map_every=10; the three methods' p50 with launches, host reads and
    device kernels a call."""
    from types import SimpleNamespace

    from coloc_tpu_torch import convert, session
    from coloc_tpu_torch.geometry.camera import Camera
    from coloc_tpu_torch.ops import dispatch
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.sfm import localize
    from coloc_tpu_torch.types import Features, Pose, PoseWithCov

    t_4k = time.perf_counter()
    cap = cfg_d.max_landmarks

    def fresh(state, device=None):
        s = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED, device=device)
        convert.session_state_from_numpy(state, s)
        return s

    def snapshot(s):
        return SimpleNamespace(
            mapdb=convert.to_numpy(s.mapdb), scene=None,
            filter_bank=convert.to_numpy(s.filter_bank),
            lm_support=None if s.lm_support is None else s.lm_support.cpu().numpy(),
            lm_last_seen=None if s.lm_last_seen is None else s.lm_last_seen.cpu().numpy(),
            last_pose={}, frame=s.frame, map_ready=True)

    def localizes(s, f):
        s.frame = f
        res = s.intra_pose_all({d: frames_h[d][f] for d in range(2)})
        return all(bool(res[d].success) for d in range(2))

    boot = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED)
    check(boot.init_map({d: frames_h[d][0] for d in range(2)}), "4k: init_map failed")
    boot.frame = K_FRAME
    base = snapshot(boot)
    n0 = int(base.mapdb.valid.sum())
    images = {d: frames_h[d][K_FRAME] for d in range(2)}

    # ---- extend_map: growth, the gates, dedup, the grown map localizes
    # the lifecycle's counts: one extend_map call on the card, then (below)
    # one merge_map_from call
    sess = fresh(base)
    dispatch.reset_launch_counts()
    added = sess.extend_map(images)
    counts["4k extend_map"] = dispatch.launch_counts()
    valid = sess.mapdb.valid.cpu().numpy()
    X = sess.mapdb.X.cpu().numpy()[valid]
    check(added > 0 and int(valid.sum()) == n0 + added,
          f"4k extend_map: added {added} to {n0}, the map holds {int(valid.sum())}")
    check(bool(np.isfinite(X).all()) and float(np.abs(X[:, 2]).max()) < 1000.0,
          "4k extend_map: a landmark is not finite or outside |Z| < 1000")
    again = sess.extend_map(images)
    check(again < max(1, added // 4), f"4k extend_map again: {again} of {added} added again")
    check(localizes(sess, K_FRAME + 1), f"4k: the grown map lost frame {K_FRAME + 1}")
    print(f"[4k extend_map] frame {K_FRAME}: {added} landmarks added to {n0}, |Z| max "
          f"{float(np.abs(X[:, 2]).max()):.2f}; again with the same frames {again}; frame "
          f"{K_FRAME + 1} localized by both drones on the grown map")

    # ---- the card against the plain CPU path: same features, same draws;
    # then the CPU path given the card's poses, which leaves only the
    # triangulation to differ (P3P is held to its twin statistically, C8).
    # extend_map detects and localizes inside; both are swapped out for the
    # call so that every path starts from the card's features (and poses).
    real_detect, real_localize = session.detect_and_describe_batch, localize.localize_image

    def extend_from(s_x, f_x, imgs, idx, pose=None):
        session.detect_and_describe_batch = lambda *a, **k: f_x
        if pose is not None:
            localize.localize_image = lambda *a, **k: (pose, None)
        try:
            return s_x.extend_map(imgs, sample_idx=idx)
        finally:
            session.detect_and_describe_batch = real_detect
            localize.localize_image = real_localize

    def against_card(s_g, s_x):
        """Slots added on the card (s_g) and on the CPU (s_x) -> (Jaccard of
        the added slots, max |dX| m, max |dX| / |X|)."""
        X_g = s_g.mapdb.X.cpu().numpy()
        new_g = s_g.mapdb.valid.cpu().numpy() & ~base.mapdb.valid
        new_x = s_x.mapdb.valid.numpy() & ~base.mapdb.valid
        both = new_g & new_x
        dX = np.linalg.norm(X_g[both] - s_x.mapdb.X.numpy()[both], axis=1)
        rel = dX / np.linalg.norm(X_g[both], axis=1)
        return (float(both.sum()) / max(float((new_g | new_x).sum()), 1.0),
                float(dX.max(initial=0.0)), float(rel.max(initial=0.0)))

    for f in K_REF_FRAMES:
        imgs = {d: frames_h[d][f] for d in range(2)}
        feats = real_detect(torch.stack([torch.from_numpy(imgs[d]) for d in range(2)]).to(dev),
                            cfg_d.detector)
        feats_c = Features(*(t.cpu() for t in feats))
        mm = session._match_drones(cfg_d, feats, boot._map_bank())
        draws = sample_indices(mm.mask & feats.valid, cfg_d.ransac.num_hypotheses, 3,
                               torch.Generator(device=dev).manual_seed(SEED + 13))
        poses = {}
        for tag, s_x, f_x, idx in (("card", fresh(base), feats, draws),
                                   ("cpu", fresh(base, "cpu"), feats_c, draws.cpu())):
            m_x = session._match_drones(cfg_d, f_x, s_x._map_bank())
            poses[tag], _ = localize.localize_image(
                f_x, m_x, s_x.mapdb, Camera(K=s_x.Ks, dist=s_x.dists), cfg_d.ransac,
                cfg_d.refiner, sample_idx=idx, check_every=session.LM_CHECK_EVERY)
        pg, pc = poses["card"], poses["cpu"]
        d_pose = [(rotation_error(torch, pg.pose.R[d].cpu(), pc.pose.R[d]),
                   float(torch.linalg.norm(pg.pose.C[d].cpu() - pc.pose.C[d])),
                   int(pg.n_tracks[d]), int(pc.n_tracks[d])) for d in range(2)]
        card_pose = PoseWithCov(Pose(pg.pose.R.cpu(), pg.pose.C.cpu()),
                                *(t.cpu() for t in pg[1:]))
        s_g, s_c, s_p = fresh(base), fresh(base, "cpu"), fresh(base, "cpu")
        a_g = extend_from(s_g, feats, imgs, draws)
        a_c = extend_from(s_c, feats_c, imgs, draws.cpu())
        a_p = extend_from(s_p, feats_c, imgs, draws.cpu(), card_pose)
        (j_c, dX_c, rel_c), (j_p, dX_p, rel_p) = against_card(s_g, s_c), against_card(s_g, s_p)
        print(f"[4k reference] frame {f}: extend_map card vs CPU plain path, same features "
              f"and draws: {a_g} / {a_c} added, Jaccard {j_c:.4f}, X {dX_c:.2e} m "
              f"({rel_c:.2e} of |X|) apart at most; the drones' poses (rad, m, tracks card / "
              f"CPU) {d_pose}; the CPU path given the card's poses: {a_p} added, Jaccard "
              f"{j_p:.4f}, X {dX_p:.2e} m ({rel_p:.2e} of |X|) apart at most")
        check(a_g > 0 and min(j_c, j_p) >= 0.98,
              f"4k card vs CPU, frame {f}: Jaccard {j_c:.4f}, {j_p:.4f} with the card's "
              f"poses, < 0.98")
        # the poses as 4i and 4j hold the card to the CPU (C8), the landmarks
        # end to end within 5e-3 of |X|; with the poses shared, within 1e-3 m
        check(all(dr < 1e-3 and dc < 1e-2 for dr, dc, _, _ in d_pose),
              f"4k card vs CPU, frame {f}: the drones' poses {d_pose} apart")
        check(rel_c < 5e-3, f"4k card vs CPU, frame {f}: X {rel_c:.2e} of |X| apart")
        check(dX_p < 1e-3,
              f"4k card vs CPU with the same poses, frame {f}: X {dX_p:.2e} m apart")

    # ---- merge_map_from: a Sim(3)-moved copy plus 16 novel landmarks
    rng = np.random.default_rng(SEED + 7)
    s_o, ang, t_o = 2.5, 0.8, np.array([1.0, -2.0, 0.5])
    R_o = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    v0 = base.mapdb.valid
    X_gt = rng.uniform(-4.0, 4.0, (16, 3))
    o_X = np.zeros((cap, 3), np.float32)
    o_X[:n0] = (s_o * (R_o @ base.mapdb.X[v0].T.astype(np.float64))).T + t_o
    o_X[n0:n0 + 16] = (s_o * (R_o @ X_gt.T)).T + t_o
    o_desc = np.array(base.mapdb.desc)
    o_desc[:n0] = base.mapdb.desc[v0]
    o_desc[n0:n0 + 16] = rng.integers(0, 2**32, (16, 16), dtype=np.uint64).astype(np.uint32)
    o_valid = np.zeros(cap, bool)
    o_valid[:n0 + 16] = True
    other = convert.mapdb_from_numpy(SimpleNamespace(X=o_X, desc=o_desc, valid=o_valid), dev)
    s_m = fresh(base)
    dispatch.reset_launch_counts()
    merged = s_m.merge_map_from(other)
    counts["4k merge_map_from"] = dispatch.launch_counts()
    slots = np.flatnonzero(~v0)[:16]
    err = float(np.linalg.norm(s_m.mapdb.X.cpu().numpy()[slots] - X_gt, axis=1).max())
    check(merged == 16, f"4k merge_map_from: {merged} added, 16 novel")
    check(err < 1e-2, f"4k merge_map_from: novel landmarks {err:.2e} from their ground truth")
    check(localizes(s_m, K_FRAME), "4k: the merged map does not localize")
    print(f"[4k merge_map_from] a Sim(3)-moved copy (s 2.5, 0.8 rad) of the {n0} landmarks plus "
          f"16 novel: {merged} added, {err:.2e} from their ground truth at most; the merged "
          f"map localizes frame {K_FRAME}")

    # ---- cull_map: 64 junk landmarks culled after the grace window
    s_k = fresh(base)
    junk = np.flatnonzero(~v0)[:64]
    jX, jdesc, jvalid = base.mapdb.X.copy(), base.mapdb.desc.copy(), v0.copy()
    jX[junk] = rng.uniform(50.0, 60.0, (junk.size, 3)).astype(np.float32)
    jdesc[junk] = rng.integers(0, 2**32, (junk.size, 16), dtype=np.uint64).astype(np.uint32)
    jvalid[junk] = True
    s_k.mapdb = convert.mapdb_from_numpy(SimpleNamespace(X=jX, desc=jdesc, valid=jvalid), dev)
    s_k._stamp_new_slots(junk)
    for f in range(K_FRAME, K_FRAME + 3):
        check(localizes(s_k, f), f"4k cull: frame {f} not localized with the junk planted")
    sup = s_k.lm_support.cpu().numpy()
    check(int((sup > 0).sum()) > 8, f"4k cull: {int((sup > 0).sum())} supported landmarks")
    check(s_k.cull_map(max_age=16, min_support=2) == 0, "4k cull: culled inside the grace window")
    aged = snapshot(s_k)
    aged.frame = s_k.frame + 40
    s_k.frame = aged.frame
    culled = s_k.cull_map(max_age=16, min_support=2, keep_min=8)
    after = s_k.mapdb.valid.cpu().numpy()
    check(culled > 0 and not after[junk].any(), f"4k cull: {culled} culled, junk left "
          f"{int(after[junk].sum())}")
    check(bool(after[sup >= 2].all()), "4k cull: a landmark with support >= 2 was culled")
    check(bool((s_k.lm_last_seen.cpu().numpy()[junk] == -1).all()),
          "4k cull: freed slots not stamped -1")
    check(localizes(s_k, K_FRAME + 3), "4k: the culled map does not localize")
    s_f = fresh(base)
    check(localizes(s_f, K_FRAME), f"4k keep_min: frame {K_FRAME} not localized")
    sup_f = s_f.lm_support.cpu().numpy()
    s_f.frame = 500
    floor = s_f.cull_map(max_age=16, min_support=10**6, keep_min=16)
    kept = s_f.mapdb.valid.cpu().numpy()
    dropped = v0 & ~kept
    check(floor == n0 - 16 and int(kept.sum()) == 16
          and sup_f[kept].min() >= sup_f[dropped].max(),
          f"4k keep_min: {floor} culled, {int(kept.sum())} kept")
    print(f"[4k cull_map] 64 junk landmarks: none culled in the grace window, then {culled} "
          f"culled ({int((sup >= 2).sum())} with support >= 2 kept), the map localizes; "
          f"keep_min=16 spared the 16 strongest of {n0}")

    # ---- run with the extend and cull schedule over 4h's frames
    n_h = len(frames_h[0])
    s_r = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED)
    log, real_extend, real_cull = [], s_r.extend_map, s_r.cull_map

    def extend_map(imgs, **kw):
        log.append(("extend", s_r.frame, real_extend(imgs, **kw)))
        return log[-1][2]

    def cull_map(**kw):
        log.append(("cull", s_r.frame, real_cull(**kw)))
        return log[-1][2]

    s_r.extend_map, s_r.cull_map = extend_map, cull_map
    t0 = time.perf_counter()
    out = s_r.run(frames_h, inter_every=0, extend_map_every=10, cull_map_every=10,
                  cull_max_age=16, cull_min_support=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = [(k, f) for f in range(10, n_h, 10) for k in ("extend", "cull")]
    check([(k, f) for k, f, _ in log] == want, f"4k run: lifecycle calls {log}, want {want}")
    lost = [sum(not bool(p.success) for p in out[d]) for d in range(2)]
    check(all(len(out[d]) == n_h - 1 for d in range(2)) and max(lost) <= 1,
          f"4k run: frames not localized by drone {lost}")
    print(f"[4k run] run(extend_map_every=10, cull_map_every=10, cull_max_age=16, "
          f"cull_min_support=1) over {n_h - 1} frames in {wall:.3f} s: (call, frame, count) "
          f"{log}; frames lost by drone {lost}; {int(s_r.mapdb.valid.sum())} landmarks at the "
          f"end  ({card})")

    # ---- each method's latency, launches, host reads and device kernels;
    # each timed call launches what the counted call did (cull_map nothing)
    calls = {"extend_map": (base, lambda s: s.extend_map(images)),
             "merge_map_from": (base, lambda s: s.merge_map_from(other)),
             "cull_map": (aged, lambda s: s.cull_map(max_age=16, min_support=2,
                                                           keep_min=8))}
    for name, (state, fn) in calls.items():
        counted = {k: v for k, v in counts.get(f"4k {name}", {}).items() if v}
        ms = []
        for i in range(LIFECYCLE_CALLS + 1):
            s = fresh(state)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = dispatch.launch_counts()
            start.record()
            fn(s)
            end.record()
            torch.cuda.synchronize()
            if i:
                ms.append(start.elapsed_time(end))
            launches = {k: v - before[k] for k, v in dispatch.launch_counts().items()
                        if v > before[k]}
        check(launches == counted, f"4k {name}: {launches} launched by the last timed call, "
              f"{counted} by the counted one")
        s = fresh(state)
        _, reads = host_reads(torch, lambda: fn(s))
        print(f"[4k timing] {name}: {percentiles(np, ms)} over {LIFECYCLE_CALLS} calls; "
              f"launches a call {launches}; {reads} host reads a call  ({card})")
        sessions = [fresh(state) for _ in range(2)]
        profile_frames(torch, f"4k {name}", lambda f: fn(sessions[f]), 2, unit="call")
    print(f"[time] 4k took {time.perf_counter() - t_4k:.1f} s")


def phase_4l(torch, np, dev, card, cfg_d, Ks2, dists2, frames_h, counts):
    """The session's plumbing on the card, on 4d's configuration and
    bootstrap (frame 0 of 4h's trajectory): a session with out_dir,
    profile=True, debug_dir and a LiveViz through init_map, L_EAGER eager
    frames (intra_pose_all, then intra_pose of each drone on the last),
    a checkpoint, one run_chunked(chunk=CHUNK) on CUDA graphs and a fusion;
    the loaded checkpoint stepped eagerly over the chunk's frames, every
    output torch.equal and every log row text-equal to the captured
    chunk's; the CSV row counts, map.ply, the SVG names, state.json, the
    profiler's stages, a trace_to file; the sync check with out_dir set;
    host reads and graph nodes a captured frame with and without out_dir;
    a checkpoint written on the CPU loaded into a card session (the
    generator's device-type rule); save_session, load_session and
    flush_logs p50."""
    import shutil
    import tempfile
    import urllib.request

    from coloc_tpu_torch import checkpoint, session
    from coloc_tpu_torch.io.liveviz import LiveViz
    from coloc_tpu_torch.ops import dispatch
    from coloc_tpu_torch.profiling import trace_to

    t_4l = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="coloc-4l-"))
    D, E = 2, L_EAGER
    chunk = {d: frames_h[d][E + 1:E + 1 + CHUNK] for d in range(D)}
    viz = LiveViz(port=0)

    def rows(out_dir, name):
        return (out_dir / name).read_text().splitlines()

    def outputs(p):
        return (*p.pose, p.cov, p.rmse, p.n_tracks, p.success)

    try:
        dispatch.reset_launch_counts()
        a_dir = root / "a"
        s_a = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED, out_dir=str(a_dir),
                                   profile=True, viz=viz, debug_dir=str(root / "svg"))
        check(s_a.init_map({d: frames_h[d][0] for d in range(D)}), "4l: init_map failed")
        for f in range(1, E):
            s_a.frame = f
            res = s_a.intra_pose_all({d: frames_h[d][f] for d in range(D)})
            check(all(bool(res[d].success) for d in range(D)), f"4l frame {f} not localized")
        check(len(rows(a_dir, "poses.txt")) == 1, "4l: intra_pose_all wrote before flush_logs")
        s_a.frame = E
        for d in range(D):
            check(bool(s_a.intra_pose(d, frames_h[d][E]).success), f"4l intra_pose {d} failed")
        check(len(rows(a_dir, "poses.txt")) == 1 + D, "4l: intra_pose did not log at once")
        s_a.flush_logs()
        check(len(rows(a_dir, "poses.txt")) == 1 + D * E, "4l: flush_logs")

        # the checkpoint: saved after frame E, timed; loaded into sessions
        ckpt = root / "after_eager.npz"
        save_ms, load_ms = [], []
        for _ in range(L_CALLS):
            t0 = time.perf_counter()
            checkpoint.save_session(str(ckpt), s_a)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        b_dir = root / "b"
        s_b = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED + 1, out_dir=str(b_dir))
        for _ in range(L_CALLS):
            t0 = time.perf_counter()
            checkpoint.load_session(str(ckpt), s_b)
            torch.cuda.synchronize()
            load_ms.append((time.perf_counter() - t0) * 1e3)

        # one chunk on CUDA graphs, and the same frames eagerly from the file
        out_a = s_a.run_chunked(chunk, chunk=CHUNK)
        torch.cuda.synchronize()
        counts["4l plumbing"] = dispatch.launch_counts()
        check(s_a._graphs is not None, "4l: run_chunked did not replay a captured graph")
        out_b = {d: [] for d in range(D)}
        for i in range(CHUNK):
            s_b.frame = i
            res = s_b.intra_pose_all({d: chunk[d][i] for d in range(D)})
            for d in range(D):
                out_b[d].append(res[d])
        s_b.close()
        for d in range(D):
            for i, (pa, pb) in enumerate(zip(out_a[d], out_b[d])):
                check(bool(pa.success), f"4l chunk frame {i} drone {d}: not localized")
                check(all(torch.equal(x, y) for x, y in zip(outputs(pa), outputs(pb))),
                      f"4l: the loaded session's eager frame {i} differs from the captured "
                      f"chunk's (drone {d})")
        for name in ("poses.txt", "poses_filtered.txt", "mahalanobis.txt"):
            ra, rb = rows(a_dir, name), rows(b_dir, name)
            head = 0 if name == "mahalanobis.txt" else 1
            check(len(ra) == head + D * (E + CHUNK) and len(rb) == head + D * CHUNK,
                  f"4l {name}: {len(ra)} and {len(rb)} rows")
            check(ra[head + D * E:] == rb[head:], f"4l {name}: the captured chunk's rows are "
                  f"not the eager frames' rows")

        # a fusion on the chunk's last frame: guided residuals, a (dest, src)
        # row, the inter overlays
        last = {d: chunk[d][-1] for d in range(D)}
        s_a.frame = CHUNK - 1
        check(s_a.inter_pose(0, 1, last) is not None, "4l: inter_pose failed")
        guided = rows(a_dir, "guidedmatches2.txt")
        fused_row = rows(a_dir, "poses_filtered.txt")[-1].split(",")
        check(len(guided) > 0 and fused_row[:3] == [str(CHUNK - 1), "1", "0"],
              f"4l: guidedmatches2.txt {len(guided)} rows, fused row {fused_row[:3]}")
        s_a.close()

        ply = rows(a_dir, "map.ply")
        n_ply = int(s_a.scene.X_valid.sum()) + s_a.scene.Rs.shape[0]
        check(f"element vertex {n_ply}" in ply and len(ply) == 10 + n_ply,
              f"4l map.ply: {len(ply) - 10} vertices, {n_ply} expected")
        want = {"init_features_d0.svg", "init_features_d1.svg", "init_putative_0_1.svg",
                "init_inlier_0_1.svg", f"inter{CHUNK - 1:04d}_s0_d1_putative.svg",
                f"inter{CHUNK - 1:04d}_s0_d1_guided.svg"}
        want |= {f"frame{f:04d}_d{d}_{k}.svg" for f in range(1, E + 1) for d in range(D)
                 for k in ("features", "map_matches")}
        names = {p.name for p in (root / "svg").iterdir()}
        check(names == want, f"4l SVGs: {sorted(names ^ want)} differ")
        check(all((root / "svg" / n).read_text().startswith("<svg") for n in names),
              "4l: an SVG does not start with <svg")
        with urllib.request.urlopen(viz.url + "state.json", timeout=5) as r:
            state = json.loads(r.read().decode())
        check(set(state["poses"]) == {"0", "1"} and state["frame"] == CHUNK - 1
              and len(state["map"]) == int(s_a.mapdb.valid.sum()),
              f"4l state.json: poses {sorted(state['poses'])}, frame {state['frame']}, "
              f"{len(state['map'])} map points")
        prof = s_a.profiler.summary()
        stages = {k: prof[k]["count"] for k in ("intra_step", "intra_step_all", "intra_chunk")}
        check(stages == {"intra_step": D, "intra_step_all": E - 1, "intra_chunk": 1},
              f"4l profiler stages {stages}")
        with trace_to(str(root / "trace")):
            s_b.intra_pose_all({d: chunk[d][0] for d in range(D)})
            torch.cuda.synchronize()
        traces = list((root / "trace").iterdir())
        check(len(traces) == 1 and traces[0].stat().st_size > 0, "4l: trace_to wrote no trace")
        print(f"[4l plumbing] init_map, {E} eager frames, a {CHUNK}-frame chunk on CUDA "
              f"graphs and a fusion with out_dir, profile, debug_dir and a LiveViz: "
              f"{len(rows(a_dir, 'poses.txt')) - 1} pose rows, {len(guided)} guided residuals, "
              f"map.ply {n_ply} vertices, {len(names)} SVGs, state.json {len(state['map'])} map "
              f"points; the loaded checkpoint's eager frames torch.equal to the captured "
              f"chunk and its rows text-equal; profiler " + ", ".join(
                  f"{k} n={v} p50 {prof[k]['p50_ms']:.3f} ms" for k, v in stages.items())
              + f"; trace {traces[0].stat().st_size} bytes  ({card})")

        # the sync check with out_dir set, and a captured frame's host reads
        # and graph nodes with and without out_dir
        imgs = torch.stack([torch.from_numpy(chunk[d][0]) for d in range(D)]).to(dev)
        sync_check(torch, cfg_d, s_b, imgs, "4l out_dir, mode error", mode="error")
        block = torch.stack([torch.stack([torch.from_numpy(chunk[d][i]) for d in range(D)])
                             for i in range(CHUNK)]).to(dev)
        per = {}
        for tag, kw in (("out_dir", {"out_dir": str(root / "c")}), ("none", {})):
            s_x = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED, **kw)
            checkpoint.load_session(str(ckpt), s_x)
            s_x.intra_pose_chunk(block)              # captures
            reads0 = s_x._graphs.host_reads
            _, reads = host_reads(torch, lambda: s_x.intra_pose_chunk(block))
            per[tag] = (reads / CHUNK, (s_x._graphs.host_reads - reads0) / CHUNK,
                        s_x._graphs.node_count())
            if tag == "out_dir":
                entries = list(s_x._pending_logs)
                check(len(entries) == 2 * CHUNK, f"4l: {len(entries)} queued entries")
                flush_ms = []
                for _ in range(L_CALLS):
                    s_x._pending_logs = list(entries)
                    t0 = time.perf_counter()
                    s_x.flush_logs()
                    flush_ms.append((time.perf_counter() - t0) * 1e3)
        check(per["out_dir"] == per["none"], f"4l: a captured frame with out_dir {per['out_dir']}"
              f", without {per['none']} (host reads, LM exit reads, graph nodes)")
        print(f"[4l host reads] a captured frame, with and without out_dir: {per['none'][0]:.2f} "
              f"synchronising operations ({per['none'][1]:.2f} of them the LM's exit), "
              f"{per['none'][2] if per['none'][2] is not None else 'not measured'} graph nodes; "
              f"flush_logs of {CHUNK} frames {percentiles(np, flush_ms)}; save_session "
              f"{percentiles(np, save_ms)}, load_session {percentiles(np, load_ms)} over "
              f"{L_CALLS} calls  ({card})")

        # a checkpoint written on the CPU into a card session: seeded from key
        s_cpu = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED, device="cpu")
        checkpoint.load_session(str(ckpt), s_cpu)
        key = np.load(ckpt)["key"]
        check(s_cpu.generator.initial_seed() == checkpoint.key_to_seed(key),
              "4l: a card checkpoint on the CPU did not seed from its key")
        ckpt_cpu = root / "cpu.npz"
        checkpoint.save_session(str(ckpt_cpu), s_cpu)
        s_g = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED + 2)
        checkpoint.load_session(str(ckpt_cpu), s_g)
        key_cpu = np.load(ckpt_cpu)["key"]
        check(s_g.generator.initial_seed() == checkpoint.key_to_seed(key_cpu),
              "4l: a CPU checkpoint on the card did not seed from its key")
        s_g.frame = E + 1
        res = s_g.intra_pose_all({d: frames_h[d][E + 1] for d in range(D)})
        check(all(bool(res[d].success) for d in range(D)),
              "4l: the card session from a CPU checkpoint does not localize")
        print(f"[4l checkpoint] card -> CPU -> card: each load on another device type seeded "
              f"from key ({checkpoint.key_to_seed(key_cpu):#018x}); frame {E + 1} localized "
              f"by both drones")
    finally:
        viz.close()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[time] 4l took {time.perf_counter() - t_4l:.1f} s")


def phase_4m(torch, np, dev, card, cfg, opts, K, scene, counts):
    """Batched serving on the card: 4b's bench map (the bench frame's
    features, LANDMARKS slots) with the scene's plane depths, so that every
    view agrees with it, and SERVE_POSES renders of the bench scene along
    drone 0's trajectory. localize_frames and localize_features on them
    (every stream within 4b's pose gate of its true pose); with injected
    draws each stream against a single-stream localize_image; set_map with
    permuted slots; then at SERVE_SIZES streams (bench.py's, the renders
    repeated): p50/p99 a dispatch by CUDA events, streams/s, launches, host
    reads, device kernels and the idle share; B1 at Q = B x KP against the
    bank, held to its twin, with its bound."""
    from coloc_tpu_torch import convert, serving
    from coloc_tpu_torch.frontend import detect_and_describe, detect_and_describe_batch
    from coloc_tpu_torch.io import synthetic
    from coloc_tpu_torch.ops import dispatch, hamming
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.sfm import localize
    from coloc_tpu_torch.types import Features, MapDB, Matches

    t_4m = time.perf_counter()
    cfg = dataclasses.replace(cfg, detector=opts)    # localize_frames' frontend
    eye = np.eye(3, dtype=np.float32)
    frame0 = synthetic.render(scene, eye, np.zeros(3, np.float32)).astype(np.float32)
    f0 = convert.to_numpy(detect_and_describe(torch.from_numpy(frame0).to(dev), opts))
    ma = synthetic.consistent_mapdb(f0, K, LANDMARKS, np.random.default_rng(SEED))
    # the first KP landmarks at the depth of the plane each bearing meets
    x, y = f0.xy[:, 0], f0.xy[:, 1]
    near = synthetic._bilinear(scene.alphas[0], np.clip(x, 0, W - 1.01),
                               np.clip(y, 0, H - 1.01)) > 0.5
    Z = np.where(near, scene.depths[0], scene.depths[1])
    X = ma.X.copy()
    X[:KP] = ((np.linalg.inv(K) @ np.c_[f0.xy, np.ones(KP)].T).T * Z[:, None]).astype(np.float32)
    mapdb = convert.mapdb_from_numpy(ma._replace(X=X), dev)
    Rs, Cs = synthetic.trajectory(SERVE_POSES, 0)
    images = render_frames(np, synthetic, scene, [(Rs, Cs)], SERVE_POSES)[0]
    images = torch.from_numpy(np.stack(images)).to(dev)
    R_gt, C_gt = torch.from_numpy(Rs).to(dev), torch.from_numpy(Cs).to(dev)
    cam = convert.camera_from_numpy(K, device=dev)
    eng = serving.ServingEngine(mapdb, cam, cfg)
    check(eng.device == dev, f"ServingEngine chose {eng.device}, not {dev}")

    def gate(tag, pwc, idx):
        for b in range(pwc.success.shape[0]):
            rot = rotation_error(torch, pwc.pose.R[b], R_gt[idx[b]])
            c_err = float(torch.linalg.norm(pwc.pose.C[b] - C_gt[idx[b]]))
            check(bool(pwc.success[b]) and rot < SERVE_GATE[0] and c_err < SERVE_GATE[1],
                  f"4m {tag} stream {b}: success {bool(pwc.success[b])}, rotation {rot:.2e} "
                  f"rad, centre {c_err:.2e} m")

    dispatch.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    every = torch.arange(SERVE_POSES)
    pwc_f, _, mm_f = eng.localize_frames(images, generator=gen)
    gate("localize_frames", pwc_f, every)
    feats = detect_and_describe_batch(images, opts)
    pwc, inl, mm = eng.localize_features(feats, generator=gen)
    gate("localize_features", pwc, every)
    counts["4m serving"] = dispatch.launch_counts()
    tracks = pwc.n_tracks.tolist()
    print(f"[4m serving] {SERVE_POSES} streams of the bench scene along drone 0's trajectory "
          f"(up to {float(np.linalg.norm(Cs, axis=1).max()):.3f} m from the map's view): "
          f"localize_frames and localize_features every stream within {SERVE_GATE[0]} rad "
          f"and {SERVE_GATE[1]} m; "
          f"n_tracks {min(tracks)}-{max(tracks)}; launches {counts['4m serving']}  ({card})")

    # each stream against a single-stream localize_image, same draws
    draws = sample_indices(mm.mask & feats.valid, cfg.ransac.num_hypotheses, 3,
                           torch.Generator(device=dev).manual_seed(SEED + 41))
    pwc_i, inl_i, mm_i = eng.localize_features(feats, sample_idx=draws)
    equal, d_rot, d_c = True, 0.0, 0.0
    for b in range(SERVE_POSES):
        one, inl1 = localize.localize_image(
            Features(*(t[b] for t in feats)), Matches(*(t[b] for t in mm_i)), eng.mapdb, cam,
            cfg.ransac, cfg.refiner, sample_idx=draws[b], check_every=serving.LM_CHECK_EVERY)
        check(torch.equal(one.success, pwc_i.success[b]) and torch.equal(one.n_tracks,
                                                                         pwc_i.n_tracks[b])
              and torch.equal(inl1, inl_i[b]),
              f"4m stream {b}: success, n_tracks or inliers differ from a single-stream call")
        equal = equal and all(torch.equal(x, y) for x, y in zip(
            (*one.pose, one.cov, one.rmse), (pwc_i.pose.R[b], pwc_i.pose.C[b], pwc_i.cov[b],
                                              pwc_i.rmse[b])))
        d_rot = max(d_rot, rotation_error(torch, one.pose.R, pwc_i.pose.R[b]))
        d_c = max(d_c, float(torch.linalg.norm(one.pose.C - pwc_i.pose.C[b])))
    # the RANSAC's outputs are equal; the pose LM's batched reductions round
    # apart at another batch shape (5.6e-7 rad and 5.7e-6 m at most measured
    # on the card), so the refined pose is held within 5e-6 rad and 5e-5 m
    check(d_rot < 5e-6 and d_c < 5e-5, f"4m: streams {d_rot:.2e} rad, {d_c:.2e} m from "
          f"single-stream calls")
    print(f"[4m streams] with injected draws every stream against localize_image alone: "
          f"success, n_tracks and inliers equal; pose, covariance and rmse bit-equal: {equal}; "
          f"at most {d_rot:.2e} rad and {d_c:.2e} m apart")

    # set_map with permuted slots: the same poses, the indices follow
    perm = torch.randperm(LANDMARKS, generator=torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    eng.set_map(MapDB(*(t[perm] for t in mapdb)))
    pwc_p, _, mm_p = eng.localize_features(feats, sample_idx=draws)
    inv = torch.argsort(perm).to(torch.int32)
    ok = mm_i.idx >= 0
    check(torch.equal(mm_p.idx >= 0, ok) and torch.equal(
        mm_p.idx[ok], inv[mm_i.idx[ok].long()]), "4m set_map: the match indices do not follow")
    dp = max(float((pwc_p.pose.R - pwc_i.pose.R).abs().max()),
             float((pwc_p.pose.C - pwc_i.pose.C).abs().max()))
    check(dp < 1e-4, f"4m set_map: poses {dp:.2e} apart")
    eng.set_map(mapdb)
    print(f"[4m set_map] {LANDMARKS} slots permuted: match indices follow, poses within "
          f"{dp:.2e}")

    # throughput and latency at bench.py's stream counts
    bank = eng.bank
    for B in SERVE_SIZES:
        sel = torch.arange(B, device=dev) % SERVE_POSES
        fb = Features(*(t[sel] for t in feats))
        gen_b = torch.Generator(device=dev).manual_seed(SEED + B)
        eng.localize_features(fb, generator=gen_b)          # warm-up
        torch.cuda.synchronize()
        before = dispatch.launch_counts()
        ms, outs = [], []
        t0 = time.perf_counter()
        for _ in range(SERVE_CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(eng.localize_features(fb, generator=gen_b)[0])
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        wall = time.perf_counter() - t0
        launches = {k: (v - before[k]) / SERVE_CALLS for k, v in dispatch.launch_counts().items()
                    if v > before[k]}
        for p in outs:
            gate(f"B={B}", p, sel.cpu())
        _, reads = host_reads(torch, lambda: eng.localize_features(fb, generator=gen_b))
        print(f"[4m B={B}] localize_features {percentiles(np, ms)} a dispatch over "
              f"{SERVE_CALLS}, {B * SERVE_CALLS / wall:.0f} streams/s; launches a dispatch "
              f"{launches}; {reads} host reads a dispatch  ({card})")
        check(all(launches.get(k, 0) >= 1 for k in ("k2nn", "p3p", "ransac_rank")),
              f"4m B={B}: a dispatch launched {launches}")
        profile_frames(torch, f"4m B={B}", lambda f: eng.localize_features(fb, generator=gen_b),
                       2, unit="dispatch")
        # B1 at this dispatch's shape: Q = B x KP queries against the bank
        q, qv = fb.desc.reshape(B * KP, -1), fb.valid.reshape(-1)
        out_k = hamming._hamming_2nn_cuda(q, qv, bank)
        if B in (SERVE_SIZES[0], SERVE_SIZES[-1]):
            out_p = hamming.hamming_2nn_plain(q, qv, bank)
            check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
                  f"4m: B1 at Q={B * KP} differs from its twin")
        bnd = bound(B * KP * 65 + LANDMARKS * 68 + 12 * B * KP, 2.0 * B * KP * LANDMARKS * 512,
                    INT8_OPS)
        k_ms = cuda_ms(lambda: hamming._hamming_2nn_cuda(q, qv, bank), iters=20)
        k_dev = device_ms(lambda: hamming._hamming_2nn_cuda(q, qv, bank), "k2nn")
        plain = ""
        if B == SERVE_SIZES[0]:
            p_ms = cuda_ms(lambda: hamming.hamming_2nn_plain(q, qv, bank), warmup=2, iters=5)
            plain = f"; plain twin {p_ms:.4f} ms"
        print(f"[4m B1] Q={B * KP} x T={LANDMARKS}: wrapper {fmt_ms(k_ms)}, device "
              f"{fmt_ms(k_dev)}; bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}){plain}"
              + ("; equal to the twin" if B in (SERVE_SIZES[0], SERVE_SIZES[-1]) else "")
              + f"  ({card})")
    print(f"[time] 4m took {time.perf_counter() - t_4m:.1f} s")
    return mapdb, images, R_gt, C_gt


def wall_ms(torch, fn, n):
    """fn() n times, each timed on the host clock with the card synchronised
    after it -> (last result, [ms])."""
    out, ms = None, []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def read_line(proc, prefix, tag, timeout=240.0):
    """The first line of a subprocess's stdout that starts with `prefix`
    (the lines before it are kept in proc.seen)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        proc.seen.append(line.rstrip())
        if line.startswith(prefix):
            return line.strip()
    raise SmokeFailure(f"4n {tag}: no line starting {prefix!r}; output so far:\n"
                       + "\n".join(proc.seen[-20:]))


def entry_point(args, repo, log):
    """`python -m <args>` from the checkout's root, stdout piped as text
    and stderr to `log`."""
    import os

    env = dict(os.environ, PYTHONPATH=str(repo), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=str(repo), env=env,
                            stdout=subprocess.PIPE, stderr=log, text=True)
    proc.seen = []
    return proc


def phase_4n(torch, np, dev, card, cfg, opts, K, scene, serve_w, cfg_d, map_path, frames,
             traj, counts):
    """The runtime over the topic bus: (a) the native libraries built with
    g++; (b) ServeRunner at B = N_SERVE over an in-process broker against
    4m's map and renders: every pose received, equal to the runner's
    return and to ServingEngine.localize_frames from the same generator
    state, within 4m's gate; round-trip p50/p99 beside localize_frames
    alone, host reads and launches a dispatch; (c) two DronePeers on two
    threads sharing 4d's saved map, stepping 4d's frames: poses equal to a
    one-drone session's intra_pose with the same seed; bundles over the
    bus, each fuses the other's; inter_fuse with injected draws equal to
    session.inter_pose, inside 4i's gates; the bundle's bytes and
    inter_fuse's p50 over the wire beside inter_pose's; (d) the three
    entry points as subprocesses on the card."""
    import shutil
    import tempfile
    import threading

    from coloc_tpu_torch import checkpoint, distributed, serve, session
    from coloc_tpu_torch.io import _native, disk, native_loader, synthetic, transport
    from coloc_tpu_torch.matching import match_pair
    from coloc_tpu_torch.ops import dispatch
    from coloc_tpu_torch.parallel import mesh
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.types import Pose, PoseWithCov

    t_4n = time.perf_counter()
    repo = Path(__file__).resolve().parent
    root = Path(tempfile.mkdtemp(prefix="coloc-4n-"))
    procs = []
    try:
        # ---- (a) the native libraries
        for name in ("transport", "loader"):
            t0 = time.perf_counter()
            try:
                path = _native.build(name)
            except RuntimeError as e:
                check(name != "transport", f"4n: the transport library did not build: {e}")
                print(f"[4n native] the loader did not build ({e}); the disk path reads "
                      "the frames")
                continue
            print(f"[4n native] {path.name}: {time.perf_counter() - t0:.2f} s (g++ "
                  f"{_native.build_seconds.get(name, 0.0):.2f} s)  ({card})")
        check(transport.available(), "4n: the transport library does not load")
        print(f"[4n native] loader available: {native_loader.available()}")

        # ---- (b) ServeRunner over the bus, in process
        mapdb, images, R_gt, C_gt = serve_w
        cfg_s = dataclasses.replace(cfg, detector=opts)
        frames_u8 = [np.clip(images[i].cpu().numpy(), 0, 255).astype(np.uint8)
                     for i in range(N_SERVE)]
        payloads = [transport.encode_image(i, frames_u8[i], 100.0 + i) for i in range(N_SERVE)]
        with transport.Broker() as broker, transport.Node(broker.port) as server, \
                transport.Node(broker.port) as robot:
            runner = serve.ServeRunner(mapdb, cfg_s, K, np.zeros(3, np.float32), server,
                                       N_SERVE, seed=SEED + 50)
            check(runner.device == dev, f"ServeRunner chose {runner.device}, not {dev}")
            for i in range(N_SERVE):
                robot.subscribe(transport.pose_topic(i), depth=4)
            time.sleep(0.1)      # the subscriptions reach the broker

            parts = {"publish": [], "poll": [], "step": [], "receive": []}

            def round_trip():
                t0 = time.perf_counter()
                for i in range(N_SERVE):
                    robot.publish(transport.image_topic(i), payloads[i])
                t1 = time.perf_counter()
                fresh = runner.poll(timeout=5.0)
                check(bool(fresh.all()), f"4n serve: fresh streams {fresh.tolist()}")
                t2 = time.perf_counter()
                out = runner.step(fresh)
                t3 = time.perf_counter()
                msgs = [robot.receive(transport.pose_topic(i), timeout=10.0)
                        for i in range(N_SERVE)]
                t4 = time.perf_counter()
                for k, a, b in (("publish", t0, t1), ("poll", t1, t2), ("step", t2, t3),
                                ("receive", t3, t4)):
                    parts[k].append((b - a) * 1e3)
                check(all(m is not None for m in msgs), "4n serve: a pose did not arrive")
                return out, [transport.decode_pose(m) for m in msgs]

            dispatch.reset_launch_counts()
            state = runner.generator.get_state()
            out, msgs = round_trip()
            counts["4n serve runner"] = dispatch.launch_counts()
            g = torch.Generator(device=dev)
            g.set_state(state)
            pwc, _, _ = runner.engine.localize_frames(
                torch.from_numpy(np.stack(frames_u8)).to(dev).float(), generator=g)
            C_ref = pwc.pose.C.cpu().numpy()
            for i, m in enumerate(msgs):
                check(m["drone"] == i and m["timestamp"] == 100.0 + i and m["success"],
                      f"4n serve: stream {i}'s pose message {m['drone']}, {m['timestamp']}")
                check(np.array_equal(m["C"], out[i]["C"].astype(np.float64)),
                      f"4n serve: stream {i}'s decoded C differs from the runner's")
                check(np.array_equal(out[i]["C"], C_ref[i]),
                      f"4n serve: stream {i} differs from localize_frames with the same "
                      "generator state")
                rot = rotation_error(torch, pwc.pose.R[i], R_gt[i])
                c_err = float(np.linalg.norm(C_ref[i] - C_gt[i].cpu().numpy()))
                check(rot < SERVE_GATE[0] and c_err < SERVE_GATE[1],
                      f"4n serve: stream {i} {rot:.2e} rad, {c_err:.2e} m from the truth")
            print(f"[4n serve] {N_SERVE} frames of {H}x{W} over the bus: {N_SERVE} poses "
                  f"received, equal to the runner's and to localize_frames from the same "
                  f"generator state, every stream within {SERVE_GATE[0]} rad and "
                  f"{SERVE_GATE[1]} m; launches {counts['4n serve runner']}  ({card})")

            # round trips against localize_frames alone and its two halves,
            # the batched frontend and localize_features, in turns
            from coloc_tpu_torch.frontend import detect_and_describe_batch

            imgs_d = torch.from_numpy(np.stack(frames_u8)).to(dev).float()
            feats_b = detect_and_describe_batch(imgs_d, opts)
            before = dispatch.launch_counts()
            for v in parts.values():
                v.clear()
            rt_ms, lf_ms, fe_ms, lx_ms = [], [], [], []
            for _ in range(SERVE_ROUNDS):
                rt_ms += wall_ms(torch, round_trip, 1)[1]
                lf_ms += wall_ms(torch, lambda: runner.engine.localize_frames(
                    imgs_d, generator=runner.generator), 1)[1]
                fe_ms += wall_ms(torch, lambda: detect_and_describe_batch(imgs_d, opts), 1)[1]
                lx_ms += wall_ms(torch, lambda: runner.engine.localize_features(
                    feats_b, generator=runner.generator), 1)[1]
            # each kernel launches three times a round (step, localize_frames,
            # and the half it belongs to)
            per = {k: (v - before[k]) / (3 * SERVE_ROUNDS)
                   for k, v in dispatch.launch_counts().items() if v > before[k]}
            for i in range(N_SERVE):
                robot.publish(transport.image_topic(i), payloads[i])
            fresh = runner.poll(timeout=5.0)
            _, reads = host_reads(torch, lambda: runner.step(fresh))
            for i in range(N_SERVE):
                robot.receive(transport.pose_topic(i), timeout=10.0)
            print(f"[4n serve] round trip (publish {N_SERVE} frames, poll, dispatch, "
                  f"{N_SERVE} poses received) {percentiles(np, rt_ms)}; localize_frames "
                  f"alone {percentiles(np, lf_ms)}, over {SERVE_ROUNDS} each in turns; "
                  f"bus and host share of the p50 "
                  f"{1.0 - np.percentile(lf_ms, 50) / np.percentile(rt_ms, 50):.3f}; "
                  f"launches a dispatch {per}; {reads} host reads a dispatch  ({card})")
            print("[4n serve] the round trip's parts, p50 ms: "
                  + ", ".join(f"{k} {np.percentile(v, 50):.3f}" for k, v in parts.items())
                  + f"; localize_frames' halves alone: batched frontend "
                  f"{percentiles(np, fe_ms)}, localize_features {percentiles(np, lx_ms)}  "
                  f"({card})")

        # ---- (c) two DronePeers on one broker, on two threads
        mapdb_d = checkpoint.load_mapdb(str(map_path))
        steps = range(1, len(frames[0]))
        last = steps[-1]
        peers, got, errors = {}, {}, []
        with transport.Broker() as broker:
            ready = threading.Barrier(2)

            def body(d):
                try:
                    node = transport.Node(broker.port)
                    peer = distributed.DronePeer(d, cfg_d, K, np.zeros(3, np.float32),
                                                 mapdb_d, node, peers=[1 - d])
                    peers[d] = (peer, node, [peer.step(frames[d][f]) for f in steps])
                    ready.wait(timeout=120)
                    fused, deadline = None, time.monotonic() + 60.0
                    while fused is None and time.monotonic() < deadline:
                        peer.publish_bundle()
                        b = peer.receive_bundle(1 - d, timeout=1.0)
                        if b is not None:
                            got[d] = b
                            fused = peer.inter_fuse(1 - d, bundle=b, publish=False)
                    got[(d, "fused")] = fused
                except Exception as e:  # noqa: BLE001 - reported by the main thread
                    errors.append(f"peer {d}: {e!r}")
                    ready.abort()

            dispatch.reset_launch_counts()
            threads = [threading.Thread(target=body, args=(d,)) for d in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            torch.cuda.synchronize()
            counts["4n peers"] = dispatch.launch_counts()
            check(not errors and all(not t.is_alive() for t in threads), f"4n peers: {errors}")
            for d in range(2):
                check(got.get((d, "fused")) is not None,
                      f"4n peers: peer {d} did not fuse its partner's bundle")

            # each peer's poses against a one-drone session with its seed
            for d in range(2):
                ref = session.ColocSession(dataclasses.replace(cfg_d, num_drones=1), K[None],
                                           np.zeros((1, 3), np.float32), seed=d)
                ref.mapdb, ref.map_ready = mapdb_d, True
                for i, f in enumerate(steps):
                    r = ref.intra_pose(0, frames[d][f])
                    ref.frame += 1
                    p = peers[d][2][i]
                    check(all(torch.equal(a, b) for a, b in zip(
                        (*p.pose, p.cov, p.rmse, p.n_tracks, p.success),
                        (*r.pose, r.cov, r.rmse, r.n_tracks, r.success))),
                        f"4n peers: peer {d}'s frame {f} differs from a one-drone session")
            print(f"[4n peers] two DronePeers on two threads, {len(steps)} frames of 4d each: "
                  f"every pose equal to a one-drone session's intra_pose with the same seed; "
                  f"each fused its partner's bundle over the bus; launches "
                  f"{counts['4n peers']}  ({card})")

            # injected draws: inter_fuse over the wire against session.inter_pose
            outs, real_core = [], mesh.inter_pose_device

            def recording_core(*args, **kw):
                outs.append(real_core(*args, **kw))
                return outs[-1]

            p0, node0, _ = peers[0]
            p1, node1, _ = peers[1]
            sizes = []

            def over_wire(draws):
                payload = p0.bundle()
                sizes.append(len(payload))
                node0.publish(transport.features_topic(0), payload)
                return p1.inter_fuse(0, bundle=p1.receive_bundle(0, timeout=10.0),
                                     publish=False, sample_idx=draws)

            b0 = transport.decode_feature_bundle(p0.bundle())
            f_src = transport.features_from_bundle(b0, dev)
            f_dst = p1._current_feats()
            m = match_pair(f_src, f_dst, cfg_d.matcher)
            draws = sample_indices(m.mask, cfg_d.ransac.num_hypotheses, 5,
                                   torch.Generator(device=dev).manual_seed(SEED + 51))
            images_last = {d: frames[d][last] for d in range(2)}
            s_ref = session.ColocSession(cfg_d, np.stack([K, K]), np.zeros((2, 3), np.float32))
            s_ref.mapdb, s_ref.map_ready = p1.session.mapdb, True
            cov_src = torch.zeros(6, 6, device=dev)
            cov_src[3:6, 3:6] = torch.tensor(b0["cov3"], dtype=torch.float32, device=dev)
            s_ref.last_pose = {
                0: PoseWithCov(pose=Pose(R=torch.as_tensor(b0["R"], dtype=torch.float32,
                                                           device=dev),
                                         C=torch.as_tensor(b0["C"], dtype=torch.float32,
                                                           device=dev)),
                               cov=cov_src, rmse=torch.zeros((), device=dev),
                               n_tracks=torch.zeros((), dtype=torch.int32, device=dev),
                               success=torch.ones((), dtype=torch.bool, device=dev)),
                1: p1.session.last_pose[0]}
            mesh.inter_pose_device = recording_core
            try:
                fused = over_wire(draws)
                host = s_ref.inter_pose(0, 1, images_last, feats={0: f_src, 1: f_dst},
                                        sample_idx=draws)
            finally:
                mesh.inter_pose_device = real_core
            check(fused is not None and host is not None and len(outs) == 2,
                  "4n peers: the injected fusion failed")
            check(all(torch.equal(a, b) for a, b in zip(fused, host)),
                  "4n peers: inter_fuse over the wire differs from session.inter_pose")
            out = outs[0]
            R_gt = torch.from_numpy(traj[1][0][last] @ traj[0][0][last].T).to(dev)
            dR_gt = rotation_error(torch, out.rel.R, R_gt)
            check(dR_gt < 1e-2, f"4n peers: relative rotation {dR_gt:.3e} rad from the truth")
            lp = p1.session.last_pose[0]
            CA = lp.cov[3:6, 3:6].double().cpu().numpy() + 1e-6 * np.eye(3)
            CB = b0["cov3"] + out.diag.cov_rel.double().cpu().numpy() + 1e-6 * np.eye(3)
            a = lp.pose.C.double().cpu().numpy()
            b = b0["C"] + b0["R"].T @ out.rel.C.double().cpu().numpy()
            cov64, _, w64 = ici64(np, CA, CB, a, b)
            tr_rel = abs(float(fused.trace) - np.trace(cov64)) / np.trace(cov64)
            check(tr_rel <= 1e-5, f"4n peers: ICI trace {tr_rel:.2e} relative to float64")

            ms = {"inter_fuse over the wire": [], "session.inter_pose": []}
            for _ in range(FUSE_CALLS):
                ms["inter_fuse over the wire"] += wall_ms(torch, lambda: over_wire(draws), 1)[1]
                ms["session.inter_pose"] += wall_ms(torch, lambda: s_ref.inter_pose(
                    0, 1, images_last, feats={0: f_src, 1: f_dst}, sample_idx=draws), 1)[1]
            node0.close()
            node1.close()
            for d in range(2):
                peers[d][0].close()
        print(f"[4n peers] injected draws: inter_fuse over the wire equal to "
              f"session.inter_pose (torch.equal); {int(out.diag.n_inliers)} E inliers, "
              f"{int(out.diag.n_common)} common landmarks, relative rotation {dR_gt:.3e} rad "
              f"from the truth; ICI trace {tr_rel:.2e} relative to float64, w* "
              f"{float(fused.omega):.5f} (float64 {w64:.5f}); a bundle of "
              f"{int(f_src.valid.numel())} keypoints is {sizes[0]} bytes; "
              + "; ".join(f"{k} {percentiles(np, v)}" for k, v in ms.items())
              + f" over {FUSE_CALLS} in turns  ({card})")

        # ---- (d) the three entry points as subprocesses, at full width. They
        # take the card one after another (processes that share it at once
        # slow each other's host-paced work: four at once read 26-134 s);
        # serve starts first and waits for frames while the peers run, and
        # the CLI starts while serve answers, so two start-ups are hidden.
        serve_map = root / "serve_map.npz"
        checkpoint.save_mapdb(str(serve_map), mapdb)
        # serve reads one camera from its calib.txt (coloc_tpu's layout)
        disk.write_calib(str(root / "calib1.txt"), (W, H), K[None], np.zeros((1, 3), np.float32))
        logs = open(root / "stderr.txt", "w")
        det = ["--maxkp", str(KP), "--fast-threshold", str(FAST_THRESHOLD)]
        secs = {}

        def finish(tag, proc, t_start):
            try:
                rest, _ = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise SmokeFailure(f"4n {tag}: did not exit within 300 s")
            secs[tag] = time.perf_counter() - t_start
            proc.seen += rest.splitlines()
            check(proc.returncode == 0, f"4n {tag}: exit {proc.returncode}; "
                  + "\n".join(proc.seen[-10:]) + "\n"
                  + (root / "stderr.txt").read_text()[-3000:])
            return proc.seen

        srv = entry_point(["coloc_tpu_torch.serve", "--map", str(serve_map), "--calib",
                           str(root / "calib1.txt"), "--streams", str(N_SERVE), "--publish",
                           "0", "--steps", str(SERVE_STEPS), "--levels", str(LEVELS), *det],
                          repo, logs)
        procs.append(srv)

        data = root / "data"
        t0 = time.perf_counter()
        synthetic.write_dataset(str(data), scene, 2, len(frames[0]))
        disk.write_calib(str(data / "calib.txt"), (W, H), np.stack([K, K]),
                         np.zeros((2, 3), np.float32))
        print(f"[4n entry] write_dataset: 2 x {len(frames[0])} frames of {H}x{W} in "
              f"{time.perf_counter() - t0:.1f} s")

        # the pair fuses at frames 1 and 3 (--inter-every 2); the broker's
        # owner steps one frame more, and should the joiner outlive the bus
        # all the same, a publish redials it for 1 s, not 10
        t0 = time.perf_counter()
        peer_args = ["--map", str(map_path), "--calib", str(data / "calib.txt"), "--folder",
                     str(data), "--inter-every", "2", "--levels", str(LEVELS), *det]
        peer0 = entry_point(["coloc_tpu_torch.distributed", "--drone", "0", "--peers", "1",
                             "--broker", "0", "--frames", str(PEER_FRAMES + 1), *peer_args],
                            repo, logs)
        procs.append(peer0)
        port = read_line(peer0, "broker listening on", "distributed 0").split()[-1]
        t_port = time.perf_counter() - t0
        peer1 = entry_point(["coloc_tpu_torch.distributed", "--drone", "1", "--peers", "0",
                             "--broker", f"127.0.0.1:{port}", "--frames", str(PEER_FRAMES),
                             "--reconnect-timeout", "1", *peer_args], repo, logs)
        procs.append(peer1)
        lines = {"distributed 1": finish("distributed 1", peer1, t0),
                 "distributed 0": finish("distributed 0", peer0, t0)}
        for d in range(2):
            tail = [ln for ln in lines[f"distributed {d}"] if ln.startswith(f"drone {d} on")]
            check(bool(tail) and "cuda:0" in tail[0], f"4n distributed {d}: {tail}")
            n = PEER_FRAMES + 1 - d
            n_fused = int(tail[0].split(" inter-drone fusions")[0].split()[-1])
            check(f"localized {n}/{n} frames" in tail[0] and n_fused >= 1,
                  f"4n distributed {d}: {tail[0]}")
            print(f"[4n entry] distributed {d}: {tail[0]}; {secs[f'distributed {d}']:.1f} s "
                  f"from the owner's launch (its broker up after {t_port:.1f} s)  ({card})")

        sport = int(read_line(srv, "broker listening on", "serve").split()[-1])
        dev_line = read_line(srv, "serving", "serve")
        check(dev_line.endswith("cuda:0"), f"4n serve: {dev_line}")
        t_cli = time.perf_counter()
        cli = entry_point(["coloc_tpu_torch.cli", "--folder", str(data), "--calib",
                           str(data / "calib.txt"), "--drones", "2", *det, "--publish", "0",
                           "--out", str(root / "cli")], repo, logs)
        procs.append(cli)
        # the robot publishes rounds of N_SERVE frames until the server has
        # made its SERVE_STEPS dispatches and exits (a round's frames may
        # straddle two polls, so a dispatch may serve part of one)
        t0 = time.perf_counter()
        received, deadline = [], time.monotonic() + 240.0
        with transport.Node(sport) as robot:
            for i in range(N_SERVE):
                robot.subscribe(transport.pose_topic(i), depth=4)
            time.sleep(0.2)
            try:
                while srv.poll() is None and time.monotonic() < deadline:
                    for i in range(N_SERVE):
                        robot.publish(transport.image_topic(i), payloads[i])
                    for i in range(N_SERVE):
                        p = robot.receive(transport.pose_topic(i),
                                          timeout=2.0 if received else 120.0)
                        if p is not None:
                            received.append(transport.decode_pose(p))
            except OSError:
                pass      # the server closed its broker on exit
        lines["serve"] = finish("serve", srv, t0)
        check(len(received) >= SERVE_STEPS and all(m["success"] for m in received),
              f"4n serve: {len(received)} poses received from the server, success "
              f"{[m['success'] for m in received]}")
        check(f"served {SERVE_STEPS} dispatches" in lines["serve"],
              f"4n serve: {lines['serve'][-3:]}")
        print(f"[4n entry] serve: {dev_line}; {lines['serve'][-1]}; {len(received)} poses "
              f"received by the robot, every one a success; {secs['serve']:.1f} s from the "
              f"first frame to its exit  ({card})")

        lines["cli"] = finish("cli", cli, t_cli)
        summary = [ln for ln in lines["cli"] if ln.startswith("processed")]
        check("session on cuda:0" in lines["cli"], f"4n cli: {lines['cli'][:6]}")
        check(bool(summary), f"4n cli: no summary line; {lines['cli'][-5:]}")
        n_done = int(summary[0].split()[1])
        check(n_done == 2 * (len(frames[0]) - 1)
              and f"{n_done}/{n_done} localized" in summary[0]
              and (root / "cli" / "poses.txt").is_file(), f"4n cli: {summary[0]}")
        loader = [ln for ln in lines["cli"] if ln.startswith("frames:")]
        print(f"[4n entry] cli over the {W}x{H} folder, 2 drones, {KP} keypoints, FAST "
              f"{FAST_THRESHOLD}: {loader[0] if loader else ''}; {summary[0]}; "
              f"{secs['cli']:.1f} s  ({card})")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[time] 4n took {time.perf_counter() - t_4n:.1f} s")


def ici64(np, CA, CB, a, b):
    """Float64 inverse covariance intersection, independent of the port's
    golden-section form: w* from a scan of 2001 weights refined by 80
    golden-section steps (tests/oracle.py's recipe). -> (cov, pos, w)."""
    CA, CB, a, b = (np.asarray(x, np.float64) for x in (CA, CB, a, b))
    CAi, CBi = np.linalg.inv(CA), np.linalg.inv(CB)

    def trace_at(w):
        return np.trace(np.linalg.inv(CAi + CBi - np.linalg.inv(w * CA + (1.0 - w) * CB)))

    ws = np.linspace(0.0, 1.0, 2001)
    i = int(np.argmin([trace_at(w) for w in ws]))
    lo, hi = ws[max(i - 1, 0)], ws[min(i + 1, len(ws) - 1)]
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    for _ in range(80):
        m1, m2 = hi - phi * (hi - lo), lo + phi * (hi - lo)
        if trace_at(m1) < trace_at(m2):
            hi = m2
        else:
            lo = m1
    w = 0.5 * (lo + hi)
    M = np.linalg.inv(w * CA + (1.0 - w) * CB)
    Cf = np.linalg.inv(CAi + CBi - M)
    return Cf, Cf @ (CAi - w * M) @ a + Cf @ (CBi - (1.0 - w) * M) @ b, float(w)


def fusion_gates(np, tag, out, CA, CB, a, b, pos, trace, omega):
    """4i's gates on one interPoseEstimator output `out` whose ICI fused
    (CA, a) with (CB, b) into `pos`, `trace` and `omega`: at least 2
    common landmarks, a finite positive scale, and the ICI against float64
    (ici64). The trace is flat near its minimum to below float32
    resolution (ROADMAP C15): tight on the trace, loose on w* and the
    position. -> the readings."""
    n_common, scale = int(out.diag.n_common), float(out.scale)
    check(n_common >= 2 and np.isfinite(scale) and scale > 0,
          f"{tag}: {n_common} common landmarks, scale {scale}")
    cov64, pos64, w64 = ici64(np, CA, CB, a, b)
    tr_rel = abs(trace - np.trace(cov64)) / np.trace(cov64)
    gap = float(np.linalg.norm(a - b))
    d_pos = float(np.abs(pos - pos64).max())
    d_w = abs(omega - w64)
    check(tr_rel <= 1e-5 and d_w <= 1e-2 and d_pos <= 1e-2 * gap,
          f"{tag}: ICI against float64: trace {tr_rel:.2e} relative, w* {d_w:.2e}, "
          f"position {d_pos:.2e} (|a - b| {gap:.3e})")
    return dict(n_common=n_common, scale=scale, w64=w64, tr_rel=tr_rel, d_w=d_w, gap=gap,
                d_pos=d_pos)


def phase_4i(torch, np, dev, card, cfg_d, Ks2, dists2, sess, frames, traj, frames_h,
             traj_h, counts):
    """Inter-drone fusion (interPoseEstimator) on the card: inter_pose_round
    on 4d's session and last frame, checked against the ground truth and a
    float64 ICI; the same pair with injected draws on the card and through
    the plain CPU path; inter_pose p50/p99, launches, host reads, device
    kernels, idle share and B1/B6-B9's device time a round; then run(frames)
    with the reference's default inter_every=10 and run_chunked(chunk=CHUNK,
    inter_every=CHUNK) on 4h's trajectory, each round where the schedule
    puts it."""
    from types import SimpleNamespace

    from coloc_tpu_torch import convert, session
    from coloc_tpu_torch.matching import match_pair
    from coloc_tpu_torch.ops import dispatch, ransac_rank
    from coloc_tpu_torch.parallel import mesh
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.types import Features

    last = len(frames[0]) - 1
    images = {d: frames[d][last] for d in range(2)}
    outs, real_core = [], mesh.inter_pose_device

    def recording_core(*args, **kw):
        out = real_core(*args, **kw)
        outs.append(out)
        return out

    def fusion_inputs(sess_x, out):
        """The two estimates ICI fused: (C_intra, C_cand, dst_pos, cand_C)."""
        src, dst = sess_x.last_pose[0], sess_x.last_pose[1]
        eye = 1e-6 * np.eye(3)
        cpu = [t.detach().cpu().double().numpy() for t in
               (dst.cov[3:6, 3:6], src.cov[3:6, 3:6], out.diag.cov_rel, dst.pose.C,
                src.pose.C, src.pose.R, out.rel.C)]
        return cpu[0] + eye, cpu[1] + cpu[2] + eye, cpu[3], cpu[4] + cpu[5].T @ cpu[6]

    epi_calls, real_epi = [], ransac_rank.epi_rank

    def capture_epi(*args, **kw):
        epi_calls.append([t.contiguous() for t in args[:4]])
        return real_epi(*args, **kw)

    mesh.inter_pose_device = recording_core
    ransac_rank.epi_rank = capture_epi
    try:
        # the round on the last frame, its draws from the session's generator
        dispatch.reset_launch_counts()
        res = sess.inter_pose_round(images)
        torch.cuda.synchronize()
        counts["4i fusion"] = launches = dispatch.launch_counts()
        ransac_rank.epi_rank = real_epi
        ops_r = epi_calls[0]
        b = epi_bound(ops_r)
        print(f"[4i epi_rank] the round's B9 call: Hm={ops_r[0].shape[0]} x "
              f"M={ops_r[1].shape[1]}, {int((ops_r[2] != 0).sum())} points unmasked; bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']})")
        check(set(res) == {1} and len(outs) == 1, f"4i: the round fused {sorted(res)}")
        out = outs[0]
        check(bool(out.ok) and res[1] is not None, "4i: the fusion round failed")
        R_gt = torch.from_numpy(traj[1][0][last] @ traj[0][0][last].T).to(dev)
        dR_gt = rotation_error(torch, out.rel.R, R_gt)
        check(dR_gt < 1e-2, f"4i: relative rotation {dR_gt:.3e} rad from the ground truth")
        cov = res[1].cov.double().cpu().numpy()
        check(np.isfinite(cov).all() and np.allclose(cov, cov.T, atol=1e-7)
              and np.linalg.eigvalsh(cov).min() > 0, "4i: the fused covariance is not SPD")
        g = fusion_gates(np, "4i", out, *fusion_inputs(sess, out),
                         res[1].pos.double().cpu().numpy(), float(res[1].trace),
                         float(res[1].omega))
        print(f"[4i round] inter_pose_round on frame {last}: ok, {int(out.diag.n_inliers)} E "
              f"inliers, {g['n_common']} common landmarks, scale {g['scale']:.5f}, relative "
              f"rotation {dR_gt:.3e} rad from the ground truth, refine rmse "
              f"{float(out.diag.rmse):.4f} px; ICI w* {float(res[1].omega):.5f} (float64 "
              f"{g['w64']:.5f}), trace {float(res[1].trace):.6e} ({g['tr_rel']:.2e} relative "
              f"to float64), position {g['d_pos']:.3e} from float64 (|a - b| {g['gap']:.4f})")
        print(f"[4i round] launches a round: {launches}  ({card})")

        # the same pair with injected draws: card against the plain CPU path
        feats = {d: sess.detect(images[d]) for d in range(2)}
        m = match_pair(feats[0], feats[1], cfg_d.matcher)
        draws = sample_indices(m.mask, cfg_d.ransac.num_hypotheses, 5,
                               torch.Generator(device=dev).manual_seed(SEED + 9))
        s_cpu = session.ColocSession(cfg_d, Ks2, dists2, device="cpu")
        convert.session_state_from_numpy(SimpleNamespace(
            mapdb=convert.to_numpy(sess.mapdb), scene=convert.to_numpy(sess.scene),
            filter_bank=convert.to_numpy(sess.filter_bank),
            lm_support=convert.to_numpy(sess.lm_support),
            lm_last_seen=convert.to_numpy(sess.lm_last_seen), frame=sess.frame,
            map_ready=sess.map_ready,
            last_pose={d: convert.to_numpy(p) for d, p in sess.last_pose.items()}), s_cpu)
        outs.clear()
        r_g = sess.inter_pose(0, 1, images, feats=feats, sample_idx=draws)
        r_c = s_cpu.inter_pose(0, 1, images, sample_idx=draws.cpu(), feats={
            d: Features(*(t.cpu() for t in f)) for d, f in feats.items()})
        check(r_g is not None and r_c is not None, "4i: the injected pair did not fuse")
        og, oc = outs
        dR = rotation_error(torch, og.rel.R.cpu().double(), oc.rel.R.double())
        Cg, Cc = og.rel.C.cpu().double(), oc.rel.C.double()
        dC = float(torch.arccos(torch.clamp(Cg @ Cc / (Cg.norm() * Cc.norm()), -1.0, 1.0)))
        d_scale = abs(float(og.scale) / float(oc.scale) - 1.0)
        _, _, a, b = fusion_inputs(sess, og)
        gap = float(np.linalg.norm(a - b))
        d_pos = float((r_g.pos.cpu() - r_c.pos).abs().max())
        print(f"[4i reference] inter_pose(0, 1) card vs CPU plain path, the same features and "
              f"draws: E inliers {int(og.diag.n_inliers)} / {int(oc.diag.n_inliers)}, common "
              f"landmarks {int(og.diag.n_common)} / {int(oc.diag.n_common)}, relative rotation "
              f"{dR:.2e} rad, baseline direction {dC:.2e} rad, scale {d_scale:.2e} relative, "
              f"fused position {d_pos:.2e} apart (|a - b| {gap:.4f}), w* "
              f"{float(r_g.omega):.5f} / {float(r_c.omega):.5f}")
        check(dR < 1e-3 and dC < 5e-3, f"4i card vs CPU: relative rotation {dR:.2e} rad, "
              f"baseline direction {dC:.2e} rad")
        check(d_scale < 1e-2 and d_pos < 1e-2,
              f"4i card vs CPU: scale {d_scale:.2e} relative, fused position {d_pos:.2e}")
    finally:
        mesh.inter_pose_device = real_core
        ransac_rank.epi_rank = real_epi

    # inter_pose p50/p99 (features given, the fusion core alone) and the
    # whole round (detection included), CUDA events after a warm-up
    def timed(fn, n):
        ms = []
        for i in range(n + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                ms.append(start.elapsed_time(end))
        return ms

    pair_ms = timed(lambda: sess.inter_pose(0, 1, images, feats=feats), FUSION_CALLS)
    round_ms = timed(lambda: sess.inter_pose_round(images), FUSION_CALLS)
    _, reads = host_reads(torch, lambda: sess.inter_pose_round(images))
    print(f"[4i timing] inter_pose (features given) {percentiles(np, pair_ms)}; "
          f"inter_pose_round {percentiles(np, round_ms)}, over {FUSION_CALLS} calls each; "
          f"{reads} host reads a round  ({card})")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.inter_pose_round(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(torch, prof)
    busy_us = sum(us for _, us in kernels)
    if busy_us > 0:
        each = {tag: sum(us for name, us in kernels if k in name)
                for tag, k in (("B1", "k2nn_mma_kernel"), ("B6", "front_kernel"),
                               ("B7", "dk_kernel"), ("B8", "polish_kernel"),
                               ("B9", "epi_rank_kernel"))}
        print(f"[4i profile] a round: {len(kernels)} device kernels, device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
              f"({100.0 - 100.0 * busy_us / wall_us:.1f}% idle, profiler on); "
              + ", ".join(f"{tag} {us:.1f} us ({100.0 * us / busy_us:.2f}%)"
                          for tag, us in each.items())
              + f"; B6-B9 {sum(each[t] for t in ('B6', 'B7', 'B8', 'B9')):.1f} us")
        by_name = {}
        for name, us in kernels:
            by_name[name] = by_name.get(name, 0.0) + us
        print("[4i profile] device us a round, largest kernels: " + "; ".join(
            f"{us:.1f} {name[:60]}" for name, us in sorted(by_name.items(),
                                                             key=lambda kv: -kv[1])[:8]))
    else:
        print("[4i profile] the profiler saw no device time: not measured")

    # run with the reference's default, run_chunked with a round a chunk
    def rounds_of(sess_x):
        at, real = [], sess_x.inter_pose_round

        def counted(imgs, policy="auto"):
            at.append(sess_x.frame)
            return real(imgs, policy)
        sess_x.inter_pose_round = counted
        return at

    n_h = len(frames_h[0])
    results = {}
    for tag, call, want in (
            ("run(frames)", lambda s: s.run(frames_h),
             list(range(10, n_h, 10))),
            (f"run_chunked(chunk={CHUNK}, inter_every={CHUNK})",
             lambda s: s.run_chunked(frames_h, chunk=CHUNK, inter_every=CHUNK),
             [min(f + CHUNK - 1, n_h - 1) for f in range(1, n_h, CHUNK)])):
        sess_x = session.ColocSession(cfg_d, Ks2, dists2, seed=SEED)
        at = rounds_of(sess_x)
        t0 = time.perf_counter()
        out_x = call(sess_x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(at == want, f"4i {tag}: rounds on frames {at}, the schedule's {want}")
        errs = []
        for d in range(2):
            check(len(out_x[d]) == n_h - 1, f"4i {tag}: {len(out_x[d])} frames of {n_h - 1}")
            for f, p in enumerate(out_x[d], start=1):
                check(bool(p.success), f"4i {tag} frame {f} drone {d}: localization failed")
                R_gt = torch.from_numpy(traj_h[d][0][f] @ traj_h[0][0][0].T).to(dev)
                errs.append(rotation_error(torch, p.pose.R, R_gt))
        errs_deg = np.degrees(np.asarray(errs))
        check(np.median(errs_deg) < 1.0 and errs_deg.max() < 2.0,
              f"4i {tag}: rotation error median {np.median(errs_deg):.3f}, max "
              f"{errs_deg.max():.3f} deg")
        C0 = [float(p.pose.C[0]) for p in out_x[0]]
        check(C0[-1] > C0[0], f"4i {tag}: drone 0's centre does not move along +x")
        steps = sess_x.filter_bank.steps.tolist()
        check(min(steps) >= n_h - 1 - 5, f"4i {tag}: filter steps {steps}")
        results[tag] = out_x
        print(f"[4i run] {tag}: init_map then {n_h - 1} frames of 2 drones ok in {wall:.3f} s; "
              f"rounds on frames {at}; rotation error median {np.median(errs_deg):.4f}, max "
              f"{errs_deg.max():.4f} deg; filter steps {steps}  ({card})")
    # both draw the same uniforms frame by frame until the first round
    (a, b), k = results.values(), min(10, CHUNK)
    same = all(torch.equal(x.pose.C, y.pose.C) and torch.equal(x.cov, y.cov)
               for d in range(2) for x, y in zip(a[d][:k], b[d][:k]))
    check(same, "4i: run and run_chunked differ before the first round")
    print(f"[4i run] frames 1-{k} of run and run_chunked bit-equal (the same draws before "
          f"the first round)")


def phase_4j(torch, np, dev, card, opts, K, scene, cfg_d, sess, frames, traj, frames_h,
             traj_h, counts):
    """The rest of the bootstrap on the card. D = 4: init_map through
    reconstruct_scene (6 pairs, 2 P3P resections) with its launches, host
    reads and a profile, INIT_CALLS timed calls, J_FRAMES eager frames of
    intra_pose_all, a run_chunked chunk from CUDA graphs held to the eager
    step with torch.equal, a ring round. Models F and H at D = 2: against
    the ground truth, their two-view estimate against the plain CPU path
    from the same features and draws, B9 (F) and B3's "nonzero" mode (H)
    at their shapes, then J_FRAMES frames.
    update_map on 4d's session, then run(update_map_every=10) and
    run_chunked(chunk=CHUNK, update_map_every=CHUNK) over 4h's frames, the
    latter held to an eager run of the same schedule with torch.equal."""
    from coloc_tpu_torch import config, robust, session
    from coloc_tpu_torch.fusion.kalman import FilterBank
    from coloc_tpu_torch.geometry import camera as cam_ops, essential, homography
    from coloc_tpu_torch.geometry.camera import Camera
    from coloc_tpu_torch.io import synthetic
    from coloc_tpu_torch.matching import match_maps, match_pair
    from coloc_tpu_torch.ops import dispatch, ransac_rank
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.utils import compute_scale_difference

    NB = cfg_d.ransac.num_hypotheses
    t_4j = time.perf_counter()

    def lap(part):
        print(f"[time] 4j: {part} at {time.perf_counter() - t_4j:.1f} s into 4j")

    def timed(fn, n):
        """fn() n times, CUDA events -> (first result, ms per call)."""
        ms, first = [], None
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            first = out if i == 0 else first
        return first, ms

    def tensors(p):
        return (p.pose.R, p.pose.C, p.cov, p.rmse, p.n_tracks, p.success)

    def localize_frames(tag, s, imgs, trj, fs, anchor=0):
        """intra_pose_all on frames fs: every drone localized, rotation error
        against the ground truth (the world frame is drone `anchor`'s
        camera at frame 0) median < 1 deg, max < 2 deg."""
        D, errs, ms = s.config.num_drones, [], []
        for f in fs:
            s.frame = f
            out, t = timed(lambda: s.intra_pose_all({d: imgs[d][f] for d in range(D)}), 1)
            ms += t
            for d in range(D):
                check(bool(out[d].success), f"{tag} frame {f} drone {d}: localization failed")
                R_gt = torch.from_numpy(trj[d][0][f] @ trj[anchor][0][0].T).to(dev)
                errs.append(rotation_error(torch, out[d].pose.R, R_gt))
        deg = np.degrees(np.asarray(errs))
        check(np.median(deg) < 1.0 and deg.max() < 2.0,
              f"{tag}: rotation error median {np.median(deg):.3f}, max {deg.max():.3f} deg")
        return deg, ms

    # ---- D = 4: four drones of the bench scene on 4h's trajectory, its
    # frames reused for drones 0 and 1 (a render is a numpy pass on the host)
    D4 = 4
    n4 = 1 + J_FRAMES + CHUNK
    traj4 = list(traj_h) + [synthetic.trajectory(len(frames_h[0]), d) for d in range(2, D4)]
    more = render_frames(np, synthetic, scene, traj4[2:], n4)
    frames4 = {d: frames_h[d][:n4] if d < 2 else more[d - 2] for d in range(D4)}
    first4 = {d: frames4[d][0] for d in range(D4)}
    lap("drones 2 and 3 rendered")
    cfg4 = config.ColocConfig(num_drones=D4, detector=opts)
    Ks4, dists4 = np.stack([K] * D4), np.zeros((D4, 3), np.float32)
    sess4 = session.ColocSession(cfg4, Ks4, dists4, seed=SEED)    # cuda:0 untold
    check(sess4.device == dev, f"ColocSession chose {sess4.device}, not {dev}")
    dispatch.reset_launch_counts()
    (ok, ms4) = timed(lambda: sess4.init_map(first4), 1)
    counts["4j bootstrap"] = boot = dispatch.launch_counts()
    check(ok and sess4.map_ready and sess4.scene.num_views == D4, "4j: D=4 init_map failed")
    n_lm = int(sess4.mapdb.valid.sum())
    cov = sess4.bootstrap_ba.cov
    check(n_lm >= 8, f"4j: D=4 init_map kept {n_lm} landmarks < 8")
    check(cov.shape == (6, 6) and bool(torch.isfinite(cov).all()),
          "4j: the D=4 bootstrap covariance is not a finite 6x6")
    want = dict(k2nn=6, fivept_front=6, fivept_dk=6, fivept_polish=6, epi_rank=6, p3p=2,
                ransac_rank=2)
    check(all(boot[k] == v for k, v in want.items()),
          f"4j: a D=4 bootstrap launched {boot}, not {want} (6 pairs, 2 resections)")
    views = sess4.bootstrap_views
    print(f"[4j bootstrap] D=4 init_map: {ms4[0]:.3f} ms (first call); seed pair "
          f"{tuple(views[:2])}, resected {views[2:]}, {int(sess4.bootstrap_geo.n_inliers)} seed "
          f"inliers, {n_lm} landmarks, BA {int(sess4.bootstrap_ba.iterations)} LM iterations, "
          f"rmse {float(sess4.bootstrap_ba.rmse):.4f} px; launches {boot}  ({card})")
    lap("the first D=4 init_map done")
    _, ms4 = timed(lambda: sess4.init_map(first4), INIT_CALLS)
    _, reads = host_reads(torch, lambda: sess4.init_map(first4))
    print(f"[4j bootstrap] D=4 init_map {percentiles(np, ms4)} over {INIT_CALLS} calls; "
          f"{reads} host reads a bootstrap  ({card})")
    profile_frames(torch, "4j bootstrap D=4", lambda f: sess4.init_map(first4), 1,
                   unit="bootstrap")
    check(sess4.init_map(first4), "4j: the last D=4 init_map failed")
    anchor = sess4.bootstrap_views[0]
    lap("the D=4 init_map timed and profiled")
    deg, ms = localize_frames("4j D=4", sess4, frames4, traj4, range(1, J_FRAMES + 1), anchor)
    print(f"[4j frames] D=4: {J_FRAMES} frames of intra_pose_all, every drone localized; "
          f"rotation error median {np.median(deg):.4f}, max {deg.max():.4f} deg "
          f"(world frame: drone {anchor}); {percentiles(np, ms[1:])} after the first  ({card})")

    # one chunk from CUDA graphs against the eager step from the same state
    # and generator
    sess_e = session.ColocSession(cfg4, Ks4, dists4, seed=SEED)
    sess_e.mapdb, sess_e.scene, sess_e.map_ready = sess4.mapdb, sess4.scene, True
    sess_e.filter_bank = FilterBank(*(t.clone() for t in sess4.filter_bank))
    sess_e.lm_support = sess4.lm_support.clone()
    sess_e.lm_last_seen = sess4.lm_last_seen.clone()
    sess_e.generator.set_state(sess4.generator.get_state())
    chunk4 = {d: frames4[d][1 + J_FRAMES:] for d in range(D4)}
    t0 = time.perf_counter()
    out_c = sess4.run_chunked(chunk4, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g = sess4._graphs
    check(g is not None and g.mapdb is sess4.mapdb, "4j: the D=4 chunk was not captured")
    equal, errs = True, []
    for i in range(CHUNK):
        sess_e.frame = i
        res = sess_e.intra_pose_all({d: chunk4[d][i] for d in range(D4)})
        for d in range(D4):
            pc = out_c[d][i]
            check(bool(pc.success), f"4j chunk frame {i} drone {d}: localization failed")
            equal = equal and all(torch.equal(a, b) for a, b in zip(tensors(pc),
                                                                     tensors(res[d])))
            f = 1 + J_FRAMES + i
            R_gt = torch.from_numpy(traj4[d][0][f] @ traj4[anchor][0][0].T).to(dev)
            errs.append(rotation_error(torch, pc.pose.R, R_gt))
    equal = equal and all(torch.equal(a, b) for a, b in zip(sess4.filter_bank,
                                                             sess_e.filter_bank))
    check(equal, "4j: the captured D=4 chunk differs from the eager step")
    deg = np.degrees(np.asarray(errs))
    check(np.median(deg) < 1.0 and deg.max() < 2.0,
          f"4j chunk: rotation error median {np.median(deg):.3f}, max {deg.max():.3f} deg")
    print(f"[4j chunked] D=4 run_chunked(chunk={CHUNK}) from CUDA graphs in {wall:.3f} s "
          f"(capture {g.capture_seconds:.3f} s): every frame and the filter bank bit-equal "
          f"to the eager step from the same state and draws; rotation error median "
          f"{np.median(deg):.4f}, max {deg.max():.4f} deg  ({card})")
    rr = sess4.inter_pose_round({d: frames4[d][n4 - 1] for d in range(D4)})
    fused = [d for d, r in rr.items() if r is not None]
    check(set(rr) == set(range(D4)) and len(fused) >= 2,
          f"4j: the ring round fused {fused} of {sorted(rr)}")
    check(all(bool(torch.isfinite(rr[d].pos).all() & torch.isfinite(rr[d].cov).all())
              for d in fused), "4j: a ring fusion is not finite")
    print(f"[4j ring] inter_pose_round at D=4 (ring): destinations {sorted(rr)}, fused {fused}")

    lap("the D=4 frames, chunk and ring round done")
    # ---- models F and H at D = 2 -----------------------------------------
    Ks2, dists2 = np.stack([K, K]), np.zeros((2, 3), np.float32)
    scene_p = synthetic.make_scene(H, W, K, seed=SCENE_SEED, depths=(8.0,))
    traj_p = [synthetic.trajectory(J_FRAMES + 1, d) for d in range(2)]
    frames_p = render_frames(np, synthetic, scene_p, traj_p, J_FRAMES + 1)
    for model, imgs, trj, S in (("F", frames, traj, 7), ("H", frames_p, traj_p, 4)):
        cfg_m = config.ColocConfig(num_drones=2, detector=opts, model=model)
        first = {d: imgs[d][0] for d in range(2)}
        calls, real = [], (ransac_rank.epi_rank if model == "F" else ransac_rank.ladder_rank)

        def capture(*args, **kw):
            calls.append(([t.contiguous() for t in args[:4]], args[4:], kw))
            return real(*args, **kw)

        s = session.ColocSession(cfg_m, Ks2, dists2, seed=SEED)
        name = "epi_rank" if model == "F" else "ladder_rank"
        setattr(ransac_rank, name, capture)
        dispatch.reset_launch_counts()
        try:
            ok = s.init_map(first)
            torch.cuda.synchronize()
        finally:
            setattr(ransac_rank, name, real)
        counts[f"4j model {model}"] = launches = dispatch.launch_counts()
        check(ok and s.map_ready, f"4j model {model}: init_map failed")
        check(len(calls) == 1, f"4j model {model}: {len(calls)} rank calls")
        (R0, C0), (R1, C1) = ((trj[d][0][0], trj[d][1][0]) for d in (0, 1))
        R_gt = torch.from_numpy(R1 @ R0.T).to(dev).double()
        C_gt = torch.from_numpy(R0 @ (C1 - C0)).to(dev).double()
        C1e = s.scene.Cs[1].double()
        dR_gt = rotation_error(torch, s.scene.Rs[1].double(), R_gt)
        dC_gt = float(torch.arccos(torch.clamp(C1e @ C_gt / (C1e.norm() * C_gt.norm()), -1, 1)))
        check(dR_gt < 1e-2 and dC_gt < 0.1,
              f"4j model {model}: drone 1 {dR_gt:.2e} rad, baseline {dC_gt:.2e} rad from the "
              f"ground truth")
        _, ms = timed(lambda: s.init_map(first), INIT_CALLS)
        print(f"[4j model {model}] init_map: {int(s.bootstrap_geo.n_inliers)} inliers, "
              f"{int(s.mapdb.valid.sum())} landmarks; drone 1 {dR_gt:.2e} rad, baseline "
              f"{dC_gt:.2e} rad from the ground truth; {percentiles(np, ms)} over "
              f"{INIT_CALLS} calls; launches {launches}  ({card})")
        # the rank call at this path's shape: equal to its twin, timed
        ops, rest, kw = calls[0]
        if model == "F":
            rk = ransac_rank._epi_rank_cuda(*ops, 2, 5)
            rp = ransac_rank.epi_rank_plain(*ops)
            fn, kern, b = (lambda: ransac_rank._epi_rank_cuda(*ops, 2, 5), "epi_rank_kernel",
                           epi_bound(ops))
            plain = lambda: ransac_rank.epi_rank_plain(*ops)  # noqa: E731
            check(launches["epi_rank"] == 1, f"4j model F: B9 launched {launches['epi_rank']}")
        else:
            thr, zmode = rest[0], rest[1]
            check(zmode == "nonzero", f"4j model H: the ladder ranked in zmode {zmode!r}")
            rk = ransac_rank._ladder_rank_cuda(*ops, thr, zmode, 2, 5)
            rp = ransac_rank.ladder_rank_plain(*ops, thr, zmode)
            fn, kern, b = (lambda: ransac_rank._ladder_rank_cuda(*ops, thr, zmode, 2, 5),
                           "rank_kernel", rank_bound(ops))
            plain = lambda: ransac_rank.ladder_rank_plain(*ops, thr, zmode)  # noqa: E731
            check(launches["ransac_rank"] == 1,
                  f"4j model H: B3 launched {launches['ransac_rank']}")
        torch.cuda.synchronize()
        check(torch.equal(rk, rp), f"4j model {model}: the rank kernel differs from its twin")
        Hm_c, M_c = ops[0].shape[0], ops[1].shape[1]
        timed_pair(f"4j model {model}: {'epi_rank' if model == 'F' else 'ransac_rank nonzero'}"
                   f" at Hm={Hm_c} x M={M_c}, "
                   f"{int((ops[2 if model == 'F' else 3] != 0).sum())} points unmasked",
                   fn, None, kern, card, b)
        print(f"[4j model {model}] its plain twin at that shape: {cuda_ms(plain):.4f} ms "
              f"(wrapper, CUDA events)  ({card})")
        # the two-view estimate on the card and through the plain CPU path
        # from the same features, matches and minimal samples, RANSAC's
        # result and the keep-if-better re-fit recorded on each side
        f0, f1 = s.detect(first[0]), s.detect(first[1])
        m01 = match_pair(f0, f1, cfg_m.matcher)
        draws = sample_indices(m01.mask, NB, S, torch.Generator(device=dev).manual_seed(SEED + 11))
        args = (f0.xy, f1.xy[m01.idx.long()], m01.mask)
        cams_c = [Camera(K=c.K.cpu(), dist=c.dist.cpu()) for c in s.cams[:2]]
        rec, real_ransac, real_refit = [], robust.ransac, robust._refit

        def rec_ransac(*a, **k):
            rec.append(real_ransac(*a, **k))
            return rec[-1]

        def rec_refit(res, refit_model, scorer, msk):
            out = real_refit(res, refit_model, scorer, msk)
            rec.append(torch.equal(out[0], refit_model))
            return out

        robust.ransac, robust._refit = rec_ransac, rec_refit
        try:
            geo_g = robust.relative_pose(model, *args, s.cams[0], s.cams[1], cfg_m.ransac,
                                         sample_idx=draws)
            geo_c = robust.relative_pose(model, *(t.cpu() for t in args), *cams_c,
                                         cfg_m.ransac, sample_idx=draws.cpu())
        finally:
            robust.ransac, robust._refit = real_ransac, real_refit
        (rs_g, kept_g, rs_c, kept_c) = rec
        R_gt2 = torch.from_numpy(trj[1][0][0] @ trj[0][0][0].T).double()
        t_gt2 = torch.from_numpy(trj[1][0][0] @ (trj[0][1][0] - trj[1][1][0])).double()

        def dir_err(a, b):
            a, b = a.cpu().double(), b.cpu().double()
            return float(torch.arccos(torch.clamp(a @ b / (a.norm() * b.norm()), -1.0, 1.0)))

        dR = rotation_error(torch, geo_g.R.cpu().double(), geo_c.R.double())
        dt = dir_err(geo_g.t, geo_c.t)
        gt_g = (rotation_error(torch, geo_g.R.cpu().double(), R_gt2), dir_err(geo_g.t, t_gt2))
        gt_c = (rotation_error(torch, geo_c.R.double(), R_gt2), dir_err(geo_c.t, t_gt2))
        ng, nc = int(geo_g.n_inliers), int(geo_c.n_inliers)
        flips = int((geo_g.inliers.cpu() != geo_c.inliers).sum())
        mg, mc = rs_g.model.cpu().double().flatten(), rs_c.model.double().flatten()
        mg, mc = mg / mg.norm(), mc / mc.norm()
        apart = float(torch.min((mg - mc).norm(), (mg + mc).norm()))
        print(f"[4j model {model} reference] relative_pose card vs CPU plain path, the same "
              f"features, matches and draws: RANSAC kept {int(rs_g.n_inliers)} / "
              f"{int(rs_c.n_inliers)} inliers, models {apart:.2e} apart (unit norm), "
              f"re-fit kept {kept_g} / {kept_c}; final inliers {ng} / {nc} "
              f"({flips} differ), rotation {dR:.2e} rad, translation direction {dt:.2e} rad; "
              f"from the ground truth: card {gt_g[0]:.2e} / {gt_g[1]:.2e}, CPU {gt_c[0]:.2e} / "
              f"{gt_c[1]:.2e} rad")
        check(bool(geo_g.success) and bool(geo_c.success), f"4j model {model}: a pose failed")
        # the float32 minimal solvers round differently on the card, so a
        # borderline inlier or a near-tied NFA can change RANSAC's model
        # and the keep-if-better choice (ROADMAP C16): both held to the
        # ground truth
        check(abs(ng - nc) <= 0.02 * nc and max(gt_g[0], gt_c[0]) < 1e-2
              and max(gt_g[1], gt_c[1]) < 0.15,
              f"4j model {model} card vs CPU: inliers {ng} / {nc}, from the ground "
              f"truth {gt_g} / {gt_c} rad")
        # the re-fit and the decomposition from one inlier set (the CPU's
        # RANSAC inliers) on both devices: within 1e-3 rad
        inl = rs_c.inliers
        one_set = []
        for dv, cams_v in ((dev, s.cams[:2]), (torch.device("cpu"), cams_c)):
            a1, a2 = args[0].to(dv), args[1].to(dv)
            w = inl.to(dv).to(torch.float32)
            if model == "F":
                u1 = cam_ops.undistort_pixel(cams_v[0], a1)
                u2 = cam_ops.undistort_pixel(cams_v[1], a2)
                E = cams_v[1].K.T @ essential.fundamental_8pt(u1, u2, weights=w) @ cams_v[0].K
                one_set.append(essential.decompose_essential(
                    E, cam_ops.normalize(cams_v[0], u1), cam_ops.normalize(cams_v[1], u2),
                    inl.to(dv)))
            else:
                x1 = cam_ops.undistort(cams_v[0], cam_ops.normalize(cams_v[0], a1))
                x2 = cam_ops.undistort(cams_v[1], cam_ops.normalize(cams_v[1], a2))
                Hm = homography.four_point(x1, x2, weights=w)
                one_set.append(homography.decompose_homography(
                    Hm, x1, x2, inl.to(dv), cfg_m.ransac.chirality_ratio)[:2])
        dR1 = rotation_error(torch, one_set[0][0].cpu().double(), one_set[1][0].double())
        dt1 = dir_err(one_set[0][1], one_set[1][1])
        print(f"[4j model {model} reference] the re-fit and decomposition from one inlier set "
              f"({int(inl.sum())}, the CPU's RANSAC inliers), card vs CPU: rotation {dR1:.2e} "
              f"rad, translation direction {dt1:.2e} rad")
        check(dR1 < 1e-3 and dt1 < 1e-3,
              f"4j model {model} re-fit from one inlier set, card vs CPU: {dR1:.2e} / "
              f"{dt1:.2e} rad")
        check(s.init_map(first), f"4j model {model}: the last init_map failed")
        deg, _ = localize_frames(f"4j model {model}", s, imgs, trj, range(1, J_FRAMES + 1))
        print(f"[4j model {model} frames] {J_FRAMES} frames of intra_pose_all on the model-"
              f"{model} map, every drone localized; rotation error median "
              f"{np.median(deg):.4f}, max {deg.max():.4f} deg")

    lap("models F and H done")
    # ---- update_map and the map-update schedule --------------------------
    old = sess.mapdb
    ok = sess.update_map({d: frames[d][J_FRAMES] for d in range(2)})
    check(ok and sess.mapdb is not old, "4j: update_map did not rebuild the map")
    mm = match_maps(sess.mapdb, old, cfg_d.matcher)
    n_common = int((mm.mask & sess.mapdb.valid).sum())
    scale = float(compute_scale_difference(sess.mapdb, old, mm))
    check(n_common >= 2 and abs(scale - 1.0) < 0.05,
          f"4j update_map: {n_common} common landmarks, scale {scale:.4f} against the old map")
    _, ms = timed(lambda: sess.update_map({d: frames[d][J_FRAMES] for d in range(2)}),
                  INIT_CALLS)
    print(f"[4j update_map] frame {J_FRAMES}: {int(sess.mapdb.valid.sum())} landmarks, "
          f"{n_common} common with the old map, scale after the rescale {scale:.5f}; "
          f"{percentiles(np, ms)} over {INIT_CALLS} calls  ({card})")

    def recorded(s):
        log, real = [], s.update_map

        def update_map(images, **kw):
            ok = real(images, **kw)
            log.append((s.frame, ok))
            return ok
        s.update_map = update_map
        return log

    n_h = len(frames_h[0])
    s_r = session.ColocSession(cfg_d, np.stack([K, K]), np.zeros((2, 3), np.float32), seed=SEED)
    log = recorded(s_r)
    out = s_r.run(frames_h, inter_every=0, update_map_every=10)
    check(log == [(f, True) for f in range(10, n_h, 10)], f"4j run: map updates {log}")
    check(all(bool(p.success) for d in range(2) for p in out[d])
          and all(len(out[d]) == n_h - 1 for d in range(2)), "4j run: a frame not localized")
    print(f"[4j run] run(update_map_every=10) over {n_h - 1} frames: every frame of both "
          f"drones localized, the map rebuilt on frames {[f for f, _ in log]}")
    captures, real_init = [], session._StepGraphs.__init__

    def counted_init(self, s, inject=False):
        captures.append(s.mapdb)
        real_init(self, s, inject)

    s_c = session.ColocSession(cfg_d, np.stack([K, K]), np.zeros((2, 3), np.float32), seed=SEED)
    log_c = recorded(s_c)
    session._StepGraphs.__init__ = counted_init
    try:
        out_c = s_c.run_chunked(frames_h, chunk=CHUNK, update_map_every=CHUNK)
    finally:
        session._StepGraphs.__init__ = real_init
    s_e = session.ColocSession(cfg_d, np.stack([K, K]), np.zeros((2, 3), np.float32), seed=SEED)
    log_e = recorded(s_e)
    out_e = s_e.run(frames_h, inter_every=0, update_map_every=CHUNK)
    n_up = (n_h - 1) // CHUNK
    check(len(log_c) == len(log_e) == n_up and all(ok for _, ok in log_c + log_e),
          f"4j run_chunked: map updates {log_c}, eager run {log_e}")
    check(len(captures) == n_up and len(set(map(id, captures))) == n_up,
          f"4j run_chunked: {len(captures)} captures for {n_up} chunks")
    equal = all(torch.equal(a, b) for d in range(2) for p, q in zip(out_c[d], out_e[d])
                for a, b in zip(tensors(p), tensors(q)))
    equal = equal and torch.equal(s_c.mapdb.X, s_e.mapdb.X)
    check(equal, "4j run_chunked with map updates differs from the eager run")
    print(f"[4j run_chunked] run_chunked(chunk={CHUNK}, update_map_every={CHUNK}) over "
          f"{n_h - 1} frames: {len(captures)} captures (one for each map), the map rebuilt after "
          f"each chunk; every frame and the final map bit-equal to run(update_map_every="
          f"{CHUNK}) stepped eagerly from the same seed")


def sync_check(torch, cfg_x, sess, images, tag, mode="warn"):
    """One eager frame step on the card with its draws injected and the
    pose LM's exit left to its done mask, under torch.cuda's sync debug
    mode `mode` ("error" raises at the first synchronising operation): ->
    the file:line of each operation that synchronised."""
    import warnings

    from coloc_tpu_torch import session

    idx = torch.randint(0, 64, (2, cfg_x.ransac.num_hypotheses, 3), device=images.device,
                        generator=torch.Generator(images.device).manual_seed(SEED))
    step = lambda: session.intra_all_device_step(  # noqa: E731
        cfg_x, images, sess.mapdb, sess._map_bank(), sess.Ks, sess.dists, sess.filter_bank,
        sample_idx=idx, check_every=cfg_x.refiner.max_iterations)
    step()      # the caches a first call fills
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    found = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    print(f"[4h sync {tag}] one eager step, draws injected, LM exit on the device: "
          f"{len(found)} synchronising operation sites{': ' + ', '.join(found) if found else ''}")
    return found


def rank_4o(rank, tmp, world, cfgs, devices):
    """One rank of phase 4o (parallel.mesh.spawn imports this module in a
    fresh process, without JAX): join the mesh on cuda:0, run the world's
    programs on 4o's inputs (`tmp`/inputs.npz) and save each program's
    outputs, per-call milliseconds, kernel launches and host-staged
    exchanges to `tmp`/<world><rank>.pt. `world`: "one" (NCCL, one rank:
    the step "full" and "ici" on drone 0's first frame with the rank's
    generator), "pair" (gloo, two ranks on one card: the step "full" and
    "ici" over O_FRAMES frames and the scan over O_SCAN with injected
    draws, sharded serving, the 1-D sharded match), "grid" (gloo, a 2 x 2
    drone x map mesh: the 2-D sharded match)."""
    t_start = time.time()
    import numpy as np
    import torch

    from coloc_tpu_torch import matching, serving
    from coloc_tpu_torch.frontend import detect_and_describe_batch
    from coloc_tpu_torch.fusion import kalman
    from coloc_tpu_torch.geometry.camera import Camera
    from coloc_tpu_torch.ops import dispatch
    from coloc_tpu_torch.parallel import mesh
    from coloc_tpu_torch.types import MapDB

    t_imported = time.time()
    if world == "grid":
        m = mesh.make_mesh(devices, axis_names=("drone", "map"), shape=(2, 2))
    else:
        m = mesh.make_mesh(devices)
    check(m.device == torch.device("cuda", 0), f"4o rank {rank} on {m.device}, not cuda:0")
    torch.cuda.synchronize()
    dev = m.device
    inp = {k: torch.from_numpy(v).to(dev) for k, v in np.load(Path(tmp) / "inputs.npz").items()}
    res = {"t_start": t_start, "t_imported": t_imported, "t_mesh": time.time(),
           "backend": m.backend, "device": str(dev)}

    def program(name, fn, calls):
        """fn(i) for i < calls, each call timed on the host clock up to a
        synchronise: the outputs, ms, launches and host-staged exchanges."""
        dispatch.reset_launch_counts()
        mesh.reset_staging_counts()
        outs, ms = [], []
        for i in range(calls):
            t0 = time.perf_counter()
            outs.append(fn(i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[name] = dict(out=outs, ms=ms, launches=dispatch.launch_counts(),
                         staging=mesh.staging_counts())

    d = m.coords[mesh.DRONE_AXIS]
    if world != "grid":
        cfg = cfgs["step"]
        _, Ks, dists, fb, mapdb = mesh.shard_inputs(
            m, inp["frames"][0], inp["Ks"], inp["dists"], kalman.init(2, cfg.filter, dev),
            MapDB(inp["map_X"], inp["map_desc"], inp["map_valid"]))

        def stepper(mode, injected):
            """Frame f of the step, the filter bank carried from frame to
            frame; the draws injected, or the rank's generator."""
            step, bank = mesh.collaborative_step(m, cfg, inter=mode), [fb]

            def frame(f):
                kw = (dict(sample_idx=inp["loc"][f, d], inter_sample_idx=inp["inter"][f, d])
                      if injected else dict(generator=mesh.rank_generator(m, SEED)))
                out = step(inp["frames"][f, d:d + 1], Ks, dists, bank[0], mapdb, **kw)
                bank[0] = out[0]
                return out
            return frame

        if world == "one":
            program("full", stepper("full", False), 1)
            program("ici", stepper("ici", False), 1)
        else:
            program("full", stepper("full", True), O_FRAMES)
            program("ici", stepper("ici", True), O_FRAMES)
            scan = mesh.collaborative_step_scan(m, cfg)
            program("scan", lambda i: scan(
                inp["frames"][:O_SCAN, d:d + 1], Ks, dists, fb, mapdb,
                sample_idx=inp["loc"][:O_SCAN, d], inter_sample_idx=inp["inter"][O_SCAN - 1, d]),
                O_CALLS)
            # sharded serving: the batched frontend on this rank's streams'
            # frames alone, then its streams against its own copy of the map
            smap = MapDB(inp["serve_X"], inp["serve_desc"], inp["serve_valid"])
            bank = matching.pack_map_bank(smap)
            run = serving.make_sharded_serve_step(m, cfgs["serve"])
            lo, hi, _ = mesh.shard_rows(O_SERVE, m, mesh.DRONE_AXIS)
            cams = Camera(K=inp["serve_K"][lo:hi], dist=inp["serve_dist"][lo:hi])
            program("serving", lambda i: run(
                detect_and_describe_batch(inp["serve_frames"][lo:hi], cfgs["serve"].detector),
                cams, smap, bank, sample_idx=inp["serve_draws"][lo:hi]), O_CALLS)
    if world != "one":
        match = (mesh.sharded_map_match(m, cfgs["matcher"], axis="map", query_axis="drone")
                 if world == "grid" else mesh.sharded_map_match(m, cfgs["matcher"]))
        program("match", lambda i: match(inp["q_desc"], inp["q_valid"], inp["t_desc"],
                                         inp["t_valid"]), O_CALLS)
    to_cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    torch.save(torch.utils._pytree.tree_map(to_cpu, res), Path(tmp) / f"{world}{rank}.pt")


def phase_4o(torch, np, dev, card, cfg_d, Ks2, dists2, map_path, frames, traj, serve_w,
             mapdb_g, q_desc_g, counts):
    """The multi-device forms on the card (parallel/mesh, sharded serving,
    graft_entry): ranks spawned by parallel.mesh.spawn after the kernels
    were built here (phase 2). (a) NCCL at world size 1 on cuda:0 (the
    identity ring) and gloo worlds of 2 and 4 ranks sharing cuda:0, every
    exchange staged through the host; (b) collaborative_step "full" and
    "ici" over O_FRAMES of 4d's frames on 4d's saved bootstrap map, with
    injected draws, every rank's outputs torch.equal to the single-process
    composition here (detect, match_with_map, localize_image,
    kalman.update; inter_pose_device or ICI with the ring predecessor),
    inside 4i's fusion gates; the world of one with its generator against
    the composition with the same generator; (c) the scan over O_SCAN
    frames equal to (b) frame by frame; (d) sharded serving at B = O_SERVE
    of 4m's renders, each rank's frontend on its own frames, equal per shard to
    ServingEngine.localize_features with the same draws and within 4m's
    gate; (e) sharded_map_match on 4g's bank over 2 ranks and a 2 x 2 mesh
    equal to one hamming_2nn and _accept; (f) `python -m
    coloc_tpu_torch.graft_entry` (4 ranks) exits 0. Spawn and init
    seconds, each program's p50 on each rank, the staged exchanges' ms and
    bytes."""
    import os
    import shutil
    import tempfile

    from coloc_tpu_torch import checkpoint, config, matching, serving
    from coloc_tpu_torch.frontend import detect_and_describe, detect_and_describe_batch
    from coloc_tpu_torch.fusion import covint, kalman
    from coloc_tpu_torch.geometry.camera import Camera
    from coloc_tpu_torch.ops import hamming
    from coloc_tpu_torch.parallel import mesh
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.sfm.localize import localize_image
    from coloc_tpu_torch.types import Features, Pose

    t_4o = time.perf_counter()
    mapdb = checkpoint.load_mapdb(str(map_path), dev)
    imgs = torch.from_numpy(np.stack([[frames[d][f] for d in range(2)]
                                      for f in range(1, O_FRAMES + 1)])).to(dev)
    Ks = torch.from_numpy(Ks2).to(dev)
    dists = torch.from_numpy(dists2).to(dev)
    cams = [Camera(K=Ks[d], dist=dists[d]) for d in range(2)]

    # the draws every path below is handed: P3P samples from each drone's
    # map-match correspondences, five-point ones from the ring pair's matches
    feats = [[detect_and_describe(imgs[f, d], cfg_d.detector) for d in range(2)]
             for f in range(O_FRAMES)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    corr = torch.stack([torch.stack([
        matching.match_with_map(fe, mapdb, cfg_d.matcher).mask & fe.valid for fe in row])
        for row in feats])
    pair = torch.stack([torch.stack([
        matching.match_pair(row[(d - 1) % 2], row[d], cfg_d.matcher).mask for d in range(2)])
        for row in feats])
    nb = cfg_d.ransac.num_hypotheses
    loc, inter = sample_indices(corr, nb, 3, gen), sample_indices(pair, nb, 5, gen)

    def compose(mode, n, gens=None, drones=2):
        """The step by hand, frame by frame: per drone the frame's features
        -> match_with_map -> localize_image -> kalman.update, then each drone
        with its ring predecessor. -> per frame, per drone, the step's
        outputs (bank row, position, covariance, fused position and
        covariance, ok) and the inter-drone core's output ("full")."""
        bank, frames_out = kalman.init(2, cfg_d.filter, dev), []
        for f in range(n):
            per = []
            for d in range(drones):
                fe = feats[f][d]
                mm = matching.match_with_map(fe, mapdb, cfg_d.matcher)
                kw = dict(generator=gens[d]) if gens else dict(sample_idx=loc[f, d])
                pwc, _ = localize_image(fe, mm, mapdb, cams[d], cfg_d.ransac, cfg_d.refiner, **kw)
                bank, filt, _, _ = kalman.update(bank, d, kalman.fill_measurement(pwc.pose),
                                                 pwc.cov[3:6, 3:6], pwc.rmse, pwc.success,
                                                 cfg_d.filter)
                per.append((filt, pwc, fe))
            rows = []
            for d in range(drones):
                src = (d - 1) % drones
                (filt, pwc, fe), (filt_s, pwc_s, fe_s) = per[d], per[src]
                eye = 1e-5 * torch.eye(3, device=dev)
                cov, cov_s = pwc.cov[3:6, 3:6] + eye, pwc_s.cov[3:6, 3:6] + eye
                core = core_in = None
                if mode == "full":
                    kw = dict(generator=gens[d]) if gens else dict(sample_idx=inter[f, d])
                    core = mesh.inter_pose_device(
                        fe, fe_s, cams[src], cams[d], torch.stack([Ks[src], Ks[d]]),
                        torch.stack([dists[src], dists[d]]), Pose(R=filt_s.R, C=filt_s.C),
                        cov_s, filt.C, cov, mapdb, cfg_d, **kw)
                    fused = (core.fused_pos, core.fused_cov, core.ok)
                    # the two estimates the ICI fused, as 4i's fusion_inputs
                    e6 = 1e-6 * torch.eye(3, device=dev)
                    core_in = [t.detach().double().cpu().numpy() for t in (
                        cov + e6, cov_s + core.diag.cov_rel + e6, filt.C,
                        filt_s.C + filt_s.R.T @ core.rel.C)]
                else:
                    ici = covint.fuse(cov, cov_s, filt.C, filt_s.C)
                    fused = (ici.pos, ici.cov, pwc.success)
                rows.append(dict(step=[t[d:d + 1] for t in bank]
                                 + [t[None] for t in (filt.C, cov, *fused)],
                                 core=core, core_in=core_in, success=bool(pwc.success)))
            frames_out.append(rows)
        return frames_out

    def equal(got, want, what):
        check(len(got) == len(want) and all(torch.equal(g, w.cpu()) for g, w in zip(got, want)),
              f"4o {what}: differs from the composition")

    def rank_ms(res, name):
        return "; ".join(f"rank {r} {percentiles(np, res[r][name]['ms'])}"
                         for r in range(len(res)))

    # the map-match case: 4g's bank and planted queries
    opts = config.MatcherOptions()
    q_valid = torch.ones(q_desc_g.shape[0], dtype=torch.bool, device=dev)
    want_m = matching._accept(*hamming.hamming_2nn(
        q_desc_g, mapdb_g.desc, q_valid, mapdb_g.valid), q_valid, opts, opts.margin_threshold)
    # sharded serving: O_SERVE of 4m's renders against 4m's map, a camera a
    # stream; each shard's features from the batched frontend on its frames
    # alone, as its rank computes them
    smap, simages, R_gt, C_gt = serve_w
    scfg = dataclasses.replace(config.ColocConfig(), detector=cfg_d.detector)
    eng = serving.ServingEngine(smap, Camera(K=Ks[0], dist=dists[0]), scfg, device=dev)
    b = O_SERVE // 2
    shard_feats = [detect_and_describe_batch(simages[d * b:(d + 1) * b], cfg_d.detector)
                   for d in range(2)]
    sfeats = Features(*(torch.cat(ts) for ts in zip(*shard_feats)))
    smm = eng.localize_features(sfeats, generator=torch.Generator(device=dev).manual_seed(
        SEED + 61))[2]
    sdraws = sample_indices(smm.mask & sfeats.valid, nb, 3,
                            torch.Generator(device=dev).manual_seed(SEED + 62))

    tmp = Path(tempfile.mkdtemp(prefix="coloc-4o-"))
    arrays = dict(frames=imgs, Ks=Ks, dists=dists, map_X=mapdb.X, map_desc=mapdb.desc,
                  map_valid=mapdb.valid, loc=loc, inter=inter, q_desc=q_desc_g,
                  q_valid=q_valid, t_desc=mapdb_g.desc, t_valid=mapdb_g.valid,
                  serve_frames=simages[:O_SERVE], serve_X=smap.X, serve_desc=smap.desc,
                  serve_valid=smap.valid, serve_K=Ks[:1].expand(O_SERVE, 3, 3).contiguous(),
                  serve_dist=dists[:1].expand(O_SERVE, 3).contiguous(), serve_draws=sdraws)
    np.savez(tmp / "inputs.npz", **{k: v.cpu().numpy() for k, v in arrays.items()})
    cfgs = dict(step=cfg_d, serve=scfg, matcher=opts)
    results = {}
    try:
        for world, n, devices in (("one", 1, None), ("pair", 2, "cuda:0"), ("grid", 4, "cuda:0")):
            t0 = time.time()
            mesh.spawn(rank_4o, n, (str(tmp), world, cfgs, devices))
            res = [torch.load(tmp / f"{world}{r}.pt", weights_only=False) for r in range(n)]
            results[world] = res
            print(f"[4o {world}] {n} rank(s) on {res[0]['device']} over {res[0]['backend']}: "
                  f"{time.time() - t0:.1f} s in all; from spawn to the rank's first line "
                  + ", ".join(f"{r['t_start'] - t0:.1f}" for r in res) + " s, imports "
                  + ", ".join(f"{r['t_imported'] - r['t_start']:.1f}" for r in res)
                  + " s, make_mesh " + ", ".join(f"{r['t_mesh'] - r['t_imported']:.2f}"
                                                 for r in res) + f" s  ({card})")
            check(all(r["device"] == "cuda:0" for r in res), f"4o {world}: a rank off cuda:0")
            check(res[0]["backend"] == ("nccl" if n == 1 else "gloo"),
                  f"4o {world}: backend {res[0]['backend']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (a) + (b) the world of one (NCCL): its generator against the composition's
    gens = lambda: [torch.Generator(device=dev).manual_seed(SEED * 2 ** 16)]
    one = results["one"][0]
    for mode in ("full", "ici"):
        want = compose(mode, 1, gens(), drones=1)[0][0]["step"]
        equal(torch.utils._pytree.tree_leaves(one[mode]["out"][0]), want, f"one {mode}")
    print(f"[4o one] {one['backend']}, world size 1: the step (\"full\": the drone fused with "
          f"itself; \"ici\") equal to the composition with the same generator; launches "
          f"{one['full']['launches']}")

    # (b) the pair: the step frame by frame, "full" and "ici", against the composition
    pair_res = results["pair"]
    full = compose("full", O_FRAMES)
    ici = compose("ici", O_FRAMES)
    n_ok, worst = 0, {}
    for f in range(O_FRAMES):
        for d in range(2):
            equal(torch.utils._pytree.tree_leaves(pair_res[d]["full"]["out"][f]),
                  full[f][d]["step"], f"full frame {f} drone {d}")
            equal(torch.utils._pytree.tree_leaves(pair_res[d]["ici"]["out"][f]),
                  ici[f][d]["step"], f"ici frame {f} drone {d}")
            check(full[f][d]["success"], f"4o frame {f} drone {d}: localization failed")
            core = full[f][d]["core"]
            if bool(core.ok):
                # 4i's gates on the fusion the ranks' outputs equal
                n_ok += 1
                src = (d - 1) % 2
                R_rel = torch.from_numpy(traj[d][0][f + 1] @ traj[src][0][f + 1].T).to(dev)
                dR = rotation_error(torch, core.rel.R, R_rel)
                cov = core.fused_cov.double().cpu().numpy()
                check(dR < 1e-2 and np.allclose(cov, cov.T, atol=1e-7)
                      and np.linalg.eigvalsh(cov).min() > 0,
                      f"4o frame {f} drone {d}: relative rotation {dR:.2e} rad from the "
                      f"truth, or the fused covariance not SPD")
                g = fusion_gates(np, f"4o frame {f} drone {d}", core, *full[f][d]["core_in"],
                                 core.fused_pos.double().cpu().numpy(),
                                 float(core.diag.trace), float(core.diag.omega))
                worst = {k: max(worst.get(k, 0.0), g[k]) for k in ("tr_rel", "d_w")}
                worst["d_pos/gap"] = max(worst.get("d_pos/gap", 0.0), g["d_pos"] / g["gap"])
                worst["n_common"] = min(worst.get("n_common", 1 << 30), g["n_common"])
    check(n_ok >= 1, "4o: no drone fused on any frame")
    st = pair_res[0]["full"]["staging"]
    print(f"[4o step] 2 ranks on {pair_res[0]['device']} over {pair_res[0]['backend']}, "
          f"{O_FRAMES} frames of 4d: \"full\" and "
          f"\"ici\" every output equal to the composition (torch.equal); {n_ok} of "
          f"{2 * O_FRAMES} fusions ok, each within 1e-2 rad of the true relative rotation, "
          f"fused covariances SPD, and in 4i's gates (fewest common landmarks "
          f"{worst['n_common']}, scale finite and > 0; ICI against float64 at worst: trace "
          f"{worst['tr_rel']:.2e} relative, w* {worst['d_w']:.2e}, position "
          f"{worst['d_pos/gap']:.2e} of |a - b|); a frame, full: {rank_ms(pair_res, 'full')}; ici: "
          f"{rank_ms(pair_res, 'ici')}  ({card})")
    print(f"[4o exchange] rank 0's ring_shift of a frame bundle staged through the host: "
          f"{st['exchanges']} exchanges, {st['bytes'] // max(st['exchanges'], 1)} bytes each, "
          f"{st['seconds'] * 1e3 / max(st['exchanges'], 1):.3f} ms each (copies and the "
          f"collective)  ({card})")
    counts["4o step"] = {k: sum(r["full"]["launches"][k] for r in pair_res)
                         for k in pair_res[0]["full"]["launches"]}

    # (c) the scan against the step frame by frame
    for d in range(2):
        out = torch.utils._pytree.tree_leaves(pair_res[d]["scan"]["out"][0])
        last = full[O_SCAN - 1][d]["step"]
        equal(out[:3], [t for t in last[:3]], f"scan drone {d} filter bank")
        for f in range(O_SCAN):
            equal([out[3][f], out[4][f]], full[f][d]["step"][3:5], f"scan frame {f} drone {d}")
        check(bool(out[5].all()), f"4o scan drone {d}: a frame failed")
        equal(out[6:], last[5:], f"scan drone {d} exchange")
    counts["4o scan"] = {k: sum(r["scan"]["launches"][k] for r in pair_res) // O_CALLS
                         for k in pair_res[0]["scan"]["launches"]}
    print(f"[4o scan] {O_SCAN} frames then one exchange, equal to the step frame by frame: "
          f"{rank_ms(pair_res, 'scan')} a call  ({card})")

    # (d) sharded serving against the engine on each shard, same draws
    for d in range(2):
        rows = slice(d * b, (d + 1) * b)
        want = eng.localize_features(shard_feats[d], sample_idx=sdraws[rows])
        equal(torch.utils._pytree.tree_leaves(pair_res[d]["serving"]["out"][0]),
              torch.utils._pytree.tree_leaves(want), f"serving shard {d}")
        pwc = pair_res[d]["serving"]["out"][0][0]
        for i in range(b):
            rot = rotation_error(torch, pwc.pose.R[i].to(dev), R_gt[d * b + i])
            c_err = float(torch.linalg.norm(pwc.pose.C[i].to(dev) - C_gt[d * b + i]))
            check(bool(pwc.success[i]) and rot < SERVE_GATE[0] and c_err < SERVE_GATE[1],
                  f"4o serving stream {d * b + i}: rotation {rot:.2e} rad, centre {c_err:.2e} m")
    counts["4o serving"] = {k: sum(r["serving"]["launches"][k] for r in pair_res) // O_CALLS
                            for k in pair_res[0]["serving"]["launches"]}
    print(f"[4o serving] B={O_SERVE} over 2 ranks, the batched frontend on the rank's "
          f"{b} frames and the step in each: "
          f"each shard equal to ServingEngine.localize_features with the same draws, every "
          f"stream within {SERVE_GATE[0]} rad and {SERVE_GATE[1]} m; "
          f"{rank_ms(pair_res, 'serving')} a dispatch  ({card})")

    # (e) the sharded match against one hamming_2nn + _accept
    for r in range(2):
        equal(list(pair_res[r]["match"]["out"][0]), list(want_m), f"1-D match rank {r}")
    grid = results["grid"]
    Q, qs = q_desc_g.shape[0], -(-q_desc_g.shape[0] // 2)
    for r in range(4):
        rows = slice((r // 2) * qs, min((r // 2 + 1) * qs, Q))
        equal(list(grid[r]["match"]["out"][0]), [t[rows] for t in want_m], f"2x2 match rank {r}")
    counts["4o match"] = {k: sum(r["match"]["launches"][k] for r in pair_res + grid) // O_CALLS
                          for k in grid[0]["match"]["launches"]}
    print(f"[4o match] Q={Q} x T={mapdb_g.desc.shape[0]}: over 2 ranks and a 2 x 2 drone x map "
          f"mesh equal to one hamming_2nn + _accept; 1-D {rank_ms(pair_res, 'match')}; "
          f"2 x 2 {rank_ms(grid, 'match')}; all_gather staged "
          f"{grid[0]['match']['staging']['bytes'] // O_CALLS} bytes a call on rank 0  ({card})")

    # (f) the port's graft entry: entry() and the 4-rank dry run
    repo = Path(__file__).resolve().parent
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "coloc_tpu_torch.graft_entry"], cwd=str(repo),
                          env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True,
                          text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("dryrun", "entry"))]
    check(proc.returncode == 0, f"4o graft_entry exited {proc.returncode}:\n"
          + proc.stdout[-2000:] + proc.stderr[-3000:])
    check(all(f"dryrun[{p}] ok" in proc.stdout for p in ("step", "scan", "serving", "map2d"))
          and "entry() ok on cuda:0" in proc.stdout, f"4o graft_entry: {lines}")
    print(f"[4o graft_entry] python -m coloc_tpu_torch.graft_entry exited 0 in "
          f"{time.time() - t0:.1f} s: {' | '.join(lines)}")
    print(f"[time] 4o took {time.perf_counter() - t_4o:.1f} s")


def main(argv=None) -> int:
    t_main = time.perf_counter()
    import argparse

    import torch

    def lap(phase):
        """The script's wall time when `phase` starts."""
        print(f"[time] phase {phase} starts at {time.perf_counter() - t_main:.1f} s")

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory with the parent commit's "
                         f"{', '.join(n + '.cu' for n in PARENT_KERNELS)}: phase 3 "
                         "times them beside this tree's kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 1

    import numpy as np

    import coloc_tpu_torch
    from coloc_tpu_torch import config, convert, frontend, session
    from coloc_tpu_torch.fusion import kalman
    from coloc_tpu_torch.geometry import camera as cam_ops
    from coloc_tpu_torch.geometry import fivept, p3p
    from coloc_tpu_torch.io import synthetic
    from coloc_tpu_torch.matching import (match_pair, match_with_map, pack_map_bank,
                                          pack_map_bank_twostage)
    from coloc_tpu_torch.ops import (_build, diffusion, dispatch, fast, hamming, patches,
                                     pyramid, ransac_rank)
    from coloc_tpu_torch.ransac import sample_indices
    from coloc_tpu_torch.sfm.localize import localize_image
    from coloc_tpu_torch.types import Features, MapDB

    # the port must come from this checkout, so its kernels build from here
    pkg = Path(coloc_tpu_torch.__file__).resolve().parent
    check(pkg.parent == Path(__file__).resolve().parent,
          f"coloc_tpu_torch imported from {pkg}, not from this checkout")

    # ---- phase 1: device ------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    print(card)

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds:.2f} s) -> {_build.library_path(_build._nvcc()).name}")
    print_ptxas("build", _build.build_log)
    sass = sass_scan(_build.library_path(_build._nvcc()), _build._nvcc())
    for fn, (ops, n_local) in sass.items():
        if ops or n_local or any(k in fn for k in ("p3p_kernel", "rank_kernel", "front_kernel",
                                                   "dk_kernel", "polish_kernel")):
            print(f"    SASS {fn}: MMA {', '.join(ops) or 'none'}; {n_local} local-memory "
                  f"loads and stores")
    for kern, tag in (("k2nn_mma_kernel", "B1"), ("k2nn_group_kernel", "B12")):
        check(any(ops for fn, (ops, _) in sass.items() if kern in fn),
              f"{tag}'s kernel shows no MMA instruction in its SASS")
    for kern, tag in (("front_kernel", "B6"), ("dk_kernel", "B7"), ("polish_kernel", "B8")):
        n_local = [n for fn, (_, n) in sass.items() if kern in fn]
        check(bool(n_local) and not any(n_local), f"{tag}'s kernel is missing from the SASS "
              f"or loads or stores local memory ({n_local})")
    parent = {}
    if args.parent is not None:
        t0 = time.perf_counter()
        parent = build_parent(args.parent.resolve())
        print(f"[2 build] the parent's {', '.join(parent)} from {args.parent}: "
              f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(SEED)
    fa, ma, K, n_out = workload(np, rng)
    feats = convert.features_from_numpy(fa, dev)
    mapdb = convert.mapdb_from_numpy(ma, dev)
    cam = convert.camera_from_numpy(K, device=dev)
    cfg = config.ColocConfig()
    results = {}

    lap("3")
    # ---- phase 3: kernels against their plain twins -------------------
    # B1: Q=1024 x T=4096, duplicates of query 0 planted in other bank
    # tiles, a band of invalid rows that holds query 5's own row
    t_desc = mapdb.desc.clone()
    t_desc[2100] = t_desc[0]
    t_desc[3900] = t_desc[0]
    t_valid = mapdb.valid.clone()
    t_valid[3:40] = False
    bank = hamming.pack_bank(t_desc, t_valid)
    q_valid = feats.valid.clone()
    q_valid[7] = False

    def check_k2nn(tag, q, qv, bank, best_row, own_row):
        """B1 against its twin, bit for bit, and the planted semantics."""
        out_k = hamming._hamming_2nn_cuda(q, qv, bank)
        out_p = hamming.hamming_2nn_plain(q, qv, bank)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(out_k, out_p))
        check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
              f"k2nn {tag} differs from its plain twin (max |diff| {err})")
        check(int(out_k[0][0]) == best_row and int(out_k[1][0]) == 0
              and int(out_k[2][0]) == 0, f"k2nn {tag}: duplicate semantics")
        check(int(out_k[1][7]) == 2048 and int(out_k[2][7]) == 2048,
              f"k2nn {tag}: invalid-query semantics")
        check(int(out_k[0][5]) != own_row, f"k2nn {tag}: an invalid row was best")
        print(f"[3 k2nn] {tag}: bit-equal to the twin (duplicates of query 0's best in "
              f"other splits, an invalid band, an invalid query)")
        return float(err)

    def k2nn_pair(q, qv, bank):
        """This tree's B1 and, with --parent, the parent's on the same inputs."""
        new = lambda: hamming._hamming_2nn_cuda(q, qv, bank)  # noqa: E731
        if "k2nn" not in parent:
            return new, None
        outs = [torch.empty(q.shape[0], dtype=torch.int32, device=dev) for _ in range(3)]
        launch = (q.data_ptr(), qv.data_ptr(), bank.desc.data_ptr(), bank.pen.data_ptr(),
                  *(o.data_ptr() for o in outs), q.shape[0], bank.desc.shape[0], dev.index,
                  dispatch.stream_handle(dev))

        def old():
            check(parent["k2nn"](*launch) == 0, "the parent's k2nn did not launch")
        return new, old

    err = check_k2nn("Q=1024 x T=4096", feats.desc, q_valid, bank, 0, 5)
    results["k2nn"] = dict(
        max_abs_err=err,
        plain_ms=cuda_ms(lambda: hamming.hamming_2nn_plain(feats.desc, q_valid, bank)),
        **timed_pair("k2nn Q=1024 x T=4096", *k2nn_pair(feats.desc, q_valid, bank),
                     "k2nn", card))
    # B1 at the AKAZE frame's shape (4e) and the large map's (4g), timed,
    # and at Q and T that are no multiple of the query tile or the stage
    # (the last stage holds 8 rows, one of them a duplicate)
    for i, (Qc, Tc, timed) in enumerate(((5000, 8192, True), (1024, 262144, True),
                                         (1000, 8200, False))):
        q_c, qv_c, bank_c, r0, own = k2nn_case(np, torch, dev, Qc, Tc, SEED + 100 + i)
        tag = f"Q={Qc} x T={Tc}"
        err = check_k2nn(tag, q_c, qv_c, bank_c, r0, own)
        results["k2nn"]["max_abs_err"] = max(results["k2nn"]["max_abs_err"], err)
        if timed:
            timed_pair(f"k2nn {tag}", *k2nn_pair(q_c, qv_c, bank_c), "k2nn", card,
                       bound(Qc * 65 + Tc * 68 + 12 * Qc, 2.0 * Qc * Tc * 512, INT8_OPS))
        del q_c, qv_c, bank_c

    # B1 at the fusion round's map-against-map shape (4i): the map's 4096
    # landmarks as queries against a temp map of 4096 slots, whose first KP
    # slots hold the frame's features (a third of them invalid, as outside
    # the two-view inliers) and the rest zero descriptors, invalid
    temp_desc = torch.zeros((LANDMARKS, 16), dtype=torch.int32, device=dev)
    temp_desc[:KP] = feats.desc
    temp_valid = torch.zeros(LANDMARKS, dtype=torch.bool, device=dev)
    temp_valid[:KP] = torch.rand(KP, generator=torch.Generator(device=dev).manual_seed(SEED + 3),
                                 device=dev) > 1.0 / 3.0
    bank_m = hamming.pack_bank(temp_desc, temp_valid)
    out_k = hamming._hamming_2nn_cuda(mapdb.desc, mapdb.valid, bank_m)
    out_p = hamming.hamming_2nn_plain(mapdb.desc, mapdb.valid, bank_m)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          "k2nn at the map-against-map shape differs from its plain twin")
    hits = int(((out_k[0] >= 0) & (out_k[1] == 0)).sum())
    print(f"[3 k2nn] Q={LANDMARKS} x T={LANDMARKS} map against a temp map ({int(temp_valid.sum())} "
          f"valid slots): bit-equal to the twin, {hits} exact hits")
    check(hits > 0, "k2nn at the map-against-map shape found no exact hit")
    timed_pair(f"k2nn Q={LANDMARKS} x T={LANDMARKS} (maps)",
               *k2nn_pair(mapdb.desc, mapdb.valid, bank_m), "k2nn", card,
               bound(LANDMARKS * 65 + LANDMARKS * 68 + 12 * LANDMARKS,
                     2.0 * LANDMARKS * LANDMARKS * 512, INT8_OPS))
    print(f"[3 k2nn] Q={LANDMARKS} x T={LANDMARKS} (maps): plain twin "
          f"{cuda_ms(lambda: hamming.hamming_2nn_plain(mapdb.desc, mapdb.valid, bank_m)):.4f} "
          f"ms  ({card})")
    del temp_desc, temp_valid, bank_m, out_k, out_p

    # B2: 256 minimal samples of the frame's 2D-3D correspondences (and
    # 1000 more). Against its twin statistically (float32 P3P, ROADMAP C8):
    # valid masks agree on >= 99% of samples, flats within 1e-4 (1+|x|)-
    # relative where both are valid; with --parent, against the parent's
    # kernel bit for bit, flats (NaN included) and valid flags.
    corr = torch.ones(KP, dtype=torch.bool, device=dev)
    Xc = mapdb.X[:KP]
    bc = cam_ops.bearing(cam, feats.xy)

    def p3p_pair(X, b):
        """This tree's B2 and, with --parent, the parent's on the same samples."""
        new = lambda: p3p._p3p_flats_cuda(X, b)  # noqa: E731
        if "p3p" not in parent:
            return new, None
        outs = (torch.empty((X.shape[0], 4, 12), device=dev),
                torch.empty((X.shape[0], 4), dtype=torch.bool, device=dev))
        launch = (X.data_ptr(), b.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                  X.shape[0], dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["p3p"](*launch) == 0, "the parent's p3p did not launch")
            return outs
        return new, old

    p3p_err = 0.0
    for nb in (cfg.ransac.num_hypotheses, 1000):
        idx = sample_indices(corr, nb, 3, torch.Generator(device=dev).manual_seed(SEED + nb))
        Xs_c, bs_c = Xc[idx].contiguous(), bc[idx].contiguous()
        fk, vk = p3p._p3p_flats_cuda(Xs_c, bs_c)
        fp, vp = p3p.p3p_flats_plain(Xs_c, bs_c)
        torch.cuda.synchronize()
        both = vk & vp
        valid_agree = float((vk == vp).all(dim=1).float().mean())
        diff = (fk - fp).abs()[both]
        rel = (diff / (1.0 + fp.abs()[both])).max() if both.any() else torch.tensor(0.0)
        exact = float((fk == fp).all(dim=2)[both].float().mean()) if both.any() else 1.0
        print(f"[3 p3p] B={nb}: valid masks agree on {valid_agree:.4f} of samples, "
              f"{int(both.sum())} poses valid in both, {exact:.4f} of them bit-equal to the twin")
        check(valid_agree >= 0.99, f"p3p valid masks agree on {valid_agree:.4f} < 0.99")
        check(float(rel) <= 1e-4, f"p3p flats differ by {float(rel):.3e} (1+|x|)-relative")
        p3p_err = max(p3p_err, float(diff.max()) if both.any() else 0.0)
        _, old = p3p_pair(Xs_c, bs_c)
        if old is not None:
            fo, vo = old()
            torch.cuda.synchronize()
            check(torch.equal(fk.view(torch.int32), fo.view(torch.int32))
                  and torch.equal(vk, vo), f"p3p B={nb} differs from the parent's kernel")
            print(f"[3 p3p] B={nb}: flats and valid bit-equal to the parent's kernel")
        if nb == cfg.ransac.num_hypotheses:
            Xs, bs, flats_main = Xs_c, bs_c, fk
    results["p3p"] = dict(
        max_abs_err=p3p_err,
        plain_ms=cuda_ms(lambda: p3p.p3p_flats_plain(Xs, bs)),
        **timed_pair(f"p3p B={Xs.shape[0]}", *p3p_pair(Xs, bs), "p3p_kernel", card))

    # B3: torch.equal with its twin in both zmodes: the main path's operands
    # (Hm=1024 models, the 256 samples' flats, x M=1024), the AKAZE frame's
    # M=5000 (the correspondences resampled with 1 cm noise on the points,
    # 20% invalid), (1, 5), (9, 300), and the planted edge inputs of
    # tests/rank_cases.py, alone and repeated 97 times against the models
    # tiled to 1000
    focal = (cam.fx + cam.fy) * 0.5
    thr_sq = cfg.ransac.p3p_threshold ** 2
    ops = tuple(t.contiguous() for t in ransac_rank.p3p_operands(
        flats_main.reshape(-1, 12), Xc, bc, corr, focal))
    rrng = np.random.default_rng(SEED + 3)
    pick = torch.from_numpy(rrng.integers(0, KP, AKAZE_RANK_M)).to(dev)
    X_m = Xc[pick] + torch.from_numpy(rrng.normal(0, 0.01, (AKAZE_RANK_M, 3))
                                      .astype(np.float32)).to(dev)
    v_m = torch.from_numpy(rrng.random(AKAZE_RANK_M) > 0.2).to(dev)
    ops_m = tuple(t.contiguous() for t in ransac_rank.p3p_operands(
        flats_main.reshape(-1, 12), X_m, bc[pick], v_m, focal))
    cases = tests_module("rank_cases")
    planted = tuple(torch.from_numpy(a).to(dev) for a in cases.planted_rank_operands())
    tiled = tuple(torch.from_numpy(a).to(dev) for a in cases.planted_rank_operands(97))
    tiled = (tiled[0].repeat(167, 1)[:1000].contiguous(), *tiled[1:])
    rank_inputs = (("Hm=1024 x M=1024", ops, thr_sq),
                   (f"Hm=1024 x M={AKAZE_RANK_M}", ops_m, thr_sq),
                   ("Hm=1 x M=5", (ops[0][:1].contiguous(), *(t[..., :5].contiguous()
                                                              for t in ops[1:])), thr_sq),
                   ("Hm=9 x M=300", (ops[0][:9].contiguous(), *(t[..., :300].contiguous()
                                                                for t in ops[1:])), thr_sq),
                   ("planted 6 x 13", planted, cases.THR_SQ),
                   ("planted 1000 x 1261", tiled, cases.THR_SQ))
    for tag, ops_c, thr_c in rank_inputs:
        for zmode in ("pos", "nonzero"):
            rk = ransac_rank._ladder_rank_cuda(*ops_c, thr_c, zmode, 2, 5)
            rp = ransac_rank.ladder_rank_plain(*ops_c, thr_c, zmode)
            torch.cuda.synchronize()
            d = float((rk - rp).abs().max())
            check(torch.equal(rk, rp), f"rank {tag} zmode={zmode} differs from its plain twin "
                  f"on {int((rk != rp).sum())} models (max |diff| {d})")
        print(f"[3 ransac_rank] {tag}: equal to the twin in both zmodes (torch.equal), "
              f"ranks {float(rp.min()):.0f}-{float(rp.max()):.0f} (nonzero)")

    # B3's drone axis (one launch, the grid's z): each drone's ranks equal
    # to a D = 1 launch on its slabs and to the batched twin, in both
    # zmodes, at (D, Hm, M) = (2, 256, 1024) and (3, 1024, 5000), each
    # drone its own rows of the models and its own mask; and the planted
    # edges tiled over 3 drones, drone d's mask rolled by d
    def drone_stack(ops_c, D, Hm, seed):
        g = np.random.default_rng(seed)
        rows = [torch.from_numpy(g.permutation(ops_c[0].shape[0])[:Hm]).to(dev)
                for _ in range(D)]
        masks = [torch.where(torch.from_numpy(g.random(ops_c[3].shape[0]) < 0.1).to(dev),
                             0.0, ops_c[3]) for _ in range(D)]
        return (torch.stack([ops_c[0][r] for r in rows]).contiguous(),
                torch.stack([ops_c[1]] * D).contiguous(), torch.stack([ops_c[2]] * D).contiguous(),
                torch.stack(masks).contiguous())

    drone_inputs = (("D=2 x Hm=256 x M=1024", drone_stack(ops, 2, 256, SEED + 5), thr_sq),
                    (f"D=3 x Hm=1024 x M={AKAZE_RANK_M}", drone_stack(ops_m, 3, 1024, SEED + 6),
                     thr_sq),
                    ("planted D=3 x 1000 x 1261",
                     (torch.stack([tiled[0]] * 3).contiguous(),
                      *(torch.stack([t] * 3).contiguous() for t in tiled[1:3]),
                      torch.stack([tiled[3].roll(d) for d in range(3)]).contiguous()),
                     cases.THR_SQ))
    for tag, ops_c, thr_c in drone_inputs:
        for zmode in ("pos", "nonzero"):
            n0 = dispatch.launch_counts()["ransac_rank"]
            rk = ransac_rank._ladder_rank_cuda(*ops_c, thr_c, zmode, 2, 5)
            check(dispatch.launch_counts()["ransac_rank"] == n0 + 1,
                  f"rank {tag}: the drone axis took more than one launch")
            rp = ransac_rank.ladder_rank_plain(*ops_c, thr_c, zmode)
            for d in range(ops_c[0].shape[0]):
                one = ransac_rank._ladder_rank_cuda(*(t[d] for t in ops_c), thr_c, zmode, 2, 5)
                torch.cuda.synchronize()
                check(torch.equal(rk[d], one), f"rank {tag} zmode={zmode}: drone {d} differs "
                      f"from its D=1 launch on {int((rk[d] != one).sum())} models")
            check(torch.equal(rk, rp), f"rank {tag} zmode={zmode} differs from its plain twin "
                  f"on {int((rk != rp).sum())} models")
        print(f"[3 ransac_rank drone axis] {tag}: one launch, each drone equal to its D=1 "
              f"launch and to the twin in both zmodes (torch.equal)")
    ops_d = drone_inputs[0][1]
    ms_d = cuda_ms(lambda: ransac_rank._ladder_rank_cuda(*ops_d, thr_sq, "pos", 2, 5))
    ms_1 = cuda_ms(lambda: [ransac_rank._ladder_rank_cuda(*(t[d] for t in ops_d), thr_sq,
                                                          "pos", 2, 5) for d in range(2)])
    print(f"[3 ransac_rank drone axis] D=2 x Hm=256 x M=1024: one launch {ms_d:.4f} ms, two "
          f"D=1 launches {ms_1:.4f} ms (wrapper, CUDA events)  ({card})")
    del drone_inputs, ops_d

    def rank_pair(ops_c):
        """This tree's B3 and, with --parent, the parent's on the same operands."""
        new = lambda: ransac_rank._ladder_rank_cuda(*ops_c, thr_sq, "pos", 2, 5)  # noqa: E731
        if "ransac_rank" not in parent:
            return new, None
        out = torch.empty(ops_c[0].shape[0], device=dev)
        launch = (*(t.data_ptr() for t in ops_c), out.data_ptr(), ops_c[0].shape[0],
                  ops_c[1].shape[1], float(thr_sq), -2, 5, 0, dev.index,
                  dispatch.stream_handle(dev))

        def old():
            check(parent["ransac_rank"](*launch) == 0, "the parent's ransac_rank did not launch")
            return out
        return new, old

    results["ransac_rank"] = dict(
        max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: ransac_rank.ladder_rank_plain(*ops, thr_sq, "pos")),
        **timed_pair("ransac_rank Hm=1024 x M=1024", *rank_pair(ops), "rank_kernel", card,
                     rank_bound(ops)))
    timed_pair(f"ransac_rank Hm=1024 x M={AKAZE_RANK_M}", *rank_pair(ops_m), "rank_kernel",
               card, rank_bound(ops_m))
    plain_m = cuda_ms(lambda: ransac_rank.ladder_rank_plain(*ops_m, thr_sq, "pos"), 2, 20)
    print(f"[3 ransac_rank Hm=1024 x M={AKAZE_RANK_M}] plain {plain_m:.4f} ms  ({card})")
    del ops_m, planted, tiled, X_m

    # B4: the D=2 stacked raw raster of the bench scene (two views), with a
    # planted plateau of equal scores: bright squares on black, whose
    # corners and edges score exactly 255
    frame, second = bench_scene(np, K)
    opts = config.DetectorOptions(width=W, height=H, max_keypoints=KP,
                                  num_levels=LEVELS, fast_threshold=FAST_THRESHOLD)
    views = torch.from_numpy(np.stack([frame, second])).to(dev)
    levels = pyramid.build_pyramid_batch(views, LEVELS, opts.scale_factor)
    raster = patches.stack_levels_batch(levels).stacked.clone()
    raster[40:100, 40:400] = 0.0
    for y0 in range(44, 92, 12):
        for x0 in range(44, 392, 12):
            raster[y0:y0 + 5, x0:x0 + 5] = 255.0
    # squares of FAST_THRESHOLD on black: their corners' best arcs score
    # exactly the threshold, which the strict test zeroes
    raster[120:180, 40:400] = 0.0
    for y0 in range(124, 172, 12):
        for x0 in range(44, 392, 12):
            raster[y0:y0 + 5, x0:x0 + 5] = float(FAST_THRESHOLD)
    at_t = fast.fast_score_map(raster[120:180, 40:400], FAST_THRESHOLD - 0.5)
    check(bool((at_t == FAST_THRESHOLD).any()), "fast_nms: no pixel scores exactly the threshold")
    # a NaN on the ring of a true corner, (44, 44), off its compass points
    check(float(fast.fast_score_map(raster[36:60, 36:60], FAST_THRESHOLD)[8, 8]) == 255.0,
          "fast_nms: (44, 44) is no corner")
    raster[46, 46] = float("nan")

    def check_fast(tag, img, threshold):
        rk, nk = fast._fast_nms_cuda(img, threshold)
        rp, nmp = fast.fast_nms_plain(img, threshold)
        torch.cuda.synchronize()
        err = max(float((rk - rp).abs().max()), float((nk - nmp).abs().max()))
        check(torch.equal(rk, rp) and torch.equal(nk, nmp),
              f"fast_nms {tag} differs from its plain twin (max |diff| {err})")
        print(f"[3 fast_nms] {tag} {tuple(img.shape)}, threshold {threshold}: raw and nms "
              f"bit-equal; {int((rk > 0).sum())} corners, {int((nk > 0).sum())} kept")
        return rk, err

    def fast_pair(img):
        """This tree's B4 and, with --parent, the parent's on the same raster."""
        new = lambda: fast._fast_nms_cuda(img, FAST_THRESHOLD)  # noqa: E731
        if "fast_nms" not in parent:
            return new, None
        outs = [torch.empty_like(img) for _ in range(2)]
        launch = (img.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), *img.shape,
                  float(FAST_THRESHOLD), dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["fast_nms"](*launch) == 0, "the parent's fast_nms did not launch")
        return new, old

    rk, err = check_fast("D=2 raster, planted", raster, FAST_THRESHOLD)
    ties = int(((rk[:, 1:] == rk[:, :-1]) & (rk[:, 1:] == 255.0)).sum())
    check(ties > 0, "fast_nms: the planted plateau has no equal neighbours")
    check(float(rk[44, 44]) == 0.0, "fast_nms: a NaN on the ring did not zero the corner")
    check(not bool(rk[123:177, 43:397].any()), "fast_nms: a score at the threshold was kept")
    print(f"[3 fast_nms] {ties} equal neighbour pairs on the 255 plateau; the threshold "
          f"plateau and the NaN's corner zeroed")
    results["fast_nms"] = dict(
        max_abs_err=err,
        plain_ms=cuda_ms(lambda: fast.fast_nms_plain(raster, FAST_THRESHOLD)),
        **timed_pair("fast_nms D=2 4464x768", *fast_pair(raster), "fast_nms", card))
    # the D=1 raster of the full frame (4b), timed; cut to an odd width
    # (scalar loads, a partial last tile column); a negative threshold
    raster1 = patches.stack_levels_batch([lv[:1] for lv in levels]).stacked.contiguous()
    for tag, img, thr in (("D=1 raster", raster1, FAST_THRESHOLD),
                          ("D=1 raster, odd width", raster1[:, :747].contiguous(),
                           FAST_THRESHOLD),
                          ("D=1 raster", raster1[:300], -1.0)):
        _, err = check_fast(tag, img, thr)
        results["fast_nms"]["max_abs_err"] = max(results["fast_nms"]["max_abs_err"], err)
    timed_pair(f"fast_nms D=1 {tuple(raster1.shape)}", *fast_pair(raster1), "fast_nms", card,
               bound(raster1.numel() * 12, raster1.numel() * 180.0, FP32_FLOPS))

    # B5: the windows of the two views' detected keypoints, plus origins at
    # the raster's last rows and columns (and unaligned ones to round)
    fv = frontend.detect_and_describe_batch(views, opts)
    sps = patches.stack_levels_batch(
        [pyramid.box_blur(l, opts.smoothing_radius) for l in levels])
    lvl = fv.scale.reshape(-1).long()
    scale = torch.pow(torch.tensor(opts.scale_factor, device=dev), lvl.float())
    row0, col0 = patches.patch_origins(sps, fv.xy[..., 0].reshape(-1) / scale,
                                       fv.xy[..., 1].reshape(-1) / scale, lvl)
    row0 = row0 + (torch.arange(2, device=dev).repeat_interleave(KP)
                   * sps.img_rows).int()
    R_all, WP = sps.stacked.shape
    PH, PW = patches.PH, patches.PW
    row0 = torch.cat([row0, torch.tensor([R_all - PH, R_all - PH, 0, R_all - PH - 3,
                                          R_all], device=dev, dtype=torch.int32)])
    col0 = torch.cat([col0, torch.tensor([WP - PW, 0, WP - PW, WP - PW + 5, 1],
                                         device=dev, dtype=torch.int32)])
    pk = patches._extract_patches_cuda(sps.stacked, row0, col0)
    pp = patches.extract_patches_plain(sps.stacked, row0, col0)
    torch.cuda.synchronize()
    err = float((pk - pp).abs().max())
    check(torch.equal(pk, pp), f"extract differs from its plain twin (max |diff| {err})")
    print(f"[3 extract] {row0.numel()} windows of {tuple(sps.stacked.shape)}: bit-equal")
    results["extract"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: patches._extract_patches_cuda(sps.stacked, row0, col0)),
        device_ms=device_ms(lambda: patches._extract_patches_cuda(sps.stacked, row0, col0),
                            "extract_kernel"),
        plain_ms=cuda_ms(lambda: patches.extract_patches_plain(sps.stacked, row0, col0)))
    del rk, pk, pp

    # B1-B5 bounds at this run's shapes. Operation counts: B1 as the +-1
    # int8 product the TPU kernel runs (2 Q T 512); B2 ~1500 flops a sample;
    # B3 ~44 flops a (model, point) pair; B4 ~180 ops a pixel; B5 moves
    # bytes only. No single PyTorch call computes any of them.
    Q, T = feats.desc.shape[0], bank.desc.shape[0]
    results["k2nn"].update(bound(Q * 65 + T * 68 + 12 * Q, 2.0 * Q * T * 512, INT8_OPS))
    nb = Xs.shape[0]
    results["p3p"].update(bound(nb * 72 + nb * 4 * 52, nb * 1500.0, FP32_FLOPS))
    results["ransac_rank"].update(rank_bound(ops))
    results["fast_nms"].update(bound(raster.numel() * 12, raster.numel() * 180.0, FP32_FLOPS))
    results["extract"].update(bound(sps.stacked.numel() * 4 + row0.numel() * (PH * PW * 4 + 8),
                                    0.0, FP32_FLOPS))
    for name in FRAME_KERNELS:
        results[name]["library_ms"] = None

    # B6-B8: 256 five-point samples of two views of a random scene, the
    # second half on a plane (the twin-solution regime of
    # tests/test_robust.py); each kernel against its twin on the same card
    # inputs, bit for bit on every output (the kernels repeat the twins'
    # arithmetic with -fmad=false): NaN where the twin has NaN, equal
    # float32 bits elsewhere, B8's E of invalid seeds included. All three
    # also at the card test's B = 1, 37, 201, 1000, at B = 2048 (timed), and on
    # io/synthetic's planted edges, alone and after 37 ordinary samples,
    # B8 also with planted seed rows and an all-zero sample
    # (plant_polish_edges); with --parent, held to the parent's kernels
    # wherever the parent equals the twin
    NB = cfg.ransac.num_hypotheses
    srng = np.random.default_rng(SEED)

    def fivept_samples(n, rng):
        P = np.c_[rng.uniform(-3, 3, (n * 5, 2)), rng.uniform(5, 15, (n * 5, 1))]
        P = P.reshape(n, 5, 3)
        P[n // 2:, :, 2] = 8.0
        Pc = P - [0.3, 0.05, 0.0]
        return ((P[..., :2] / P[..., 2:]).astype(np.float32),
                (Pc[..., :2] / Pc[..., 2:]).astype(np.float32))

    def pack_xs(x1, x2):
        x1, x2 = torch.from_numpy(x1).to(dev), torch.from_numpy(x2).to(dev)
        return torch.cat([x1[:, :, 0], x1[:, :, 1], x2[:, :, 0], x2[:, :, 1]],
                         dim=1).T.contiguous()

    def same_bits(a, b):
        """NaN where b has NaN, the same float32 bits elsewhere (equal
        masks)."""
        if not b.is_floating_point():
            return torch.equal(a, b)
        nan = torch.isnan(b)
        return bool(torch.equal(torch.isnan(a), nan)
                    and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))

    def front_pair(xs_c):
        """This tree's B6 and, with --parent, the parent's on the same input."""
        new = lambda: fivept._front_cuda(xs_c)  # noqa: E731
        if "fivept_front" not in parent:
            return new, None
        B_c = xs_c.shape[1]
        outs = [torch.empty(shape + (B_c,), device=dev) for shape in ((36,), (40, 20),
                                                                      (40,), (11,))]
        launch = (xs_c.data_ptr(), *(o.data_ptr() for o in outs), B_c, dev.index,
                  dispatch.stream_handle(dev))

        def old():
            check(parent["fivept_front"](*launch) == 0, "the parent's fivept_front did not launch")
            return outs
        return new, old

    def dk_pair(c_, s_):
        """This tree's B7 and, with --parent, the parent's on the same input."""
        new = lambda: fivept._dk_cuda(c_, s_)  # noqa: E731
        if "fivept_dk" not in parent:
            return new, None
        outs = (torch.empty((10, c_.shape[1]), device=dev),
                torch.empty((10, c_.shape[1]), dtype=torch.bool, device=dev))
        launch = (c_.data_ptr(), s_.data_ptr(), *(o.data_ptr() for o in outs), c_.shape[1],
                  dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["fivept_dk"](*launch) == 0, "the parent's fivept_dk did not launch")
            return outs
        return new, old

    def polish_pair(pol_c):
        """This tree's B8 and, with --parent, the parent's on the same input."""
        new = lambda: fivept._polish_cuda(*pol_c)  # noqa: E731
        if "fivept_polish" not in parent:
            return new, None
        B_c = pol_c[0].shape[2]
        outs = (torch.empty((B_c, 30, 9), device=dev),
                torch.empty((B_c, 30), dtype=torch.bool, device=dev))
        launch = (*(t.data_ptr() for t in pol_c), *(o.data_ptr() for o in outs), B_c,
                  dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["fivept_polish"](*launch) == 0,
                  "the parent's fivept_polish did not launch")
            return outs
        return new, old

    def check_twin(name, tag, got, want, old):
        """got (this tree's outputs, one launch) against the twin's, and with
        --parent against the parent's wherever the parent equals the twin."""
        n_bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"{name} {tag} differs from its plain twin on {n_bad} entries (NaN counted)")
        note = ""
        if old is not None:
            ro = old()
            torch.cuda.synchronize()
            n_diff = sum(0 if same_bits(o, w) else 1 for o, w in zip(ro, want))
            if n_diff == 0:
                check(all(same_bits(g, o) for g, o in zip(got, ro)),
                      f"{name} {tag} differs from the parent's kernel")
            note = (f"; the parent's kernel {'equals' if n_diff == 0 else 'differs from'} "
                    f"the twin ({n_diff} outputs differ)")
        n_nan = sum(int(torch.isnan(w.float()).sum()) for w in want)
        print(f"[3 {name}] {tag}: bit-equal to the twin ({n_nan} NaN in the same places)"
              f"{note}")

    def check_front(tag, xs_c):
        before = dispatch.launch_counts()["fivept_front"]
        got = fivept.front(xs_c)
        want = fivept.front_plain(xs_c)
        torch.cuda.synchronize()
        check(dispatch.launch_counts()["fivept_front"] == before + 1,
              f"fivept_front {tag}: launches")
        check_twin("fivept_front", tag, got, want, front_pair(xs_c)[1])
        return want

    def check_dk(tag, npoly_c):
        c_, s_ = fivept.dk_normalise(npoly_c)
        before = dispatch.launch_counts()["fivept_dk"]
        got = fivept.dk_roots(c_, s_)
        want = fivept.dk_roots_plain(c_, s_)
        torch.cuda.synchronize()
        check(dispatch.launch_counts()["fivept_dk"] == before + 1, f"fivept_dk {tag}: launches")
        check_twin("fivept_dk", tag, got, (want[0], want[1]), dk_pair(c_, s_)[1])
        return c_, s_, want

    def polish_inputs(fr, dk):
        """B8's operands from the front's (basis, md, coef, npoly) and DK's
        (roots, is_real), split as five_point_batch splits them."""
        delta = 0.01 * (dk[0].abs() + 1.0)
        seeds = torch.cat([dk[0], dk[0] + delta, dk[0] - delta]).contiguous()
        return (fr[1], fr[2], fr[0], seeds, dk[1].repeat(3, 1).contiguous())

    def check_polish(tag, pol_c):
        before = dispatch.launch_counts()["fivept_polish"]
        got = fivept.polish(*pol_c)
        want = fivept.polish_plain(*pol_c)
        torch.cuda.synchronize()
        check(dispatch.launch_counts()["fivept_polish"] == before + 1,
              f"fivept_polish {tag}: launches")
        check_twin("fivept_polish", tag, got, want, polish_pair(pol_c)[1])
        return want

    def front_bound(B_c):
        """xs in, basis, md, coef and npoly out; ~10 kFLOP a sample."""
        return bound(B_c * (20 + 887) * 4, B_c * 1e4, FP32_FLOPS)

    def dk_bound(B_c):
        """coef and scale in, roots and is_real out; ~25 kFLOP a polynomial."""
        return bound(B_c * (12 * 4 + 10 * 5), B_c * 2.5e4, FP32_FLOPS)

    def polish_bound(B_c):
        """md, coef, basis, seeds, svalid in, Es and valid out; ~10 kFLOP a
        seed."""
        return bound(B_c * (906 * 4 + 30 + 30 * 37), B_c * 30 * 1e4, FP32_FLOPS)

    s1_np, s2_np = fivept_samples(NB, srng)
    s1, s2 = torch.from_numpy(s1_np).to(dev), torch.from_numpy(s2_np).to(dev)
    xs = pack_xs(s1_np, s2_np)
    fr_p = check_front(f"B={NB}", xs)
    c, sc_, dk_p = check_dk(f"B={NB}", fr_p[3])
    pol = polish_inputs(fr_p, dk_p)
    check_polish(f"B={NB}", pol)
    for B_t in (1, 37, 201, 1000, 2048):
        x1_t, x2_t = fivept_samples(B_t, np.random.default_rng(B_t))
        xs_t = pack_xs(x1_t, x2_t)
        fr_t = check_front(f"B={B_t}", xs_t)
        c_t, s_t, dk_t = check_dk(f"B={B_t}", fr_t[3])
        pol_t = polish_inputs(fr_t, dk_t)
        check_polish(f"B={B_t}", pol_t)
        if B_t == 2048:
            xs_2048, c_2048, s_2048, pol_2048 = xs_t, c_t, s_t, pol_t
    e1, e2 = synthetic.five_point_edge_samples()
    o1, o2 = fivept_samples(37, np.random.default_rng(37))
    fr_e = check_front("planted edges (repeated, collinear, all-zero, NaN points)",
                       pack_xs(e1, e2))
    check_polish("the front's planted edges",
                 polish_inputs(fr_e, check_dk("the front's planted edges", fr_e[3])[2]))
    fr_oe = check_front("37 samples + the planted edges",
                        pack_xs(np.concatenate([o1, e1]), np.concatenate([o2, e2])))
    edge_polys = torch.from_numpy(synthetic.dk_edge_polys()).to(dev)
    check_dk("planted edges (double root, lead 1e-14, inf, NaN)", edge_polys)
    dk_oe = check_dk("B=37 + the planted edges",
                     torch.cat([fr_oe[3][:, :37], edge_polys], dim=1))[2]
    pol_e = polish_inputs(fr_oe, dk_oe)
    check_polish("B=37 + the front's and DK's planted edges", pol_e)
    check_polish("the same, planted seed rows (NaN, +-inf, +-1e30) and an all-zero sample",
                 synthetic.plant_polish_edges(*(t.clone() for t in pol_e)))
    results["fivept_front"] = dict(
        max_abs_err=0.0, plain_ms=cuda_ms(lambda: fivept.front_plain(xs), 2, 10),
        library_ms=None, **timed_pair(f"fivept_front B={NB}", *front_pair(xs), "front_kernel",
                                      card, front_bound(NB)),
        **front_bound(NB))
    timed_pair("fivept_front B=2048", *front_pair(xs_2048), "front_kernel", card,
               front_bound(2048))
    # the library yardstick: the roots as eigenvalues of the companion
    # matrices, one torch.linalg.eigvals call
    comp = torch.zeros((NB, 10, 10), device=dev)
    comp[:, 1:, :-1] = torch.eye(9, device=dev)
    comp[:, :, -1] = -c[:10].T
    results["fivept_dk"] = dict(
        max_abs_err=0.0, plain_ms=cuda_ms(lambda: fivept.dk_roots_plain(c, sc_), 2, 10),
        library_ms=cuda_ms(lambda: torch.linalg.eigvals(comp), 2, 20),
        **timed_pair(f"fivept_dk B={NB}", *dk_pair(c, sc_), "dk_kernel", card, dk_bound(NB)),
        **dk_bound(NB))
    timed_pair("fivept_dk B=2048", *dk_pair(c_2048, s_2048), "dk_kernel", card, dk_bound(2048))
    results["fivept_polish"] = dict(
        max_abs_err=0.0, plain_ms=cuda_ms(lambda: fivept.polish_plain(*pol), 2, 10),
        library_ms=None, **timed_pair(f"fivept_polish B={NB}", *polish_pair(pol),
                                      "polish_kernel", card, polish_bound(NB)),
        **polish_bound(NB))
    timed_pair("fivept_polish B=2048", *polish_pair(pol_2048), "polish_kernel", card,
               polish_bound(2048))
    print(f"[3 fivept] five_point_batch B={NB} (front, normalise, dk, seeds, polish): "
          f"wrapper {fmt_ms(cuda_ms(lambda: fivept.five_point_batch(s1, s2), 3, 20))}  ({card})")
    valid_p = fivept.polish_plain(*pol)[1]
    print(f"[3 fivept] B={NB}: {int(dk_p[1].sum())} real roots, {int(valid_p.sum())} valid E "
          f"of {valid_p.numel()}")

    # B9: the 7680 candidates of those samples against 1024 correspondences
    # of two views of a random scene, a band of them invalid
    Es = fivept.five_point_batch(s1, s2)[0].reshape(-1, 3, 3)
    Mc = 1024
    Pw = np.c_[srng.uniform(-3, 3, (Mc, 2)), srng.uniform(4, 12, (Mc, 1))]
    Pw2 = Pw - [0.5, 0.1, 0.05]
    e1 = torch.from_numpy((Pw[:, :2] / Pw[:, 2:]).astype(np.float32)).to(dev)
    e2 = torch.from_numpy((Pw2[:, :2] / Pw2[:, 2:] + srng.normal(0, 2e-3, (Mc, 2)))
                          .astype(np.float32)).to(dev)
    e_valid = torch.ones(Mc, dtype=torch.bool, device=dev)
    e_valid[300:400] = False
    f_sq = float(K[0, 0]) ** 2
    eops = tuple(t.contiguous() for t in ransac_rank.epipolar_operands(
        Es, e1, e2, e_valid, f_sq, f_sq, cfg.ransac.essential_threshold ** 2))
    Hm = Es.shape[0]

    def epi_pair(ops_c, n_rungs=5):
        """This tree's B9 and, with --parent, the parent's on the same operands."""
        new = lambda: ransac_rank._epi_rank_cuda(*ops_c, 2, n_rungs)  # noqa: E731
        if "epi_rank" not in parent:
            return new, None
        out = torch.empty(ops_c[0].shape[0], device=dev)
        launch = (*(t.data_ptr() for t in ops_c), out.data_ptr(), ops_c[0].shape[0],
                  ops_c[1].shape[1], 3 - n_rungs, n_rungs, dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["epi_rank"](*launch) == 0, "the parent's epi_rank did not launch")
            return out
        return new, old

    def check_epi(tag, ops_c, n_rungs=5):
        """B9 against its twin, torch.equal, one launch; with --parent, the
        parent's ranks that differ from the twin's counted, and this tree's
        held to the parent's where there are none."""
        before = dispatch.launch_counts()["epi_rank"]
        rk = ransac_rank.epi_rank(*ops_c, 2, n_rungs)
        rp = ransac_rank.epi_rank_plain(*ops_c, 2, n_rungs)
        torch.cuda.synchronize()
        check(dispatch.launch_counts()["epi_rank"] == before + 1, f"epi_rank {tag}: launches")
        check(torch.equal(rk, rp), f"epi_rank {tag} n_rungs={n_rungs} differs from its plain "
              f"twin on {int((rk != rp).sum())} models (max |diff| {float((rk - rp).abs().max())})")
        _, old = epi_pair(ops_c, n_rungs)
        note = ""
        if old is not None:
            ro = old()
            torch.cuda.synchronize()
            n_diff = int((ro != rp).sum())
            if n_diff == 0:
                check(torch.equal(rk, ro), f"epi_rank {tag} differs from the parent's kernel")
            note = (f"; the parent's kernel differs from the twin on {n_diff} of "
                    f"{rp.numel()} ranks (max |diff| {float((ro - rp).abs().max())})")
        print(f"[3 epi_rank] {tag}, {n_rungs} rungs: equal to the twin (torch.equal), ranks "
              f"{float(rp.min()):.0f}-{float(rp.max()):.0f}{note}")

    check_epi(f"Hm={Hm} x M={Mc}", eops)
    # the card test's three shapes (tests/test_torch_kernels.py), built as
    # it builds them
    for Hm_t, M_t in ((1, 5), (1110, 300), (7680, 1024)):
        trng = np.random.default_rng(Hm_t + M_t)
        Es_t = torch.from_numpy(trng.normal(size=(Hm_t, 3, 3)).astype(np.float32))
        x1_t = torch.from_numpy(trng.uniform(-0.6, 0.6, (M_t, 2)).astype(np.float32))
        x2_t = x1_t + torch.from_numpy(trng.normal(0, 0.01, (M_t, 2)).astype(np.float32))
        v_t = torch.from_numpy(trng.random(M_t) > 0.2)
        check_epi(f"test shape Hm={Hm_t} x M={M_t}", [t.to(dev).contiguous() for t in
                  ransac_rank.epipolar_operands(Es_t, x1_t, x2_t, v_t, 451.2 ** 2,
                                                480.0 ** 2, 16.0)])
    # tests/rank_cases.py's planted epipolar inputs: compares exactly on a
    # rung, zero and clamped denominators, NaN data, a masked band, masks of
    # 1/2; Hm = 1 and off the CTA's model tile, M off the 4-point grid and
    # over two stages; 5 rungs and the generic loop
    for Hm_t, M_t, odd in ((1, 5, False), (33, 301, True), (1000, 1027, False),
                           (70, 2100, True)):
        planted_e = [torch.from_numpy(a).to(dev)
                     for a in cases.planted_epi_operands(Hm_t, M_t, odd_mask=odd)]
        for n_rungs in (5, 4):
            check_epi(f"planted Hm={Hm_t} x M={M_t}", planted_e, n_rungs)
    results["epi_rank"] = dict(
        max_abs_err=0.0, plain_ms=cuda_ms(lambda: ransac_rank.epi_rank_plain(*eops), 2, 20),
        library_ms=None, **timed_pair(f"epi_rank Hm={Hm} x M={Mc}", *epi_pair(eops),
                                      "epi_rank_kernel", card, epi_bound(eops)),
        **epi_bound(eops))
    del fr_p, pol, xs_2048, pol_2048, pol_t, pol_e

    # B10: the bench frame's four octaves (B=1), each octave's input the
    # last sublevel of the one before halved, as build_scale_space_batch
    # feeds them; then octave 0 of both views (B=2, two k^2). The kernel
    # repeats the twin's arithmetic in its order (-fmad=false): bit-equal
    # to the twin and, with --parent, to the parent's kernel. Bound: the
    # input and the 4 S output planes once; ~22 flops a pixel for the first
    # conductivity, ~21 an explicit step, ~58 a sublevel's Scharr passes
    # and response.
    images01 = diffusion._true_div(views, 255.0)
    k2_01 = diffusion.contrast_factor(images01) ** 2
    schedule = diffusion.octave_schedule(4, 4, 1.6, 0.25)
    L_o, k2_o = images01[:1].contiguous(), k2_01[:1].contiguous()
    fed_cases = []
    for o, (_, cycles, s4) in enumerate(schedule):
        fed_cases.append((f"octave {o}", L_o, k2_o, cycles, s4))
        L_o = diffusion.fed_octave_plain(L_o, k2_o, cycles, s4)[0][:, -1, ::2, ::2].contiguous()
    fed_cases.append(("octave 0, B=2", images01.contiguous(), k2_01.contiguous(),
                      *schedule[0][1:]))

    def fed_pair(L_c, k2_c, cycles, s4):
        """This tree's B10 and, with --parent, the parent's launch on the
        same inputs and the planes it writes."""
        new = lambda: diffusion._fed_octave_cuda(L_c, k2_c, cycles, s4)  # noqa: E731
        if "fed_octave" not in parent:
            return new, None, None
        nb, h, w = L_c.shape
        out = torch.empty((4, nb, len(cycles), h, w), device=dev)
        scr = torch.empty((3, nb, h, w), device=dev)
        plan = diffusion._plan(cycles, s4)
        launch = (L_c.data_ptr(), k2_c.data_ptr(), *(o.data_ptr() for o in out),
                  scr.data_ptr(), nb, h, w, len(cycles), *(ctypes.addressof(a) for a in plan),
                  dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["fed_octave"](*launch) == 0, "the parent's fed_octave did not launch")
        old.plan = plan    # the schedule's host arrays live as long as the launcher
        return new, old, out

    def check_fed(tag, L_c, k2_c, cycles, s4):
        """B10 against its twin, all four planes bit for bit."""
        out_k = diffusion._fed_octave_cuda(L_c, k2_c, cycles, s4)
        out_p = diffusion.fed_octave_plain(L_c, k2_c, cycles, s4)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
        check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
              f"fed_octave {tag} differs from its plain twin (max |diff| {err})")
        return out_k, err

    fed = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, device_ms=0.0,
               parent_ms=0.0, parent_device_ms=0.0)
    fed_bytes = fed_ops = 0.0
    for tag, L_c, k2_c, cycles, s4 in fed_cases:
        out_k, err = check_fed(tag, L_c, k2_c, cycles, s4)
        new, old, out_o = fed_pair(L_c, k2_c, cycles, s4)
        if old is not None:
            old()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out_k, out_o)),
                  f"fed_octave {tag} differs from the parent's kernel")
        px = L_c.numel()
        nbytes = px * 4 * (1 + 4 * len(cycles)) + 4 * L_c.shape[0]
        ops = px * (22.0 + sum(21.0 * len(taus) + 58.0 for taus in cycles))
        b = bound(nbytes, ops, FP32_FLOPS)
        print(f"[3 fed_octave] {tag} {tuple(L_c.shape)}, {sum(map(len, cycles))} steps: "
              f"bit-equal to the twin" + ("" if old is None else " and the parent's kernel"))
        t = timed_pair(f"fed_octave {tag}", new, old, "fed_octave_kernel", card, b)
        pms = cuda_ms(lambda: diffusion.fed_octave_plain(L_c, k2_c, cycles, s4), 2, 10)
        fed["max_abs_err"] = max(fed["max_abs_err"], err)
        if L_c.shape[0] == 1:        # a frame's four launches
            fed["plain_ms"] += pms
            for k in ("ms", "device_ms", "parent_ms", "parent_device_ms"):
                fed[k] = None if fed[k] is None or t[k] is None else fed[k] + t[k]
            fed_bytes += nbytes
            fed_ops += ops
    results["fed_octave"] = dict(fed, **bound(fed_bytes, fed_ops, FP32_FLOPS))
    print(f"[3 fed_octave] a frame's four octaves: wrapper {fmt_ms(fed['ms'])}, device "
          f"{fmt_ms(fed['device_ms'])}; parent wrapper {fmt_ms(fed['parent_ms'])}, device "
          f"{fmt_ms(fed['parent_device_ms'])}  ({card})")
    # edge shapes at B=2 with distinct k^2, on octave 0's and octave 3's
    # schedules: images smaller than the halo, one row or column, widths off
    # the tile grid, a frame one pixel larger than the bench's; and the
    # Plan's limits, 8 sublevels and 128 steps in cycles of 20 and 12 (each
    # cut into chunks between grid barriers)
    erng = np.random.default_rng(SEED + 10)
    k2_e = torch.tensor([0.01, 0.04], device=dev)
    long_plan = ((tuple(diffusion.fed_tau_cycle(30.0)),) * 4
                 + (tuple(diffusion.fed_tau_cycle(10.0)),) * 4,
                 tuple(float(i + 1) for i in range(8)))
    check(len(long_plan[0]) == 8 and sum(map(len, long_plan[0])) == 128,
          f"the long plan has {[len(c) for c in long_plan[0]]} steps")
    for h, w in ((1, 1), (1, 37), (37, 1), (9, 130), (37, 61), (481, 753)):
        L_e = torch.from_numpy(erng.uniform(0, 1, (2, h, w)).astype(np.float32)).to(dev)
        plans = [("octave 0", *schedule[0][1:]), ("octave 3", *schedule[3][1:])]
        if (h, w) in ((9, 130), (37, 61)):
            plans.append(("8 sublevels, 128 steps", *long_plan))
        for ptag, cycles, s4 in plans:
            _, err = check_fed(f"{h}x{w} {ptag}", L_e, k2_e, cycles, s4)
            fed["max_abs_err"] = max(fed["max_abs_err"], err)
    print("[3 fed_octave] edge shapes 1x1, 1x37, 37x1, 9x130, 37x61, 481x753 at B=2 on "
          "octave 0's and 3's schedules, and 8 sublevels of 128 steps: bit-equal")
    del out_k

    # B11: the AKAZE frame's two sampler calls at 5000 keypoints, their
    # inputs captured from the frontend's own calls (orientation: 2
    # channels, 48 rows; descriptor: 3 channels, 64 rows). A gather: exact,
    # and with --parent equal to the parent's kernel. Bound: bytes, the
    # outputs and coordinates once and each distinct raster element the
    # samples read.
    opts_a = config.DetectorOptions(width=W, height=H, max_keypoints=AKAZE_KP,
                                    num_levels=LEVELS, backend="akaze")
    sampler_calls = []
    real_sampler = patches.sample_raster_flat

    def capture(*args, **kw):
        sampler_calls.append((args, kw))
        return real_sampler(*args, **kw)

    patches.sample_raster_flat = capture
    try:
        frontend.detect_and_describe(views[0], opts_a)
    finally:
        patches.sample_raster_flat = real_sampler
    check(len(sampler_calls) == 2, f"the AKAZE frame made {len(sampler_calls)} sampler calls")

    def sample_pair(args):
        """This tree's B11 and, with --parent, the parent's launch on the
        same inputs and the output it writes."""
        new = lambda: patches._sample_raster_cuda(*args)  # noqa: E731
        if "sample_raster" not in parent:
            return new, None, None
        src2, stride, row0_s, col0_s, lx, ly, C, ph, pw = args
        out = torch.empty((C, *lx.shape), device=dev)
        launch = (src2.data_ptr(), row0_s.data_ptr(), col0_s.data_ptr(), lx.data_ptr(),
                  ly.data_ptr(), out.data_ptr(), *src2.shape, stride, *lx.shape, C, ph, pw,
                  dev.index, dispatch.stream_handle(dev))

        def old():
            check(parent["sample_raster"](*launch) == 0,
                  "the parent's sample_raster did not launch")
        return new, old, out

    def check_sample(tag, args):
        sk = patches._sample_raster_cuda(*args)
        sp = patches.sample_raster_plain(*args)
        torch.cuda.synchronize()
        err = float((sk - sp).abs().max()) if sk.numel() else 0.0
        check(torch.equal(sk, sp), f"sample_raster {tag} differs from its plain twin "
              f"(max |diff| {err})")
        return sk, err

    samp = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, device_ms=0.0,
                parent_ms=0.0, parent_device_ms=0.0)
    samp_bytes = 0.0
    for (src2, stride, row0_s, col0_s, lx, ly), kw in sampler_calls:
        C, ph, pw = kw["C"], kw.get("ph", patches.PH), kw["pw"]
        args = (src2, stride, row0_s, col0_s, lx, ly, C, ph, pw)
        tag = f"C={C}, NS={lx.shape[1]}"
        sk, err = check_sample(tag, args)
        new, old, out_o = sample_pair(args)
        if old is not None:
            old()
            torch.cuda.synchronize()
            check(torch.equal(sk, out_o), f"sample_raster {tag} differs from the parent's kernel")
        K_s, NS = lx.shape
        ci = torch.round(torch.clamp(lx, 0, pw - 1)).long()
        ri = torch.round(torch.clamp(ly, 0, ph - 1)).long()
        read = torch.cat([((r0[:, None] + ri) * src2.shape[1] + c0[:, None] + ci).reshape(-1)
                          for r0, c0 in (patches._sample_windows(src2, stride, row0_s, col0_s,
                                                                 c, ph, pw)
                                         for c in range(C))])
        nbytes = C * K_s * NS * 4 + 2 * K_s * NS * 4 + 2 * K_s * 4 + torch.unique(read).numel() * 2
        print(f"[3 sample_raster] {tag}, {ph}x{pw} windows, K={K_s}, src {tuple(src2.shape)} "
              f"bf16: exact" + ("" if old is None else ", equal to the parent's kernel"))
        t = timed_pair(f"sample_raster {tag}", new, old, "sample_raster_kernel", card,
                       bound(nbytes, 0.0, FP32_FLOPS))
        pms = cuda_ms(lambda: patches.sample_raster_plain(*args), 2, 20)
        samp["max_abs_err"] = max(samp["max_abs_err"], err)
        samp["plain_ms"] += pms
        for k in ("ms", "device_ms", "parent_ms", "parent_device_ms"):
            samp[k] = None if samp[k] is None or t[k] is None else samp[k] + t[k]
        samp_bytes += nbytes
    results["sample_raster"] = dict(samp, **bound(samp_bytes, 0.0, FP32_FLOPS))
    print(f"[3 sample_raster] a frame's two calls: wrapper {fmt_ms(samp['ms'])}, device "
          f"{fmt_ms(samp['device_ms'])}; parent wrapper {fmt_ms(samp['parent_ms'])}, device "
          f"{fmt_ms(samp['parent_device_ms'])}  ({card})")
    # edges: K=1, NS=1, both, NS off the 4-sample grid, and coordinate rows
    # not 16-byte aligned (a view at an odd offset), on the descriptor
    # call's raster with .5 ties and origins past the raster's end
    src2, stride = sampler_calls[1][0][:2]
    R_s, WP_s = src2.shape
    for K_e, NS_e, C_e, shift in ((1, 464, 3, 0), (77, 1, 2, 0), (1, 1, 3, 0), (5, 49, 3, 0),
                                  (9, 8, 2, 1)):
        lx_e = erng.uniform(-6, 133, K_e * NS_e + shift).astype(np.float32)
        ly_e = erng.uniform(-6, 69, K_e * NS_e + shift).astype(np.float32)
        lx_e[shift:shift + 2], ly_e[shift:shift + 2] = 2.5, 63.5
        lx_t = torch.from_numpy(lx_e).to(dev)[shift:].view(K_e, NS_e)
        ly_t = torch.from_numpy(ly_e).to(dev)[shift:].view(K_e, NS_e)
        row0_e = torch.from_numpy(erng.integers(0, R_s + 20, K_e).astype(np.int32)).to(dev)
        col0_e = torch.from_numpy(erng.integers(0, WP_s + 9, K_e).astype(np.int32)).to(dev)
        _, err = check_sample(f"K={K_e} NS={NS_e}", (src2, stride, row0_e, col0_e, lx_t, ly_t,
                                                    C_e, 64, 128))
        samp["max_abs_err"] = max(samp["max_abs_err"], err)
    print("[3 sample_raster] edges K=1, NS=1, both, NS=49 at K=5 and unaligned coordinate "
          "rows: exact")
    del sk, sampler_calls

    # B12: matching-shaped queries (each a bank row with ~40 bits flipped,
    # tests/test_hamming.py's construction) against a 262144-row bank, 5%
    # of its rows invalid, one best row duplicated in another group. Integer
    # keys: exact. Bound: operations counted as the TPU kernel's int8
    # product (2 Q T 128).
    trng = np.random.default_rng(SEED + 12)
    td = trng.integers(0, 2 ** 32, (TWOSTAGE_T, 16), dtype=np.uint64).astype(np.uint32)
    tv = trng.random(TWOSTAGE_T) > 0.05
    qd = trng.integers(0, 2 ** 32, (TWOSTAGE_Q, 16), dtype=np.uint64).astype(np.uint32)
    slots = trng.choice(np.flatnonzero(tv), TWOSTAGE_Q + 1, replace=False)
    flips = trng.integers(0, 512, (TWOSTAGE_Q, 40))
    planted = qd.copy()
    for j in range(flips.shape[1]):
        planted[np.arange(TWOSTAGE_Q), flips[:, j] // 32] ^= (
            np.uint32(1) << (flips[:, j] % 32).astype(np.uint32))
    td[slots[:TWOSTAGE_Q]] = planted
    td[slots[TWOSTAGE_Q]] = planted[0]
    t_desc_g = torch.from_numpy(td.view(np.int32)).to(dev)
    t_valid_g = torch.from_numpy(tv).to(dev)
    q_desc_g = torch.from_numpy(qd.view(np.int32)).to(dev)
    mapdb_g = MapDB(X=torch.zeros((TWOSTAGE_T, 3), device=dev), desc=t_desc_g,
                    valid=t_valid_g)
    ts_bank = pack_map_bank_twostage(mapdb_g)
    q_pf = hamming.prefilter_words(q_desc_g)

    def group_pair(qp, bk):
        """This tree's B12 and, with --parent, the parent's on the same bank."""
        new = lambda: hamming._group_top2_cuda(qp, bk)  # noqa: E731
        if "k2nn_group" not in parent:
            return new, None
        Qc, G_c = qp.shape[0], bk.pf.shape[0] // hamming._GROUP
        outs = [torch.empty((Qc, G_c), dtype=torch.int32, device=dev) for _ in range(2)]
        launch = (qp.data_ptr(), bk.pf.data_ptr(), bk.penrcol.data_ptr(),
                  *(o.data_ptr() for o in outs), Qc, bk.desc.shape[0], G_c, dev.index,
                  dispatch.stream_handle(dev))

        def old():
            check(parent["k2nn_group"](*launch) == 0, "the parent's k2nn_group did not launch")
            return outs
        return new, old

    def check_group(tag, qp, bk):
        """B12 against its twin, both outputs torch.equal, one launch; with
        --parent, against the parent's kernel too."""
        before = dispatch.launch_counts()["k2nn_group"]
        gk = hamming.group_top2(qp, bk)
        gp = hamming.group_top2_plain(qp, bk)
        torch.cuda.synchronize()
        check(dispatch.launch_counts()["k2nn_group"] == before + 1, f"k2nn_group {tag}: launches")
        err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
        check(all(torch.equal(a, b) for a, b in zip(gk, gp)),
              f"k2nn_group {tag} differs from its plain twin (max |diff| {err})")
        _, old = group_pair(qp, bk)
        if old is not None:
            go = old()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(gk, go)),
                  f"k2nn_group {tag} differs from the parent's kernel")
        print(f"[3 k2nn_group] {tag} ({bk.pf.shape[0] // hamming._GROUP} groups): equal to the "
              f"twin" + ("" if old is None else " and the parent's kernel"))
        return err

    def group_bound(Qc, bk):
        G_c = bk.pf.shape[0] // hamming._GROUP
        return bound(Qc * 16 + bk.pf.shape[0] * 20 + 2 * Qc * G_c * 4,
                     2.0 * Qc * bk.desc.shape[0] * 128, INT8_OPS)

    err = check_group(f"Q={TWOSTAGE_Q} x T={TWOSTAGE_T}", q_pf, ts_bank)
    results["k2nn_group"] = dict(
        max_abs_err=err, plain_ms=cuda_ms(lambda: hamming.group_top2_plain(q_pf, ts_bank), 2, 10),
        library_ms=None, **timed_pair(f"k2nn_group Q={TWOSTAGE_Q} x T={TWOSTAGE_T}",
                                      *group_pair(q_pf, ts_bank), "k2nn_group_kernel", card,
                                      group_bound(TWOSTAGE_Q, ts_bank)),
        **group_bound(TWOSTAGE_Q, ts_bank))
    # a bank with a partial last group (1696 of its 2048 rows), timed
    part_bank = hamming.pack_bank_twostage(t_desc_g[:TWOSTAGE_PARTIAL_T],
                                           t_valid_g[:TWOSTAGE_PARTIAL_T])
    check_group(f"Q={TWOSTAGE_Q} x T={TWOSTAGE_PARTIAL_T}", q_pf, part_bank)
    timed_pair(f"k2nn_group Q={TWOSTAGE_Q} x T={TWOSTAGE_PARTIAL_T}",
               *group_pair(q_pf, part_bank), "k2nn_group_kernel", card,
               group_bound(TWOSTAGE_Q, part_bank))
    # tests/rank_cases.py's edges: a last group of one real row, groups
    # with one and no valid rows, duplicates within and across groups,
    # all-zero and all-ones rows and queries, a query equal to a bank row;
    # Q below 16 and off the 128-query tile
    for Qc, Tc in ((5, 2049), (130, 6145), (3, 2), (40, 100), (1024, 6145)):
        qd_e, td_e, tv_e = cases.twostage_edge_case(Qc, Tc)
        bank_e = hamming.pack_bank_twostage(torch.from_numpy(td_e.view(np.int32)).to(dev),
                                            torch.from_numpy(tv_e).to(dev))
        check_group(f"edges Q={Qc} x T={Tc}", hamming.prefilter_words(
            torch.from_numpy(qd_e.view(np.int32)).to(dev)), bank_e)
    del part_bank

    lap("3p")
    # ---- phase 3p: the pose LM's kernels against their twins -------------
    phase_3p(torch, np, dev, card, results)
    for name, r in results.items():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        if "device_ms" in r:
            lib += f", device {fmt_ms(r['device_ms'])} (profiler)"
        print(f"[3 {name}] kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), max |err| "
              f"{r['max_abs_err']:.3e}  ({card})")

    lap("4")
    # ---- phase 4: the slice end to end ----------------------------------
    bank = pack_map_bank(mapdb)
    lat_ms = []
    dispatch.reset_launch_counts()
    for f in range(FRAMES):
        gen = torch.Generator(device=dev).manual_seed(1000 + f)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mm = match_with_map(feats, mapdb, cfg.matcher, bank=bank)
        pwc, inl = localize_image(feats, mm, mapdb, cam, cfg.ransac,
                                  cfg.refiner, generator=gen)
        end.record()
        torch.cuda.synchronize()
        lat_ms.append(start.elapsed_time(end))
        rot_err, c_err = pose_errors(torch, pwc.pose.R, pwc.pose.C)
        n = int(pwc.n_tracks)
        check(bool(pwc.success), f"frame {f}: localization failed")
        check(700 <= n <= 800, f"frame {f}: n_tracks {n} outside [700, 800]")
        check(rot_err < 1e-3, f"frame {f}: rotation error {rot_err:.3e} rad")
        check(c_err < 1e-2, f"frame {f}: center error {c_err:.3e} m")
        check(bool(torch.isfinite(pwc.cov).all()) and pwc.cov.shape == (6, 6),
              f"frame {f}: covariance not finite (6, 6)")
        check(not bool(inl[:n_out].any()), f"frame {f}: a moved landmark is an inlier")
    counts = {"4 slice": dispatch.launch_counts()}
    # frame 0 pays the one-time set-up of the ops it is first to run
    steady = np.asarray(lat_ms[1:])
    print(f"[4 slice] {FRAMES} frames ok; per-frame latency after frame 0: "
          f"{percentiles(np, steady)}; frame 0 {lat_ms[0]:.3f} ms  ({card})")

    # frame 0 again, on the card and through the plain CPU path, with the
    # same RANSAC draws: the two paths must agree
    draw = sample_indices(mm.mask & feats.valid, cfg.ransac.num_hypotheses, 3,
                          torch.Generator(device=dev).manual_seed(1000))
    mm_g = match_with_map(feats, mapdb, cfg.matcher, bank=bank)
    pg, _ = localize_image(feats, mm_g, mapdb, cam, cfg.ransac, cfg.refiner,
                           sample_idx=draw)
    cpu = torch.device("cpu")
    feats_c = convert.features_from_numpy(fa, cpu)
    mapdb_c = convert.mapdb_from_numpy(ma, cpu)
    mm_c = match_with_map(feats_c, mapdb_c, cfg.matcher)
    pc, _ = localize_image(feats_c, mm_c, mapdb_c,
                           convert.camera_from_numpy(K, device=cpu),
                           cfg.ransac, cfg.refiner, sample_idx=draw.cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(mm_g, mm_c)),
          "matches differ between the card and the CPU path")
    check(bool(pg.success) and bool(pc.success), "reference frame failed")
    check(abs(int(pg.n_tracks) - int(pc.n_tracks)) <= 1,
          f"n_tracks {int(pg.n_tracks)} on the card vs {int(pc.n_tracks)} on CPU")
    dR = float((pg.pose.R.cpu() - pc.pose.R).abs().max())
    dC = float((pg.pose.C.cpu() - pc.pose.C).abs().max())
    check(dR < 1e-4 and dC < 1e-4, f"pose card vs CPU: |dR| {dR:.2e}, |dC| {dC:.2e}")
    print(f"[4 reference] frame 0 card vs CPU plain path: n_tracks "
          f"{int(pg.n_tracks)} / {int(pc.n_tracks)}, |dR| {dR:.2e}, |dC| {dC:.2e}")

    lap("4b")
    # ---- phase 4b: the full-frame op, camera frame in, pose out ---------
    frame_t = torch.from_numpy(frame).to(dev)
    feats0 = frontend.detect_and_describe(frame_t, opts)
    f0 = convert.to_numpy(feats0)
    n_valid = int(f0.valid.sum())
    check(n_valid >= 1000, f"frame: {n_valid} valid keypoints < 1000")
    rng = np.random.default_rng(SEED)
    ma_f = synthetic.consistent_mapdb(f0, K, LANDMARKS, rng)
    X = ma_f.X.copy()
    X[:n_out] = rng.uniform(-50.0, 50.0, (n_out, 3)).astype(np.float32)
    mapdb_f = convert.mapdb_from_numpy(ma_f._replace(X=X), dev)
    bank_f = pack_map_bank(mapdb_f)

    def check_pose(tag, pwc, mm, inl, n_moved=n_out):
        rot_err, c_err = pose_errors(torch, pwc.pose.R, pwc.pose.C)
        check(bool(pwc.success), f"{tag}: localization failed")
        check(rot_err < 1e-3, f"{tag}: rotation error {rot_err:.3e} rad")
        check(c_err < 1e-2, f"{tag}: center error {c_err:.3e} m")
        check(not bool((inl & mm.mask & (mm.idx < n_moved)).any()),
              f"{tag}: a moved landmark is an inlier")

    def full_frame(f, mark=None):
        gen = torch.Generator(device=dev).manual_seed(2000 + f)
        if mark is None:
            feats = frontend.detect_and_describe(frame_t, opts)
        else:
            feats = Features(*(a[0] for a in frontend._detect_and_describe_trip_batch(
                frame_t[None], opts, mark)))
        mm = match_with_map(feats, mapdb_f, cfg.matcher, bank=bank_f)
        if mark is not None:
            mark("match")
        pwc, inl = localize_image(feats, mm, mapdb_f, cam, cfg.ransac,
                                  cfg.refiner, generator=gen)
        if mark is not None:
            mark("localize")
        return feats, mm, pwc, inl

    lat_ms, tracks = [], []
    dispatch.reset_launch_counts()
    for f in range(FULL_FRAMES + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        feats, mm, pwc, inl = full_frame(f)
        end.record()
        torch.cuda.synchronize()
        lat_ms.append(start.elapsed_time(end))
        check_pose(f"full frame {f}", pwc, mm, inl)
        check(int(feats.valid.sum()) >= 1000, f"full frame {f}: < 1000 keypoints")
        tracks.append(int(pwc.n_tracks))
        check(700 <= tracks[-1] <= 800,
              f"full frame {f}: n_tracks {tracks[-1]} outside [700, 800]")
    counts["4b frame"] = dispatch.launch_counts()
    per_frame = {k: v / (FULL_FRAMES + 1) for k, v in counts["4b frame"].items()}
    print(f"[4b frame] {FULL_FRAMES + 1} frames ok ({n_valid} keypoints, n_tracks "
          f"{min(tracks)}-{max(tracks)}); latency after frame 0: "
          f"{percentiles(np, lat_ms[1:])}; frame 0 {lat_ms[0]:.3f} ms  ({card})")
    print(f"[4b frame] kernel launches a frame: {per_frame}")

    print_stages(torch, np, "4b", lambda f, mark: full_frame(100 + f, mark), STAGED_FRAMES)
    profile_frames(torch, "4b", lambda f: full_frame(200 + f), PROFILED_FRAMES)

    # the same image through the port's plain CPU path
    fc = convert.to_numpy(frontend.detect_and_describe(torch.from_numpy(frame), opts))
    shared, bits = shared_features(np, f0, fc)
    print(f"[4b reference] card vs CPU plain path: {shared:.4f} of keypoints "
          f"shared, {bits:.4f} of descriptor bits equal on them")
    check(shared >= 0.98, f"card vs CPU: {shared:.4f} of keypoints shared < 0.98")
    check(bits >= 0.99, f"card vs CPU: {bits:.4f} of bits equal < 0.99")

    lap("4c")
    # ---- phase 4c: the session's frame step, 2 drones -------------------
    # the batched step (one frontend, one 2-NN, one P3P launch of D x 256
    # samples, one B3 launch, one LM over the drone axis), timed in turns
    # with the per-drone form: D calls of the same body at D = 1
    cfg_s = config.ColocConfig(num_drones=STEP_DRONES, detector=opts)
    imgs = torch.from_numpy(np.stack([frame] * STEP_DRONES)).to(dev)
    Ks = torch.from_numpy(np.stack([K] * STEP_DRONES)).to(dev)
    dists = torch.zeros((STEP_DRONES, 3), device=dev)
    fb = kalman.init(STEP_DRONES, cfg_s.filter, dev)
    fb_one = [kalman.FilterBank(*(t[d:d + 1].clone() for t in fb)) for d in range(STEP_DRONES)]
    accepted = torch.zeros(STEP_DRONES, dtype=torch.int32)
    step_ms, per_drone_ms, reads = [], [], []
    dispatch.reset_launch_counts()
    for s in range(STEPS + 1):
        gen = torch.Generator(device=dev).manual_seed(3000 + s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        (pwcs, fb, filt, gate, rej, eul, sup), n_reads = host_reads(
            torch, lambda: session.intra_all_device_step(cfg_s, imgs, mapdb_f, bank_f, Ks,
                                                         dists, fb, generator=gen))
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        reads.append(n_reads)
        for d in range(STEP_DRONES):
            rot_err, c_err = pose_errors(torch, pwcs.pose.R[d], pwcs.pose.C[d])
            check(bool(pwcs.success[d]), f"step {s} drone {d}: localization failed")
            check(rot_err < 1e-3 and c_err < 1e-2,
                  f"step {s} drone {d}: pose error {rot_err:.3e} rad, {c_err:.3e} m")
        check(bool(torch.isfinite(filt.R).all() & torch.isfinite(filt.C).all()),
              f"step {s}: filtered pose not finite")
        accepted += (pwcs.success & ~rej).int().cpu()
        check(torch.equal(fb.steps.cpu(), accepted),
              f"step {s}: filter steps {fb.steps.tolist()} != accepted {accepted.tolist()}")
        check(not bool(sup[:n_out].any()) and int(sup.sum()) > 0,
              f"step {s}: landmark support counts")
        if s == 0:
            counts["4c step"] = dispatch.launch_counts()
            per_step = counts["4c step"]
        # the per-drone form, in turn
        gen = torch.Generator(device=dev).manual_seed(3000 + s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for d in range(STEP_DRONES):
            out_d = session.intra_all_device_step(
                cfg_s, imgs[d:d + 1], mapdb_f, bank_f, Ks[d:d + 1], dists[d:d + 1],
                fb_one[d], generator=gen)
            fb_one[d] = out_d[1]
            check(bool(out_d[0].success[0]), f"step {s} drone {d} alone: localization failed")
        end.record()
        torch.cuda.synchronize()
        per_drone_ms.append(start.elapsed_time(end))
    print(f"[4c step] {STEPS + 1} steps of {STEP_DRONES} drones ok; filter steps "
          f"{fb.steps.tolist()}, filtered C {[round(v, 5) for v in filt.C.flatten().tolist()]}; "
          f"latency after step 0: {percentiles(np, step_ms[1:])}; step 0 "
          f"{step_ms[0]:.3f} ms  ({card})")
    print(f"[4c step] kernel launches a step: {per_step}; host reads a step "
          f"{min(reads)}-{max(reads)} (torch.cuda sync debug mode, the pose LM's exit "
          f"every {session.LM_CHECK_EVERY} iterations)")
    print(f"[4c step] per-drone form ({STEP_DRONES} calls of the D=1 body), in turns: "
          f"{percentiles(np, per_drone_ms[1:])}; batched / per-drone p50 "
          f"{np.percentile(step_ms[1:], 50) / np.percentile(per_drone_ms[1:], 50):.3f}")
    profile_frames(torch, "4c", lambda f: session.intra_all_device_step(
        cfg_s, imgs, mapdb_f, bank_f, Ks, dists, fb,
        generator=torch.Generator(device=dev).manual_seed(3100 + f)), 3)

    lap("4d")
    # ---- phase 4d: the session, two drones' frames in, poses out ---------
    scene = synthetic.make_scene(H, W, K, seed=SCENE_SEED)
    traj = [synthetic.trajectory(SESSION_FRAMES + 1, d) for d in range(2)]
    frames = render_frames(np, synthetic, scene, traj, SESSION_FRAMES + 1)
    first = {0: frames[0][0], 1: frames[1][0]}
    cfg_d = config.ColocConfig(num_drones=2, detector=opts)    # model E, 4096 landmarks
    Ks2, dists2 = np.stack([K, K]), np.zeros((2, 3), np.float32)

    def rot_err(R, R_ref):
        return rotation_error(torch, R, R_ref)

    def drive_session(tag, cfg_x):
        """A ColocSession on cuda:0 unasked: init_map on frame 0 of drones 0
        and 1, then SESSION_FRAMES frames of intra_pose_all, each checked
        against the ground truth. -> the session and its launch counts."""
        sess = session.ColocSession(cfg_x, Ks2, dists2, seed=SEED)  # cuda:0 untold
        check(sess.device == dev, f"ColocSession chose {sess.device}, not {dev}")
        dispatch.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ok = sess.init_map(first)
        end.record()
        torch.cuda.synchronize()
        init_ms = start.elapsed_time(end)
        check(ok and sess.map_ready, f"{tag}: init_map failed")
        n_lm = int(sess.mapdb.valid.sum())
        ba, geo = sess.bootstrap_ba, sess.bootstrap_geo
        check(n_lm >= 8, f"{tag}: init_map kept {n_lm} landmarks < 8")
        check(ba.cov.shape == (6, 6) and bool(torch.isfinite(ba.cov).all()),
              f"{tag}: drone 1's bootstrap covariance is not a finite 6x6")
        print(f"[{tag} init_map] {init_ms:.3f} ms; {int(geo.n_inliers)} E inliers, {n_lm} "
              f"landmarks, BA {int(ba.iterations)} LM iterations, rmse {float(ba.rmse):.4f} px, "
              f"launches {dispatch.launch_counts()}  ({card})")

        sess_ms, errs, centres = [], [], []
        accepted = torch.zeros(2, dtype=torch.int32)
        for f in range(1, SESSION_FRAMES + 1):
            sess.frame = f
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = sess.intra_pose_all({d: frames[d][f] for d in range(2)})
            end.record()
            torch.cuda.synchronize()
            sess_ms.append(start.elapsed_time(end))
            for d in range(2):
                check(bool(out[d].success),
                      f"{tag} frame {f} drone {d}: localization failed")
                R_gt = torch.from_numpy(traj[d][0][f] @ traj[0][0][0].T).to(dev)
                errs.append(rot_err(out[d].pose.R, R_gt))
            accepted += torch.stack([out[d].success for d in range(2)]).cpu().int() \
                * (~sess.last_rejected.cpu()).int()
            check(torch.equal(sess.filter_bank.steps.cpu(), accepted),
                  f"{tag} frame {f}: filter steps {sess.filter_bank.steps.tolist()} "
                  f"!= accepted {accepted.tolist()}")
            centres.append(out[0].pose.C.cpu())
        launches = dispatch.launch_counts()
        errs_deg = np.degrees(np.asarray(errs))
        check(np.median(errs_deg) < 1.0 and errs_deg.max() < 2.0,
              f"{tag} rotation error median {np.median(errs_deg):.3f}, max "
              f"{errs_deg.max():.3f} deg")
        check(float(centres[-1][0]) > float(centres[0][0]),
              f"{tag}: drone 0's estimated centre does not move along +x")
        print(f"[{tag} session] {SESSION_FRAMES} frames of 2 drones ok; rotation error "
              f"median {np.median(errs_deg):.4f}, max {errs_deg.max():.4f} deg; filter "
              f"steps {sess.filter_bank.steps.tolist()}; intra_pose_all "
              f"{percentiles(np, sess_ms[1:])}; frame 1 {sess_ms[0]:.3f} ms  ({card})")
        return sess, launches

    # capture the operands init_map hands B9, to time it at that shape
    epi_calls = []
    real_epi = ransac_rank.epi_rank

    def capture_epi(*args, **kw):
        epi_calls.append(args)
        return real_epi(*args, **kw)

    ransac_rank.epi_rank = capture_epi
    try:
        sess, counts["4d session"] = drive_session("4d", cfg_d)
    finally:
        ransac_rank.epi_rank = real_epi
    check(len(epi_calls) == 1, f"4d's init_map ranked {len(epi_calls)} times")
    # 4d's bootstrapped map, shared by 4n's peers
    import os
    import tempfile

    from coloc_tpu_torch import checkpoint

    fd, name = tempfile.mkstemp(prefix="coloc-4d-map-", suffix=".npz")
    os.close(fd)
    map_4d = Path(name)
    checkpoint.save_mapdb(str(map_4d), sess.mapdb)
    ops_4d = [t.contiguous() for t in epi_calls[0][:4]]
    rk = ransac_rank._epi_rank_cuda(*ops_4d, 2, 5)
    rp = ransac_rank.epi_rank_plain(*ops_4d)
    torch.cuda.synchronize()
    check(torch.equal(rk, rp), "epi_rank at 4d's shape differs from its plain twin")
    print(f"[4d epi_rank] init_map's B9 call: Hm={ops_4d[0].shape[0]} x M={ops_4d[1].shape[1]}, "
          f"{int((ops_4d[2] != 0).sum())} points unmasked; equal to the twin")
    timed_pair(f"epi_rank at 4d's Hm={ops_4d[0].shape[0]} x M={ops_4d[1].shape[1]}",
               *epi_pair(ops_4d), "epi_rank_kernel", card, epi_bound(ops_4d))
    del epi_calls, rk, rp

    # init_map on the card and through the plain CPU path, the same
    # five-point draws: both bootstrap nearly the same map
    m01 = match_pair(sess.detect(first[0]), sess.detect(first[1]), cfg_d.matcher)
    draws = sample_indices(m01.mask, NB, 5, torch.Generator(device=dev).manual_seed(SEED + 7))
    s_gpu = session.ColocSession(cfg_d, Ks2, dists2, device=dev)
    s_cpu = session.ColocSession(cfg_d, Ks2, dists2, device="cpu")
    ok_g = s_gpu.init_map(first, sample_idx=draws)
    ok_c = s_cpu.init_map(first, sample_idx=draws.cpu())
    check(ok_g and ok_c, f"reference init_map: card {ok_g}, CPU {ok_c}")
    vg, vc = s_gpu.mapdb.valid.cpu(), s_cpu.mapdb.valid
    shared = float((vg & vc).sum()) / float((vg | vc).sum())
    Rg, Rc = s_gpu.scene.Rs[1].cpu(), s_cpu.scene.Rs[1]
    Cg, Cc = s_gpu.scene.Cs[1].cpu().double(), s_cpu.scene.Cs[1].double()
    dR = rot_err(Rg.double(), Rc.double())
    dC = float(torch.arccos(torch.clamp(Cg @ Cc / (Cg.norm() * Cc.norm()), -1.0, 1.0)))
    print(f"[4d reference] init_map card vs CPU plain path: {int(vg.sum())} / "
          f"{int(vc.sum())} landmarks, {shared:.4f} of valid slots shared, drone 1 "
          f"rotation {dR:.2e} rad, baseline direction {dC:.2e} rad apart")
    check(shared >= 0.97, f"card vs CPU: {shared:.4f} of landmark slots shared < 0.97")
    check(dR < 1e-3 and dC < 5e-3, f"card vs CPU: drone 1 {dR:.2e} rad, baseline {dC:.2e} rad")

    # where the bootstrap's device time goes: init_map under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s_gpu.init_map(first, sample_idx=draws)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(torch, prof)
    busy_us = sum(us for _, us in kernels)
    if busy_us > 0:
        ours = sum(us for name, us in kernels
                   if any(k in name for k in ("front_kernel", "dk_kernel",
                                              "polish_kernel", "epi_rank_kernel")))
        each = {tag: sum(us for name, us in kernels if k in name)
                for tag, k in (("B6", "front_kernel"), ("B7", "dk_kernel"),
                               ("B8", "polish_kernel"), ("B9", "epi_rank_kernel"))}
        print(f"[4d profile] init_map: {len(kernels)} device kernels, device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
              f"({100.0 - 100.0 * busy_us / wall_us:.1f}% idle, profiler on); "
              f"B6-B9 {ours / 1e3:.4f} ms = {100.0 * ours / busy_us:.2f}% of device time ("
              + ", ".join(f"{tag} {us / 1e3:.4f}" for tag, us in each.items()) + " ms)")
    else:
        print("[4d profile] the profiler saw no device time: not measured")

    lap("4i")
    # ---- phase 4i: inter-drone fusion (interPoseEstimator) ----------------
    # 4h's trajectory: two chunks of CHUNK frames after the bootstrap frame
    n_h = CHUNK * CHUNKS + 1
    traj_h = [synthetic.trajectory(n_h, d) for d in range(2)]
    frames_h = render_frames(np, synthetic, scene, traj_h, n_h)
    phase_4i(torch, np, dev, card, cfg_d, Ks2, dists2, sess, frames, traj, frames_h, traj_h,
             counts)

    lap("4e")
    # ---- phase 4e: the AKAZE frame op (bench.py _bench_akaze) -----------
    from coloc_tpu_torch import akaze

    matcher_a = config.MatcherOptions(mode="ratio")
    fa_np = convert.to_numpy(frontend.detect_and_describe(frame_t, opts_a))
    n_valid_a = int(fa_np.valid.sum())
    check(n_valid_a >= 4900, f"AKAZE frame: {n_valid_a} valid keypoints < 4900")
    rng = np.random.default_rng(SEED)
    ma_a = synthetic.consistent_mapdb(fa_np, K, AKAZE_LANDMARKS, rng)
    n_out_a = int(OUTLIER_FRAC * AKAZE_KP)
    X = ma_a.X.copy()
    X[:n_out_a] = rng.uniform(-50.0, 50.0, (n_out_a, 3)).astype(np.float32)
    mapdb_a = convert.mapdb_from_numpy(ma_a._replace(X=X), dev)
    bank_a = pack_map_bank(mapdb_a)

    def akaze_frame(f, mark=None):
        gen = torch.Generator(device=dev).manual_seed(5000 + f)
        if mark is None:
            feats = frontend.detect_and_describe(frame_t, opts_a)
        else:
            feats = Features(*(a[0] for a in akaze.detect_and_describe_akaze_batch(
                frame_t[None], opts_a, mark)))
        mm = match_with_map(feats, mapdb_a, matcher_a, bank=bank_a)
        if mark is not None:
            mark("match")
        pwc, inl = localize_image(feats, mm, mapdb_a, cam, cfg.ransac, cfg.refiner,
                                  generator=gen)
        if mark is not None:
            mark("localize")
        return feats, mm, pwc, inl

    lat_ms, tracks = [], []
    dispatch.reset_launch_counts()
    for f in range(AKAZE_FRAMES + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        feats, mm, pwc, inl = akaze_frame(f)
        end.record()
        torch.cuda.synchronize()
        lat_ms.append(start.elapsed_time(end))
        check_pose(f"AKAZE frame {f}", pwc, mm, inl, n_out_a)
        check(int(feats.valid.sum()) >= 4900, f"AKAZE frame {f}: < 4900 keypoints")
        tracks.append(int(pwc.n_tracks))
    counts["4e akaze frame"] = dispatch.launch_counts()
    per_frame = {k: v / (AKAZE_FRAMES + 1) for k, v in counts["4e akaze frame"].items()}
    print(f"[4e akaze frame] {AKAZE_FRAMES + 1} frames ok ({n_valid_a} keypoints, "
          f"{int(mm.mask.sum())} matches, n_tracks {min(tracks)}-{max(tracks)}); latency "
          f"after frame 0: {percentiles(np, lat_ms[1:])}; frame 0 {lat_ms[0]:.3f} ms  ({card})")
    print(f"[4e akaze frame] kernel launches a frame: {per_frame}")
    print_stages(torch, np, "4e", lambda f, mark: akaze_frame(100 + f, mark), AKAZE_STAGED)
    profile_frames(torch, "4e", lambda f: akaze_frame(200 + f), AKAZE_PROFILED)

    # the same image through the port's plain CPU path
    fc = convert.to_numpy(frontend.detect_and_describe(torch.from_numpy(frame), opts_a))
    shared, bits = shared_features(np, fa_np, fc)
    print(f"[4e reference] card vs CPU plain path: {shared:.4f} of keypoints "
          f"shared, {bits:.4f} of descriptor bits equal on them")
    check(shared >= 0.98, f"AKAZE card vs CPU: {shared:.4f} of keypoints shared < 0.98")
    check(bits >= 0.99, f"AKAZE card vs CPU: {bits:.4f} of bits equal < 0.99")

    lap("4f")
    # ---- phase 4f: the AKAZE session (bench.py config_akaze) -------------
    cfg_a = config.ColocConfig(
        num_drones=2, matcher=matcher_a, max_landmarks=LANDMARKS,
        detector=config.DetectorOptions(width=W, height=H, max_keypoints=KP,
                                        num_levels=LEVELS, backend="akaze"))
    sess_a, counts["4f akaze session"] = drive_session("4f", cfg_a)

    lap("4g")
    # ---- phase 4g: the large-map matcher, two-stage against brute force ---
    # phase 3's bank (262144 rows, 5% invalid) and planted queries; the
    # accept decisions at the margin threshold must be brute force's
    feats_g = Features(
        xy=torch.zeros((TWOSTAGE_Q, 2), device=dev),
        score=torch.ones(TWOSTAGE_Q, device=dev),
        scale=torch.zeros(TWOSTAGE_Q, dtype=torch.int32, device=dev),
        angle=torch.zeros(TWOSTAGE_Q, device=dev), desc=q_desc_g,
        valid=torch.ones(TWOSTAGE_Q, dtype=torch.bool, device=dev))
    bf_bank = pack_map_bank(mapdb_g)
    mopts = config.MatcherOptions()
    dispatch.reset_launch_counts()
    ms_g = {"two-stage": [], "brute force": []}
    for i in range(TWOSTAGE_CALLS + 1):
        # alternate the order of the two ops from call to call
        for op in (("two-stage", "brute force") if i % 2 else ("brute force", "two-stage")):
            kw = {"twostage_bank": ts_bank} if op == "two-stage" else {"bank": bf_bank}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = match_with_map(feats_g, mapdb_g, mopts, **kw)
            end.record()
            torch.cuda.synchronize()
            if i > 0:
                ms_g[op].append(start.elapsed_time(end))
            if op == "two-stage":
                m_ts = m
            else:
                m_bf = m
    counts["4g large map"] = dispatch.launch_counts()
    n_acc = int(m_bf.mask.sum())
    check(torch.equal(m_ts.mask, m_bf.mask),
          f"two-stage accepts {int(m_ts.mask.sum())} queries, brute force {n_acc}, "
          f"{int((m_ts.mask != m_bf.mask).sum())} decisions differ")
    check(torch.equal(m_ts.idx[m_bf.mask], m_bf.idx[m_bf.mask])
          and torch.equal(m_ts.best[m_bf.mask], m_bf.best[m_bf.mask]),
          "two-stage best differs from brute force on an accepted query")
    planted_hit = float((m_bf.idx.cpu().numpy() == slots[:TWOSTAGE_Q]).mean())
    check(n_acc >= 0.9 * TWOSTAGE_Q and planted_hit >= 0.9,
          f"brute force accepts {n_acc}, finds {planted_hit:.3f} of the planted rows")
    p50 = {k: float(np.percentile(v, 50)) for k, v in ms_g.items()}
    print(f"[4g large map] Q={TWOSTAGE_Q} x T={TWOSTAGE_T}: accepted sets equal ({n_acc} "
          f"queries, {planted_hit:.4f} on their planted row); match_with_map two-stage "
          f"{percentiles(np, ms_g['two-stage'])}, brute force "
          f"{percentiles(np, ms_g['brute force'])} over {TWOSTAGE_CALLS} calls each; "
          f"brute force / two-stage {p50['brute force'] / p50['two-stage']:.2f}  ({card})")

    lap("4h")
    # ---- phase 4h: chunked stepping on CUDA graphs (run_chunked) ----------
    # the sync check first: the TRIP step must raise nothing under "error"
    check(not sync_check(torch, cfg_d, sess, imgs, "TRIP"),
          "the TRIP frame step synchronises with the host")
    sync_check(torch, cfg_d, sess, imgs, "TRIP, mode error", mode="error")
    check(not sync_check(torch, cfg_a, sess_a, imgs, "AKAZE"),
          "the AKAZE frame step synchronises with the host")
    sync_check(torch, cfg_a, sess_a, imgs, "AKAZE, mode error", mode="error")
    phase_4h(torch, np, dev, card, cfg_d, Ks2, dists2, frames_h, traj_h, counts)
    lap("4h akaze")
    phase_4h_akaze(torch, np, dev, card, cfg_a, sess_a, frames_h, traj_h, counts)

    lap("4j")
    # ---- phase 4j: the rest of the bootstrap: D = 4, models F and H,
    # update_map and the map-update schedule ----------------------------
    phase_4j(torch, np, dev, card, opts, K, scene, cfg_d, sess, frames, traj, frames_h, traj_h,
             counts)

    lap("4k")
    # ---- phase 4k: the map lifecycle: extend, merge, cull, run's schedule
    phase_4k(torch, np, dev, card, cfg_d, Ks2, dists2, frames_h, traj_h, counts)

    lap("4l")
    # ---- phase 4l: the session's plumbing: logs, checkpoints, profiler,
    # debug output and the live view, eager and on CUDA graphs
    phase_4l(torch, np, dev, card, cfg_d, Ks2, dists2, frames_h, counts)

    lap("4m")
    # ---- phase 4m: batched serving (ServingEngine) at bench.py's sizes
    serve_w = phase_4m(torch, np, dev, card, cfg, opts, K, scene, counts)

    lap("4n")
    # ---- phase 4n: the runtime over the topic bus: ServeRunner, two
    # DronePeers, the three entry points as subprocesses
    phase_4n(torch, np, dev, card, cfg, opts, K, scene, serve_w, cfg_d, map_4d, frames, traj,
             counts)

    lap("4o")
    # ---- phase 4o: the multi-device forms: ranks of parallel.mesh on the
    # card, the step, the scan, sharded serving and the sharded match
    phase_4o(torch, np, dev, card, cfg_d, Ks2, dists2, map_4d, frames, traj, serve_w, mapdb_g,
             q_desc_g, counts)
    map_4d.unlink(missing_ok=True)

    lap("5")
    # ---- phase 5: each path went through its kernels -------------------
    for phase, names in PATH_KERNELS.items():
        print(f"[5 counters] launches during phase {phase}: {counts[phase]}")
        for name in names:
            check(counts[phase][name] > 0,
                  f"kernel {name} was never launched in phase {phase}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": counts[LAUNCH_PHASE[name]][name],
         **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}
        for name in dispatch.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
