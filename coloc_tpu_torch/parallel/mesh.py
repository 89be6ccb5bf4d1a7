"""Drone-axis parallelism on torch.distributed (counterpart of
coloc_tpu.parallel.mesh).

Reference parity: the reference localizes its robots one after another in
one process (coloc.hpp:128-148) and exchanges descriptors, poses and
covariances over ROS topics (SURVEY.md §2.2). coloc_tpu makes the drone
axis an axis of a jax.sharding.Mesh: one controller traces a shard_map
program, each device runs its drone's step, and the exchange is a
ppermute or all_gather over ICI. The port runs one process a drone
instead, the PyTorch form of SPMD (torchrun, or `spawn` below): each rank
holds its drone's shard on its own device and a full copy of the map;
coloc_tpu's shard_map body is the function each rank calls on its (1, ...)
rows, and ppermute and all_gather are collectives on the mesh's process
groups. A host thread a rank also suits the port's eager paths, which are
launch-bound: one controller would serialise D host loops.

  make_mesh               this rank's place: axis names and sizes, its
                          coordinates, one process group per axis, its
                          device and the backend
  ring_shift, all_gather  the exchanges: ppermute to the ring successor
                          and all_gather, a pytree (a Features, a camera,
                          a pose) packed into ONE buffer per call
  shard_inputs, gather    global (D, ...) inputs to this rank's rows, the
                          map broadcast from rank 0; outputs back to
                          (D, ...)
  inter_pose_device       interPoseEstimator as one masked function, the
                          compute core of session.inter_pose,
                          distributed.DronePeer and the ring exchange
  sharded_inter_step, collaborative_step ("full" or "ici"),
  collaborative_step_scan, sharded_map_match
                          coloc_tpu's mesh programs, each a function that
                          every rank calls on its own shard
  spawn                   n ranks as fresh processes on this host

Devices and backend. `devices=None` puts local rank r on cuda:(r %
device_count) and raises where there is no CUDA device; the CPU is used
only when asked for ("cpu"). NCCL runs where every rank has a card of its
own, or at world size 1; gloo where ranks share a card (NCCL refuses two
ranks on one GPU) or on the CPU. make_mesh decides from the devices before
the first collective, prints the choice and never changes it. Under gloo
a CUDA tensor goes through the host explicitly: one device-to-host and
one host-to-device copy an exchange, counted by `staging_counts`.

Draws. coloc_tpu splits a drone's key into (k_loc, k_inter). Here each
rank draws from its own torch.Generator on its device, seeded
seed * 2**16 + rank (`rank_generator`): a frame's P3P samples first, then
the exchange's five-point samples. `sample_idx` (256, 3) and
`inter_sample_idx` (256, 5) inject them instead (how the tests replay
coloc_tpu's draws).
"""

from __future__ import annotations

import os
import socket
import sys
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.utils import _pytree as pytree

from coloc_tpu_torch import matching, robust, utils
from coloc_tpu_torch.config import ColocConfig, MatcherOptions
from coloc_tpu_torch.frontend import detect_and_describe
from coloc_tpu_torch.fusion import covint, kalman
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.ops import hamming
from coloc_tpu_torch.sfm import localize, reconstruct
from coloc_tpu_torch.types import Features, MapDB, Matches, Pose

DRONE_AXIS = "drone"
_ALIGN = 8   # bytes: each packed leaf starts at a multiple, so it views as any dtype


class Mesh(NamedTuple):
    """This rank's place in a mesh of processes: coloc_tpu's Mesh seen from
    one of its devices."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]     # axis -> size
    coords: Dict[str, int]    # axis -> this rank's index along it
    groups: Dict[str, object]  # axis -> the process group of this rank's line along it
    device: torch.device
    backend: str              # "nccl" or "gloo"
    rank: int
    size: int


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def _placement(devices, rank: int, world: int):
    """-> (this rank's device, the devices of the ranks on this host)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh runs on the card; pass devices='cpu' to run "
                "the plain PyTorch path")
        local = int(os.environ.get("LOCAL_RANK", rank))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        every = [torch.device("cuda", r % torch.cuda.device_count()) for r in range(n_local)]
        return every[local], every
    if isinstance(devices, (str, torch.device)):
        return _device(devices), [_device(devices)] * world
    every = [_device(d) for d in devices]
    if len(every) != world:
        raise ValueError(f"{len(every)} devices for a world of {world} ranks")
    return every[rank], every


def _choose_backend(every) -> Tuple[str, str]:
    """The backend for ranks on `every`, and why."""
    if any(d.type != "cuda" for d in every):
        return "gloo", "ranks on the CPU"
    if len(every) == 1:
        return "nccl", "one rank on the card"
    if len(set(every)) < len(every):
        return "gloo", ("ranks share a card, which NCCL refuses; CUDA tensors staged "
                        "through the host")
    return "nccl", "a card a rank"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(devices=None, axis_names: Tuple[str, ...] = (DRONE_AXIS,),
              shape=None) -> Mesh:
    """This rank's mesh. Called by every rank, in the same order.

    `devices`: None (cuda:(local rank % device_count), raising with no CUDA
    device), one device for every rank ("cpu", "cuda:0"), or one a rank.
    The backend follows from the devices (module docstring). `shape` lays the world out over
    `axis_names` row-major, as coloc_tpu's Mesh(devices.reshape(shape),
    axis_names) (default: one axis of every rank). Initialises the default
    process group if no one has, from torchrun's (or spawn's) environment,
    or as a world of one; then builds one group per line of each axis."""
    if tdist.is_initialized():
        rank, world = tdist.get_rank(), tdist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
    device, every = _placement(devices, rank, world)
    backend, why = _choose_backend(every)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not tdist.is_initialized():
        if "MASTER_ADDR" in os.environ:
            init = "env://"
        elif world == 1:
            init = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise RuntimeError("a world of several ranks needs MASTER_ADDR and MASTER_PORT "
                               "(torchrun, or parallel.mesh.spawn)")
        tdist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    shape = tuple(int(s) for s in (shape if shape is not None else (world,)))
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"shape {shape} over axes {axis_names} does not hold {world} ranks")
    grid = np.arange(world).reshape(shape)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    for k, name in enumerate(axis_names):
        # every rank creates every line's group, in one order
        for line in np.moveaxis(grid, k, -1).reshape(-1, shape[k]):
            group = tdist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                groups[name] = group
    if rank == 0:
        print(f"make_mesh: {world} rank(s), {dict(zip(axis_names, shape))}, backend "
              f"{backend} ({why}); rank 0 on {device}", flush=True)
    return Mesh(axis_names=tuple(axis_names), shape=dict(zip(axis_names, shape)),
                coords=coords, groups=groups, device=device, backend=backend, rank=rank,
                size=world)


def rank_generator(mesh: Mesh, seed: int = 0) -> torch.Generator:
    """This rank's generator: on its device, seeded seed * 2**16 + rank."""
    return torch.Generator(device=mesh.device).manual_seed(seed * 2 ** 16 + mesh.rank)


# ---------------------------------------------------------------- exchanges

_STAGING = {"exchanges": 0, "bytes": 0, "seconds": 0.0}


def staging_counts() -> dict:
    """This process's host-staged exchanges under gloo: their count, the
    bytes this rank sent and the seconds they took (copies and collective)."""
    return dict(_STAGING)


def reset_staging_counts() -> None:
    _STAGING.update(exchanges=0, bytes=0, seconds=0.0)


def _pack(leaves) -> torch.Tensor:
    """Tensors of one device -> one uint8 buffer, each leaf's bytes at a
    multiple of _ALIGN."""
    parts = []
    for t in leaves:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % _ALIGN:
            parts.append(b.new_zeros(-b.numel() % _ALIGN))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, leaves):
    """The leaves back out of buf (..., N), shaped and typed as `leaves`,
    with buf's leading axes in front."""
    lead, out, off = buf.shape[:-1], [], 0
    for t in leaves:
        nb = t.numel() * t.element_size()
        out.append(buf[..., off:off + nb].view(t.dtype).reshape(lead + t.shape))
        off += nb + (-nb % _ALIGN)
    return out


def _collective(buf: torch.Tensor, group, run):
    """run(wire) -> what the collective received. Under gloo a CUDA buffer
    is staged through the host: one copy down, one up, counted."""
    if not (buf.is_cuda and tdist.get_backend(group) == tdist.Backend.GLOO):
        return run(buf)
    t0 = time.perf_counter()
    out = run(buf.cpu()).to(buf.device)
    _STAGING["exchanges"] += 1
    _STAGING["bytes"] += buf.numel()
    _STAGING["seconds"] += time.perf_counter() - t0
    return out


def ring_shift(tree, group):
    """coloc_tpu's ppermute with perm [(i, (i + 1) % n)] over `group`: every
    rank sends `tree` (a pytree of tensors on its device, the same shapes
    on every rank) to its successor and returns its predecessor's. One
    packed buffer; the identity at n = 1 (a send to self is refused)."""
    n = tdist.get_world_size(group)
    if n == 1:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    me = tdist.get_rank(group)
    succ = tdist.get_global_rank(group, (me + 1) % n)
    pred = tdist.get_global_rank(group, (me - 1) % n)

    def shift(wire):
        out = torch.empty_like(wire)
        for req in tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, wire, succ, group),
                                            tdist.P2POp(tdist.irecv, out, pred, group)]):
            req.wait()
        return out

    recv = _collective(_pack(leaves), group, shift)
    return pytree.tree_unflatten(_unpack(recv, leaves), spec)


def all_gather(tree, group):
    """coloc_tpu's all_gather over `group`: each leaf (...) -> (n, ...), row
    i from the group's rank i. One packed buffer."""
    leaves, spec = pytree.tree_flatten(tree)
    n = tdist.get_world_size(group)

    def gather(wire):
        out = wire.new_empty((n, wire.numel()))
        tdist.all_gather(list(out.unbind(0)), wire, group=group)
        return out

    recv = _collective(_pack(leaves), group, gather)
    return pytree.tree_unflatten(_unpack(recv, leaves), spec)


def _broadcast(tree, group, src: int):
    leaves, spec = pytree.tree_flatten(tree)

    def bcast(wire):
        tdist.broadcast(wire, src, group=group)
        return wire

    recv = _collective(_pack(leaves), group, bcast)
    return pytree.tree_unflatten(_unpack(recv, leaves), spec)


def shard_inputs(mesh: Mesh, images, Ks, dists, fb: kalman.FilterBank, mapdb: MapDB):
    """Global (D, ...) inputs -> this rank's (1, ...) rows of images, Ks,
    dists and the filter bank on its device, and rank 0's map on every
    rank's device (coloc_tpu's device_put with a replicated sharding). The
    draws are each rank's own (rank_generator), not an input."""
    d = mesh.coords[DRONE_AXIS]

    def row(x):
        return torch.as_tensor(x)[d:d + 1].to(mesh.device)

    mapdb = MapDB(*(torch.as_tensor(t).to(mesh.device) for t in mapdb))
    return (row(images), row(Ks), row(dists), kalman.FilterBank(*(row(t) for t in fb)),
            _broadcast(mapdb, tdist.group.WORLD, 0))


def gather(mesh: Mesh, tree, axis: str = DRONE_AXIS, dim: int = 0):
    """Every rank's shards of `tree` along `axis`, concatenated on `dim`:
    the (D, ...) outputs coloc_tpu returns, on every rank of the axis."""
    return pytree.tree_map(lambda t: torch.cat(t.unbind(0), dim=dim),
                           all_gather(tree, mesh.groups[axis]))


def _check_no_jax(rank: int) -> None:
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {rank} has jax imported: the port's ranks run on torch alone")


def _rank_main(rank: int, fn, world: int, port: int, args) -> None:
    """A spawned rank: torchrun's environment, then fn(rank, *args)."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    # one host: gloo's and NCCL's bootstrap sockets on the loopback, whatever
    # the hostname resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        _check_no_jax(rank)
        fn(rank, *args)
        _check_no_jax(rank)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def spawn(fn, nprocs: int, args=()) -> None:
    """Run fn(rank, *args) in `nprocs` fresh processes (the "spawn" start
    method), a world of nprocs ranks on this host with torchrun's
    environment (MASTER_ADDR, a free MASTER_PORT, RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE), so that make_mesh() joins it. `fn` and
    `args` are pickled: fn lives at module level. Returns when every rank
    has; a rank that raises ends the others and raises here."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(fn, nprocs, _free_port(), tuple(args)),
                       nprocs=nprocs, join=True, start_method="spawn")


# ------------------------------------------ the inter-drone compute core

class InterDiag(NamedTuple):
    """Diagnostics of inter_pose_device for host-side logging (guided
    epipolar residuals, CSV rows)."""

    geo_R: torch.Tensor        # (3, 3) robust relative rotation (pre-refine)
    geo_t: torch.Tensor        # (3,) robust unit translation
    n_inliers: torch.Tensor    # () int32 geometric inliers
    n_common: torch.Tensor     # () int32 common landmarks map <-> temp
    rmse: torch.Tensor         # () refine reprojection RMSE
    omega: torch.Tensor        # () ICI weight
    trace: torch.Tensor        # () fused covariance trace
    obs_src: torch.Tensor      # (L, 2) temp src-view obs per map landmark
    obs_dst: torch.Tensor      # (L, 2) temp dst-view obs per map landmark
    guided_mask: torch.Tensor  # (L,) bool valid guided-residual entries
    cov_rel: torch.Tensor      # (3, 3) refine covariance CENTRE block, the
    #                            `cov` the reference adds to the source
    #                            covariance before ICI (coloc.hpp:366-367)


class InterPoseOut(NamedTuple):
    fused_pos: torch.Tensor    # (3,)
    fused_cov: torch.Tensor    # (3, 3)
    ok: torch.Tensor           # () bool
    rel: Pose                  # refined relative pose (dst in src frame)
    scale: torch.Tensor        # () monocular scale factor applied
    diag: InterDiag


def inter_pose_device(
    f_dst: Features,           # my (destination) frame features
    f_src: Features,           # partner (source) frame features
    cam_src: Camera,
    cam_dst: Camera,
    Ks_pair: torch.Tensor,     # (2, 3, 3) [src, dst]
    dists_pair: torch.Tensor,  # (2, 3)
    src_pose: Pose,            # partner's current (filtered) world pose
    src_cov3: torch.Tensor,    # (3, 3) partner's intra position covariance
    dst_pos: torch.Tensor,     # (3,) my current position estimate
    dst_cov3: torch.Tensor,    # (3, 3) my intra position covariance
    mapdb: MapDB,              # the shared map
    config: ColocConfig,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (B, 5)
    check_every: int = 1,
) -> InterPoseOut:
    """interPoseEstimator stage for stage (coloc.hpp:274-392), masked: no
    host branch decides what is computed.

      1. pairwise match src -> dst          (:287  computeMatchesPair)
      2. robust relative pose               (:296  filterMatchesPair)
      3. temp two-view scene, src-anchored  (:306  interReconstruct)
      4. map-to-map descriptor match        (:317-323 setupMapDatabase(1)
                                                   + matchMapFeatures)
      5. monocular scale alignment          (:331-336 computeScaleDifference
                                                   + rescaleMap)
      6. pose-only refine -> covariance     (:339-341 refinePose)
      7. compose src o rel, then ICI        (:351-389 CovIntersection)

    The reference's early returns become a mask: where the relative pose
    fails or fewer than 2 common landmarks exist, the outputs are the
    drone's own intra estimate. `generator` draws the five-point samples,
    or `sample_idx` injects them (coloc_tpu's `key`); the host reads the
    Gauss-Newton and LM exits every `check_every` iterations. B1 runs twice
    (frame against frame, map against temp map), B6-B9 once."""
    cfg = config
    dev = dst_pos.device
    # 1. pairwise putative match (query = src, train = dst)
    m = matching.match_pair(f_src, f_dst, cfg.matcher)

    # 2. robust relative pose src -> dst (geometric model E, F or H)
    geo = robust.relative_pose(
        cfg.model, f_src.xy, f_dst.xy[m.idx.long()], m.mask, cam_src, cam_dst,
        cfg.ransac, generator=generator, sample_idx=sample_idx, check_every=check_every)

    # 3. temporary two-view scene, src-anchored at unit scale
    origin = Pose(R=torch.eye(3, device=dev), C=torch.zeros(3, device=dev))
    temp = reconstruct.two_view_scene(
        f_src, f_dst, m, geo.inliers, geo.R, geo.t, origin, 1.0, cam_src, cam_dst,
        num_landmarks=cfg.max_landmarks)
    temp_db = reconstruct.scene_to_mapdb(temp)

    # 4. map-to-map descriptor match against the shared map
    mm = matching.match_maps(mapdb, temp_db, cfg.matcher)
    n_common = (mm.mask & mapdb.valid).sum(dtype=torch.int32)

    # 5. monocular scale alignment between the maps
    scale = utils.compute_scale_difference(mapdb, temp_db, mm)
    Xs, Cs = utils.rescale_map(temp.X, temp.Cs, scale)
    temp = temp._replace(X=Xs, Cs=Cs)

    # 6. pose-only refinement of the scaled relative pose -> 6x6 covariance;
    #    the structure is held (Structure NONE, coloc.hpp:339) and the src
    #    anchor view fixed, which with the structure held is the same
    #    problem up to gauge
    temp, ba_res = reconstruct.refine_scene(
        temp, Ks_pair, dists_pair, cfg.refiner,
        fix_pose=torch.tensor([True, False], device=dev), cov_view=1,
        optimize_structure=False, check_every=check_every)

    # 7. the fused candidate, ICI-fused with my intra estimate
    rel = Pose(R=temp.Rs[1], C=temp.Cs[1])
    cand_C = src_pose.C + src_pose.R.T @ rel.C
    eye = 1e-6 * torch.eye(3, device=dev)
    C_intra = dst_cov3 + eye
    C_cand = src_cov3 + ba_res.cov[3:6, 3:6] + eye
    fused = covint.fuse(C_intra, C_cand, dst_pos, cand_C)

    ok = geo.success & (n_common >= 2)
    idx = mm.idx.long()
    diag = InterDiag(
        geo_R=geo.R, geo_t=geo.t, n_inliers=geo.n_inliers, n_common=n_common,
        rmse=ba_res.rmse, omega=fused.omega, trace=fused.trace,
        obs_src=temp.obs[0][idx], obs_dst=temp.obs[1][idx],
        guided_mask=mm.mask & mapdb.valid & temp.X_valid[idx],
        cov_rel=ba_res.cov[3:6, 3:6])
    return InterPoseOut(
        fused_pos=torch.where(ok, fused.pos, dst_pos),
        fused_cov=torch.where(ok, fused.cov, C_intra),
        ok=ok, rel=rel, scale=scale, diag=diag)


# ------------------------------------------------------- the mesh programs

def _per_drone_step(image, K, dist, fb: kalman.FilterBank, mapdb: MapDB,
                    config: ColocConfig, generator=None, sample_idx=None):
    """One drone's frame step on its rank: detect -> map match (B4, B5,
    B1) -> P3P localization (B2, B3, pose LM) -> the Kalman update of its
    one-drone bank. image (H, W), K (3, 3), dist (3,), fb (1, ...) ->
    (fb', filtered pose, PoseWithCov, features)."""
    feats = detect_and_describe(image, config.detector)
    mm = matching.match_with_map(feats, mapdb, config.matcher)
    pwc, _ = localize.localize_image(feats, mm, mapdb, Camera(K=K, dist=dist), config.ransac,
                                     config.refiner, generator=generator,
                                     sample_idx=sample_idx)
    bank, filtered, _dist, _rej = kalman.update(
        fb, 0, kalman.fill_measurement(pwc.pose), pwc.cov[3:6, 3:6], pwc.rmse, pwc.success,
        config.filter)
    return bank, filtered, pwc, feats


def _inter_exchange_step(mesh: Mesh, feats: Features, K, dist, myR, myC, cov3,
                         mapdb: MapDB, config: ColocConfig, generator=None,
                         sample_idx=None) -> InterPoseOut:
    """The ring exchange and the full inter-drone step: drone d ships its
    frame bundle (features, camera, filtered pose, covariance; ~64 B a
    keypoint and a few hundred bytes of pose state, what the reference
    shipped over ROS) to (d + 1) % D in one ring_shift, then fuses with its
    predecessor's: inter_pose_device(src=(d - 1) % D, dst=d) (B1 twice,
    B6-B9)."""
    f_src, K_src, dist_src, src_R, src_C, src_cov3 = ring_shift(
        (feats, K, dist, myR, myC, cov3), mesh.groups[DRONE_AXIS])
    return inter_pose_device(
        feats, f_src, Camera(K=K_src, dist=dist_src), Camera(K=K, dist=dist),
        torch.stack([K_src, K]), torch.stack([dist_src, dist]), Pose(R=src_R, C=src_C),
        src_cov3, myC, cov3, mapdb, config, generator=generator, sample_idx=sample_idx)


def sharded_inter_step(mesh: Mesh, config: ColocConfig):
    """The inter-drone event alone, over each rank's precomputed state.

    Returns run(feats (1, K, ...), Ks (1, 3, 3), dists (1, 3), Rs (1, 3, 3),
    Cs (1, 3), cov3s (1, 3, 3), mapdb, generator=None, sample_idx=None)
      -> (fused_pos (1, 3), fused_cov (1, 3, 3), ok (1,), rel_R (1, 3, 3),
          rel_C (1, 3), scale (1,)),
    drone d fused (dst) with its ring predecessor (d - 1) % D (src): at D =
    2, drone 1's row is the reference's interPoseEstimator(0, 1)."""

    def run(feats: Features, Ks, dists, Rs, Cs, cov3s, mapdb: MapDB, generator=None,
            sample_idx=None):
        out = _inter_exchange_step(mesh, Features(*(t[0] for t in feats)), Ks[0], dists[0],
                                   Rs[0], Cs[0], cov3s[0], mapdb, config, generator,
                                   sample_idx)
        return (out.fused_pos[None], out.fused_cov[None], out.ok[None], out.rel.R[None],
                out.rel.C[None], out.scale[None])

    return run


def _position_cov(pwc) -> torch.Tensor:
    return pwc.cov[3:6, 3:6] + 1e-5 * torch.eye(3, device=pwc.cov.device)


def collaborative_step(mesh: Mesh, config: ColocConfig, inter: str = "full"):
    """The multi-drone step over `mesh`, each rank its drone.

    Returns run(images (1, H, W), Ks (1, 3, 3), dists (1, 3), fb (1, ...),
    mapdb, generator=None, sample_idx=None (256, 3),
    inter_sample_idx=None (256, 5))
      -> (fb', position (1, 3), cov (1, 3, 3), fused_pos (1, 3),
          fused_cov (1, 3, 3), inter_ok (1,)).

    `inter`: "full", the complete interPoseEstimator over the ring (one
    ring_shift of the frame bundle, then match, relative pose, temp scene,
    scale alignment, pose-only refine and ICI on each rank); "ici", an
    all_gather of positions and covariances and ICI with the ring
    predecessor only, a fallback for a narrow link."""
    if inter not in ("full", "ici"):
        raise ValueError(f"unknown inter mode {inter!r}")

    def run(images, Ks, dists, fb: kalman.FilterBank, mapdb: MapDB, generator=None,
            sample_idx=None, inter_sample_idx=None):
        bank, filtered, pwc, feats = _per_drone_step(images[0], Ks[0], dists[0], fb, mapdb,
                                                     config, generator, sample_idx)
        pos, cov = filtered.C, _position_cov(pwc)
        if inter == "full":
            out = _inter_exchange_step(mesh, feats, Ks[0], dists[0], filtered.R, pos, cov,
                                       mapdb, config, generator, inter_sample_idx)
            fused_pos, fused_cov, ok = out.fused_pos, out.fused_cov, out.ok
        else:
            all_pos, all_cov = all_gather((pos, cov), mesh.groups[DRONE_AXIS])
            other = (mesh.coords[DRONE_AXIS] - 1) % mesh.shape[DRONE_AXIS]
            fused = covint.fuse(cov, all_cov[other], pos, all_pos[other])
            fused_pos, fused_cov, ok = fused.pos, fused.cov, pwc.success
        return bank, pos[None], cov[None], fused_pos[None], fused_cov[None], ok[None]

    return run


def collaborative_step_scan(mesh: Mesh, config: ColocConfig):
    """F frames of the per-drone step (the filter bank carried on the
    device), then ONE full exchange on the last frame: the cadence of
    session.run_chunked, each rank its drone. The frames run eagerly, one
    after another (coloc_tpu's lax.scan).

    Returns run(images (F, 1, H, W), Ks (1, 3, 3), dists (1, 3), fb (1, ...),
    mapdb, generator=None, sample_idx=None (F, 256, 3),
    inter_sample_idx=None (256, 5))
      -> (fb', positions (F, 1, 3), covs (F, 1, 3, 3), success (F, 1),
          fused_pos (1, 3), fused_cov (1, 3, 3), inter_ok (1,))."""

    def run(images, Ks, dists, fb: kalman.FilterBank, mapdb: MapDB, generator=None,
            sample_idx=None, inter_sample_idx=None):
        pos, cov, ok = [], [], []
        for f in range(images.shape[0]):
            fb, filtered, pwc, feats = _per_drone_step(
                images[f, 0], Ks[0], dists[0], fb, mapdb, config, generator,
                None if sample_idx is None else sample_idx[f])
            pos.append(filtered.C)
            cov.append(_position_cov(pwc))
            ok.append(pwc.success)
        out = _inter_exchange_step(mesh, feats, Ks[0], dists[0], filtered.R, pos[-1], cov[-1],
                                   mapdb, config, generator, inter_sample_idx)
        return (fb, torch.stack(pos)[:, None], torch.stack(cov)[:, None],
                torch.stack(ok)[:, None], out.fused_pos[None], out.fused_cov[None],
                out.ok[None])

    return run


def shard_rows(n_rows: int, mesh: Mesh, axis: Optional[str]) -> Tuple[int, int, int]:
    """Rows [lo, hi) of n_rows that this rank holds along `axis` (all of
    them for None), and the shard size, ceil(n_rows / axis size): the last
    shards are padded to it."""
    if axis is None:
        return 0, n_rows, n_rows
    size = -(-n_rows // mesh.shape[axis])
    lo = mesh.coords[axis] * size
    return lo, max(lo, min(lo + size, n_rows)), size


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with zero rows appended to n rows (False for a mask: invalid)."""
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def sharded_map_match(mesh: Mesh, opts: MatcherOptions, axis: str = DRONE_AXIS,
                      query_axis: Optional[str] = None):
    """2-NN matching against a bank sharded over `axis` (SURVEY.md §5):
    each rank runs B1 over its shard, the (best, second, idx) of the shards
    are all-gathered over `axis` and merged by the kernel's own
    two-smallest rule: O(shards x queries) bytes, no descriptor moves.

    The default shards the bank over the 1-D drone axis with every query
    on every rank. On a ("drone", "map") mesh, axis="map" and
    query_axis="drone" shard the queries over the drone rows and the bank
    over the map columns; the merge runs over the map axis only.

    Returns run(q_desc (Q, 16), q_valid (Q,), map_desc (L, 16),
    map_valid (L,)), the global arrays on every rank -> Matches (global
    landmark indices, the accept rule of matching._accept) of this rank's
    queries, rows shard_rows(Q, mesh, query_axis)[:2]. L (and Q) need not
    divide: the last shards are padded with invalid rows, which cost 2048
    in B1 and so never win; padded queries are cut off."""

    def run(q_desc, q_valid, map_desc, map_valid) -> Matches:
        lo, hi, size = shard_rows(map_desc.shape[0], mesh, axis)
        qlo, qhi, qsize = shard_rows(q_desc.shape[0], mesh, query_axis)
        qv = _pad_rows(q_valid[qlo:qhi], qsize)
        idx, best, second = hamming.hamming_2nn(
            _pad_rows(q_desc[qlo:qhi], qsize), _pad_rows(map_desc[lo:hi], size), qv,
            _pad_rows(map_valid[lo:hi], size))
        all_best, all_second, all_idx = all_gather((best, second, idx + lo),
                                                   mesh.groups[axis])
        # the two smallest of the shards' pairs: the best of the bests, and
        # the least of the seconds and the other shards' bests
        d_best = torch.argmin(all_best, dim=0)
        g_best = all_best.gather(0, d_best[None])[0]
        g_idx = all_idx.gather(0, d_best[None])[0]
        others = torch.where(
            torch.arange(all_best.shape[0], device=d_best.device)[:, None] == d_best[None],
            hamming._INVALID_DIST, all_best)
        g_second = torch.minimum(all_second.min(dim=0).values, others.min(dim=0).values)
        n = qhi - qlo
        return matching._accept(g_idx[:n], g_best[:n], g_second[:n], qv[:n], opts,
                                opts.margin_threshold)

    return run
