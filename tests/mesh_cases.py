"""Cases and rank programs of the tests of the port's multi-device forms
(parallel/mesh, serving.make_sharded_serve_step). numpy, torch and the port
only: the ranks that parallel.mesh.spawn starts import this module and
must never import jax; the tests bring coloc_tpu where they compare.

The scene: tests/plumbing_cases.py's frame family (96x128, make_scene seed
2, f = 80 px), with a map whose first landmarks are the identity view's
features at the depth of the plane each bearing meets (so every nearby
view agrees with it), the rest random. Drone d sits at (0.03 + 0.3 d,
0.05 d, 0) and moves 2 cm along x a frame: both drones localize, and each
fuses with the other (inter_ok) on the CPU. No drone sits at the map's
own view, where every residual is float32 rounding and so is the
covariance it scales (tests/test_torch_step.py).

A rank program writes what it computed to `<out>/<name><rank>.npz`, each
pytree flattened to keys `<tag>/<i>`.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert, matching, serving
from coloc_tpu_torch.frontend import detect_and_describe
from coloc_tpu_torch.fusion import kalman
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.parallel import mesh
from coloc_tpu_torch.types import Features

H, W = 96, 128
K = np.array([[80.0, 0, 64], [0, 80.0, 48], [0, 0, 1]], np.float32)
KP, LANDMARKS, D, F = 128, 256, 2, 2
SEED = 3
NB = 256                         # RansacOptions().num_hypotheses


def config(mod=tcfg, num_drones: int = D):
    """The scene's configuration, from the port's config module or
    coloc_tpu's (the same fields)."""
    return mod.ColocConfig(
        num_drones=num_drones, max_landmarks=LANDMARKS,
        detector=mod.DetectorOptions(width=W, height=H, max_keypoints=KP, num_levels=2,
                                     fast_threshold=10))


def centre(d: int, f: int) -> np.ndarray:
    return np.array([0.03 + 0.3 * d + 0.02 * f, 0.05 * d, 0.0], np.float32)


@functools.lru_cache(maxsize=None)
def scene():
    return synthetic.make_scene(H, W, K, seed=2)


@functools.lru_cache(maxsize=None)
def images() -> np.ndarray:
    """(F, D, H, W) float32: drone d's frame f, rendered at centre(d, f)."""
    eye = np.eye(3, dtype=np.float32)
    return np.stack([np.stack([synthetic.render(scene(), eye, centre(d, f))
                               for d in range(D)]) for f in range(F)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def map_arrays() -> synthetic.MapDBArrays:
    """The map (reference layout): the identity view's features on their
    planes, then random landmarks."""
    eye = np.eye(3, dtype=np.float32)
    img = synthetic.render(scene(), eye, np.zeros(3, np.float32)).astype(np.float32)
    f0 = convert.to_numpy(detect_and_describe(torch.from_numpy(img), config().detector))
    ma = synthetic.consistent_mapdb(f0, K, LANDMARKS, np.random.default_rng(5))
    x, y = f0.xy[:, 0], f0.xy[:, 1]
    near = synthetic._bilinear(scene().alphas[0], np.clip(x, 0, W - 1.01),
                               np.clip(y, 0, H - 1.01)) > 0.5
    Z = np.where(near, scene().depths[0], scene().depths[1])
    X = ma.X.copy()
    X[:KP] = ((np.linalg.inv(K) @ np.c_[f0.xy, np.ones(KP)].T).T * Z[:, None])
    return ma._replace(X=X.astype(np.float32))


def cameras(n: int = D):
    return np.stack([K] * n), np.zeros((n, 3), np.float32)


def flat(tag: str, tree) -> dict:
    """{tag/i: ndarray} of a pytree of tensors, in flattening order."""
    leaves = _pytree.tree_leaves(tree)
    return {f"{tag}/{i}": t.detach().cpu().numpy() for i, t in enumerate(leaves)}


def leaves(npz, tag: str) -> list:
    """The arrays flat() wrote under `tag`, in order."""
    n = sum(1 for k in npz.files if k.startswith(tag + "/"))
    return [npz[f"{tag}/{i}"] for i in range(n)]


def _mesh(**kw) -> mesh.Mesh:
    return mesh.make_mesh("cpu", **kw)


def _inputs(m: mesh.Mesh, cfg, frame: int = 0):
    Ks, dists = cameras()
    return mesh.shard_inputs(m, images()[frame], Ks, dists, kalman.init(D, cfg.filter, "cpu"),
                             convert.mapdb_from_numpy(map_arrays(), "cpu"))


def port_programs(rank: int, out: str, draws: dict, state: dict) -> None:
    """tests/test_torch_mesh.py's ranks: the step "full" and "ici" with
    each rank's generator (rank_generator(m, SEED)); the step frame by
    frame and the scan with injected draws (draws["loc"] (F, D, 256, 3),
    draws["inter"] (F, D, 256, 5)); sharded_inter_step on `state`
    (features and pose state of every drone, numpy); ring_shift and
    all_gather of a packed Features with odd leaves; gather."""
    cfg = config()
    m = _mesh()
    d = m.coords[mesh.DRONE_AXIS]
    images_0, Ks, dists, fb, mapdb = _inputs(m, cfg)
    res = {}
    for mode in ("full", "ici"):
        run = mesh.collaborative_step(m, cfg, inter=mode)
        res.update(flat(mode, run(images_0, Ks, dists, fb, mapdb,
                                  generator=mesh.rank_generator(m, SEED))))
    loc = torch.from_numpy(draws["loc"][:, d])
    inter = torch.from_numpy(draws["inter"][:, d])
    step, fb_f = mesh.collaborative_step(m, cfg), fb
    for f in range(F):
        out_f = step(torch.from_numpy(images()[f, d:d + 1]), Ks, dists, fb_f, mapdb,
                     sample_idx=loc[f], inter_sample_idx=inter[f])
        fb_f = out_f[0]
        res.update(flat(f"step{f}", out_f))
    scan = mesh.collaborative_step_scan(m, cfg)
    res.update(flat("scan", scan(torch.from_numpy(images()[:, d:d + 1]), Ks, dists, fb, mapdb,
                                 sample_idx=loc, inter_sample_idx=inter[F - 1])))
    feats = convert.features_from_numpy(state["feats"][d], "cpu")
    row = {k: torch.from_numpy(state[k][d:d + 1]) for k in ("R", "C", "cov3")}
    run = mesh.sharded_inter_step(m, cfg)
    res.update(flat("inter", run(Features(*(t[None] for t in feats)), Ks, dists, row["R"],
                                 row["C"], row["cov3"], mapdb,
                                 sample_idx=torch.from_numpy(state["draws"][d]))))
    # one packed exchange of a Features plus leaves of other sizes and dtypes
    odd = (feats, torch.tensor(d, dtype=torch.int32), torch.tensor([True, d == 1, False]),
           torch.full((3,), float(d), dtype=torch.float64))
    group = m.groups[mesh.DRONE_AXIS]
    res.update(flat("ring", mesh.ring_shift(odd, group)))
    res.update(flat("all", mesh.all_gather(odd, group)))
    res.update(flat("gather", mesh.gather(m, (feats.xy[None], feats.desc[None]))))
    np.savez(Path(out) / f"port{rank}.npz", **res)


def world_of_one(rank: int, out: str) -> None:
    """A world of one rank: ring_shift is the identity (the same object),
    all_gather adds an axis of 1, and the step runs with itself as its ring
    partner."""
    cfg = config(num_drones=1)
    m = _mesh()
    feats = convert.features_from_numpy(synthetic.random_features(H, W, 16,
                                                                  np.random.default_rng(1)),
                                        "cpu")
    group = m.groups[mesh.DRONE_AXIS]
    res = {"same": np.array(mesh.ring_shift(feats, group) is feats)}
    res.update(flat("all", mesh.all_gather(feats, group)))
    res.update(flat("feats", feats))
    Ks, dists = cameras(1)
    args = mesh.shard_inputs(m, images()[0, :1], Ks, dists, kalman.init(1, cfg.filter, "cpu"),
                             convert.mapdb_from_numpy(map_arrays(), "cpu"))
    out1 = mesh.collaborative_step(m, cfg)(*args, generator=mesh.rank_generator(m, SEED))
    res.update(flat("step", out1))
    np.savez(Path(out) / f"one{rank}.npz", **res)


def _matches(run, case) -> dict:
    return flat("m", run(*(torch.from_numpy(case[k]) for k in ("qd", "qv", "td", "tv"))))


def reference_step(rank: int, out: str, draws: dict) -> None:
    """tests/test_torch_mesh_reference.py's 2 ranks: the step "full" with
    coloc_tpu's draws injected (draws["loc"] (D, 256, 3), draws["inter"]
    (D, 256, 5))."""
    cfg = config()
    m = _mesh()
    d = m.coords[mesh.DRONE_AXIS]
    res = flat("step", mesh.collaborative_step(m, cfg)(
        *_inputs(m, cfg), sample_idx=torch.from_numpy(draws["loc"][d]),
        inter_sample_idx=torch.from_numpy(draws["inter"][d])))
    np.savez(Path(out) / f"step{rank}.npz", **res)


def sharded_programs(rank: int, out: str, match_cases: list, serve: dict) -> None:
    """tests/test_torch_mesh_sharded.py's 2 ranks: sharded_map_match on the
    1-D mesh (each case of match_cases: qd, qv, td, tv; descriptors as
    int32) and sharded serving with each shard's draws (serve: feats,
    map, Ks, draws)."""
    m = _mesh()
    run = mesh.sharded_map_match(m, config().matcher)
    res = {}
    for i, case in enumerate(match_cases):
        res.update({f"match{i}/{k}": v for k, v in _matches(run, case).items()})
    # the rank is handed its own streams only
    mapdb = convert.mapdb_from_numpy(serve["map"], "cpu")
    lo, hi, _ = mesh.shard_rows(len(serve["Ks"]), m, mesh.DRONE_AXIS)
    cams = Camera(K=torch.from_numpy(serve["Ks"][lo:hi]), dist=torch.zeros(hi - lo, 3))
    feats = convert.features_from_numpy(serve["feats"], "cpu")
    res.update(flat("serve", serving.make_sharded_serve_step(m, tcfg.ColocConfig())(
        Features(*(t[lo:hi] for t in feats)), cams, mapdb, matching.pack_map_bank(mapdb),
        sample_idx=torch.from_numpy(serve["draws"][lo:hi]))))
    np.savez(Path(out) / f"sharded{rank}.npz", **res)


def sharded_programs_2d(rank: int, out: str, match_cases: list) -> None:
    """The 2 x 2 ("drone", "map") mesh's ranks: sharded_map_match with the
    queries over the drone rows and the bank over the map columns."""
    m = _mesh(axis_names=("drone", "map"), shape=(2, 2))
    run = mesh.sharded_map_match(m, config().matcher, axis="map", query_axis="drone")
    res = {}
    for i, case in enumerate(match_cases):
        res.update({f"match{i}/{k}": v for k, v in _matches(run, case).items()})
    np.savez(Path(out) / f"sharded2d{rank}.npz", **res)
