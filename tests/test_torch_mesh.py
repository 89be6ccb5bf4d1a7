"""The port's multi-device forms against its own single-process functions
(parallel/mesh): two gloo CPU ranks run the collaborative step ("full"
and "ici"), the step frame by frame and the scan, sharded_inter_step and
the exchanges; a world of one rank runs the exchanges and the step. Each
rank's outputs must equal, bit for bit on the CPU, the composition of the
one-process functions with the same draws: per drone detect ->
match_with_map -> localize_image -> kalman.update, then
inter_pose_device(src=(d - 1) % D, dst=d).

The ranks (tests/mesh_cases.py, no jax) are spawned once for the file, in
a module fixture, with one torch thread each; so is this process's
composition (bit equality needs the same reduction order).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from coloc_tpu_torch import convert
from coloc_tpu_torch.frontend import detect_and_describe
from coloc_tpu_torch.fusion import covint, kalman
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.matching import match_pair, match_with_map
from coloc_tpu_torch.parallel import mesh
from coloc_tpu_torch.ransac import sample_indices
from coloc_tpu_torch.sfm.localize import localize_image
from coloc_tpu_torch.types import Pose

import mesh_cases as mc
from port_harness import one_torch_thread, time_limit  # noqa: F401

D, F, NB = mc.D, mc.F, mc.NB


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The draws injected into the frame-by-frame step and the scan (from
    this process's matches), the state sharded_inter_step fuses, and what
    the two ranks and the world of one wrote."""
    cfg = mc.config()
    mapdb = convert.mapdb_from_numpy(mc.map_arrays(), "cpu")
    imgs = mc.images()
    feats = [[detect_and_describe(torch.from_numpy(imgs[f, d]), cfg.detector)
              for d in range(D)] for f in range(F)]
    corr = torch.stack([torch.stack([match_with_map(fe, mapdb, cfg.matcher).mask & fe.valid
                                     for fe in row]) for row in feats])
    pair = torch.stack([torch.stack([match_pair(row[(d - 1) % D], row[d], cfg.matcher).mask
                                     for d in range(D)]) for row in feats])
    g = torch.Generator().manual_seed(7)
    draws = {"loc": sample_indices(corr, NB, 3, g).numpy(),
             "inter": sample_indices(pair, NB, 5, g).numpy()}
    state = {"feats": [convert.to_numpy(feats[0][d]) for d in range(D)],
             "R": np.stack([np.eye(3, dtype=np.float32)] * D),
             "C": np.stack([mc.centre(d, 0) for d in range(D)]),
             "cov3": np.stack([np.diag([1e-3, 2e-3, 3e-3]).astype(np.float32) * (d + 1)
                               for d in range(D)]),
             "draws": draws["inter"][0]}
    out = tmp_path_factory.mktemp("mesh")
    mesh.spawn(mc.port_programs, D, (str(out), draws, state))
    mesh.spawn(mc.world_of_one, 1, (str(out),))
    return SimpleNamespace(cfg=cfg, mapdb=mapdb, feats=feats, draws=draws, state=state,
                           ranks=[np.load(out / f"port{d}.npz") for d in range(D)],
                           one=np.load(out / "one0.npz"))


def _cam():
    return Camera(K=torch.from_numpy(mc.K), dist=torch.zeros(3))


def _drones(r, gens):
    """The per-drone half by hand: (bank, filtered, pwc, feats) of each
    drone on frame 0, its P3P samples from gens[d]."""
    bank, out = kalman.init(D, r.cfg.filter, "cpu"), []
    for d in range(D):
        feats = detect_and_describe(torch.from_numpy(mc.images()[0, d]), r.cfg.detector)
        mm = match_with_map(feats, r.mapdb, r.cfg.matcher)
        pwc, _ = localize_image(feats, mm, r.mapdb, _cam(), r.cfg.ransac, r.cfg.refiner,
                                generator=gens[d])
        bank, filt, _, _ = kalman.update(bank, d, kalman.fill_measurement(pwc.pose),
                                         pwc.cov[3:6, 3:6], pwc.rmse, pwc.success,
                                         r.cfg.filter)
        out.append((filt, pwc, feats))
    return bank, out


def _cov(pwc):
    return pwc.cov[3:6, 3:6] + 1e-5 * torch.eye(3)


def _equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape and np.array_equal(a, b), f"{what}, leaf {i}"


def _gens():
    return [torch.Generator().manual_seed(mc.SEED * 2 ** 16 + d) for d in range(D)]


def test_full_step_equals_composition(runs):
    """inter="full": the filter bank row, position, covariance, fused
    position and covariance and inter_ok of each rank equal the
    composition's, each rank's generator seeded SEED * 2**16 + rank and
    drawing the P3P samples, then the five-point ones."""
    gens = _gens()
    bank, drones = _drones(runs, gens)
    for d in range(D):
        src = (d - 1) % D
        (filt, pwc, feats), (filt_s, pwc_s, feats_s) = drones[d], drones[src]
        assert bool(pwc.success)
        out = mesh.inter_pose_device(
            feats, feats_s, _cam(), _cam(), torch.from_numpy(np.stack([mc.K] * 2)),
            torch.zeros(2, 3), Pose(R=filt_s.R, C=filt_s.C), _cov(pwc_s), filt.C, _cov(pwc),
            runs.mapdb, runs.cfg, generator=gens[d])
        assert bool(out.ok)
        want = [t[d:d + 1] for t in bank] + [filt.C[None], _cov(pwc)[None],
                                             out.fused_pos[None], out.fused_cov[None],
                                             out.ok[None]]
        _equal(mc.leaves(runs.ranks[d], "full"), want, f"rank {d}")


def test_ici_step_equals_composition(runs):
    """inter="ici": each rank fuses with its ring predecessor's gathered
    position and covariance; ok is its own localization's success."""
    bank, drones = _drones(runs, _gens())
    for d in range(D):
        src = (d - 1) % D
        (filt, pwc, _), (filt_s, pwc_s, _) = drones[d], drones[src]
        fused = covint.fuse(_cov(pwc), _cov(pwc_s), filt.C, filt_s.C)
        want = [t[d:d + 1] for t in bank] + [filt.C[None], _cov(pwc)[None], fused.pos[None],
                                             fused.cov[None], pwc.success[None]]
        _equal(mc.leaves(runs.ranks[d], "ici"), want, f"rank {d}")
    # the fallback moved each drone towards its partner
    full = mc.leaves(runs.ranks[1], "ici")
    assert not np.array_equal(full[5], full[3])


def test_scan_equals_step_frame_by_frame(runs):
    """The scan over F frames with the frames' draws: its filter bank, its
    positions and covariances frame by frame equal the step run frame by
    frame with the same draws; its exchange equals the last frame's."""
    for d in range(D):
        scan = mc.leaves(runs.ranks[d], "scan")
        steps = [mc.leaves(runs.ranks[d], f"step{f}") for f in range(F)]
        _equal(scan[:3], steps[-1][:3], f"rank {d} filter bank")
        for f in range(F):
            _equal([scan[3][f], scan[4][f]], steps[f][3:5], f"rank {d} frame {f}")
        assert scan[5].shape == (F, 1) and scan[5].all()
        _equal(scan[6:], steps[-1][5:], f"rank {d} exchange")
        np.testing.assert_array_equal(scan[2], [F])


def test_sharded_inter_step_equals_core_on_each_ring_pair(runs):
    """sharded_inter_step on given state: each rank's (fused_pos,
    fused_cov, ok, rel R, rel C, scale) equal inter_pose_device(src=(d - 1)
    % D, dst=d) with the same draws."""
    s = runs.state
    for d in range(D):
        src = (d - 1) % D
        t = {k: torch.from_numpy(s[k]) for k in ("R", "C", "cov3")}
        out = mesh.inter_pose_device(
            convert.features_from_numpy(s["feats"][d], "cpu"),
            convert.features_from_numpy(s["feats"][src], "cpu"), _cam(), _cam(),
            torch.from_numpy(np.stack([mc.K] * 2)), torch.zeros(2, 3),
            Pose(R=t["R"][src], C=t["C"][src]), t["cov3"][src], t["C"][d], t["cov3"][d],
            runs.mapdb, runs.cfg, sample_idx=torch.from_numpy(s["draws"][d]))
        want = [out.fused_pos, out.fused_cov, out.ok, out.rel.R, out.rel.C, out.scale]
        _equal(mc.leaves(runs.ranks[d], "inter"), [w[None] for w in want], f"rank {d}")


def _odd(d, feats):
    return [*feats, np.int32(d), np.array([True, d == 1, False]), np.full(3, float(d))]


def test_ring_shift_and_all_gather_of_packed_leaves(runs):
    """One packed buffer carries a Features (float32, int32 and bool
    leaves), a 0-dim int32, a 3-byte bool and a float64 vector: ring_shift
    gives each rank its predecessor's, all_gather every rank's stacked,
    gather the (D, ...) concatenation."""
    feats = [convert.features_from_numpy(f, "cpu") for f in runs.state["feats"]]
    odd = [[t.numpy() if isinstance(t, torch.Tensor) else t for t in _odd(d, feats[d])]
           for d in range(D)]
    for d in range(D):
        _equal(mc.leaves(runs.ranks[d], "ring"), odd[(d - 1) % D], f"ring to rank {d}")
        _equal(mc.leaves(runs.ranks[d], "all"), [np.stack(x) for x in zip(*odd)],
               f"all_gather on rank {d}")
        _equal(mc.leaves(runs.ranks[d], "gather"),
               [np.stack([f.xy for f in feats]), np.stack([f.desc for f in feats])],
               f"gather on rank {d}")


def test_world_of_one(runs):
    """At world size 1 ring_shift returns its argument, all_gather adds an
    axis of one, and the step fuses the drone with itself (inter_ok may be
    false: no baseline), every output finite."""
    one = runs.one
    assert bool(one["same"])
    _equal(mc.leaves(one, "all"), [x[None] for x in mc.leaves(one, "feats")], "all_gather")
    step = mc.leaves(one, "step")
    assert [x.shape for x in step[3:]] == [(1, 3), (1, 3, 3), (1, 3), (1, 3, 3), (1,)]
    assert all(np.isfinite(x).all() for x in step[:5])


def test_make_mesh_needs_a_card_or_the_cpu(monkeypatch):
    """No CUDA device and no devices: make_mesh raises before it joins a
    process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("devices, backend", [
    (["cuda:0"], "nccl"), (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cuda:0"], "gloo"),
    (["cuda:0"] * 4, "gloo"), (["cpu", "cpu"], "gloo"), (["cpu"], "gloo"),
    (["cuda:0", "cpu"], "gloo")])
def test_backend_rule(devices, backend):
    """NCCL where every rank has a card of its own or there is one rank on
    a card; gloo where ranks share a card or any is on the CPU."""
    assert mesh._choose_backend([torch.device(d) for d in devices])[0] == backend


def test_shard_rows():
    """Rows of an uneven axis: ceil-sized shards, the last ones short or
    empty."""
    m = mesh.Mesh(axis_names=("drone",), shape={"drone": 4}, coords={"drone": 3}, groups={},
                  device=torch.device("cpu"), backend="gloo", rank=3, size=4)
    assert mesh.shard_rows(10, m, "drone") == (9, 10, 3)
    assert mesh.shard_rows(5, m, "drone") == (6, 6, 2)
    assert mesh.shard_rows(8, m, None) == (0, 8, 8)
