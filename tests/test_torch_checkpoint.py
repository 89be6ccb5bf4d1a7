"""Checkpoints across packages (ROADMAP C14) on the CPU: a file coloc_tpu's
save_session writes loads into the port (every field equal, descriptors
bit for bit, the generator seeded from `key` by checkpoint.key_to_seed),
a file the port writes loads through coloc_tpu's load_session (every
field and dtype as coloc_tpu writes them), a file without the landmark
support loads, save_mapdb / load_mapdb both ways at the exact path given,
the generator's device-type rule, and a port round trip that resumes bit
for bit (tests/test_checkpoint.py's size: 240x320, 4 levels, 512
keypoints, 512 landmarks).

The cross-package states are built from seeded numpy arrays; no frame is
run by coloc_tpu.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import checkpoint as jckpt
from coloc_tpu import config as jcfg
from coloc_tpu.fusion import kalman as jkalman
from coloc_tpu.session import ColocSession as JSession
from coloc_tpu.sfm import reconstruct as jrec
from coloc_tpu.types import MapDB as JMapDB

from coloc_tpu_torch import checkpoint as tckpt
from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch import convert
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.session import ColocSession as TSession

from plumbing_cases import frame, session
from port_harness import one_torch_thread, time_limit  # noqa: F401

D, L, V = 2, 96, 2
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
KS, DISTS = np.stack([K] * D), np.zeros((D, 3), np.float32)
FIELDS_MAP = ("X", "desc", "valid")
FIELDS_SCENE = ("Rs", "Cs", "X", "X_valid", "obs", "obs_mask", "desc")


def _state(seed, support=True):
    """A session's persistent state as numpy arrays in coloc_tpu's dtypes."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2 ** 32, (L, 16), dtype=np.uint64).astype(np.uint32)
    desc[0] = 0xFFFFFFFF                    # every bit set: the sign bit survives
    P = rng.normal(size=(D, 6, 6)).astype(np.float32)
    st = dict(
        frame=17, map_ready=True,
        fb_x=rng.normal(size=(D, 6)).astype(np.float32),
        fb_P=(P @ P.transpose(0, 2, 1)).astype(np.float32),
        fb_steps=rng.integers(0, 9, D).astype(np.int32),
        map_X=rng.normal(size=(L, 3)).astype(np.float32), map_desc=desc,
        map_valid=rng.uniform(size=L) < 0.7,
        scene_Rs=np.stack([np.eye(3, dtype=np.float32)] * V),
        scene_Cs=rng.normal(size=(V, 3)).astype(np.float32),
        scene_X=rng.normal(size=(L, 3)).astype(np.float32),
        scene_X_valid=rng.uniform(size=L) < 0.7,
        scene_obs=rng.uniform(0, 300, (V, L, 2)).astype(np.float32),
        scene_obs_mask=rng.uniform(size=(V, L)) < 0.5, scene_desc=desc[::-1].copy())
    if support:
        st.update(lm_support=rng.integers(0, 20, L).astype(np.int32),
                  lm_last_seen=rng.integers(-1, 17, L).astype(np.int32))
    return st


def _jsession(st, seed=0):
    js = JSession(jcfg.ColocConfig(num_drones=D), KS, DISTS, seed=seed)
    js.frame, js.map_ready = st["frame"], st["map_ready"]
    js.filter_bank = jkalman.FilterBank(*(jnp.asarray(st[f"fb_{k}"]) for k in ("x", "P", "steps")))
    js.mapdb = JMapDB(*(jnp.asarray(st[f"map_{k}"]) for k in FIELDS_MAP))
    js.scene = jrec.Scene(*(jnp.asarray(st[f"scene_{k}"]) for k in FIELDS_SCENE))
    js.lm_support = jnp.asarray(st["lm_support"]) if "lm_support" in st else None
    js.lm_last_seen = jnp.asarray(st["lm_last_seen"]) if "lm_support" in st else None
    return js


def _tsession(st, seed=0):
    ts = TSession(tcfg.ColocConfig(num_drones=D), KS, DISTS, seed=seed, device="cpu")
    convert.session_state_from_numpy(SimpleNamespace(
        frame=st["frame"], map_ready=st["map_ready"], last_pose={},
        filter_bank=SimpleNamespace(x=st["fb_x"], P=st["fb_P"], steps=st["fb_steps"]),
        mapdb=SimpleNamespace(**{k: st[f"map_{k}"] for k in FIELDS_MAP}),
        scene=SimpleNamespace(**{k: st[f"scene_{k}"] for k in FIELDS_SCENE}),
        lm_support=st.get("lm_support"), lm_last_seen=st.get("lm_last_seen")), ts)
    return ts


def _assert_port_holds(ts, st):
    """The port session's fields equal the state, descriptors as the int32
    view of the same bits."""
    assert ts.frame == st["frame"] and ts.map_ready == st["map_ready"]
    for k in ("x", "P", "steps"):
        np.testing.assert_array_equal(getattr(ts.filter_bank, k).numpy(), st[f"fb_{k}"])
    for k in FIELDS_MAP:
        np.testing.assert_array_equal(getattr(convert.to_numpy(ts.mapdb), k),
                                      st[f"map_{k}"])
    for k in FIELDS_SCENE:
        np.testing.assert_array_equal(getattr(convert.to_numpy(ts.scene), k),
                                      st[f"scene_{k}"])
    assert ts.mapdb.desc.dtype == torch.int32 and ts.scene.desc.dtype == torch.int32
    if "lm_support" in st:
        np.testing.assert_array_equal(ts.lm_support.numpy(), st["lm_support"])
        np.testing.assert_array_equal(ts.lm_last_seen.numpy(), st["lm_last_seen"])
        assert ts.lm_support.dtype == torch.int32
    else:
        assert ts.lm_support is None and ts.lm_last_seen is None


def test_key_to_seed_inverts_prng_key():
    """PRNGKey(s) -> s for the seeds coloc_tpu keeps (32 bits without
    jax_enable_x64); a key's high word lands in the seed's high 32 bits."""
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        assert tckpt.key_to_seed(np.asarray(jax.random.PRNGKey(seed))) == seed
    assert tckpt.key_to_seed(np.array([3, 5], np.uint32)) == (3 << 32) | 5


def test_reference_file_loads_into_the_port(tmp_path):
    """coloc_tpu's file: every field equal, descriptors bit for bit, the
    generator seeded with (key[0] << 32) | key[1], the state that the file
    does not hold reset."""
    st = _state(0)
    js = _jsession(st)
    js.key = jax.random.PRNGKey(123456789)
    path = str(tmp_path / "ref.ckpt")
    jckpt.save_session(path, js)
    ts = TSession(tcfg.ColocConfig(num_drones=D), KS, DISTS, device="cpu")
    ts.last_pose, ts.bootstrap_views, ts._graphs = {0: None}, [0, 1], object()
    tckpt.load_session(path, ts)
    _assert_port_holds(ts, st)
    want = torch.rand(16, generator=torch.Generator().manual_seed(123456789))
    assert torch.equal(torch.rand(16, generator=ts.generator), want)
    assert ts.last_pose == {} and ts.bootstrap_views is None and ts._graphs is None


def test_port_file_loads_into_the_reference(tmp_path):
    """The port's file through coloc_tpu.checkpoint.load_session: every
    field as the state; and key by key the file holds what coloc_tpu writes
    for the same state, with its dtypes and shapes (plus the port's
    generator keys), `key` a uint32[2]."""
    st = _state(1)
    ts = _tsession(st)
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tckpt.save_session(port_path, ts)
    jckpt.save_session(ref_path, _jsession(st))
    js = JSession(jcfg.ColocConfig(num_drones=D), KS, DISTS)
    jckpt.load_session(port_path, js)
    assert js.frame == st["frame"] and js.map_ready == st["map_ready"]
    for k in ("x", "P", "steps"):
        np.testing.assert_array_equal(np.asarray(getattr(js.filter_bank, k)), st[f"fb_{k}"])
    for k in FIELDS_MAP:
        np.testing.assert_array_equal(np.asarray(getattr(js.mapdb, k)), st[f"map_{k}"])
    for k in FIELDS_SCENE:
        np.testing.assert_array_equal(np.asarray(getattr(js.scene, k)), st[f"scene_{k}"])
    np.testing.assert_array_equal(np.asarray(js.lm_support), st["lm_support"])
    assert np.asarray(js.key).dtype == np.uint32 and np.asarray(js.key).shape == (2,)
    zp, zr = np.load(port_path), np.load(ref_path)
    assert set(zp.files) == set(zr.files) | {"torch_generator_state", "torch_generator_device"}
    for name in zr.files:
        assert (zp[name].dtype, zp[name].shape) == (zr[name].dtype, zr[name].shape), name
        if name != "key":
            np.testing.assert_array_equal(zp[name], zr[name])


def test_file_without_support_or_map_loads(tmp_path):
    """A file from before the landmark support (no lm_* keys) loads with
    both None, rebuilt at the next frame; a file without a map leaves the
    session without one, not with the map it had."""
    st = _state(2, support=False)
    path = str(tmp_path / "old.npz")
    jckpt.save_session(path, _jsession(st))
    assert "lm_support" not in np.load(path).files
    ts = _tsession(_state(3))
    tckpt.load_session(path, ts)
    _assert_port_holds(ts, st)
    ts._ensure_support()
    assert ts.lm_support.shape == (L,) and int(ts.lm_support.abs().sum()) == 0
    js = JSession(jcfg.ColocConfig(num_drones=D), KS, DISTS)
    jckpt.save_session(path, js)
    tckpt.load_session(path, ts)
    assert ts.mapdb is None and ts.scene is None and not ts.map_ready


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mapdb_round_trip_at_the_exact_path(tmp_path, writer):
    st = _state(4)
    path = tmp_path / "map.ckpt"
    if writer == "port":
        tckpt.save_mapdb(str(path), _tsession(st).mapdb)
        db = jckpt.load_mapdb(str(path))
    else:
        jckpt.save_mapdb(str(path), _jsession(st).mapdb)
        db = convert.to_numpy(tckpt.load_mapdb(str(path), "cpu"))
    assert path.exists() and not (tmp_path / "map.ckpt.npz").exists()
    for k in FIELDS_MAP:
        np.testing.assert_array_equal(np.asarray(getattr(db, k)), st[f"map_{k}"])
    assert np.asarray(db.desc).dtype == np.uint32


def test_generator_state_follows_the_device_type(tmp_path):
    """A port file restores its generator state on the device type that
    wrote it; a file written on another device type seeds from `key`."""
    ts = _tsession(_state(5), seed=3)
    torch.rand(5, generator=ts.generator)
    path = str(tmp_path / "g.npz")
    tckpt.save_session(path, ts)
    want = torch.rand(8, generator=ts.generator)
    same = _tsession(_state(6), seed=99)
    tckpt.load_session(path, same)
    assert torch.equal(torch.rand(8, generator=same.generator), want)
    z = dict(np.load(path))
    z["torch_generator_device"] = np.array("cuda")
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **z)
    other = _tsession(_state(6), seed=99)
    tckpt.load_session(path, other)
    seeded = torch.Generator().manual_seed(tckpt.key_to_seed(z["key"]))
    assert torch.equal(torch.rand(8, generator=other.generator), torch.rand(8, generator=seeded))


H, W = 240, 320


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_scene(H, W, K, seed=3)
    out = {}
    for d in range(D):
        Rs, Cs = synthetic.trajectory(4, d)
        out[d] = [synthetic.render(scene, Rs[f], Cs[f]).astype(np.float32) for f in range(4)]
    return out


def _make():
    cfg = tcfg.ColocConfig(num_drones=D, max_landmarks=512, detector=tcfg.DetectorOptions(
        width=W, height=H, max_keypoints=512, num_levels=4, fast_threshold=10))
    return TSession(cfg, KS, DISTS, device="cpu")


def test_round_trip_resumes_bit_for_bit(frames, tmp_path):
    """Bootstrap on frame 0, frame 1, save; a fresh session loads the file
    and both step frames 2 and 3: every output, the filter bank and the
    landmark support torch.equal."""
    s1 = _make()
    assert s1.init_map({d: frames[d][0] for d in range(D)})
    s1.frame = 1
    s1.intra_pose_all({d: frames[d][1] for d in range(D)})
    path = str(tmp_path / "session.ckpt")
    tckpt.save_session(path, s1)
    s2 = _make()
    tckpt.load_session(path, s2)
    assert s2.map_ready
    for f in (2, 3):
        s1.frame = s2.frame = f
        imgs = {d: frames[d][f] for d in range(D)}
        a, b = s1.intra_pose_all(imgs), s2.intra_pose_all(imgs)
        for d in range(D):
            assert bool(a[d].success)
            for x, y in zip((*a[d].pose, *a[d][1:]), (*b[d].pose, *b[d][1:])):
                assert torch.equal(x, y)
    for x, y in zip((*s1.filter_bank, s1.lm_support, s1.lm_last_seen),
                    (*s2.filter_bank, s2.lm_support, s2.lm_last_seen)):
        assert torch.equal(x, y)


def test_loaded_session_runs_every_entry_point(tmp_path):
    """After a load, what the file does not hold is rebuilt or waits, never
    stale: inter_pose returns None until a frame gives the drones poses;
    intra_pose_chunk steps (on the card it captures again, the map being a
    new object) and localizes; inter_pose and extend_map run
    (tests/plumbing_cases.py's 96x128 frame and map)."""
    s1 = session(D)
    s1.intra_pose_all({d: frame() for d in range(D)})
    path = str(tmp_path / "p.npz")
    tckpt.save_session(path, s1)
    s2 = session(D)
    s2.last_pose, s2._graphs = dict(s1.last_pose), object()
    tckpt.load_session(path, s2)
    imgs = {d: frame() for d in range(D)}
    assert s2.inter_pose(0, 1, imgs) is None and s2._graphs is None and s2.last_pose == {}
    s2.frame = 1
    out = s2.intra_pose_chunk(np.stack([[frame()] * D]))
    assert all(bool(out[d][0].success) for d in range(D)) and s2.frame == 2
    fused = s2.inter_pose(0, 1, imgs)
    assert fused is None or bool(torch.isfinite(fused.pos).all())
    assert s2.extend_map(imgs) >= 0
