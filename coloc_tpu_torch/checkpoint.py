"""Checkpoint and resume of a session's persistent state (counterpart of
coloc_tpu.checkpoint), in coloc_tpu's file format, so that a file either
package writes loads into the other.

Reference parity: SURVEY.md §5 — the reference saves scenes as PLY and
loads nothing back; the map database is the unit a localization session
resumes from. One .npz (written to the exact path given) holds:
  - version (1), frame, map_ready;
  - key, uint32[2]: coloc_tpu's JAX PRNG key;
  - fb_x float32, fb_P float32, fb_steps int32: the Kalman bank;
  - map_X float32, map_desc uint32, map_valid bool, and, where the session
    has them, lm_support / lm_last_seen int32 (a file without them, from
    before the landmark support, loads with both None);
  - scene_Rs, scene_Cs, scene_X float32, scene_X_valid bool, scene_obs
    float32, scene_obs_mask bool, scene_desc uint32, where there is a scene.
Descriptors are written as uint32 with the bits of the port's int32 view
(types.py) and read back the same way.

The random stream. The port draws from a torch.Generator, coloc_tpu from
a JAX key, and neither can continue the other's stream. The rule:
  - a file is read with seed = (key[0] << 32) | key[1], the inverse of
    jax.random.PRNGKey(seed) (which keeps a seed's low 32 bits unless JAX
    runs with x64): a coloc_tpu session made with seed s writes key
    [0, s], and the port reseeds with s;
  - the port writes, besides `key`, its generator's state
    (`torch_generator_state`, uint8) and device type
    (`torch_generator_device`, "cpu" or "cuda"); coloc_tpu ignores both;
  - loading restores that state exactly when the session's device type is
    the one that wrote it, so a resumed session draws what the
    uninterrupted one would have; otherwise (another device type, or a
    coloc_tpu file) the generator is seeded from `key` by the mapping;
  - the port's `key` is the first 8 bytes of the SHA-256 of that state, as
    two big-endian uint32 words: a function of where the stream stands,
    so a load elsewhere starts a stream of its own instead of replaying
    draws already used.

What the file does not hold is reset on load, never left stale: the
bootstrap's geometry and BA result (`bootstrap_views`, `bootstrap_geo`,
`bootstrap_ba`), `last_rejected`, `last_pose` (inter_pose waits for the
next frame), the resident bank and the captured step graphs, which the
next intra_pose_chunk captures again for the loaded map. Queued log
entries are flushed first: they belong to frames already stepped.
"""

from __future__ import annotations

import hashlib
import os
from types import SimpleNamespace

import numpy as np
import torch

from coloc_tpu_torch import convert
from coloc_tpu_torch.types import MapDB

_VERSION = 1


def key_to_seed(key) -> int:
    """coloc_tpu's uint32[2] key -> the torch seed (key[0] << 32) | key[1]."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return (int(k[0]) << 32) | int(k[1])


def _state_key(state: np.ndarray) -> np.ndarray:
    digest = hashlib.sha256(state.tobytes()).digest()
    return np.frombuffer(digest[:8], dtype=">u4").astype(np.uint32)


def _desc_u32(desc: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(desc.cpu().numpy()).view(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_session(path: str, session) -> None:
    """Snapshot a ColocSession's persistent state to `path` (.npz)."""
    state = session.generator.get_state().numpy()
    fb = session.filter_bank
    data = {
        "version": _VERSION,
        "frame": session.frame,
        "map_ready": session.map_ready,
        "key": _state_key(state),
        "fb_x": _np(fb.x), "fb_P": _np(fb.P), "fb_steps": _np(fb.steps),
        "torch_generator_state": state,
        "torch_generator_device": np.array(session.device.type),
    }
    if session.mapdb is not None:
        db = session.mapdb
        data.update(map_X=_np(db.X), map_desc=_desc_u32(db.desc), map_valid=_np(db.valid))
        if session.lm_support is not None:
            data.update(lm_support=_np(session.lm_support),
                        lm_last_seen=_np(session.lm_last_seen))
    if session.scene is not None:
        s = session.scene
        data.update(scene_Rs=_np(s.Rs), scene_Cs=_np(s.Cs), scene_X=_np(s.X),
                    scene_X_valid=_np(s.X_valid), scene_obs=_np(s.obs),
                    scene_obs_mask=_np(s.obs_mask), scene_desc=_desc_u32(s.desc))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # through a file handle, so that the file lands at `path` exactly
    # (np.savez appends ".npz" to a bare string path)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **data)


def load_session(path: str, session) -> None:
    """Restore a file's state into a configured ColocSession, on the
    session's device (the random stream by the module's rule)."""
    z = np.load(path)
    version = int(z["version"])
    if version > _VERSION:
        raise ValueError(f"{path}: unknown checkpoint version {version}")
    dev = session.device
    if session._pending_logs:
        session.flush_logs()
    session.frame = int(z["frame"])
    session.map_ready = bool(z["map_ready"])
    if ("torch_generator_state" in z
            and str(z["torch_generator_device"]) == dev.type):
        session.generator.set_state(torch.from_numpy(z["torch_generator_state"].copy()))
    else:
        session.generator.manual_seed(key_to_seed(z["key"]))
    session.filter_bank = convert.filter_bank_from_numpy(
        SimpleNamespace(x=z["fb_x"], P=z["fb_P"], steps=z["fb_steps"]), dev)
    session.mapdb = session.lm_support = session.lm_last_seen = session.scene = None
    if "map_X" in z:
        session.mapdb = convert.mapdb_from_numpy(
            SimpleNamespace(X=z["map_X"], desc=z["map_desc"], valid=z["map_valid"]), dev)
        if "lm_support" in z:
            session.lm_support = torch.from_numpy(z["lm_support"].astype(np.int32)).to(dev)
            session.lm_last_seen = torch.from_numpy(
                z["lm_last_seen"].astype(np.int32)).to(dev)
    if "scene_Rs" in z:
        session.scene = convert.scene_from_numpy(SimpleNamespace(
            Rs=z["scene_Rs"], Cs=z["scene_Cs"], X=z["scene_X"], X_valid=z["scene_X_valid"],
            obs=z["scene_obs"], obs_mask=z["scene_obs_mask"], desc=z["scene_desc"]), dev)
    session.bootstrap_views = session.bootstrap_geo = session.bootstrap_ba = None
    session.last_rejected = None
    session.last_pose = {}
    session._bank = session._bank_src = None
    session._graphs = None


def save_mapdb(path: str, mapdb: MapDB) -> None:
    """A map database on its own (exchangeable between sessions and with
    coloc_tpu), at `path` exactly."""
    with open(path, "wb") as fh:
        np.savez_compressed(fh, version=_VERSION, X=_np(mapdb.X),
                            desc=_desc_u32(mapdb.desc), valid=_np(mapdb.valid))


def load_mapdb(path: str, device=None) -> MapDB:
    """A saved map database on `device` (None: cuda:0)."""
    z = np.load(path)
    return convert.mapdb_from_numpy(
        SimpleNamespace(X=z["X"], desc=z["desc"], valid=z["valid"]), device)
