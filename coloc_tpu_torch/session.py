"""Collaborative-localization session (counterpart of coloc_tpu.session).

Reference parity: coloc.hpp class ColoC — mainThread (:96-148) bootstraps
the map from the first frame of each drone (initMap :151), then localizes
every drone every frame (intraPoseEstimator :201) and updates the Kalman
bank.

  intra_all_device_step — the body that coloc_tpu's intra_pose_all, run and
      run_chunked call every frame: a batched frontend over D drones, one
      2-NN of all queries against the resident map bank, per-drone
      localization, landmark support counts, the filter bank update
  ColocSession          — init_map (the D = 2 model-E bootstrap),
      intra_pose_all and run around that step

The host drives the events; tensors stay on the session's device, which is
cuda:0 unless the caller asks for another. RANSAC draws come from the
session's torch.Generator (seeded by `seed`), or are injected with
`sample_idx` (how the parity tests replay coloc_tpu's jax.random draws).

Not ported yet, each raising NotImplementedError where it is asked for:
models F and H and the D > 2 reconstruction (ROADMAP A6), inter-drone
fusion (A7), the map lifecycle (A8), logging, checkpoints, intra_pose and
the chunked stepping (A5).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from coloc_tpu_torch import matching, robust
from coloc_tpu_torch.config import ColocConfig
from coloc_tpu_torch.frontend import detect_and_describe, detect_and_describe_batch
from coloc_tpu_torch.fusion import kalman
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.ops import dispatch, hamming
from coloc_tpu_torch.sfm import reconstruct
from coloc_tpu_torch.sfm.localize import localize_image
from coloc_tpu_torch.types import (Features, MapDB, Matches, Pose, PoseWithCov,
                                   TwoViewGeometry)


def intra_all_device_step(
    cfg: ColocConfig,
    images: torch.Tensor,                 # (D, H, W)
    mapdb: MapDB,
    bank: hamming.Bank,                   # resident bank of mapdb
    Ks: torch.Tensor,                     # (D, 3, 3)
    dists: torch.Tensor,                  # (D, 3)
    fb: kalman.FilterBank,
    generators: Optional[Sequence[torch.Generator]] = None,
    sample_idx: Optional[torch.Tensor] = None,   # (D, B, 3)
):
    """All drones' frame step -> (pwcs, fb', filtered, gate_dist, rej,
    eulers, sup_inc), each with a leading drone axis except sup_inc, the
    (L,) int32 count of drones that used each landmark as a refinement
    inlier this frame. `generators[d]` draws drone d's RANSAC samples;
    `sample_idx[d]` injects them instead (parity tests)."""
    D = images.shape[0]
    kp = cfg.detector.max_keypoints
    feats = detect_and_describe_batch(images, cfg.detector)
    qv = feats.valid.reshape(-1)
    idx, best, second = hamming.hamming_2nn_bank(
        feats.desc.reshape(D * kp, -1), qv, bank)
    m = matching._accept(idx, best, second, qv, cfg.matcher,
                         cfg.matcher.margin_threshold)
    mm = Matches(*(t.reshape(D, kp) for t in m))

    pwcs, inls = [], []
    for d in range(D):
        pwc, inl = localize_image(
            Features(*(t[d] for t in feats)), Matches(*(t[d] for t in mm)),
            mapdb, Camera(K=Ks[d], dist=dists[d]), cfg.ransac, cfg.refiner,
            generator=None if generators is None else generators[d],
            sample_idx=None if sample_idx is None else sample_idx[d])
        pwcs.append(pwc)
        inls.append(inl)
    pwcs = PoseWithCov(
        pose=Pose(R=torch.stack([p.pose.R for p in pwcs]),
                  C=torch.stack([p.pose.C for p in pwcs])),
        **{f: torch.stack([getattr(p, f) for p in pwcs])
           for f in ("cov", "rmse", "n_tracks", "success")})
    inls = torch.stack(inls)

    # landmark support: one count per (drone, landmark) refinement inlier of
    # a drone whose localization succeeded; non-hits go to slot L, dropped
    hit = inls & mm.mask & pwcs.success[:, None]
    L = mapdb.X.shape[0]
    slot = torch.where(hit, mm.idx, L).reshape(-1).to(torch.int64)
    sup_inc = torch.zeros(L + 1, dtype=torch.int32, device=slot.device)
    sup_inc = sup_inc.scatter_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))[:L]

    zs = kalman.fill_measurement(pwcs.pose)
    fb, filtered, dist_g, rej = kalman.update_all(
        fb, zs, pwcs.cov[:, 3:6, 3:6], pwcs.rmse, pwcs.success, cfg.filter)
    eulers = so3.rot_to_euler(pwcs.pose.R)
    return pwcs, fb, filtered, dist_g, rej, eulers, sup_inc


class ColocSession:
    """One collaborative-localization session over D drones (class ColoC).

    Attributes as coloc_tpu's: map_ready, mapdb, scene, filter_bank,
    last_pose, frame, lm_support, lm_last_seen; plus bootstrap_geo and
    bootstrap_ba, the bootstrap's TwoViewGeometry and BAResult, and
    last_rejected, the (D,) gate rejections of the last frame."""

    def __init__(self, config: ColocConfig, Ks, dists, out_dir: str = "",
                 seed: int = 0, profile: bool = False, viz=None,
                 debug_dir: str = "", device=None):
        asked = [name for name, given in (("out_dir", bool(out_dir)),
                                          ("profile", bool(profile)),
                                          ("viz", viz is not None),
                                          ("debug_dir", bool(debug_dir)))
                 if given]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: the session's logs, stage profiler, "
                "SVG debug output and live view are not ported yet "
                "(ROADMAP A5b)")
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

    def _image(self, image) -> torch.Tensor:
        if isinstance(image, torch.Tensor):
            return image.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(image, np.float32), device=self.device)

    def detect(self, image) -> Features:
        return detect_and_describe(self._image(image), self.config.detector)

    def _relative_pose(self, uv1, uv2, mask, cam1, cam2,
                       sample_idx=None) -> TwoViewGeometry:
        model = self.config.model
        if model == "E":
            return robust.relative_pose_essential(
                uv1, uv2, mask, cam1, cam2, self.config.ransac,
                generator=self.generator, sample_idx=sample_idx)
        if model in ("F", "H"):
            raise NotImplementedError(
                f"model {model!r}: the {'fundamental' if model == 'F' else 'homography'}"
                " two-view path is not ported yet (ROADMAP A6)")
        raise ValueError(f"unknown geometric model {model!r}")

    def init_map(self, images, sample_idx: Optional[torch.Tensor] = None) -> bool:
        """Bootstrap the shared map from one frame of each of two drones
        (ColoC::initMap, coloc.hpp:151-199): detect, match the pair, model-E
        AC-RANSAC, triangulate, full BA with drone 0's pose fixed. False if
        the geometry fails or fewer than 8 landmarks survive.
        `sample_idx` (256, 5): injected five-point draws."""
        cfg = self.config
        if cfg.num_drones != 2:
            raise NotImplementedError(
                f"init_map with {cfg.num_drones} drones: the D > 2 "
                "reconstruction (reconstruct_scene, tracks, resection) is not "
                "ported yet (ROADMAP A6)")
        f0, f1 = self.detect(images[0]), self.detect(images[1])
        m = matching.match_pair(f0, f1, cfg.matcher)
        geo = self._relative_pose(f0.xy, f1.xy[m.idx.long()], m.mask,
                                  self.cams[0], self.cams[1], sample_idx)
        if not bool(geo.success):
            return False
        origin = Pose(R=torch.eye(3, device=self.device),
                      C=torch.zeros(3, device=self.device))
        scene = reconstruct.two_view_scene(
            f0, f1, m, geo.inliers, geo.R, geo.t, origin, cfg.scale,
            self.cams[0], self.cams[1], num_landmarks=cfg.max_landmarks)
        scene, ba = reconstruct.refine_scene(
            scene, self.Ks[:2], self.dists[:2], cfg.refiner,
            fix_pose=torch.tensor([True, False], device=self.device))
        if int(scene.X_valid.sum()) < 8:
            return False
        self.scene = scene
        self.bootstrap_geo, self.bootstrap_ba = geo, ba
        self.mapdb = reconstruct.scene_to_mapdb(scene)
        self.map_ready = True
        # a wholesale (re)build: every slot is a fresh landmark
        self.lm_support = None
        self.lm_last_seen = None
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

    def intra_pose_all(self, images, sample_idx: Optional[torch.Tensor] = None
                       ) -> Dict[int, PoseWithCov]:
        """Localize every drone in one step: dict drone -> PoseWithCov with
        the filtered pose, the covariance, rmse, n_tracks and success.
        `sample_idx` (D, 256, 3): injected P3P draws."""
        D = self.config.num_drones
        imgs = torch.stack([self._image(images[d]) for d in range(D)])
        self._ensure_support()
        pwcs, fb, filtered, _, rej, _, sup_inc = intra_all_device_step(
            self.config, imgs, self.mapdb, self._map_bank(), self.Ks, self.dists,
            self.filter_bank, generators=[self.generator] * D,
            sample_idx=sample_idx)
        self.filter_bank = fb
        self.last_rejected = rej
        self.lm_support = self.lm_support + sup_inc
        self.lm_last_seen = torch.where(sup_inc > 0, self.frame,
                                        self.lm_last_seen).to(torch.int32)
        out = {}
        for d in range(D):
            out[d] = PoseWithCov(
                pose=Pose(R=filtered.R[d], C=filtered.C[d]), cov=pwcs.cov[d],
                rmse=pwcs.rmse[d], n_tracks=pwcs.n_tracks[d],
                success=pwcs.success[d])
            self.last_pose[d] = out[d]
        return out

    def run(self, frames: Dict[int, list], inter_every: int = 10,
            update_map_every: int = 0, auto_update_map: bool = False,
            auto_update_patience: int = 3, extend_map_every: int = 0,
            cull_map_every: int = 0, cull_max_age: int = 64,
            cull_min_support: int = 8) -> Dict[int, list]:
        """mainThread parity (coloc.hpp:96-148): bootstrap on the first
        frames that succeed, then intra_pose_all every frame. Returns the
        per-drone lists of filtered poses. The options of paths not ported
        yet raise rather than being skipped."""
        cfg = self.config
        if inter_every and cfg.num_drones >= 2:
            raise NotImplementedError(
                f"inter_every={inter_every}: inter-drone relative pose and "
                "fusion are not ported yet (ROADMAP A7); pass inter_every=0")
        lifecycle = {"update_map_every": update_map_every,
                     "auto_update_map": auto_update_map,
                     "extend_map_every": extend_map_every,
                     "cull_map_every": cull_map_every}
        asked = [k for k, v in lifecycle.items() if v]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: the map lifecycle is not ported yet "
                "(ROADMAP A8)")
        num_frames = min(len(v) for v in frames.values())
        out = {d: [] for d in range(cfg.num_drones)}
        f = 0
        while not self.map_ready and f < num_frames:
            self.init_map({d: frames[d][f] for d in range(cfg.num_drones)})
            f += 1
        if not self.map_ready:
            return out
        for frame_idx in range(f, num_frames):
            self.frame = frame_idx
            res = self.intra_pose_all({d: frames[d][frame_idx]
                                       for d in range(cfg.num_drones)})
            for d in range(cfg.num_drones):
                out[d].append(res[d])
        return out
