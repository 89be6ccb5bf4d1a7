"""The session's per-frame step (counterpart of the device step of
coloc_tpu.session).

Reference parity: coloc.hpp mainThread's per-frame, per-drone intra
localization (intraPoseEstimator) followed by the Kalman bank update.
intra_all_device_step is the body that coloc_tpu's
ColocSession.intra_pose_all, run and run_chunked call every frame: a
batched frontend over D drones, one 2-NN of all queries against the
resident map bank, per-drone localization, landmark support counts, then
the filter bank update.

Not ported yet: the ColocSession class itself (bootstrap, inter-drone
fusion, map lifecycle, logging, checkpoints), ROADMAP A5-A8.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from coloc_tpu_torch import matching
from coloc_tpu_torch.config import ColocConfig
from coloc_tpu_torch.frontend import detect_and_describe_batch
from coloc_tpu_torch.fusion import kalman
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.ops import hamming
from coloc_tpu_torch.sfm.localize import localize_image
from coloc_tpu_torch.types import Features, MapDB, Matches, Pose, PoseWithCov


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
