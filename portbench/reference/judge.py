"""The numbers that decide `correct`: each stage of the program's work
judged by the plain reference from the stage's own inputs.

  features   - the frame's keypoints and descriptors against the
               reference frontend's on the same frame (the one of the
               configuration's detector backend, FRONTENDS)
  matches    - the map slot of each of the program's descriptors against
               the reference's 2-NN of the same descriptors
  localize   - the inlier set against the reference's AC-RANSAC of the
               program's correspondences with the same draws (the share
               of the reference's inliers that differ); the pose
               against the Huber optimum of the program's own inliers, in
               standard errors; the covariance against the reference's at
               the program's pose, in correlation units
  filter     - the filtered poses against the reference filter run over
               the program's own localizations

The reference computes in float64 wherever it can (the frontend in
float32, the configuration's precision); `localize` and `filter` take the
dtype of their inputs, so the control runs them in float32 with TF32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import akaze, geometry, kalman, match, trip

PAIR_PX = 0.05          # a program keypoint and a reference keypoint this close are one


def features(prog_xy, prog_valid, ref: trip.Keypoints, prog_bits=None) -> Dict[str, float]:
    """Keypoints of B frames, (B, K, 2) and (B, K) on each side ->
    `keypoints_differ`, the most keypoints of a frame found by one side
    only; `desc_bits_differ`, the most descriptor bits of a frame that
    differ over the keypoints found by both (with `prog_bits`)."""
    kp_d, bits_d = 0, 0
    for b in range(prog_xy.shape[0]):
        p = prog_xy[b][prog_valid[b]].double()
        r = ref.xy[b][ref.valid[b]].double()
        if p.shape[0] == 0 or r.shape[0] == 0:
            kp_d = max(kp_d, p.shape[0] + r.shape[0])
            continue
        d = torch.cdist(p, r)
        near, j = d.min(dim=1)
        both = near < PAIR_PX
        kp_d = max(kp_d, int((~both).sum()) + r.shape[0] - int(torch.unique(j[both]).numel()))
        if prog_bits is not None:
            pb = prog_bits[b][prog_valid[b]][both]
            rb = ref.bits[b][ref.valid[b]][j[both]]
            bits_d = max(bits_d, int((pb != rb).sum()))
    out = {"keypoints_differ": float(kp_d)}
    if prog_bits is not None:
        out["desc_bits_differ"] = float(bits_d)
    return out


def matches(prog_idx, prog_words, prog_valid, bank_words, bank_valid, opts: dict) -> float:
    """The most keypoints of a frame whose map slot (-1: none) differs from
    the reference's 2-NN of the program's own descriptors. (B, K) each."""
    B, K = prog_idx.shape
    ref = match.match(prog_words.reshape(B * K, -1), prog_valid.reshape(-1), bank_words,
                      bank_valid, opts.get("mode", "margin"), opts.get("margin_threshold", 60),
                      opts.get("dist_ratio", 0.8)).reshape(B, K)
    return float((ref != prog_idx.to(ref.dtype)).sum(dim=1).max())


def localize(R, C, cov, success, inliers, X, uv, corr, K, dist, draws,
             dtype=torch.float64) -> Dict[str, float]:
    """B localizations: the program's pose (R (B, 3, 3), C (B, 3)), its
    covariance (B, 6, 6), success (B,), inliers (B, M), and its
    correspondences X (B, M, 3), uv (B, M, 2), corr (B, M) with the
    camera K (B, 3, 3), dist (B, 3) and the draws (B, 256, 3)."""
    f = {"dtype": dtype}
    Xd, uvd, Kd, dd = (t.to(**f) for t in (X, uv, K, dist))
    rs = geometry.acransac(Xd, uvd, corr, Kd, dd, draws.to(torch.float32))
    differ = ((rs.inliers != inliers) & corr).sum(dim=1)
    inl_d = float((differ / torch.clamp(rs.inliers.sum(dim=1), min=1)).max())
    ok = success & rs.success
    out = {"inliers_differ_share": inl_d}
    if not bool(ok.any()):
        out.update(pose_sigma_gap=0.0, cov_gap=0.0)
        return out
    Rp, Cp = R.to(**f)[ok], C.to(**f)[ok]
    a = (Xd[ok], uvd[ok], inliers[ok])
    Ro, Co = geometry.refine(Rp, Cp, Kd[ok], dd[ok], *a)
    Ho, _, rmse_o = geometry.information(Ro, Co, Kd[ok], dd[ok], *a)
    delta = torch.cat([geometry.log_so3(Rp @ Ro.transpose(-1, -2)), Cp - Co], -1)
    sig = torch.sqrt(torch.einsum("bi,bij,bj->b", delta, Ho, delta)) / torch.clamp(rmse_o, min=1e-9)
    Hp, _, _ = geometry.information(Rp, Cp, Kd[ok], dd[ok], *a)
    cref = geometry.covariance(Hp)
    scale = torch.sqrt(torch.diagonal(cref, dim1=-2, dim2=-1))
    corr_gap = (cov.to(**f)[ok] - cref).abs() / (scale[:, :, None] * scale[:, None, :])
    out.update(pose_sigma_gap=float(sig.max()), cov_gap=float(corr_gap.amax()))
    return out


def filtered(R, C, z, cov3, rmse, ok, opts: dict, dtype=torch.float64) -> Dict[str, float]:
    """N steps of D drones: the program's filtered poses R (N, D, 3, 3), C
    (N, D, 3) against the reference filter over the program's
    measurements z (N, D, 6) = (centre, bank, attitude, heading), cov3
    (N, D, 3, 3), rmse (N, D) and success ok (N, D)."""
    Rr, Cr = kalman.run(z.to(dtype), cov3.to(dtype), rmse.to(dtype), ok, opts)
    rot = geometry.angle_between(R.to(dtype), Rr)
    return {"filter_gap_rad": float(rot.max()),
            "filter_gap_m": float(torch.linalg.norm(C.to(dtype) - Cr, dim=-1).max())}


# the reference frontend of each detector backend: a module whose
# frontend(frames, det, k) gives trip.Keypoints (xy at base resolution,
# descriptor bits zero padded to 512)
FRONTENDS = {"trip": trip, "akaze": akaze}


def reference_frontend(frames, det: dict, k: Optional[int] = None) -> trip.Keypoints:
    """The reference frontend of the configuration's detector group, by its
    backend: the best k (max_keypoints) keypoints of each of (B, H, W)."""
    return FRONTENDS[det.get("backend", "trip")].frontend(frames, det, k or det["max_keypoints"])


def matches_by_position(prog_xy, prog_valid, prog_idx, ref: trip.Keypoints, bank_words,
                        bank_valid, opts: dict) -> float:
    """Where the program's descriptors are not at hand: the most keypoints
    of a frame whose map slot differs from the reference's 2-NN of the
    reference's descriptor at the same keypoint (a keypoint that the
    reference did not find counts where the program matched it)."""
    B, k = ref.valid.shape
    ridx = match.match(trip.bits_to_words(ref.bits).reshape(B * k, -1), ref.valid.reshape(-1),
                       bank_words, bank_valid, opts.get("mode", "margin"),
                       opts.get("margin_threshold", 60), opts.get("dist_ratio", 0.8)).reshape(B, k)
    worst = 0
    for b in range(B):
        pv = prog_valid[b]
        p, pidx = prog_xy[b][pv].double(), prog_idx[b][pv]
        r = ref.xy[b].double()
        d = torch.cdist(p, r) + torch.where(ref.valid[b], 0.0, float("inf"))[None]
        near, j = d.min(dim=1)
        paired = near < PAIR_PX
        theirs = torch.where(paired, ridx[b][j], torch.full_like(pidx, -1))
        worst = max(worst, int((theirs != pidx).sum()))
    return float(worst)
