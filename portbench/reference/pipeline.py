"""The whole localization of a batch of frames in the reference, from the
frames, the map and the draws: what the control puts in the program's
place. It computes in `dtype` under `precision(tf32)`."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from portbench.reference import geometry, judge, match, trip


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in full float32, or, for the control, in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def localize_frames(frames, cfg: dict, X, words, valid, K, dist, draws,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """B frames (B, H, W) against the map (X (L, 3), words (L, 16), valid
    (L,)) with cameras K (B, 3, 3), dist (B, 3) and draws (B, 256, 3) ->
    keypoints, map slots, correspondences, inliers, pose, covariance,
    rmse and success of each frame."""
    kp = judge.reference_frontend(frames, cfg["detector"])
    B, k = kp.valid.shape
    m = cfg["matcher"]
    idx = match.match(trip.bits_to_words(kp.bits).reshape(B * k, -1), kp.valid.reshape(-1),
                      words, valid, m.get("mode", "margin"), m.get("margin_threshold", 60),
                      m.get("dist_ratio", 0.8)).reshape(B, k)
    corr = idx >= 0
    Xc = X[torch.clamp(idx, min=0)].to(dtype)
    uv, Kd, dd = kp.xy.to(dtype), K.to(dtype), dist.to(dtype)
    rs = geometry.acransac(Xc, uv, corr, Kd, dd, draws.to(torch.float32))
    R, C = geometry.refine(rs.R, rs.C, Kd, dd, Xc, uv, rs.inliers)
    H, _, rmse = geometry.information(R, C, Kd, dd, Xc, uv, rs.inliers)
    eye = torch.eye(3, dtype=dtype, device=R.device)
    ok = rs.success
    return {"kp": kp, "idx": idx, "corr": corr, "X": Xc, "inliers": rs.inliers,
            "R": torch.where(ok[:, None, None], R, eye),
            "C": torch.where(ok[:, None], C, torch.zeros_like(C)),
            "cov": torch.where(ok[:, None, None], geometry.covariance(H),
                               torch.eye(6, dtype=dtype, device=R.device)),
            "rmse": torch.where(ok, rmse, torch.zeros_like(rmse)), "success": ok}
