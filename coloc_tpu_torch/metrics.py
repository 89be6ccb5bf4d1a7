"""Trajectory accuracy metrics: ATE / RPE with Umeyama alignment
(counterpart of coloc_tpu.metrics, a copy: the port imports nothing of
coloc_tpu).

The standard SLAM benchmark definitions (Sturm et al., IROS 2012):

  ATE: align the estimated trajectory to ground truth with a similarity
       transform (monocular estimates carry a free global scale, as the
       reference's maps do until rescaleMap aligns them,
       colocUtils.hpp:184-223), then RMSE of position residuals.
  RPE: per-delta-step relative translation error, invariant to the global
       frame, catching drift the ATE alignment can absorb.

Pure numpy (host-side post-processing of logged trajectories); utils.align_maps
uses the Umeyama alignment.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    est: np.ndarray,   # (N, 3) estimated positions
    gt: np.ndarray,    # (N, 3) ground-truth positions
    with_scale: bool = True,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform (s, R, t): s R est + t ~= gt.

    Umeyama (1991) closed form; `with_scale=False` pins s=1 for metric
    estimates.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error: similarity-align est to gt, return
    (RMSE, per-frame residual norms)."""
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ np.asarray(est, np.float64).T)).T + t
    res = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((res ** 2).mean())), res


def rpe_translation(
    est: np.ndarray, gt: np.ndarray, delta: int = 1,
    with_scale: bool = True, frame_ids=None,
) -> Tuple[float, np.ndarray]:
    """Relative pose error (translation drift per `delta` frames).

    Scale-aligns est once (monocular), then compares per-step displacement
    vectors: ||(est_{i+d} - est_i) * s_aligned - (gt_{i+d} - gt_i)||.

    `frame_ids`: optional per-row original frame indices. When the rows are
    a SUBSET of the sequence (e.g. only the localized frames), pairs whose
    id gap != delta are excluded so "RPE(delta)" really measures a
    delta-frame step, not a variable multi-frame gap across localization
    dropouts. Returns (RMSE, per-kept-step error norms); RMSE is NaN when
    no pair qualifies.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    s, R, _ = umeyama_alignment(est, gt, with_scale)
    de = (s * (R @ est.T)).T
    d_est = de[delta:] - de[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    res = np.linalg.norm(d_est - d_gt, axis=1)
    if frame_ids is not None:
        ids = np.asarray(frame_ids)
        keep = (ids[delta:] - ids[:-delta]) == delta
        res = res[keep]
    if res.size == 0:
        return float("nan"), res
    return float(np.sqrt((res ** 2).mean())), res
