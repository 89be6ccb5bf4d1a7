"""Per-drone 6-state Kalman filter bank with chi-square gating (counterpart
of coloc_tpu.fusion.kalman).

Reference parity: KalmanFilter.hpp — one filter per drone, state
(x, y, z, roll, pitch, yaw), identity transition (constant position),
process noise 1e-2 I, measurement noise 1e-1 I with its rotation block
overwritten by the BA covariance centre block * rmse, P0 = I. The gate
distance is innv^T S innv ("energy", the reference's form) or
innv^T S^-1 innv ("mahalanobis"); a measurement is rejected above
chi2_gate once a drone has WARMUP_STEPS accepted updates. Angle
innovations wrap to [-pi, pi].

The bank is one (D, ...) NamedTuple; update_all updates every drone at
once (the batch dimension written out), and gating is a select, not a
branch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from coloc_tpu_torch.config import FilterOptions
from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.ops import dispatch
from coloc_tpu_torch.types import Pose

WARMUP_STEPS = 5
_GATE_MODES = ("energy", "mahalanobis")


class FilterBank(NamedTuple):
    x: torch.Tensor      # (D, 6) float32 state: x, y, z, roll, pitch, yaw
    P: torch.Tensor      # (D, 6, 6) float32 covariance
    steps: torch.Tensor  # (D,) int32 accepted-update count (gate warm-up)


def init(num_drones: int, opts: FilterOptions, device=None) -> FilterBank:
    """P0 = initial_covariance I, zero state. `device` None is cuda:0, and
    raises where there is none (dispatch.default_device)."""
    device = dispatch.default_device(device)
    eye = torch.eye(6, dtype=torch.float32, device=device)
    return FilterBank(
        x=torch.zeros((num_drones, 6), dtype=torch.float32, device=device),
        P=(eye * opts.initial_covariance).expand(num_drones, 6, 6).clone(),
        steps=torch.zeros(num_drones, dtype=torch.int32, device=device),
    )


def fill_measurement(pose: Pose) -> torch.Tensor:
    """Pose (R (..., 3, 3), C (..., 3)) -> (..., 6) measurement
    (fillMeasurements parity)."""
    return torch.cat([pose.C, so3.rot_to_euler(pose.R)], dim=-1)


def measurement_to_pose(x: torch.Tensor) -> Pose:
    return Pose(R=so3.euler_to_rot(x[..., 3:6]), C=x[..., :3])


def update_all(
    bank: FilterBank,
    zs: torch.Tensor,            # (D, 6) measurements
    cov_centers: torch.Tensor,   # (D, 3, 3) BA covariance centre blocks
    rmses: torch.Tensor,         # (D,)
    available: torch.Tensor,     # (D,) bool
    opts: FilterOptions,
) -> Tuple[FilterBank, Pose, torch.Tensor, torch.Tensor]:
    """One filter step for every drone -> (bank, filtered poses (D, ...),
    gate distances (D,), rejected (D,))."""
    if opts.gate_mode not in _GATE_MODES:
        raise ValueError(f"gate_mode must be one of {_GATE_MODES}: {opts.gate_mode!r}")
    eye = torch.eye(6, dtype=zs.dtype, device=zs.device)
    R = (eye * opts.measurement_noise).expand(zs.shape[0], 6, 6).clone()
    R[:, 3:6, 3:6] = cov_centers * rmses[:, None, None]

    # predict (F = I)
    x_pred = bank.x
    P_pred = bank.P + eye * opts.process_noise

    innv = zs - x_pred
    ang = innv[:, 3:6]
    innv = torch.cat([innv[:, :3], torch.atan2(torch.sin(ang), torch.cos(ang))],
                     dim=1)
    S = P_pred + R
    Sinv = torch.linalg.inv_ex(S).inverse       # no host sync on the card
    G = Sinv if opts.gate_mode == "mahalanobis" else S
    dist = ((innv[:, None, :] @ G)[:, 0, :] * innv).sum(dim=1)
    reject = (dist > opts.chi2_gate) & (bank.steps >= WARMUP_STEPS)

    # correct
    K = P_pred @ Sinv
    x_corr = x_pred + (K @ innv[:, :, None])[:, :, 0]
    P_corr = (eye - K) @ P_pred

    use = available & ~reject
    x_new = torch.where(use[:, None], x_corr, x_pred)
    P_new = torch.where(use[:, None, None], P_corr, P_pred)
    bank = FilterBank(x=x_new, P=P_new, steps=bank.steps + use.to(torch.int32))
    return bank, measurement_to_pose(x_new), dist, reject


def update(
    bank: FilterBank,
    drone: int,
    z: torch.Tensor,             # (6,) measurement
    cov_center: torch.Tensor,    # (3, 3)
    rmse: torch.Tensor,          # ()
    available: torch.Tensor,     # () bool
    opts: FilterOptions,
) -> Tuple[FilterBank, Pose, torch.Tensor, torch.Tensor]:
    """One filter step for one drone -> (bank, filtered pose, gate
    distance, rejected flag)."""
    one = FilterBank(*(t[drone:drone + 1] for t in bank))
    new, pose, dist, rej = update_all(
        one, z[None], cov_center[None],
        rmse.to(z.dtype).reshape(1), available.reshape(1), opts)
    merged = []
    for full, part in zip(bank, new):
        full = full.clone()
        full[drone] = part[0]
        merged.append(full)
    return (FilterBank(*merged), Pose(R=pose.R[0], C=pose.C[0]), dist[0],
            rej[0])
