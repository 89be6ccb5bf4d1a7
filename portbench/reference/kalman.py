"""The drones' pose filter, one per drone: state (x, y, z, bank, attitude,
heading), constant position, process noise q I, measurement noise m I
with its angle block the localization's centre covariance times its
rmse, P0 = p0 I; an update whose gate distance innv^T S innv passes the
chi-square gate is dropped once the drone has had five updates; angle
innovations wrap to (-pi, pi]."""

from __future__ import annotations

import math

import torch

from portbench.reference import geometry

WARMUP = 5


def run(z, cov3, rmse, ok, opts: dict):
    """Measurements of N steps of D drones: z (N, D, 6), cov3 (N, D, 3, 3),
    rmse (N, D), ok (N, D) bool -> the filtered poses R (N, D, 3, 3), C
    (N, D, 3) after each step."""
    N, D = z.shape[:2]
    dt, dev = z.dtype, z.device
    eye = torch.eye(6, dtype=dt, device=dev)
    x = torch.zeros((D, 6), dtype=dt, device=dev)
    P = (eye * opts["initial_covariance"]).expand(D, 6, 6).clone()
    n_used = torch.zeros(D, dtype=torch.long, device=dev)
    Rs, Cs = [], []
    for i in range(N):
        Pp = P + eye * opts["process_noise"]
        Rm = (eye * opts["measurement_noise"]).expand(D, 6, 6).clone()
        Rm[:, 3:, 3:] = cov3[i] * rmse[i][:, None, None]
        innv = z[i] - x
        ang = torch.remainder(innv[:, 3:] + math.pi, 2 * math.pi) - math.pi
        innv = torch.cat([innv[:, :3], ang], -1)
        S = Pp + Rm
        gate = torch.einsum("di,dij,dj->d", innv, S, innv)
        use = ok[i] & ~((gate > opts["chi2_gate"]) & (n_used >= WARMUP))
        Kg = Pp @ torch.linalg.inv(S)
        xn = x + torch.einsum("dij,dj->di", Kg, innv)
        Pn = (eye - Kg) @ Pp
        x = torch.where(use[:, None], xn, x)
        P = torch.where(use[:, None, None], Pn, Pp)
        n_used = n_used + use.long()
        Rs.append(geometry.rot_of(x[:, 3:]))
        Cs.append(x[:, :3])
    return torch.stack(Rs), torch.stack(Cs)
