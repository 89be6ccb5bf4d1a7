"""Homography estimation, Euclidean decomposition and the chirality test
(counterpart of coloc_tpu.geometry.homography).

Reference parity: RobustMatcher.hpp model 'H' — the 4-point DLT kernel
(:191-206), OpenCV decomposeHomographyMat (:106-126) and
performChiralityTest (:39-104): each motion candidate votes with the
matches it puts in front of both cameras, and the best is accepted only
if second / best < 0.7 (:100-103).

The decomposition is coloc_tpu's Faugeras/Lustman construction from the
eigen-structure of Hn^T Hn: two rotation/normal solutions and their sign
flips, 4 motions. An eigenvector's sign is free (torch and XLA may pick
either), which permutes the 4 candidates but not the set; the vote picks
the motion. All coords are normalized (unit-focal, undistorted).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def four_point(x1: torch.Tensor, x2: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DLT homography x2 ~ H x1 from (..., N >= 4, 2) correspondences ->
    (..., 3, 3) scaled so H[2, 2] = 1; `weights` (..., N) scales each
    point's two rows by sqrt(w) (the masked least-squares re-fit)."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    if weights is not None:
        sw = torch.sqrt(weights)[..., None]
        r1, r2 = r1 * sw, r2 * sw
    A = torch.cat([r1, r2], dim=-2)                        # (..., 2N, 9)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    H = vecs[..., :, 0].reshape(A.shape[:-2] + (3, 3))
    h22 = H[..., 2:3, 2:3]
    return H / (h22 + torch.where(h22.abs() < 1e-12, 1e-12, 0.0))


def transfer_error_sq(H: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """Forward transfer error ||x2 - pi(H x1)||^2, (M,); 1e12 where the
    projective coordinate |w| < 1e-9."""
    p = _homog(x1) @ H.T
    w = p[:, 2]
    bad = w.abs() < 1e-9
    proj = p[:, :2] / torch.where(bad, 1.0, w)[:, None]
    err = ((proj - x2) ** 2).sum(dim=-1)
    return torch.where(bad, 1e12, err)


def transfer_error_sq_batch(Hs: torch.Tensor, x1: torch.Tensor,
                            x2: torch.Tensor) -> torch.Tensor:
    """All models at once, (Hm, M), in the division-cleared form
    ((u - x2x w)^2 + (v - x2y w)^2) / w^2 with [u, v, w] = H h1: one
    (Hm, 3) x (3, M) product a projective plane."""
    h1t = _homog(x1).T                                      # (3, M)
    U = Hs[:, 0] @ h1t
    V = Hs[:, 1] @ h1t
    W = Hs[:, 2] @ h1t
    bad = W.abs() < 1e-9
    Wc = torch.where(bad, 1.0, W)
    du = U - x2[:, 0][None, :] * W
    dv = V - x2[:, 1][None, :] * W
    return torch.where(bad, 1e12, (du * du + dv * dv) / (Wc * Wc))


def decompose_homography(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                         mask: torch.Tensor, chirality_ratio: float = 0.7
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Calibrated H -> (R, unit t, n, chirality_ok): the motion of most
    votes among the 4 candidates, ok iff the runner-up has fewer than
    `chirality_ratio` of its votes (ties to the lower candidate, a stable
    sort as coloc_tpu's)."""
    h1, h2 = _homog(x1), _homog(x2)
    # the overall sign so x2^T H x1 > 0 over the masked majority
    s = ((h2 * (h1 @ H.T)).sum(dim=-1) * mask).sum()
    H = H * torch.where(s < 0, -1.0, 1.0)
    sv = torch.linalg.svdvals(H)
    Hn = H / torch.clamp(sv[1], min=1e-12)
    evals, evecs = torch.linalg.eigh(Hn.T @ Hn)            # ascending
    s3sq = torch.clamp(evals[0], min=1e-12)
    s1sq = torch.clamp(evals[2], min=1e-12)
    v1, v2, v3 = evecs[:, 2], evecs[:, 1], evecs[:, 0]
    denom = torch.clamp(s1sq - s3sq, min=1e-12)
    a = torch.sqrt(torch.clamp(1.0 - s3sq, min=0.0) / denom)
    b = torch.sqrt(torch.clamp(s1sq - 1.0, min=0.0) / denom)

    def motion(u):
        n = torch.linalg.cross(v2, u)
        U = torch.stack([v2, u, n], dim=1)
        Hv2, Hu = Hn @ v2, Hn @ u
        Wm = torch.stack([Hv2, Hu, torch.linalg.cross(Hv2, Hu)], dim=1)
        R = Wm @ U.T
        return R, (Hn - R) @ n, n

    R1, t1, n1 = motion(a * v1 + b * v3)
    R2, t2, n2 = motion(a * v1 - b * v3)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t1, -t1, t2, -t2])
    ns = torch.stack([n1, -n1, n2, -n2])

    # closed-form two-view depths, as essential.decompose_essential
    tn = ts / (torch.linalg.norm(ts, dim=-1, keepdim=True) + 1e-12)
    Rx1 = torch.einsum("cij,mj->cmi", Rs, h1)              # (4, M, 3)
    cr = torch.linalg.cross(h2.expand_as(Rx1), Rx1)
    ct = torch.linalg.cross(h2[None].expand_as(Rx1), tn[:, None, :].expand_as(Rx1))
    z1 = -(cr * ct).sum(dim=-1) / ((cr * cr).sum(dim=-1) + 1e-12)
    z2 = (z1[..., None] * Rx1 + tn[:, None, :])[..., 2]
    votes = ((z1 > 0) & (z2 > 0) & mask[None]).to(torch.int32).sum(dim=1)
    order = torch.argsort(-votes, stable=True)
    best, second = order[0], order[1]
    ratio = votes[second].to(torch.float32) / torch.clamp(
        votes[best].to(torch.float32), min=1.0)
    t_best = ts[best] / (torch.linalg.norm(ts[best]) + 1e-12)
    return Rs[best], t_best, ns[best], ratio < chirality_ratio
