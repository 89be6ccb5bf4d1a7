"""Map-alignment utilities (counterpart of coloc_tpu.utils).

Reference parity: colocUtils.hpp —
  computeScaleDifference (:184-211): mean over CONSECUTIVE common-feature
    pairs of the inter-landmark distance ratio between two maps (monocular
    scale alignment between independently built maps).
  rescaleMap (:213-223): scale landmark positions and pose centres.
  handlePairs (:58-61): exhaustive pair enumeration.
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Tuple

import numpy as np
import torch

from coloc_tpu_torch import matching, metrics
from coloc_tpu_torch.geometry.essential import hat3
from coloc_tpu_torch.types import MapDB, Matches


def exhaustive_pairs(n: int) -> List[Tuple[int, int]]:
    """handlePairs parity: all (i, j) with i < j."""
    return list(combinations(range(n), 2))


def compute_scale_difference(map_a: MapDB, map_b: MapDB, matches: Matches
                             ) -> torch.Tensor:
    """Scale of map_a relative to map_b from common landmarks, () float32.

    The reference's estimator: the ratio of distances between CONSECUTIVE
    matched landmark pairs, averaged (colocUtils.hpp:193-209). Masked and
    fixed-shape; 1.0 when no pair qualifies (the reference returns 1.0 when
    there is no common feature, :186-189). An unmatched slot (idx -1) reads
    map_b's last row, as coloc_tpu's indexing does; the mask drops it."""
    mask = matches.mask & map_a.valid
    Xa = map_a.X
    Xb = map_b.X[matches.idx.long()]

    # consecutive valid pairs: valid entries compressed to the front in slot
    # order (a stable sort, as jnp.argsort is)
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    Xa_s, Xb_s, m_s = Xa[order], Xb[order], mask[order]

    d_a = torch.linalg.norm(Xa_s[1:] - Xa_s[:-1], dim=1)
    d_b = torch.linalg.norm(Xb_s[1:] - Xb_s[:-1], dim=1)
    pair_ok = m_s[1:] & m_s[:-1] & (d_b > 1e-9)
    ratios = torch.where(pair_ok, d_a / torch.clamp(d_b, min=1e-9), 0.0)
    n = pair_ok.to(torch.float32).sum()
    scale = ratios.sum() / torch.clamp(n, min=1.0)
    return torch.where(n >= 1.0, scale, 1.0)


def rescale_map(X: torch.Tensor, Cs: torch.Tensor, scale
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rescaleMap parity: landmarks and camera centres scaled by `scale`."""
    return X * scale, Cs * scale


def align_maps(map_a: MapDB, map_b: MapDB, opts, min_matches: int = 12):
    """Sim(3) alignment of map_b into map_a's world frame from map-to-map
    descriptor matches: (s, R, t, n_inliers, matched_b) with
    X_a ~= s R X_b + t, or None when fewer than `min_matches` common
    landmarks survive.

    The matched 3D-3D landmark pairs are fit with the Umeyama closed-form
    similarity; one reweighting round drops pairs whose residual exceeds 3x
    the median (a wrong descriptor match is a 3D outlier). Host-side numpy
    after the match, as in coloc_tpu. `matched_b` marks map_b entries
    consumed by a match (duplicates of map_a landmarks)."""
    m = matching.match_maps(map_a, map_b, opts)
    idx = m.idx.cpu().numpy()
    vb = map_b.valid.cpu().numpy()
    safe = np.clip(idx, 0, vb.size - 1)
    ok = m.mask.cpu().numpy() & map_a.valid.cpu().numpy() & vb[safe]
    if int(ok.sum()) < min_matches:
        return None
    Xa = map_a.X.cpu().numpy()[ok]
    Xb = map_b.X.cpu().numpy()[safe[ok]]
    s, R, t = metrics.umeyama_alignment(Xb, Xa, with_scale=True)
    res = np.linalg.norm((s * (R @ Xb.T)).T + t - Xa, axis=1)
    keep = res <= 3.0 * max(float(np.median(res)), 1e-9)
    if int(keep.sum()) >= min_matches and not keep.all():
        s, R, t = metrics.umeyama_alignment(Xb[keep], Xa[keep], with_scale=True)
    matched_b = np.zeros(vb.size, bool)
    matched_b[safe[ok]] = True
    return s, R, t, int(keep.sum()), matched_b


def guided_match_residuals(
    K1: torch.Tensor,          # (3, 3) intrinsics of map A's anchor view
    K2: torch.Tensor,          # (3, 3) intrinsics of map B's anchor view
    R_diff: torch.Tensor,      # (3, 3) known relative rotation between maps
    t_diff: torch.Tensor,      # (3,) known relative translation
    uv1: torch.Tensor,         # (M, 2) map-A observation pixels
    uv2: torch.Tensor,         # (M, 2) matched map-B observation pixels
    mask: torch.Tensor,        # (M,) bool
) -> torch.Tensor:
    """Epipolar residuals |x2^T F x1| of map-to-map matches under a KNOWN
    relative pose, F = K2^-T [t]_x R K1^-1 (RobustMatcher::matchMaps
    parity, :241-370, :318-328); 0 where `mask` is False. The reference
    logs them (guidedmatches2.txt) and passes every match through."""
    inv = lambda K: torch.linalg.inv_ex(K).inverse  # noqa: E731
    F = inv(K2).T @ hat3(t_diff) @ R_diff @ inv(K1)
    h1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    h2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=-1)
    res = (h2 * (h1 @ F.T)).sum(dim=-1).abs()
    return torch.where(mask, res, 0.0)
