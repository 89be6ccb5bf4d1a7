"""Batched fixed-shape RANSAC (counterpart of coloc_tpu.ransac).

Reference parity: OpenMVG ACRANSAC as driven by RobustMatcher.hpp and
Localizer.hpp. All B minimal sets are drawn at once, the batched minimal
solver may emit several models per sample, and every model is scored
against every correspondence.

Scoring: "nfa" (the default of RansacOptions) is a-contrario ACRANSAC with
a fully adaptive threshold. Models are pre-ranked by the threshold-ladder
rank (`rank_fn`, the fused kernel of ops/ransac_rank.py) and the exact NFA
runs on the top _NFA_CANDIDATES only. "count" is the fixed-threshold form.
Both apply the `inliers >= inlier_multiple x sample_size` gate.

Sampling: Floyd's algorithm without replacement over the valid entries,
from uniforms drawn with an explicit torch.Generator, or handed in
(`uniforms`: a captured frame step draws them outside its graph). torch
cannot replay jax.random's stream, so `ransac(..., sample_idx=...)` takes
injected (B, S) minimal-sample indices instead (how the parity tests
replay coloc_tpu's draws).

Drone axis: with valid (D, M) every function runs D problems at once, each
with its own valid set, NFA top-k and adaptive threshold (coloc_tpu vmaps
the one-problem form); the (M,) form is the D = 1 case.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from coloc_tpu_torch.ops import dispatch

# exact-NFA evaluations per call, pre-ranked by the ladder
_NFA_CANDIDATES = 32
# ladder rungs threshold * 4^j for j in [LADDER_JMAX - LADDER_RUNGS + 1,
# LADDER_JMAX]; ops/ransac_rank.py reads these same constants
LADDER_JMAX = 2
LADDER_RUNGS = 5


class RansacResult(NamedTuple):
    model: torch.Tensor         # best model parameters
    inliers: torch.Tensor       # (M,) bool
    n_inliers: torch.Tensor     # () int32
    success: torch.Tensor       # () bool
    threshold_sq: torch.Tensor  # () f32 squared inlier threshold used


def nfa_scores(res_sq: torch.Tensor, valid: torch.Tensor, sample_size: int,
               log_alpha0, error_dim: float = 1.0,
               max_threshold_sq: float = float("inf")
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched a-contrario NFA (OpenMVG ACRANSAC semantics). For each model
    over every candidate inlier count k in (S, n]:
      log10 NFA(k) = log10(n-S) + logC(n,k) + logC(k,S)
                     + (k-S) (log_alpha0 + dim log10(e_k)),
    e_k the k-th smallest residual. res_sq (..., Hm, M), valid (..., M),
    log_alpha0 broadcasting against (..., Hm, M). Returns (min_k log NFA
    (..., Hm), threshold_sq at the argmin (..., Hm))."""
    M = res_sq.shape[-1]
    S = sample_size
    dev = res_sq.device
    nf = valid.to(torch.int32).sum(dim=-1, keepdim=True).to(torch.float32)  # (..., 1)

    masked = torch.where(valid[..., None, :], res_sq, float("inf"))
    masked = torch.where(masked <= max_threshold_sq, masked, float("inf"))
    sorted_sq = torch.sort(masked, dim=-1).values              # (..., Hm, M)

    ks = torch.arange(1, M + 1, dtype=torch.float32, device=dev)
    ln10 = torch.log(dispatch.constant(10.0, dev))
    lgam = torch.lgamma
    lgam_s1 = lgam(dispatch.constant(float(S) + 1.0, dev))
    logC_n_k = (lgam(nf + 1) - lgam(ks + 1)
                - lgam(torch.clamp(nf - ks + 1, min=1.0))) / ln10   # (..., M)
    logC_k_S = (lgam(ks + 1) - lgam_s1
                - lgam(torch.clamp(ks - S + 1, min=1.0))) / ln10

    log_e = 0.5 * torch.log10(torch.clamp(sorted_sq, min=1e-20))
    log_nfa = (
        torch.log10(torch.clamp(nf - S, min=1.0))[..., None]
        + logC_n_k[..., None, :]
        + logC_k_S
        + (ks - S) * (log_alpha0 + error_dim * log_e)
    )
    k_ok = (ks > S) & (ks <= nf[..., None]) & torch.isfinite(sorted_sq)
    log_nfa = torch.where(k_ok, log_nfa, float("inf"))

    best_k = torch.argmin(log_nfa, dim=-1, keepdim=True)       # (..., Hm, 1)
    score = torch.gather(log_nfa, -1, best_k)[..., 0]
    thr_sq = torch.gather(sorted_sq, -1, best_k)[..., 0]
    return score, thr_sq


def _distinct_positions(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Floyd's algorithm, per row: S distinct uniform positions in [0, n)
    from S uniforms. u (..., B, S), n (...) -> (..., B, S) int64."""
    S = u.shape[-1]
    n = n[..., None]
    nf = torch.clamp(n, min=S).to(torch.int64)  # n < S: distinct impossible
    picks = []
    for j in range(S):
        m = nf - S + j + 1  # draw t in [0, m)
        t = torch.floor(u[..., j] * m.to(torch.float32)).to(torch.int64)
        t = torch.minimum(torch.clamp(t, min=0), m - 1)
        if j > 0:
            collide = (torch.stack(picks, dim=-1) == t[..., None]).any(dim=-1)
            t = torch.where(collide, nf - S + j, t)
        picks.append(t)
    # n < S: clamp into range (such a bank can never pass the inlier gate)
    hi = torch.clamp(n.to(torch.int64) - 1, min=0)[..., None]
    return torch.minimum(torch.clamp(torch.stack(picks, dim=-1), min=0), hi)


def _pack_valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Stable index order with valid entries first (two cumsums + one
    scatter, the reference's argsort-free form), per row of (..., n)."""
    n = valid.shape[-1]
    v = valid.to(torch.int64)
    pos_valid = torch.cumsum(v, -1) - 1
    n_valid = pos_valid[..., -1:] + 1
    pos_invalid = n_valid + torch.cumsum(1 - v, -1) - 1
    tgt = torch.where(valid, pos_valid, pos_invalid)
    src = torch.arange(n, device=valid.device).expand(valid.shape)
    return torch.empty_like(tgt).scatter_(-1, tgt, src)


def sample_indices(valid: torch.Tensor, num_samples: int, sample_size: int,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., B, S) indices drawn without replacement from the valid entries
    of each row of valid (..., M): Floyd's algorithm on `uniforms` (...,
    B, S) in [0, 1), or on uniforms drawn from `generator` when None."""
    lead = tuple(valid.shape[:-1])
    order = _pack_valid_first(valid)
    n_valid = valid.to(torch.int64).sum(dim=-1)
    if uniforms is None:
        uniforms = torch.rand(lead + (num_samples, sample_size), generator=generator,
                              device=valid.device)
    pos = _distinct_positions(uniforms, n_valid)
    return torch.gather(order, -1, pos.reshape(lead + (-1,))).reshape(pos.shape)


def _one_drone(fn):
    """A callable of the drone-axis contract from one of the one-problem
    contract: drop the (size 1) drone axis of every argument, add it to
    the result."""
    if fn is None:
        return None
    return lambda *args: fn(*(a[0] for a in args))[None]


def ransac(
    data: Tuple[torch.Tensor, ...],
    valid: torch.Tensor,
    batch_solver: Callable,   # (gathered (N, S, ...) each) -> (models (N, H, ...), valid (N, H))
    scorer: Callable,         # (model (D, ...), *data) -> (D, M) squared residuals
    batch_scorer: Callable,   # (models (D, Hm, ...), *data) -> (D, Hm, M)
    sample_size: int,
    num_hypotheses: int,
    threshold_sq: float,
    inlier_multiple: float = 2.5,
    scoring: str = "count",   # "count" | "nfa"
    log_alpha0=0.0,           # only for scoring="nfa": a number, or (D, 1, 1)
    error_dim: float = 1.0,   # only for scoring="nfa"
    rank_fn: Optional[Callable] = None,  # nfa: (models (D, Hm, ...), valid, *data) -> (D, Hm)
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,  # injected (D, B, S) draws
    uniforms: Optional[torch.Tensor] = None,    # (D, B, S) uniforms to draw with
) -> RansacResult:
    """Generic batched RANSAC over tensor-valued models, for D problems at
    once: data (D, M, ...) each, valid (D, M); the result has a leading
    drone axis. With valid (M,) it is the one-problem call, and the
    callables take and return no drone axis (scorer (model, *data) -> (M,),
    batch_scorer -> (Hm, M), rank_fn -> (Hm,)).

    scoring="nfa" ranks models by the fused ladder `rank_fn`, takes the top
    _NFA_CANDIDATES in rank order (ties to the lower index, as lax.top_k),
    and picks the one of least NFA; its adaptive threshold classifies the
    inliers. `threshold_sq` only seeds the ladder there."""
    if valid.dim() == 1:
        res = ransac(tuple(d[None] for d in data), valid[None], batch_solver,
                     _one_drone(scorer), _one_drone(batch_scorer), sample_size,
                     num_hypotheses, threshold_sq, inlier_multiple, scoring,
                     log_alpha0, error_dim, _one_drone(rank_fn), generator,
                     None if sample_idx is None else sample_idx[None],
                     None if uniforms is None else uniforms[None])
        return RansacResult(*(t[0] for t in res))
    D = valid.shape[0]
    dev = valid.device
    if sample_idx is None:
        idx = sample_indices(valid, num_hypotheses, sample_size, generator, uniforms)
    else:
        idx = sample_idx.to(device=dev, dtype=torch.int64)
    B = idx.shape[1]
    rows = torch.arange(D, device=dev)
    gathered = tuple(d[rows[:, None, None], idx] for d in data)      # (D, B, S, ...)
    models, model_valid = batch_solver(
        *(g.reshape((D * B,) + tuple(g.shape[2:])) for g in gathered))
    flat_models = models.reshape((D, -1) + tuple(models.shape[2:]))  # (D, Hm, ...)
    flat_valid = model_valid.reshape(D, -1)
    gate = int(inlier_multiple * sample_size)

    if scoring == "nfa":
        if rank_fn is None:
            raise ValueError('scoring="nfa" needs rank_fn')
        rank = rank_fn(flat_models, valid, *data)
        rank = torch.where(flat_valid, rank, -1.0)
        k_nfa = min(_NFA_CANDIDATES, rank.shape[1])
        cand = torch.sort(rank, dim=1, descending=True, stable=True).indices[:, :k_nfa]
        cand_res = batch_scorer(flat_models[rows[:, None], cand], *data)
        score, thr = nfa_scores(cand_res, valid, sample_size, log_alpha0,
                                error_dim)
        score = torch.where(torch.gather(flat_valid, 1, cand), score, float("inf"))
        best_sub = torch.argmin(score, dim=1, keepdim=True)          # (D, 1)
        best_model = flat_models[rows, torch.gather(cand, 1, best_sub)[:, 0]]
        thr_best = torch.gather(thr, 1, best_sub)[:, 0]
        res = scorer(best_model, *data)
        inliers = (res <= thr_best[:, None]) & valid
        n_inl = inliers.sum(dim=1, dtype=torch.int32)
        success = (torch.gather(score, 1, best_sub)[:, 0] < 0.0) & (n_inl >= gate)  # NFA < 1
        return RansacResult(model=best_model, inliers=inliers, n_inliers=n_inl,
                            success=success, threshold_sq=thr_best)

    all_res = batch_scorer(flat_models, *data)
    counts = ((all_res < threshold_sq) & valid[:, None, :]).to(torch.int32).sum(dim=2)
    counts = torch.where(flat_valid, counts, -1)
    best_model = flat_models[rows, torch.argmax(counts, dim=1)]
    res = scorer(best_model, *data)
    inliers = (res < threshold_sq) & valid
    n_inl = inliers.sum(dim=1, dtype=torch.int32)
    return RansacResult(
        model=best_model, inliers=inliers, n_inliers=n_inl,
        success=n_inl >= gate,
        threshold_sq=dispatch.constant(float(threshold_sq), dev).expand(D))
