"""Fused RANSAC pre-ranks: P3P / epipolar residual + threshold-ladder count
(counterpart of coloc_tpu.ops.ransac_rank).

The NFA pre-rank (ransac.py, scoring="nfa") needs per candidate model only
a scalar: the number of ladder rungs thr * 4^j, j in [jmax - n_rungs + 1,
jmax], that each valid correspondence's residual clears, summed. The
kernel computes it without materializing the (Hm, M) residual matrix, in
product form (no division):
  err < thr 4^j  <=>  (u^2 + v^2) < (thr 4^j) zc^2.

  ladder_rank        — the CUDA kernel csrc/ransac_rank.cu on a CUDA tensor,
                       ladder_rank_plain on CPU; operands with a leading
                       drone axis are one launch (the grid's z)
  ladder_rank_plain  — the kernel's plain twin, (Hm, M) planes in memory
  p3p_ladder_rank    — the P3P entry (zmode "pos"): folds focal into the model
                       and observation operands, then ladder_rank
  homography_ladder_rank — the H entry (zmode "nonzero"): the projective
                       planes [f H0; f H1; H2 | 0] as the camera rows and
                       [x1; 1; 0] as [X; -1], then ladder_rank
  epi_rank           — the CUDA kernel csrc/epi_rank.cu on a CUDA tensor,
                       epi_rank_plain on CPU (symmetric epipolar distance)
  epipolar_ladder_rank — the E/F entry: (Hm, 27) model and (27, M) data
                       operands with the focal scales folded in, then epi_rank

zmode "pos" (P3P reprojection): Z <= 0 counts 0, the denominator clamps at
1e-9. zmode "nonzero" (homography transfer): |Z| < 1e-9 counts 0.
"""

from __future__ import annotations

import torch

from coloc_tpu_torch.ops import _build, dispatch
# the ladder's shape has ONE source of truth, as in coloc_tpu
from coloc_tpu_torch.ransac import LADDER_JMAX, LADDER_RUNGS

_ZMODES = {"pos": 0, "nonzero": 1}


def ladder_rank_plain(eflat: torch.Tensor, xh: torch.Tensor, obs: torch.Tensor,
                      maskf: torch.Tensor, thr_sq: float, zmode: str = "pos",
                      jmax: int = LADDER_JMAX,
                      n_rungs: int = LADDER_RUNGS) -> torch.Tensor:
    """Plain twin of csrc/ransac_rank.cu: eflat (Hm,12), xh (4,M), obs (2,M),
    maskf (M,) -> (Hm,) float32; with a leading drone axis on every operand,
    (D, Hm)."""

    def plane(c0):
        acc = eflat[..., :, c0:c0 + 1] * xh[..., 0:1, :]
        for k in range(1, 4):
            acc = acc + eflat[..., :, c0 + k:c0 + k + 1] * xh[..., k:k + 1, :]
        return acc                                    # (..., Hm, M)

    A0, A1, Z = plane(0), plane(4), plane(8)
    u = A0 - obs[..., 0:1, :] * Z
    v = A1 - obs[..., 1:2, :] * Z
    s = u * u + v * v
    msk = maskf[..., None, :]
    if zmode == "pos":
        zc = torch.clamp(Z, min=1e-9)
        t0 = zc * zc
        alive = torch.where(Z > 0, msk, 0.0)
    elif zmode == "nonzero":
        t0 = Z * Z
        alive = torch.where(Z.abs() >= 1e-9, msk, 0.0)
    else:
        raise ValueError(f"zmode must be one of {sorted(_ZMODES)}: {zmode!r}")
    cnt = torch.zeros_like(s)
    for j in range(jmax - n_rungs + 1, jmax + 1):
        cnt = cnt + torch.where(s < (thr_sq * 4.0 ** j) * t0, 1.0, 0.0)
    return (cnt * alive).sum(dim=-1)


def _ladder_rank_cuda(eflat, xh, obs, maskf, thr_sq, zmode, jmax, n_rungs):
    """One launch: coloc_ransac_rank for (Hm, 12) models, or
    coloc_ransac_rank_batched for a leading drone axis (D, Hm, 12)."""
    dev = eflat.device
    lead = tuple(eflat.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"eflat: at most one drone axis, got {tuple(eflat.shape)}")
    Hm, M = eflat.shape[-2], xh.shape[-1]
    dispatch.check_operand(eflat, "eflat", torch.float32, lead + (Hm, 12), dev)
    dispatch.check_operand(xh, "xh", torch.float32, lead + (4, M), dev)
    dispatch.check_operand(obs, "obs", torch.float32, lead + (2, M), dev)
    dispatch.check_operand(maskf, "maskf", torch.float32, lead + (M,), dev)
    rank = torch.empty(lead + (Hm,), dtype=torch.float32, device=dev)
    tail = (float(thr_sq), jmax - n_rungs + 1, n_rungs, _ZMODES[zmode], dev.index,
            dispatch.stream_handle(dev))
    ptrs = (eflat.data_ptr(), xh.data_ptr(), obs.data_ptr(), maskf.data_ptr(),
            rank.data_ptr())
    if lead:
        _build.launch("coloc_ransac_rank_batched", *ptrs, lead[0], Hm, M, *tail)
    else:
        _build.launch("coloc_ransac_rank", *ptrs, Hm, M, *tail)
    dispatch.count_launch("ransac_rank")
    return rank


def ladder_rank(eflat, xh, obs, maskf, thr_sq: float, zmode: str = "pos",
                jmax: int = LADDER_JMAX, n_rungs: int = LADDER_RUNGS):
    """(Hm,) float32 ladder rank per model (higher = better candidate), or
    (D, Hm) for operands with a leading drone axis."""
    if zmode not in _ZMODES:
        raise ValueError(f"zmode must be one of {sorted(_ZMODES)}: {zmode!r}")
    if dispatch.use_kernel(eflat):
        return _ladder_rank_cuda(eflat.contiguous(), xh.contiguous(),
                                 obs.contiguous(), maskf.contiguous(),
                                 thr_sq, zmode, jmax, n_rungs)
    return ladder_rank_plain(eflat, xh, obs, maskf, thr_sq, zmode, jmax,
                             n_rungs)


def p3p_operands(flats, Xw, bearings, valid, focal):
    """The rank's operands for P3P models: (eflat (Hm,12), xh (4,M),
    obs (2,M), maskf (M,)), focal folded into the x/y model rows and the
    observations (u = f A0 - (f ox) Z). With a leading drone axis (flats
    (D, Hm, 12), Xw and bearings (D, M, 3), valid (D, M), focal (D, 1))
    each operand gains it. `focal` is a tensor or a number."""
    lead = tuple(flats.shape[:-2])
    Hm = flats.shape[-2]
    R = flats[..., :9].reshape(lead + (Hm, 3, 3))
    C = flats[..., 9:]
    t = torch.einsum("...mkd,...md->...mk", R, C)        # (..., Hm, 3) = R_m C_m
    E = torch.cat([R, t[..., None]], dim=-1)             # (..., Hm, 3, 4)
    if not isinstance(focal, torch.Tensor):
        focal = dispatch.constant(float(focal), flats.device)
    f = focal.to(torch.float32)
    E = E * torch.stack([f, f, torch.ones_like(f)], dim=-1)[..., None]
    eflat = E.reshape(lead + (Hm, 12))
    obs = bearings[..., :2] / torch.clamp(bearings[..., 2:3], min=1e-9)
    obs = (obs * f[..., None]).transpose(-1, -2)         # (..., 2, M)
    xh = torch.cat([Xw, -torch.ones_like(Xw[..., :1])], dim=-1).transpose(-1, -2)
    return eflat, xh, obs, valid.to(torch.float32)


def p3p_ladder_rank(flats, Xw, bearings, valid, focal, thr_sq: float,
                    jmax: int = LADDER_JMAX,
                    n_rungs: int = LADDER_RUNGS) -> torch.Tensor:
    """flats (Hm,12) R | C, Xw (M,3), bearings (M,3), valid (M,) bool ->
    (Hm,) float32 ladder rank; (D, Hm) with a leading drone axis."""
    eflat, xh, obs, maskf = p3p_operands(flats, Xw, bearings, valid, focal)
    return ladder_rank(eflat, xh, obs, maskf, thr_sq, "pos", jmax, n_rungs)


def homography_ladder_rank(Hs, x1, x2, valid, focal, thr_sq: float,
                           jmax: int = LADDER_JMAX,
                           n_rungs: int = LADDER_RUNGS) -> torch.Tensor:
    """Hs (Hm, 3, 3), x1/x2 (M, 2) normalized coords, valid (M,) bool,
    image 2's focal -> (Hm,) float32 ladder rank of the forward transfer
    error f^2 ||x2 - pi(H h1)||^2 (|w| < 1e-9 counts 0)."""
    Hm = Hs.shape[0]
    if not isinstance(focal, torch.Tensor):
        focal = dispatch.constant(float(focal), Hs.device)
    f = focal.to(torch.float32)
    scale = torch.stack([f, f, torch.ones_like(f)])[:, None]          # (3, 1)
    E = torch.cat([Hs * scale, torch.zeros_like(Hs[..., :1])], dim=-1)  # (Hm, 3, 4)
    xh = torch.cat([x1, torch.ones_like(x1[:, :1]), torch.zeros_like(x1[:, :1])],
                   dim=-1).T                                          # (4, M)
    return ladder_rank(E.reshape(Hm, 12), xh, (x2 * f).T, valid.to(torch.float32),
                       thr_sq, "nonzero", jmax, n_rungs)


# ---------------------------------------------------------------------------
# Epipolar (essential/fundamental) ladder rank
# ---------------------------------------------------------------------------
#
# The product form of the symmetric epipolar gate (dens clamped at 0):
#   err = num (s2 den1' + s1 den2') / (den1' den2') < thr 4^j
#   <=>  num (den1 + den2) < (thr / (s1 s2)) 4^j den1 den2
# with den1 = s2 den1', den2 = s1 den2' pre-scaled into the data operand, so
# the rung scale c = thr / (s1 s2) is the one scalar the kernel reads. Counts
# equal the division-form ladder except at f32 rounding of exact rung ties.

def epi_rank_plain(emat: torch.Tensor, dmat: torch.Tensor, maskf: torch.Tensor,
                   c: torch.Tensor, jmax: int = LADDER_JMAX,
                   n_rungs: int = LADDER_RUNGS) -> torch.Tensor:
    """Plain twin of csrc/epi_rank.cu: emat (Hm, 27), dmat (27, M), maskf
    (M,), c (1,) -> (Hm,) float32."""

    def contract(c0):
        acc = emat[:, c0:c0 + 1] * dmat[c0:c0 + 1, :]
        for k in range(1, 9):
            acc = acc + emat[:, c0 + k:c0 + k + 1] * dmat[c0 + k:c0 + k + 1, :]
        return acc                                    # (Hm, M)

    A = contract(0)
    den2 = torch.clamp(contract(9), min=0.0)
    den1 = torch.clamp(contract(18), min=0.0)
    num = A * A
    lhs = num * (den1 + den2)
    rhs = den1 * den2
    cnt = torch.zeros_like(lhs)
    for j in range(jmax - n_rungs + 1, jmax + 1):
        cnt = cnt + torch.where(lhs < (c * 4.0 ** j) * rhs, 1.0, 0.0)
    return (cnt * maskf[None, :]).sum(dim=1)


def _epi_rank_cuda(emat, dmat, maskf, c, jmax, n_rungs):
    dev = emat.device
    Hm, M = emat.shape[0], dmat.shape[1]
    dispatch.check_operand(emat, "emat", torch.float32, (Hm, 27), dev)
    dispatch.check_operand(dmat, "dmat", torch.float32, (27, M), dev)
    dispatch.check_operand(maskf, "maskf", torch.float32, (M,), dev)
    dispatch.check_operand(c, "c", torch.float32, (1,), dev)
    rank = torch.empty(Hm, dtype=torch.float32, device=dev)
    _build.launch(
        "coloc_epi_rank", emat.data_ptr(), dmat.data_ptr(), maskf.data_ptr(),
        c.data_ptr(), rank.data_ptr(), Hm, M, jmax - n_rungs + 1, n_rungs,
        dev.index, dispatch.stream_handle(dev))
    dispatch.count_launch("epi_rank")
    return rank


def epi_rank(emat, dmat, maskf, c, jmax: int = LADDER_JMAX,
             n_rungs: int = LADDER_RUNGS) -> torch.Tensor:
    """(Hm,) float32 epipolar ladder rank per model."""
    if dispatch.use_kernel(emat):
        return _epi_rank_cuda(emat.contiguous(), dmat.contiguous(),
                              maskf.contiguous(), c.contiguous(), jmax, n_rungs)
    return epi_rank_plain(emat, dmat, maskf, c, jmax, n_rungs)


def epipolar_operands(Es, x1, x2, valid, s1_sq, s2_sq, thr_sq: float):
    """The rank's operands for E/F models: (emat (Hm, 27) = [vec E | vec S1 |
    vec S2], dmat (27, M) = [h2 (x) h1 | s1 h1 (x) h1 | s2 h2 (x) h2],
    maskf (M,), c (1,) = thr / (s1 s2))."""
    Hm, M = Es.shape[0], x1.shape[0]
    rows = Es[:, :2, :]
    S1 = torch.einsum("had,hak->hdk", rows, rows).reshape(Hm, 9)
    cols = Es[:, :, :2]
    S2 = torch.einsum("hda,hka->hdk", cols, cols).reshape(Hm, 9)
    emat = torch.cat([Es.reshape(Hm, 9), S1, S2], dim=1)
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1)
    h2 = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=-1)
    O = (h2[:, :, None] * h1[:, None, :]).reshape(M, 9)
    P1 = (h1[:, :, None] * h1[:, None, :]).reshape(M, 9)
    P2 = (h2[:, :, None] * h2[:, None, :]).reshape(M, 9)
    s1f, s2f = (s if isinstance(s, torch.Tensor)
                else dispatch.constant(float(s), Es.device) for s in (s1_sq, s2_sq))
    s1f, s2f = s1f.to(torch.float32), s2f.to(torch.float32)
    dmat = torch.cat([O, s1f * P1, s2f * P2], dim=1).T
    c = (dispatch.constant(float(thr_sq), Es.device)
         / torch.clamp(s1f * s2f, min=1e-20)).reshape(1)
    return emat, dmat, valid.to(torch.float32), c


def epipolar_ladder_rank(Es, x1, x2, valid, s1_sq, s2_sq, thr_sq: float,
                         jmax: int = LADDER_JMAX,
                         n_rungs: int = LADDER_RUNGS) -> torch.Tensor:
    """Es (Hm, 3, 3), x1/x2 (M, 2) normalised coords, valid (M,) bool, the
    squared focal scales of each image -> (Hm,) float32 ladder rank."""
    emat, dmat, maskf, c = epipolar_operands(Es, x1, x2, valid, s1_sq, s2_sq,
                                             thr_sq)
    return epi_rank(emat, dmat, maskf, c, jmax, n_rungs)
