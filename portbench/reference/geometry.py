"""Localization against a map, written from its definition in plain
PyTorch: the camera (pinhole, radial k1 k2 k3), Grunert's P3P on a
quartic whose roots are eigenvalues, a-contrario RANSAC (AC-RANSAC) over
every hypothesis, the pose-only Huber refinement and its covariance, and
the rotation helpers the filter needs.

A pose is (R, C): a world point X lies at R (X - C) in the camera. The
refinement perturbs it as (exp(w) R, C + dC), and the covariance is over
(w, dC) in that order. Every function follows the dtype of its inputs:
the reference runs float64, the control float32 with TF32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SAMPLE = 3
INLIER_GATE = 7            # int(2.5 x 3): at least this many inliers
HUBER_SQ = 16.0


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    W = hat(w)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    b = torch.where(small, torch.full_like(th, 0.5), (1 - torch.cos(ths)) / ths ** 2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of R (angles below pi)."""
    c = torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1.0, 1.0)
    th = torch.acos(c)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sin(th)
    k = torch.where(s.abs() < 1e-12, torch.full_like(th, 0.5), th / (2 * s))
    return v * k[..., None]


def angle_between(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    d = torch.linalg.norm((Ra - Rb).flatten(-2), dim=-1)
    return 2 * torch.asin(torch.clamp(d / (2 * math.sqrt(2)), max=1.0))


def euler_of(R: torch.Tensor) -> torch.Tensor:
    """(bank, attitude, heading) of R, attitude = asin(R10), with the
    poles (|R10| > 0.998) taken as bank 0."""
    m10 = R[..., 1, 0]
    pole = m10.abs() > 0.998
    bank = torch.where(pole, torch.zeros_like(m10), torch.atan2(-R[..., 1, 2], R[..., 1, 1]))
    att = torch.where(pole, torch.sign(m10) * math.pi / 2, torch.asin(torch.clamp(m10, -1, 1)))
    head = torch.where(pole, torch.atan2(R[..., 0, 2], R[..., 2, 2]),
                       torch.atan2(-R[..., 2, 0], R[..., 0, 0]))
    return torch.stack([bank, att, head], -1)


def rot_of(e: torch.Tensor) -> torch.Tensor:
    """The rotation of (bank, attitude, heading): heading about y, then
    attitude about z, then bank about x."""
    b, a, h = e[..., 0], e[..., 1], e[..., 2]
    one, zero = torch.ones_like(b), torch.zeros_like(b)
    Ry = torch.stack([torch.stack([torch.cos(h), zero, torch.sin(h)], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-torch.sin(h), zero, torch.cos(h)], -1)], -2)
    Rz = torch.stack([torch.stack([torch.cos(a), -torch.sin(a), zero], -1),
                      torch.stack([torch.sin(a), torch.cos(a), zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, torch.cos(b), -torch.sin(b)], -1),
                      torch.stack([zero, torch.sin(b), torch.cos(b)], -1)], -2)
    return Ry @ Rz @ Rx


# -- the camera ----------------------------------------------------------------

def radial(dist: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """1 + k1 r^2 + k2 r^4 + k3 r^6: dist (..., 3) against r2 (..., N)."""
    k1, k2, k3 = dist[..., 0, None], dist[..., 1, None], dist[..., 2, None]
    return 1 + r2 * (k1 + r2 * (k2 + r2 * k3))


def project(K, dist, Xc):
    """Camera points (..., N, 3) -> pixels (..., N, 2); K (..., 3, 3), dist (..., 3)."""
    z = torch.clamp(Xc[..., 2:3], min=1e-9)
    p = Xc[..., :2] / z
    p = p * radial(dist, (p * p).sum(-1))[..., None]
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[..., None, :]
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], -1)[..., None, :]
    return p * f + c


def bearings(K, dist, uv):
    """Pixels (..., N, 2) -> unit rays (..., N, 3): the distortion undone
    by ten fixed-point steps."""
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[..., None, :]
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], -1)[..., None, :]
    pd = (uv - c) / f
    p = pd
    for _ in range(10):
        p = pd / radial(dist, (p * p).sum(-1))[..., None]
    ray = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# -- P3P -------------------------------------------------------------------------

def p3p(X: torch.Tensor, b: torch.Tensor):
    """Grunert: three world points X (N, 3, 3) seen along unit rays b (N,
    3, 3) -> up to four poses R (N, 4, 3, 3), C (N, 4, 3) and which are
    real (N, 4)."""
    dt = X.dtype
    a2 = ((X[:, 1] - X[:, 2]) ** 2).sum(-1)
    b2 = ((X[:, 0] - X[:, 2]) ** 2).sum(-1)
    c2 = ((X[:, 0] - X[:, 1]) ** 2).sum(-1)
    ca = (b[:, 1] * b[:, 2]).sum(-1)
    cb = (b[:, 0] * b[:, 2]).sum(-1)
    cg = (b[:, 0] * b[:, 1]).sum(-1)
    # the resultant of the two conics in (u, v) = (s2 / s1, s3 / s1)
    q4 = a2 ** 2 - 2 * a2 * b2 - 2 * a2 * c2 + b2 ** 2 - 4 * b2 * c2 * ca ** 2 + 2 * b2 * c2 + c2 ** 2
    q3 = -4 * (a2 ** 2 * cb - a2 * b2 * ca * cg - a2 * b2 * cb - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
               - 2 * b2 * c2 * ca ** 2 * cb - b2 * c2 * ca * cg + b2 * c2 * cb + c2 ** 2 * cb)
    q2 = 2 * (2 * a2 ** 2 * cb ** 2 + a2 ** 2 - 4 * a2 * b2 * ca * cb * cg - 2 * a2 * b2 * cg ** 2
              - 4 * a2 * c2 * cb ** 2 - 2 * a2 * c2 + 2 * b2 ** 2 * ca ** 2 + 2 * b2 ** 2 * cg ** 2
              - b2 ** 2 - 2 * b2 * c2 * ca ** 2 - 4 * b2 * c2 * ca * cb * cg + 2 * c2 ** 2 * cb ** 2
              + c2 ** 2)
    q1 = -4 * (a2 ** 2 * cb - a2 * b2 * ca * cg - 2 * a2 * b2 * cb * cg ** 2 + a2 * b2 * cb
               - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg - b2 * c2 * ca * cg - b2 * c2 * cb + c2 ** 2 * cb)
    q0 = a2 ** 2 - 4 * a2 * b2 * cg ** 2 + 2 * a2 * b2 - 2 * a2 * c2 + b2 ** 2 - 2 * b2 * c2 + c2 ** 2
    lead = torch.where(q4.abs() < 1e-30, torch.full_like(q4, 1e-30), q4)
    comp = torch.zeros((X.shape[0], 4, 4), dtype=dt, device=X.device)
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1
    comp[:, :, 3] = -torch.stack([q0, q1, q2, q3], -1) / lead[:, None]
    roots = torch.linalg.eigvals(comp.cpu()).to(X.device)
    tol = 1e-4 if dt == torch.float32 else 1e-7
    v = roots.real.to(dt)
    real = roots.imag.abs().to(dt) <= tol * torch.clamp(v.abs(), min=1.0)
    a2_, b2_, c2_ = a2[:, None], b2[:, None], c2[:, None]
    ca_, cb_, cg_ = ca[:, None], cb[:, None], cg[:, None]
    den = 2 * b2_ * (ca_ * v - cg_)
    u = (2 * a2_ * cb_ * v - a2_ * v ** 2 - a2_ + b2_ * v ** 2 - b2_ - 2 * c2_ * cb_ * v
         + c2_ * v ** 2 + c2_) / torch.where(den.abs() < 1e-30, torch.full_like(den, 1e-30), den)
    s1sq = b2_ / (1 + v ** 2 - 2 * v * cb_)
    ok = real & (u > 0) & (v > 0) & (s1sq > 0) & torch.isfinite(u) & torch.isfinite(s1sq)
    s1 = torch.sqrt(torch.clamp(s1sq, min=0))
    depth = torch.stack([s1, u * s1, v * s1], -1)                 # (N, 4, 3)
    P = depth[..., None] * b[:, None]                             # camera points (N, 4, 3, 3)
    W = X[:, None].expand_as(P)
    pm, wm = P.mean(-2, keepdim=True), W.mean(-2, keepdim=True)
    H = (W - wm).transpose(-1, -2) @ (P - pm)                     # (N, 4, 3, 3)
    U, _, Vh = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vh.transpose(-1, -2) @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = Vh.transpose(-1, -2) @ D @ U.transpose(-1, -2)
    C = wm[..., 0, :] - (R.transpose(-1, -2) @ pm[..., 0, :, None])[..., 0]
    ok = ok & torch.isfinite(R).all(-1).all(-1) & torch.isfinite(C).all(-1)
    return R, C, ok


def floyd(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Draws (F, B, 3) of uniforms -> three distinct indices of the valid
    entries of each row of valid (F, M): Floyd's method over the valid
    entries in their order, draw j from [0, n - 3 + j], a repeat replaced
    by n - 3 + j."""
    n = valid.sum(-1)                                             # (F,)
    nn = torch.clamp(n, min=SAMPLE)[:, None]
    picks = []
    for j in range(SAMPLE):
        m = nn - SAMPLE + j + 1
        t = torch.floor(u[..., j] * m.to(u.dtype)).long()
        t = torch.minimum(torch.clamp(t, min=0), m - 1)
        for p in picks:
            t = torch.where(p == t, nn - SAMPLE + j, t)
        picks.append(t)
    pos = torch.minimum(torch.stack(picks, -1), torch.clamp(n - 1, min=0)[:, None, None])
    # the index of the pos-th valid entry
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    return torch.gather(order, 1, pos.reshape(pos.shape[0], -1)).reshape(pos.shape)


class Ransac(NamedTuple):
    R: torch.Tensor          # (F, 3, 3)
    C: torch.Tensor          # (F, 3)
    inliers: torch.Tensor    # (F, M) bool
    success: torch.Tensor    # (F,) bool
    log_nfa: torch.Tensor    # (F,)


def residuals_sq(R, C, K, dist, Xw, uv):
    """Squared reprojection errors, pixels: poses (..., 3, 3), (..., 3)
    against points (..., N, 3); inf behind the camera."""
    Xc = (Xw - C[..., None, :]) @ R.transpose(-1, -2)
    e = ((project(K, dist, Xc) - uv) ** 2).sum(-1)
    return torch.where(Xc[..., 2] > 0, e, torch.full_like(e, float("inf")))


def log_nfa(res_sq: torch.Tensor, valid: torch.Tensor, log_alpha0: torch.Tensor):
    """AC-RANSAC's least log10 NFA over k of each hypothesis, and the
    squared threshold at that k. res_sq (F, H, M), valid (F, M),
    log_alpha0 (F,)."""
    M = res_sq.shape[-1]
    dt = res_sq.dtype
    n = valid.sum(-1).to(dt)[:, None, None]
    e = torch.sort(torch.where(valid[:, None], res_sq, torch.full_like(res_sq, float("inf"))),
                   dim=-1).values
    k = torch.arange(1, M + 1, dtype=dt, device=res_sq.device)
    lg = torch.lgamma
    l10 = math.log(10.0)
    logc_nk = (lg(n + 1) - lg(k + 1) - lg(torch.clamp(n - k + 1, min=1))) / l10
    logc_ks = (lg(k + 1) - math.lgamma(SAMPLE + 1) - lg(torch.clamp(k - SAMPLE + 1, min=1))) / l10
    val = (torch.log10(torch.clamp(n - SAMPLE, min=1)) + logc_nk + logc_ks
           + (k - SAMPLE) * (log_alpha0[:, None, None] + torch.log10(torch.clamp(e, min=1e-20))))
    ok = (k > SAMPLE) & (k <= n) & torch.isfinite(e)
    val = torch.where(ok, val, torch.full_like(val, float("inf")))
    best = torch.argmin(val, dim=-1, keepdim=True)
    return torch.gather(val, -1, best)[..., 0], torch.gather(e, -1, best)[..., 0]


def acransac(Xw, uv, valid, K, dist, draws) -> Ransac:
    """AC-RANSAC P3P of F frames: Xw (F, M, 3) and uv (F, M, 2) the 2D-3D
    correspondences, valid (F, M), K (F, 3, 3), dist (F, 3), draws (F, B,
    3) the uniforms of the minimal samples. Every hypothesis is scored by
    its NFA; the least wins, and its threshold picks the inliers."""
    Fn, B = draws.shape[:2]
    rays = bearings(K, dist, uv)
    idx = floyd(draws, valid)                                      # (F, B, 3)
    fr = torch.arange(Fn, device=Xw.device)[:, None, None]
    R, C, ok = p3p(Xw[fr, idx].reshape(-1, 3, 3), rays[fr, idx].reshape(-1, 3, 3))
    R, C, ok = R.reshape(Fn, B * 4, 3, 3), C.reshape(Fn, B * 4, 3), ok.reshape(Fn, B * 4)
    R = torch.where(ok[..., None, None], R, torch.eye(3, dtype=R.dtype, device=R.device))
    C = torch.where(ok[..., None], C, torch.zeros_like(C))
    # the a-contrario constant of a point error in pixels: pi / image area
    alpha0 = torch.log10(math.pi / ((2 * K[:, 0, 2]) * (2 * K[:, 1, 2])))
    best_nfa = torch.full((Fn,), float("inf"), dtype=Xw.dtype, device=Xw.device)
    best_h = torch.zeros(Fn, dtype=torch.long, device=Xw.device)
    best_thr = torch.zeros(Fn, dtype=Xw.dtype, device=Xw.device)
    step = 64
    for h0 in range(0, B * 4, step):
        res = residuals_sq(R[:, h0:h0 + step], C[:, h0:h0 + step], K[:, None], dist[:, None],
                           Xw[:, None], uv[:, None])
        nfa, thr = log_nfa(res, valid, alpha0)
        nfa = torch.where(ok[:, h0:h0 + step], nfa, torch.full_like(nfa, float("inf")))
        v, i = nfa.min(dim=1)
        better = v < best_nfa
        best_nfa = torch.where(better, v, best_nfa)
        best_h = torch.where(better, h0 + i, best_h)
        best_thr = torch.where(better, torch.gather(thr, 1, i[:, None])[:, 0], best_thr)
    rows = torch.arange(Fn, device=Xw.device)
    Rb, Cb = R[rows, best_h], C[rows, best_h]
    res = residuals_sq(Rb, Cb, K, dist, Xw, uv)
    inl = (res <= best_thr[:, None]) & valid
    success = (best_nfa < 0) & (inl.sum(-1) >= INLIER_GATE)
    return Ransac(Rb, Cb, inl, success, best_nfa)


# -- the pose refinement -----------------------------------------------------------

def jacobian(R, C, K, dist, Xw, uv):
    """Residuals r (F, N, 2) and their derivatives (F, N, 2, 6) in (w, dC)."""
    Xc = (Xw - C[:, None, :]) @ R.transpose(-1, -2)
    z = torch.clamp(Xc[..., 2], min=1e-9)
    p = Xc[..., :2] / z[..., None]
    r2 = (p * p).sum(-1)
    k = dist[:, None, :]
    fac = radial(dist, r2)
    dfac = k[..., 0] + r2 * (2 * k[..., 1] + 3 * k[..., 2] * r2)
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None, :]
    # d pixel / d p, then d p / d Xc
    dd = fac[..., None, None] * torch.eye(2, dtype=R.dtype, device=R.device) \
        + 2 * dfac[..., None, None] * p[..., :, None] * p[..., None, :]
    dpix = f[..., :, None] * dd
    live = (Xc[..., 2] > 1e-9).to(R.dtype)
    dp = torch.zeros(Xc.shape[:-1] + (2, 3), dtype=R.dtype, device=R.device)
    dp[..., 0, 0] = 1 / z
    dp[..., 1, 1] = 1 / z
    dp[..., 0, 2] = -p[..., 0] / z * live
    dp[..., 1, 2] = -p[..., 1] / z * live
    dXc = torch.cat([-hat(Xc), -R[:, None].expand(Xc.shape + (3,))], -1)   # (F, N, 3, 6)
    J = dpix @ dp @ dXc
    r = project(K, dist, Xc) - uv
    return r, J


def huber_w(res_sq):
    return torch.where(res_sq <= HUBER_SQ, torch.ones_like(res_sq),
                       torch.sqrt(HUBER_SQ / torch.clamp(res_sq, min=1e-30)))


def information(R, C, K, dist, Xw, uv, inliers):
    """The Huber-weighted Gauss-Newton matrix (F, 6, 6), gradient (F, 6)
    and the unweighted rmse over the inliers."""
    r, J = jacobian(R, C, K, dist, Xw, uv)
    s = (r * r).sum(-1)
    w = huber_w(s) * inliers.to(R.dtype)
    H = torch.einsum("fn,fnai,fnaj->fij", w, J, J)
    g = torch.einsum("fn,fnai,fna->fi", w, J, r)
    n = torch.clamp(inliers.sum(-1), min=1).to(R.dtype)
    rmse = torch.sqrt((s * inliers.to(R.dtype)).sum(-1) / n)
    return H, g, rmse


def refine(R, C, K, dist, Xw, uv, inliers, iterations: int = 60):
    """The Huber optimum of the reprojection error over the inliers, from
    (R, C), by damped Gauss-Newton steps until they stop changing it."""
    lam = torch.full(R.shape[:1], 1e-6, dtype=R.dtype, device=R.device)
    eye = torch.eye(6, dtype=R.dtype, device=R.device)

    def cost(Rp, Cp):
        s = residuals_sq(Rp, Cp, K, dist, Xw, uv)
        rho = torch.where(s <= HUBER_SQ, s, 2 * math.sqrt(HUBER_SQ) * torch.sqrt(s) - HUBER_SQ)
        return torch.where(inliers, rho, torch.zeros_like(rho)).sum(-1)

    c0 = cost(R, C)
    for _ in range(iterations):
        H, g, _ = information(R, C, K, dist, Xw, uv, inliers)
        A = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
            + 1e-30 * eye
        dp = -torch.linalg.solve(A, g[..., None])[..., 0]
        Rn, Cn = exp_so3(dp[:, :3]) @ R, C + dp[:, 3:]
        c1 = cost(Rn, Cn)
        take = c1 <= c0
        R = torch.where(take[:, None, None], Rn, R)
        C = torch.where(take[:, None], Cn, C)
        c0 = torch.where(take, c1, c0)
        lam = torch.where(take, torch.clamp(lam / 10, min=1e-12), lam * 10)
    return R, C


def covariance(H: torch.Tensor) -> torch.Tensor:
    """The inverse of H with its eigenvalues floored at 1e-6 of the largest
    (plus 1e-12)."""
    ev, V = torch.linalg.eigh(H)
    floor = 1e-6 * ev.abs().amax(-1, keepdim=True) + 1e-12
    return (V / torch.maximum(ev, floor)[..., None, :]) @ V.transpose(-1, -2)
