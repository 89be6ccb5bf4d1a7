"""Batched Nistér 5-point essential-matrix solver (counterpart of
coloc_tpu.geometry.fivept, in the form of its Pallas batch path).

Reference parity: OpenMVG's FivePointSolver inside the ACRANSAC essential
kernel (RobustMatcher.hpp:161-171). coloc_tpu has two forms of the batch
solver, which capture the same solution set but give different candidates
for one sample: the Pallas kernels (Householder null basis, 5 Gauss-Newton
steps) and jax.vmap(five_point) (LAPACK QR basis, 3 steps). The port
follows the Pallas form on every device. Three stages, each a kernel on a
CUDA tensor and a plain PyTorch twin on a CPU tensor:

  front   B6 csrc/fivept_front.cu  — null basis by 5 Householder reflections,
          the 10x20 cubic-constraint matrix, MD = [M; M D_x; M D_y; M D_z],
          Gauss-Jordan, Nistér's reduced polynomials and the degree-10 one
  dk      B7 csrc/fivept_dk.cu     — Durand-Kerner roots of the monic,
          rescaled degree-10 polynomial (24 iterations, 3 real Newton steps)
  polish  B8 csrc/fivept_polish.cu — per seed (each root, root +- 1%): a 2x2
          normal solve for (x, y), 5 Gauss-Newton steps on the 10
          constraints, a convergence certificate, E normalised

The monic normalisation and rescaling before dk and the split seeds before
polish stay in PyTorch between the launches, as they sit in XLA between the
Pallas calls. There is no compile probe and no vmap fallback: a kernel that
fails to build or launch raises.

Every kernel repeats its twin's arithmetic operation for operation (the
kernels are built with -fmad=false): the constraint expansion is generated
from this module's _constraint_rows by csrc/gen_fivept_constraints.py into
csrc/fivept_constraints.cuh, and every sum runs in the twin's order. Two
forms differ from coloc_tpu at the last bit: reductions over the 10
constraint rows are sequential sums, and the certificate's |xyz|^3 is
t * sqrt(t), not t ** 1.5.

Layouts are the TPU kernels' (samples on the last axis): xs (20, B) packed
[u1(5) v1(5) u2(5) v2(5)] -> basis (36, B), md (40, 20, B), coef (40, B),
npoly (11, B); roots and masks (10, B); seeds (30, B) -> E (B, 30, 9).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from coloc_tpu_torch.ops import _build, dispatch


class _Poly:
    """Polynomial in (x, y, z): dict[(i, j, k)] -> coefficient. The
    coefficients may be tensors or the symbolic values of the header
    generator, so the twin and the kernel expand in one order."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})

    @staticmethod
    def const(c):
        return _Poly({(0, 0, 0): c})

    def __add__(self, other):
        out = dict(self.terms)
        for m, c in other.terms.items():
            out[m] = out[m] + c if m in out else c
        return _Poly(out)

    def __sub__(self, other):
        out = dict(self.terms)
        for m, c in other.terms.items():
            out[m] = out[m] - c if m in out else -c
        return _Poly(out)

    def __mul__(self, other):
        out = {}
        for m1, c1 in self.terms.items():
            for m2, c2 in other.terms.items():
                m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
                prod = c1 * c2
                out[m] = out[m] + prod if m in out else prod
        return _Poly(out)

    def coeff(self, m):
        return self.terms.get(m, 0.0)


# Nistér's monomial order for the 10x20 constraint matrix
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]

_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}


def _diff_mats() -> np.ndarray:
    """(3, 20, 20) differentiation matrices over the monomial basis:
    (D[a] @ mono)[k] = d mono_k / d var_a (the 20 monomials are all those of
    degree <= 3, so the basis is closed under differentiation)."""
    D = np.zeros((3, 20, 20), np.float32)
    for k, exps in enumerate(_MONOMIALS):
        for a in range(3):
            if exps[a] > 0:
                red = list(exps)
                red[a] -= 1
                D[a, k, _MONO_INDEX[tuple(red)]] = float(exps[a])
    return D


_DIFF_MATS = _diff_mats()


def _sparse_diff_terms():
    """COO view of _DIFF_MATS: terms[a][j] = [(k, val), ...] with
    (M @ D_a)[:, j] = sum val * M[:, k]."""
    return [
        [[(k, float(_DIFF_MATS[a, k, j])) for k in range(20)
          if _DIFF_MATS[a, k, j] != 0.0]
         for j in range(20)]
        for a in range(3)
    ]


_DIFF_TERMS = _sparse_diff_terms()

_DK_ITERS = 24
_NEWTON_STEPS = 3
_GN_STEPS = 5
_SEEDS = 30   # 10 roots x (root, root + delta, root - delta)


def _constraint_rows(X, Y, Z, W):
    """The cubic-constraint expansion: X/Y/Z/W are [r][c]-indexable null
    basis matrices of scalar-like values. Returns 10 x 20 nested lists of
    coefficients over _MONOMIALS (0.0 where a monomial is absent)."""
    E = [[_Poly({(1, 0, 0): X[r][c], (0, 1, 0): Y[r][c],
                 (0, 0, 1): Z[r][c], (0, 0, 0): W[r][c]})
          for c in range(3)] for r in range(3)]

    def matmul(A, B):
        return [[sum((A[r][k] * B[k][c] for k in range(3)), _Poly())
                 for c in range(3)] for r in range(3)]

    Et = [[E[c][r] for c in range(3)] for r in range(3)]
    EEt = matmul(E, Et)
    EEtE = matmul(EEt, E)
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]

    # det(E) = 0, then 2 E E^T E - tr(E E^T) E = 0 (nine entries)
    eqs = [
        E[0][0] * (E[1][1] * E[2][2] - E[1][2] * E[2][1])
        - E[0][1] * (E[1][0] * E[2][2] - E[1][2] * E[2][0])
        + E[0][2] * (E[1][0] * E[2][1] - E[1][1] * E[2][0])
    ]
    two = _Poly.const(2.0)
    for r in range(3):
        for c in range(3):
            eqs.append(two * EEtE[r][c] - trace * E[r][c])
    return [[eq.coeff(m) for m in _MONOMIALS] for eq in eqs]


# ---------------------------------------------------------------------------
# B6: the front (plain twin of csrc/fivept_front.cu)
# ---------------------------------------------------------------------------

def _householder_null_basis(xs: torch.Tensor):
    """(20, B) packed coords -> 4 null vectors of the 5x9 epipolar design
    matrix, each a list of 9 (B,) tensors (complete QR of A^T by 5
    Householder reflections, the TPU kernel's arithmetic)."""
    u1 = [xs[i] for i in range(5)]
    v1 = [xs[5 + i] for i in range(5)]
    u2 = [xs[10 + i] for i in range(5)]
    v2 = [xs[15 + i] for i in range(5)]
    one = torch.ones_like(xs[0])
    zero = torch.zeros_like(xs[0])
    cols = [[u2[i] * u1[i], u2[i] * v1[i], u2[i], v2[i] * u1[i],
             v2[i] * v1[i], v2[i], u1[i], v1[i], one] for i in range(5)]
    refl = []
    for k in range(5):
        x = cols[k]
        sigma = sum(x[i] * x[i] for i in range(k, 9))
        sgn = torch.where(x[k] >= 0.0, 1.0, -1.0)
        alpha = -sgn * torch.sqrt(sigma + 1e-30)
        v = [zero] * k + [x[k] - alpha] + x[k + 1:]
        beta = 2.0 / (2.0 * (sigma - x[k] * alpha) + 1e-30)
        refl.append((v, beta))
        for j in range(k + 1, 5):
            c = sum(v[i] * cols[j][i] for i in range(k, 9))
            cols[j] = [cols[j][i] - beta * c * v[i] for i in range(9)]
    nb = []
    for j in range(5, 9):
        q = [zero] * 9
        q[j] = one
        for k in range(4, -1, -1):
            v, beta = refl[k]
            c = sum(v[i] * q[i] for i in range(k, 9))
            q = [q[i] - beta * c * v[i] for i in range(9)]
        nb.append(q)
    return nb


def _gj_polys(Mw: torch.Tensor):
    """Gauss-Jordan with partial pivoting (first row on ties, one-hot row
    swaps) on regularised (10, 20, B) constraint matrices, then Nistér's
    <k>, <l>, <m> polynomials. -> coef (40, B) [Pk Qk Pl Ql Pm Qm](4 each)
    [Rk Rl Rm](5 each) + a zero row, npoly (11, B) ascending."""
    B = Mw.shape[2]
    row = torch.arange(10, device=Mw.device)[:, None]
    for k in range(10):
        cand = torch.where(row >= k, Mw[:, k, :].abs(), -1.0)
        mx = cand.amax(dim=0)
        pidx = torch.where(cand == mx[None, :], row, 10).amin(dim=0)
        onep = (row == pidx[None, :]).to(Mw.dtype)               # (10, B)
        onek = (row == k).to(Mw.dtype).expand(10, B)
        rp = (onep[:, None, :] * Mw).sum(dim=0)                  # (20, B)
        rk = Mw[k]
        Mw = (Mw + onek[:, None, :] * (rp - rk)[None]
              + onep[:, None, :] * (rk - rp)[None])
        piv = rp[k] + onep[k] * (rk[k] - rp[k])
        piv = torch.where(piv.abs() < 1e-20, 1e-20, piv)
        rowk = Mw[k] / piv[None, :]
        Mw = Mw - Mw[:, k, :][:, None, :] * rowk[None]
        Mw = Mw + onek[:, None, :] * rowk[None]
    tail = Mw[:, 10:, :]
    zero = torch.zeros_like(tail[0, 0])

    def row_polys(i):
        r = tail[i]
        return (r[2], r[1], r[0]), (r[5], r[4], r[3]), (r[9], r[8], r[7], r[6])

    def combine(ia, ib):
        # <k> = eq(a) - z * eq(b)
        Pa, Qa, Ra = row_polys(ia)
        Pb, Qb, Rb = row_polys(ib)
        P = (Pa[0], Pa[1] - Pb[0], Pa[2] - Pb[1], zero - Pb[2])
        Q = (Qa[0], Qa[1] - Qb[0], Qa[2] - Qb[1], zero - Qb[2])
        R = (Ra[0], Ra[1] - Rb[0], Ra[2] - Rb[1], Ra[3] - Rb[2], zero - Rb[3])
        return P, Q, R

    Pk, Qk, Rk = combine(4, 5)
    Pl, Ql, Rl = combine(6, 7)
    Pm, Qm, Rm = combine(8, 9)

    def pmul(a, b):
        out = [zero] * (len(a) + len(b) - 1)
        for i in range(len(a)):
            for j in range(len(b)):
                out[i + j] = out[i + j] + a[i] * b[j]
        return out

    def pad(a, n):
        return list(a) + [zero] * (n - len(a))

    def psub(a, b):
        n = max(len(a), len(b))
        return [x - y for x, y in zip(pad(a, n), pad(b, n))]

    def padd(a, b):
        n = max(len(a), len(b))
        return [x + y for x, y in zip(pad(a, n), pad(b, n))]

    # det = Pk (Ql Rm - Qm Rl) - Qk (Pl Rm - Pm Rl) + Rk (Pl Qm - Pm Ql)
    m01 = psub(pmul(Ql, Rm), pmul(Qm, Rl))
    m11 = psub(pmul(Pl, Rm), pmul(Pm, Rl))
    m21 = psub(pmul(Pl, Qm), pmul(Pm, Ql))
    det = pad(padd(psub(pmul(Pk, m01), pmul(Qk, m11)), pmul(Rk, m21)), 11)
    coef = torch.stack(list(Pk) + list(Qk) + list(Pl) + list(Ql) + list(Pm)
                       + list(Qm) + list(Rk) + list(Rl) + list(Rm) + [zero])
    return coef, torch.stack(det[:11])


def front_plain(xs: torch.Tensor):
    """Plain twin of csrc/fivept_front.cu: xs (20, B) -> (basis (36, B),
    md (40, 20, B), coef (40, B), npoly (11, B))."""
    nb = _householder_null_basis(xs)
    zero = torch.zeros_like(xs[0])

    def as33(q):
        return [[q[3 * r + c] for c in range(3)] for r in range(3)]

    rows = _constraint_rows(*(as33(q) for q in nb))
    M = torch.stack([torch.stack([v if torch.is_tensor(v) else zero for v in rr])
                     for rr in rows])                          # (10, 20, B)
    md_rows = [M]
    for a in range(3):
        cols_a = []
        for j in range(20):
            acc = torch.zeros_like(M[:, 0])
            for k, val in _DIFF_TERMS[a][j]:
                acc = acc + val * M[:, k]
            cols_a.append(acc)
        md_rows.append(torch.stack(cols_a, dim=1))
    md = torch.cat(md_rows, dim=0)                             # (40, 20, B)
    basis = torch.stack([nb[b][i] for b in range(4) for i in range(9)])
    reg = torch.zeros((10, 20, 1), dtype=xs.dtype, device=xs.device)
    reg[torch.arange(10), torch.arange(10)] = 1e-10
    coef, npoly = _gj_polys(M + reg)
    return basis, md, coef, npoly


def _front_cuda(xs: torch.Tensor):
    dev = xs.device
    B = xs.shape[1]
    dispatch.check_operand(xs, "xs", torch.float32, (20, B), dev)
    basis = torch.empty((36, B), dtype=torch.float32, device=dev)
    md = torch.empty((40, 20, B), dtype=torch.float32, device=dev)
    coef = torch.empty((40, B), dtype=torch.float32, device=dev)
    npoly = torch.empty((11, B), dtype=torch.float32, device=dev)
    _build.launch("coloc_fivept_front", xs.data_ptr(), basis.data_ptr(),
                  md.data_ptr(), coef.data_ptr(), npoly.data_ptr(), B,
                  dev.index, dispatch.stream_handle(dev))
    dispatch.count_launch("fivept_front")
    return basis, md, coef, npoly


def front(xs: torch.Tensor):
    """B6: (20, B) packed minimal samples -> (basis, md, coef, npoly)."""
    if dispatch.use_kernel(xs):
        return _front_cuda(xs.contiguous())
    return front_plain(xs)


# ---------------------------------------------------------------------------
# B7: Durand-Kerner roots (plain twin of csrc/fivept_dk.cu)
# ---------------------------------------------------------------------------

def _horner(c, zr, zi):
    """Complex Horner of the ascending (11, B) real coefficients at z."""
    pr = c[10][None].expand_as(zr)
    pi = torch.zeros_like(zi)
    for i in range(9, -1, -1):
        pr, pi = pr * zr - pi * zi + c[i][None], pr * zi + pi * zr
    return pr, pi


def dk_roots_plain(c: torch.Tensor, s: torch.Tensor):
    """Plain twin of csrc/fivept_dk.cu: c (11, B) monic rescaled ascending
    coefficients, s (B,) rescale factor -> (roots (10, B) real parts times
    s, is_real (10, B) bool)."""
    B = c.shape[1]
    sr, si = 0.4, 0.9        # seeds (0.4 + 0.9i)^(k+1)
    zr0 = [torch.full((B,), sr, dtype=c.dtype, device=c.device)]
    zi0 = [torch.full((B,), si, dtype=c.dtype, device=c.device)]
    for _ in range(9):
        zr0.append(zr0[-1] * sr - zi0[-1] * si)
        zi0.append(zr0[-2] * si + zi0[-1] * sr)
    zr, zi = torch.stack(zr0), torch.stack(zi0)               # (10, B)
    row = torch.arange(10, device=c.device)[:, None]
    for _ in range(_DK_ITERS):
        pr, pi = _horner(c, zr, zi)
        dr = torch.ones_like(zr)
        di = torch.zeros_like(zi)
        for j in range(10):
            wr = torch.where(row == j, 1.0, zr - zr[j][None])
            wi = torch.where(row == j, 0.0, zi - zi[j][None])
            dr, di = dr * wr - di * wi, dr * wi + di * wr
        den = dr * dr + di * di + 1e-20
        zr, zi = zr - (pr * dr + pi * di) / den, zi - (pi * dr - pr * di) / den
    x = zr
    for _ in range(_NEWTON_STEPS):
        pr, _ = _horner(c, x, torch.zeros_like(x))
        dacc = (10.0 * c[10])[None].expand_as(x)
        for i in range(9, 0, -1):
            dacc = dacc * x + float(i) * c[i][None]
        x = x - pr / (dacc + 1e-12)
    is_real = (zi.abs() < 0.5 * (zr.abs() + 1.0)) & torch.isfinite(x)
    return x * s[None], is_real


def _dk_cuda(c: torch.Tensor, s: torch.Tensor):
    dev = c.device
    B = c.shape[1]
    dispatch.check_operand(c, "coef", torch.float32, (11, B), dev)
    dispatch.check_operand(s, "scale", torch.float32, (B,), dev)
    roots = torch.empty((10, B), dtype=torch.float32, device=dev)
    is_real = torch.empty((10, B), dtype=torch.bool, device=dev)
    _build.launch("coloc_fivept_dk", c.data_ptr(), s.data_ptr(),
                  roots.data_ptr(), is_real.data_ptr(), B, dev.index,
                  dispatch.stream_handle(dev))
    dispatch.count_launch("fivept_dk")
    return roots, is_real


def dk_roots(c: torch.Tensor, s: torch.Tensor):
    """B7: roots of monic rescaled degree-10 polynomials."""
    if dispatch.use_kernel(c):
        return _dk_cuda(c.contiguous(), s.contiguous())
    return dk_roots_plain(c, s)


def dk_normalise(npoly: torch.Tensor):
    """(11, B) ascending -> (monic coefficients rescaled so the roots sit at
    O(1) (11, B), rescale factor s (B,)), _dk_roots_batch's arithmetic."""
    lead = npoly[10]
    lead = torch.where(lead.abs() < 1e-12, 1e-12, lead)
    c = npoly / lead[None]
    k = torch.arange(10, dtype=torch.float32, device=npoly.device)
    mag = torch.clamp(c[:10].abs(), min=1e-30)
    s = torch.clamp(torch.pow(mag, (1.0 / (10.0 - k))[:, None]).amax(dim=0),
                    1e-3, 1e6)
    deg = torch.arange(11, dtype=torch.float32, device=npoly.device)
    c = c * torch.exp((deg[:, None] - 10.0) * torch.log(s)[None])
    return c, s


# ---------------------------------------------------------------------------
# B8: the polish (plain twin of csrc/fivept_polish.cu)
# ---------------------------------------------------------------------------

def _mono20(x, y, z):
    px = [None, x, x * x, x * x * x]
    py = [None, y, y * y, y * y * y]
    pz = [None, z, z * z, z * z * z]

    def term(i, j, k):
        # products in the order px * py * pz, skipping the constant factors
        # (a product with 1.0 is exact)
        fac = [p[e] for p, e in ((px, i), (py, j), (pz, k)) if e > 0]
        if not fac:
            return torch.ones_like(x)
        acc = fac[0]
        for f in fac[1:]:
            acc = acc * f
        return acc

    return [term(*m) for m in _MONOMIALS]


def polish_plain(md, coef, basis, seeds, svalid):
    """Plain twin of csrc/fivept_polish.cu: md (40, 20, B), coef (40, B),
    basis (36, B), seeds (30, B), svalid (30, B) bool -> (E (B, 30, 9),
    valid (B, 30) bool)."""
    z = seeds

    def c(i):
        return coef[i][None]

    def ev4(o):
        return ((c(o + 3) * z + c(o + 2)) * z + c(o + 1)) * z + c(o)

    def ev5(o):
        return (((c(o + 4) * z + c(o + 3)) * z + c(o + 2)) * z + c(o + 1)) * z + c(o)

    a00, a01 = ev4(0), ev4(4)
    a10, a11 = ev4(8), ev4(12)
    a20, a21 = ev4(16), ev4(20)
    b0, b1, b2 = -ev5(24), -ev5(29), -ev5(34)
    AtA00 = a00 * a00 + a10 * a10 + a20 * a20 + 1e-12
    AtA01 = a00 * a01 + a10 * a11 + a20 * a21
    AtA11 = a01 * a01 + a11 * a11 + a21 * a21 + 1e-12
    Atb0 = a00 * b0 + a10 * b1 + a20 * b2
    Atb1 = a01 * b0 + a11 * b1 + a21 * b2
    det2 = AtA00 * AtA11 - AtA01 * AtA01
    det2 = torch.where(det2.abs() < 1e-20, 1e-20, det2)
    x = (AtA11 * Atb0 - AtA01 * Atb1) / det2
    y = (AtA00 * Atb1 - AtA01 * Atb0) / det2

    def contract(r, mono):
        acc = md[r, 0][None] * mono[0]
        for k in range(1, 20):
            acc = acc + md[r, k][None] * mono[k]
        return acc

    def rowsum(terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc

    for _ in range(_GN_STEPS):
        mono = _mono20(x, y, z)
        r = [contract(i, mono) for i in range(10)]
        Jx = [contract(10 + i, mono) for i in range(10)]
        Jy = [contract(20 + i, mono) for i in range(10)]
        Jz = [contract(30 + i, mono) for i in range(10)]
        Axx = rowsum([a * a for a in Jx]) + 1e-9
        Axy = rowsum([a * b for a, b in zip(Jx, Jy)])
        Axz = rowsum([a * b for a, b in zip(Jx, Jz)])
        Ayy = rowsum([a * a for a in Jy]) + 1e-9
        Ayz = rowsum([a * b for a, b in zip(Jy, Jz)])
        Azz = rowsum([a * a for a in Jz]) + 1e-9
        gx = rowsum([a * b for a, b in zip(Jx, r)])
        gy = rowsum([a * b for a, b in zip(Jy, r)])
        gz = rowsum([a * b for a, b in zip(Jz, r)])
        c00 = Ayy * Azz - Ayz * Ayz
        c01 = Ayz * Axz - Axy * Azz
        c02 = Axy * Ayz - Ayy * Axz
        det = Axx * c00 + Axy * c01 + Axz * c02
        det = torch.where(det.abs() < 1e-20, 1e-20, det)
        dx = (c00 * gx + c01 * gy + c02 * gz) / det
        dy = (c01 * gx + (Axx * Azz - Axz * Axz) * gy
              + (Axz * Axy - Axx * Ayz) * gz) / det
        dz = (c02 * gx + (Axz * Axy - Axx * Ayz) * gy
              + (Axx * Ayy - Axy * Axy) * gz) / det
        x, y, z = x - dx, y - dy, z - dz

    # convergence certificate on the final point (rows 0:10 of MD = M)
    mono = _mono20(x, y, z)
    maxr = contract(0, mono).abs()
    for i in range(1, 10):
        maxr = torch.maximum(maxr, contract(i, mono).abs())
    t = x * x + y * y + z * z
    scale = 1.0 + t * torch.sqrt(t)
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    conv = finite & (maxr < 1e-3 * scale)

    def bs(i):
        return basis[i][None]

    E = [x * bs(k) + y * bs(9 + k) + z * bs(18 + k) + bs(27 + k) for k in range(9)]
    nrm = E[0] * E[0]
    for e in E[1:]:
        nrm = nrm + e * e
    nrm = torch.sqrt(nrm)
    nrm = torch.where(nrm < 1e-12, 1e-12, nrm)
    Es = torch.stack([e / nrm for e in E])                     # (9, 30, B)
    return Es.permute(2, 1, 0).contiguous(), (svalid & conv).T.contiguous()


def _polish_cuda(md, coef, basis, seeds, svalid):
    dev = md.device
    B = md.shape[2]
    dispatch.check_operand(md, "md", torch.float32, (40, 20, B), dev)
    dispatch.check_operand(coef, "coef", torch.float32, (40, B), dev)
    dispatch.check_operand(basis, "basis", torch.float32, (36, B), dev)
    dispatch.check_operand(seeds, "seeds", torch.float32, (_SEEDS, B), dev)
    dispatch.check_operand(svalid, "svalid", torch.bool, (_SEEDS, B), dev)
    Es = torch.empty((B, _SEEDS, 9), dtype=torch.float32, device=dev)
    valid = torch.empty((B, _SEEDS), dtype=torch.bool, device=dev)
    _build.launch("coloc_fivept_polish", md.data_ptr(), coef.data_ptr(),
                  basis.data_ptr(), seeds.data_ptr(), svalid.data_ptr(),
                  Es.data_ptr(), valid.data_ptr(), B, dev.index,
                  dispatch.stream_handle(dev))
    dispatch.count_launch("fivept_polish")
    return Es, valid


def polish(md, coef, basis, seeds, svalid):
    """B8: 30 seeds a sample -> (E (B, 30, 9), valid (B, 30))."""
    if dispatch.use_kernel(md):
        return _polish_cuda(md.contiguous(), coef.contiguous(),
                            basis.contiguous(), seeds.contiguous(),
                            svalid.contiguous())
    return polish_plain(md, coef, basis, seeds, svalid)


def five_point_batch(x1: torch.Tensor, x2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 5, 2) x 2 normalised coords -> ((B, 30, 3, 3) E candidates,
    (B, 30) valid): front, DK roots, split seeds, polish."""
    B = x1.shape[0]
    xs = torch.cat([x1[:, :, 0], x1[:, :, 1], x2[:, :, 0], x2[:, :, 1]],
                   dim=1).T.contiguous()                       # (20, B)
    basis, md, coef, npoly = front(xs)
    c, s = dk_normalise(npoly)
    roots, is_real = dk_roots(c, s)
    # split seeds: a near-double root holds two genuine solutions that one
    # polish basin would merge
    delta = 0.01 * (roots.abs() + 1.0)
    seeds = torch.cat([roots, roots + delta, roots - delta], dim=0)   # (30, B)
    Es, valid = polish(md, coef, basis, seeds, is_real.repeat(3, 1))
    return Es.reshape(B, _SEEDS, 3, 3), valid


def five_point(x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minimal sample, (5, 2) x 2 normalised coords -> ((30, 3, 3) E
    candidates, (30,) valid): five_point_batch at B = 1 (on a CUDA tensor
    its three kernels, B6-B8)."""
    Es, valid = five_point_batch(x1[None], x2[None])
    return Es[0], valid[0]
