"""The TRIP frontend of the KORAL configuration, written from its
definition in plain PyTorch: an 8-level bilinear pyramid at 1.2x steps,
FAST-9 corners with a 3x3 non-maximum suppression, the best k over every
level of a frame, parabolic subpixel offsets, the intensity-centroid
angle and the 512-bit steered triplet descriptor.

Each level is processed on its own (no stacked raster, no patches): a
keypoint keeps out of a border of `border / 1.2^level` pixels (at least
8), so nothing it reads lies outside its level. Sampled values are
rounded to bfloat16, as the descriptor's definition rounds them, and the
frames' arithmetic is float32. The two products (the resampling and the
centroid's moments) are matrix products, which the control computes in
TF32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
ARC = 9
MIN_BORDER = 8
DESC_BITS, POOL, POOL_SEED, POOL_RADIUS, MIN_SEP = 512, 192, 20240816, 24.0, 3.0


class Keypoints(NamedTuple):
    xy: torch.Tensor       # (B, k, 2) full-resolution pixels
    level: torch.Tensor    # (B, k) int64
    score: torch.Tensor    # (B, k)
    angle: torch.Tensor    # (B, k) radians
    bits: torch.Tensor     # (B, k, 512) bool
    valid: torch.Tensor    # (B, k) bool


def level_shapes(h: int, w: int, levels: int, factor: float) -> List[Tuple[int, int]]:
    return [(max(int(round(h / factor ** l)), 8), max(int(round(w / factor ** l)), 8))
            for l in range(levels)]


def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights: output i reads the input at
    (i + 1/2) n_in / n_out - 1/2, clamped to the input, linearly."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        p = min(max((i + 0.5) * (n_in / n_out) - 0.5, 0.0), n_in - 1.0)
        a = int(np.floor(p))
        frac = np.float32(p - a)
        m[i, a] += np.float32(1.0) - frac
        m[i, min(a + 1, n_in - 1)] += frac
    return m


def pyramid(frames: torch.Tensor, levels: int, factor: float) -> List[torch.Tensor]:
    """(B, H, W) float32 -> each level (B, H_l, W_l), every level resampled
    from the one before."""
    out = [frames]
    shapes = level_shapes(frames.shape[1], frames.shape[2], levels, factor)
    for (h, w) in shapes[1:]:
        prev = out[-1]
        rows = torch.from_numpy(bilinear_matrix(prev.shape[1], h)).to(frames.device)
        cols = torch.from_numpy(bilinear_matrix(prev.shape[2], w)).to(frames.device)
        out.append((rows @ prev) @ cols.T)
    return out


def box(img: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over the (2r + 1)^2 box, edges replicated: rows, then columns."""
    def along(x, dim):
        n = x.shape[dim]
        idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
        p = x.index_select(dim, idx)
        acc = p.narrow(dim, 0, n)
        for s in range(1, 2 * r + 1):
            acc = acc + p.narrow(dim, s, n)
        return acc / (2 * r + 1)
    return along(along(img, 1), 2)


def shifted(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """out[..., y, x] = img[..., y + dy, x + dx], `fill` outside."""
    h, w = img.shape[-2:]
    out = torch.full_like(img, fill)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[..., yd, xd] = img[..., ys, xs]
    return out


def fast9(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score: over the 16 runs of 9 neighbours on the ring, the
    largest least brightening, or the largest least darkening; 0 where it
    is not above `threshold` and within 3 pixels of the edge."""
    ring = torch.stack([shifted(img, dy, dx) - img for dy, dx in RING], dim=1)
    best = None
    for start in range(16):
        run = ring[:, [(start + j) % 16 for j in range(ARC)]]
        s = torch.maximum(run.amin(dim=1), (-run).amin(dim=1))
        best = s if best is None else torch.maximum(best, s)
    best = torch.where(best > threshold, best, torch.zeros_like(best))
    edge = torch.zeros_like(best, dtype=torch.bool)
    edge[..., 3:-3, 3:-3] = True
    return torch.where(edge, best, torch.zeros_like(best))


def suppress(score: torch.Tensor) -> torch.Tensor:
    """Keep a score that no 3x3 neighbour beats and that no neighbour
    before it in raster order equals."""
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            nb = shifted(score, dy, dx)
            earlier = dy < 0 or (dy == 0 and dx < 0)
            keep &= (nb < score) if earlier else (nb <= score)
    return torch.where(keep, score, torch.zeros_like(score))


def parabola(m: torch.Tensor, c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    d = m - 2.0 * c + p
    d = torch.where(d.abs() < 1e-6, torch.full_like(d, 1e-6), d)
    return torch.clamp(0.5 * (m - p) / d, -0.5, 0.5)


def pool_and_triplets():
    """The descriptor's 192 pool offsets and its 512 (anchor, a, b) triplets,
    drawn from numpy's generator of the fixed seed."""
    rng = np.random.default_rng(POOL_SEED)
    pts = []
    while len(pts) < POOL:
        p = rng.normal(0.0, POOL_RADIUS / 2.5, size=2)
        if np.linalg.norm(p) <= POOL_RADIUS:
            pts.append(p)
    pool = np.array(pts, np.float32)
    trip, seen = [], set()
    while len(trip) < DESC_BITS:
        a, p1, p2 = (int(v) for v in rng.integers(0, POOL, 3))
        if len({a, p1, p2}) < 3 or np.linalg.norm(pool[p1] - pool[p2]) < MIN_SEP:
            continue
        key = (a, min(p1, p2), max(p1, p2))
        if key not in seen:
            seen.add(key)
            trip.append((a, p1, p2))
    return pool, np.array(trip, np.int64)


def nearest(img: torch.Tensor, b: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img (B, h, w) at rounded (x, y) (N, S) of frames b (N,), as bf16."""
    h, w = img.shape[-2:]
    xi = torch.round(x).long()
    yi = torch.round(y).long()
    flat = img.reshape(img.shape[0], h * w)
    v = flat[b[:, None], yi * w + xi]
    return v.to(torch.bfloat16).to(torch.float32)


def describe(frames: torch.Tensor, levels: int, factor: float, k: int, threshold: float,
             border: int, radius: int) -> Keypoints:
    """(B, H, W) float32 frames -> the best k keypoints of each, with their
    angles and descriptors."""
    dev = frames.device
    B = frames.shape[0]
    pyr = pyramid(frames.to(torch.float32), levels, factor)
    cand_s, cand_l, cand_y, cand_x = [], [], [], []
    raw = []
    for l, lvl in enumerate(pyr):
        h, w = lvl.shape[1:]
        s = fast9(lvl, threshold)
        raw.append(s)
        n = suppress(s)
        b = max(MIN_BORDER, int(round(border / factor ** l)))
        mask = torch.zeros_like(n, dtype=torch.bool)
        if h > 2 * b and w > 2 * b:
            mask[:, b:h - b, b:w - b] = True
        n = torch.where(mask, n, torch.zeros_like(n))
        ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        cand_s.append(n.reshape(B, -1))
        cand_l.append(torch.full((h * w,), l, device=dev))
        cand_y.append(ys.reshape(-1))
        cand_x.append(xs.reshape(-1))
    score = torch.cat(cand_s, dim=1)
    lev, yy, xx = torch.cat(cand_l), torch.cat(cand_y), torch.cat(cand_x)
    # the best k by score, ties to the earlier (level, row, column)
    order = torch.argsort(-score, dim=1, stable=True)[:, :k]
    top = torch.gather(score, 1, order)
    valid = top > 0
    L, Y, X = lev[order], yy[order], xx[order]

    smooth = [box(p, radius) for p in pyr]
    fx = torch.zeros((B, k), device=dev)
    fy = torch.zeros((B, k), device=dev)
    ang = torch.zeros((B, k), device=dev)
    bits = torch.zeros((B, k, DESC_BITS), dtype=torch.bool, device=dev)
    pool_np, trip = pool_and_triplets()
    pool = torch.from_numpy(pool_np).to(dev)
    trip = torch.from_numpy(trip).to(dev)
    r = torch.arange(-3, 4, device=dev, dtype=torch.float32)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    taper = 4.0 - torch.maximum(ox.abs(), oy.abs())
    wx, wy = (ox * taper).reshape(-1), (oy * taper).reshape(-1)
    for l in range(levels):
        sel = L == l
        if not bool(sel.any()):
            continue
        bi, ki = torch.nonzero(sel, as_tuple=True)
        h, w = pyr[l].shape[1:]
        x, y = X[bi, ki], Y[bi, ki]
        s = raw[l]
        xc, yc = torch.clamp(x, 1, w - 2), torch.clamp(y, 1, h - 2)
        c = s[bi, yc, xc]
        kx = x.to(torch.float32) + parabola(s[bi, yc, xc - 1], c, s[bi, yc, xc + 1])
        ky = y.to(torch.float32) + parabola(s[bi, yc - 1, xc], c, s[bi, yc + 1, xc])
        wmax, hmax = float(w - 1), float(h - 1)
        gx = torch.clamp(torch.round(kx)[:, None] + ox.reshape(-1), 0.0, wmax)
        gy = torch.clamp(torch.round(ky)[:, None] + oy.reshape(-1), 0.0, hmax)
        win = nearest(smooth[l], bi, gx, gy)                    # (N, 49)
        a = torch.atan2(win @ wy, win @ wx)
        ca, sa = torch.cos(a)[:, None], torch.sin(a)[:, None]
        px = torch.clamp(kx[:, None] + (ca * pool[:, 0] - sa * pool[:, 1]), 0.0, wmax)
        py = torch.clamp(ky[:, None] + (sa * pool[:, 0] + ca * pool[:, 1]), 0.0, hmax)
        v = nearest(smooth[l], bi, px, py)                      # (N, 192)
        va, v1, v2 = v[:, trip[:, 0]], v[:, trip[:, 1]], v[:, trip[:, 2]]
        bits[bi, ki] = (va - v1) ** 2 > (va - v2) ** 2
        scale = torch.pow(torch.tensor(factor, dtype=torch.float32, device=dev),
                          torch.tensor(float(l), device=dev))
        fx[bi, ki], fy[bi, ki], ang[bi, ki] = kx * scale, ky * scale, a
    xy = torch.where(valid[..., None], torch.stack([fx, fy], dim=-1), 0.0)
    return Keypoints(xy=xy, level=L, score=top, angle=ang, bits=bits & valid[..., None],
                     valid=valid)


def frontend(frames: torch.Tensor, det: dict, k: int) -> Keypoints:
    """The configuration's detector group (`backend` "trip") on (B, H, W)."""
    return describe(frames, det["num_levels"], det["scale_factor"], k, det["fast_threshold"],
                    det["border"], det["smoothing_radius"])


def words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., 16) int32 words, bit j of word i the descriptor's bit 32 i + j
    -> (..., 512) bool."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(32, device=words.device)
    return ((w[..., None] >> sh) & 1).bool().reshape(*words.shape[:-1], -1)


def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of words_to_bits."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    w = (b << torch.arange(32, device=bits.device)).sum(dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
