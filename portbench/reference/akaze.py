"""The AKAZE-MLDB frontend of the reference's CPU build (OpenMVG's AKAZE
with the MLDB describer, NORMAL preset; the FED scale space and M-LDB of
Alcantarilla et al.), written from its definition in plain PyTorch.

  1. contrast     k: the 70th percentile of the base image's Scharr
                  gradient magnitudes, on a 300-bin histogram up to the
                  largest: the upper edge of the first bin whose count
                  from the bottom reaches 70% of the non-zero magnitudes
  2. scale space  octaves of sublevels at sigma = 1.6 2^(o + s/S); each
                  sublevel one FED cycle of explicit steps of div(g grad L),
                  g = 1 / (1 + |grad L|^2 / k^2) (Perona-Malik g2) from the
                  Scharr gradient at the cycle's start, held over the cycle,
                  on the half-grid; an octave starts from the last sublevel
                  at every second pixel, its evolution time scaled by 4^-o
  3. detection    the sigma^4-normalised Hessian determinant of Scharr
                  second derivatives, kept above 1e-4; a 3x3 maximum per
                  level, ties to the earlier pixel in raster order; then, in
                  level order, a peak dies where a stronger peak of an
                  adjacent level lies within the larger sigma (a square
                  window on the finer grid); a tie kills the coarser peak
  4. selection    a frame's best k over every level by response, ties to
                  the earlier (level, row, column), 10 pixels off each
                  level's edges; parabolic subpixel offsets on the response
  5. orientation  (Lx, Ly) at 49 points of a disc of radius 6 sigma, their
                  vector sums in 30 bins of gradient angle; the largest sum
                  over 5 bins in a row (60 degrees), the first on ties,
                  gives the angle
  6. descriptor   2x2, 3x3 and 4x4 grids over a square of half-size 5 sigma
                  turned by the angle; each cell's means of L and of the
                  turned derivatives over 4x4 points; each cell pair of a
                  grid compares each channel: (6 + 36 + 120) x 3 = 486 bits,
                  L's over every grid's pairs, then x's, then y's, zero
                  padded to 512

Samples read the level's L, Lx and Ly rounded to bfloat16, at the nearest
pixel (half to even) of a coordinate clipped to the level and then to a
window about the keypoint: 128 columns from a multiple of 128, or that
plus 64, whichever holds the keypoint's 52-pixel span; 64 rows (48, for
the orientation, from a multiple of 8 inside them) from a multiple of 8.
The program holds the window and the bfloat16 source as semantics: a clip
that bites reads another pixel.

The method is the plain one where the program's differs: a raster a
level (no stacked levels, no shifted copies), loops over levels and
stencil taps, one mean a cell. The Scharr stencils are convolutions and
take the caller's precision: float32 under pipeline.precision(False),
TF32 in the control. Nothing else here is a product.

The definition followed is the program's where it departs from the
source (AKAZE's published code and OpenMVG's); the source's value beside
it, where AKAZE's code states one:
  - contrast: of the base image's 3x3 Scharr gradient, every pixel, the
    upper bin edge, at least 1e-3 (source: of the image smoothed by a
    Gaussian of scale 1, inner pixels, the same bin edge, 0.03 where no
    bin reaches the percentile); the same k in every octave (source: k
    times 0.75 at each new octave)
  - conductivity: the Scharr gradient of L (source: of L smoothed by a
    Gaussian of scale 1)
  - FED: one step more than FED's least count n = ceil(sqrt(3T/tau_max +
    1/4) - 1/2), taken in order; T starts from sigma 0.5 (a camera blur)
  - octaves: every second pixel (source: a half-size resampling)
  - derivatives: the 3x3 Scharr stencil at every level, scaled by
    (sigma / 2^o)^4 with sigma unrounded (source: Scharr stencils that
    widen with the level's integer scale)
  - threshold 1e-4 on [0, 1] images (source: 0.001); a square
    cross-scale window
  - orientation: 49 fixed points, 30 bins, no Gaussian weights (source:
    every point within 6 sigma on a sigma grid, Gaussian weights of 2.5
    sigma, a 60-degree window swept in steps of 0.15 rad)
  - descriptor: 4x4 points a cell (source: every pixel of a cell at a
    step of the level's scale), 486 bits in channel order (source: the
    three channels' bits of a pair together)
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import common
from portbench.reference import trip

SIGMA0, START_SIGMA = 1.6, 0.5
PERCENTILE, HIST_BINS, MIN_CONTRAST = 70.0, 300, 1e-3
THRESHOLD, BORDER = 1e-4, 10
ORI_BINS, ORI_SPAN, ORI_RADIUS, ORI_RINGS = 30, 5, 6.0, 3
PATCH_HALF, GRIDS = 5.0, (2, 3, 4)
WIN_COLS, WIN_ROWS, ORI_ROWS, REACH = 128, 64, 48, 26
TAPS = ((0, 1), (0, -1), (1, 0), (-1, 0))        # east, west, south, north


class Level(NamedTuple):
    L: torch.Tensor          # (B, h, w)
    Lx: torch.Tensor
    Ly: torch.Tensor
    response: torch.Tensor
    sigma: float             # base-resolution pixels
    octave: int


def f32(x: float) -> float:
    return float(np.float32(x))


def neighbour(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(B, h, w) -> a at (y + dy, x + dx), clamped to the raster."""
    h, w = a.shape[1:]
    p = F.pad(a[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def scharr(a: torch.Tensor):
    """(B, h, w) -> (d/dx, d/dy): the 3x3 Scharr stencil (3, 10, 3) / 32,
    the edges replicated."""
    taps = torch.tensor([[[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                         [[-3.0, -10.0, -3.0], [0.0, 0.0, 0.0], [3.0, 10.0, 3.0]]],
                        dtype=a.dtype, device=a.device) / 32.0
    d = F.conv2d(F.pad(a[:, None], (1, 1, 1, 1), mode="replicate"), taps[:, None])
    return d[:, 0], d[:, 1]


def contrast(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) in [0, 1] -> k (B,)."""
    gx, gy = scharr(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    out = []
    for m in mag:
        hmax = torch.clamp(m.max(), min=1e-6)
        pos = m > 1e-6
        bins = torch.clamp((m[pos] / hmax * HIST_BINS).to(torch.int64), max=HIST_BINS - 1)
        count = torch.cumsum(torch.bincount(bins, minlength=HIST_BINS), 0)
        need = pos.sum().to(torch.float32) * (PERCENTILE / 100.0)
        first = int(torch.nonzero(count.to(torch.float32) >= need)[0, 0])
        edge = hmax * float(first + 1) / torch.tensor(float(HIST_BINS), device=img.device)
        out.append(torch.clamp(edge, min=MIN_CONTRAST))
    return torch.stack(out)


def fed_cycle(T: float, tau_max: float) -> List[float]:
    """A FED cycle's steps, float32, which sum to the time T."""
    n = max(int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1, 1)
    taus = [tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
            for j in range(n)]
    scale = T / sum(taus)
    return [f32(t * scale) for t in taus]


def scale_space(img: torch.Tensor, k: torch.Tensor, octaves: int, sublevels: int,
                tau_max: float) -> List[Level]:
    k2 = (k * k)[:, None, None]
    levels = []
    L = img
    t_prev = 0.5 * START_SIGMA ** 2
    for o in range(octaves):
        if o:
            L = L[:, ::2, ::2]
        for s in range(sublevels):
            sigma = SIGMA0 * 2.0 ** (o + s / sublevels)
            t = 0.5 * sigma * sigma
            gx, gy = scharr(L)
            g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
            half = [0.5 * (g + neighbour(g, dy, dx)) for dy, dx in TAPS]
            for tau in fed_cycle(max((t - t_prev) / 4.0 ** o, 1e-4), tau_max):
                flux = 0.0
                for c, (dy, dx) in zip(half, TAPS):
                    flux = flux + c * (neighbour(L, dy, dx) - L)
                L = L + tau * flux
            t_prev = t
            Lx, Ly = scharr(L)
            Lxx, Lxy = scharr(Lx)
            Lyy = scharr(Ly)[1]
            s4 = f32((sigma / 2.0 ** o) ** 4)
            levels.append(Level(L, Lx, Ly, s4 * (Lxx * Lyy - Lxy * Lxy), sigma, o))
    return levels


def dilate(a: torch.Tensor, r: int) -> torch.Tensor:
    """The largest of (B, h, w) >= 0 over each (2r + 1)^2 square."""
    return F.max_pool2d(a[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def across_levels(levels: List[Level], peaks: List[torch.Tensor]) -> List[torch.Tensor]:
    """Cross-scale suppression, each adjacent pair in level order."""
    peaks = list(peaks)
    for i in range(len(levels) - 1):
        a, b = peaks[i], peaks[i + 1]
        oa, ob = levels[i].octave, levels[i + 1].octave
        coarser = ob > oa
        r = math.ceil(max(levels[i].sigma, levels[i + 1].sigma) / 2.0 ** oa) + int(coarser)
        ha, wa = a.shape[1:]
        b_on_a = b.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :ha, :wa] if coarser else b
        a_dies = dilate(b_on_a, r) > a
        near_a = dilate(a, r)
        if coarser:                 # the 2x2 cells of a's grid under each b pixel
            hb, wb = b.shape[1:]
            near_a = F.max_pool2d(F.pad(near_a, (0, 2 * wb - wa, 0, 2 * hb - ha))[:, None],
                                  2, stride=2)[:, 0]
        peaks[i] = torch.where(a_dies, 0.0, a)
        peaks[i + 1] = torch.where(near_a >= b, 0.0, b)
    return peaks


def disc() -> np.ndarray:
    """The orientation's points in units of sigma, (49, 2) float32."""
    pts = [(0.0, 0.0)]
    for ring in range(1, ORI_RINGS + 1):
        rad, n = ORI_RADIUS * ring / ORI_RINGS, 8 * ring
        pts += [(rad * math.cos(2 * math.pi * j / n), rad * math.sin(2 * math.pi * j / n))
                for j in range(n)]
    return np.asarray(pts, np.float32)


def grid_points(n: int) -> np.ndarray:
    """Every grid's cells' n x n points in [-1, 1]^2, cell by cell, (29 n^2, 2)."""
    pts = []
    for g in GRIDS:
        for cy in range(g):
            for cx in range(g):
                pts += [((cx + (ix + 0.5) / n) / g * 2 - 1, (cy + (iy + 0.5) / n) / g * 2 - 1)
                        for iy in range(n) for ix in range(n)]
    return np.asarray(pts, np.float32)


def cell_pairs(g: int):
    """The compared (first, second) cells of a g x g grid."""
    return [(a, b) for a in range(g * g) for b in range(a + 1, g * g)]


def sample(plane: torch.Tensor, bi, x, y, col0, row0, rows: int) -> torch.Tensor:
    """plane (B, h, w) bf16 at (x, y) (N, P) of frames bi (N,): each
    coordinate clipped to the level, then to the window of `rows` x 128
    pixels at (row0, col0) (N,), then rounded."""
    h, w = plane.shape[1:]
    x = torch.clamp(x, 0.0, w - 1.0) - col0[:, None].to(torch.float32)
    y = torch.clamp(y, 0.0, h - 1.0) - row0[:, None].to(torch.float32)
    c = torch.round(torch.clamp(x, 0.0, WIN_COLS - 1.0)).to(torch.int64) + col0[:, None]
    r = torch.round(torch.clamp(y, 0.0, rows - 1.0)).to(torch.int64) + row0[:, None]
    return plane[bi[:, None], r, c].to(torch.float32)


def windows(x, y, h: int):
    """Level-local keypoints (N,) of a level h rows high -> the windows'
    (row0, col0, orientation row0), int64 (N,) each."""
    xi, yi = torch.round(x).to(torch.int64), torch.round(y).to(torch.int64)
    row0 = torch.div(yi - (REACH + 1), 8, rounding_mode="floor") * 8
    row0 = torch.clamp(torch.clamp(row0, min=0), max=max((h - WIN_ROWS + 7) // 8 * 8, 0))
    a = torch.clamp(xi - REACH, min=0)
    shifted = (a % 128) > 75                     # the span [a, a + 52) crosses a tile
    col0 = torch.where(shifted, (a - 64) // 128 * 128 + 64, a // 128 * 128)
    inner = torch.clamp(torch.div(yi - row0 - 17, 8, rounding_mode="floor") * 8, 0, 16)
    return row0, col0, row0 + inner


def orientation(Lx, Ly, bi, x, y, sig: float, row0, col0) -> torch.Tensor:
    pts = torch.from_numpy(disc()).to(x.device)
    sx = x[:, None] + sig * pts[:, 0]
    sy = y[:, None] + sig * pts[:, 1]
    gx = sample(Lx, bi, sx, sy, col0, row0, ORI_ROWS)
    gy = sample(Ly, bi, sx, sy, col0, row0, ORI_ROWS)
    bins = torch.clamp(torch.floor((torch.atan2(gy, gx) + math.pi) / (2 * math.pi) * ORI_BINS)
                       .to(torch.int64), 0, ORI_BINS - 1)
    hot = (bins[:, :, None] == torch.arange(ORI_BINS, device=x.device)).to(torch.float32)
    hx, hy = (gx[:, :, None] * hot).sum(1), (gy[:, :, None] * hot).sum(1)
    wx, wy = torch.zeros_like(hx), torch.zeros_like(hy)
    for s in range(ORI_SPAN):
        wx, wy = wx + torch.roll(hx, -s, 1), wy + torch.roll(hy, -s, 1)
    best = torch.argmax(wx * wx + wy * wy, dim=1, keepdim=True)
    return torch.atan2(wy.gather(1, best)[:, 0], wx.gather(1, best)[:, 0])


def descriptor(lvl, bi, x, y, sig: float, angle, row0, col0, n: int) -> torch.Tensor:
    """-> (N, 486) bool."""
    pts = torch.from_numpy(grid_points(n)).to(x.device)
    half = f32(PATCH_HALF * sig)
    u, v = pts[:, 0] * half, pts[:, 1] * half
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    sx, sy = x[:, None] + (ca * u - sa * v), y[:, None] + (sa * u + ca * v)
    L, gx, gy = (sample(p, bi, sx, sy, col0, row0, WIN_ROWS) for p in lvl)
    N = x.shape[0]
    means = [c.reshape(N, -1, n * n).mean(-1) for c in (L, ca * gx + sa * gy, -sa * gx + ca * gy)]
    bits = []
    for m in means:
        base = 0
        for g in GRIDS:
            bits += [m[:, base + a] > m[:, base + b] for a, b in cell_pairs(g)]
            base += g * g
    return torch.stack(bits, 1)


def describe(frames: torch.Tensor, k: int, octaves: int, sublevels: int, tau_max: float,
             cell_samples: int) -> trip.Keypoints:
    """(B, H, W) frames, 0-255 -> the best k keypoints of each, at base
    resolution, with their angles and descriptors."""
    dev = frames.device
    B = frames.shape[0]
    img = frames.to(torch.float32) / torch.tensor(255.0, device=dev)
    levels = scale_space(img, contrast(img), octaves, sublevels, tau_max)
    peaks = [trip.suppress(torch.where(lv.response > THRESHOLD, lv.response, 0.0))
             for lv in levels]
    peaks = across_levels(levels, peaks)
    cand, lev, ys, xs = [], [], [], []
    for l, p in enumerate(peaks):
        h, w = p.shape[1:]
        inside = torch.zeros_like(p, dtype=torch.bool)
        inside[:, BORDER:h - BORDER, BORDER:w - BORDER] = True
        cand.append(torch.where(inside, p, 0.0).reshape(B, -1))
        yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        lev.append(torch.full((h * w,), l, device=dev))
        ys.append(yy.reshape(-1))
        xs.append(xx.reshape(-1))
    score = torch.cat(cand, 1)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    top = torch.gather(score, 1, order)
    valid = top > 0
    Lv, Y, X = torch.cat(lev)[order], torch.cat(ys)[order], torch.cat(xs)[order]

    fx, fy = torch.zeros((B, k), device=dev), torch.zeros((B, k), device=dev)
    ang = torch.zeros((B, k), device=dev)
    bits = torch.zeros((B, k, trip.DESC_BITS), dtype=torch.bool, device=dev)
    for l, lv in enumerate(levels):
        bi, ki = torch.nonzero(Lv == l, as_tuple=True)
        if bi.numel() == 0:
            continue
        r = lv.response
        h, w = r.shape[1:]
        x0, y0 = X[bi, ki], Y[bi, ki]
        xc, yc = torch.clamp(x0, 1, w - 2), torch.clamp(y0, 1, h - 2)
        c = r[bi, yc, xc]
        x = x0.to(torch.float32) + trip.parabola(r[bi, yc, xc - 1], c, r[bi, yc, xc + 1])
        y = y0.to(torch.float32) + trip.parabola(r[bi, yc - 1, xc], c, r[bi, yc + 1, xc])
        sig = f32(lv.sigma / 2.0 ** lv.octave)       # level pixels
        row0, col0, row0_ori = windows(x, y, h)
        src = [p.to(torch.bfloat16) for p in (lv.L, lv.Lx, lv.Ly)]
        a = orientation(src[1], src[2], bi, x, y, sig, row0_ori, col0)
        d = descriptor(src, bi, x, y, sig, a, row0, col0, cell_samples)
        bits[bi, ki, :d.shape[1]] = d
        up = float(2 ** lv.octave)
        fx[bi, ki], fy[bi, ki], ang[bi, ki] = x * up, y * up, a
    xy = torch.where(valid[..., None], torch.stack([fx, fy], -1), 0.0)
    return trip.Keypoints(xy=xy, level=Lv, score=top, angle=ang,
                          bits=bits & valid[..., None], valid=valid)


def frontend(frames: torch.Tensor, det: dict, k: int) -> trip.Keypoints:
    """The configuration's detector group (`backend` "akaze") on (B, H, W)."""
    return describe(frames, k, *common.akaze_params(det))
