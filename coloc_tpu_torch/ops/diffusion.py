"""Nonlinear diffusion scale space, the AKAZE backbone (counterpart of
coloc_tpu.ops.diffusion).

Reference parity: the OpenMVG AKAZE path (CPUDetector.hpp + AKAZE.hpp)
builds a nonlinear scale space by Fast Explicit Diffusion: octaves of
evolution levels where structure diffuses everywhere except across strong
edges (Perona-Malik conductivity g2 = 1 / (1 + |grad L|^2 / k^2)), and
detects extrema of the sigma^4-normalised Hessian determinant.

  contrast_factor   — k per image: a 300-bin histogram percentile by a
                      9-step binary search, kept on the device
  fed_tau_cycle     — FED step sizes (the same Python as coloc_tpu)
  fed_octave        — B10: one whole octave (every FED cycle and each
                      sublevel's L, Lx, Ly, response) in ONE launch of
                      csrc/fed_octave.cu on a CUDA tensor, fed_octave_plain
                      on a CPU tensor
  build_scale_space(_batch) — one fed_octave per octave, L[:, ::2, ::2]
                      between octaves

coloc_tpu computes an octave in two forms, its Pallas kernel and an XLA
per-step loop (_diffusion_step, _hessian_response), which differ in the
Scharr summation order. Its tests run the Pallas kernel, so the port
follows the kernel's order on both devices: _scharr_streamed accumulates
the eight weighted neighbours in the kernel's (dy, dx) order, skips zero
weights, then divides by 32. Every neighbour access clamps at the image
border (pad(mode="edge")); the TPU kernel's row bands, 8-aligned halos and
128-lane padding are layout, not semantics. The step sizes and sigma^4
scales are rounded to float32 once on the host, as JAX's weak typing bakes
them into the trace.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from coloc_tpu_torch.ops import _build, dispatch

_MAX_SUBLEVELS = 8    # csrc/fed_octave.cu's Plan capacity
_MAX_STEPS = 128


class Evolution(NamedTuple):
    """One nonlinear scale-space level, (B, H, W) planes."""

    L: torch.Tensor          # diffused image
    Lx: torch.Tensor         # Scharr x-derivative
    Ly: torch.Tensor
    response: torch.Tensor   # sigma^4-normalised Hessian determinant
    sigma: float             # scale in base-image pixels
    octave: int              # downsampling power


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped neighbour view of (..., H, W): the value at (y + dy,
    x + dx) clamped to the raster, as pad(mode="edge") then shift."""
    if dy == 1:
        a = torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    elif dy == -1:
        a = torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)
    if dx == 1:
        a = torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)
    elif dx == -1:
        a = torch.cat([a[..., :, :1], a[..., :, :-1]], dim=-1)
    return a


def _scharr(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr 3x3 derivatives in coloc_tpu's XLA form (the one its
    contrast_factor uses): 3 (a - b) + 10 (c - d) + 3 (e - f), over 32."""
    def s(dy, dx):
        return _shift(img, dy, dx)

    gx = (3.0 * (s(-1, 1) - s(-1, -1)) + 10.0 * (s(0, 1) - s(0, -1))
          + 3.0 * (s(1, 1) - s(1, -1))) / 32.0
    gy = (3.0 * (s(1, -1) - s(-1, -1)) + 10.0 * (s(1, 0) - s(-1, 0))
          + 3.0 * (s(1, 1) - s(-1, 1))) / 32.0
    return gx, gy


# Scharr weights (dy, dx, wx, wy) in the order coloc_tpu's kernel streams
# them; csrc/fed_octave.cu repeats this order
_SCHARR_STREAM = (
    (-1, -1, -3.0, -3.0), (-1, 0, 0.0, -10.0), (-1, 1, 3.0, -3.0),
    (0, -1, -10.0, 0.0), (0, 1, 10.0, 0.0),
    (1, -1, -3.0, 3.0), (1, 0, 0.0, 10.0), (1, 1, 3.0, 3.0),
)


def _scharr_streamed(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr derivatives in the TPU kernel's order: from zero, add w * v
    for each non-zero weight in _SCHARR_STREAM order, then divide by 32."""
    sgx = torch.zeros_like(a)
    sgy = torch.zeros_like(a)
    for dy, dx, wx, wy in _SCHARR_STREAM:
        v = _shift(a, dy, dx)
        if wx:
            sgx = sgx + wx * v
        if wy:
            sgy = sgy + wy * v
    return sgx / 32.0, sgy / 32.0


def _true_div(a: torch.Tensor, scalar: float) -> torch.Tensor:
    """a / scalar rounded as one IEEE division on every device (CUDA turns
    a division by a Python scalar into a product with its reciprocal)."""
    return a / torch.full((), scalar, dtype=a.dtype, device=a.device)


def contrast_factor(image: torch.Tensor, percentile: float = 70.0,
                    nbins: int = 300) -> torch.Tensor:
    """k per image of (..., H, W): the percentile of the non-zero gradient
    magnitudes on a 300-bin histogram (OpenMVG Compute_Contrast_Factor),
    k = hmax * (b + 1) / nbins at the first bin b whose cumulative count
    reaches the percentile. The bin is found by ceil(log2(nbins)) counting
    passes of a binary search, and k stays on the device."""
    gx, gy = _scharr(image)
    mag = torch.sqrt(gx * gx + gy * gy)
    pos = mag > 1e-6
    hmax = torch.clamp(mag.amax(dim=(-2, -1)), min=1e-6)
    idx = torch.clamp((mag / hmax[..., None, None] * nbins).to(torch.int32),
                      max=nbins - 1)
    npos = pos.sum(dim=(-2, -1), dtype=torch.int32)
    target = npos.to(torch.float32) * (percentile / 100.0)
    lo = torch.zeros_like(npos)
    hi = torch.full_like(npos, nbins - 1)
    for _ in range(max(int(math.ceil(math.log2(nbins))), 1)):
        mid = (lo + hi) // 2
        cnt = (pos & (idx <= mid[..., None, None])).sum(dim=(-2, -1),
                                                       dtype=torch.int32)
        reached = cnt.to(torch.float32) >= target
        lo, hi = torch.where(reached, lo, mid + 1), torch.where(reached, mid, hi)
    k = _true_div(hmax * (lo.to(torch.float32) + 1.0), float(nbins))
    return torch.clamp(k, min=1e-3)


def fed_tau_cycle(T: float, tau_max: float = 0.25) -> List[float]:
    """FED step sizes summing to T (fed_tau_by_process_time equivalent)."""
    n = max(int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1, 1)
    taus = [
        tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
        for j in range(n)
    ]
    scale = T / sum(taus)
    return [t * scale for t in taus]


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step of div(g grad L) with half-grid conductivities,
    coloc_tpu's XLA form."""
    def s(a, dy, dx):
        return _shift(a, dy, dx)

    g_e = 0.5 * (g + s(g, 0, 1))
    g_w = 0.5 * (g + s(g, 0, -1))
    g_s = 0.5 * (g + s(g, 1, 0))
    g_n = 0.5 * (g + s(g, -1, 0))
    flux = (g_e * (s(L, 0, 1) - L) + g_w * (s(L, 0, -1) - L)
            + g_s * (s(L, 1, 0) - L) + g_n * (s(L, -1, 0) - L))
    return L + tau * flux


def _hessian_response(L: torch.Tensor, sigma_px: float):
    """sigma^4-normalised Hessian determinant + first derivatives, coloc_tpu's
    XLA form."""
    Lx, Ly = _scharr(L)
    Lxx, Lxy = _scharr(Lx)
    _, Lyy = _scharr(Ly)
    return (sigma_px ** 2) ** 2 * (Lxx * Lyy - Lxy * Lxy), Lx, Ly


def _f32(x: float) -> float:
    return float(np.float32(x))


def fed_octave_plain(L: torch.Tensor, k2: torch.Tensor,
                     cycles: Sequence[Sequence[float]],
                     sigma4s: Sequence[float]):
    """Plain twin of csrc/fed_octave.cu: (B, H, W) float32 base images and
    (B,) squared contrast factors -> (L, Lx, Ly, response), each (B, S, H,
    W). Per cycle: g from the Scharr gradient, held fixed across the
    cycle's explicit steps (FED parity); after them each sublevel's Scharr
    derivatives, which double as the next cycle's gradient, and the
    response. The arithmetic is the TPU kernel's, operation by operation."""
    k2 = k2.to(torch.float32)[:, None, None]
    dLx, dLy = _scharr_streamed(L)
    outs = []
    for s, taus in enumerate(cycles):
        g = 1.0 / (1.0 + (dLx * dLx + dLy * dLy) / k2)
        g_e = 0.5 * (g + _shift(g, 0, 1))
        g_w = 0.5 * (g + _shift(g, 0, -1))
        g_s = 0.5 * (g + _shift(g, 1, 0))
        g_n = 0.5 * (g + _shift(g, -1, 0))
        for tau in taus:
            flux = (g_e * (_shift(L, 0, 1) - L) + g_w * (_shift(L, 0, -1) - L)
                    + g_s * (_shift(L, 1, 0) - L) + g_n * (_shift(L, -1, 0) - L))
            L = L + _f32(tau) * flux
        dLx, dLy = _scharr_streamed(L)
        Lxx, Lxy = _scharr_streamed(dLx)
        _, Lyy = _scharr_streamed(dLy)
        outs.append((L, dLx, dLy, _f32(sigma4s[s]) * (Lxx * Lyy - Lxy * Lxy)))
    return tuple(torch.stack([o[i] for o in outs], dim=1) for i in range(4))


def _plan(cycles, sigma4s):
    """The octave's schedule as the kernel's host arrays: step counts,
    float32 step sizes and sigma^4 scales."""
    S = len(cycles)
    n = [len(t) for t in cycles]
    if not 1 <= S <= _MAX_SUBLEVELS or min(n) < 1 or sum(n) > _MAX_STEPS:
        raise ValueError(f"fed_octave: {S} sublevels of {n} steps; the kernel "
                         f"takes 1-{_MAX_SUBLEVELS} sublevels, >= 1 step each, "
                         f"<= {_MAX_STEPS} steps in all")
    return ((ctypes.c_int * S)(*n),
            (ctypes.c_float * sum(n))(*[t for taus in cycles for t in taus]),
            (ctypes.c_float * S)(*sigma4s))


def _fed_octave_cuda(L, k2, cycles, sigma4s):
    dev = L.device
    B, H, W = L.shape
    S = len(cycles)
    dispatch.check_operand(L, "L", torch.float32, (B, H, W), dev)
    dispatch.check_operand(k2, "k2", torch.float32, (B,), dev)
    nsteps, taus, s4 = _plan(cycles, sigma4s)
    out = torch.empty((4, B, S, H, W), dtype=torch.float32, device=dev)
    scratch = torch.empty((3, B, H, W), dtype=torch.float32, device=dev)
    _build.launch("coloc_fed_octave", L.data_ptr(), k2.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                  out[3].data_ptr(), scratch.data_ptr(), B, H, W, S,
                  ctypes.addressof(nsteps), ctypes.addressof(taus),
                  ctypes.addressof(s4), dev.index, dispatch.stream_handle(dev))
    dispatch.count_launch("fed_octave")
    return tuple(out)


def fed_octave(L: torch.Tensor, k2: torch.Tensor,
               cycles: Sequence[Sequence[float]], sigma4s: Sequence[float]):
    """One octave: (B, H, W) float32 images, (B,) float32 k^2, the cycles'
    step sizes and the sublevels' sigma^4 scales -> (L, Lx, Ly, response),
    each (B, S, H, W)."""
    if dispatch.use_kernel(L):
        return _fed_octave_cuda(L.contiguous(), k2.to(torch.float32).contiguous(),
                                cycles, sigma4s)
    return fed_octave_plain(L, k2, cycles, sigma4s)


@functools.lru_cache(maxsize=32)
def octave_schedule(num_octaves: int, num_sublevels: int, sigma0: float,
                    tau_max: float):
    """Per octave (sigmas, cycles, sigma4s): the static schedule coloc_tpu
    bakes into its trace. Evolution time t = sigma^2 / 2 is advanced on the
    current octave's grid, where halving the resolution scales time by 4."""
    plan = []
    t_prev = 0.5 * 0.5 ** 2  # camera blur sigma ~0.5
    for o in range(num_octaves):
        sigmas, cycles = [], []
        for s in range(num_sublevels):
            sigma = sigma0 * (2.0 ** (o + s / num_sublevels))
            t = 0.5 * sigma * sigma
            dt = max((t - t_prev) / 4.0 ** o, 1e-4)
            sigmas.append(sigma)
            cycles.append(tuple(_f32(x) for x in fed_tau_cycle(dt, tau_max)))
            t_prev = t
        sigma4s = tuple(_f32((sg / (2.0 ** o)) ** 4) for sg in sigmas)
        plan.append((tuple(sigmas), tuple(cycles), sigma4s))
    return tuple(plan)


def build_scale_space_batch(images: torch.Tensor, num_octaves: int = 4,
                            num_sublevels: int = 4, sigma0: float = 1.6,
                            percentile: float = 70.0, tau_max: float = 0.25,
                            ) -> List[Evolution]:
    """(B, H, W) grayscale -> Evolution levels with (B, h_o, w_o) planes:
    octave o holds the image at 2^-o resolution, one FED cycle a sublevel,
    one fed_octave launch an octave for the whole batch."""
    img = _true_div(images.to(torch.float32), 255.0)
    k = contrast_factor(img, percentile)
    k2 = k * k
    levels: List[Evolution] = []
    L = img
    schedule = octave_schedule(num_octaves, num_sublevels, sigma0, tau_max)
    for o, (sigmas, cycles, sigma4s) in enumerate(schedule):
        Ls, Lxs, Lys, resps = fed_octave(L, k2, cycles, sigma4s)
        for s in range(num_sublevels):
            levels.append(Evolution(L=Ls[:, s], Lx=Lxs[:, s], Ly=Lys[:, s],
                                    response=resps[:, s], sigma=sigmas[s],
                                    octave=o))
        L = Ls[:, num_sublevels - 1]
        if o + 1 < num_octaves:
            L = L[:, ::2, ::2].contiguous()
    return levels


def build_scale_space(image: torch.Tensor, num_octaves: int = 4,
                      num_sublevels: int = 4, sigma0: float = 1.6,
                      percentile: float = 70.0) -> List[Evolution]:
    """Single-image form of build_scale_space_batch: (H, W) planes."""
    levels = build_scale_space_batch(image[None], num_octaves, num_sublevels,
                                     sigma0, percentile)
    return [ev._replace(L=ev.L[0], Lx=ev.Lx[0], Ly=ev.Ly[0],
                        response=ev.response[0]) for ev in levels]
