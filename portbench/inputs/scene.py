"""The benchmark's scene and trajectory generator.

A frozen copy of the port's `io/synthetic` scene (value-noise textures on
a fenestrated near plane over a far plane, rendered with exact projective
warps, and the smooth per-drone trajectory), with the same numpy draws in
the same order, so one seed gives the same textures. The textures are
made on the host; the frames are rendered on the device in float64 (the
numpy render's precision), many poses a call, and returned as float32.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class Scene(NamedTuple):
    textures: List[np.ndarray]   # per plane (H, W) float32
    alphas: List[np.ndarray]     # per plane visibility (H, W) float32
    depths: List[float]          # plane depths, z = const in the world frame
    K: np.ndarray                # (3, 3) float32


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bilinear resample matrix (jax.image.resize's
    linear sample positions, edge clamped)."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - f)
    np.add.at(m, (np.arange(n_out), hi), f)
    return m


def smooth_texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-octave value noise with FAST-detectable structure, 0-255."""
    img = np.zeros((h, w), np.float32)
    for cell, amp in [(8, 120.0), (16, 80.0), (32, 60.0)]:
        c = rng.uniform(0, 1, (h // cell + 2, w // cell + 2)).astype(np.float32)
        up = resize_matrix(c.shape[0], h + cell) @ c @ resize_matrix(c.shape[1], w + cell).T
        img += amp * up[:h, :w]
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return np.floor(pos / np.float32(n_out)).astype(np.int64)


def make_scene(height: int, width: int, K: np.ndarray, seed: int,
               depths: Tuple[float, ...] = (6.0, 12.0),
               near_coverage: float = 0.45) -> Scene:
    rng = np.random.default_rng(seed)
    tex = [smooth_texture(height, width, rng) for _ in depths]
    mask_coarse = (rng.uniform(0, 1, (6, 8)) < near_coverage).astype(np.float32)
    near_alpha = mask_coarse[_nearest_index(6, height)[:, None],
                             _nearest_index(8, width)[None, :]]
    alphas = [near_alpha] + [np.ones((height, width), np.float32)] * (len(depths) - 1)
    return Scene(textures=tex, alphas=alphas, depths=list(depths),
                 K=np.asarray(K, np.float32))


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rotation vector (3,) -> rotation matrix (3, 3), Rodrigues."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    Wx = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-8:
        return (np.eye(3) + Wx + 0.5 * Wx @ Wx).astype(np.float32)
    return (np.eye(3) + np.sin(th) / th * Wx
            + (1.0 - np.cos(th)) / th ** 2 * Wx @ Wx).astype(np.float32)


def pose_at(t: float, drone: int) -> Tuple[np.ndarray, np.ndarray]:
    """A drone's pose at t in [0, 1] along its smooth path: (R, C)."""
    base = np.array([0.6 * drone, 0.1 * drone, 0.0], np.float32)
    w = np.array([0.02 * np.sin(2 * np.pi * t + drone), -0.05 * t,
                  0.01 * np.cos(2 * np.pi * t)], np.float32)
    C = base + np.array([0.5 * t, 0.1 * np.sin(2 * np.pi * t), 0.05 * t], np.float32)
    return so3_exp(w), C


def trajectory(num_frames: int, drone: int) -> Tuple[np.ndarray, np.ndarray]:
    """A drone's path at num_frames evenly spaced t: (R (F, 3, 3), C (F, 3))."""
    poses = [pose_at(f / max(num_frames - 1, 1), drone) for f in range(num_frames)]
    return np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses])


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (H, W) sampled at (N, P) float64 positions, clamped inside."""
    h, w = img.shape
    x = torch.clamp(x, 0, w - 1.001)
    y = torch.clamp(y, 0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1).to(torch.float64)

    def at(yy, xx):
        return flat[yy * w + xx]

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


def render(scene: Scene, Rs: np.ndarray, Cs: np.ndarray, device,
           block: int = 16) -> torch.Tensor:
    """Frames of the scene from poses Rs (N, 3, 3), Cs (N, 3) -> (N, H, W)
    float32 on `device`, z-buffered over the planes; `block` poses a pass."""
    h, w = scene.textures[0].shape
    tex = [torch.from_numpy(t).to(device) for t in scene.textures]
    alp = [torch.from_numpy(a).to(device) for a in scene.alphas]
    K = np.asarray(scene.K, np.float64)
    Kinv = np.linalg.inv(K)
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float64),
                            torch.arange(w, device=device, dtype=torch.float64),
                            indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1), torch.ones_like(xx).reshape(-1)])
    Kinv_t = torch.from_numpy(Kinv).to(device)
    out = []
    for i in range(0, len(Rs), block):
        R = np.asarray(Rs[i:i + block], np.float64)
        C = np.asarray(Cs[i:i + block], np.float64)
        n = R.shape[0]
        t = -np.einsum("nij,nj->ni", R, C)
        img = torch.zeros((n, h * w), dtype=torch.float64, device=device)
        best = torch.full((n, h * w), 1e9, dtype=torch.float64, device=device)
        R_t = torch.from_numpy(R).to(device)
        C_t = torch.from_numpy(C).to(device)
        for tx, al, Z in zip(tex, alp, scene.depths):
            # the plane's homography from the reference view to this one
            Hm = K @ (R + t[:, :, None] * np.array([0.0, 0.0, 1.0])[None, None, :] / Z) @ Kinv
            Hinv = torch.from_numpy(np.linalg.inv(Hm)).to(device)
            src = Hinv @ pts                                   # (n, 3, P)
            sx, sy = src[:, 0] / src[:, 2], src[:, 1] / src[:, 2]
            w1 = (Kinv_t @ torch.stack([sx, sy, torch.ones_like(sx)], dim=1)) * Z
            zc = (R_t @ (w1 - C_t[:, :, None]))[:, 2]
            a = _bilinear(al, torch.clamp(sx, 0, w - 1.01), torch.clamp(sy, 0, h - 1.01))
            vis = ((sx >= 0) & (sx < w - 1) & (sy >= 0) & (sy < h - 1)
                   & (zc > 0) & (zc < best) & (a > 0.5))
            img = torch.where(vis, _bilinear(tx, sx, sy), img)
            best = torch.where(vis, zc, best)
        out.append(img.reshape(n, h, w).to(torch.float32))
    return torch.cat(out)


def plane_depth(scene: Scene, xy: np.ndarray) -> np.ndarray:
    """The depth of the plane that each pixel (N, 2) of the reference view
    (identity pose) sees: the near plane where its mask is set."""
    h, w = scene.textures[0].shape
    x = np.clip(xy[:, 0], 0, w - 1.01)
    y = np.clip(xy[:, 1], 0, h - 1.01)
    a = _bilinear(torch.from_numpy(scene.alphas[0]), torch.from_numpy(x.astype(np.float64)),
                  torch.from_numpy(y.astype(np.float64))).numpy()
    return np.where(a > 0.5, scene.depths[0], scene.depths[-1])
