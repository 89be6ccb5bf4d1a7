"""Synthetic workload made with numpy (counterpart of coloc_tpu.io.synthetic,
plus a frontend-free feature generator).

The scene generator (smooth_texture, make_scene, render, trajectory)
makes camera frames with known poses: textured planes (a fenestrated near
plane over a far plane) rendered with exact projective warps. Same rng
call order and sample positions as coloc_tpu's, so one seed gives the
same frames in both packages (to float32 rounding). write_dataset writes
them as the reference's PNG sequences, with the standard library's zlib
(no PIL needed).

Arrays come out in the reference's layout (uint32 descriptors);
convert.features_from_numpy / mapdb_from_numpy make the port's tensors.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from coloc_tpu_torch.geometry import so3
from coloc_tpu_torch.ops.pyramid import _resize_matrix
from coloc_tpu_torch.types import DESC_WORDS


class SyntheticScene(NamedTuple):
    textures: List[np.ndarray]   # per-plane texture (H, W)
    alphas: List[np.ndarray]     # per-plane visibility mask (H, W)
    depths: List[float]          # plane depths (z = const in world frame)
    K: np.ndarray                # (3, 3)


def smooth_texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-octave value-noise texture with FAST-detectable structure. The
    bilinear upsampling is jax.image.resize(method="linear")'s: for an
    upsample its sample positions are pyramid._resize_matrix's."""
    img = np.zeros((h, w), np.float32)
    for cell, amp in [(8, 120.0), (16, 80.0), (32, 60.0)]:
        c = rng.uniform(0, 1, (h // cell + 2, w // cell + 2)).astype(np.float32)
        up = (_resize_matrix(c.shape[0], h + cell) @ c
              @ _resize_matrix(c.shape[1], w + cell).T)
        img += amp * up[:h, :w]
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize(method="nearest")'s source index per output index:
    floor((i + 0.5) * n_in / n_out), computed in float32 as jax does."""
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return np.floor(pos / np.float32(n_out)).astype(np.int64)


def make_scene(
    height: int, width: int, K: np.ndarray, seed: int = 0,
    depths: Tuple[float, float] = (6.0, 12.0), near_coverage: float = 0.45,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    tex = [smooth_texture(height, width, rng) for _ in depths]
    mask_coarse = (rng.uniform(0, 1, (6, 8)) < near_coverage).astype(np.float32)
    near_alpha = mask_coarse[_nearest_index(6, height)[:, None],
                             _nearest_index(8, width)[None, :]]
    alphas = [near_alpha] + [np.ones((height, width), np.float32)] * (len(depths) - 1)
    return SyntheticScene(textures=tex, alphas=alphas, depths=list(depths),
                          K=np.asarray(K, np.float32))


def _bilinear(img, x, y):
    h, w = img.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def render(scene: SyntheticScene, R: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Render the scene from pose (R, C); z-buffered over the planes."""
    K = scene.K
    h, w = scene.textures[0].shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w, np.float32)])
    img = np.zeros(h * w, np.float32)
    best_z = np.full(h * w, 1e9, np.float32)
    n = np.array([0, 0, 1.0])
    t = -R @ C
    Kinv = np.linalg.inv(K)
    for tex, alpha, Z in zip(scene.textures, scene.alphas, scene.depths):
        Hm = K @ (R + np.outer(t, n) / Z) @ Kinv   # plane homography view1->this
        Hinv = np.linalg.inv(Hm)
        src = Hinv @ pts
        s = src[:2] / src[2]
        w1 = Kinv @ np.vstack([s, np.ones(h * w)]) * Z
        zc = (R @ (w1 - C[:, None]))[2]
        a = _bilinear(alpha, np.clip(s[0], 0, w - 1.01), np.clip(s[1], 0, h - 1.01))
        vis = (
            (s[0] >= 0) & (s[0] < w - 1) & (s[1] >= 0) & (s[1] < h - 1)
            & (zc > 0) & (zc < best_z) & (a > 0.5)
        )
        vals = _bilinear(tex, s[0], s[1])
        img = np.where(vis, vals, img)
        best_z = np.where(vis, zc, best_z)
    return img.reshape(h, w)


def trajectory(num_frames: int, drone: int, seed: int = 7):
    """Smooth per-drone ground-truth trajectory: (R (F,3,3), C (F,3))."""
    base = np.array([0.6 * drone, 0.1 * drone, 0.0], np.float32)
    Rs, Cs = [], []
    for f in range(num_frames):
        tpar = f / max(num_frames - 1, 1)
        w = np.array([
            0.02 * np.sin(2 * np.pi * tpar + drone),
            -0.05 * tpar,
            0.01 * np.cos(2 * np.pi * tpar),
        ], np.float32)
        C = base + np.array([0.5 * tpar, 0.1 * np.sin(2 * np.pi * tpar), 0.05 * tpar],
                            np.float32)
        Rs.append(so3.exp(torch.from_numpy(w)).numpy())
        Cs.append(C)
    return np.stack(Rs), np.stack(Cs)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG of a (H, W) uint8 image: filter byte 0 on
    every row, one IDAT chunk."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _png_chunk(b"IEND", b""))


def write_dataset(folder: str, scene: SyntheticScene, num_drones: int,
                  num_frames: int) -> dict:
    """Write `img__Quad{id}_{frame:04d}.png` sequences (InterfaceDisk
    parity) of each drone's trajectory, and the ground-truth poses to
    groundtruth.npz. Returns {'Rs': (D, F, 3, 3), 'Cs': (D, F, 3)}."""
    os.makedirs(folder, exist_ok=True)
    gt_R = np.zeros((num_drones, num_frames, 3, 3), np.float32)
    gt_C = np.zeros((num_drones, num_frames, 3), np.float32)
    for d in range(num_drones):
        Rs, Cs = trajectory(num_frames, d)
        for f in range(num_frames):
            img = render(scene, Rs[f], Cs[f])
            write_png(os.path.join(folder, f"img__Quad{d}_{f:04d}.png"), img.astype(np.uint8))
            gt_R[d, f] = Rs[f]
            gt_C[d, f] = Cs[f]
    np.savez(os.path.join(folder, "groundtruth.npz"), Rs=gt_R, Cs=gt_C)
    return {"Rs": gt_R, "Cs": gt_C}


class FeaturesArrays(NamedTuple):
    xy: np.ndarray      # (K, 2) float32
    score: np.ndarray   # (K,) float32
    scale: np.ndarray   # (K,) int32
    angle: np.ndarray   # (K,) float32
    desc: np.ndarray    # (K, 16) uint32
    valid: np.ndarray   # (K,) bool


class MapDBArrays(NamedTuple):
    X: np.ndarray       # (L, 3) float32
    desc: np.ndarray    # (L, 16) uint32
    valid: np.ndarray   # (L,) bool


def _random_desc(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, (n, DESC_WORDS), dtype=np.uint64).astype(np.uint32)


def random_features(h: int, w: int, kp: int,
                    rng: np.random.Generator) -> FeaturesArrays:
    """kp valid keypoints uniform over a w x h image with random 512-bit
    descriptors (stands in for the frontend where a run needs no images).
    Draws, in order: xy, score, angle, desc."""
    xy = rng.uniform((0.0, 0.0), (w - 1.0, h - 1.0), (kp, 2)).astype(np.float32)
    score = rng.uniform(0.0, 1.0, kp).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, kp).astype(np.float32)
    return FeaturesArrays(xy=xy, score=score, scale=np.zeros(kp, np.int32),
                          angle=angle, desc=_random_desc(rng, kp),
                          valid=np.ones(kp, bool))


def consistent_mapdb(feats, K: np.ndarray, num_landmarks: int,
                     rng: np.random.Generator,
                     depth_range: Tuple[float, float] = (5.0, 14.0)
                     ) -> MapDBArrays:
    """Geometrically consistent map for a frame: the first kp landmarks sit
    on the frame's feature bearings at random depths (X = d K^-1 [u, v, 1])
    with the frame's own descriptors; the rest are random landmarks with
    random descriptors. Same recipe and rng call order as coloc_tpu's, so
    one seed gives one map in both packages."""
    kp = int(feats.xy.shape[0])
    L = int(num_landmarks)
    pad = max(L - kp, 0)
    uv = np.asarray(feats.xy)
    depths = rng.uniform(*depth_range, (kp, 1)).astype(np.float32)
    dirs = (np.linalg.inv(np.asarray(K))
            @ np.c_[uv, np.ones(kp)].T).T.astype(np.float32)
    X = np.concatenate(
        [dirs * depths, rng.uniform(-3, 3, (pad, 3)).astype(np.float32)],
        axis=0,
    )[:L]
    desc = np.concatenate([np.asarray(feats.desc, np.uint32),
                           _random_desc(rng, pad)])[:L]
    return MapDBArrays(X=X.astype(np.float32), desc=desc, valid=np.ones(L, bool))


def five_point_edge_samples() -> Tuple[np.ndarray, np.ndarray]:
    """Minimal five-point samples at the solver's numeric edges, x1 and x2
    (4, 5, 2) float32 normalised coordinates: two identical points (a rank-4
    design matrix, where the Householder steps' 1e-30 guards act); five
    collinear points in both views; every point at the origin (Gauss-Jordan
    meets its 1e-20 pivot floor three times); a NaN coordinate (NaN through
    every output)."""
    rng = np.random.default_rng(0)
    P = np.c_[rng.uniform(-3, 3, (5, 2)), rng.uniform(5, 15, (5, 1))]
    Pc = P - [0.3, 0.05, 0.0]
    a, b = P[:, :2] / P[:, 2:], Pc[:, :2] / Pc[:, 2:]
    dup1, dup2 = a.copy(), b.copy()
    dup1[1], dup2[1] = dup1[0], dup2[0]
    t = np.linspace(-1.0, 1.0, 5)
    nan1 = a.copy()
    nan1[2, 0] = np.nan
    x1 = np.stack([dup1, np.c_[t, 0.5 * t + 0.1], np.zeros((5, 2)), nan1])
    x2 = np.stack([dup2, np.c_[t + 0.05, 0.5 * t + 0.12], np.zeros((5, 2)), b])
    return x1.astype(np.float32), x2.astype(np.float32)


def dk_edge_polys() -> np.ndarray:
    """Degree-10 polynomials at the Durand-Kerner stage's edges, ascending
    coefficients (11, 4) float32 as the five-point front hands them on: a
    double root at 1; a leading coefficient of 1e-14, under
    dk_normalise's 1e-12 floor; an infinite and a NaN coefficient (no real
    root)."""
    rng = np.random.default_rng(1)
    double = np.poly([1.0, 1.0, -2.0, 3.0, 0.5, -0.7, 1.5, -1.2, 2.5, -3.0])[::-1]
    tiny = rng.normal(size=11)
    tiny[10] = 1e-14
    inf_row, nan_row = rng.normal(size=11), rng.normal(size=11)
    inf_row[4], nan_row[7] = np.inf, np.nan
    return np.stack([double, tiny, inf_row, nan_row], axis=1).astype(np.float32)


def plant_polish_edges(md, coef, basis, seeds, svalid):
    """The five-point polish's operands (md (40, 20, B), coef (40, B),
    basis (36, B), seeds and svalid (30, B), B >= 2) with its numeric edges
    planted in place: seed rows 0, 1, 5, 12 and 29 set to NaN, +inf, -inf,
    1e30 and -1e30 in every sample and marked valid (row 29 is the seed that
    a spare lane of the kernel repeats); sample 1's MD and coefficients all
    zero, so both determinant floors (1e-20) act. -> the operands."""
    for row, value in ((0, float("nan")), (1, float("inf")), (5, float("-inf")),
                       (12, 1e30), (29, -1e30)):
        seeds[row] = value
        svalid[row] = True
    md[:, :, 1] = 0.0
    coef[:, 1] = 0.0
    return md, coef, basis, seeds, svalid
