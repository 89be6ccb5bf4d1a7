"""KITTI odometry dataset ingest (counterpart of coloc_tpu.io.kitti).

BASELINE.md's accuracy target references EuRoC/KITTI sequences; this module
maps the standard KITTI odometry layout

    <root>/sequences/<NN>/image_0/<frame:06d>.png   (rectified grayscale)
    <root>/sequences/<NN>/calib.txt                 (P0..P3 3x4 projections)
    <root>/sequences/<NN>/times.txt                 (seconds per frame)
    <root>/poses/<NN>.txt                           (ground truth, 3x4 [R|t])

onto the session's frame dict: one KITTI sequence per drone (mirroring
io/euroc.py's one-ASL-sequence-per-drone convention), frames associated by
frame index — KITTI sequences carry no cross-sequence clock, so index
alignment replaces EuRoC's nearest-timestamp sync.

KITTI odometry images are rectified, so the distortion vector is zero and K
comes straight from the chosen camera's projection matrix (P = K [I | t]).
Ground-truth poses are cam0-to-world transforms whose translation column is
the camera position in the world frame — exactly the quantity the session
estimates, so ATE/RPE association is a direct row lookup.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from coloc_tpu_torch.io.disk import load_image


def _seq_dir(seq_root: str) -> str:
    """Accept either `<root>/sequences/NN` directly or a directory that
    contains a single `sequences/NN` level below it is NOT guessed — the
    caller passes the sequence directory itself (the folder holding
    image_0/ and calib.txt)."""
    if os.path.isdir(os.path.join(seq_root, "image_0")) or os.path.isfile(
        os.path.join(seq_root, "calib.txt")
    ):
        return seq_root
    raise FileNotFoundError(
        f"{seq_root} is not a KITTI sequence directory "
        "(expected image_0/ and calib.txt)"
    )


def read_calib(seq_root: str, cam: str = "image_0") -> Tuple[np.ndarray,
                                                             np.ndarray]:
    """calib.txt -> (K (3,3) float32, dist (3,) zeros).

    Parses the `P<n>:` line matching `cam` ("image_0" -> P0, ...). The
    rectified projection is P = K [I | t]; K is its left 3x3 block.
    """
    key = "P" + cam.split("_")[-1]
    path = os.path.join(_seq_dir(seq_root), "calib.txt")
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].rstrip(":") != key:
                continue
            vals = [float(v) for v in parts[1:]]
            if len(vals) != 12:
                raise ValueError(
                    f"{key} line in {path} has {len(vals)} values, want 12")
            P = np.asarray(vals, np.float64).reshape(3, 4)
            return P[:, :3].astype(np.float32), np.zeros(3, np.float32)
    raise ValueError(f"{key} not found in {path}")


def read_times(seq_root: str) -> np.ndarray:
    """times.txt -> (N,) float64 seconds; empty array when absent."""
    path = os.path.join(_seq_dir(seq_root), "times.txt")
    if not os.path.isfile(path):
        return np.zeros(0, np.float64)
    with open(path) as fh:
        return np.asarray([float(l) for l in fh if l.strip()], np.float64)


def list_frames(seq_root: str, cam: str = "image_0") -> List[Tuple[int, str]]:
    """Sorted [(frame_index, path)] for a sequence's camera directory."""
    data = os.path.join(_seq_dir(seq_root), cam)
    if not os.path.isdir(data):
        raise FileNotFoundError(f"no {cam} directory under {seq_root}")
    out = []
    for name in os.listdir(data):
        stem, ext = os.path.splitext(name)
        if ext.lower() in (".png", ".pgm") and stem.isdigit():
            out.append((int(stem), os.path.join(data, name)))
    out.sort()
    return out


def load_dataset(
    seq_roots: Sequence[str],
    num_frames: int = 0,
    stride: int = 1,
    cam: str = "image_0",
    with_indices: bool = False,
):
    """N KITTI sequences (one per drone) -> (frames, Ks, dists, (w, h))
    [+ per-drone frame-index lists with `with_indices=True`].

    Frames align by index on drone 0's (strided) timeline, truncated to the
    shortest sequence. `indices[d][i]` is the KITTI frame number of drone
    d's i-th kept frame — the row key into the poses ground-truth file.
    """
    metas = []
    for root in seq_roots:
        K, dist = read_calib(root, cam)
        metas.append((K, dist, list_frames(root, cam)))
    Ks = np.stack([m[0] for m in metas])
    dists = np.stack([m[1] for m in metas])

    n_avail = min(len(m[2]) for m in metas)
    base = list(range(0, n_avail, stride))
    if num_frames:
        base = base[:num_frames]
    frames: Dict[int, list] = {}
    indices: Dict[int, list] = {}
    for d, (_, _, flist) in enumerate(metas):
        frames[d] = [load_image(flist[i][1]) for i in base]
        indices[d] = [flist[i][0] for i in base]
    h, w = frames[0][0].shape[:2]
    if with_indices:
        return frames, Ks, dists, (w, h), indices
    return frames, Ks, dists, (w, h)


def load_groundtruth(seq_root: str):
    """KITTI poses file -> (frame_indices (N,), positions (N, 3)) or None.

    Looks for `<root>/poses/<NN>.txt` (derived from the sequence directory
    name) and `<seq>/poses.txt`. Each row is a 3x4 cam0-to-world [R|t];
    the translation column is the camera center in the world frame.
    """
    seq = _seq_dir(seq_root)
    nn = os.path.basename(os.path.normpath(seq))
    cands = [os.path.join(seq, "poses.txt")]
    up = os.path.dirname(os.path.normpath(seq))
    if os.path.basename(up) == "sequences":
        cands.append(os.path.join(os.path.dirname(up), "poses", nn + ".txt"))
    for cand in cands:
        if not os.path.isfile(cand):
            continue
        rows = []
        with open(cand) as fh:
            for line in fh:
                vals = line.split()
                if len(vals) != 12:
                    continue
                rows.append([float(v) for v in vals])
        if not rows:
            return None
        M = np.asarray(rows, np.float64).reshape(-1, 3, 4)
        idx = np.arange(M.shape[0], dtype=np.int64)
        return idx, M[:, :, 3]
    return None


def groundtruth_at(idx_gt: np.ndarray, pos_gt: np.ndarray,
                   frame_indices: Sequence[int]) -> np.ndarray:
    """Ground-truth positions for a list of frame indices -> (len, 3).
    Row lookup (poses files are dense per frame); clamps out-of-range
    indices to the last row so short pose files degrade gracefully."""
    sel = np.clip(np.asarray(frame_indices, np.int64), 0,
                  len(idx_gt) - 1)
    return pos_gt[sel]
