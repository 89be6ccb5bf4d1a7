"""EuRoC-MAV dataset ingest (counterpart of coloc_tpu.io.euroc).

BASELINE.md's accuracy target references EuRoC/KITTI sequences; the reference
itself reads its own `img__Quad{d}_{f:04d}.png` shared-folder convention
(InterfaceDisk.hpp:13-14). This module maps the standard EuRoC ASL layout

    <root>/<drone_dir>/mav0/cam0/data/<timestamp_ns>.png
    <root>/<drone_dir>/mav0/cam0/sensor.yaml      (intrinsics + distortion)

(or the per-sequence `mav0/...` directly) onto the session's frame dict: one
EuRoC sequence per drone, frames associated by sorted timestamp index, with
nearest-timestamp alignment across drones when sequences are offset.

The sensor.yaml parser is a minimal line reader for the two fields the
pipeline needs (`intrinsics: [fu, fv, cu, cv]` and
`distortion_coefficients: [k1, k2, p1, p2]` — radial terms map to the
radial-K3 camera; EuRoC's small tangential terms are not modeled, matching
the reference's radial-only `Pinhole_Intrinsic_Radial_K3`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from coloc_tpu_torch.io.disk import load_image


def _cam_dir(seq_root: str, cam: str = "cam0") -> str:
    """Resolve `<seq>/mav0/cam0` whether seq_root includes mav0 or not."""
    for cand in (os.path.join(seq_root, "mav0", cam),
                 os.path.join(seq_root, cam)):
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(f"no {cam} directory under {seq_root}")


def read_sensor_yaml(path: str) -> Tuple[np.ndarray, np.ndarray,
                                         Tuple[int, int]]:
    """sensor.yaml -> (K (3,3), dist (3,) radial-K3, (width, height)).

    Minimal parser: finds `intrinsics`, `distortion_coefficients`, and
    `resolution` bracket lists without a YAML dependency.
    """
    text = open(path).read()

    def bracket_list(key):
        m = re.search(rf"{key}\s*:\s*\[([^\]]*)\]", text)
        if not m:
            raise ValueError(f"{key} not found in {path}")
        return [float(v) for v in m.group(1).split(",")]

    fu, fv, cu, cv = bracket_list("intrinsics")
    dist_raw = bracket_list("distortion_coefficients")
    res = bracket_list("resolution")
    K = np.array([[fu, 0.0, cu], [0.0, fv, cv], [0.0, 0.0, 1.0]], np.float32)
    # radial-tangential [k1, k2, p1, p2] -> radial-K3 (k1, k2, 0); EuRoC's
    # tangential terms are ~1e-4 and dropped (radial-only camera model,
    # Pinhole_Intrinsic_Radial_K3 parity)
    dist = np.array([dist_raw[0], dist_raw[1], 0.0], np.float32)
    return K, dist, (int(res[0]), int(res[1]))


def list_frames(seq_root: str, cam: str = "cam0") -> List[Tuple[int, str]]:
    """Sorted [(timestamp_ns, path)] for a sequence's camera."""
    data = os.path.join(_cam_dir(seq_root, cam), "data")
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
    cam: str = "cam0",
    with_timestamps: bool = False,
):
    """N EuRoC sequences (one per drone) -> (frames, Ks, dists, (w, h))
    [+ timestamps with `with_timestamps=True`].

    Frames are aligned by NEAREST TIMESTAMP to drone 0's (strided) timeline —
    the ApproximateTimeSync analog for recorded data; `frames[d][i]` is the
    image of drone d closest in time to drone 0's i-th kept frame.
    `timestamps[d][i]` is that frame's own timestamp (ns) — the key for
    ground-truth association (load_groundtruth).
    """
    metas = []
    for root in seq_roots:
        K, dist, size = read_sensor_yaml(
            os.path.join(_cam_dir(root, cam), "sensor.yaml"))
        metas.append((K, dist, size, list_frames(root, cam)))
    Ks = np.stack([m[0] for m in metas])
    dists = np.stack([m[1] for m in metas])
    size = metas[0][2]

    base = metas[0][3][::stride]
    if num_frames:
        base = base[:num_frames]
    frames: Dict[int, list] = {}
    stamps: Dict[int, list] = {}
    for d, (_, _, _, flist) in enumerate(metas):
        ts = np.asarray([t for t, _ in flist], np.int64)
        picks = []
        for t0, _ in base:
            picks.append(int(np.argmin(np.abs(ts - t0))))
        frames[d] = [load_image(flist[i][1]) for i in picks]
        stamps[d] = [flist[i][0] for i in picks]
    if with_timestamps:
        return frames, Ks, dists, size, stamps
    return frames, Ks, dists, size


def load_groundtruth(seq_root: str):
    """EuRoC ground truth -> (timestamps_ns (N,), positions (N, 3)) or None.

    Reads `mav0/state_groundtruth_estimate0/data.csv` (columns: timestamp,
    p_RS_R_{x,y,z}, q_RS_{w,x,y,z}, ...). Returns None when the sequence has
    no ground-truth folder (e.g. the mock fixtures) so callers can gate the
    accuracy report on availability.
    """
    for cand in (
        os.path.join(seq_root, "mav0", "state_groundtruth_estimate0",
                     "data.csv"),
        os.path.join(seq_root, "state_groundtruth_estimate0", "data.csv"),
    ):
        if os.path.isfile(cand):
            rows = []
            with open(cand) as fh:
                for line in fh:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split(",")
                    if len(parts) < 4:
                        continue
                    rows.append((int(parts[0]), float(parts[1]),
                                 float(parts[2]), float(parts[3])))
            if not rows:
                return None
            ts = np.asarray([r[0] for r in rows], np.int64)
            pos = np.asarray([r[1:] for r in rows], np.float64)
            return ts, pos
    return None


def groundtruth_at(ts_gt: np.ndarray, pos_gt: np.ndarray,
                   stamps: Sequence[int]) -> np.ndarray:
    """Nearest-timestamp ground-truth positions for a list of frame
    timestamps -> (len(stamps), 3)."""
    out = []
    for t in stamps:
        out.append(pos_gt[int(np.argmin(np.abs(ts_gt - t)))])
    return np.asarray(out)
