"""Disk ingest and calibration parsing (counterpart of coloc_tpu.io.disk).

Reference parity:
  InterfaceDisk.hpp — the file name `img__Quad{id}_{frame:04d}.png` from
    the folder and the frame counter (:13-14);
  coloc_node.cpp:5-51 readCalibData — calib.txt, comma-separated: line 1
    the image size `w,h`, then the 9 values of K (row-major) of each drone,
    then the 3 radial distortion values of each drone.

Host numpy on purpose: decoding and file names stay off the card; a frame
goes to the device once, as the session's input. PNG / JPEG decoding
needs PIL (optional); `.npy` frames need only numpy.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_EXTS = ("png", "pgm", "npy", "jpg")


def frame_path(folder: str, drone: int, frame: int, ext: str = "png") -> str:
    return os.path.join(folder, f"img__Quad{drone}_{frame:04d}.{ext}")


def load_image(path: str) -> np.ndarray:
    """Grayscale float32 (H, W) in [0, 255]."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"))
    return img.astype(np.float32)


def load_frame(folder: str, drone: int, frame: int) -> np.ndarray:
    for ext in _EXTS:
        p = frame_path(folder, drone, frame, ext)
        if os.path.exists(p):
            return load_image(p)
    raise FileNotFoundError(frame_path(folder, drone, frame))


def num_frames(folder: str, drone: int = 0) -> int:
    """Frames 0, 1, ... of `drone` on disk, up to the first one missing."""
    f = 0
    while any(os.path.exists(frame_path(folder, drone, f, ext)) for ext in _EXTS):
        f += 1
    return f


def read_calib(path: str, num_drones: int) -> Tuple[Tuple[int, int], np.ndarray, np.ndarray]:
    """calib.txt -> ((width, height), Ks (D, 3, 3), dists (D, 3)), float32."""
    with open(path) as fh:
        rows = [[float(x) for x in line.replace(",", " ").split()]
                for line in fh if line.strip()]
    size = (int(rows[0][0]), int(rows[0][1]))
    Ks = np.stack([np.asarray(rows[1 + d], np.float32).reshape(3, 3)
                   for d in range(num_drones)])
    dists = np.stack([np.asarray(rows[1 + num_drones + d], np.float32)
                      for d in range(num_drones)])
    return size, Ks, dists


def write_calib(path: str, size: Tuple[int, int], Ks: np.ndarray, dists: np.ndarray):
    with open(path, "w") as fh:
        fh.write(f"{size[0]},{size[1]}\n")
        for K in Ks:
            fh.write(",".join(str(float(v)) for v in np.asarray(K).reshape(-1)) + "\n")
        for d in dists:
            fh.write(",".join(str(float(v)) for v in np.asarray(d)) + "\n")
