"""CSV / PLY / gate-distance logs (counterpart of coloc_tpu.io.loggers).

Reference parity: logUtils.hpp —
  - the pose CSV (:69-100): idx,dest,src,x,y,z, the 3x3 position block of
    the covariance, roll,pitch,yaw,rmse,ntracks, with the Euler angles
    unwrapped (:34-67) so that a logged angle stays continuous across +-pi;
  - the PLY export (:102-168): landmarks white, camera centres green;
plus KalmanFilter.hpp:148-153's mahalanobis.txt (drone,distance a frame).

Host-side: the loggers take numpy arrays (or anything np.asarray reads, a
CPU tensor included) and write each value as str(float), as coloc_tpu's
do, so the same values give the same text.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _unwrap(prev: Optional[float], value: float) -> float:
    """Angle unwrapping (logUtils.hpp:34-67): keep logged angles continuous."""
    if prev is None:
        return value
    while value - prev > np.pi:
        value -= 2 * np.pi
    while value - prev < -np.pi:
        value += 2 * np.pi
    return value


class PoseLogger:
    """CSV pose + covariance log (Logger::logPoseCovtoFile parity)."""

    def __init__(self, path: str):
        self.path = path
        self._prev_euler = {}
        with open(self.path, "w") as fh:
            fh.write(
                "idx,dest,src,x,y,z,"
                "c00,c01,c02,c10,c11,c12,c20,c21,c22,"
                "roll,pitch,yaw,rmse,ntracks\n"
            )

    def log(self, idx, dest, src, pose_C, cov6, euler, rmse, ntracks):
        cov3 = np.asarray(cov6)[3:6, 3:6].reshape(-1)
        key = (dest, src)
        prev = self._prev_euler.get(key)
        e = [_unwrap(prev[i] if prev else None, float(euler[i])) for i in range(3)]
        self._prev_euler[key] = e
        row = ([idx, dest, src] + [float(v) for v in np.asarray(pose_C)]
               + [float(v) for v in cov3] + e + [float(rmse), int(ntracks)])
        with open(self.path, "a") as fh:
            fh.write(",".join(str(v) for v in row) + "\n")


class GateLogger:
    """mahalanobis.txt parity (KalmanFilter.hpp:148-153)."""

    def __init__(self, path: str):
        self.path = path
        open(self.path, "w").close()

    def log(self, drone: int, dist: float):
        with open(self.path, "a") as fh:
            fh.write(f"{drone},{float(dist)}\n")


def write_ply(path: str, landmarks, landmark_mask, camera_centers=None) -> None:
    """PLY export: landmarks white, camera centres green (logUtils:102-168)."""
    pts = np.asarray(landmarks)[np.asarray(landmark_mask)]
    cams = np.zeros((0, 3)) if camera_centers is None else np.asarray(camera_centers)
    n = len(pts) + len(cams)
    with open(path, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p in pts:
            fh.write(f"{p[0]} {p[1]} {p[2]} 255 255 255\n")
        for c in cams:
            fh.write(f"{c[0]} {c[1]} {c[2]} 0 255 0\n")
