"""Declarative session configuration (copy of coloc_tpu.config).

A copy, not an import: `import coloc_tpu.config` runs coloc_tpu/__init__.py,
which imports jax, and the port runs where jax is absent. Field names and
defaults must stay equal to coloc_tpu.config's; tests/test_torch_port.py
pins that. See coloc_tpu/config.py for the reference citations of each knob.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DetectorOptions:
    """Feature frontend knobs (reference: colocData.hpp:29-36)."""

    width: int = 752
    height: int = 480
    max_keypoints: int = 1024
    scale_factor: float = 1.2
    num_levels: int = 8
    fast_threshold: int = 40
    descriptor_bits: int = 512
    smoothing_radius: int = 2
    border: int = 16
    backend: str = "trip"              # "trip" | "akaze"
    akaze_sublevels: int = 4
    akaze_cell_samples: int = 4
    akaze_fed_tau_max: float = 0.25


@dataclasses.dataclass(frozen=True)
class MatcherOptions:
    """Descriptor matching knobs (reference: colocData.hpp:38-42).

    `margin_threshold`: accept iff `second - best > threshold` (CUDAK2NN);
    `dist_ratio`: Lowe ratio of the CPU path."""

    margin_threshold: int = 60
    pair_margin_threshold: int = 40
    dist_ratio: float = 0.8
    mode: str = "margin"               # "margin" | "ratio"


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """Robust-estimation budgets (reference: RobustMatcher.hpp:34, Localizer.hpp:84)."""

    num_hypotheses: int = 256
    inlier_multiple: float = 2.5       # accept iff inliers >= 2.5 x minimal sample
    scoring: str = "nfa"               # "nfa" (AC-RANSAC) | "count" (fixed threshold)
    essential_threshold: float = 4.0
    p3p_threshold: float = 4.0         # px, reprojection
    homography_threshold: float = 4.0
    chirality_ratio: float = 0.7


@dataclasses.dataclass(frozen=True)
class RefinerOptions:
    """Bundle-adjustment budgets (reference: Refiner.hpp:34-44,158-169)."""

    max_iterations: int = 100
    tolerance: float = 1e-8
    huber_delta_sq: float = 16.0


@dataclasses.dataclass(frozen=True)
class FilterOptions:
    """Kalman filter bank knobs (reference: KalmanFilter.hpp:98-119)."""

    dt: float = 0.066
    process_noise: float = 1e-2
    measurement_noise: float = 1e-1
    initial_covariance: float = 1.0
    chi2_gate: float = 10.0
    gate_mode: str = "energy"          # "energy" | "mahalanobis"


@dataclasses.dataclass(frozen=True)
class ColocConfig:
    """Top-level session config (reference: colocParams.hpp + coloc_node.cpp main)."""

    num_drones: int = 2
    model: str = "E"
    image_folder: str = ""
    detector: DetectorOptions = dataclasses.field(default_factory=DetectorOptions)
    matcher: MatcherOptions = dataclasses.field(default_factory=MatcherOptions)
    ransac: RansacOptions = dataclasses.field(default_factory=RansacOptions)
    refiner: RefinerOptions = dataclasses.field(default_factory=RefinerOptions)
    filter: FilterOptions = dataclasses.field(default_factory=FilterOptions)
    max_landmarks: int = 4096
    max_tracks: int = 4096
    scale: float = 1.0

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.detector.height, self.detector.width)


def default_intrinsics(config: ColocConfig) -> np.ndarray:
    """Per-drone K matrices, (num_drones, 3, 3) float32. EuRoC-like defaults."""
    k = np.array([[458.654, 0.0, 367.215],
                  [0.0, 457.296, 248.375],
                  [0.0, 0.0, 1.0]], dtype=np.float32)
    return np.broadcast_to(k, (config.num_drones, 3, 3)).copy()


def default_distortion(config: ColocConfig) -> np.ndarray:
    """Per-drone radial distortion (k1, k2, k3), (num_drones, 3) float32."""
    return np.zeros((config.num_drones, 3), dtype=np.float32)
