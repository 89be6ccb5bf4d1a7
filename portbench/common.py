"""What the traffic drivers share: the files of a cell, the configuration
built for the program, an AKAZE detector group's parameters, seeds derived
from the run's seed, and the largest of several readings of a number."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent          # portbench/
REPO = ROOT.parent                               # the checkout's root


def load_json(path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed: the same (seed, tags)
    give the same number, different tags independent ones."""
    words = [int(seed) % (1 << 64)]
    words = [words[0] & 0xFFFFFFFF, words[0] >> 32]
    for t in tags:
        words += [ord(c) for c in t] if isinstance(t, str) else [int(t)]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def coloc_config(config_mod, cfg: Dict[str, Any], drones: int):
    """The configuration file as the program's `config_mod.ColocConfig`: its
    groups over the defaults (keys the program does not take left out)."""
    groups = {}
    for name in ("detector", "matcher", "ransac", "refiner", "filter"):
        field = {f.name: f for f in dataclasses.fields(config_mod.ColocConfig)}[name]
        known = {f.name for f in dataclasses.fields(field.default_factory())}
        groups[name] = field.default_factory(**{k: v for k, v in cfg.get(name, {}).items()
                                                if k in known})
    return config_mod.ColocConfig(num_drones=drones, model=cfg["model"],
                                  max_landmarks=cfg["max_landmarks"], scale=cfg["scale"],
                                  **groups)


class AkazeParams(NamedTuple):
    octaves: int
    sublevels: int
    tau_max: float
    cell_samples: int


def akaze_params(det: Dict[str, Any]) -> AkazeParams:
    """An `akaze` detector group as the program reads it: `num_levels` as
    octaves (half of it, 2 to 4), `akaze_sublevels`, `akaze_fed_tau_max`
    and `akaze_cell_samples` over the program's defaults."""
    n = det["num_levels"]
    return AkazeParams(min(n // 2, 4) if n >= 4 else 2, det.get("akaze_sublevels", 4),
                       det.get("akaze_fed_tau_max", 0.25), det.get("akaze_cell_samples", 4))


def intrinsics(cfg: Dict[str, Any]):
    """(K (3, 3), dist (3,)) float32 of the configuration's camera."""
    H, W = cfg["detector"]["height"], cfg["detector"]["width"]
    f = cfg["camera"]["focal_over_width"] * W
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]], np.float32)
    return K, np.asarray(cfg["camera"]["distortion"], np.float32)


def merge_max(into: Dict[str, float], more: Dict[str, float]) -> None:
    """Keep the larger reading of each number."""
    for k, v in more.items():
        into[k] = max(into.get(k, v), v)


class Laps:
    """Seconds of each named stage of a set-up, host clock (the device
    synchronised at each lap where `sync` is given)."""

    def __init__(self, sync=None):
        self.sync = sync
        self.t = time.perf_counter()
        self.laps: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        if self.sync is not None:
            self.sync()
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now

    def __str__(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.laps.items())
