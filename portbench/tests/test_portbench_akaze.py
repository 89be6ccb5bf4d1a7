"""The AKAZE-MLDB reference against the program's AKAZE frontend on its
plain CPU path, and faults planted in a copy of the reference, each of
which the comparison has to catch. Two frames of the benchmark's scene at
240x376, num_levels 8 (4 octaves of 4 sublevels), 512 keypoints."""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest
import torch

from portbench import common
from portbench.inputs import scene as scene_mod
from portbench.reference import akaze, judge, pipeline, trip

H, W, KP = 240, 376, 512
DET = {"width": W, "height": H, "max_keypoints": KP, "num_levels": 8, "backend": "akaze"}
# Rounding alone separates the two sides (the Scharr stencils as
# convolutions, other sums in other orders): a keypoint differs only where
# two responses tie to rounding at a suppression or at the k-th place (0
# on 8 seeds), a bit where two cell means do (at most 4 a frame on 8
# seeds). An orientation that ties flips about half of one keypoint's 486
# bits, so the limit holds one such. The faults below read 800 keypoints
# or 1700 bits and more.
KEYPOINTS_LIMIT = 4
BITS_LIMIT = 300


@pytest.fixture(scope="module")
def frames_and_program():
    from coloc_tpu_torch import config, frontend

    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    scene = scene_mod.make_scene(H, W, K, common.derive(7, "scene"), (6.0, 12.0), 0.45)
    paths = [scene_mod.trajectory(8, d) for d in range(2)]
    frames = scene_mod.render(scene, np.stack([p[0][5] for p in paths]),
                              np.stack([p[1][5] for p in paths]), torch.device("cpu"))
    opts = config.DetectorOptions(width=W, height=H, max_keypoints=KP, num_levels=8,
                                  backend="akaze")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        feats = frontend.detect_and_describe_batch(frames, opts)
    finally:
        torch.set_num_threads(n)
    return frames, feats


def judged(module, frames, feats):
    with pipeline.precision(False):
        ref = module.frontend(frames, DET, KP)
    return judge.features(feats.xy, feats.valid, ref, trip.words_to_bits(feats.desc))


def passes(numbers):
    return (numbers["keypoints_differ"] <= KEYPOINTS_LIMIT
            and numbers["desc_bits_differ"] <= BITS_LIMIT)


def test_reference_agrees_with_the_program(cpu_threads, frames_and_program):
    frames, feats = frames_and_program
    assert bool(feats.valid.all())
    numbers = judged(judge.FRONTENDS["akaze"], frames, feats)
    assert passes(numbers), numbers


def copy_of_reference():
    spec = importlib.util.spec_from_file_location("portbench_akaze_copy", akaze.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fed_step_dropped(mod):
    """The first FED cycle one step short."""
    cycle, calls = mod.fed_cycle, []

    def short(T, tau_max):
        calls.append(T)
        taus = cycle(T, tau_max)
        return taus[:-1] if len(calls) == 1 else taus
    mod.fed_cycle = short


def contrast_at_50(mod):
    mod.PERCENTILE = 50.0


def grid3_reversed(mod):
    pairs = mod.cell_pairs
    mod.cell_pairs = lambda g: [(b, a) for a, b in pairs(g)] if g == 3 else pairs(g)


@pytest.mark.parametrize("fault", [fed_step_dropped, contrast_at_50, grid3_reversed],
                         ids=lambda f: f.__name__)
def test_planted_fault_fails(cpu_threads, frames_and_program, fault):
    frames, feats = frames_and_program
    mod = copy_of_reference()
    fault(mod)
    numbers = judged(mod, frames, feats)
    assert not passes(numbers), numbers


def test_frontend_gap_readings(cpu_threads):
    """The readings that an AKAZE cell's limits are set from, at a test's
    size on the CPU: the koral file with an AKAZE detector group, a ratio
    matcher and a 512-slot map."""
    from portbench import frontend_gap

    cfg = common.load_json(common.ROOT / "configs" / "koral-752x480.json")
    cfg["detector"].update(backend="akaze", max_keypoints=256, width=320, height=240)
    cfg["matcher"] = {"mode": "ratio", "dist_ratio": 0.8}
    cfg["max_landmarks"] = 512
    r = frontend_gap.readings(cfg, 1, torch.device("cpu"))
    json.dumps(r)
    assert r["device"] == "cpu" and r["map_valid"] == 512 and r["keypoints"] == [256, 256]
    assert r["matches_differ"] == 0
    assert passes(r)


def test_frontend_gap_needs_a_card(monkeypatch, capsys):
    """Its readings differ by device, so with no CUDA device it reads none."""
    from portbench import frontend_gap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert frontend_gap.main(["--config", str(common.ROOT / "configs" / "koral-752x480.json"),
                              "--seeds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
