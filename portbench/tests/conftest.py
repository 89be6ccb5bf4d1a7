"""Shared fixtures of the benchmark's tests: tiny configurations of the
cells that the program runs on the CPU in seconds, and the card for
the tests marked `cuda`, decided inside a fixture."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import common, run


def tiny(cell_name: str):
    """The cell's configuration and traffic mix cut to a CPU test's size
    (240x320 frames, 4 levels, few keypoints, frames, streams and chunks),
    everything else as committed."""
    _, entry, cfg, traffic = run.cell_files(cell_name)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["detector"].update(width=320, height=240, num_levels=4, max_keypoints=256)
    cfg["max_landmarks"] = 1024
    if traffic["driver"] == "session":
        traffic.update(frames_per_drone=4, chunk=2, traced_chunks=1)
    else:
        traffic.update(streams=4, frames_per_stream=2, uniform_sets=2, traced_requests=1,
                       split_requests=1)
    return entry, cfg, traffic


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    return common.load_json(common.REPO / "BENCHMARK.json")
