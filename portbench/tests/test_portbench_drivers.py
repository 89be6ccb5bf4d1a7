"""Each driver run to its end at a CPU test's size, called directly (not
through the card-only command): the result line's keys, `correct` on the
program as it is, and `correct` false with the timed path broken
underneath in each way a cell can be broken."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import common, faults, run
from portbench.tests.conftest import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def measure(cell_name: str, trace: bool = False):
    bench = common.load_json(common.REPO / "BENCHMARK.json")
    _, cfg, traffic = tiny(cell_name)
    t0 = time.perf_counter()
    cell = run.make_cell(cfg, traffic, 2 ** 31 + 5, torch.device("cpu"))
    return run.measure(bench, cell_name, cell, 0.2, trace, t0)


E2E = {"koral-session-d2": {"frames_per_s", "latency_ms_p95", "setup_s"},
       "koral-serve-b64": {"frames_per_s", "setup_s"}}


@pytest.mark.parametrize("cell", sorted(E2E))
def test_runs_and_is_correct(cpu_threads, cell):
    res = measure(cell)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and 0 <= res["failed"] <= res["attempted"]
    assert set(res["metrics"]) == E2E[cell]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["koral-session-d2", "koral-serve-b64"])
def test_traced_run(cpu_threads, cell):
    res = measure(cell, trace=True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # off the card the trace has no device events: nothing is read from it
    assert "peak_mem_gib" in res["metrics"] and "device_idle_pct" not in res["metrics"]


FAULTS = [("koral-session-d2", "state_unchanged"), ("koral-session-d2", "half_batch"),
          ("koral-session-d2", "altered"), ("koral-session-d2", "inliers_halved"),
          ("koral-serve-b64", "half_batch"), ("koral-serve-b64", "altered"),
          ("koral-serve-b64", "inliers_halved")]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_not_correct(cpu_threads, cell, fault):
    """The timed path broken underneath: `correct` reads false."""
    with faults.planted(fault):
        res = measure(cell)
    assert res["correct"] is False, res["checks"]
