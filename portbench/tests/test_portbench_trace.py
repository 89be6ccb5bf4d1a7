"""The trace's arithmetic and the per-layer readers on a made-up trace."""

from __future__ import annotations

import pytest

from portbench import run, trace
from portbench.trace import Event, Trace


def made_up():
    dev = [Event("void k2nn_mma_kernel<4>()", 0, 100), Event("elementwise_kernel", 50, 150),
           Event("Memcpy DtoH (Device -> Pinned)", 400, 500),
           Event("(anonymous namespace)::extract_kernel()", 700, 1000)]
    host = [Event("cudaStreamSynchronize", 120, 420), Event("aten::item", 100, 430),
            Event("cudaGraphLaunch", 550, 690)]
    return Trace(dev, host, window_s=1e-6)


def test_busy_union_and_gaps():
    tr = made_up()
    assert trace.busy_intervals(tr.device) == [(0, 150), (400, 500), (700, 1000)]
    assert tr.busy_s() == pytest.approx(550e-9)
    assert [g[0] for g in trace.idle_gaps(tr)] == ["cudaStreamSynchronize", "cudaGraphLaunch"]
    assert trace.idle_gaps(tr)[0][1] == pytest.approx(250e-9)
    assert trace.top_device_ops(tr, 1)[0][0] == "(anonymous namespace)::extract_kernel()"


def test_readers():
    tr = made_up()
    ctx = {"trace": tr, "frames": 2, "counters": {}, "spans": {},
           "bounds": {"k2nn": 50e-9, "extract": 150e-9}, "window_peak_bytes": 2 ** 30,
           "latency_ms_p95": 12.5}
    assert run.reader("device_idle_pct")(ctx) == pytest.approx(45.0)
    assert run.reader("device_kernels_per_frame")(ctx) == pytest.approx(1.5)
    assert run.reader("kernel_roofline_pct")(ctx) == pytest.approx(50.0)
    assert run.reader("port_kernel_share_pct")(ctx) == pytest.approx(400 / 550 * 100)
    assert run.reader("peak_mem_gib")(ctx) == pytest.approx(1.0)
    assert run.reader("latency_ms_p95.host")(ctx) == 12.5
    # nothing to read: nothing returned, never 0
    empty = dict(ctx, trace=None, bounds={})
    for name in ("device_idle_pct", "device_kernels_per_frame", "kernel_roofline_pct",
                 "port_kernel_share_pct", "graph_nodes_per_frame.session",
                 "host_reads_per_frame.session", "frontend_ms.serve", "localize_ms.serve"):
        assert run.reader(name)(empty) is None
