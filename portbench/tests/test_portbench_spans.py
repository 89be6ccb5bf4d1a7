"""The readers of the program's spans on made-up traces: a session's two
chunks and serving's two requests, each reader's exact value, and
nothing where the spans are absent."""

from __future__ import annotations

import pytest

from portbench import run
from portbench.trace import Event, Trace

SPAN_READERS = ("graph_launch_ms_per_step.session", "lm_exit_wait_ms_per_step.session",
                "chunk_host_ms.session", "frontend_span_ms.serve", "localize_span_ms.serve",
                "lm_exit_reads_per_request.serve", "device_idle_outside_program_pct")


def ev(name: str, a_us: int, b_us: int) -> Event:
    return Event(name, a_us * 1000, b_us * 1000)


def session_trace() -> Trace:
    """Chunk A (50-900 us): inputs, steps 1 and 2, outputs; chunk B
    (950-1400 us): inputs, step 3, outputs. Device idle gaps of 50, 300,
    300 and 400 us inside the chunks and one of 300 us after them."""
    host = [ev("coloc.session.chunk", 50, 900), ev("coloc.session.inputs", 50, 120),
            ev("coloc.session.step", 120, 400), ev("coloc.session.replay.head", 130, 160),
            ev("coloc.lm.exit_read", 170, 250), ev("coloc.session.replay.middle", 260, 280),
            ev("coloc.session.replay.tail", 300, 320),
            ev("coloc.session.step", 400, 800), ev("coloc.session.replay.head", 410, 430),
            ev("coloc.lm.exit_read", 440, 500), ev("coloc.session.replay.tail", 510, 530),
            ev("coloc.session.outputs", 800, 900),
            ev("coloc.session.chunk", 950, 1400), ev("coloc.session.inputs", 950, 960),
            ev("coloc.session.step", 960, 1300), ev("coloc.session.replay.head", 970, 990),
            ev("coloc.lm.exit_read", 1000, 1100), ev("coloc.session.replay.tail", 1110, 1150),
            ev("coloc.session.outputs", 1300, 1400), ev("cudaGraphLaunch", 131, 159)]
    dev = [ev("k", 0, 100), ev("k", 150, 300), ev("k", 600, 700), ev("k", 1000, 1100),
           ev("k", 1500, 1600), ev("k", 1900, 2000)]
    return Trace(dev, host, window_s=2e-3)


def serve_trace() -> Trace:
    """Two requests with frontend and localize spans, four exit reads;
    device idle gaps of 50 us inside request 1 and 10 us between the
    requests."""
    host = [ev("coloc.serve.request", 0, 500), ev("coloc.serve.frontend", 10, 200),
            ev("coloc.serve.localize", 200, 480), ev("coloc.lm.exit_read", 300, 310),
            ev("coloc.lm.exit_read", 320, 330), ev("coloc.lm.exit_read", 340, 350),
            ev("coloc.serve.request", 600, 1000), ev("coloc.serve.frontend", 610, 750),
            ev("coloc.serve.localize", 750, 990), ev("coloc.lm.exit_read", 800, 820)]
    dev = [ev("k", 0, 100), ev("k", 150, 550), ev("k", 540, 545), ev("k", 560, 1100)]
    return Trace(dev, host, window_s=1.1e-3)


def ctx_of(tr):
    return {"trace": tr, "frames": 6, "counters": {}, "spans": {}, "bounds": {},
            "window_peak_bytes": 0, "latency_ms_p95": 1.0}


def test_session_readers():
    ctx = ctx_of(session_trace())
    # launches 30 + 20 + 20, 20 + 20, 20 + 40 us over 3 steps
    assert run.reader("graph_launch_ms_per_step.session")(ctx) == pytest.approx(170e-3 / 3)
    # exit reads 80, 60, 100 us over 3 steps
    assert run.reader("lm_exit_wait_ms_per_step.session")(ctx) == pytest.approx(0.08)
    # chunk A 850 less steps 680, chunk B 450 less 340: mean 140 us
    assert run.reader("chunk_host_ms.session")(ctx) == pytest.approx(0.14)
    # gaps 50 + 300 + 300 + 400 + 300 us, the last outside both chunks
    assert run.reader("device_idle_outside_program_pct")(ctx) == pytest.approx(
        100 * 300 / 1350)
    for name in ("frontend_span_ms.serve", "localize_span_ms.serve",
                 "lm_exit_reads_per_request.serve"):
        assert run.reader(name)(ctx) is None


def test_serve_readers():
    ctx = ctx_of(serve_trace())
    assert run.reader("frontend_span_ms.serve")(ctx) == pytest.approx((0.19 + 0.14) / 2)
    assert run.reader("localize_span_ms.serve")(ctx) == pytest.approx((0.28 + 0.24) / 2)
    assert run.reader("lm_exit_reads_per_request.serve")(ctx) == 2.0
    # gaps 50 us (in request 1, midpoint 125) and 10 us (midpoint 555, outside)
    assert run.reader("device_idle_outside_program_pct")(ctx) == pytest.approx(100 * 10 / 60)
    for name in ("graph_launch_ms_per_step.session", "lm_exit_wait_ms_per_step.session",
                 "chunk_host_ms.session"):
        assert run.reader(name)(ctx) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_without_spans(name):
    """No trace, or a trace without the program's spans (an older
    commit's): nothing returned, never 0."""
    plain = Trace([ev("k", 0, 100), ev("k", 200, 300)],
                  [ev("cudaGraphLaunch", 100, 200), ev("aten::item", 110, 190)], 3e-4)
    assert run.reader(name)(ctx_of(None)) is None
    assert run.reader(name)(ctx_of(plain)) is None


def test_span_readers_listed(bench):
    """Each reader is a per-layer metric of the cells whose spans it reads."""
    by = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_READERS:
        assert by[name]["moves"] == "frames_per_s"
        cells = set(by[name]["workloads"])
        assert cells <= {"koral-session-d2", "koral-serve-b64"}
        assert (".session" in name) <= (cells == {"koral-session-d2"})
        assert (".serve" in name) <= (cells == {"koral-serve-b64"})
