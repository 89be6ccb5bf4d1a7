"""The AKAZE deployment's cell, akaze-session-d2: its files found by name,
a run at a CPU test's size `correct`, each session fault and each
alteration of the program's AKAZE frontend (portbench/akaze_control.py)
`correct` false, and its three readers on made-up traces."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import akaze_control, common, faults, run, spans
from portbench.tests.conftest import tiny
from portbench.tests.test_portbench_drivers import FAULTS, KEYS, measure
from portbench.trace import Event, Trace

CELL = "akaze-session-d2"
READERS = ("frontend_device_ms_per_frame.session", "fed_octave_roofline_pct",
           "sample_raster_roofline_pct")


def test_cell_files_resolve(bench):
    _, entry, cfg, traffic = run.cell_files(CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "akaze-752x480", "session-d2-chunk16", 1)
    det = cfg["detector"]
    assert (det["backend"], det["width"], det["height"], det["max_keypoints"]) == (
        "akaze", 752, 480, 5000)
    assert common.akaze_params(det)[:2] == (4, 4)
    assert cfg["matcher"] == {"mode": "ratio", "dist_ratio": 0.8}
    assert cfg["max_landmarks"] == 8192 and cfg["reduced"] == []
    assert traffic["driver"] == "session"
    limits = common.load_json(common.ROOT / "limits" / f"{CELL}.json")
    assert set(limits) == set(common.load_json(common.ROOT / "limits" / "koral-session-d2.json"))
    names = {m["name"] for m in run.per_layer(bench, CELL)}
    assert set(READERS) <= names
    koral = {m["name"] for m in run.per_layer(bench, "koral-session-d2")}
    assert koral <= names and not set(READERS) & koral
    assert {m["name"] for m in run.end_to_end(bench, CELL)} == {
        "frames_per_s", "latency_ms_p95", "setup_s"}


def test_runs_and_is_correct(cpu_threads):
    _, cfg, _ = tiny(CELL)
    assert cfg["detector"]["backend"] == "akaze"
    res = measure(CELL)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "latency_ms_p95", "setup_s"}


SESSION_FAULTS = [f for c, f in FAULTS if c == "koral-session-d2"]


@pytest.mark.parametrize("fault", SESSION_FAULTS)
def test_fault_is_not_correct(cpu_threads, fault):
    with faults.planted(fault):
        res = measure(CELL)
    assert res["correct"] is False, res["checks"]


# The program altered in its AKAZE frontend (portbench/akaze_control.py),
# which neither the control nor the session faults of portbench/faults.py
# reach: the upper readings of keypoints_differ and matches_differ. At
# 1024 keypoints, where the top-k reaches responses between the threshold
# and its double (at 256 every kept response lies above both, and
# threshold_doubled changes nothing). The fifth, TF32, touches nothing of a
# CPU run.
@pytest.mark.parametrize("name", ["subpixel_dropped", "angle_turned", "threshold_doubled",
                                  "scale_space_bf16"])
def test_frontend_alteration_is_not_correct(cpu_threads, name):
    bench = common.load_json(common.REPO / "BENCHMARK.json")
    _, cfg, traffic = tiny(CELL)
    cfg["detector"]["max_keypoints"] = 1024
    t0 = time.perf_counter()
    with akaze_control.altered(name):
        cell = run.make_cell(cfg, traffic, 2 ** 31 + 5, torch.device("cpu"))
        res = run.measure(bench, CELL, cell, 0.2, False, t0)
    assert res["correct"] is False, res["checks"]


def test_tf32_alteration(monkeypatch):
    """TF32 on inside each intra_pose_chunk call (its capture included), and
    off again after it, as the program's import leaves it."""
    from coloc_tpu_torch import session
    seen = []
    monkeypatch.setattr(session.ColocSession, "intra_pose_chunk",
                        lambda self, frames: seen.append(
                            (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32,
                             torch.get_float32_matmul_precision())))
    with akaze_control.altered("tf32"):
        session.ColocSession.intra_pose_chunk(None, None)
    session.ColocSession.intra_pose_chunk(None, None)
    assert seen == [(True, True, "high"), (False, False, "highest")]


def test_alterations_restored():
    from coloc_tpu_torch import akaze
    from coloc_tpu_torch.ops import diffusion
    before = (akaze._RESPONSE_THRESHOLD, diffusion.build_scale_space_batch)
    with akaze_control.altered("threshold_doubled"), akaze_control.altered("scale_space_bf16"):
        assert akaze._RESPONSE_THRESHOLD == 2 * before[0]
        assert diffusion.build_scale_space_batch is not before[1]
    assert (akaze._RESPONSE_THRESHOLD, diffusion.build_scale_space_batch) == before


def ev(name: str, a_us: int, b_us: int) -> Event:
    return Event(name, a_us * 1000, b_us * 1000)


DTOD = "Memcpy DtoD (Device -> Device)"
B1 = "void k2nn_mma_kernel<8>(int const*)"
B10 = "void (anonymous namespace)::fed_octave_kernel<32, 64>(float const*)"
B11 = "void (anonymous namespace)::sample_raster_kernel<2>(bf16 const*)"


def session_trace() -> Trace:
    """Two frame steps. Step 1: a load copy, the image and draws copies
    (100-112 us), the frontend (B10 120-200, a memset, B11 210-250 beside
    an elementwise kernel to 300), B1 at 320; then the exit read, the
    tail and the outputs' clones. Step 2: image and draws copies at
    1000-1012, frontend 1020-1100 and 1150-1200, B1 at 1250. On the host,
    one `coloc.session.step` span a step."""
    dev = [ev(DTOD, 80, 90), ev(DTOD, 100, 110), ev(DTOD, 110, 112),
           ev(B10, 120, 200), ev("Memset (Unknown)", 200, 205), ev(B11, 210, 250),
           ev("elementwise_kernel", 240, 300), ev(B1, 320, 340), ev("p3p_kernel", 340, 360),
           ev("Memcpy DtoH (Device -> Pinned)", 400, 402), ev("gemm", 500, 600),
           ev(DTOD, 600, 601), ev(DTOD, 602, 603),
           ev(DTOD, 1000, 1010), ev(DTOD, 1010, 1012), ev(B10, 1020, 1100),
           ev(B11, 1150, 1200), ev(B1, 1250, 1260), ev("gemm", 1300, 1400)]
    host = [ev(spans.STEP, 95, 410), ev(spans.STEP, 990, 1410)]
    return Trace(dev, host, window_s=2e-3)


def ctx_of(tr, bounds=None):
    return {"trace": tr, "frames": 4, "counters": {}, "spans": {}, "bounds": bounds or {},
            "window_peak_bytes": 0, "latency_ms_p95": 1.0}


def test_frontend_device_ms():
    # step 1: [100, 112), [120, 205) and [210, 300) = 187 us; step 2:
    # [1000, 1012), [1020, 1100) and [1150, 1200) = 142 us; over 4 drone
    # frames
    read = run.reader("frontend_device_ms_per_frame.session")
    assert read(ctx_of(session_trace())) == pytest.approx((187 + 142) / 4 / 1e3)


def test_rooflines():
    ctx = ctx_of(session_trace(), {"fed_octave": 40e-6, "sample_raster": 9e-6, "k2nn": 1e-6})
    # B10 80 + 80 us, B11 40 + 50 us
    assert run.reader("fed_octave_roofline_pct")(ctx) == pytest.approx(100 * 40 / 160)
    assert run.reader("sample_raster_roofline_pct")(ctx) == pytest.approx(100 * 9 / 90)


def test_nothing_to_read():
    """No trace, no bounds, no B1, a step without its B1 or its copy-in,
    B1 launches and step spans that do not agree, no B10 or B11 launch (a
    TRIP cell's trace): nothing returned, never 0."""
    tr = session_trace()
    bounds = {"fed_octave": 40e-6, "sample_raster": 9e-6}
    for name in READERS:
        assert run.reader(name)(ctx_of(None, bounds)) is None
    assert run.reader("fed_octave_roofline_pct")(ctx_of(tr)) is None
    assert run.reader("sample_raster_roofline_pct")(ctx_of(tr)) is None
    front = run.reader("frontend_device_ms_per_frame.session")
    no_b1 = Trace([e for e in tr.device if e.name != B1], tr.host, tr.window_s)
    assert front(ctx_of(no_b1)) is None
    # step 2's B1 clipped out of the trace: one B1 for two steps
    one_b1 = Trace([e for e in tr.device if not (e.name == B1 and e.start_ns > 1e6)], tr.host,
                   tr.window_s)
    assert front(ctx_of(one_b1)) is None
    # no step spans (a program without them), or a third one
    assert front(ctx_of(tr._replace(host=[]))) is None
    assert front(ctx_of(tr._replace(host=tr.host + [ev(spans.STEP, 1500, 1600)]))) is None
    # two steps that do not divide the drone frames
    assert front({**ctx_of(tr), "frames": 3}) is None
    # no device-to-device copy between step 1's B1 and step 2's
    no_copy = Trace([e for e in tr.device if not (e.name == DTOD and e.start_ns >= 600_000)],
                    tr.host, tr.window_s)
    assert front(ctx_of(no_copy)) is None
    # step 2 with its draws copy alone, after a kernel: no image copy-in
    lone = Trace(sorted(no_copy.device + [ev(DTOD, 1010, 1012)], key=lambda e: e.start_ns),
                 tr.host, tr.window_s)
    assert front(ctx_of(lone)) is None
    trip = Trace([e for e in tr.device if e.name not in (B10, B11)], tr.host, tr.window_s)
    assert run.reader("fed_octave_roofline_pct")(ctx_of(trip, bounds)) is None
    assert run.reader("sample_raster_roofline_pct")(ctx_of(trip, bounds)) is None
