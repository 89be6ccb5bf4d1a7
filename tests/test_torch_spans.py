"""The port's profiler spans (profiling.span) on the CPU: what the serving
and session paths record under torch.profiler, how each span nests, that
they are host ops (never user annotations, which kineto mirrors onto the
device's timeline) and that no record_function is opened on those paths.

numpy and the port only, at tests/plumbing_cases.py's 96x128 frame.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coloc_tpu_torch import convert, profiling, serving
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.sfm import ba

import plumbing_cases


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_record_function(monkeypatch):
    """record_function raises: the paths under test must not open one."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def spans(prof) -> list:
    """The profiler's `coloc.*` events: [(name, start_ns, end_ns, kineto
    event)] in start order."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e) for e in prof.profiler.kineto_results.events()
           if e.name().startswith("coloc.")]
    return sorted(out, key=lambda s: s[1])


def named(evs, name) -> list:
    return [s for s in evs if s[0] == name]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def assert_host_ops(evs):
    for name, _, _, e in evs:
        assert e.activity_type() == "cpu_op" and not e.is_user_annotation(), name
        assert e.device_type() == torch.autograd.DeviceType.CPU, name


@pytest.fixture(scope="module")
def engine():
    mapdb = convert.mapdb_from_numpy(plumbing_cases.map_arrays(), "cpu")
    cam = Camera(K=torch.from_numpy(plumbing_cases.K), dist=torch.zeros(3))
    return serving.ServingEngine(mapdb, cam, plumbing_cases.config(2), device="cpu")


def test_serving_spans(engine, no_record_function, monkeypatch):
    """localize_frames: request holds frontend then localize, and localize
    holds one exit read a check that pose_lm_run makes (after each call of
    pose_lm_steps that leaves iterations to run)."""
    calls = []
    steps = ba.pose_lm_steps

    def counted(*args):
        calls.append(args[-1])
        return steps(*args)

    monkeypatch.setattr(ba, "pose_lm_steps", counted)
    images = torch.from_numpy(np.stack([plumbing_cases.frame()] * 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pwc, _, _ = engine.localize_frames(images, generator=torch.Generator().manual_seed(0))
    assert bool(pwc.success.all())
    evs = spans(prof)
    assert_host_ops(evs)
    (req,), (front,), (loc,) = (named(evs, n) for n in (
        "coloc.serve.request", "coloc.serve.frontend", "coloc.serve.localize"))
    assert inside(front, req) and inside(loc, req) and front[2] <= loc[1]
    max_its = engine.config.refiner.max_iterations
    checks = sum(1 for done in np.cumsum(calls) if done < max_its)
    reads = named(evs, "coloc.lm.exit_read")
    assert checks >= 1 and len(reads) == checks
    assert all(inside(r, loc) for r in reads)
    assert {s[0] for s in evs} == {"coloc.serve.request", "coloc.serve.frontend",
                                   "coloc.serve.localize", "coloc.lm.exit_read"}


def test_serving_features_spans(engine, no_record_function):
    """localize_features: request holds localize, and no frontend."""
    feats = serving.detect_and_describe_batch(
        torch.from_numpy(plumbing_cases.frame())[None], engine.config.detector)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.localize_features(feats, generator=torch.Generator().manual_seed(0))
    evs = spans(prof)
    assert_host_ops(evs)
    (req,), (loc,) = named(evs, "coloc.serve.request"), named(evs, "coloc.serve.localize")
    assert inside(loc, req) and not named(evs, "coloc.serve.frontend")
    assert named(evs, "coloc.lm.exit_read")


def test_session_chunk_spans(no_record_function):
    """An eager intra_pose_chunk of F frames: one chunk holding inputs, F
    steps and outputs, in that order; each step holds its LM's exit
    reads; nothing is replayed."""
    F = 2
    sess = plumbing_cases.session(2)
    frame = plumbing_cases.frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.intra_pose_chunk(np.stack([np.stack([frame, frame])] * F))
    assert sess.frame == F
    evs = spans(prof)
    assert_host_ops(evs)
    (chunk,), (inputs,), (outputs,) = (named(evs, n) for n in (
        "coloc.session.chunk", "coloc.session.inputs", "coloc.session.outputs"))
    steps = named(evs, "coloc.session.step")
    assert len(steps) == F
    parts = [inputs] + steps + [outputs]
    assert all(inside(p, chunk) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))
    reads = named(evs, "coloc.lm.exit_read")
    assert all(any(inside(r, s) for s in steps) for r in reads)
    assert all(any(inside(r, s) for r in reads) for s in steps)
    assert not [s for s in evs if s[0].startswith("coloc.session.replay.")]


def test_stage_profiler_stage_is_a_span(no_record_function):
    prof = profiling.StageProfiler(enabled=True, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.stage("coloc.test.stage"):
            torch.ones(4).sum()
    evs = spans(p)
    assert [s[0] for s in evs] == ["coloc.test.stage"]
    assert_host_ops(evs)
    assert prof.summary()["coloc.test.stage"]["count"] == 1


def test_span_off_records_nothing():
    """Spans opened and closed with no profiler running leave nothing for
    a profiler started after them; one opened under it is recorded even
    when it closes after the profiler stops."""
    with profiling.span("coloc.test.off"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        late = profiling.span("coloc.test.on")
        late.__enter__()
        torch.ones(4).sum()
    late.__exit__(None, None, None)
    assert [s[0] for s in spans(prof)] == ["coloc.test.on"]
