"""The AKAZE frontend's profiler spans (profiling.span) on the CPU: an
eager detect_and_describe_akaze_batch records coloc.akaze.scale_space,
.detect, .sample and .describe once each, one after another; inside
ServingEngine.localize_frames they lie inside coloc.serve.frontend; the
TRIP frontend records none of them.

numpy and the port only, at tests/plumbing_cases.py's 96x128 frame."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coloc_tpu_torch import akaze, convert, frontend, serving
from coloc_tpu_torch.geometry.camera import Camera

import plumbing_cases
from port_harness import one_torch_thread, time_limit  # noqa: F401

STAGES = ["coloc.akaze.scale_space", "coloc.akaze.detect", "coloc.akaze.sample",
          "coloc.akaze.describe"]


def akaze_config(D: int = 2):
    cfg = plumbing_cases.config(D)
    det = dataclasses.replace(cfg.detector, backend="akaze", num_levels=4)
    return dataclasses.replace(cfg, detector=det)


def spans(prof) -> list:
    """The profiler's `coloc.*` host ops: [(name, start_ns, end_ns)] in
    start order."""
    out = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name().startswith("coloc.")]
    return sorted(out, key=lambda s: s[1])


def images(B: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([plumbing_cases.frame()] * B))


def test_akaze_stage_spans_in_order():
    opts = akaze_config().detector
    marks = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feats = akaze.detect_and_describe_akaze_batch(images(2), opts, mark=marks.append)
    assert bool(feats.valid.any())
    evs = spans(prof)
    assert [s[0] for s in evs] == STAGES
    assert all(a[2] <= b[1] for a, b in zip(evs, evs[1:]))
    # the mark callback still sees every stage
    assert marks == ["scale_space", "detect", "topk", "sampling", "orientation", "descriptor"]


def test_akaze_spans_inside_serving_frontend():
    cfg = akaze_config()
    mapdb = convert.mapdb_from_numpy(plumbing_cases.map_arrays(), "cpu")
    cam = Camera(K=torch.from_numpy(plumbing_cases.K), dist=torch.zeros(3))
    engine = serving.ServingEngine(mapdb, cam, cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.localize_frames(images(2), generator=torch.Generator().manual_seed(0))
    evs = spans(prof)
    (front,) = [s for s in evs if s[0] == "coloc.serve.frontend"]
    stages = [s for s in evs if s[0].startswith("coloc.akaze.")]
    assert [s[0] for s in stages] == STAGES
    assert all(front[1] <= s[1] and s[2] <= front[2] for s in stages)


@pytest.mark.parametrize("batch", [1, 2])
def test_trip_records_no_akaze_span(batch):
    opts = plumbing_cases.config().detector
    assert opts.backend == "trip"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frontend.detect_and_describe_batch(images(batch), opts)
    assert not [s for s in spans(prof) if s[0].startswith("coloc.akaze.")]
