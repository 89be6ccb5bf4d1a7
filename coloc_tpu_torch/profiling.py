"""Per-stage tracing and profiling (counterpart of coloc_tpu.profiling).

Reference parity: the reference wraps every stage in std::chrono spans and
prints them (coloc.hpp:113-144, GPUDetector.hpp:162-165,
GPUMatcher.hpp:204-223). StageProfiler gives the same per-stage wall-time
lines and keeps them for a summary; each stage is also a
torch.profiler.record_function, so it shows as a span in a trace.

    prof = StageProfiler(enabled=True, device=torch.device("cuda", 0))
    with prof.stage("detect"):
        feats = detect_and_describe(img, opts)   # synchronised on exit
    prof.report()

    with trace_to("traces"):                     # a Chrome trace in traces/
        session.run(frames)

A stage that wraps a CUDA graph's replay times the replay; a stage never
sits inside a capture (synchronising there would break it).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch


def _synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work queued on `device`: torch.cuda.synchronize on a
    CUDA device, nothing on the CPU (its ops have finished on return)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class StageProfiler:
    """Wall-clock spans per named stage, synchronised with `device` on exit
    when `sync` (device None: cuda:0 if there is a card, else the CPU)."""

    def __init__(self, enabled: bool = True, sync: bool = True, printer=None,
                 device=None):
        self.enabled = enabled
        self.sync = sync
        self.printer = printer
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", 0)
        self.device = None if device is None else torch.device(device)
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result=None) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if self.sync:
                _synchronize(self.device)
        dt = time.perf_counter() - t0
        self.times[name].append(dt)
        if self.printer:
            self.printer(f"[{name}] {dt * 1e3:.2f} ms")

    def block_on(self, value):
        """Synchronise with the device of `value` (a tensor) inside a stage."""
        if isinstance(value, torch.Tensor):
            _synchronize(value.device)
        return value

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            arr = sorted(ts)
            n = len(arr)
            out[name] = {
                "count": n,
                "total_ms": sum(arr) * 1e3,
                "mean_ms": sum(arr) / n * 1e3,
                "p50_ms": arr[n // 2] * 1e3,
                "max_ms": arr[-1] * 1e3,
            }
        return out

    def report(self, printer=print):
        for name, s in sorted(self.summary().items()):
            printer(
                f"{name:>24}: n={s['count']:4d} mean={s['mean_ms']:8.2f}ms "
                f"p50={s['p50_ms']:8.2f}ms max={s['max_ms']:8.2f}ms"
            )


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block, CPU and (with a card) CUDA activity,
    written as a Chrome trace `trace_<pid>_<ns>.json` into `log_dir`
    (chrome://tracing, Perfetto). No-op when log_dir is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
