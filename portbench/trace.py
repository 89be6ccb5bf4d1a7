"""What a torch.profiler trace of a few requests says: the device's
events and their busy time (the union of their intervals), the host's
events, and the breakdown of the device's time and idle gaps.

The events are read from the profiler's raw kineto results (the device
events with their start and end), without the host-side event tree that
`prof.events()` builds first.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: List[Event]      # device operations (kernels, copies, sets)
    host: List[Event]        # host operations and runtime calls
    window_s: float          # the traced window, host clock

    def kernels(self) -> List[Event]:
        """The device's kernels: its operations less copies and sets."""
        return [e for e in self.device if not e.name.startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return sum(b - a for a, b in busy_intervals(self.device)) / 1e9


@contextlib.contextmanager
def traced(out: list, card: bool = True):
    """Profile the device (`card`) and the host inside the block; a Trace
    is appended to `out` when it ends (after a device synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out.append(read(prof, window_s))


def read(prof, window_s: float) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        ev = Event(e.name(), int(e.start_ns()), int(e.end_ns()))
        (dev if e.device_type() == cuda else host).append(ev)
    return Trace(sorted(dev, key=lambda e: e.start_ns), host, window_s)


def busy_intervals(events: List[Event]) -> List[Tuple[int, int]]:
    """The union of the events' [start, end) intervals, in order."""
    out: List[Tuple[int, int]] = []
    for e in sorted(events, key=lambda e: e.start_ns):
        if out and e.start_ns <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e.end_ns))
        else:
            out.append((e.start_ns, e.end_ns))
    return out


def top_device_ops(trace: Trace, n: int = 10) -> List[list]:
    """[[name, seconds]] of the n device operations that took most time
    in all, by name."""
    by: Dict[str, float] = {}
    for e in trace.device:
        by[e.name] = by.get(e.name, 0.0) + (e.end_ns - e.start_ns) / 1e9
    return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> List[list]:
    """[[what the host was doing, seconds]] of the n longest gaps between
    device work inside the traced span: the name of the shortest host
    event that covers the gap's middle ("host" where none does)."""
    busy = busy_intervals(trace.device)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:n]
    out = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        cover: Optional[Event] = None
        for e in trace.host:
            if e.start_ns <= mid < e.end_ns and (
                    cover is None or e.end_ns - e.start_ns < cover.end_ns - cover.start_ns):
                cover = e
        out.append([cover.name[:200] if cover else "host", length / 1e9])
    return out
