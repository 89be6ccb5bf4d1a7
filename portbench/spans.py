"""The program's own spans in a trace: the host events that
coloc_tpu_torch.profiling.span records under torch.profiler, named
`coloc.<layer>.<part>` at the session's and serving's layer boundaries,
on the same clock as the device's events. A program without them (an
older commit) leaves these lists empty, and the readers report nothing."""

from __future__ import annotations

from typing import List

from portbench.trace import Event, Trace, busy_intervals

CHUNK = "coloc.session.chunk"            # one session request
STEP = "coloc.session.step"              # one frame step
REPLAY = "coloc.session.replay."         # .head, .middle, .tail: a graph's launch
EXIT_READ = "coloc.lm.exit_read"         # one host read of the pose LM's exit
REQUEST = "coloc.serve.request"          # one serving dispatch
FRONTEND = "coloc.serve.frontend"
LOCALIZE = "coloc.serve.localize"


def named(trace: Trace, name: str) -> List[Event]:
    return [e for e in trace.host if e.name == name]


def prefixed(trace: Trace, prefix: str) -> List[Event]:
    return [e for e in trace.host if e.name.startswith(prefix)]


def total_ms(events: List[Event]) -> float:
    return sum(e.end_ns - e.start_ns for e in events) / 1e6


def mean_ms(events: List[Event]):
    return total_ms(events) / len(events) if events else None


def covered_ns(events: List[Event]) -> int:
    """The length of the union of the events' intervals."""
    return sum(b - a for a, b in busy_intervals(events))


def within(events: List[Event], outer: Event) -> List[Event]:
    return [e for e in events if outer.start_ns <= e.start_ns and e.end_ns <= outer.end_ns]
