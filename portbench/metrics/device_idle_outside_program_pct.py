"""The share of the device's idle time that falls outside the program's
requests, in %: of the gaps between the device's busy intervals in the
traced run, the gap time whose midpoint lies in no `coloc.session.chunk`
or `coloc.serve.request` span. That idle is the benchmark's driver's,
the collector's or the profiler's, not the program's."""

from portbench import spans, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    program = spans.named(tr, spans.CHUNK) + spans.named(tr, spans.REQUEST)
    busy = trace.busy_intervals(tr.device)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    total = sum(b - a for a, b in gaps)
    if not program or total <= 0:
        return None
    outside = sum(b - a for a, b in gaps
                  if not any(p.start_ns <= (a + b) // 2 < p.end_ns for p in program))
    return 100.0 * outside / total
