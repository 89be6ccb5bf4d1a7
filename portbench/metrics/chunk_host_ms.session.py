"""Host ms of a session request outside its frame steps: each
`coloc.session.chunk` span less the union of the `coloc.session.step`
spans inside it (inputs, draws, state loads, stacking, clones, log
queueing), the mean over the traced chunks, profiler on."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    chunks, steps = spans.named(tr, spans.CHUNK), spans.named(tr, spans.STEP)
    if not chunks:
        return None
    rest = [c.end_ns - c.start_ns - spans.covered_ns(spans.within(steps, c)) for c in chunks]
    return sum(rest) / len(rest) / 1e6
