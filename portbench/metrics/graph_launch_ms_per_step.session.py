"""Host ms a frame step spends launching the captured step's graphs: the
summed `coloc.session.replay.*` spans (head, middle, tail) over the
number of `coloc.session.step` spans in the traced chunks, profiler on."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    steps, launches = spans.named(tr, spans.STEP), spans.prefixed(tr, spans.REPLAY)
    if not steps or not launches:
        return None
    return spans.total_ms(launches) / len(steps)
