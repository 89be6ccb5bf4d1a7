"""Host ms a frame step waits on the pose LM's exit: the summed
`coloc.lm.exit_read` spans (each a host read of whether a lane is still
active, so a wait for the device) over the number of `coloc.session.step`
spans in the traced chunks, profiler on."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    steps = spans.named(tr, spans.STEP)
    if not steps:
        return None
    return spans.total_ms(spans.named(tr, spans.EXIT_READ)) / len(steps)
