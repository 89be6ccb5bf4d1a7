"""Mean host ms of the `coloc.serve.frontend` spans (the batched frontend
inside ServingEngine.localize_frames) over the traced requests, profiler
on: the time to launch the frontend's work, and any wait for it."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else spans.mean_ms(spans.named(tr, spans.FRONTEND))
