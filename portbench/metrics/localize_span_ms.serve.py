"""Mean host ms of the `coloc.serve.localize` spans (2-NN, accept,
RANSAC, the pose LM and covariance inside ServingEngine.localize_frames)
over the traced requests, profiler on: launches and the LM's exit
reads."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else spans.mean_ms(spans.named(tr, spans.LOCALIZE))
