"""Host reads of the pose LM's exit a frame step over the window, from the
session's step graphs' counter."""


def read(ctx):
    return ctx["counters"].get("host_reads_per_step")
