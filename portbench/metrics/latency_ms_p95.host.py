"""The 95th percentile of the window's request latencies (call to outputs
on the host, host clock), where the host paces the requests: the same
number as the end-to-end latency_ms_p95, read as a layer's metric in a
cell whose device is idle most of its window."""


def read(ctx):
    return ctx.get("latency_ms_p95")
