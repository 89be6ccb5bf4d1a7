"""Device kernels of every kind (copies and sets left out) in the profiler's
trace of the traced requests, per drone frame: the whole device's count,
the frontend's, the match and localize layers' and the filter's alike."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["frames"]:
        return None
    n = len(tr.kernels())
    return n / ctx["frames"] if n else None
