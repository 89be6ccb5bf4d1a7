"""The port's kernels' share of their roofline in the traced requests, in
%: the least time of every port kernel's work in those requests
(roofline.py, from the cell's shapes) over the device time of all their
launches in the trace, over the kernels that both name."""

from portbench import roofline


def read(ctx):
    tr, bounds = ctx["trace"], ctx["bounds"]
    if tr is None or not bounds:
        return None
    dev = {}
    for e in tr.kernels():
        key = roofline.kernel_of(e.name)
        if key is not None and key in bounds:
            dev[key] = dev.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e9
    total = sum(dev.values())
    return 100.0 * sum(bounds[k] for k in dev) / total if total > 0 else None
