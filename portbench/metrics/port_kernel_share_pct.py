"""The port's own kernels' device time over all the device's busy time in
the trace, in %: the most that a change to those kernels can save."""

from portbench import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.busy_s()
    port = sum((e.end_ns - e.start_ns) / 1e9 for e in tr.kernels()
               if roofline.kernel_of(e.name) is not None)
    return 100.0 * port / busy if busy > 0 and port > 0 else None
