"""100 less the device's busy time (the union of its operations'
intervals) over the traced window, in %, with the profiler on."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 - 100.0 * tr.busy_s() / tr.window_s
