"""B10's (fed_octave_kernel, one launch an octave) share of its roofline
in the traced requests, in %: the least time of the scale spaces of
their frames (roofline.fed_octave, from the cell's shapes) over the
device time of the B10 launches in the trace."""

from portbench import kernel_share


def read(ctx):
    return kernel_share.roofline_pct(ctx, "fed_octave")
