"""B11's (sample_raster_kernel: the orientation's and the descriptor's
samples, two launches a frame step) share of its roofline in the traced
requests, in %: their least time (roofline.sample_raster, from the cell's
shapes) over the device time of the B11 launches in the trace. The bound
leaves out the bf16 source elements that the samples read (they depend
on the frame), so this share reads low by up to their bytes."""

from portbench import kernel_share


def read(ctx):
    return kernel_share.roofline_pct(ctx, "sample_raster")
