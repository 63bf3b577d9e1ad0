"""kernels_roofline.infer (%): the least time the chip could take for the
graph's layer passes of the batches done in the traced window (per pass
the larger of its operations at the peak and its bytes, each tensor
once, at 3.35 TB/s), over the device's busy time in the window, every
kernel whatever its name."""

from bench_dcnn import readers


def read(ctx):
    return readers.kernels_roofline(ctx, "infer")
