"""kernels_roofline.train (%): the least time the chip could take for the
forward, dx and dw passes of the training steps done in the traced
window (per pass the larger of its operations at the peak and its
bytes, each tensor once, at 3.35 TB/s), over the device's busy time in
the window, every kernel whatever its name."""

from bench_dcnn import readers


def read(ctx):
    return readers.kernels_roofline(ctx, "train")
