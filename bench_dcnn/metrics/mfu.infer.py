"""mfu.infer (%): the model's useful operations (``counts``: no padding,
crop or inserted zero) times the batches done in the traced window, over
the window times the bf16 (or the stated dtype's) data-sheet peak."""

from bench_dcnn import readers


def read(ctx):
    return readers.mfu(ctx, "infer")
