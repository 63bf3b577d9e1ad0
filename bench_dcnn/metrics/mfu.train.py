"""mfu.train (%): the forward, dx and dw operations a training step needs
(``counts``) times the steps done in the traced window, over the window
times the data-sheet peak (float32 against the TF32 tensor cores)."""

from bench_dcnn import readers


def read(ctx):
    return readers.mfu(ctx, "train")
