"""launches_per_step.train (launches): kernels the device ran in the
traced window per training step (exact, as for a batch)."""

from bench_dcnn import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "train")
