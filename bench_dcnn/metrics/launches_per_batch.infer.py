"""launches_per_batch.infer (launches): kernels the device ran in the
traced window per batch (every batch issued there is done there, and
nothing else runs, so the count is exact)."""

from bench_dcnn import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "infer")
