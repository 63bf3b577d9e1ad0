"""idle_share.infer (%): the share of the traced window in which the device
ran no kernel, copy or set (the profiler's trace)."""

from bench_dcnn import readers


def read(ctx):
    return readers.idle_share(ctx, "infer")
