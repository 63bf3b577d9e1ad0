"""update_host_ms.train (ms): the host's time a step inside the program's
``update`` span (``launch/steps.py`` around ``optim/adamw.py``'s update)."""

from bench_dcnn import program_spans


def read(ctx):
    return program_spans.host_ms_per_unit(ctx, "train", "update")
