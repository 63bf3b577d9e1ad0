"""update_idle_share.train (%): the share of the traced window in which no
kernel ran, in gaps between kernels that began while the program's
``update`` span was open (``program_spans.idle_share_in``)."""

from bench_dcnn import program_spans


def read(ctx):
    return program_spans.idle_share_in(ctx, "train", "update")
