"""backward_host_ms.train (ms): the host's time a step inside the program's
``backward`` span (``launch/steps.py``: autograd over the ops' backward,
each op's dx and dw launches issued from it)."""

from bench_dcnn import program_spans


def read(ctx):
    return program_spans.host_ms_per_unit(ctx, "train", "backward")
