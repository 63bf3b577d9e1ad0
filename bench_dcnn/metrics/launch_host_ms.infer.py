"""launch_host_ms.infer (ms): the host's time a batch inside the program's
``launch`` spans, around each kernel wrapper's call of its C entry
(``kernels/*/kernel.py``: the ctypes call and its launch bookkeeping)."""

from bench_dcnn import program_spans


def read(ctx):
    return program_spans.host_ms_per_unit(ctx, "infer", "launch")
