"""compile_host_ms.infer (ms): the host's time a batch inside the program's
``compile`` spans (``core/engine.py::compile_network``, which the model
forwards run on every call: the schedule and its plans looked up again)."""

from bench_dcnn import program_spans


def read(ctx):
    return program_spans.host_ms_per_unit(ctx, "infer", "compile")
