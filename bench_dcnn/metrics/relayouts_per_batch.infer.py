"""relayouts_per_batch.infer (relayouts): weight re-layouts a batch, the
program's ``weight_relayouts_total`` counter (``kernels/*/ops.py``: each
phase-major gather, K-major layout or dx regroup of a layer's weights)."""

from bench_dcnn import program_spans


def read(ctx):
    return program_spans.count_per_unit(ctx, "infer",
                                        "weight_relayouts_total")
