"""wgmma_launches_per_batch.infer (launches): launches a batch of kernel
1's TMA + wgmma route (``csrc/deconv_wgmma.cu``), the program's
``wgmma_launches_total`` counter.  Nothing where the program recorded no
such counter: a program without the route, or a traced window in which no
launch took it."""

from bench_dcnn import program_spans

COUNTER = "wgmma_launches_total"


def read(ctx):
    tel = (program_spans.recorder()
           if ctx.kind == "infer" and ctx.units else None)
    if tel is None or not any(i.name == COUNTER
                              for i in tel.registry.instruments()):
        return None
    return program_spans.count_per_unit(ctx, "infer", COUNTER)
