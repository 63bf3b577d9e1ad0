"""host_ms_per_batch.infer (ms): the host's time inside the benchmark's
"issue" span, around the forward call (which returns without waiting for
the device: the engine's walk, the wrappers' planning, re-layouts and
launches), per batch of the traced window."""


def read(ctx):
    if ctx.kind != "infer" or ctx.units == 0 or "issue" not in ctx.host_s:
        return None
    return 1e3 * ctx.host_s["issue"] / ctx.units
