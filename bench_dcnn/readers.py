"""The arithmetic that per-layer metrics of one quantity share across
kinds of cell (``infer``, ``train``): each takes the traced window's
``harness.Context`` and the kind its metric reads, and returns None
where the cell is of another kind or gives it nothing to read."""

from __future__ import annotations

from bench_dcnn import counts, peaks


def idle_share(ctx, kind: str):
    """% of the traced window in which the device ran no kernel, copy or
    set."""
    if ctx.kind != kind or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu(ctx, kind: str):
    """% of the data-sheet peak of the cell's dtype that the counted
    useful operations of the units done in the window make."""
    if ctx.kind != kind or ctx.units == 0:
        return None
    done = counts.flops(ctx.work, ctx.batch) * ctx.units
    return 100.0 * done / (ctx.window_s * peaks.FLOPS[ctx.dtype])


def kernels_roofline(ctx, kind: str):
    """% of the device's busy time that the least time of the units' layer
    passes (each the larger of its operations at the peak and its bytes
    at the HBM's rate) takes."""
    if ctx.kind != kind or ctx.units == 0 or ctx.busy_s <= 0:
        return None
    least = ctx.units * counts.roofline_seconds(
        ctx.work, ctx.batch, peaks.ELEM_BYTES[ctx.dtype],
        peaks.FLOPS[ctx.dtype], peaks.HBM_BYTES_PER_S)
    return 100.0 * least / ctx.busy_s


def launches_per_unit(ctx, kind: str):
    """Kernels the device ran in the traced window per batch or step."""
    if ctx.kind != kind or ctx.units == 0 or not ctx.kernels:
        return None
    return len(ctx.kernels) / ctx.units
