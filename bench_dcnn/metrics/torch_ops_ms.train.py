"""torch_ops_ms.train (ms): device time per training step in kernels that
are not the port's own (the loss, the optimizer, concatenations, casts,
the dense layers and reductions: PyTorch's kernels), from the trace.  The
port's own kernels are those of ``src/repro_torch/csrc``, by name."""

PORT_KERNELS = ("igemm_kernel", "igemm_reduce", "igemm_tf32_kernel",
                "igemm_bf16_kernel", "igemm_bf16_halo_kernel",
                "igemm_s8_kernel", "dw_kernel", "dw_reduce")


def read(ctx):
    if ctx.kind != "train" or ctx.units == 0 or not ctx.kernels:
        return None
    other = sum(b - a for name, _, a, b in ctx.kernels
                if not any(k in name for k in PORT_KERNELS))
    return 1e-6 * other / ctx.units
