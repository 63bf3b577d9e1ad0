"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit).  A share is stated against these, with the card's
power limit beside it."""

FLOPS = {
    "bfloat16": 989e12,     # bf16 tensor cores
    # float32 work is stated against the TF32 tensor cores (3xTF32 reaches
    # float32 accuracy there), not the 67e12 of the CUDA cores, so no
    # kernel of either kind can read above 100 %
    "float32": 494.7e12,
}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}
