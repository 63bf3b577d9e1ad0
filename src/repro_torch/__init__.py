"""repro_torch — the PyTorch/CUDA port of the uniform conv/deconv engine.

It stands beside the JAX package ``repro``, which stays the reference: the
layouts are the same (activations ``[N, *spatial, C]``, weights
``[*K, Cin/G, Cout]``), so weight trees cross between the packages
unchanged (``repro_torch.convert``).  Entry points run on the CUDA device
unless the caller asks for the CPU, where the kernels' plain versions run.
"""
