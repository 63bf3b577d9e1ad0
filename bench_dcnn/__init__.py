"""Benchmark of the PyTorch and CUDA port (``repro_torch``): one cell per
run, driven by ``BENCHMARK.json`` and the data files beside this one."""
