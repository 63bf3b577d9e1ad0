"""Runnable examples of the port (the JAX package's ``examples/``):

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.train_dcgan --steps 200 --method pallas
    python -m repro_torch.examples.segment_vnet3d --steps 60 --method pallas
    python -m repro_torch.examples.serve_dcnn [--inject-faults]
    python -m repro_torch.examples.serve_lm [--arch llama3.2-1b]

Each runs on the CUDA device by default; ``--device cpu`` runs the
kernels' plain versions instead.  Every example reaches the port through
its public names (``repro_torch.core`` and the subpackages' own), and
``main(argv)`` runs it in-process.
"""
