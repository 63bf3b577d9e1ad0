"""The port's two hand-written Hopper kernels and what surrounds them:

  deconv/ — the IOM transposed convolution (replaces ``deconv_pallas_3d``)
  conv/   — the forward strided convolution (replaces ``conv_pallas_3d``)
  common.py — the shared polyphase geometry and host-side lifting
  build.py — builds ``csrc/`` with nvcc and binds it with ctypes

Each kernel directory holds ``kernel.py`` (the wrapper, with its launch
count), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the op).
"""
