"""The port's hand-written Hopper kernels and what surrounds them:

  deconv/ — the IOM transposed convolution (replaces ``deconv_pallas_3d``),
            the weight gradient of both ops (replaces
            ``deconv_dw_pallas_3d``) and the deconv's dx as the conv kernel
            with the channel roles swapped (``deconv_dx_pallas_3d``)
  conv/   — the forward strided convolution (replaces ``conv_pallas_3d``)
  common.py — the shared polyphase geometry, host-side lifting and what
              the two ops' backward passes share
  build.py — builds ``csrc/`` with nvcc and binds it with ctypes

Each kernel directory holds ``kernel.py`` (the wrappers, with their launch
counts), ``ref.py`` (the plain PyTorch versions) and ``ops.py`` (the op and
its autograd ``Function``).
"""
