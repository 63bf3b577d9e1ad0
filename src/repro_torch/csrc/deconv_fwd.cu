// Deconv (transposed convolution) forward for Hopper, sm_90a.
//
// Replaces the TPU kernel deconv_pallas_3d (src/repro/kernels/deconv/
// kernel.py, body _deconv_kernel_body).  That kernel scatters: per grid step
// it multiplies an input tile by every tap of a phase and overlap-adds the
// products into a VMEM accumulator, carrying a halo between sequential
// d-tiles.  CUDA blocks run concurrently with nothing carried between them,
// so this kernel gathers instead: a block owns one output phase p, a tile of
// 128 phase positions q and a block of output channels inside one group,
// and reads x[q - m] for every tap m of that phase (masked to the input).
// Each output element is summed entirely inside one thread, in f32
// registers; the (lo, hi) crop folds into the store mask, and empty
// (dilation-gap) phases still run the epilogue on a zero sum, as the TPU
// kernel's zero-initialised accumulator does.
//
// What bounds it on an H100: with IEEE f32 FMA on CUDA cores (67 TFLOP/s
// peak) and prod(K)/prod(S) x Cin MACs per output element on average
// (2.25 x Cin for DCGAN's 3x3 stride-2 layers, 3.4 x Cin for V-Net's
// 3x3x3 ones) against about Cin/prod(S) + Cout elements moved, the
// full-width DCGAN and V-Net layers are bound by operations, not bytes.  The design keeps every operand tile in
// shared memory and a 128 x BN accumulator tile in registers (8 x 2 or
// 8 x 4 sums per thread), so each staged element feeds BN or 128 FMAs.
// It does not yet pipeline the global loads (no cp.async/TMA) nor use the
// tensor cores for bf16: both are later work.
#include "igemm.cuh"

extern "C" int repro_deconv_fwd(const void* x, const void* w_taps,
                                const int* taps, const float* scale,
                                const float* bias, void* y, const int* geom,
                                int act, float alpha, int in_dtype,
                                int out_dtype, int block_co, void* stream) {
  return repro::launch<true>(x, w_taps, taps, scale, bias, y, geom, act, alpha,
                             in_dtype, out_dtype, block_co, stream);
}
