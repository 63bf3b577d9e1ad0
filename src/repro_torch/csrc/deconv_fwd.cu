// Deconv (transposed convolution) forward for Hopper, sm_90a.
//
// Replaces the TPU kernel deconv_pallas_3d (src/repro/kernels/deconv/
// kernel.py, body _deconv_kernel_body).  That kernel scatters: per grid step
// it multiplies an input tile by every tap of a phase and overlap-adds the
// products into a VMEM accumulator, carrying a halo between sequential
// d-tiles.  CUDA blocks run concurrently with nothing carried between them,
// so this kernel gathers instead: a block owns one output phase p, a tile of
// phase positions q and a block of output channels inside one group, and
// reads x[q - m] for every tap m of that phase (zero outside the input).
// The (lo, hi) crop folds into the store mask, and empty (dilation-gap)
// phases still store the epilogue of a zero sum, as the TPU kernel's
// zero-initialised accumulator does.  The phase grid may reach past the
// Eq. (1) extent (the conv's dx); rows there get the epilogue of zero.
//
// What bounds it on an H100: with IEEE f32 FMA on CUDA cores (67 TFLOP/s
// peak) and prod(K)/prod(S) x Cin MACs per output element on average
// (2.25 x Cin for DCGAN's 3x3 stride-2 layers, 3.4 x Cin for V-Net's
// 3x3x3 ones) against about Cin/prod(S) + Cout elements moved, the
// full-width layers are bound by operations, not bytes.  The shared block
// (igemm.cuh) pipelines the gathers through a cp.async ring, keeps 32-64
// f32 sums per thread fed by 16-byte shared reads, and splits a deep
// reduction over a short grid (served DCGAN: 1-4 taps x 512-1,024
// channels over a few dozen blocks) into slices summed in a second pass.
// What still bounds it: the served DCGAN layers are latency-bound (tens of
// microseconds of work per launch), and bf16 operands still run on CUDA
// cores: the tensor-core route is later work.
#include "igemm.cuh"

// This source is compiled once per variant (-DREPRO_PART=0..3, see
// igemm.cuh::variant_part); part 0 also holds the C entry point.
#ifndef REPRO_PART
#error "build with -DREPRO_PART=0..3"
#endif
#define REPRO_CAT2(a, b) a##b
#define REPRO_CAT(a, b) REPRO_CAT2(a, b)

int REPRO_CAT(repro_deconv_part, REPRO_PART)(const repro::FwdArgs& a) {
  return repro::run_part<true, REPRO_PART>(a);
}

#if REPRO_PART == 0
int repro_deconv_part1(const repro::FwdArgs& a);
int repro_deconv_part2(const repro::FwdArgs& a);
int repro_deconv_part3(const repro::FwdArgs& a);

extern "C" int repro_deconv_fwd(const void* x, const void* w_taps,
                                const int* taps, const float* scale,
                                const float* bias, void* y, float* work,
                                const int* geom, int act, float alpha,
                                int in_dtype, int out_dtype, int block_co,
                                int vec, void* stream) {
  repro::FwdArgs a;
  if (!repro::fwd_args(a, x, w_taps, taps, scale, bias, y, work, geom, act,
                       alpha, out_dtype, block_co, stream) ||
      (in_dtype != repro::DT_F32 && in_dtype != repro::DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (repro::variant_part(in_dtype, vec)) {
    case 0: return repro_deconv_part0(a);
    case 1: return repro_deconv_part1(a);
    case 2: return repro_deconv_part2(a);
    default: return repro_deconv_part3(a);
  }
}
#endif
