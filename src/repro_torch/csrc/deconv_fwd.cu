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
// microseconds of work per launch).
//
// Quantized operands, as the TPU kernel takes them: int8 weights beside
// f32 or bf16 activations, or int8 activations and weights.  The kernel
// reads them from global memory as int8 and stages them as int8.  Beside
// float activations it runs on the TF32 tensor cores: int8 and bf16
// values are exact in TF32, f32 activations go in as hi + lo in two
// products, so the sums keep the reference's f32 cast-then-dot accuracy.
// int8 activations beside int8 weights run on the int8 tensor cores
// (mma.sync s8, exact s32 sums, the weights K-major).  bf16 x bf16 runs on
// the bf16 tensor cores (mma.sync m16n8k16, f32 sums: the products of
// bf16 values are exact, as in the reference's bf16 dot with f32 sums).
// The tensor-core routes are bound by their gathers (igemm.cuh), except
// where bf16 x bf16 stages each box of rows' input footprint once a chunk
// of channels (igemm_bf16_halo_kernel, the planner's choice).  Either
// way the per-cout dequant scale (the activations' per-tensor scale
// folded in) multiplies the finished sum first thing in the epilogue.
#include "igemm.cuh"

// This source is compiled once per variant (-DREPRO_PART=0..11, see
// igemm.cuh::variant_part); part 0 also holds the C entry point.
#ifndef REPRO_PART
#error "build with -DREPRO_PART=0..11"
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
int repro_deconv_part4(const repro::FwdArgs& a);
int repro_deconv_part5(const repro::FwdArgs& a);
int repro_deconv_part6(const repro::FwdArgs& a);
int repro_deconv_part7(const repro::FwdArgs& a);
int repro_deconv_part8(const repro::FwdArgs& a);
int repro_deconv_part9(const repro::FwdArgs& a);
int repro_deconv_part10(const repro::FwdArgs& a);
int repro_deconv_part11(const repro::FwdArgs& a);
int repro_deconv_wgmma(const void* x, const void* w_taps, const int* taps,
                       const float* scale, const float* bias, void* y,
                       const int* geom, const int* plan, int act,
                       float alpha, int out_dtype, int* launched,
                       void* stream);

// in_dtype / w_dtype: x's and the weights' DType; the pair must be one
// igemm.cuh::pair_index knows.  copy picks the copy widths
// (igemm.cuh::variant_part): 16-byte copies of both operands or not for
// the FMA and TF32 routes, a bit per operand for the bf16 route (A: 1,
// B: 2), A's bytes per copy (16, 4 or 1) for int8 x int8, whose weights
// come K-major.  halo (int[HALO_FIELDS], or null) is the bf16 route's
// halo staging the planner chose (igemm.cuh::Halo; null: the gather).
// wgmma (int[wg::FIELDS], or null) is the bf16 route's TMA + wgmma
// staging the planner chose (deconv_wgmma.cu::WgmmaPlan): the launch then
// runs deconv_wgmma.cu's kernel, with bf16 x and weights, no halo, no
// split (work, block_co and copy unused).
// launched (int[3], or null) receives the kernel launched, its passes
// and its staging (igemm.cuh::Launched, Staging).
extern "C" int repro_deconv_fwd(const void* x, const void* w_taps,
                                const int* taps, const float* scale,
                                const float* bias, void* y, float* work,
                                const int* geom, int act, float alpha,
                                int in_dtype, int w_dtype, int out_dtype,
                                int block_co, int copy,
                                const int* halo, const int* wgmma,
                                int* launched, void* stream) {
  if (wgmma) {
    if (halo || in_dtype != repro::DT_BF16 || w_dtype != repro::DT_BF16)
      return static_cast<int>(cudaErrorInvalidValue);
    return repro_deconv_wgmma(x, w_taps, taps, scale, bias, y, geom, wgmma,
                              act, alpha, out_dtype, launched, stream);
  }
  repro::FwdArgs a;
  const int pair = repro::pair_index(in_dtype, w_dtype);
  if (pair < 0 || !repro::fwd_args(a, x, w_taps, taps, scale, bias, y, work,
                                    geom, act, alpha, out_dtype, block_co,
                                    copy, halo, launched, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  using Part = int (*)(const repro::FwdArgs&);
  static const Part parts[repro::FWD_PARTS] = {
      repro_deconv_part0,
      repro_deconv_part1,
      repro_deconv_part2,
      repro_deconv_part3,
      repro_deconv_part4,
      repro_deconv_part5,
      repro_deconv_part6,
      repro_deconv_part7,
      repro_deconv_part8,
      repro_deconv_part9,
      repro_deconv_part10,
      repro_deconv_part11,
  };
  const int part = repro::variant_part(pair, copy, halo != nullptr);
  if (part < 0) return static_cast<int>(cudaErrorInvalidValue);
  return parts[part](a);
}
#endif
