// Strided convolution forward for Hopper, sm_90a.
//
// Replaces the TPU kernel conv_pallas_3d (src/repro/kernels/conv/kernel.py,
// body _conv_kernel_body).  That kernel gathers x[p::S] per input phase into
// VMEM, runs one matmul per phase and carries a halo backwards between
// sequential d-tiles, over an input the host has already (lo, hi)-padded.
// Here a block owns a tile of output positions o and a block of output
// channels inside one group, and loops over the taps k (kernel-element
// order) and input channels, reading x[o*S + k*dil - lo] with zero-filling
// copies that stand in for the host-side pad.  No halo, no carry, no
// atomics: results repeat bit for bit.  The same launch with the channel
// roles swapped is the deconv's dx.
//
// What bounds it on an H100: the V-Net layers do 27 x Cin MACs per output
// element, far above the 20 FLOP/byte an f32 kernel needs to leave the
// 3.35 TB/s memory bound behind, so they are bound by operations (67 TFLOP/s
// IEEE f32 on CUDA cores); the 1x1x1 head (16 -> 2 channels) is bound by
// bytes.  What the block does about it (igemm.cuh): a cp.async ring in
// shared memory so the gathers of the next stage overlap this stage's
// FMAs, register tiles with 16-byte shared reads (on the narrow merge
// layers a thread owns all 16 or 32 channels of two rows), and a split of
// the (tap, channel) reduction, summed in a second pass in a fixed order,
// where the output alone leaves the card idle (V-Net's deepest layers,
// the DCGAN generator's dx).  What still bounds it: each input element is
// gathered from L2 once per tap, and a 16-channel layer reuses it only 16
// times; V-Net merge4 runs near 40 % of the f32 peak (PERF.md).
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

int REPRO_CAT(repro_conv_part, REPRO_PART)(const repro::FwdArgs& a) {
  return repro::run_part<false, REPRO_PART>(a);
}

#if REPRO_PART == 0
int repro_conv_part1(const repro::FwdArgs& a);
int repro_conv_part2(const repro::FwdArgs& a);
int repro_conv_part3(const repro::FwdArgs& a);
int repro_conv_part4(const repro::FwdArgs& a);
int repro_conv_part5(const repro::FwdArgs& a);
int repro_conv_part6(const repro::FwdArgs& a);
int repro_conv_part7(const repro::FwdArgs& a);
int repro_conv_part8(const repro::FwdArgs& a);
int repro_conv_part9(const repro::FwdArgs& a);
int repro_conv_part10(const repro::FwdArgs& a);
int repro_conv_part11(const repro::FwdArgs& a);

// in_dtype / w_dtype: x's and the weights' DType; the pair must be one
// igemm.cuh::pair_index knows.  copy picks the copy widths
// (igemm.cuh::variant_part): 16-byte copies of both operands or not for
// the FMA and TF32 routes, a bit per operand for the bf16 route (A: 1,
// B: 2), A's bytes per copy (16, 4 or 1) for int8 x int8, whose weights
// come K-major.  halo (int[HALO_FIELDS], or null) is the bf16 route's
// halo staging the planner chose (igemm.cuh::Halo; null: the gather).
// launched (int[3], or null) receives the kernel launched, its passes
// and its staging (igemm.cuh::Launched, Staging).
extern "C" int repro_conv_fwd(const void* x, const void* w,
                              const float* scale, const float* bias, void* y,
                              float* work, const int* geom, int act,
                              float alpha, int in_dtype, int w_dtype,
                              int out_dtype, int block_co, int copy,
                              const int* halo, int* launched,
                              void* stream) {
  repro::FwdArgs a;
  const int pair = repro::pair_index(in_dtype, w_dtype);
  if (pair < 0 || !repro::fwd_args(a, x, w, nullptr, scale, bias, y, work,
                                    geom, act, alpha, out_dtype, block_co,
                                    copy, halo, launched, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  using Part = int (*)(const repro::FwdArgs&);
  static const Part parts[repro::FWD_PARTS] = {
      repro_conv_part0,
      repro_conv_part1,
      repro_conv_part2,
      repro_conv_part3,
      repro_conv_part4,
      repro_conv_part5,
      repro_conv_part6,
      repro_conv_part7,
      repro_conv_part8,
      repro_conv_part9,
      repro_conv_part10,
      repro_conv_part11,
  };
  const int part = repro::variant_part(pair, copy, halo != nullptr);
  if (part < 0) return static_cast<int>(cudaErrorInvalidValue);
  return parts[part](a);
}
#endif
