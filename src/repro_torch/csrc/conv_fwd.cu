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
#include "igemm.cuh"

// This source is compiled once per variant (-DREPRO_PART=0..3, see
// igemm.cuh::variant_part); part 0 also holds the C entry point.
#ifndef REPRO_PART
#error "build with -DREPRO_PART=0..3"
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

extern "C" int repro_conv_fwd(const void* x, const void* w,
                              const float* scale,
                              const float* bias, void* y, float* work,
                              const int* geom, int act, float alpha,
                              int in_dtype, int out_dtype, int block_co,
                              int vec, void* stream) {
  repro::FwdArgs a;
  if (!repro::fwd_args(a, x, w, nullptr, scale, bias, y, work, geom, act,
                       alpha, out_dtype, block_co, stream) ||
      (in_dtype != repro::DT_F32 && in_dtype != repro::DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (repro::variant_part(in_dtype, vec)) {
    case 0: return repro_conv_part0(a);
    case 1: return repro_conv_part1(a);
    case 2: return repro_conv_part2(a);
    default: return repro_conv_part3(a);
  }
}
#endif
