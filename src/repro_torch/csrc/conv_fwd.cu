// Strided convolution forward for Hopper, sm_90a.
//
// Replaces the TPU kernel conv_pallas_3d (src/repro/kernels/conv/kernel.py,
// body _conv_kernel_body).  That kernel gathers x[p::S] per input phase into
// VMEM, runs one matmul per phase and carries a halo backwards between
// sequential d-tiles, over an input the host has already (lo, hi)-padded.
// Here a block owns a tile of 128 output positions o and a block of output
// channels inside one group, and loops over the taps k (kernel-element
// order) and input channels, reading x[o*S + k*dil - lo] with a masked load
// that stands in for the host-side pad.  Sums stay in f32 registers inside
// one thread; scale -> bias -> activation -> cast run on the finished sum.
// No halo, no carry, no atomics: results repeat bit for bit.
//
// What bounds it on an H100: the V-Net layers do 27 x Cin MACs per output
// element, far above the 20 FLOP/byte an f32 kernel needs to leave the
// 3.35 TB/s memory bound behind, so they are bound by operations (67 TFLOP/s
// IEEE f32 on CUDA cores).  The 1x1x1 head (16 -> 2 channels) is bound by
// bytes.  The design stages both operands in shared memory and keeps a
// 128 x BN tile of sums in registers; global loads are not yet pipelined.
#include "igemm.cuh"

extern "C" int repro_conv_fwd(const void* x, const void* w, const float* scale,
                              const float* bias, void* y, const int* geom,
                              int act, float alpha, int in_dtype,
                              int out_dtype, int block_co, void* stream) {
  return repro::launch<false>(x, w, nullptr, scale, bias, y, geom, act, alpha,
                              in_dtype, out_dtype, block_co, stream);
}
