// Implicit-GEMM block shared by the deconv and conv forward kernels.
//
// Both kernels compute, for one group g,
//
//     Y[row, co] = epilogue( sum_kk A[row, kk] * B[kk, co] )
//
// where a row is one output position (batch folded in), kk runs over
// (tap, input channel) pairs, A is gathered from the channels-last input on
// the fly (never materialised) and B is a plain row-major weight matrix:
//
//   * deconv (DECONV=true): a block owns ONE output phase p; its rows are the
//     phase positions q, its taps m come from the host's phase table, and
//     A[q, (m, ci)] = x[q - m, ci] (zero outside the input).  The phase's
//     weights are one contiguous [taps * Cin/G, Cout] slab of the
//     phase-major weight tensor.  Row q is stored at out[q*S + p - lo]
//     when that lands inside the cropped output.
//   * conv (DECONV=false): rows are output positions o, taps k run in
//     kernel-element order, and A[o, (k, ci)] = x[o*S + k*dil - lo, ci]
//     (zero in the padding).  Weights are [prod(K) * Cin/G, Cout].
//
// What bounds it on an H100: in IEEE f32 on CUDA cores (67 TFLOP/s, no
// TF32) the full-width layers are bound by operations, so the block is
// built to keep the FMA pipes fed:
//
//   * a ring of shared-memory stages (two for the narrow tiles, four for
//     the wide ones, 64 bytes of each row's pairs per stage) filled with
//     cp.async: 16-byte copies of 4 f32 / 8 bf16 / 16 int8 channels,
//     which skip L1 (.cg), where the layer's per-group channels allow, else
//     4-byte f32 copies or 2-byte bf16 / 1-byte int8 loads (the VEC
//     template flag, picked by the wrapper).  A source size of 0
//     zero-fills what the masks drop: padding, rows past the end, pairs
//     past the slice.  One barrier per
//     stage; the next stages load while this one computes.
//   * register tiles sized to the layer: where a group has <= 32 output
//     channels a thread owns all of them for two rows (32 or 64 sums) and
//     a block takes 256 rows; wider groups take 128 x 64 or 128 x 128
//     tiles of 8 x 8 sums a thread.  A is staged row-major with a 16-byte
//     pad (rows 80 bytes apart, so eight neighbouring rows hit eight
//     different bank quads) and read as 16-byte vectors along the
//     reduction; B is read as 16-byte vectors every thread of a warp
//     shares (a broadcast).  That is 4-16 FMAs per shared load.
//   * a split reduction for grids short of one wave: blockIdx.z carries
//     (phase, slice); each slice stores its f32 partial sums to a
//     workspace, and igemm_reduce sums the slices in slice order, then runs
//     the epilogue and the cropped store.  No atomics: a launch repeats bit
//     for bit.
//
// What still bounds it: the gathers re-read each input element once per
// tap from L2 (27 times on a 3x3x3 layer), and a 16-channel group reuses
// each staged input element only 16 times; the narrow merge layers reach
// about 40 % of the f32 peak.  (The bf16 x bf16 route stages each input
// element once per block instead where it can: igemm_bf16_halo_kernel.)
//
// No block waits on another.  Operands are staged in their own type: the
// activations (A, type TA) f32, bf16 or int8, the weights (B, type TB) the
// same type or int8.  A stage holds 64 bytes of each row's pairs at A's
// width (16 f32, 32 bf16 or 64 int8 pairs).  The operand pair picks one of
// four routes (the planner's tiling.py::operand_route):
//
//   * f32 x f32 (igemm_kernel, the "fma" route): IEEE f32 FMAs on the CUDA
//     cores, as described above.
//   * bf16 x bf16 (igemm_bf16_kernel, "bf16"): mma.sync m16n8k16 on the
//     bf16 tensor cores, f32 sums in the mma's registers (the products of
//     bf16 values are exact, as in the reference's bf16 dot with f32
//     sums); below.
//   * f32 x int8 and bf16 x int8 (igemm_tf32_kernel, "tf32"): mma.sync
//     m16n8k8 on the TF32 tensor cores, f32 sums.  Every int8 (|q| <=
//     127) and bf16 value is exact in TF32, so the weights and bf16
//     activations go in unsplit: int8 lanes become f32 exactly in registers
//     (the sign-flipped byte as the low mantissa byte of 2^23, minus 2^23 +
//     128: a byte permute and an add), bf16 ones by a shift.  An f32
//     activation is split once per fragment load into hi = rna_tf32(x) and
//     lo = rna_tf32(x - hi), hi + lo within 2^-21 of x, and each k8 step
//     runs two products, hi x w then lo x w (two passes; bf16 activations
//     one).  The tensor cores' f32 sums truncate, so a k8 step's two
//     products of f32 activations run from zero and are then added to
//     the f32 sums in registers, rounded to nearest; bf16 activations'
//     sums stay in the mma's registers, whose truncation (under 3e-5 of
//     max |y| at 4,096 pairs) is far below the operands' own rounding
//     (2^-9).
//   * int8 x int8 (igemm_s8_kernel, "s8"): below.
//
// The per-cout dequant scale is the epilogue's first multiply, on the
// finished sum (after the slices' sum when split), so it is applied exactly
// once, as the reference's cast-then-dot-then-scale does.
//
// The TF32 route keeps the FMA route's stages: A row-major at the 80-byte
// pitch (its 16-byte copies skip L1: 4 % faster than .ca on merge4),
// read with ldmatrix.x4 (a lane's words are a[gid][tig] and
// a[gid][tig + 4] of an f32 k8 step, or two bf16 pairs of a k16 chunk,
// which feed two k8 steps with the k order permuted: a0 / a2 take pairs
// 2 tig / 2 tig + 1, and B's rows follow), B N-major [pairs][channels] as
// the weights lie in memory, its rows padded (tf32_b_pitch) so the
// fragment reads of a warp hit distinct banks.  Each warp owns a 32-row x
// 16- or 32-channel tile; its n8 fragment j takes the channels n * NT + j
// (n the fragment column, NT the warp's fragments), so a lane reads its
// NT weights of a row in one 2- or 4-byte load.  The finished sums go
// through shared memory (the rings, free after the last stage) to the
// epilogue, as the s8 route's s32 sums do.  What bounds the route:
// the gathers, as on the s8 route, at four times its bytes for f32
// activations (V-Net merge4 under int8 weights stages 14.5 GB of A in
// 4.27 ms, PERF.md).
//
// The bf16 route keeps the same gather, ring, tables, masks, crop, split
// and C-tile epilogue, with the TF32 route's tiles, and takes away the
// instructions around the products (it keeps the gather only where the
// halo staging below does not apply): a k16 step is one mma.sync
// m16n8k16 bf16 per fragment (on the TF32 tensor cores it took two
// m16n8k8);
// A is read with ldmatrix.x4 from the 80-byte-pitch rows, whose lane
// words (rows lane % 16 at byte (lane / 16) * 16 of a 32-byte chunk) are
// the m16n8k16 A fragment in natural k order, with no shift or mask; B is
// staged N-major as the weights lie, its rows 2 BN + 16 bytes apart (an
// odd multiple of 16: bf16_b_pitch), and read with ldmatrix.x4.trans, one
// instruction for two n8 fragments of a k16 step, channels in natural
// order.  No operand is converted in the main loop.  The f32 sums stay in
// the mma's registers across the reduction (their truncation read under
// 6e-6 of max |y| of float64 at 4,096 pairs).  A's 16-byte copies go
// through L1 (.ca) and take their width apart from B's, as on the s8
// route, so a layer of 1-3 output channels still gathers its input 16
// bytes a copy.  The gather reads each input element once per tap, from
// L1 or L2 (V-Net merge4 1.52 ms of device time against a 0.12 ms byte
// bound), so where the planner allows it (tiling.py::plan_halo: a
// bf16 x bf16 launch, unsplit, Cin/G a multiple of 8, more than one
// tap, two stages within the shared memory of the tile's residency, and
// a modeled cost well under the gather's) the route stages A another way
// (igemm_bf16_halo_kernel): a block owns a box of the position grid, and
// a stage holds 8 input channels of the box's whole input footprint,
// each input element staged once, beside every tap's rows of B for
// those channels; each lane's ldmatrix reads its row's footprint slot
// plus the tap's offset, with no copy per tap (merge4 0.785 ms, cuDNN's
// 1.000).  The rest keep the gather: Cin/G not a multiple of 8 (V-Net
// enc1, DCGAN's 3-channel discriminator conv1), one tap (the 1x1x1
// head), split launches, and the launches whose footprint saves too
// little (stride-2 deconvs, whose phases hold 1-8 of 27 taps; stride-2
// convs, whose footprint holds eight input positions a row; grids too
// small to fill a box's rows).  What bounds the halo kernel: its k16
// steps, the ldmatrix reads of A (as many bytes as the gather's) and
// the products beside them (without them merge4 took 0.435 of its 0.79
// ms: scripts/halo_levers.py, PERF.md), then a block's copies, setup
// and epilogue, which run one after another (0.04-0.07 ms each); the
// wrappers' host time still bounds the short launches.
//
// int8 activations beside int8 weights take a route of their own, on the
// int8 tensor cores (igemm_s8_kernel): mma.sync m16n8k32 s8 x s8 with s32
// sums, which are exact (|q| <= 128, at most 2^31 / 128^2 pairs deep: the
// wrapper raises past that), so the one rounding is the s32 sum's
// conversion to f32 before the same epilogue.  The same gathers, masks,
// ring, tables, crop and split as above; what differs:
//
//   * B is K-major, [phases][G][Cout/G][kp] int8 (the deconv's phases
//     along the first axis, each phase's (tap, channel) pairs contiguous
//     and zero-padded to kp, the deepest phase's pairs rounded up to 16),
//     because s8 mma takes B with K contiguous and ldmatrix has no 8-bit
//     transpose.  A stage of B is [BN][64 + 16] bytes, filled with
//     16-byte copies only.
//   * A's copy width is its own (the VA template argument): 16-byte
//     copies where Cin/G % 16 == 0, 4-byte cp.async where Cin/G % 4 == 0,
//     else byte loads, whatever the output channels allow.  A's 16-byte
//     copies allocate in L1 (.ca): neighbouring rows' taps re-read the
//     same input, and on V-Net merge4 that took 0.95 against 1.22 ms.
//   * each warp owns a 32-row x 16/32/64-channel tile of m16n8 fragments;
//     A is read with ldmatrix.x4 from the 80-byte-pitch rows, B with
//     ldmatrix.x4 (two n8 fragments of one k32 step) from the 80-byte
//     rows of its K-major stage: no bank conflicts in either.  Every tile
//     is built for two resident blocks (128 registers a thread).
//   * the s32 tile goes through shared memory, and the epilogue runs as a
//     loop over rows, four channels a thread; a split stores s32 partials
//     (the f32 workspace's bytes) that igemm_reduce sums as integers,
//     exactly, before the epilogue.
//
// What bounds the int8 route: the tensor cores' 1,979 TOP/s take a V-Net
// merge layer's reduction in tens of microseconds, so the gathers bound
// it (each input element read once per tap, from L1 or L2: merge4 0.92 ms
// against a 0.12 ms byte bound), then the output's bytes.  wgmma, TMA and
// staging the input tile once with its halo (as the bf16 route's
// igemm_bf16_halo_kernel does) are what it leaves.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

// Geometry, in the order the Python wrappers pack it (GEOM_FIELDS).
struct Geom {
  int N, D, H, W, Ci, Co, G;   // input [N, D, H, W, Ci]; output channels Co
  int Kd, Kh, Kw;              // kernel extent
  int Sd, Sh, Sw;              // stride
  int dd, dh, dw;              // dilation
  int Pd, Ph, Pw;              // position grid of the rows (deconv: phase
                               // positions q; conv: output positions o)
  int Od, Oh, Ow;              // output tensor extent (after the crop)
  int lod, loh, low;           // deconv: crop lo; conv: pad lo
  int splits;                  // slices of the (tap, channel) reduction
  int k_per_split;             // pairs per slice, a multiple of 32
};
constexpr int GEOM_FIELDS = 27;
static_assert(sizeof(Geom) == GEOM_FIELDS * sizeof(int), "Geom is packed");

struct Epi {
  const float* scale;  // [Co] or null
  const float* bias;   // [Co] or null
  int act;
  float alpha;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float epilogue(float v, const Epi& e, int co) {
  if (e.scale) v *= e.scale[co];
  if (e.bias) v += e.bias[co];
  // relu and leaky_relu keep NaN, as the reference's maximum/where do
  if (e.act == ACT_RELU) v = v < 0.f ? 0.f : v;
  else if (e.act == ACT_LEAKY) v = v > 0.f ? v : e.alpha * v;
  else if (e.act == ACT_TANH) v = tanhf(v);
  return v;
}

__device__ __forceinline__ void store_out(void* y, int out_bf16, int64_t i,
                                          float v) {
  if (out_bf16) static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
  else static_cast<float*>(y)[i] = v;
}

// The slices' partial sums of element i, added in slice order (a fixed
// order: the result repeats bit for bit), as f32.  partial is [splits][n]
// of f32 sums, or of s32 ones (the int8 route: summed exactly, converted
// once).
template <typename TP>
__device__ __forceinline__ float slice_sum(const TP* __restrict__ partial,
                                           int64_t n, int splits, int64_t i) {
  TP s = 0;
  for (int z = 0; z < splits; ++z) s += partial[(int64_t)z * n + i];
  return static_cast<float>(s);
}

// -- asynchronous copies ---------------------------------------------------

// Copy BYTES from global to shared memory, or zero-fill them when !valid
// (source size 0: nothing is read).  cp.async has no 1- or 2-byte form, so
// the int8 and bf16 scalar variants load and store synchronously.  L1:
// whether a 16-byte copy also allocates in L1 (.ca) or skips it (.cg).
template <int BYTES, bool L1 = false>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           bool valid) {
  if constexpr (BYTES == 1) {
    *static_cast<int8_t*>(smem) =
        valid ? *static_cast<const int8_t*>(gmem) : (int8_t)0;
  } else if constexpr (BYTES == 2) {
    *static_cast<uint16_t*>(smem) =
        valid ? *static_cast<const uint16_t*>(gmem) : (uint16_t)0;
  } else {
    static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int src_bytes = valid ? BYTES : 0;
    // 16-byte copies of the float route skip L1 (.cg): the staged operands
    // live in shared memory, and allocating them in L1 too measured slower
    if constexpr (BYTES == 16 && !L1)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst), "l"(gmem), "r"(src_bytes));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                       dst), "l"(gmem), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// -- 16-byte shared reads ---------------------------------------------------

// Element k of a 16-byte vector of T, as f32.
template <typename T>
__device__ __forceinline__ float lane_f32(const uint4& v, int k);
template <>
__device__ __forceinline__ float lane_f32<float>(const uint4& v, int k) {
  const unsigned u = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  return __uint_as_float(u);
}
template <>
__device__ __forceinline__ float lane_f32<__nv_bfloat16>(const uint4& v,
                                                         int k) {
  const int q = k >> 1;
  const unsigned u = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
}
// exact: byte k of the vector with its sign bit flipped (q + 128, in
// [1, 255]) becomes the low mantissa byte of 2^23, then 2^23 + 128 comes
// off again
template <>
__device__ __forceinline__ float lane_f32<int8_t>(const uint4& v, int k) {
  const int q = k >> 2;
  const unsigned u = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  const unsigned b =
      __byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540u | (unsigned)(k & 3));
  return __uint_as_float(b) - 8388736.f;
}

// N consecutive values of T from shared memory, as f32: 16-byte vectors,
// or one 8-, 4- or 2-byte read for a shorter row; src aligned to the read.
template <typename T, int N>
__device__ __forceinline__ void load_row(float* out, const T* src) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES >= 16) {
    static_assert(N % PER == 0, "row of whole 16-byte vectors");
#pragma unroll
    for (int v = 0; v < N / PER; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[v];
#pragma unroll
      for (int k = 0; k < PER; ++k) out[v * PER + k] = lane_f32<T>(raw, k);
    }
  } else {
    static_assert(BYTES == 8 || BYTES == 4 || BYTES == 2,
                  "an 8-, 4- or 2-byte read");
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      raw.x = u.x;
      raw.y = u.y;
    } else if constexpr (BYTES == 4) {
      raw.x = *reinterpret_cast<const unsigned*>(src);
    } else {
      raw.x = *reinterpret_cast<const uint16_t*>(src);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = lane_f32<T>(raw, k);
  }
}

// -- tiles -----------------------------------------------------------------

// BM rows x BN output channels per block, TM x TN sums per thread, KB
// bytes of each row's (tap, channel) pairs per stage, ST stages in the
// ring.  Keep in step with repro_torch/core/tiling.py::KERNEL_TILES.
template <int BM_, int BN_, int TM_, int TN_, int KB_, int ST_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int KB = KB_, ST = ST_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
};
// The narrow tiles take 256 rows in two deep stages (more resident blocks
// per SM hide the gathers' latency); the wide ones four.  Each shape was
// the fastest of those timed on an H100 (PERF.md).
using Tile16 = Tile<256, 16, 2, 16, 64, 2>;
using Tile32 = Tile<256, 32, 2, 32, 64, 2>;
using Tile64 = Tile<128, 64, 8, 8, 64, 4>;
using Tile128 = Tile<128, 128, 8, 8, 64, 4>;

constexpr int APAD = 16;         // pad after each staged A row, bytes
constexpr int MAX_TAPS = 128;    // taps a block's shared tap table holds

// Dynamic shared memory of one FMA-route block: the A and B rings (a
// stage of B is KB / 4 pairs of BN f32 weights), the row table and the
// tap table.  Keep in step with tiling.py::step_byte_model.
template <class TL>
constexpr int fma_smem_bytes() {
  return TL::ST * (TL::BM * (TL::KB + APAD) + TL::KB / 4 * TL::BN * 4) +
         16 * TL::BM + 16 * MAX_TAPS;
}

// Flat element offset of output row m's channel 0, or false when the row
// falls outside the (cropped) output.
template <bool DECONV>
__device__ __forceinline__ bool out_offset(const Geom& g, int m, int pd,
                                           int ph, int pw, int64_t& out) {
  int t = m;
  int ow = t % g.Pw; t /= g.Pw;
  int oh = t % g.Ph; t /= g.Ph;
  int od = t % g.Pd;
  const int n = t / g.Pd;
  if (DECONV) {
    od = od * g.Sd + pd - g.lod;
    oh = oh * g.Sh + ph - g.loh;
    ow = ow * g.Sw + pw - g.low;
    if ((unsigned)od >= (unsigned)g.Od || (unsigned)oh >= (unsigned)g.Oh ||
        (unsigned)ow >= (unsigned)g.Ow)
      return false;
  }
  out = ((((int64_t)n * g.Od + od) * g.Oh + oh) * g.Ow + ow) * g.Co;
  return true;
}

// -- what both routes share: a block's place, its tables, A's gather -------

// The block of blockIdx: x = row tile, y = group x channel tile, z = phase
// x slice.  Its rows start at m0, its channels at co0 within group grp,
// and its slice of the reduction covers pairs [kb, ke) of the phase's
// (or the conv's) ntaps taps, the first tap0 of the phase table.
struct BlockPos {
  int grp, co0, m0, rows, slice, p, pd, ph, pw, tap0, ntaps, kb, ke;
  const int* tapm;   // the deconv's per-tap (m_d, m_h, m_w) offsets
};

template <bool DECONV, int BM, int BN>
__device__ __forceinline__ BlockPos block_pos(const Geom& g,
                                              const int* taps) {
  BlockPos b;
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int co_tiles = (Cog + BN - 1) / BN;
  b.grp = blockIdx.y / co_tiles;
  b.co0 = (blockIdx.y % co_tiles) * BN;          // within the group
  b.rows = g.N * g.Pd * g.Ph * g.Pw;
  b.m0 = blockIdx.x * BM;
  b.slice = blockIdx.z % g.splits;
  b.p = blockIdx.z / g.splits;
  b.pd = b.ph = b.pw = b.tap0 = 0;
  b.tapm = taps;
  if (DECONV) {
    b.pw = b.p % g.Sw;
    b.ph = (b.p / g.Sw) % g.Sh;
    b.pd = b.p / (g.Sw * g.Sh);
    b.tap0 = taps[2 * b.p];
    b.ntaps = taps[2 * b.p + 1];
    b.tapm = taps + 2 * g.Sd * g.Sh * g.Sw;
  } else {
    b.ntaps = g.Kd * g.Kh * g.Kw;
  }
  b.kb = b.slice * g.k_per_split;
  b.ke = min(b.ntaps * Cig, b.kb + g.k_per_split);
  return b;
}

// A halo-staged launch's staging (igemm_bf16_halo_kernel), as the planner
// packs it (tiling.py::HaloPlan.fields): a stage holds 8 input channels
// of the box's footprint, slots positions, the footprint's planes lh x lw
// slots apart and its lines lw apart (each at least the footprint's
// extent, padded so that every aligned eight rows of the box take slots
// that differ mod 8), the last slot zero; steps k16 steps of B a stage.
struct Halo {
  int bd, bh, bw;      // the box a block owns
  int lh, lw;          // lines a plane, slots a line
  int slots;           // slots a stage (planes x lh x lw + the zero slot)
  int steps;           // k16 steps a stage (the deepest phase's)
};
constexpr int HALO_FIELDS = 7;
static_assert(sizeof(Halo) == HALO_FIELDS * sizeof(int), "Halo is packed");

// A halo-staged block's place: BlockPos's group, channels and phase, and
// the box: batch item n, origin (od0, oh0, ow0) on the position grid (the
// deconv's phase positions q, the conv's output positions o), fewer of
// its positions inside the grid at the grid's edges.
struct BoxPos : BlockPos {
  int n, od0, oh0, ow0;
};

// blockIdx: x = box (batch item, then boxes along d, h, w, w fastest), y
// = group x channel tile, z = phase.
template <bool DECONV, int BN>
__device__ __forceinline__ BoxPos box_pos(const Geom& g, const int* taps,
                                          const Halo& h) {
  BoxPos b;
  static_cast<BlockPos&>(b) = block_pos<DECONV, 1, BN>(g, taps);
  const int nbd = (g.Pd + h.bd - 1) / h.bd, nbh = (g.Ph + h.bh - 1) / h.bh,
            nbw = (g.Pw + h.bw - 1) / h.bw;
  int t = blockIdx.x;
  b.ow0 = (t % nbw) * h.bw; t /= nbw;
  b.oh0 = (t % nbh) * h.bh; t /= nbh;
  b.od0 = (t % nbd) * h.bd;
  b.n = t / nbd;
  return b;
}

// Tap t's input offset (flat position delta) and coordinate deltas.
template <bool DECONV>
__device__ __forceinline__ int4 tap_entry(const Geom& g, const BlockPos& b,
                                          int t) {
  int dd, dh, dw;
  if (DECONV) {
    const int* mm = b.tapm + 3 * (b.tap0 + t);
    dd = -mm[0]; dh = -mm[1]; dw = -mm[2];
  } else {
    const int kw = t % g.Kw, kh = (t / g.Kw) % g.Kh, kd = t / (g.Kw * g.Kh);
    dd = kd * g.dd; dh = kh * g.dh; dw = kw * g.dw;
  }
  return make_int4((dd * g.H + dh) * g.W + dw, dd, dh, dw);
}

// The block's row table (each row's input position of tap offset 0 and its
// coordinates; rows past the end get coordinates every tap reads out of
// bounds) and tap table (the first MAX_TAPS taps' tap_entry), then a
// barrier.
template <bool DECONV, int BM, int THREADS>
__device__ __forceinline__ void fill_tables(const Geom& g, const BlockPos& b,
                                            int4* rowtab, int4* taptab) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = b.m0 + r;
    int4 e = make_int4(0, -(1 << 29), 0, 0);
    if (m < b.rows) {
      int t = m;
      const int qw = t % g.Pw; t /= g.Pw;
      const int qh = t % g.Ph; t /= g.Ph;
      const int qd = t % g.Pd;
      const int n = t / g.Pd;
      int bd = qd, bh = qh, bw = qw;
      if (!DECONV) {
        bd = qd * g.Sd - g.lod;
        bh = qh * g.Sh - g.loh;
        bw = qw * g.Sw - g.low;
      }
      e = make_int4(((n * g.D + bd) * g.H + bh) * g.W + bw, bd, bh, bw);
    }
    rowtab[r] = e;
  }
  for (int t = threadIdx.x; t < b.ntaps && t < MAX_TAPS; t += THREADS)
    taptab[t] = tap_entry<DECONV>(g, b, t);
  __syncthreads();
}

// The gather of A into one stage: BM rows x BK pairs of TA, VA consecutive
// channels of one tap a copy (VA divides Cin/G), UNROLL copies in flight
// per thread, 16-byte copies through L1 when L1.  A thread owns copy
// column ca (pair k0 + ca*VA of every stage, at tap a_t and channel a_ci,
// advanced one stage at a time) of rows ra, ra + A_ROWS, ...; what the
// masks drop is zero-filled: padding, rows past the end, pairs at or past
// ke.
template <typename TA, int VA, int BM, int THREADS, int BK, int APITCH,
          int UNROLL, bool DECONV, bool L1 = false>
struct AGather {
  static constexpr int A_CH = BK / VA;            // copies per A row
  static constexpr int A_ROWS = THREADS / A_CH;   // rows one pass covers
  static_assert(BK % VA == 0 && THREADS % A_CH == 0 && BM % A_ROWS == 0,
                "A copies");
  int ca, ra, a_t, a_ci, a_tcur;
  int4 a_tap;         // a_tcur's offsets (taptab entry)
  int64_t ci_base;

  __device__ __forceinline__ AGather(const Geom& g, const BlockPos& b) {
    const int Cig = g.Ci / g.G;
    ca = threadIdx.x % A_CH;
    ra = threadIdx.x / A_CH;
    const int kk = b.kb + ca * VA;
    a_t = kk / Cig;
    a_ci = kk - a_t * Cig;
    a_tcur = -1;
    a_tap = make_int4(0, 0, 0, 0);
    ci_base = (int64_t)b.grp * Cig;
  }

  __device__ __forceinline__ void load(TA* As_slot, int k0, const TA* x,
                                       const Geom& g, const BlockPos& b,
                                       const int4* rowtab,
                                       const int4* taptab) {
    const int Cig = g.Ci / g.G;
    const bool k_ok = k0 + ca * VA < b.ke;
    if (k_ok && a_t != a_tcur) {
      a_tcur = a_t;
      a_tap = a_t < MAX_TAPS ? taptab[a_t] : tap_entry<DECONV>(g, b, a_t);
    }
    const int64_t coff = ci_base + a_ci;
    TA* adst = As_slot + ra * APITCH + ca * VA;
#pragma unroll (UNROLL)
    for (int j = 0; j < BM / A_ROWS; ++j) {
      const int4 e = rowtab[ra + j * A_ROWS];
      const int id = e.y + a_tap.y, ih = e.z + a_tap.z, iw = e.w + a_tap.w;
      const bool ok = k_ok && (unsigned)id < (unsigned)g.D &&
                      (unsigned)ih < (unsigned)g.H &&
                      (unsigned)iw < (unsigned)g.W;
      const TA* src = ok ? x + (int64_t)(e.x + a_tap.x) * g.Ci + coff : x;
      copy_async<VA * (int)sizeof(TA), L1>(adst + j * A_ROWS * APITCH, src,
                                           ok);
    }
    a_ci += BK;
    if (a_ci >= Cig) {
      const int q = a_ci / Cig;
      a_t += q;
      a_ci -= q * Cig;
    }
  }
};

// -- the FMA route: f32 x f32 on the CUDA cores ------------------------------

// blockIdx: x = row tile, y = group x channel tile, z = phase x slice.
// The FMA route keeps its own copy of the block's setup and gather
// (block_pos, fill_tables and AGather are the same code), the code that
// was timed for it (PERF.md).  With partial != nullptr the block stores its
// slice's raw f32 sums at partial[((slice * phases + p) * rows + m) * Co +
// c]; else the epilogue's result in y (f32, or bf16 when out_bf16).
template <class TL, bool VEC, bool DECONV>
__global__ void __launch_bounds__(TL::THREADS)
igemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const int* __restrict__ taps, Epi ep, void* __restrict__ y,
             int out_bf16, float* __restrict__ partial, Geom g) {
  using TA = float;
  using TB = float;
  constexpr int BM = TL::BM, BN = TL::BN, TM = TL::TM, TN = TL::TN;
  constexpr int THREADS = TL::THREADS, STAGES = TL::ST;
  constexpr int BK = TL::KB / sizeof(TA);         // pairs per stage
  constexpr int APITCH = (TL::KB + APAD) / sizeof(TA);
  constexpr int VA = VEC ? 16 / sizeof(TA) : 1;   // A elements per copy
  constexpr int VB = VEC ? 16 / sizeof(TB) : 1;   // B elements per copy
  constexpr int CA = VA * sizeof(TA);             // bytes per A copy
  constexpr int CB = VB * sizeof(TB);             // bytes per B copy
  constexpr int A_CH = BK / VA;                   // copies per A row
  constexpr int A_ROWS = THREADS / A_CH;          // rows one pass covers
  constexpr int B_CH = BN / VB;                   // copies per B row
  constexpr int B_COPIES = BK * B_CH;             // copies per B stage
  constexpr int KV = 16 / sizeof(TA);             // pairs per 16-byte read
  // the scalar variants' many small copies stay a loop (build time)
  constexpr int A_UNROLL = VEC ? BM / A_ROWS : 4;
  static_assert(THREADS % A_CH == 0 && BM % A_ROWS == 0, "A copies");
  static_assert(BK % KV == 0 && BN % TN == 0 && BM % TM == 0 && TN % 4 == 0
                && BN % VB == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);                // [STAGES][BM][APITCH]
  TB* Bs = reinterpret_cast<TB*>(As + STAGES * BM * APITCH);  // [ST][BK][BN]
  int4* rowtab = reinterpret_cast<int4*>(Bs + STAGES * BK * BN);  // [BM]
  int4* taptab = rowtab + BM;                                  // [MAX_TAPS]

  const int tid = threadIdx.x;
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int co_tiles = (Cog + BN - 1) / BN;
  const int grp = blockIdx.y / co_tiles;
  const int co0 = (blockIdx.y % co_tiles) * BN;          // within the group
  const int rows = g.N * g.Pd * g.Ph * g.Pw;
  const int m0 = blockIdx.x * BM;
  const int slice = blockIdx.z % g.splits;
  const int p = blockIdx.z / g.splits;

  int pd = 0, ph = 0, pw = 0, tap0 = 0, ntaps;
  const int* tapm = taps;
  if (DECONV) {
    pw = p % g.Sw;
    ph = (p / g.Sw) % g.Sh;
    pd = p / (g.Sw * g.Sh);
    tap0 = taps[2 * p];
    ntaps = taps[2 * p + 1];
    tapm = taps + 2 * g.Sd * g.Sh * g.Sw;
  } else {
    ntaps = g.Kd * g.Kh * g.Kw;
  }
  const int depth = ntaps * Cig;
  const int kb = slice * g.k_per_split;
  const int ke = min(depth, kb + g.k_per_split);
  const int nst = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  // per-row input position of tap offset 0 and its coordinates; rows past
  // the end get coordinates every tap reads out of bounds
  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    int4 e = make_int4(0, -(1 << 29), 0, 0);
    if (m < rows) {
      int t = m;
      const int qw = t % g.Pw; t /= g.Pw;
      const int qh = t % g.Ph; t /= g.Ph;
      const int qd = t % g.Pd;
      const int n = t / g.Pd;
      int bd = qd, bh = qh, bw = qw;
      if (!DECONV) {
        bd = qd * g.Sd - g.lod;
        bh = qh * g.Sh - g.loh;
        bw = qw * g.Sw - g.low;
      }
      e = make_int4(((n * g.D + bd) * g.H + bh) * g.W + bw, bd, bh, bw);
    }
    rowtab[r] = e;
  }
  // per-tap input offset (flat position delta) and coordinate deltas
  auto tap_entry = [&](int t) {
    int dd, dh, dw;
    if (DECONV) {
      const int* mm = tapm + 3 * (tap0 + t);
      dd = -mm[0]; dh = -mm[1]; dw = -mm[2];
    } else {
      const int kw = t % g.Kw, kh = (t / g.Kw) % g.Kh, kd = t / (g.Kw * g.Kh);
      dd = kd * g.dd; dh = kh * g.dh; dw = kw * g.dw;
    }
    return make_int4((dd * g.H + dh) * g.W + dw, dd, dh, dw);
  };
  for (int t = tid; t < ntaps && t < MAX_TAPS; t += THREADS)
    taptab[t] = tap_entry(t);
  __syncthreads();

  // this thread's A copy column: pair kk = k0 + ca*V of every stage, at
  // tap a_t and channel a_ci, advanced one stage at a time
  const int ca = tid % A_CH, ra = tid / A_CH;
  int a_t, a_ci;
  {
    const int kk = kb + ca * VA;
    a_t = kk / Cig;
    a_ci = kk - a_t * Cig;
  }
  int a_tcur = -1;
  int4 a_tap = make_int4(0, 0, 0, 0);   // a_tcur's offsets (taptab entry)
  const int64_t ci_base = (int64_t)grp * Cig;
  const int64_t co_base = (int64_t)grp * Cog;
  const int64_t w_row0 = (int64_t)tap0 * Cig;

  auto load_stage = [&](int slot, int k0) {
    // A: BM rows x BK pairs, gathered
    const bool k_ok = k0 + ca * VA < ke;
    if (k_ok && a_t != a_tcur) {
      a_tcur = a_t;
      a_tap = a_t < MAX_TAPS ? taptab[a_t] : tap_entry(a_t);
    }
    const int64_t coff = ci_base + a_ci;
    TA* adst = As + (slot * BM + ra) * APITCH + ca * VA;
#pragma unroll (A_UNROLL)
    for (int j = 0; j < BM / A_ROWS; ++j) {
      const int4 e = rowtab[ra + j * A_ROWS];
      const int id = e.y + a_tap.y, ih = e.z + a_tap.z, iw = e.w + a_tap.w;
      const bool ok = k_ok && (unsigned)id < (unsigned)g.D &&
                      (unsigned)ih < (unsigned)g.H &&
                      (unsigned)iw < (unsigned)g.W;
      const TA* src = ok ? x + (int64_t)(e.x + a_tap.x) * g.Ci + coff : x;
      copy_async<CA>(adst + j * A_ROWS * APITCH, src, ok);
    }
    a_ci += BK;
    if (a_ci >= Cig) {
      const int q = a_ci / Cig;
      a_t += q;
      a_ci -= q * Cig;
    }
    // B: BK rows x BN channels of the plain [taps * Cig, Co] slab
    TB* bdst = Bs + slot * BK * BN;
#pragma unroll
    for (int e0 = 0; e0 < B_COPIES; e0 += THREADS) {
      const int e = e0 + tid;
      if (B_COPIES % THREADS == 0 || e < B_COPIES) {
        const int k = e / B_CH, c = (e - k * B_CH) * VB;
        const int co = co0 + c;
        const bool ok = k0 + k < ke && co < Cog;
        const TB* src =
            ok ? w + (w_row0 + k0 + k) * g.Co + co_base + co : w;
        copy_async<CB>(bdst + k * BN + c, src, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, kb + s * BK);
    copy_commit();
  }

  const int ty = tid % (BM / TM), tx = tid / (BM / TM);
  for (int st = 0; st < nst; ++st) {
    copy_wait<STAGES - 2>();   // stage st has landed (this thread's copies)
    __syncthreads();           // ... everyone's; slot st-1 is free again
    const int nxt = st + STAGES - 1;
    if (nxt < nst) load_stage(nxt % STAGES, kb + nxt * BK);
    copy_commit();
    const int slot = st % STAGES;
    const TA* a_s = As + (slot * BM + ty) * APITCH;
    const TB* b_s = Bs + slot * BK * BN + tx * TN;
#pragma unroll
    for (int kg = 0; kg < BK; kg += KV) {
      uint4 araw[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        araw[i] = *reinterpret_cast<const uint4*>(
            a_s + i * (BM / TM) * APITCH + kg);
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        float b[TN];
        load_row<TB, TN>(b, b_s + (kg + k) * BN);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = lane_f32<TA>(araw[i], k);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }
  copy_wait<0>();

  // a slice's raw sums, or the epilogue and the store (crop folded in);
  // four channels go in one store where every row's start is aligned
  const int cot = co0 + tx * TN;                     // within the group
  const bool vec_out =
      g.Co % 4 == 0 && Cog % 4 == 0 &&
      reinterpret_cast<uintptr_t>(y) % (out_bf16 ? 8 : 16) == 0;
  const int phases = DECONV ? g.Sd * g.Sh * g.Sw : 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= rows) continue;
    if (partial) {
      float* dst = partial +
                   (((int64_t)slice * phases + p) * rows + m) * g.Co +
                   co_base + cot;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (cot + j < Cog) dst[j] = acc[i][j];
      continue;
    }
    int64_t out;
    if (!out_offset<DECONV>(g, m, pd, ph, pw, out)) continue;
    out += co_base + cot;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)       // (scale/bias hold Co values)
        v[u] = cot + j + u < Cog
                   ? epilogue(acc[i][j + u], ep, (int)co_base + cot + j + u)
                   : 0.f;
      if (vec_out && cot + j + 3 < Cog) {
        if (out_bf16) {       // four bf16 in one 8-byte store
          __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 pk;
          pk.x = *reinterpret_cast<unsigned*>(&lo);
          pk.y = *reinterpret_cast<unsigned*>(&hi);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + out +
                                    j) = pk;
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(y) + out + j) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (cot + j + u < Cog) store_out(y, out_bf16, out + j + u, v[u]);
      }
    }
  }
}

// The split reduction's second pass: element i = (p * rows + m) * Co + c
// sums its slices in slice order (TP: f32 sums, or s32 ones summed
// exactly), then the epilogue and the cropped store.
template <typename TP, bool DECONV>
__global__ void igemm_reduce(const TP* __restrict__ partial, Epi ep,
                             void* __restrict__ y, int out_bf16, Geom g) {
  const int rows = g.N * g.Pd * g.Ph * g.Pw;
  const int phases = DECONV ? g.Sd * g.Sh * g.Sw : 1;
  const int64_t n = (int64_t)phases * rows * g.Co;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % g.Co);
  const int64_t pm = i / g.Co;
  const int m = (int)(pm % rows), p = (int)(pm / rows);
  const float s = slice_sum(partial, n, g.splits, i);
  const int pw = p % g.Sw, ph = (p / g.Sw) % g.Sh, pd = p / (g.Sw * g.Sh);
  int64_t out;
  if (!out_offset<DECONV>(g, m, pd, ph, pw, out)) return;
  store_out(y, out_bf16, out + c, epilogue(s, ep, c));
}

// -- the tensor-core routes: what both share --------------------------------

// BM rows x BN output channels per block, WM x WN warps of (BM/WM) x
// (BN/WN) sums each (m16n8 fragments, four sums a thread each), KB bytes
// of each row's pairs per stage (64 on the TF32 and s8 routes), ST
// stages, MINB blocks an SM keeps resident (the register cap).  Keep in
// step with repro_torch/core/tiling.py::S8_KERNEL_TILES,
// TF32_KERNEL_TILES and BF16_KERNEL_TILES.
template <int BM_, int BN_, int WM_, int WN_, int ST_, int MINB_,
          int KB_ = 64>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int ST = ST_, MINB = MINB_, KB = KB_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // its fragments
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "whole fragment pairs");
  static constexpr int CPITCH = BN + 4;      // sums per row of the C tile
};
// Two resident blocks (128 registers a thread): capped at 80 for three,
// the s8 deconv's tiles spilled; on V-Net merge4 two, three or four s8
// blocks an SM timed within 1 % of each other (PERF.md).
using S8Tile16 = MmaTile<256, 16, 8, 1, 3, 2>;
using S8Tile32 = MmaTile<256, 32, 8, 1, 3, 2>;
using S8Tile64 = MmaTile<128, 64, 4, 2, 4, 2>;
using S8Tile128 = MmaTile<128, 128, 4, 2, 4, 2>;
// The TF32 route's tiles, the FMA route's rows and stages.  The narrowest
// takes three blocks an SM (85 registers: with three stages it spilled; on
// V-Net merge4, f32 x int8, it timed 5 % under three stages and two
// blocks, PERF.md), the 32-channel one two blocks (at three stages it
// spilled), and the widest sixteen warps of 32 x 32, one block (a 32 x 64
// warp tile, 64 f32 sums a thread, spilled at 128 registers).  Warps of
// 32 x 16 in the 32- and 64-channel tiles timed 9-12 % slower over the
// V-Net batch, f32 x int8 and bf16 alike (PERF.md).
using Tf32Tile16 = MmaTile<256, 16, 8, 1, 2, 3>;
using Tf32Tile32 = MmaTile<256, 32, 8, 1, 2, 2>;
using Tf32Tile64 = MmaTile<128, 64, 4, 2, 4, 2>;
using Tf32Tile128 = MmaTile<128, 128, 4, 4, 4, 1>;

// Four 8 x 16-byte matrices from shared memory: lanes 8q..8q+7 give the
// row addresses of matrix q, and each lane receives word (lane % 4) of row
// lane / 4 of each matrix.
__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3,
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// The finished BM x BN tile of sums (TC: s32 or f32) in shared memory,
// ctile[r * CPITCH + c], after a barrier: four channels of a row a
// thread, in row order, a slice's raw sums stored at partial[((slice *
// phases + p) * rows + m) * Co + c], or the f32 epilogue and one store of
// four where aligned.  (An epilogue straight from the fragments, unrolled
// over every fragment, took cicc minutes to compile.)
template <typename TC, class TL, bool DECONV>
__device__ __forceinline__ void store_tile(const TC* ctile, const Geom& g,
                                           const BlockPos& b, const Epi& ep,
                                           void* y, int out_bf16,
                                           TC* partial) {
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  constexpr int CPITCH = TL::CPITCH;
  const int tid = threadIdx.x;
  const int Cog = g.Co / g.G;
  const int phases = DECONV ? g.Sd * g.Sh * g.Sw : 1;
  const int64_t co_base = (int64_t)b.grp * Cog;
  const bool vec_out =
      g.Co % 4 == 0 && Cog % 4 == 0 &&
      reinterpret_cast<uintptr_t>(y) % (out_bf16 ? 8 : 16) == 0;
#pragma unroll 1
  for (int e = tid; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4), c = b.co0 + (e - r * (BN / 4)) * 4;
    const int m = b.m0 + r;
    if (m >= b.rows || c >= Cog) continue;
    using V4 = typename Vec4<TC>::type;
    const V4 s4 = *reinterpret_cast<const V4*>(ctile + r * CPITCH + c -
                                               b.co0);
    const TC sv[4] = {s4.x, s4.y, s4.z, s4.w};
    if (partial) {
      TC* dst = partial +
                (((int64_t)b.slice * phases + b.p) * b.rows + m) * g.Co +
                co_base + c;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < Cog) dst[u] = sv[u];
      continue;
    }
    int64_t out;
    if (!out_offset<DECONV>(g, m, b.pd, b.ph, b.pw, out)) continue;
    out += co_base + c;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)         // (scale/bias hold Co values)
      v[u] = c + u < Cog ? epilogue(static_cast<float>(sv[u]), ep,
                                    (int)co_base + c + u)
                         : 0.f;
    if (vec_out && c + 3 < Cog) {
      if (out_bf16) {         // four bf16 in one 8-byte store
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<unsigned*>(&lo);
        pk.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + out) = pk;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(y) + out) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < Cog) store_out(y, out_bf16, out + u, v[u]);
    }
  }
}

// -- the TF32 route: f32 x int8, bf16 x int8 ---------------------------------

// The bytes between two staged B rows of BN weights of TB: the least
// multiple of 16 with (4 / sizeof(TA)) x pitch = 32 (mod 64), so that
// the four quads of a warp (B rows tig, or 2 tig with bf16 activations)
// and the eight lanes of a quad (NT channels each) read distinct banks.
// Keep in step with tiling.py::tf32_b_pitch.
template <typename TA, typename TB, int BN>
__host__ __device__ constexpr int tf32_b_pitch() {
  int p = (BN * (int)sizeof(TB) + 15) / 16 * 16;
  while ((4 / (int)sizeof(TA)) * p % 64 != 32) p += 16;
  return p;
}

// Dynamic shared memory of one block: the A ring [ST][BM][KB + APAD]
// bytes and the B ring [ST][KB / sizeof(TA)][tf32_b_pitch] bytes, or the
// f32 C tile [BM][BN + 4] where that is larger (it takes the rings' place
// after the last stage), then the row table and the tap table.  Keep in
// step with tiling.py::step_byte_model.
template <typename TA, typename TB, class TL>
__host__ __device__ constexpr int tf32_ring_bytes() {
  const int ring =
      TL::ST * (TL::BM * (TL::KB + APAD) +
                TL::KB / (int)sizeof(TA) * tf32_b_pitch<TA, TB, TL::BN>());
  const int ctile = TL::BM * TL::CPITCH * 4;
  return ring > ctile ? ring : ctile;
}
template <typename TA, typename TB, class TL>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return tf32_ring_bytes<TA, TB, TL>() + 16 * TL::BM + 16 * MAX_TAPS;
}

// The products a k8 step runs per fragment: hi and lo of f32 activations,
// bf16 ones unsplit.
template <typename TA>
__host__ __device__ constexpr int tf32_passes() {
  return sizeof(TA) == 4 ? 2 : 1;
}

// v rounded to TF32 (nearest, ties away), as the mma operand's bits.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16 x 8 tf32, row) * b (8 x 8 tf32, col), f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16 x 8 tf32, row) * b (8 x 8 tf32, col), f32 sums from zero.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// N int8 values (2 or 4) of a staged B row in one read, each byte's sign
// bit flipped (q + 128), for flipped_s8.
template <int N>
__device__ __forceinline__ unsigned packed_row(const unsigned char* src) {
  const unsigned u = N == 4 ? *reinterpret_cast<const unsigned*>(src)
                            : *reinterpret_cast<const uint16_t*>(src);
  return u ^ 0x80808080u;
}

// Byte k of packed_row's word as the exact f32 of its int8 value (the
// byte as the low mantissa byte of 2^23, then 2^23 + 128 off).
__device__ __forceinline__ float flipped_s8(unsigned u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (unsigned)k)) -
         8388736.f;
}

// x is TA (f32 or bf16), w is TB (int8), the plain [taps * Cig, Co] slab
// the FMA route takes (the deconv's phase-major).  VEC: 16-byte
// copies of both operands, else one element a copy.  With partial !=
// nullptr the block stores its slice's raw f32 sums at partial[((slice *
// phases + p) * rows + m) * Co + c].
template <typename TA, typename TB, class TL, bool VEC, bool DECONV>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
igemm_tf32_kernel(const TA* __restrict__ x, const TB* __restrict__ w,
                  const int* __restrict__ taps, Epi ep,
                  void* __restrict__ y, int out_bf16,
                  float* __restrict__ partial, Geom g) {
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  constexpr int STAGES = TL::ST, MT = TL::MT, NT = TL::NT;
  constexpr int BK = TL::KB / sizeof(TA);         // pairs per stage
  constexpr int APB = TL::KB + APAD;              // bytes per staged A row
  constexpr int APITCH = APB / sizeof(TA);
  constexpr int BP = tf32_b_pitch<TA, TB, BN>();  // bytes per staged B row
  constexpr int VA = VEC ? 16 / sizeof(TA) : 1;   // A elements per copy
  constexpr int VB = VEC ? 16 / sizeof(TB) : 1;   // B elements per copy
  constexpr int B_CH = BN / VB;                   // copies per B row
  constexpr int B_COPIES = BK * B_CH;             // copies per B stage
  constexpr int A_UNROLL = VEC ? BM / (THREADS / (BK / VA)) : 4;
  // f32 activations: hi and lo, two products a k8 step; and a 32-byte
  // chunk of a staged A row (one ldmatrix.x4 per 16 rows) is one k8 step
  // of f32 or two of bf16
  constexpr bool SPLIT = tf32_passes<TA>() == 2;
  constexpr int CPITCH = TL::CPITCH;
  static_assert(sizeof(TA) == 4 || sizeof(TA) == 2, "f32 or bf16 A");
  static_assert(sizeof(TB) == 1, "int8 B (bf16 x bf16: the bf16 route)");
  static_assert(BN % VB == 0 && BP % 16 == 0, "B copies");

  extern __shared__ __align__(16) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);                // [ST][BM][APITCH]
  unsigned char* Bs = smem + STAGES * BM * APB;        // [ST][BK][BP] bytes
  int4* rowtab =
      reinterpret_cast<int4*>(smem + tf32_ring_bytes<TA, TB, TL>());
  int4* taptab = rowtab + BM;

  const int tid = threadIdx.x;
  const BlockPos b = block_pos<DECONV, BM, BN>(g, taps);
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int nst = b.ke > b.kb ? (b.ke - b.kb + BK - 1) / BK : 0;
  const int64_t co_base = (int64_t)b.grp * Cog;
  const int64_t w_row0 = (int64_t)b.tap0 * Cig;
  fill_tables<DECONV, BM, THREADS>(g, b, rowtab, taptab);   // (a barrier)
  AGather<TA, VA, BM, THREADS, BK, APITCH, A_UNROLL, DECONV> ga(g, b);

  auto copy_b = [&](unsigned char* bdst, int k0, int e) {
    const int k = e / B_CH, c = (e - k * B_CH) * VB;
    const int co = b.co0 + c;
    const bool ok = k0 + k < b.ke && co < Cog;
    const TB* src = ok ? w + (w_row0 + k0 + k) * g.Co + co_base + co : w;
    copy_async<VB * (int)sizeof(TB)>(bdst + k * BP + c * (int)sizeof(TB),
                                     src, ok);
  };
  auto load_stage = [&](int slot, int k0) {
    ga.load(As + slot * BM * APITCH, k0, x, g, b, rowtab, taptab);
    // B: BK rows x BN channels of the slab, at the padded pitch
    unsigned char* bdst = Bs + slot * BK * BP;
    if constexpr (VEC) {
#pragma unroll
      for (int e0 = 0; e0 < B_COPIES; e0 += THREADS)
        if (B_COPIES % THREADS == 0 || e0 + tid < B_COPIES)
          copy_b(bdst, k0, e0 + tid);
    } else {
      // an element a copy: four at a time (fully unrolled, the FMA
      // route's byte-wide copy loop spilled)
#pragma unroll 4
      for (int e0 = 0; e0 < B_COPIES; e0 += THREADS)
        if (B_COPIES % THREADS == 0 || e0 + tid < B_COPIES)
          copy_b(bdst, k0, e0 + tid);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, b.kb + s * BK);
    copy_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % TL::WM, wn = warp / TL::WM;
  const int gid = lane >> 2, tig = lane & 3;
  // this lane's ldmatrix row address in slot 0 (x4: rows 0-7 / 8-15 of a
  // fragment at bytes 0 / 16 of a 32-byte chunk): row lane % 16, byte
  // (lane / 16) * 16.  Its B reads: the NT channels wn * WTN + gid * NT
  // of rows tig and tig + 4 of each k8 step (f32 A), or 2 tig and 2 tig + 1
  // (bf16 A, whose a0 / a2 hold pairs 2 tig / 2 tig + 1)
  const unsigned a_lane =
      static_cast<unsigned>(__cvta_generic_to_shared(As)) +
      (wm * TL::WTM + (lane & 15)) * APB + (lane >> 4) * 16;
  constexpr int B_GAP = SPLIT ? 4 : 1;            // rows between b0, b1
  const unsigned char* b_lane = Bs + (SPLIT ? tig : 2 * tig) * BP +
                                (wn * TL::WTN + gid * NT) * (int)sizeof(TB);
  for (int st = 0; st < nst; ++st) {
    copy_wait<STAGES - 2>();   // stage st has landed (this thread's copies)
    __syncthreads();           // ... everyone's; slot st-1 is free again
    const int nxt = st + STAGES - 1;
    if (nxt < nst) load_stage(nxt % STAGES, b.kb + nxt * BK);
    copy_commit();
    const int slot = st % STAGES;
    const unsigned a_s = a_lane + slot * BM * APB;
    const unsigned char* b_s = b_lane + slot * BK * BP;
    if constexpr (SPLIT) {
      // f32 x int8, a k8 step a chunk: the NT weights of each of its B
      // rows stay packed (sign bits flipped) and are widened where used;
      // one chunk at a time (overlapping two spilled)
      static_assert(sizeof(TB) == 1 && (NT == 2 || NT == 4),
                    "int8 rows of 2 or 4 weights");
#pragma unroll 1
      for (int ch = 0; ch < TL::KB / 32; ++ch) {
        const unsigned raw0 = packed_row<NT>(b_s + ch * 8 * BP);
        const unsigned raw1 = packed_row<NT>(b_s + (ch * 8 + B_GAP) * BP);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4], op[2][4];
          ldmatrix_x4(a[0], a[1], a[2], a[3], a_s + i * 16 * APB + ch * 32);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            op[0][u] = tf32_rna(__uint_as_float(a[u]));
            op[1][u] = tf32_rna(__uint_as_float(a[u]) -
                                __uint_as_float(op[0][u]));
          }
          // hi then lo from zero, then added to the sums rounded to
          // nearest (the tensor cores' own sums truncate)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned w0 = __float_as_uint(flipped_s8(raw0, j));
            const unsigned w1 = __float_as_uint(flipped_s8(raw1, j));
            float t[4];
            mma_tf32_zero(t, op[0], w0, w1);
            mma_tf32(t, op[1], w0, w1);
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][j][u] += t[u];
          }
        }
      }
    } else {
#pragma unroll
      for (int ch = 0; ch < TL::KB / 32; ++ch) {
        // bf16 activations: the chunk's A fragments feed its two k8 steps
        unsigned af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(af[i][0], af[i][1], af[i][2], af[i][3],
                      a_s + i * 16 * APB + ch * 32);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int k8 = (ch * 2 + s) * 8;        // the step's first pair
          float bv0[NT], bv1[NT];
          load_row<TB, NT>(bv0, reinterpret_cast<const TB*>(b_s + k8 * BP));
          load_row<TB, NT>(bv1, reinterpret_cast<const TB*>(
                                    b_s + (k8 + B_GAP) * BP));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            // rows gid / gid + 8; pairs 2 tig (low half), 2 tig + 1
            const unsigned r0 = af[i][2 * s], r1 = af[i][2 * s + 1];
            const unsigned op[4] = {r0 << 16, r1 << 16, r0 & 0xffff0000u,
                                    r1 & 0xffff0000u};
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_tf32(acc[i][j], op, __float_as_uint(bv0[j]),
                       __float_as_uint(bv1[j]));
          }
        }
      }
    }
  }
  copy_wait<0>();

  // the f32 tile through shared memory (the rings are free once every
  // warp is past its last stage): fragment (i, j) holds rows lane / 4 (+ 8)
  // of the warp's i-th 16 and fragment columns n = 2 * (lane % 4) + {0, 1},
  // which are the warp's channels n * NT + j
  float* ctile = reinterpret_cast<float*>(smem);  // [BM][CPITCH]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = ctile + (wm * TL::WTM + i * 16 + gid + h * 8) * CPITCH +
                     wn * TL::WTN + (2 * tig + e) * NT;
#pragma unroll
        for (int j = 0; j < NT; ++j) dst[j] = acc[i][j][2 * h + e];
      }
  __syncthreads();
  store_tile<float, TL, DECONV>(ctile, g, b, ep, y, out_bf16, partial);
}

// -- the bf16 route: bf16 x bf16 on the bf16 tensor cores --------------------

// The bf16 route's tiles: the TF32 route's rows, warps, stages and
// residency, 64 bytes (32 pairs) of each row a stage.  128 bytes a stage
// (two stages) timed 3-15 % faster on V-Net's merge layers but 1.8-2.5x
// slower on its shallow scalar-copy layers (enc1, head), 31 % slower over
// the V-Net batch (scripts/bf16_levers.py, PERF.md).
using Bf16Tile16 = MmaTile<256, 16, 8, 1, 2, 3, 64>;
using Bf16Tile32 = MmaTile<256, 32, 8, 1, 2, 2, 64>;
using Bf16Tile64 = MmaTile<128, 64, 4, 2, 4, 2, 64>;
using Bf16Tile128 = MmaTile<128, 128, 4, 4, 4, 1, 64>;
// A's 16-byte copies allocate in L1 (.ca): neighbouring rows' taps re-read
// the same input; on V-Net merge4 1.53 against 1.86 ms for .cg, the
// batch 9 % faster
constexpr bool BF16_A_L1 = true;
// the bf16 route's copy argument (the C entries' copy): a bit per operand
// that takes 16-byte copies (8 channels), each on its own
constexpr int BF16_COPY_A16 = 1, BF16_COPY_B16 = 2;

// The bytes between two staged B rows of BN bf16 weights: 2 BN + 16, an
// odd multiple of 16 (BN is a multiple of 16), so that the eight rows an
// ldmatrix.trans matrix reads start in eight distinct 16-byte bank
// groups.  Keep in step with tiling.py::bf16_b_pitch.
template <int BN>
__host__ __device__ constexpr int bf16_b_pitch() {
  static_assert(BN % 16 == 0, "whole k16 x n16 ldmatrix.x4.trans reads");
  return 2 * BN + 16;
}

// Dynamic shared memory of one block: the A ring [ST][BM][KB + APAD]
// bytes and the B ring [ST][KB / 2][bf16_b_pitch] bytes, or the f32 C
// tile [BM][BN + 4] where that is larger (it takes the rings' place after
// the last stage), then the row table and the tap table.  Keep in step
// with tiling.py::step_byte_model.
template <class TL>
__host__ __device__ constexpr int bf16_ring_bytes() {
  const int ring = TL::ST * (TL::BM * (TL::KB + APAD) +
                             TL::KB / 2 * bf16_b_pitch<TL::BN>());
  const int ctile = TL::BM * TL::CPITCH * 4;
  return ring > ctile ? ring : ctile;
}
template <class TL>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return bf16_ring_bytes<TL>() + 16 * TL::BM + 16 * MAX_TAPS;
}

// Four 8 x 16-byte matrices from shared memory, each transposed: lanes
// 8q..8q+7 give the row addresses of matrix q, and each lane receives the
// 2-byte elements (row 2 (lane % 4), column lane / 4) and (row 2 (lane %
// 4) + 1, column lane / 4) of each matrix, the first in the low half.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned& r0, unsigned& r1,
                                                  unsigned& r2, unsigned& r3,
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x and w are bf16, w the plain [taps * Cig, Co] slab the FMA route takes
// (the deconv's phase-major).  VA16 / VB16: 16-byte copies (8 channels)
// of A / of B, each operand on its own, else one element a copy.  With
// partial != nullptr the block stores its slice's raw f32 sums at
// partial[((slice * phases + p) * rows + m) * Co + c].
template <class TL, bool VA16, bool VB16, bool DECONV>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
igemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const int* __restrict__ taps, Epi ep,
                  void* __restrict__ y, int out_bf16,
                  float* __restrict__ partial, Geom g) {
  using T = __nv_bfloat16;
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  constexpr int STAGES = TL::ST, MT = TL::MT, NT = TL::NT;
  constexpr int BK = TL::KB / 2;                  // pairs per stage
  constexpr int APB = TL::KB + APAD;              // bytes per staged A row
  constexpr int APITCH = APB / 2;
  constexpr int BP = bf16_b_pitch<BN>();          // bytes per staged B row
  constexpr int VA = VA16 ? 8 : 1;                // A elements per copy
  constexpr int VB = VB16 ? 8 : 1;                // B elements per copy
  constexpr int B_CH = BN / VB;                   // copies per B row
  constexpr int B_COPIES = BK * B_CH;             // copies per B stage
  constexpr int A_UNROLL = VA16 ? BM / (THREADS / (BK / VA)) : 4;
  static_assert(BK % 16 == 0 && NT % 2 == 0, "whole k16 steps, n8 pairs");

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);                  // [ST][BM][APITCH]
  unsigned char* Bs = smem + STAGES * BM * APB;        // [ST][BK][BP] bytes
  int4* rowtab = reinterpret_cast<int4*>(smem + bf16_ring_bytes<TL>());
  int4* taptab = rowtab + BM;

  const int tid = threadIdx.x;
  const BlockPos b = block_pos<DECONV, BM, BN>(g, taps);
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int nst = b.ke > b.kb ? (b.ke - b.kb + BK - 1) / BK : 0;
  const int64_t co_base = (int64_t)b.grp * Cog;
  const int64_t w_row0 = (int64_t)b.tap0 * Cig;
  fill_tables<DECONV, BM, THREADS>(g, b, rowtab, taptab);   // (a barrier)
  AGather<T, VA, BM, THREADS, BK, APITCH, A_UNROLL, DECONV, BF16_A_L1> ga(
      g, b);

  auto copy_b = [&](unsigned char* bdst, int k0, int e) {
    const int k = e / B_CH, c = (e - k * B_CH) * VB;
    const int co = b.co0 + c;
    const bool ok = k0 + k < b.ke && co < Cog;
    const T* src = ok ? w + (w_row0 + k0 + k) * g.Co + co_base + co : w;
    copy_async<VB * 2>(bdst + k * BP + c * 2, src, ok);
  };
  auto load_stage = [&](int slot, int k0) {
    ga.load(As + slot * BM * APITCH, k0, x, g, b, rowtab, taptab);
    // B: BK rows x BN channels of the slab, at the padded pitch
    unsigned char* bdst = Bs + slot * BK * BP;
    if constexpr (VB16) {
#pragma unroll
      for (int e0 = 0; e0 < B_COPIES; e0 += THREADS)
        if (B_COPIES % THREADS == 0 || e0 + tid < B_COPIES)
          copy_b(bdst, k0, e0 + tid);
    } else {
#pragma unroll 4
      for (int e0 = 0; e0 < B_COPIES; e0 += THREADS)
        if (B_COPIES % THREADS == 0 || e0 + tid < B_COPIES)
          copy_b(bdst, k0, e0 + tid);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, b.kb + s * BK);
    copy_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % TL::WM, wn = warp / TL::WM;
  // this lane's ldmatrix row address in slot 0.  A (x4: rows 0-7 / 8-15
  // of a fragment at k 0 / 8): row lane % 16, byte (lane / 16) * 16 of a
  // 32-byte chunk, which is the m16n8k16 A fragment as it stands.  B (x4,
  // transposed: fragments j, j + 1 at k 0-7 / 8-15): pair row lane % 16,
  // channels wn * WTN + (lane / 16) * 8 ..
  const unsigned a_lane =
      static_cast<unsigned>(__cvta_generic_to_shared(As)) +
      (wm * TL::WTM + (lane & 15)) * APB + (lane >> 4) * 16;
  const unsigned b_lane =
      static_cast<unsigned>(__cvta_generic_to_shared(Bs)) +
      (lane & 15) * BP + (wn * TL::WTN + (lane >> 4) * 8) * 2;
  for (int st = 0; st < nst; ++st) {
    copy_wait<STAGES - 2>();   // stage st has landed (this thread's copies)
    __syncthreads();           // ... everyone's; slot st-1 is free again
    const int nxt = st + STAGES - 1;
    if (nxt < nst) load_stage(nxt % STAGES, b.kb + nxt * BK);
    copy_commit();
    const int slot = st % STAGES;
    const unsigned a_s = a_lane + slot * BM * APB;
    const unsigned b_s = b_lane + slot * BK * BP;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2)
        ldmatrix_x4_trans(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1],
                          b_s + ks * 16 * BP + j * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        ldmatrix_x4(af[0], af[1], af[2], af[3],
                    a_s + i * 16 * APB + ks * 32);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  copy_wait<0>();

  // the f32 tile through shared memory (the rings are free once every
  // warp is past its last stage): fragment (i, j) holds rows lane / 4 (+ 8)
  // of the warp's i-th 16 and channels 2 * (lane % 4) + {0, 1} of its j-th 8
  constexpr int CPITCH = TL::CPITCH;
  float* ctile = reinterpret_cast<float*>(smem);  // [BM][CPITCH]
  __syncthreads();
  {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              ctile + (wm * TL::WTM + i * 16 + gid + h * 8) * CPITCH +
              wn * TL::WTN + j * 8 + tig * 2) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  __syncthreads();
  store_tile<float, TL, DECONV>(ctile, g, b, ep, y, out_bf16, partial);
}

// -- the bf16 route's halo staging -------------------------------------------
//
// A block owns a box of the position grid (bd x bh x bw positions of one
// batch item, at most BM; its tile's rows are the box's positions, w
// fastest) and runs the reduction chunk-major: for each chunk of 8 input
// channels, one stage holds the box's whole input footprint at those
// channels (each input element copied once, zero outside the input) and
// every tap's 8 rows of B; then the taps' k16 steps, two taps a step (an
// ldmatrix.x4 takes each 8 x 16-byte matrix's row addresses apart: lanes
// 0-15 read the first tap's slots, lanes 16-31 the second's; a missing
// last tap reads the zero slot beside zero B rows), read A straight from
// the footprint.  Along each dim, footprint slot p stands for input
// coordinate org + step * (p / e + s * (p % e)): the conv's input at
// stride S and dilation dil, step = gcd(S, dil), lies in s = S / step
// residue classes of e slots each, one class after another, so that a
// tap's reads of consecutive rows are consecutive slots (the deconv's
// taps read x[q - m]: s = 1, org = q0 - the phase's largest m).  A row's
// slot is pos(r) = (rd * lh + rh) * lw + rw, a tap's offset off(t) the
// same sum of its per-dim offsets, and the lane's ldmatrix address
// (pos(r) + off(t)) * HALO_PITCH: the planner pads lh and lw so that
// every aligned eight rows' slots differ mod 8, and a slot is 16 bytes,
// so each 8 x 16-byte matrix reads eight distinct bank groups whatever
// the tap.  Two chunks are in flight.  8 channels a chunk timed faster
// than 16 (more blocks an SM, shorter stages) on V-Net merge2-4, and more
// stages than two no faster (PERF.md).

constexpr int HALO_STAGES = 2;      // chunks in flight
constexpr int HALO_CHANNELS = 8;    // input channels a stage holds
constexpr int HALO_PITCH = 16;      // bytes a staged slot (8 bf16)
constexpr int HALO_SLOT_ZERO = -1;  // a slot outside the input: zero-filled
constexpr int HALO_SLOT_NONE = -2;  // a pad slot no row reads: not copied

// One stage: slots footprint slots of A, then steps x 16 rows of B at
// bf16_b_pitch; a block holds HALO_STAGES of them (or the f32 C tile
// where that is larger: it takes the stages' place after the last chunk),
// then its row table (each row's output offset), slot table (each slot's
// input position, or HALO_SLOT_*) and tap table (each tap's slot
// offset).  Keep in step with tiling.py::halo_smem_bytes.
template <class TL>
__host__ __device__ constexpr int halo_stage_bytes(int slots, int steps) {
  return slots * HALO_PITCH + steps * 16 * bf16_b_pitch<TL::BN>();
}
template <class TL>
__host__ __device__ constexpr int halo_smem_bytes(int slots, int steps) {
  const int ring = HALO_STAGES * halo_stage_bytes<TL>(slots, steps);
  const int ctile = TL::BM * TL::CPITCH * 4;
  return (ring > ctile ? ring : ctile) + 4 * slots + 4 * MAX_TAPS +
         8 * TL::BM;
}

// One dim of a block's footprint (above): slot p is input coordinate org
// + step * f, f = p / e + s * (p % e), when p / e < s and f < f_end.
struct HaloDim {
  int org, step, s, e, f_end, dil;   // dil: the conv's dilation / step
  // slot p's input coordinate, HALO_SLOT_ZERO outside [0, extent) or
  // HALO_SLOT_NONE for a slot no row reads
  __device__ __forceinline__ int coord(int p, int extent) const {
    const int rho = p / e;
    const int f = rho + s * (p - rho * e);
    const int c = org + step * f;
    if (rho >= s || f >= f_end) return HALO_SLOT_NONE;
    return (unsigned)c < (unsigned)extent ? c : HALO_SLOT_ZERO;
  }
  // the conv's kernel element k: its slot offset
  __device__ __forceinline__ int conv_off(int k) const {
    const int kk = k * dil;
    return (kk % s) * e + kk / s;
  }
};

// The conv's dim: output box [o0, o0 + bx), kernel K, stride S, dilation
// dil, pad lo.
__device__ __forceinline__ HaloDim conv_dim(int o0, int bx, int K, int S,
                                            int dil, int lo) {
  int a = S, c = dil;
  while (c) {
    const int t = a % c;
    a = c;
    c = t;
  }
  HaloDim d;
  d.step = a;
  d.s = S / a;
  d.dil = dil / a;
  d.f_end = (bx - 1) * d.s + (K - 1) * d.dil + 1;
  d.e = (d.f_end + d.s - 1) / d.s;
  d.org = o0 * S - lo;
  return d;
}

// The deconv's dim: phase box [q0, q0 + bx), the phase's taps m in [mlo,
// mhi]; a tap's slot offset is mhi - m.
__device__ __forceinline__ HaloDim deconv_dim(int q0, int bx, int mlo,
                                              int mhi) {
  HaloDim d;
  d.step = d.s = d.dil = 1;
  d.f_end = d.e = bx + mhi - mlo;
  d.org = q0 - mhi;
  return d;
}

// The finished BM x BN tile of f32 sums in shared memory, ctile[r *
// CPITCH + c], after a barrier, stored as store_tile stores one slice's
// (four channels of a row a thread, the epilogue, one store of four
// where aligned), each row at its output offset rowoff[r] (< 0: not
// stored).
template <class TL>
__device__ __forceinline__ void store_box_tile(const float* ctile,
                                               const int64_t* rowoff,
                                               const Geom& g,
                                               const BoxPos& b, const Epi& ep,
                                               void* y, int out_bf16) {
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  const int Cog = g.Co / g.G;
  const int64_t co_base = (int64_t)b.grp * Cog;
  const bool vec_out =
      g.Co % 4 == 0 && Cog % 4 == 0 &&
      reinterpret_cast<uintptr_t>(y) % (out_bf16 ? 8 : 16) == 0;
#pragma unroll 1
  for (int e = threadIdx.x; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4), c = b.co0 + (e - r * (BN / 4)) * 4;
    const int64_t row = rowoff[r];
    if (row < 0 || c >= Cog) continue;
    const float4 s4 =
        *reinterpret_cast<const float4*>(ctile + r * TL::CPITCH + c - b.co0);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const int64_t out = row + co_base + c;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)         // (scale/bias hold Co values)
      v[u] = c + u < Cog ? epilogue(sv[u], ep, (int)co_base + c + u) : 0.f;
    if (vec_out && c + 3 < Cog) {
      if (out_bf16) {         // four bf16 in one 8-byte store
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<unsigned*>(&lo);
        pk.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + out) = pk;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(y) + out) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < Cog) store_out(y, out_bf16, out + u, v[u]);
    }
  }
}

// x and w as igemm_bf16_kernel takes them, Cin/G a multiple of 8 (A's
// copies are 16 bytes); VB16: 16-byte copies of B.  One slice (unsplit),
// so the epilogue and the store follow the last chunk.
template <class TL, bool VB16, bool DECONV>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
igemm_bf16_halo_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ taps, Epi ep,
                       void* __restrict__ y, int out_bf16, Geom g, Halo h) {
  using T = __nv_bfloat16;
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  constexpr int MT = TL::MT, NT = TL::NT, CC = HALO_CHANNELS;
  constexpr int BP = bf16_b_pitch<BN>();          // bytes per staged B row
  constexpr int VB = VB16 ? 8 : 1;                // B elements per copy
  constexpr int B_CH = BN / VB;                   // copies per B row
  static_assert(NT % 2 == 0, "n8 pairs");

  extern __shared__ __align__(16) unsigned char smem[];
  const int stage = halo_stage_bytes<TL>(h.slots, h.steps);
  const int ring = HALO_STAGES * stage > BM * TL::CPITCH * 4
                       ? HALO_STAGES * stage
                       : BM * TL::CPITCH * 4;
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem + ring);  // [BM]
  int* slotpos = reinterpret_cast<int*>(rowoff + BM);          // [slots]
  int* tapoff = slotpos + h.slots;                             // [MAX_TAPS]
  // the footprint's per-dim coordinates, in stage 1 until chunk 1 loads
  const int planes = (h.slots - 1) / (h.lh * h.lw);
  int* dimpos = reinterpret_cast<int*>(smem + stage);  // [planes + lh + lw]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const BoxPos b = box_pos<DECONV, BN>(g, taps, h);
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int64_t co_base = (int64_t)b.grp * Cog;
  const int64_t w_row0 = (int64_t)b.tap0 * Cig;
  const int64_t ci_base = (int64_t)b.grp * Cig;
  const int steps = (b.ntaps * CC + 15) / 16;     // two taps a k16 step
  const int chunks = b.ntaps > 0 ? Cig / CC : 0;

  // B's rows of a chunk: every tap's 8 channels (a missing last tap's
  // zero); chunk 0's go out before the tables are built
  auto load_b = [&](int s, int chunk) {
    unsigned char* b_dst = smem + s * stage + h.slots * HALO_PITCH;
    const int copies = steps * 16 * B_CH;
#pragma unroll 4
    for (int e = tid; e < copies; e += THREADS) {
      const int k = e / B_CH, c = (e - k * B_CH) * VB;
      const int t = k / CC, ci = k - t * CC;
      const int co = b.co0 + c;
      const bool ok = t < b.ntaps && co < Cog;
      const T* src =
          ok ? w + (w_row0 + (int64_t)t * Cig + chunk * CC + ci) * g.Co +
                   co_base + co
             : w;
      copy_async<VB * 2>(b_dst + k * BP + c * 2, src, ok);
    }
  };
  // A's slots of a chunk: each once, 8 channels in one 16-byte copy
  auto load_a = [&](int s, int chunk) {
    unsigned char* a_dst = smem + s * stage;
    const int64_t coff = ci_base + chunk * CC;
    for (int i = tid; i < h.slots; i += THREADS) {
      const int pos = slotpos[i];
      if (pos == HALO_SLOT_NONE) continue;
      copy_async<16, BF16_A_L1>(
          a_dst + i * HALO_PITCH,
          pos >= 0 ? x + (int64_t)pos * g.Ci + coff : x, pos >= 0);
    }
  };
  if (chunks > 0) load_b(0, 0);

  // the footprint's dims
  HaloDim dd, dh, dw;
  int mhi[3] = {0, 0, 0};
  if (DECONV) {
    int mlo[3] = {1 << 29, 1 << 29, 1 << 29};
    for (int t = 0; t < b.ntaps; ++t)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int m = b.tapm[3 * (b.tap0 + t) + j];
        mlo[j] = min(mlo[j], m);
        mhi[j] = max(mhi[j], m);
      }
    if (b.ntaps == 0) mlo[0] = mlo[1] = mlo[2] = 0;
    dd = deconv_dim(b.od0, h.bd, mlo[0], mhi[0]);
    dh = deconv_dim(b.oh0, h.bh, mlo[1], mhi[1]);
    dw = deconv_dim(b.ow0, h.bw, mlo[2], mhi[2]);
  } else {
    dd = conv_dim(b.od0, h.bd, g.Kd, g.Sd, g.dd, g.lod);
    dh = conv_dim(b.oh0, h.bh, g.Kh, g.Sh, g.dh, g.loh);
    dw = conv_dim(b.ow0, h.bw, g.Kw, g.Sw, g.dw, g.low);
  }
  // each dim's coordinates, each tap's slot offset, each row's output
  // offset (row r = (rd * bh + rh) * bw + rw of the box)
  for (int k = tid; k < planes + h.lh + h.lw; k += THREADS)
    dimpos[k] = k < planes ? dd.coord(k, g.D)
                : k < planes + h.lh ? dh.coord(k - planes, g.H)
                                    : dw.coord(k - planes - h.lh, g.W);
  for (int t = tid; t < b.ntaps; t += THREADS) {
    int od, oh, ow;
    if (DECONV) {
      const int* mm = b.tapm + 3 * (b.tap0 + t);
      od = mhi[0] - mm[0]; oh = mhi[1] - mm[1]; ow = mhi[2] - mm[2];
    } else {
      const int kw = t % g.Kw, kh = (t / g.Kw) % g.Kh, kd = t / (g.Kw * g.Kh);
      od = dd.conv_off(kd); oh = dh.conv_off(kh); ow = dw.conv_off(kw);
    }
    tapoff[t] = (od * h.lh + oh) * h.lw + ow;
  }
  const int box_rows = h.bd * h.bh * h.bw;
  for (int r = tid; r < BM; r += THREADS) {
    const int rw = r % h.bw, rh = (r / h.bw) % h.bh, rd = r / (h.bw * h.bh);
    int od = b.od0 + rd, oh = b.oh0 + rh, ow = b.ow0 + rw;
    bool ok = r < box_rows && od < g.Pd && oh < g.Ph && ow < g.Pw;
    if (DECONV) {
      od = od * g.Sd + b.pd - g.lod;
      oh = oh * g.Sh + b.ph - g.loh;
      ow = ow * g.Sw + b.pw - g.low;
      ok = ok && (unsigned)od < (unsigned)g.Od &&
           (unsigned)oh < (unsigned)g.Oh && (unsigned)ow < (unsigned)g.Ow;
    }
    rowoff[r] = ok ? ((((int64_t)b.n * g.Od + od) * g.Oh + oh) * g.Ow + ow) *
                         g.Co
                   : -1;
  }
  __syncthreads();
  // each slot's input position (every chunk copies the same slots), the
  // last slot zero: a thread's slots tid, tid + THREADS, ... stepped
  // through (plane, line, column) without a division each
  {
    const int plane = h.lh * h.lw;
    int pd = tid / plane, ph = (tid % plane) / h.lw, pw = tid % h.lw;
    const int sd = THREADS / plane, sh = (THREADS % plane) / h.lw,
              sw = THREADS % h.lw;
    for (int i = tid; i < h.slots; i += THREADS) {
      int v = HALO_SLOT_ZERO;
      if (i < h.slots - 1) {
        const int cd = dimpos[pd], ch = dimpos[planes + ph],
                  cw = dimpos[planes + h.lh + pw];
        if (cd == HALO_SLOT_NONE || ch == HALO_SLOT_NONE ||
            cw == HALO_SLOT_NONE)
          v = HALO_SLOT_NONE;
        else if (cd >= 0 && ch >= 0 && cw >= 0)
          v = ((b.n * g.D + cd) * g.H + ch) * g.W + cw;
      }
      slotpos[i] = v;
      pw += sw;
      if (pw >= h.lw) { pw -= h.lw; ++ph; }
      ph += sh;
      if (ph >= h.lh) { ph -= h.lh; ++pd; }
      pd += sd;
    }
  }
  __syncthreads();
  if (chunks > 0) load_a(0, 0);
  copy_commit();

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

  const int wm = warp % TL::WM, wn = warp / TL::WM;
  // this lane's A rows: row r = wm * WTM + i * 16 + lane % 16 of the box
  // at slot pos(r) (rows past the box read slot 0; their sums are not
  // stored); lanes 16-31 read the step's second tap (matrices 2-3, its k
  // 8-15)
  int rslot[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wm * TL::WTM + i * 16 + (lane & 15);
    const int rw = r % h.bw, rh = (r / h.bw) % h.bh, rd = r / (h.bw * h.bh);
    rslot[i] = r < box_rows ? (rd * h.lh + rh) * h.lw + rw : 0;
  }
  const unsigned s_base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned zero_slot = s_base + (h.slots - 1) * HALO_PITCH;
  const unsigned b_lane = s_base + h.slots * HALO_PITCH + (lane & 15) * BP +
                          (wn * TL::WTN + (lane >> 4) * 8) * 2;
  const int half = lane >> 4;
  for (int ch = 0; ch < chunks; ++ch) {
    copy_wait<0>();            // chunk ch has landed (this thread's copies)
    __syncthreads();           // ... everyone's; the other stage is free
    if (ch + 1 < chunks) {
      load_b((ch + 1) % HALO_STAGES, ch + 1);
      load_a((ch + 1) % HALO_STAGES, ch + 1);
    }
    copy_commit();
    const unsigned st = (ch % HALO_STAGES) * stage;
#pragma unroll 2
    for (int ks = 0; ks < steps; ++ks) {
      unsigned bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2)
        ldmatrix_x4_trans(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1],
                          b_lane + st + ks * 16 * BP + j * 16);
      const int t = 2 * ks + half;
      const bool real = t < b.ntaps;
      const int off = real ? tapoff[t] : 0;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        ldmatrix_x4(af[0], af[1], af[2], af[3],
                    real ? s_base + st + (rslot[i] + off) * HALO_PITCH
                         : zero_slot + st);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  copy_wait<0>();

  // the f32 tile through shared memory, as igemm_bf16_kernel's
  constexpr int CPITCH = TL::CPITCH;
  float* ctile = reinterpret_cast<float*>(smem);  // [BM][CPITCH]
  __syncthreads();
  {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              ctile + (wm * TL::WTM + i * 16 + gid + hh * 8) * CPITCH +
              wn * TL::WTN + j * 8 + tig * 2) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
  }
  __syncthreads();
  store_box_tile<TL>(ctile, rowoff, g, b, ep, y, out_bf16);
}

// -- the int8 x int8 route: s8 tensor cores ----------------------------------

constexpr int BPAD = 16;         // pad after each staged K-major B row

// Dynamic shared memory of one block: the A ring [ST][BM][KB + APAD], the
// K-major B ring [ST][BN][KB + BPAD], the row table and the tap table.
// Keep in step with tiling.py::step_byte_model.
template <class TL>
constexpr int s8_smem_bytes() {
  return TL::ST * (TL::BM * (TL::KB + APAD) + TL::BN * (TL::KB + BPAD)) +
         16 * TL::BM + 16 * MAX_TAPS;
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w is K-major: [phases][G][Cog][kp] int8, kp the deepest phase's pairs
// rounded up to 16, each row zero past its phase's pairs.  VA: A's bytes
// per copy (16, 4 or 1).  With partial != nullptr the block stores its
// slice's s32 sums at partial[((slice * phases + p) * rows + m) * Co + c].
template <class TL, int VA, bool DECONV>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
igemm_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const int* __restrict__ taps, Epi ep, void* __restrict__ y,
                int out_bf16, int* __restrict__ partial, Geom g) {
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  constexpr int STAGES = TL::ST, BK = TL::KB;
  constexpr int APITCH = TL::KB + APAD, BPITCH = TL::KB + BPAD;
  constexpr int MT = TL::MT, NT = TL::NT;
  constexpr int B_CH = BK / 16;                   // 16-byte copies per row
  constexpr int B_COPIES = BN * B_CH;
  constexpr int A_UNROLL = VA > 1 ? BM / (THREADS / (BK / VA)) : 4;
  static_assert(BK == 64, "two k32 steps a stage");

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);        // [ST][BM][APITCH]
  int8_t* Bs = As + STAGES * BM * APITCH;              // [ST][BN][BPITCH]
  int4* rowtab = reinterpret_cast<int4*>(Bs + STAGES * BN * BPITCH);
  int4* taptab = rowtab + BM;

  const int tid = threadIdx.x;
  const BlockPos b = block_pos<DECONV, BM, BN>(g, taps);
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int phases = DECONV ? g.Sd * g.Sh * g.Sw : 1;
  const int nst = b.ke > b.kb ? (b.ke - b.kb + BK - 1) / BK : 0;
  int deepest = b.ntaps;
  if (DECONV)
    for (int q = 0; q < phases; ++q) deepest = max(deepest, taps[2 * q + 1]);
  const int64_t kp = ((int64_t)deepest * Cig + 15) / 16 * 16;
  const int8_t* wblk = w + ((int64_t)b.p * g.G + b.grp) * Cog * kp;
  fill_tables<DECONV, BM, THREADS>(g, b, rowtab, taptab);
  AGather<int8_t, VA, BM, THREADS, BK, APITCH, A_UNROLL, DECONV, true> ga(g,
                                                                       b);

  auto load_stage = [&](int slot, int k0) {
    ga.load(As + slot * BM * APITCH, k0, x, g, b, rowtab, taptab);
    // B: BN K-major rows of 64 pairs; a 16-byte chunk starting at or past
    // ke is not read (the rest of a row's last chunk is its zero pad)
    int8_t* bdst = Bs + slot * BN * BPITCH;
#pragma unroll
    for (int e0 = 0; e0 < B_COPIES; e0 += THREADS) {
      const int e = e0 + tid;
      if (B_COPIES % THREADS == 0 || e < B_COPIES) {
        const int n = e / B_CH, c = (e - n * B_CH) * 16;
        const int co = b.co0 + n;
        const bool ok = co < Cog && k0 + c < b.ke;
        const int8_t* src = ok ? wblk + co * kp + k0 + c : w;
        copy_async<16>(bdst + n * BPITCH + c, src, ok);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, b.kb + s * BK);
    copy_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % TL::WM, wn = warp / TL::WM;
  // this lane's ldmatrix row address in slot 0.  A (x4: rows 0-7 / 8-15
  // of a fragment at k 0 / 16): row lane % 16, k (lane / 16) * 16.  B (x4:
  // fragments j, j + 1 at k 0 / 16): channel lane % 8 + (lane / 16) * 8, k
  // ((lane / 8) % 2) * 16
  const unsigned a_lane =
      static_cast<unsigned>(__cvta_generic_to_shared(As)) +
      (wm * TL::WTM + (lane & 15)) * APITCH + (lane >> 4) * 16;
  const unsigned b_lane =
      static_cast<unsigned>(__cvta_generic_to_shared(Bs)) +
      (wn * TL::WTN + (lane & 7) + ((lane >> 4) << 3)) * BPITCH +
      ((lane >> 3) & 1) * 16;
  for (int st = 0; st < nst; ++st) {
    copy_wait<STAGES - 2>();   // stage st has landed (this thread's copies)
    __syncthreads();           // ... everyone's; slot st-1 is free again
    const int nxt = st + STAGES - 1;
    if (nxt < nst) load_stage(nxt % STAGES, b.kb + nxt * BK);
    copy_commit();
    const int slot = st % STAGES;
    const unsigned a_s = a_lane + slot * BM * APITCH;
    const unsigned b_s = b_lane + slot * BN * BPITCH;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2)
        ldmatrix_x4(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1],
                    b_s + j * 8 * BPITCH + ks * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        ldmatrix_x4(af[0], af[1], af[2], af[3],
                    a_s + i * 16 * APITCH + ks * 32);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  copy_wait<0>();

  // the s32 tile through shared memory (the rings are free once every warp
  // is past its last stage): fragment (i, j) holds rows lane / 4 (+ 8) of
  // the warp's i-th 16 and channels 2 * (lane % 4) + {0, 1} of its j-th 8
  constexpr int CPITCH = TL::CPITCH;              // s32 per staged row
  static_assert(BM * CPITCH * 4 <= STAGES * (BM * APITCH + BN * BPITCH),
                "C fits the rings");
  int* ctile = reinterpret_cast<int*>(smem);      // [BM][CPITCH]
  __syncthreads();
  {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(
              ctile + (wm * TL::WTM + i * 16 + gid + h * 8) * CPITCH +
              wn * TL::WTN + j * 8 + tig * 2) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  __syncthreads();
  store_tile<int, TL, DECONV>(ctile, g, b, ep, y, out_bf16, partial);
}

// -- launches ----------------------------------------------------------------

constexpr int MAX_DEVICES = 64;
// the most dynamic shared memory an sm_90 block may use (227 KB): the
// halo kernels' limit, set once, since their stages' size is the launch's
constexpr int HALO_SMEM_MAX = 232448;

// Raise a kernel's dynamic shared-memory limit once per device (the call
// costs more host time than a small layer's whole launch); set holds the
// devices done, one array per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool (&set)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) set[dev] = true;
  return err;
}

// After a split launch's main pass: the slices' sum, epilogue and store.
template <typename TP, bool DECONV>
cudaError_t launch_reduce(const TP* work, const Epi& ep, void* y,
                          int out_bf16, const Geom& g, cudaStream_t stream) {
  const int rows = g.N * g.Pd * g.Ph * g.Pw;
  const int phases = DECONV ? g.Sd * g.Sh * g.Sw : 1;
  const int64_t n = (int64_t)phases * rows * g.Co;
  igemm_reduce<TP, DECONV><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      work, ep, y, out_bf16, g);
  return cudaGetLastError();
}

inline dim3 grid_of(const Geom& g, int BM, int BN, bool deconv) {
  const int rows = g.N * g.Pd * g.Ph * g.Pw;
  const int phases = deconv ? g.Sd * g.Sh * g.Sw : 1;
  const int Cog = g.Co / g.G;
  return dim3((rows + BM - 1) / BM, g.G * ((Cog + BN - 1) / BN),
              phases * g.splits);
}

// A halo-staged launch's grid: x counts the boxes (box_pos), one slice.
inline dim3 grid_of(const Geom& g, const Halo& h, int BN, bool deconv) {
  const int phases = deconv ? g.Sd * g.Sh * g.Sw : 1;
  const int Cog = g.Co / g.G;
  const int boxes = g.N * ((g.Pd + h.bd - 1) / h.bd) *
                    ((g.Ph + h.bh - 1) / h.bh) * ((g.Pw + h.bw - 1) / h.bw);
  return dim3(boxes, g.G * ((Cog + BN - 1) / BN), phases);
}

// The kernel a C call launched, as its launched[3] out-parameter reports
// it: launched[0] is the kernel's route, launched[1] the products a k8
// step runs per fragment (the TF32 route's passes, else 1), launched[2]
// how it staged A (Staging).
enum Launched {
  LAUNCHED_FMA = 0,    // igemm_kernel
  LAUNCHED_TF32 = 1,   // igemm_tf32_kernel
  LAUNCHED_S8 = 2,     // igemm_s8_kernel
  LAUNCHED_BF16 = 3,   // igemm_bf16_kernel, igemm_bf16_halo_kernel
};
enum Staging {
  STAGING_GATHER = 0,  // A gathered per (row, tap) into the ring
  STAGING_HALO = 1,    // each box's footprint once a chunk
};

// One forward launch's arguments, as the C entry points receive them.
struct FwdArgs {
  const void* x;
  const void* w;
  const int* taps;
  Epi ep;
  void* y;
  int out_bf16;
  float* work;
  Geom g;
  int block_co;
  int copy;         // the C entry's copy argument (variant_part)
  const Halo* halo; // the halo staging the planner chose, or null
  int* launched;    // [3], or null
  cudaStream_t stream;
};

// Record in a.launched what was launched; then, for a split launch, the
// slices' sum (TP: the workspace's f32 or s32 sums).
template <typename TP, bool DECONV>
cudaError_t finish(const FwdArgs& a, TP* work, int kernel, int passes,
                   int staging = STAGING_GATHER) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.launched) {
    a.launched[0] = kernel;
    a.launched[1] = passes;
    a.launched[2] = staging;
  }
  if (a.g.splits == 1) return cudaSuccess;
  return launch_reduce<TP, DECONV>(work, a.ep, a.y, a.out_bf16, a.g,
                                   a.stream);
}

template <class TL, bool VEC, bool DECONV>
cudaError_t launch_tile(const FwdArgs& a) {
  const Geom& g = a.g;
  if (g.splits < 1 || g.k_per_split < 1 || (g.splits > 1 && !a.work))
    return cudaErrorInvalidValue;
  constexpr int smem = fma_smem_bytes<TL>();
  auto kernel = igemm_kernel<TL, VEC, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g, TL::BM, TL::BN, DECONV), TL::THREADS, smem,
           a.stream>>>(static_cast<const float*>(a.x),
                       static_cast<const float*>(a.w), a.taps, a.ep, a.y,
                       a.out_bf16, g.splits > 1 ? a.work : nullptr, g);
  return finish<float, DECONV>(a, a.work, LAUNCHED_FMA, 1);
}

// The TF32 route; k_per_split is a multiple of a stage's pairs.
template <typename TA, typename TB, class TL, bool VEC, bool DECONV>
cudaError_t launch_tf32(const FwdArgs& a) {
  const Geom& g = a.g;
  if (g.splits < 1 || g.k_per_split < 1 ||
      g.k_per_split % (TL::KB / (int)sizeof(TA)) || (g.splits > 1 && !a.work))
    return cudaErrorInvalidValue;
  constexpr int smem = tf32_smem_bytes<TA, TB, TL>();
  auto kernel = igemm_tf32_kernel<TA, TB, TL, VEC, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g, TL::BM, TL::BN, DECONV), TL::THREADS, smem,
           a.stream>>>(static_cast<const TA*>(a.x),
                       static_cast<const TB*>(a.w), a.taps, a.ep, a.y,
                       a.out_bf16, g.splits > 1 ? a.work : nullptr, g);
  return finish<float, DECONV>(a, a.work, LAUNCHED_TF32, tf32_passes<TA>());
}

// The bf16 route; k_per_split is a multiple of a k16 step (a slice's
// last stage may end short: its pairs past the slice are zero-filled).
template <class TL, bool VA16, bool VB16, bool DECONV>
cudaError_t launch_bf16(const FwdArgs& a) {
  const Geom& g = a.g;
  if (g.splits < 1 || g.k_per_split < 1 || g.k_per_split % 16 ||
      (g.splits > 1 && !a.work))
    return cudaErrorInvalidValue;
  constexpr int smem = bf16_smem_bytes<TL>();
  auto kernel = igemm_bf16_kernel<TL, VA16, VB16, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g, TL::BM, TL::BN, DECONV), TL::THREADS, smem,
           a.stream>>>(static_cast<const __nv_bfloat16*>(a.x),
                       static_cast<const __nv_bfloat16*>(a.w), a.taps, a.ep,
                       a.y, a.out_bf16, g.splits > 1 ? a.work : nullptr, g);
  return finish<float, DECONV>(a, a.work, LAUNCHED_BF16, 1);
}

// The bf16 route's halo staging; one slice, Cin/G a multiple of 8, the
// deepest phase's taps in the tap table and in a.halo's steps.
template <class TL, bool VB16, bool DECONV>
cudaError_t launch_bf16_halo(const FwdArgs& a) {
  const Geom& g = a.g;
  const Halo& h = *a.halo;
  int deepest = 1;
  if (DECONV)
    deepest = ((g.Kd - 1) * g.dd / g.Sd + 1) * ((g.Kh - 1) * g.dh / g.Sh + 1) *
              ((g.Kw - 1) * g.dw / g.Sw + 1);
  else
    deepest = g.Kd * g.Kh * g.Kw;
  if (g.splits != 1 || (g.Ci / g.G) % HALO_CHANNELS || h.bd < 1 ||
      h.bh < 1 || h.bw < 1 || h.bd * h.bh * h.bw > TL::BM || h.lh < 1 ||
      h.lw < 1 || h.slots < 2 || (h.slots - 1) % (h.lh * h.lw) ||
      deepest > MAX_TAPS || h.steps < (deepest * HALO_CHANNELS + 15) / 16)
    return cudaErrorInvalidValue;
  const int smem = halo_smem_bytes<TL>(h.slots, h.steps);
  if (smem > HALO_SMEM_MAX ||
      (h.slots - 1) / (h.lh * h.lw) + h.lh + h.lw >
          halo_stage_bytes<TL>(h.slots, h.steps) / 4)
    return cudaErrorInvalidValue;
  auto kernel = igemm_bf16_halo_kernel<TL, VB16, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, HALO_SMEM_MAX, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g, h, TL::BN, DECONV), TL::THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w), a.taps, a.ep, a.y, a.out_bf16,
      g, h);
  return finish<float, DECONV>(a, a.work, LAUNCHED_BF16, 1, STAGING_HALO);
}

// The int8 route; work holds the slices' s32 sums (the f32 workspace's
// bytes), and k_per_split is a multiple of 16 (B's copies).
template <class TL, int VA, bool DECONV>
cudaError_t launch_s8(const FwdArgs& a) {
  const Geom& g = a.g;
  if (g.splits < 1 || g.k_per_split < 1 || g.k_per_split % 16 ||
      (g.splits > 1 && !a.work))
    return cudaErrorInvalidValue;
  constexpr int smem = s8_smem_bytes<TL>();
  auto kernel = igemm_s8_kernel<TL, VA, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  int* iwork = reinterpret_cast<int*>(a.work);
  kernel<<<grid_of(g, TL::BM, TL::BN, DECONV), TL::THREADS, smem,
           a.stream>>>(static_cast<const int8_t*>(a.x),
                       static_cast<const int8_t*>(a.w), a.taps, a.ep, a.y,
                       a.out_bf16, g.splits > 1 ? iwork : nullptr, g);
  return finish<int, DECONV>(a, iwork, LAUNCHED_S8, 1);
}

// The tile per output-channel block (the planner's block_co).
template <bool VEC, bool DECONV>
cudaError_t launch_fma_typed(const FwdArgs& a) {
  switch (a.block_co) {
    case 16: return launch_tile<Tile16, VEC, DECONV>(a);
    case 32: return launch_tile<Tile32, VEC, DECONV>(a);
    case 64: return launch_tile<Tile64, VEC, DECONV>(a);
    case 128: return launch_tile<Tile128, VEC, DECONV>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TA, typename TB, bool VEC, bool DECONV>
cudaError_t launch_tf32_typed(const FwdArgs& a) {
  switch (a.block_co) {
    case 16: return launch_tf32<TA, TB, Tf32Tile16, VEC, DECONV>(a);
    case 32: return launch_tf32<TA, TB, Tf32Tile32, VEC, DECONV>(a);
    case 64: return launch_tf32<TA, TB, Tf32Tile64, VEC, DECONV>(a);
    case 128: return launch_tf32<TA, TB, Tf32Tile128, VEC, DECONV>(a);
  }
  return cudaErrorInvalidValue;
}

template <class TL, bool VA16, bool DECONV>
cudaError_t launch_bf16_b(const FwdArgs& a) {
  return a.copy & BF16_COPY_B16 ? launch_bf16<TL, VA16, true, DECONV>(a)
                                : launch_bf16<TL, VA16, false, DECONV>(a);
}

template <bool VA16, bool DECONV>
cudaError_t launch_bf16_typed(const FwdArgs& a) {
  switch (a.block_co) {
    case 16: return launch_bf16_b<Bf16Tile16, VA16, DECONV>(a);
    case 32: return launch_bf16_b<Bf16Tile32, VA16, DECONV>(a);
    case 64: return launch_bf16_b<Bf16Tile64, VA16, DECONV>(a);
    case 128: return launch_bf16_b<Bf16Tile128, VA16, DECONV>(a);
  }
  return cudaErrorInvalidValue;
}

template <class TL, bool DECONV>
cudaError_t launch_bf16_halo_b(const FwdArgs& a) {
  return a.copy & BF16_COPY_B16 ? launch_bf16_halo<TL, true, DECONV>(a)
                                : launch_bf16_halo<TL, false, DECONV>(a);
}

template <bool DECONV>
cudaError_t launch_bf16_halo_typed(const FwdArgs& a) {
  if (!a.halo) return cudaErrorInvalidValue;
  switch (a.block_co) {
    case 16: return launch_bf16_halo_b<Bf16Tile16, DECONV>(a);
    case 32: return launch_bf16_halo_b<Bf16Tile32, DECONV>(a);
    case 64: return launch_bf16_halo_b<Bf16Tile64, DECONV>(a);
    case 128: return launch_bf16_halo_b<Bf16Tile128, DECONV>(a);
  }
  return cudaErrorInvalidValue;
}

template <int VA, bool DECONV>
cudaError_t launch_s8_typed(const FwdArgs& a) {
  switch (a.block_co) {
    case 16: return launch_s8<S8Tile16, VA, DECONV>(a);
    case 32: return launch_s8<S8Tile32, VA, DECONV>(a);
    case 64: return launch_s8<S8Tile64, VA, DECONV>(a);
    case 128: return launch_s8<S8Tile128, VA, DECONV>(a);
  }
  return cudaErrorInvalidValue;
}

// Unpack a C call; false for an output type the kernels do not store.
// launched (see Launched) reads -1 until a kernel has been launched.
inline bool fwd_args(FwdArgs& a, const void* x, const void* w,
                     const int* taps, const float* scale, const float* bias,
                     void* y, float* work, const int* geom, int act,
                     float alpha, int out_dtype, int block_co, int copy,
                     const int* halo, int* launched, void* stream) {
  if (launched) launched[0] = launched[1] = launched[2] = -1;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16) return false;
  int* dst = reinterpret_cast<int*>(&a.g);
  for (int i = 0; i < GEOM_FIELDS; ++i) dst[i] = geom[i];
  a.x = x;
  a.w = w;
  a.taps = taps;
  a.ep = Epi{scale, bias, act, alpha};
  a.y = y;
  a.out_bf16 = out_dtype == DT_BF16;
  a.work = work;
  a.block_co = block_co;
  a.copy = copy;
  a.halo = reinterpret_cast<const Halo*>(halo);
  a.launched = launched;
  a.stream = static_cast<cudaStream_t>(stream);
  return true;
}

// The (x, w) operand pairs the kernels take, in part order: f32 x f32 (the
// FMA route, pair 0), bf16 x bf16 (the bf16 route, pair 1), the pairs of
// int8 weights beside float activations (the TF32 route: f32 x int8,
// bf16 x int8, pairs 2-3, their types below), then int8 x int8 (the s8
// route); the pairs repro_torch.quant.Precision and bf16 training
// produce.
template <int PAIR> struct PairTypes;
template <> struct PairTypes<2> { using A = float; using B = int8_t; };
template <> struct PairTypes<3> { using A = __nv_bfloat16; using B = int8_t; };
constexpr int BF16_PAIR = 1;
constexpr int S8_PAIR = 4;
constexpr int HALO_PART = 11;
constexpr int FWD_PARTS = 12;

// The pair's index, or -1 for a pair the kernels do not take.
constexpr int pair_index(int x_dtype, int w_dtype) {
  if (x_dtype == DT_F32 && w_dtype == DT_F32) return 0;
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16) return 1;
  if (x_dtype == DT_F32 && w_dtype == DT_I8) return 2;
  if (x_dtype == DT_BF16 && w_dtype == DT_I8) return 3;
  if (x_dtype == DT_I8 && w_dtype == DT_I8) return S8_PAIR;
  return -1;
}

// The variant of one launch.  The C entry points compile the twelve
// variants as twelve objects (build.py passes -DREPRO_PART=0..11) so that
// nvcc builds them in parallel: per pair 0-3 and copy width, parts 0-1
// the FMA route (f32 x f32) and 4-7 the TF32 route (f32 x int8, bf16 x
// int8; copy != 0: 16-byte copies of both operands), 2-3 the bf16 route
// (bf16 x bf16) per A copy width (copy's BF16_COPY_A16 bit; B's width,
// the BF16_COPY_B16 bit, is chosen inside the part); parts 8-10 the s8
// route, per A copy width (copy = 16, 4 or 1 bytes); part 11 the bf16
// route's halo staging (halo: the planner's Halo, 16-byte copies of A),
// B's width chosen inside.  -1: no variant takes it.
constexpr int variant_part(int pair, int copy, bool halo = false) {
  if (halo)
    return pair == BF16_PAIR && (copy & BF16_COPY_A16) ? HALO_PART : -1;
  if (pair == BF16_PAIR) return 2 + (copy & BF16_COPY_A16 ? 0 : 1);
  if (pair < S8_PAIR) return 2 * pair + (copy ? 0 : 1);
  return 8 + (copy == 16 ? 0 : copy == 4 ? 1 : 2);
}

template <bool DECONV, int PART>
int run_part(const FwdArgs& a) {
  cudaError_t err;
  if constexpr (PART < 2) {
    err = launch_fma_typed<PART % 2 == 0, DECONV>(a);
  } else if constexpr (PART < 4) {
    err = launch_bf16_typed<PART % 2 == 0, DECONV>(a);
  } else if constexpr (PART < 8) {
    using P = PairTypes<PART / 2>;
    err = launch_tf32_typed<typename P::A, typename P::B, PART % 2 == 0,
                            DECONV>(a);
  } else if constexpr (PART < HALO_PART) {
    err = launch_s8_typed<PART == 8 ? 16 : PART == 9 ? 4 : 1, DECONV>(a);
  } else {
    err = launch_bf16_halo_typed<DECONV>(a);
  }
  return static_cast<int>(err);
}

}  // namespace repro
