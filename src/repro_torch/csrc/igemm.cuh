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
// about 40 % of the f32 peak.
//
// No block waits on another.  Sums are f32 with plain FMA (no TF32);
// operands are staged in their own type: the activations (A, type TA) f32
// or bf16, the weights (B, type TB) the same type or int8.  A stage holds
// 64 bytes of each row's pairs at A's width (16 f32 or 32 bf16 pairs) and
// B's rows of those pairs at B's width, so int8 weights beside f32
// activations take a quarter of B's shared memory.  int8 lanes become f32
// exactly in registers (the sign-flipped byte as the low mantissa byte of
// 2^23, minus 2^23 + 128: a byte permute and an add, no conversion
// instruction); every product of |q| <= 127 values is then exact in f32,
// and the sums round in f32, as the reference's f32 cast-then-dot does.
// The per-cout dequant scale is the epilogue's first multiply, on the
// finished sum (after the slices' sum when split), so it is applied
// exactly once.
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
// staging the input tile once with its halo are what it leaves.
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
// or one 8- or 4-byte read for a shorter row; src aligned to the read.
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
    static_assert(BYTES == 8 || BYTES == 4, "an 8- or 4-byte read");
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      raw.x = u.x;
      raw.y = u.y;
    } else {
      raw.x = *reinterpret_cast<const unsigned*>(src);
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

// Dynamic shared memory of one block: the A and B rings (a stage of B is
// A's KB / sizeof(TA) pairs of BN weights of TB), the row table and the tap
// table.  Keep in step with tiling.py::step_byte_model.
template <typename TA, typename TB, class TL>
constexpr int smem_bytes() {
  return TL::ST * (TL::BM * (TL::KB + APAD) +
                   TL::KB / (int)sizeof(TA) * TL::BN * (int)sizeof(TB)) +
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

// -- the float route ---------------------------------------------------------

// blockIdx: x = row tile, y = group x channel tile, z = phase x slice.
// The float route keeps its own copy of the block's setup and gather
// (block_pos, fill_tables and AGather are the same code): built from
// those helpers, the bf16 scalar-copy conv (255 registers) spilled.
// With partial != nullptr the block stores its slice's raw f32 sums at
// partial[((slice * phases + p) * rows + m) * Co + c]; else the epilogue's
// result in y (f32, or bf16 when out_bf16).  x is TA, w is TB.
template <typename TA, typename TB, class TL, bool VEC, bool DECONV>
__global__ void __launch_bounds__(TL::THREADS)
igemm_kernel(const TA* __restrict__ x, const TB* __restrict__ w,
             const int* __restrict__ taps, Epi ep, void* __restrict__ y,
             int out_bf16, float* __restrict__ partial, Geom g) {
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
    if constexpr (!VEC && sizeof(TB) < sizeof(TA)) {
      // int8 weights beside wider activations, a byte per copy: fully
      // unrolled, the bf16-activation conv spilled (ptxas), so four at a
      // time; every other variant keeps the full unroll below
#pragma unroll 4
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
    } else {
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

// -- the int8 x int8 route: s8 tensor cores ----------------------------------

// BM rows x BN output channels per block, WM x WN warps of (BM/WM) x
// (BN/WN) sums each (m16n8 fragments, four s32 sums a thread each), 64
// bytes of each row's pairs (two k32 steps) per stage, ST stages,
// MINB blocks an SM keeps resident (the register cap).  Keep in step with
// repro_torch/core/tiling.py::S8_KERNEL_TILES.
template <int BM_, int BN_, int WM_, int WN_, int ST_, int MINB_>
struct S8Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int ST = ST_, MINB = MINB_, KB = 64;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // its fragments
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "whole fragment pairs");
};
// Two resident blocks (128 registers a thread): capped at 80 for three,
// the deconv's tiles spilled; on V-Net merge4 two, three or four blocks
// an SM timed within 1 % of each other (PERF.md).
using S8Tile16 = S8Tile<256, 16, 8, 1, 3, 2>;
using S8Tile32 = S8Tile<256, 32, 8, 1, 3, 2>;
using S8Tile64 = S8Tile<128, 64, 4, 2, 4, 2>;
using S8Tile128 = S8Tile<128, 128, 4, 2, 4, 2>;

constexpr int BPAD = 16;         // pad after each staged K-major B row

// Dynamic shared memory of one block: the A ring [ST][BM][KB + APAD], the
// K-major B ring [ST][BN][KB + BPAD], the row table and the tap table.
// Keep in step with tiling.py::step_byte_model.
template <class TL>
constexpr int s8_smem_bytes() {
  return TL::ST * (TL::BM * (TL::KB + APAD) + TL::BN * (TL::KB + BPAD)) +
         16 * TL::BM + 16 * MAX_TAPS;
}

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
  // the warp's i-th 16 and channels 2 * (lane % 4) + {0, 1} of its j-th 8.
  // Then four channels of a row a thread, in row order: a slice's s32
  // sums, or the f32 epilogue and one store of four where aligned.  (The
  // epilogue straight from the fragments, unrolled over every fragment,
  // took cicc minutes to compile.)
  constexpr int CPITCH = BN + 4;                  // s32 per staged row
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
  const int64_t co_base = (int64_t)b.grp * Cog;
  const bool vec_out =
      g.Co % 4 == 0 && Cog % 4 == 0 &&
      reinterpret_cast<uintptr_t>(y) % (out_bf16 ? 8 : 16) == 0;
#pragma unroll 1
  for (int e = tid; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4), c = b.co0 + (e - r * (BN / 4)) * 4;
    const int m = b.m0 + r;
    if (m >= b.rows || c >= Cog) continue;
    const int4 s4 = *reinterpret_cast<const int4*>(ctile + r * CPITCH + c -
                                                    b.co0);
    const int sv[4] = {s4.x, s4.y, s4.z, s4.w};
    if (partial) {
      int* dst = partial +
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

// -- launches ----------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

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

template <typename TA, typename TB, class TL, bool VEC, bool DECONV>
cudaError_t launch_tile(const void* x, const void* w, const int* taps,
                        const Epi& ep, void* y, int out_bf16, float* work,
                        const Geom& g, cudaStream_t stream) {
  if (g.splits < 1 || g.k_per_split < 1 || (g.splits > 1 && !work))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<TA, TB, TL>();
  auto kernel = igemm_kernel<TA, TB, TL, VEC, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(g, TL::BM, TL::BN, DECONV), TL::THREADS, smem, stream>>>(
      static_cast<const TA*>(x), static_cast<const TB*>(w), taps, ep, y,
      out_bf16, g.splits > 1 ? work : nullptr, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_reduce<float, DECONV>(work, ep, y, out_bf16, g, stream);
}

// The int8 route; work holds the slices' s32 sums (the f32 workspace's
// bytes), and k_per_split is a multiple of 16 (B's copies).
template <class TL, int VA, bool DECONV>
cudaError_t launch_s8(const void* x, const void* w, const int* taps,
                      const Epi& ep, void* y, int out_bf16, float* work,
                      const Geom& g, cudaStream_t stream) {
  if (g.splits < 1 || g.k_per_split < 1 || g.k_per_split % 16 ||
      (g.splits > 1 && !work))
    return cudaErrorInvalidValue;
  constexpr int smem = s8_smem_bytes<TL>();
  auto kernel = igemm_s8_kernel<TL, VA, DECONV>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  int* iwork = reinterpret_cast<int*>(work);
  kernel<<<grid_of(g, TL::BM, TL::BN, DECONV), TL::THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), taps, ep,
      y, out_bf16, g.splits > 1 ? iwork : nullptr, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_reduce<int, DECONV>(iwork, ep, y, out_bf16, g, stream);
}

// The tile per output-channel block (the planner's block_co).
template <typename TA, typename TB, bool VEC, bool DECONV>
cudaError_t launch_typed(const void* x, const void* w, const int* taps,
                         const Epi& ep, void* y, int out_bf16, float* work,
                         const Geom& g, int block_co, cudaStream_t stream) {
  switch (block_co) {
    case 16:
      return launch_tile<TA, TB, Tile16, VEC, DECONV>(x, w, taps, ep, y,
                                                      out_bf16, work, g,
                                                      stream);
    case 32:
      return launch_tile<TA, TB, Tile32, VEC, DECONV>(x, w, taps, ep, y,
                                                      out_bf16, work, g,
                                                      stream);
    case 64:
      return launch_tile<TA, TB, Tile64, VEC, DECONV>(x, w, taps, ep, y,
                                                      out_bf16, work, g,
                                                      stream);
    case 128:
      return launch_tile<TA, TB, Tile128, VEC, DECONV>(x, w, taps, ep, y,
                                                       out_bf16, work, g,
                                                       stream);
  }
  return cudaErrorInvalidValue;
}

template <int VA, bool DECONV>
cudaError_t launch_s8_typed(const void* x, const void* w, const int* taps,
                            const Epi& ep, void* y, int out_bf16, float* work,
                            const Geom& g, int block_co,
                            cudaStream_t stream) {
  switch (block_co) {
    case 16:
      return launch_s8<S8Tile16, VA, DECONV>(x, w, taps, ep, y, out_bf16,
                                             work, g, stream);
    case 32:
      return launch_s8<S8Tile32, VA, DECONV>(x, w, taps, ep, y, out_bf16,
                                             work, g, stream);
    case 64:
      return launch_s8<S8Tile64, VA, DECONV>(x, w, taps, ep, y, out_bf16,
                                             work, g, stream);
    case 128:
      return launch_s8<S8Tile128, VA, DECONV>(x, w, taps, ep, y, out_bf16,
                                              work, g, stream);
  }
  return cudaErrorInvalidValue;
}

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
  cudaStream_t stream;
};

// Unpack a C call; false for an output type the kernels do not store.
inline bool fwd_args(FwdArgs& a, const void* x, const void* w,
                     const int* taps, const float* scale, const float* bias,
                     void* y, float* work, const int* geom, int act,
                     float alpha, int out_dtype, int block_co, void* stream) {
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
  a.stream = static_cast<cudaStream_t>(stream);
  return true;
}

// The (x, w) operand pairs the kernels take, in part order: the float
// pairs, int8 weights beside f32 and bf16 activations (the float route),
// then int8 activations and weights (the s8 route); the pairs
// repro_torch.quant.Precision produces.
template <int PAIR> struct PairTypes;
template <> struct PairTypes<0> { using A = float; using B = float; };
template <> struct PairTypes<1> {
  using A = __nv_bfloat16;
  using B = __nv_bfloat16;
};
template <> struct PairTypes<2> { using A = float; using B = int8_t; };
template <> struct PairTypes<3> { using A = __nv_bfloat16; using B = int8_t; };
constexpr int S8_PAIR = 4;
constexpr int FWD_PARTS = 11;

// The pair's index, or -1 for a pair the kernels do not take.
constexpr int pair_index(int x_dtype, int w_dtype) {
  if (x_dtype == DT_F32 && w_dtype == DT_F32) return 0;
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16) return 1;
  if (x_dtype == DT_F32 && w_dtype == DT_I8) return 2;
  if (x_dtype == DT_BF16 && w_dtype == DT_I8) return 3;
  if (x_dtype == DT_I8 && w_dtype == DT_I8) return S8_PAIR;
  return -1;
}

// The variant of one launch.  The C entry points compile the eleven
// variants as eleven objects (build.py passes -DREPRO_PART=0..10) so that
// nvcc builds them in parallel: parts 0-7 the float route, per pair and
// copy width (copy != 0: 16-byte copies of both operands); parts 8-10 the
// s8 route, per A copy width (copy = 16, 4 or 1 bytes).
constexpr int variant_part(int pair, int copy) {
  if (pair < S8_PAIR) return 2 * pair + (copy ? 0 : 1);
  return 8 + (copy == 16 ? 0 : copy == 4 ? 1 : 2);
}

template <bool DECONV, int PART>
int run_part(const FwdArgs& a) {
  cudaError_t err;
  if constexpr (PART < 8) {
    using P = PairTypes<PART / 2>;
    err = launch_typed<typename P::A, typename P::B, PART % 2 == 0, DECONV>(
        a.x, a.w, a.taps, a.ep, a.y, a.out_bf16, a.work, a.g, a.block_co,
        a.stream);
  } else {
    constexpr int VA = PART == 8 ? 16 : PART == 9 ? 4 : 1;
    err = launch_s8_typed<VA, DECONV>(a.x, a.w, a.taps, a.ep, a.y,
                                      a.out_bf16, a.work, a.g, a.block_co,
                                      a.stream);
  }
  return static_cast<int>(err);
}

}  // namespace repro
