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
// Each block owns a disjoint BM x BN output tile and computes all of it:
// no carry between blocks, no atomics, so results repeat bit for bit.
// Operands are staged in shared memory in their own type (f32 or bf16) and
// accumulated in f32 registers with plain FMA (IEEE f32, no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

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
};
constexpr int GEOM_FIELDS = 25;
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

// BM output rows x BN output channels per block, BK (tap, channel) pairs
// per shared-memory stage, TM x TN accumulators per thread.
template <typename T, typename U, int BM, int BN, int BK, int TM, int TN,
          bool DECONV>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
igemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const int* __restrict__ taps, Epi ep, U* __restrict__ y,
             Geom g) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int A_STEP = THREADS / BK;   // rows one pass of A loads covers
  constexpr int B_STEP = THREADS / BN;   // k rows one pass of B loads covers
  static_assert(THREADS % BK == 0 && BM % A_STEP == 0, "A tiling");
  static_assert(THREADS % BN == 0 && BK % B_STEP == 0, "B tiling");

  __shared__ T As[BK][BM + 1];  // +1: the kk-major stores hit distinct banks
  __shared__ T Bs[BK][BN];
  __shared__ int rowN[BM], rowD[BM], rowH[BM], rowW[BM];

  const int tid = threadIdx.x;
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int co_tiles = (Cog + BN - 1) / BN;
  const int grp = blockIdx.y / co_tiles;
  const int co0 = (blockIdx.y % co_tiles) * BN;          // within the group
  const int rows = g.N * g.Pd * g.Ph * g.Pw;
  const int m0 = blockIdx.x * BM;

  int pd = 0, ph = 0, pw = 0, tap0 = 0, ntaps;
  const int* tapm = taps;
  if (DECONV) {
    const int p = blockIdx.z;
    pw = p % g.Sw;
    ph = (p / g.Sw) % g.Sh;
    pd = p / (g.Sw * g.Sh);
    tap0 = taps[2 * p];
    ntaps = taps[2 * p + 1];
    tapm = taps + 2 * g.Sd * g.Sh * g.Sw;
  } else {
    ntaps = g.Kd * g.Kh * g.Kw;
  }
  const int Ktot = ntaps * Cig;

  // per-row input base coordinates (rowN < 0 marks rows past the end)
  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    if (m < rows) {
      int t = m;
      const int qw = t % g.Pw; t /= g.Pw;
      const int qh = t % g.Ph; t /= g.Ph;
      const int qd = t % g.Pd;
      rowN[r] = t / g.Pd;
      if (DECONV) {
        rowD[r] = qd; rowH[r] = qh; rowW[r] = qw;
      } else {
        rowD[r] = qd * g.Sd - g.lod;
        rowH[r] = qh * g.Sh - g.loh;
        rowW[r] = qw * g.Sw - g.low;
      }
    } else {
      rowN[r] = -1;
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int a_k = tid % BK, a_r = tid / BK;
  const int b_n = tid % BN, b_k = tid / BN;
  const int64_t ci_base = (int64_t)grp * Cig;
  const int64_t w_row0 = (int64_t)tap0 * Cig;
  const int co_b = co0 + b_n;
  const T zero = from_f32<T>(0.f);

  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    // A: this thread's column kk is fixed for the stage; decode it once
    const int kk = k0 + a_k;
    const bool k_ok = kk < Ktot;
    const int t = k_ok ? kk / Cig : 0;
    const int ci = kk - t * Cig;
    int dd, dh, dw;
    if (DECONV) {
      const int* mm = tapm + 3 * (tap0 + t);
      dd = -mm[0]; dh = -mm[1]; dw = -mm[2];
    } else {
      const int kw = t % g.Kw, kh = (t / g.Kw) % g.Kh, kd = t / (g.Kw * g.Kh);
      dd = kd * g.dd; dh = kh * g.dh; dw = kw * g.dw;
    }
#pragma unroll
    for (int i = 0; i < BM / A_STEP; ++i) {
      const int r = a_r + i * A_STEP;
      const int n = rowN[r];
      T v = zero;
      if (k_ok && n >= 0) {
        const int id = rowD[r] + dd, ih = rowH[r] + dh, iw = rowW[r] + dw;
        if ((unsigned)id < (unsigned)g.D && (unsigned)ih < (unsigned)g.H &&
            (unsigned)iw < (unsigned)g.W)
          v = x[((((int64_t)n * g.D + id) * g.H + ih) * g.W + iw) * g.Ci +
                ci_base + ci];
      }
      As[a_k][r] = v;
    }
    // B: a plain row-major [Ktot, Co] slab starting at the phase's taps
#pragma unroll
    for (int i = 0; i < BK / B_STEP; ++i) {
      const int k = b_k + i * B_STEP;
      T v = zero;
      if (k0 + k < Ktot && co_b < Cog)
        v = w[(w_row0 + k0 + k) * g.Co + (int64_t)grp * Cog + co_b];
      Bs[k][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f32(As[k][ty + i * (BM / TM)]);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = to_f32(Bs[k][tx + j * (BN / TN)]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue on the finished f32 sums, then the store (crop folded in)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * (BM / TM);
    const int m = m0 + r;
    if (m >= rows) continue;
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
        continue;
    }
    const int64_t out =
        ((((int64_t)n * g.Od + od) * g.Oh + oh) * g.Ow + ow) * g.Co;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + tx + j * (BN / TN);
      if (co >= Cog) continue;
      const int c = grp * Cog + co;
      y[out + c] = from_f32<U>(epilogue(acc[i][j], ep, c));
    }
  }
}

// Tile shapes per output-channel block (the planner's block_co): 128 rows,
// 16 (tap, channel) pairs per stage.  Keep in step with
// repro_torch/core/tiling.py::KERNEL_TILES.
template <typename T, typename U, bool DECONV>
cudaError_t launch_typed(const void* x, const void* w, const int* taps,
                         Epi ep, void* y, const Geom& g, int block_co,
                         cudaStream_t stream) {
  const int rows = g.N * g.Pd * g.Ph * g.Pw;
  const int phases = DECONV ? g.Sd * g.Sh * g.Sw : 1;
  const int Cog = g.Co / g.G;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  U* yt = static_cast<U*>(y);
#define REPRO_LAUNCH(BN, TM, TN)                                           \
  {                                                                        \
    constexpr int BM = 128, BK = 16;                                       \
    dim3 grid((rows + BM - 1) / BM, g.G * ((Cog + BN - 1) / BN), phases);  \
    igemm_kernel<T, U, BM, BN, BK, TM, TN, DECONV>                         \
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(xt, wt, taps, ep, yt, \
                                                      g);                  \
    return cudaGetLastError();                                             \
  }
  switch (block_co) {
    case 16: REPRO_LAUNCH(16, 8, 2)
    case 32: REPRO_LAUNCH(32, 8, 4)
    case 64: REPRO_LAUNCH(64, 8, 4)
  }
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

template <bool DECONV>
int launch(const void* x, const void* w, const int* taps, const float* scale,
           const float* bias, void* y, const int* geom, int act, float alpha,
           int in_dtype, int out_dtype, int block_co, void* stream) {
  Geom g;
  int* dst = reinterpret_cast<int*>(&g);
  for (int i = 0; i < GEOM_FIELDS; ++i) dst[i] = geom[i];
  const Epi ep{scale, bias, act, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    err = launch_typed<float, float, DECONV>(x, w, taps, ep, y, g, block_co, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    err = launch_typed<float, __nv_bfloat16, DECONV>(x, w, taps, ep, y, g,
                                                     block_co, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16, DECONV>(x, w, taps, ep,
                                                             y, g, block_co, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    err = launch_typed<__nv_bfloat16, float, DECONV>(x, w, taps, ep, y, g,
                                                     block_co, s);
  return static_cast<int>(err);
}

}  // namespace repro
