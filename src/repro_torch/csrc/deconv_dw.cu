// Weight gradient of the deconv and the conv for Hopper, sm_90a.
//
// Replaces the TPU kernel deconv_dw_pallas_3d (src/repro/kernels/deconv/
// kernel.py, body _deconv_dw_kernel_body).  One kernel serves both ops:
//
//     out[t, a, b] = sum_p A[p, a] * B[p*S + k_t*dil - lo, b]
//
// p runs over every position of the unstrided operand A (batch folded in),
// t over the taps in kernel-element order, and reads of B outside its
// extent are zero; a's group pairs with b's group.  For the deconv A = x,
// B = dy and lo is the crop; for the conv A = dy, B = x, lo is the pad and
// the result is stored transposed per group ([t, b, g*Ag + a]), which is
// the conv's weight layout.
//
// The TPU kernel carries the sum (and an x halo) in VMEM across its
// sequential (N, d-tile) grid.  CUDA blocks run concurrently, so here the
// reduction is cut into row slices: a block owns one (a-tile, column
// tile, row slice), where a column is a (tap, b channel) pair, and sums its
// slice in f32 registers with A and the gathered B staged through shared
// memory.  With one slice the block stores the cast result; with more,
// each slice stores its f32 partial into a workspace and a second pass
// (dw_reduce) sums the slices in slice order and casts.  No atomics:
// results repeat bit for bit.
//
// What bounds it on an H100: on the big V-Net layers (merge4 sums 4.19 M
// rows into 27 x 32 x 16 outputs) operations: 2 x rows x taps x Ag x Bg
// FLOPs against reading each operand once; on DCGAN's layers latency (as
// few as 1,024 rows, a few hundred blocks).  The design folds the taps
// into the column axis, so a 1- or 3-channel operand still fills a
// 64/128-wide column tile, and the planner (core/tiling.py::plan_dw_tiles)
// splits the rows until about four blocks per SM are in flight.  Plain
// IEEE f32 FMA on CUDA cores; no cp.async/TMA pipelining and no tensor
// cores yet.
#include "igemm.cuh"

namespace repro {

// Geometry, in the order the Python wrapper packs it (DW_GEOM_FIELDS).
struct DwGeom {
  int N, Ad, Ah, Aw, Ac;       // A: [N, Ad, Ah, Aw, Ac]
  int Bd, Bh, Bw, Bc;          // B: [N, Bd, Bh, Bw, Bc]
  int G;                       // groups
  int Kd, Kh, Kw;              // kernel extent
  int Sd, Sh, Sw;              // stride
  int dd, dh, dw;              // dilation
  int lod, loh, low;           // B index offset (deconv crop / conv pad)
  int rows_per_split;          // rows of one slice (a multiple of BK)
  int transpose;               // store [t, b, g*Ag + a] (the conv's dw)
};
constexpr int DW_GEOM_FIELDS = 24;
static_assert(sizeof(DwGeom) == DW_GEOM_FIELDS * sizeof(int),
              "DwGeom is packed");

// BA channels of A x BC columns per block, BK rows per shared-memory stage,
// TA x TC sums per thread.  blockIdx: x = column tile, y = group x a-tile,
// z = row slice.  With partial != nullptr the block stores f32 partials at
// partial[z * out_elems + i], else the cast result at out[i].
template <typename T, typename U, int BA, int BC, int BK, int TA, int TC>
__global__ void __launch_bounds__((BA / TA) * (BC / TC))
dw_kernel(const T* __restrict__ A, const T* __restrict__ B,
          U* __restrict__ out, float* __restrict__ partial, DwGeom g) {
  constexpr int THREADS = (BA / TA) * (BC / TC);
  static_assert((BK * BC) % THREADS == 0, "B tiling");

  __shared__ T As[BK][BA];
  __shared__ T Bs[BK][BC];
  __shared__ int rowN[BK], rowD[BK], rowH[BK], rowW[BK];
  __shared__ int colB[BC], colD[BC], colH[BC], colW[BC];

  const int tid = threadIdx.x;
  const int Ag = g.Ac / g.G, Bg = g.Bc / g.G;
  const int taps = g.Kd * g.Kh * g.Kw;
  const int cols = taps * Bg;
  const int a_tiles = (Ag + BA - 1) / BA;
  const int grp = blockIdx.y / a_tiles;
  const int a0 = (blockIdx.y % a_tiles) * BA;     // within the group
  const int c0 = blockIdx.x * BC;
  const int64_t rows = (int64_t)g.N * g.Ad * g.Ah * g.Aw;
  const int64_t r_begin = (int64_t)blockIdx.z * g.rows_per_split;
  int64_t r_end = r_begin + g.rows_per_split;
  if (r_end > rows) r_end = rows;

  // per-column tap offsets and b channel (colB < 0: past the last column)
  for (int j = tid; j < BC; j += THREADS) {
    const int c = c0 + j;
    if (c < cols) {
      const int t = c / Bg;
      colB[j] = c - t * Bg;
      const int kw = t % g.Kw, kh = (t / g.Kw) % g.Kh, kd = t / (g.Kw * g.Kh);
      colD[j] = kd * g.dd - g.lod;
      colH[j] = kh * g.dh - g.loh;
      colW[j] = kw * g.dw - g.low;
    } else {
      colB[j] = -1;
    }
  }

  float acc[TA][TC];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  const int tx = tid % (BC / TC), ty = tid / (BC / TC);
  const int64_t a_base = (int64_t)grp * Ag + a0;
  const int64_t b_base = (int64_t)grp * Bg;
  const T zero = from_f32<T>(0.f);

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BK) {
    __syncthreads();  // the previous stage's reads are done
    // row coordinates on B's grid (rowN < 0: past the slice)
    for (int k = tid; k < BK; k += THREADS) {
      const int64_t r = r0 + k;
      if (r < r_end) {
        int64_t t = r;
        const int w = (int)(t % g.Aw); t /= g.Aw;
        const int h = (int)(t % g.Ah); t /= g.Ah;
        const int d = (int)(t % g.Ad);
        rowN[k] = (int)(t / g.Ad);
        rowD[k] = d * g.Sd;
        rowH[k] = h * g.Sh;
        rowW[k] = w * g.Sw;
      } else {
        rowN[k] = -1;
      }
    }
    // A: BK rows x BA channels, channels fastest (coalesced)
    for (int e = tid; e < BK * BA; e += THREADS) {
      const int k = e / BA, a = e - k * BA;
      const int64_t r = r0 + k;
      T v = zero;
      if (r < r_end && a0 + a < Ag) v = A[r * g.Ac + a_base + a];
      As[k][a] = v;
    }
    __syncthreads();  // row coordinates are in place
    // B: BK rows x BC (tap, channel) columns, gathered at p*S + k*dil - lo
#pragma unroll
    for (int i = 0; i < (BK * BC) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / BC, j = e - k * BC;
      const int n = rowN[k], b = colB[j];
      T v = zero;
      if (n >= 0 && b >= 0) {
        const int bd = rowD[k] + colD[j], bh = rowH[k] + colH[j],
                  bw = rowW[k] + colW[j];
        if ((unsigned)bd < (unsigned)g.Bd && (unsigned)bh < (unsigned)g.Bh &&
            (unsigned)bw < (unsigned)g.Bw)
          v = B[((((int64_t)n * g.Bd + bd) * g.Bh + bh) * g.Bw + bw) * g.Bc +
                b_base + b];
      }
      Bs[k][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TA], b[TC];
#pragma unroll
      for (int i = 0; i < TA; ++i) a[i] = to_f32(As[k][ty + i * (BA / TA)]);
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = to_f32(Bs[k][tx + j * (BC / TC)]);
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const int64_t out_elems = (int64_t)taps * Ag * g.Bc;
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const int a = a0 + ty + i * (BA / TA);
    if (a >= Ag) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + tx + j * (BC / TC);
      if (c >= cols) continue;
      const int t = c / Bg, b = c - t * Bg;
      const int64_t o =
          g.transpose
              ? ((int64_t)t * Bg + b) * g.Ac + (int64_t)grp * Ag + a
              : ((int64_t)t * Ag + a) * g.Bc + (int64_t)grp * Bg + b;
      if (partial)
        partial[(int64_t)blockIdx.z * out_elems + o] = acc[i][j];
      else
        out[o] = from_f32<U>(acc[i][j]);
    }
  }
}

// Sum the row slices in slice order (igemm.cuh's slice_sum, which the
// forward kernels' split reduction shares) and cast.
template <typename U>
__global__ void dw_reduce(const float* __restrict__ partial,
                          U* __restrict__ out, int64_t n, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = from_f32<U>(slice_sum(partial, n, splits, i));
}

template <typename T, typename U>
cudaError_t launch_dw_typed(const void* a, const void* b, void* out,
                            float* workspace, const DwGeom& g, int splits,
                            int block_a, cudaStream_t stream) {
  const int Ag = g.Ac / g.G, Bg = g.Bc / g.G;
  const int taps = g.Kd * g.Kh * g.Kw;
  const int64_t out_elems = (int64_t)taps * Ag * g.Bc;
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  U* ot = static_cast<U*>(out);
  float* part = splits > 1 ? workspace : nullptr;
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
#define REPRO_DW_LAUNCH(BA, BC, TA, TC)                                       \
  {                                                                           \
    constexpr int BK = 16;                                                    \
    dim3 grid((taps * Bg + BC - 1) / BC, g.G * ((Ag + BA - 1) / BA), splits); \
    dw_kernel<T, U, BA, BC, BK, TA, TC>                                       \
        <<<grid, (BA / TA) * (BC / TC), 0, stream>>>(at, bt, ot, part, g);    \
    break;                                                                    \
  }
  switch (block_a) {
    case 16: REPRO_DW_LAUNCH(16, 128, 2, 4)
    case 32: REPRO_DW_LAUNCH(32, 128, 4, 4)
    case 64: REPRO_DW_LAUNCH(64, 64, 4, 4)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DW_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int threads = 256;
  dw_reduce<U><<<(unsigned)((out_elems + threads - 1) / threads), threads, 0,
                 stream>>>(workspace, ot, out_elems, splits);
  return cudaGetLastError();
}

}  // namespace repro

// Tile shapes per block_a (the planner's): keep in step with
// repro_torch/core/tiling.py::DW_TILES.
extern "C" int repro_deconv_dw(const void* a, const void* b, void* out,
                               float* workspace, const int* geom, int splits,
                               int block_a, int in_dtype, int out_dtype,
                               void* stream) {
  using namespace repro;
  DwGeom g;
  int* dst = reinterpret_cast<int*>(&g);
  for (int i = 0; i < DW_GEOM_FIELDS; ++i) dst[i] = geom[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    err = launch_dw_typed<float, float>(a, b, out, workspace, g, splits,
                                        block_a, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    err = launch_dw_typed<float, __nv_bfloat16>(a, b, out, workspace, g,
                                                splits, block_a, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    err = launch_dw_typed<__nv_bfloat16, __nv_bfloat16>(a, b, out, workspace,
                                                        g, splits, block_a, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    err = launch_dw_typed<__nv_bfloat16, float>(a, b, out, workspace, g,
                                                splits, block_a, s);
  return static_cast<int>(err);
}
