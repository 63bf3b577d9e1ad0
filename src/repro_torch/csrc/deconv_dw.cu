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
// slice in f32 registers.  With one slice the block stores the cast
// result; with more, each slice stores its f32 partial into a workspace
// and a second pass (dw_reduce) sums the slices in slice order and casts.
// No atomics: results repeat bit for bit.
//
// What bounds it on an H100: on the big V-Net layers (merge4 sums 4.19 M
// rows into 27 x 16 x 32 outputs) operations, 2 x rows x taps x Ag x Bg
// FLOPs in IEEE f32 on CUDA cores (67 TFLOP/s, no TF32), while each B
// element is gathered from L2 once per tap; on DCGAN's layers latency (as
// few as 1,024 rows).  The block is igemm.cuh's recipe with the gather on
// the other operand:
//
//   * a ring of shared-memory stages of 32 rows ([rows][block_a] of A,
//     [rows][block_c] of gathered B) filled with cp.async: 16-byte copies
//     of 4 f32 / 8 bf16 consecutive channels (of one A row, or of one tap
//     of one B row) that skip L1 (.cg), where the per-group channels and
//     the alignment allow (the wrapper picks per operand: VA, VB), else
//     4-byte f32 copies or 2-byte bf16 loads.  A source size of 0
//     zero-fills reads outside B's extent, rows past the slice and
//     columns past the last.  Each copying thread walks its own rows'
//     (n, d, h, w) and keeps its columns' tap offsets in registers, so no
//     table and no extra barrier: one barrier per stage, and the next
//     stage loads while this one computes.
//   * register tiles sized to the layer: where A has <= 16 or <= 32
//     channels a group, the block takes all of them against 256 columns
//     (4 x 8 sums a thread); wider A takes 64 x 128 tiles (8 x 8 sums);
//     layers of <= 32 columns (1-3-channel images, the 1x1x1 head) take a
//     16 x 32 tile.  Each thread's sums are read from shared memory as
//     16-byte vectors, 11-16 FMAs per shared load on the big tiles; all
//     threads of a warp read one staged row, their vectors side by side,
//     so the reads need no pad to stay free of bank conflicts.
//   * the planner (core/tiling.py::plan_dw_tiles) splits the rows, in
//     whole stages, until one wave of resident blocks is in flight.
//
// What still bounds it: each B element is gathered once per tap (27 times
// on a 3x3x3 layer) and a 16-channel A reuses each staged B element 16
// times; no halo staging and no tensor cores yet.
#include <type_traits>

#include "igemm.cuh"

// This source is compiled once per variant (-DREPRO_PART=0..7, see
// dw_part); part 0 also holds the C entry point.
#ifndef REPRO_PART
#error "build with -DREPRO_PART=0..7"
#endif

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
  int rows_per_split;          // rows of one slice (a multiple of DW_BK)
  int transpose;               // store [t, b, g*Ag + a] (the conv's dw)
};
constexpr int DW_GEOM_FIELDS = 24;
static_assert(sizeof(DwGeom) == DW_GEOM_FIELDS * sizeof(int),
              "DwGeom is packed");

constexpr int DW_BK = 32;       // rows of the reduction per stage

// BA channels of A x BC columns per block, TA x TC sums per thread, ST
// stages in the ring.  Keep in step with core/tiling.py::DW_KERNEL_TILES.
template <int BA_, int BC_, int TA_, int TC_, int ST_>
struct DwTile {
  static constexpr int BA = BA_, BC = BC_, TA = TA_, TC = TC_, ST = ST_;
  static constexpr int THREADS = (BA / TA) * (BC / TC);
};
using DwTileC = DwTile<16, 32, 2, 4, 2>;      // <= 32 columns
using DwTile16 = DwTile<16, 256, 4, 8, 2>;
using DwTile32 = DwTile<32, 256, 4, 8, 2>;
using DwTile64 = DwTile<64, 128, 8, 8, 3>;

template <class TL, typename T>
constexpr int dw_smem_bytes() {
  return TL::ST * DW_BK * (TL::BA + TL::BC) * (int)sizeof(T);
}

// Bring a coordinate that was advanced past its extent back into it and
// return the carry into the next one.  A step of at most one extent (the
// common case) costs a compare and a subtraction, no division.
__device__ __forceinline__ int wrap(int& v, int extent) {
  if (v < extent) return 0;
  v -= extent;
  if (v < extent) return 1;
  const int q = v / extent;
  v -= q * extent;
  return q + 1;
}

// blockIdx: x = column tile, y = group x a-tile, z = row slice.  With
// partial != nullptr the block stores f32 partials at
// partial[z * out_elems + i], else the cast result at out[i].
template <typename T, class TL, bool VA, bool VB>
__global__ void __launch_bounds__(TL::THREADS)
dw_kernel(const T* __restrict__ A, const T* __restrict__ B,
          void* __restrict__ out, int out_bf16, float* __restrict__ partial,
          DwGeom g) {
  constexpr int BA = TL::BA, BC = TL::BC, TA = TL::TA, TC = TL::TC;
  constexpr int THREADS = TL::THREADS, ST = TL::ST, BK = DW_BK;
  constexpr int VE = 16 / sizeof(T);             // elements of 16 bytes
  constexpr int EA = VA ? VE : 1, EB = VB ? VE : 1;   // elements per copy
  constexpr int CA = BA / EA, CB = BC / EB;      // copies per staged row
  // A: copies e = tid + i * THREADS of the stage's BK x CA
  constexpr int A_ITERS = (BK * CA + THREADS - 1) / THREADS;
  // B: each thread copies B_NCOL columns of every B_RSTEP-th row
  constexpr int B_NCOL = CB > THREADS ? CB / THREADS : 1;
  constexpr int B_RSTEP = THREADS > CB ? THREADS / CB : 1;
  constexpr int B_ROWS = BK / B_RSTEP;
  // the scalar A copies stay a loop (build time); the B rows too, four
  // at a time (unrolled further, ptxas spilled on the bf16 16 x 256 tile)
  constexpr int A_UNROLL = VA ? A_ITERS : 4;
  constexpr int B_UNROLL = B_ROWS < 4 ? B_ROWS : 4;
  // shared reads: vectors of RA / RB values
  constexpr int RA = TA < VE ? TA : VE, RB = TC < VE ? TC : VE;
  constexpr int NRA = TA / RA, NRB = TC / RB;
  static_assert(CA % THREADS == 0 || THREADS % CA == 0, "A copies");
  static_assert(CB % THREADS == 0 || THREADS % CB == 0, "B copies");
  static_assert(B_RSTEP <= BK && BK % B_RSTEP == 0, "B rows");
  static_assert(BA % (NRA * RA) == 0 && BC % (NRB * RB) == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);            // [ST][BK][BA]
  T* Bs = As + ST * BK * BA;                     // [ST][BK][BC]

  const int tid = threadIdx.x;
  const int Ag = g.Ac / g.G, Bg = g.Bc / g.G;
  const int taps = g.Kd * g.Kh * g.Kw;
  const int cols = taps * Bg;
  const int a_tiles = (Ag + BA - 1) / BA;
  const int grp = blockIdx.y / a_tiles;
  const int a0 = (blockIdx.y % a_tiles) * BA;    // within the group
  const int c0 = blockIdx.x * BC;
  const int rows = g.N * g.Ad * g.Ah * g.Aw;
  const int r_begin = blockIdx.z * g.rows_per_split;
  const int r_end = min(rows, r_begin + g.rows_per_split);
  const int nst = (r_end - r_begin + BK - 1) / BK;
  const int64_t a_base = (int64_t)grp * Ag + a0;

  // this thread's B columns: tap offset on B's grid and absolute channel
  // (ok false: past the last column)
  int cd[B_NCOL], ch[B_NCOL], cw[B_NCOL], cb[B_NCOL];
  bool cok[B_NCOL];
#pragma unroll
  for (int j = 0; j < B_NCOL; ++j) {
    const int c = c0 + (tid % CB + j * THREADS) * EB;
    cok[j] = c < cols;
    const int t = cok[j] ? c / Bg : 0;
    cb[j] = grp * Bg + (c - t * Bg);
    const int kw = t % g.Kw, kh = (t / g.Kw) % g.Kh, kd = t / (g.Kw * g.Kh);
    cd[j] = kd * g.dd - g.lod;
    ch[j] = kh * g.dh - g.loh;
    cw[j] = kw * g.dw - g.low;
  }
  // this thread's next B row r and its coordinates, advanced B_RSTEP rows
  // at a time (the stages load in order, so no division per row)
  int r = r_begin + tid / CB;
  int rn, rd, rh, rw;
  {
    int t = r;
    rw = t % g.Aw; t /= g.Aw;
    rh = t % g.Ah; t /= g.Ah;
    rd = t % g.Ad;
    rn = t / g.Ad;
  }

  auto load_stage = [&](int slot, int k0) {
    // A: BK rows x BA channels, straight from A's rows
    T* adst = As + slot * BK * BA;
#pragma unroll (A_UNROLL)
    for (int i = 0; i < A_ITERS; ++i) {
      const int e = tid + i * THREADS;
      if ((BK * CA) % THREADS == 0 || e < BK * CA) {
        const int k = e / CA, a = (e - k * CA) * EA;
        const int ra = r_begin + k0 + k;
        const bool ok = ra < r_end && a0 + a < Ag;
        const T* src = ok ? A + (int64_t)ra * g.Ac + a_base + a : A;
        copy_async<EA * sizeof(T)>(adst + k * BA + a, src, ok);
      }
    }
    // B: BK rows x BC (tap, channel) columns, gathered at p*S + k*dil - lo
    T* bdst = Bs + slot * BK * BC + (tid / CB) * BC + (tid % CB) * EB;
#pragma unroll (B_UNROLL)
    for (int i = 0; i < B_ROWS; ++i) {
      const bool row_ok = r < r_end;
      const int pd = rd * g.Sd, ph = rh * g.Sh, pw = rw * g.Sw;
      const int nb = rn * g.Bd;
#pragma unroll
      for (int j = 0; j < B_NCOL; ++j) {
        const int bd = pd + cd[j], bh = ph + ch[j], bw = pw + cw[j];
        const bool ok = row_ok && cok[j] && (unsigned)bd < (unsigned)g.Bd &&
                        (unsigned)bh < (unsigned)g.Bh &&
                        (unsigned)bw < (unsigned)g.Bw;
        const T* src =
            ok ? B + (int64_t)(((nb + bd) * g.Bh + bh) * g.Bw + bw) * g.Bc +
                     cb[j]
               : B;
        copy_async<EB * sizeof(T)>(bdst + i * B_RSTEP * BC + j * THREADS * EB,
                                   src, ok);
      }
      r += B_RSTEP;
      rw += B_RSTEP;
      const int qh = wrap(rw, g.Aw);
      if (qh) {
        rh += qh;
        const int qd = wrap(rh, g.Ah);
        if (qd) {
          rd += qd;
          rn += wrap(rd, g.Ad);
        }
      }
    }
  };

  float acc[TA][TC];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nst) load_stage(s, s * BK);
    copy_commit();
  }

  const int tx = tid % (BC / TC), ty = tid / (BC / TC);
  for (int st = 0; st < nst; ++st) {
    copy_wait<ST - 2>();    // stage st has landed (this thread's copies)
    __syncthreads();        // ... everyone's; slot st-1 is free again
    const int nxt = st + ST - 1;
    if (nxt < nst) load_stage(nxt % ST, nxt * BK);
    copy_commit();
    const int slot = st % ST;
    const T* a_s = As + slot * BK * BA + ty * RA;
    const T* b_s = Bs + slot * BK * BC + tx * RB;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TA], b[TC];
#pragma unroll
      for (int i = 0; i < NRA; ++i)
        load_row<T, RA>(a + i * RA, a_s + k * BA + i * (BA / NRA));
#pragma unroll
      for (int j = 0; j < NRB; ++j)
        load_row<T, RB>(b + j * RB, b_s + k * BC + j * (BC / NRB));
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  copy_wait<0>();

  const int64_t out_elems = (int64_t)taps * Ag * g.Bc;
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const int a = a0 + ty * RA + (i / RA) * (BA / NRA) + i % RA;
    if (a >= Ag) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + tx * RB + (j / RB) * (BC / NRB) + j % RB;
      if (c >= cols) continue;
      const int t = c / Bg, b = c - t * Bg;
      const int64_t o =
          g.transpose
              ? ((int64_t)t * Bg + b) * g.Ac + (int64_t)grp * Ag + a
              : ((int64_t)t * Ag + a) * g.Bc + (int64_t)grp * Bg + b;
      if (partial)
        partial[(int64_t)blockIdx.z * out_elems + o] = acc[i][j];
      else
        store_out(out, out_bf16, o, acc[i][j]);
    }
  }
}

// Sum the row slices in slice order (igemm.cuh's slice_sum, which the
// forward kernels' split reduction shares) and cast.
static __global__ void dw_reduce(const float* __restrict__ partial,
                          void* __restrict__ out, int out_bf16, int64_t n,
                          int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_out(out, out_bf16, i, slice_sum(partial, n, splits, i));
}

// One dw launch's arguments, as the C entry point receives them.
struct DwArgs {
  const void* a;
  const void* b;
  void* out;
  int out_bf16;
  float* work;
  DwGeom g;
  int splits;
  int block_a, block_c;
  cudaStream_t stream;
};

template <typename T, class TL, bool VA, bool VB>
cudaError_t launch_dw_tile(const DwArgs& x) {
  const DwGeom& g = x.g;
  const int Ag = g.Ac / g.G, Bg = g.Bc / g.G;
  const int taps = g.Kd * g.Kh * g.Kw;
  constexpr int smem = dw_smem_bytes<TL, T>();
  auto kernel = dw_kernel<T, TL, VA, VB>;
  // raise the kernel's dynamic shared-memory limit once per device
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  dim3 grid((taps * Bg + TL::BC - 1) / TL::BC,
            g.G * ((Ag + TL::BA - 1) / TL::BA), x.splits);
  kernel<<<grid, TL::THREADS, smem, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.out,
      x.out_bf16, x.splits > 1 ? x.work : nullptr, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || x.splits == 1) return err;
  const int64_t n = (int64_t)taps * Ag * g.Bc;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, x.stream>>>(
      x.work, x.out, x.out_bf16, n, x.splits);
  return cudaGetLastError();
}

// The tile named by (block_a, block_c), the planner's.
template <typename T, bool VA, bool VB>
int run_dw_variant(const DwArgs& x) {
  cudaError_t err = cudaErrorInvalidValue;
  if (x.block_a == 16 && x.block_c == 32)
    err = launch_dw_tile<T, DwTileC, VA, VB>(x);
  else if (x.block_a == 16 && x.block_c == 256)
    err = launch_dw_tile<T, DwTile16, VA, VB>(x);
  else if (x.block_a == 32 && x.block_c == 256)
    err = launch_dw_tile<T, DwTile32, VA, VB>(x);
  else if (x.block_a == 64 && x.block_c == 128)
    err = launch_dw_tile<T, DwTile64, VA, VB>(x);
  return static_cast<int>(err);
}

// The variant (operand type, A copy width, B copy width) of a launch:
// its part number, the object it is compiled in.
constexpr int dw_part(int in_dtype, int vec_a, int vec_b) {
  return 4 * (in_dtype == DT_BF16) + 2 * (vec_a ? 0 : 1) + (vec_b ? 0 : 1);
}

template <int PART>
int run_dw_part(const DwArgs& x) {
  using T = std::conditional_t<(PART >= 4), __nv_bfloat16, float>;
  return run_dw_variant<T, (PART & 2) == 0, (PART & 1) == 0>(x);
}

}  // namespace repro

#define REPRO_CAT2(a, b) a##b
#define REPRO_CAT(a, b) REPRO_CAT2(a, b)

int REPRO_CAT(repro_dw_part, REPRO_PART)(const repro::DwArgs& x) {
  return repro::run_dw_part<REPRO_PART>(x);
}

#if REPRO_PART == 0
int repro_dw_part1(const repro::DwArgs& x);
int repro_dw_part2(const repro::DwArgs& x);
int repro_dw_part3(const repro::DwArgs& x);
int repro_dw_part4(const repro::DwArgs& x);
int repro_dw_part5(const repro::DwArgs& x);
int repro_dw_part6(const repro::DwArgs& x);
int repro_dw_part7(const repro::DwArgs& x);

// block_a x block_c names the tile (core/tiling.py::DW_KERNEL_TILES);
// vec_a / vec_b pick 16-byte copies of A / B (build.dw_vector_copies).
extern "C" int repro_deconv_dw(const void* a, const void* b, void* out,
                               float* workspace, const int* geom, int splits,
                               int block_a, int block_c, int in_dtype,
                               int out_dtype, int vec_a, int vec_b,
                               void* stream) {
  using namespace repro;
  if ((in_dtype != DT_F32 && in_dtype != DT_BF16) ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16) || splits < 1 ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs x;
  int* dst = reinterpret_cast<int*>(&x.g);
  for (int i = 0; i < DW_GEOM_FIELDS; ++i) dst[i] = geom[i];
  if (x.g.rows_per_split < 1 || x.g.rows_per_split % DW_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  x.a = a;
  x.b = b;
  x.out = out;
  x.out_bf16 = out_dtype == DT_BF16;
  x.work = workspace;
  x.splits = splits;
  x.block_a = block_a;
  x.block_c = block_c;
  x.stream = static_cast<cudaStream_t>(stream);
  switch (dw_part(in_dtype, vec_a, vec_b)) {
    case 0: return repro_dw_part0(x);
    case 1: return repro_dw_part1(x);
    case 2: return repro_dw_part2(x);
    case 3: return repro_dw_part3(x);
    case 4: return repro_dw_part4(x);
    case 5: return repro_dw_part5(x);
    case 6: return repro_dw_part6(x);
    default: return repro_dw_part7(x);
  }
}
#endif
