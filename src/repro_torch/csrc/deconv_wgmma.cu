// Kernel 1's deep-channel bf16 stride-2 deconvs for Hopper, sm_90a: TMA
// boxes and wgmma over only the phase positions the crop keeps.
//
// Another route of the TPU kernel deconv_pallas_3d (src/repro/kernels/
// deconv/kernel.py, body _deconv_kernel_body), which deconv_fwd.cu
// replaces: the same polyphase deconv, for the launches the planner gives
// it (tiling.py::plan_wgmma: bf16 x bf16, more than one phase, Cin/G a
// multiple of 64, Cout/G of 16, unsplit, 16-byte aligned operands); every
// other launch runs deconv_fwd.cu's gather or halo staging (igemm.cuh),
// unchanged.  It replaces no other TPU kernel.
//
// What bounds these layers on an H100: DCGAN's deconv1-3 and V-Net's
// up1-3 do 64-512 MACs an output element from operands that fit in L2, so
// the bf16 tensor cores (989 TFLOP/s) bound them, not bytes.  The gather
// route (igemm_bf16_kernel) reached ~10 % of that peak there: mma.sync fed
// by ldmatrix (a block's shared-memory reads alone outlast its products),
// a barrier every 32-pair stage, each copy a thread's instruction.  And it
// ran each phase over the I + M - 1 positions of the Eq. (1) grid, of
// which the crop drops the last in every dim (DCGAN deconv1: 25 rows for
// 16 kept).  This kernel does the work the crop keeps, on the instruction
// that reaches the tensor cores' rate:
//
//   * a tile is one phase x 128 positions of that phase's cropped grid
//     (the positions q whose output q S + p - lo lands inside the output
//     in some phase: tiling.py::cropped_grid) x BN output channels (64 or
//     128).  Its 128 positions are one TMA box over x viewed as [N, D, H,
//     W, Cin], bn x bd x bh x bw (powers of two: DCGAN deconv1 8 items x
//     4 x 4), so a ragged grid's last boxes reach past it and their rows
//     are masked at the store;
//   * a stage is one tap x 64 input channels: A is the box at the tile's
//     origin minus the tap's offset m (A[q, (m, ci)] = x[q - m, ci]), which
//     the TMA zero-fills outside x, so no tap, border or batch edge needs
//     a mask; B is the tap's 64 rows of the phase's slab of the phase-major
//     weights, BN / 64 boxes of 64 channels (2-D TMA).  Both land with the
//     128-byte swizzle: A K-major, B N-major, as wgmma reads them;
//   * one producer warp issues the TMA loads into a ring of 3-4 stages
//     (full and empty mbarriers); two consumer warpgroups each run
//     wgmma.m64nBNk16 on their 64 rows, four k16 steps a stage, one
//     group in flight, the f32 sums in registers;
//   * the epilogue (igemm.cuh's: scale, bias, activation) runs on the
//     registers and stores two channels a lane at q S + p - lo, masked
//     where the box leaves the grid or the crop;
//   * where the boxes fill the card evenly, a work unit is every phase of
//     one box and channel tile (equal work a unit: a K 3, S 2 phase holds
//     4 / 2 / 2 / 1 taps in 2-D, 8 ... 1 in 3-D; each phase reads the
//     box's input from L2 right after the last), and blocks are
//     persistent, two an SM, a block's producer running on into its next
//     tile while its consumers store this one; else a unit is one tile, a
//     block one unit, the deepest phase's tiles first.  No atomics: a
//     launch repeats bit for bit.
//
// The sums are f32 over bf16 products, as the gather route's and the
// reference's bf16 dot with f32 sums; every tap of every kept position is
// summed, and only rows and channels that no output keeps are dropped.
//
// What still bounds it: a 128 x 128 tile reads 32 KB of A and B a stage
// for 1 M products, ~64 bytes a clock an SM at the tensor cores' rate,
// more than L2 gives every SM at once; DCGAN's deconv1-3 at batch 1,024
// run at 270-360 TFLOP/s (0.36-0.55 ms, cuDNN 0.27-0.35; the gather
// 1.27-1.46: PERF.md).  Larger tiles (256 rows, one block an SM, more
// registers for the sums) or a cluster's TMA multicast of the shared
// operand are what it leaves.
#include <cuda.h>

#include <algorithm>

#include "igemm.cuh"

namespace repro {

// A launch's staging, as the planner packs it (tiling.py::WgmmaPlan.fields).
struct WgmmaPlan {
  int bn, bd, bh, bw;   // the TMA box: positions of a tile
  int q0d, q0h, q0w;    // the cropped grid's origin
  int Pd, Ph, Pw;       // its extent
  int block_co;         // BN
  int stages;           // the ring's stages (wg::stages<BN>)
  int nphases;          // Sd * Sh * Sw
  int group;            // phases a work unit runs: 1, or all of them
  int order[8];         // phases, deepest first
};

namespace wg {

constexpr int ROWS = 128;       // positions a tile: one box, two m64 groups
constexpr int KC = 64;          // input channels a stage (128 bytes)
constexpr int BCOLS = 64;       // output channels a B box (128 bytes)
constexpr int ROW_BYTES = 128;  // a swizzled row of either operand
constexpr int A_BYTES = ROWS * ROW_BYTES;
constexpr int B_BOX_BYTES = KC * ROW_BYTES;
constexpr int MAX_PHASES = 8;
constexpr int FIELDS = 14 + MAX_PHASES;
constexpr int CONSUMERS = 2;                  // warpgroups on wgmma
constexpr int THREADS = 128 * CONSUMERS + 32; // and one producer warp
constexpr int MIN_BLOCKS = 2;
// registers a thread: the most at which MIN_BLOCKS blocks fit an SM's
// 65,536 (__launch_bounds__ with two blocks capped them at 96, where the
// 64 x 128 tile's sums and the unit loop spilled)
constexpr int REGISTERS = 65536 / (MIN_BLOCKS * THREADS) / 8 * 8;
static_assert(REGISTERS == 112, "two blocks of 288 threads an SM");
constexpr int STAGING = 2;  // the launched[2] it reports (build.STAGINGS)
static_assert(sizeof(WgmmaPlan) == FIELDS * sizeof(int), "packed plan");

// Keep in step with tiling.py::WGMMA_STAGES, wgmma_stage_bytes and
// wgmma_smem_bytes: the stages (two blocks an SM), a stage's bytes, and a
// block's dynamic shared memory (the ring, 1,024 bytes to align it to the
// swizzle's pattern, a full and an empty mbarrier a stage).
template <int BN> __host__ __device__ constexpr int stages() {
  return BN == 128 ? 3 : 4;
}
template <int BN> __host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN / BCOLS * B_BOX_BYTES;
}
template <int BN> __host__ __device__ constexpr int smem_bytes() {
  return stages<BN>() * stage_bytes<BN>() + 1024 + 16 * stages<BN>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(unsigned bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.  Built
// with -DREPRO_WGMMA_WATCHDOG (a probe's build), a wait of more than
// ~2^34 cycles traps, so a fault in the ring fails the launch instead of
// hanging the card.
__device__ __forceinline__ void bar_wait(unsigned bar, int parity) {
  unsigned done = 0;
#ifdef REPRO_WGMMA_WATCHDOG
  const long long t0 = clock64();
#endif
  do {
#ifdef REPRO_WGMMA_WATCHDOG
    if (clock64() - t0 > (1ll << 34)) asm volatile("trap;");
#endif
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA loads ------------------------------------------------------------------

__device__ __forceinline__ void tma_load_5d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// A shared-memory matrix descriptor, 128-byte swizzle: the start address,
// the leading and stride byte offsets (>> 4 each), layout type 1.  A
// (K-major) takes the 1,024 bytes of an 8-row group as its stride; B
// (N-major) the same between 8-row groups of k and 8,192 bytes (one
// 64-channel box) between groups of channels as its leading offset.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo,
                                         unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N f32 sums of a warpgroup) += A (64 x 16 bf16, K-major) * B (16
// x N bf16, N-major), both read from shared memory through descriptors.
template <int N> struct Wgmma;
template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
// The driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

}  // namespace wg

// The work: units of ``group`` tiles, a tile one phase x one box x one
// group's channel tile.  Unit u takes its channel tile from u % chans,
// its box (batch item, d, h, w; w fastest) from u / chans % boxes and its
// phases from u / (chans x boxes): the plan's order, the deepest first,
// ``group`` of them (one: a unit is a tile, the deepest phase's tiles run
// first; all: a unit runs every phase of its box, equal work a unit, the
// box's input read from L2 by each phase in turn).  The blocks running
// together share A's box.
struct WgTile {
  int p, pd, ph, pw, tap0, ntaps, grp, co0, n0, qd0, qh0, qw0;
};

// Phase k of unit u's group (a select chain: no local memory).
__device__ __forceinline__ int wg_phase(int u, int k, int units_per_group,
                                        const WgmmaPlan& pl) {
  const int i = u / units_per_group * pl.group + k;
  return i == 0 ? pl.order[0] : i == 1 ? pl.order[1] : i == 2 ? pl.order[2]
       : i == 3 ? pl.order[3] : i == 4 ? pl.order[4] : i == 5 ? pl.order[5]
       : i == 6 ? pl.order[6] : pl.order[7];
}

template <int BN>
__device__ __forceinline__ WgTile wg_tile(int u, int k, const Geom& g,
                                          const WgmmaPlan& pl,
                                          const int* taps) {
  WgTile w;
  const int Cog = g.Co / g.G;
  const int co_tiles = (Cog + BN - 1) / BN, chans = g.G * co_tiles;
  const int nbw = (pl.Pw + pl.bw - 1) / pl.bw;
  const int nbh = (pl.Ph + pl.bh - 1) / pl.bh;
  const int nbd = (pl.Pd + pl.bd - 1) / pl.bd;
  const int boxes = (g.N + pl.bn - 1) / pl.bn * nbd * nbh * nbw;
  w.p = wg_phase(u, k, boxes * chans, pl);
  w.grp = u % chans / co_tiles;
  w.co0 = u % chans % co_tiles * BN;
  int t = u / chans % boxes;
  w.qw0 = pl.q0w + t % nbw * pl.bw;
  t /= nbw;
  w.qh0 = pl.q0h + t % nbh * pl.bh;
  t /= nbh;
  w.qd0 = pl.q0d + t % nbd * pl.bd;
  w.n0 = t / nbd * pl.bn;
  w.pw = w.p % g.Sw;
  w.ph = w.p / g.Sw % g.Sh;
  w.pd = w.p / (g.Sw * g.Sh);
  w.tap0 = taps[2 * w.p];
  w.ntaps = taps[2 * w.p + 1];
  return w;
}

// Units per phase group: boxes x channel tiles.
template <int BN>
__host__ __device__ __forceinline__ int wg_units_per_group(
    const Geom& g, const WgmmaPlan& pl) {
  const int co_tiles = (g.Co / g.G + BN - 1) / BN;
  return (g.N + pl.bn - 1) / pl.bn * ((pl.Pd + pl.bd - 1) / pl.bd) *
         ((pl.Ph + pl.bh - 1) / pl.bh) * ((pl.Pw + pl.bw - 1) / pl.bw) *
         g.G * co_tiles;
}

// Block b runs units b, b + gridDim.x, ... (persistent, two blocks an SM,
// where a unit is every phase of a box; else one unit a block), its
// producer and consumers walking one ring across them, so the next tile's
// loads fill the ring while this tile's epilogue runs.
template <int BN>
__global__ void __maxnreg__(wg::REGISTERS)
igemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const int* __restrict__ taps, Epi ep,
                        void* __restrict__ y, int out_bf16, Geom g,
                        WgmmaPlan pl, int units) {
  constexpr int ST = wg::stages<BN>();
  constexpr int SB = wg::stage_bytes<BN>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring at the next 1,024-byte boundary (the swizzle's pattern), then
  // the full and the empty barrier of each stage
  const unsigned ring = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned full0 = ring + ST * SB, empty0 = full0 + 8 * ST;
  const int Cig = g.Ci / g.G, Cog = g.Co / g.G;
  const int chunks = Cig / wg::KC;
  const int* tapm = taps + 2 * g.Sd * g.Sh * g.Sw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      wg::bar_init(full0 + 8 * s, 1);
      wg::bar_init(empty0 + 8 * s, wg::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * wg::CONSUMERS) {
    // the producer: one lane issues each stage's loads once its slot is
    // free; a tile's stage s is tap s / chunks, channels (s % chunks) x 64
    if (lane == 0) {
      wg::tma_prefetch(&tx);
      wg::tma_prefetch(&tw);
      int it = 0;     // stages issued, over all of this block's tiles
      for (int u = blockIdx.x; u < units; u += gridDim.x)
      for (int k = 0; k < pl.group; ++k) {
        const WgTile w = wg_tile<BN>(u, k, g, pl, taps);
        const int nst = w.ntaps * chunks;
        for (int s = 0; s < nst; ++s, ++it) {
          const int slot = it % ST, use = it / ST;
          if (use > 0) wg::bar_wait(empty0 + 8 * slot, (use - 1) & 1);
          const unsigned full = full0 + 8 * slot, dst = ring + slot * SB;
          wg::bar_expect_tx(full, SB);
          const int tp = s / chunks, kc = s - tp * chunks;
          const int* m = tapm + 3 * (w.tap0 + tp);
          wg::tma_load_5d(dst, &tx, full, w.grp * Cig + kc * wg::KC,
                          w.qw0 - m[2], w.qh0 - m[1], w.qd0 - m[0], w.n0);
          const int krow = (w.tap0 + tp) * Cig + kc * wg::KC;
#pragma unroll
          for (int hb = 0; hb < BN / wg::BCOLS; ++hb)
            wg::tma_load_2d(dst + wg::A_BYTES + hb * wg::B_BOX_BYTES, &tw,
                            full, w.grp * Cog + w.co0 + hb * wg::BCOLS, krow);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wgi owns rows [64 wgi, 64 wgi + 64) of each
  // tile; a stage's four k16 steps advance A by 32 bytes inside its
  // swizzled rows and B by 16 rows (2,048 bytes)
  const int wgi = warp >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  int it = 0;         // stages consumed, as the producer counts them
  const int upg = wg_units_per_group<BN>(g, pl);
  for (int u = blockIdx.x; u < units; u += gridDim.x)
  for (int k = 0; k < pl.group; ++k) {
    const int nst = taps[2 * wg_phase(u, k, upg, pl) + 1] * chunks;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < nst; ++s, ++it) {
      const int slot = it % ST;
      wg::bar_wait(full0 + 8 * slot, (it / ST) & 1);
      const unsigned base = ring + slot * SB;
      const uint64_t da = wg::desc(base + wgi * 64 * wg::ROW_BYTES, 16, 1024);
      const uint64_t db = wg::desc(base + wg::A_BYTES, wg::B_BOX_BYTES, 1024);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < wg::KC / 16; ++kk)
        wg::Wgmma<BN>::mma(acc, da + 2 * kk, db + 128 * kk);
      wg::wgmma_commit();
      // the previous stage's products are done: free its slot
      wg::wgmma_wait<1>();
      if (s > 0 && leader) wg::bar_arrive(empty0 + 8 * ((it - 1) % ST));
    }
    wg::wgmma_wait<0>();
    if (nst > 0 && leader) wg::bar_arrive(empty0 + 8 * ((it - 1) % ST));

    // the epilogue from the registers: sum i of a lane holds row (warp %
    // 4) x 16 + lane / 4 (+ 8 for i % 4 >= 2) of its warpgroup's 64 and
    // channel 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile
    const WgTile w = wg_tile<BN>(u, k, g, pl, taps);
    const int64_t co_base = (int64_t)w.grp * Cog;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = wgi * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
      const int iw = r % pl.bw;
      r /= pl.bw;
      const int ih = r % pl.bh;
      r /= pl.bh;
      const int id = r % pl.bd;
      const int n = w.n0 + r / pl.bd;
      const int od = (w.qd0 + id) * g.Sd + w.pd - g.lod;
      const int oh = (w.qh0 + ih) * g.Sh + w.ph - g.loh;
      const int ow = (w.qw0 + iw) * g.Sw + w.pw - g.low;
      if (n >= g.N || (unsigned)od >= (unsigned)g.Od ||
          (unsigned)oh >= (unsigned)g.Oh || (unsigned)ow >= (unsigned)g.Ow)
        continue;
      const int64_t out =
          ((((int64_t)n * g.Od + od) * g.Oh + oh) * g.Ow + ow) * g.Co +
          co_base;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = w.co0 + 8 * j + 2 * (lane & 3);  // Cog: a multiple of 16
        if (c >= Cog) continue;
        const float v0 = epilogue(acc[4 * j + 2 * h], ep, (int)co_base + c);
        const float v1 =
            epilogue(acc[4 * j + 2 * h + 1], ep, (int)co_base + c + 1);
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) +
                                             out + c) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(y) + out + c) =
              make_float2(v0, v1);
      }
    }
  }
}

namespace wg {

// The launch: x's 5-D map ([N, D, H, W, Ci], boxes of 64 channels x bw x
// bh x bd x bn) and the weights' 2-D map ([prod(K) Cin/G, Co], boxes of 64
// x 64), both with the 128-byte swizzle and zeros outside the tensor.
template <int BN>
cudaError_t launch(const void* x, const void* w, const int* taps,
                   const Epi& ep, void* y, int out_bf16, const Geom& g,
                   const WgmmaPlan& pl, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t ci = g.Ci;
  const cuuint64_t xdim[5] = {ci, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.D, (cuuint64_t)g.N};
  const cuuint64_t xstride[4] = {2 * ci, 2 * ci * g.W, 2 * ci * g.W * g.H,
                                 2 * ci * g.W * g.H * g.D};
  const cuuint32_t xbox[5] = {KC, (cuuint32_t)pl.bw, (cuuint32_t)pl.bh,
                              (cuuint32_t)pl.bd, (cuuint32_t)pl.bn};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t wdim[2] = {(cuuint64_t)g.Co,
                              (cuuint64_t)g.Kd * g.Kh * g.Kw * (g.Ci / g.G)};
  const cuuint64_t wstride[1] = {2 * (cuuint64_t)g.Co};
  const cuuint32_t wbox[2] = {BCOLS, KC};
  CUtensorMap tx, tw;
  if (enc(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
          xdim, xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
          wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = igemm_bf16_wgmma_kernel<BN>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, smem_bytes<BN>(), smem_set);
  if (err != cudaSuccess) return err;
  const int64_t units = (int64_t)wg_units_per_group<BN>(g, pl) *
                        (pl.nphases / pl.group);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int sm_count[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && sm_count[dev]) {
    sms = sm_count[dev];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sm_count[dev] = sms;
  }
  const int64_t blocks = pl.group == 1
      ? units : std::min<int64_t>(units, (int64_t)sms * MIN_BLOCKS);
  kernel<<<(unsigned)blocks, THREADS, smem_bytes<BN>(), stream>>>(
      tx, tw, taps, ep, y, out_bf16, g, pl, (int)units);
  return cudaGetLastError();
}

// Whether a plan is one this source's kernels take for geometry g.
inline bool plan_ok(const Geom& g, const WgmmaPlan& pl, const void* x,
                    const void* w, const void* y) {
  const int phases = g.Sd * g.Sh * g.Sw;
  if (g.G < 1 || g.Ci % g.G || g.Co % g.G || (g.Ci / g.G) % KC ||
      (g.Co / g.G) % 16 || g.splits != 1 || phases < 2 ||
      phases > MAX_PHASES || pl.nphases != phases || g.N < 1)
    return false;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return false;
  const int box[4] = {pl.bn, pl.bd, pl.bh, pl.bw};
  for (int b : box)
    if (b < 1 || b > 256) return false;
  if (pl.bn * pl.bd * pl.bh * pl.bw != ROWS || pl.Pd < 1 || pl.Ph < 1 ||
      pl.Pw < 1 || pl.q0d < 0 || pl.q0h < 0 || pl.q0w < 0)
    return false;
  for (int i = 0; i < phases; ++i)
    if (pl.order[i] < 0 || pl.order[i] >= phases) return false;
  if (pl.group != 1 && pl.group != phases) return false;
  // units (and tiles) in 32 bits
  const int co_tiles = (g.Co / g.G + pl.block_co - 1) / pl.block_co;
  const int64_t units = (int64_t)((g.N + pl.bn - 1) / pl.bn) *
                        ((pl.Pd + pl.bd - 1) / pl.bd) *
                        ((pl.Ph + pl.bh - 1) / pl.bh) *
                        ((pl.Pw + pl.bw - 1) / pl.bw) * g.G * co_tiles *
                        phases;
  if (units > 0x7fffffff) return false;
  if (pl.block_co == 128) return pl.stages == stages<128>();
  if (pl.block_co == 64) return pl.stages == stages<64>();
  return false;
}

}  // namespace wg
}  // namespace repro

// The wgmma staging of deconv_fwd.cu's C entry repro_deconv_fwd, which
// calls this where the planner chose it (its wgmma argument is the plan).
// x [N, D, H, W, Ci] and w_taps [prod(K), Ci/G, Co] (phase-major) bf16,
// 16-byte aligned; taps the deconv kernel's tap table
// (common.tap_table); geom igemm.cuh's Geom (splits 1); plan
// int[wg::FIELDS] (tiling.py::WgmmaPlan.fields).  launched (int[3], or
// null) receives the kernel's route, passes and staging: LAUNCHED_BF16,
// 1, wg::STAGING (igemm.cuh::Launched; build.STAGINGS).
int repro_deconv_wgmma(const void* x, const void* w_taps, const int* taps,
                       const float* scale, const float* bias, void* y,
                       const int* geom, const int* plan, int act,
                       float alpha, int out_dtype, int* launched,
                       void* stream) {
  using namespace repro;
  if (launched) launched[0] = launched[1] = launched[2] = -1;
  if (!x || !w_taps || !taps || !y || !geom || !plan ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  WgmmaPlan pl;
  int* gd = reinterpret_cast<int*>(&g);
  for (int i = 0; i < GEOM_FIELDS; ++i) gd[i] = geom[i];
  int* pd = reinterpret_cast<int*>(&pl);
  for (int i = 0; i < wg::FIELDS; ++i) pd[i] = plan[i];
  if (!wg::plan_ok(g, pl, x, w_taps, y))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epi ep{scale, bias, act, alpha};
  const int out_bf16 = out_dtype == DT_BF16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pl.block_co == 128
          ? wg::launch<128>(x, w_taps, taps, ep, y, out_bf16, g, pl, s)
          : wg::launch<64>(x, w_taps, taps, ep, y, out_bf16, g, pl, s);
  if (err == cudaSuccess && launched) {
    launched[0] = LAUNCHED_BF16;
    launched[1] = 1;
    launched[2] = wg::STAGING;
  }
  return static_cast<int>(err);
}
