// Fused grouped-expert SwiGLU for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces repro/kernels/moe_gemm.py::fused_moe_ffn, the Pallas TPU kernel
// of the MoE layer.  It computes the same function, for every expert e over
// its capacity-padded rows:
//   x      [E, C, d]    f32 or bf16 (per-expert buffers)
//   w_gate [E, d, ff],  w_up [E, d, ff],  w_down [E, ff, d]   same dtype
//   counts [E] int32 or null: expert e holds rows 0 .. counts[e]-1 (null: C)
//   out[e, c] = (silu(x[e, c] @ w_gate[e]) * (x[e, c] @ w_up[e])) @ w_down[e]
//               for c < counts[e], exact zeros for the rows past it
// with f32 accumulation; the hidden is rounded to x's dtype before the down
// projection, as the Pallas kernel does.  A row past counts[e] costs no load
// and no product (at the granularity below): an expert that holds no row
// reads no weights, and whatever x holds there never reaches a live row.
//
// What bounds it on an H100.  bf16 at the serve path's shapes (olmoe-1b-7b:
// E=64, C=88, d=2048, ff=1024) reads 805 MB of expert weights for 70.9 GFLOP:
// ~88 flops per weight byte against the card's ~295, so device-memory bytes
// bound it (0.254 ms at 3.35 TB/s), and on a decode tick, with a few live
// rows per expert, it is the weights of the experts that hold any row.  f32
// runs on the tensor cores in split TF32 (three TF32 products per product,
// below); at its ~165 TFLOP/s of f32 products the same shapes are bound by
// bytes too, and not by the 67 TFLOP/s of the CUDA cores.
//
// The Pallas kernel keeps a [Ct, d] f32 accumulator in VMEM (1 MB at
// 128 x 2048) across ff blocks; a Hopper SM has 227 KB.  So a call is two
// launches of one kernel: the first writes h = silu(x Wg) * (x Wu) in x's
// dtype to a scratch the wrapper allocates, the second computes out = h Wd.
//
// Swap AB.  Tokens are the N dimension of the products and weights the M
// dimension: gate/up computes h^T[ff tile, tokens] = Wg^T x^T and Wu^T x^T,
// down computes out^T[d tile, tokens] = Wd^T h^T.  The weights, [E, K, M]
// with M contiguous, are read MN-major; x and h are K-major.  A token tile
// of C=88 rows is one product 96 wide, with no padding to 128 rows.
//
// bf16: wgmma + TMA, warp specialised (moe_wgmma_kernel).  A block is one
// producer warpgroup, of which one thread issues TMA copies into a ring of 4
// stages, and two consumer warpgroups of 64 weight columns x 2 products each
// (gate/up: the gate and up tiles of 64 ff columns; down: two tiles of 64 d
// columns), 128 ff or 256 d columns a block, up to 96 tokens: C=88 is one
// tile, and the two accumulators stay at 96 registers (a 128-token tile
// spilled, and with the ring filling shared memory the spills went to L2).
// A stage is 4 weight boxes of [64 depth x 64 columns] (32 KB) and the token
// tile [96 rows x 64 depth] (12 KB), 128-byte swizzled as TMA writes them
// and wgmma reads them.  Two blocks form a cluster over neighbouring column
// tiles of one expert and token tile: each loads half of the token tile's
// live 8-row groups and multicasts it to both, so the activation leaves L2
// once a cluster.  A slot is free when the consumers of both blocks
// released it; each releases it as soon as its products are done.  The grid
// is persistent: cluster c takes tiles c, c + clusters, ... (token tile
// fastest, so that the clusters that share a weight tile run together and
// L2 serves the second).  Per tile: live = counts[e] - t0; a tile with none
// issues nothing (down: its rows are written as zeros), only the live 8-row
// groups are copied (the rest of the stage keeps stale data, which reaches
// only dead token columns and is masked), and the product width is the
// least of 16, 32, 64 or 96 that covers the live rows.  The epilogue rounds
// to bf16 once, stages each 64-column slice through a swizzled shared
// buffer (a thread's fragments run along the weight columns) and writes
// rows of 16-byte stores.

// f32: split TF32 on mma.sync (moe_f32_kernel).  Each product a*b becomes
// hi(a)hi(b) + hi(a)lo(b) + lo(a)hi(b), hi = rna_tf32(v), lo =
// rna_tf32(v - hi), on mma.sync.m16n8k8 TF32 with f32 accumulation: the
// dropped lo*lo term is ~2^-22 of each product, inside the f32 check (one
// TF32 product alone is not).  A block of 8 warps takes 64 tokens x 128
// weight columns (gate/up: 64 ff columns of each of Wg and Wu); the threads
// stage a 4-deep ring of [32 depth x 128 columns] weight and [64 x 32] token
// tiles with cp.async (rows past the live count are not copied) and load
// their own fragments, rows padded so that they hit distinct banks.  A warp
// takes 16 columns of each of its two products and every other 8-token
// block, so both halves share a partly live tile, and computes only its
// live blocks, in straight-line code for each count (the three dependent
// products of each block interleave with the other blocks' instead of
// waiting on each other).  The tiles are smaller than bf16's because
// mma.sync's are; wgmma's TF32 form would want both operands K-major in
// shared memory, which the weights are not.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Rows expert e holds: counts[e] clamped to [0, C], or C without counts.
__device__ __forceinline__ int live_rows(const int* counts, int e, int C) {
  if (counts == nullptr) return C;
  return min(max(counts[e], 0), C);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA

constexpr int kTok = 96;                      // token tile (rows)
constexpr int kBK = 64;                       // depth of a stage: 128 B of bf16
constexpr int kStages = 4;
constexpr int kRegion = 64 * 128;             // a weight box: 64 depth x 64 columns
constexpr int kActBytes = kTok * 128;         // the token tile of a stage
constexpr int kStageBytes = 4 * kRegion + kActBytes;   // 44 KB
constexpr int kGroupBytes = 8 * 128;          // 8 token rows x 64 depth
constexpr int kOutBytes = kTok * 128;         // a warpgroup's epilogue buffer
constexpr int kWgThreads = 384;               // 2 consumer warpgroups + producer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr size_t kWgSmem = 1024 /* alignment */ + size_t(kStages) * kStageBytes +
                           2 * kOutBytes + 2 * kStages * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive on the barrier at the same offset in block `cta` of the cluster.
// Release at CTA scope, the default: the slot's readers are wgmma products
// that have completed (the async proxy), so nothing of the generic proxy
// needs ordering, and ".release.cluster" compiles to a GPU-scope MEMBAR on
// every stage (it cost ~20% of the kernel's time at jamba's shape).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that lasts ~10 s traps, so a lost arrival fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
                   : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The same copy into every block of `mask`, at the same offset, each block's
// barrier at that offset counting the bytes.
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// 8-row groups 1024 B apart (SBO).  The leading offset is unused here: a
// K-major token tile's k16 step stays inside its 128-byte rows, and an
// MN-major weight tile is 64 columns, one swizzle atom wide.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across the wgmma
// fence/wait (the asm above names no registers).
template <int R> __device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] . B[16 x N]: A (weights) MN-major (transpose bit),
// B (tokens) K-major, both from shared memory, f32 accumulators.
#define MOE_D8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : MOE_D8(0)
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : MOE_D8(0), MOE_D8(8)
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : MOE_D8(0), MOE_D8(8), MOE_D8(16), MOE_D8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
        : MOE_D8(0), MOE_D8(8), MOE_D8(16), MOE_D8(24), MOE_D8(32), MOE_D8(40)
        : "l"(a), "l"(b), "r"(1));
  }
};
#undef MOE_D8

// Where a tile of the persistent walk lies.  Tiles are numbered token tile
// fastest, then column-tile pair, then expert; block `rank` of a cluster
// takes column tile 2 * pair + rank, a ghost when that lies past the end
// (an odd number of column tiles).
struct Tile {
  int e, t0, live, c0;
  bool ghost;
};

template <bool GLU>
__device__ __forceinline__ Tile tile_at(int i, int rank, const int* counts, int C,
                                        int ncols, int pairs, int ttiles) {
  constexpr int kCols = GLU ? 128 : 256;
  Tile t;
  const int tt = i % ttiles, rest = i / ttiles;
  t.e = rest / pairs;
  t.t0 = tt * kTok;
  t.live = min(live_rows(counts, t.e, C) - t.t0, kTok);
  t.c0 = (2 * (rest % pairs) + rank) * kCols;
  t.ghost = t.c0 >= ncols;
  return t;
}

// Release a ring slot: one arrival per consumer warp on this block's
// barrier and on the peer's, whose producer also writes into this slot.
__device__ __forceinline__ void release_slot(uint64_t* empty, uint32_t peer) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(empty);
    mbar_arrive_cluster(empty, peer);
  }
}

// One consumer warpgroup's pass over a live tile at product width N: the
// depth loop over the ring, then the epilogue.  `col0` is the first output
// column of the warpgroup (64 of them in gate/up, 128 in down); `idle`: the
// warpgroup's columns lie past the end, so it only keeps pace with the ring.
template <int N, bool GLU>
__device__ __forceinline__ void consume_tile(unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, uint32_t peer, int& it,
                                             int k_tiles, bool idle, int wg,
                                             unsigned char* stage_out,
                                             __nv_bfloat16* __restrict__ out,
                                             size_t row0, int rows, int live,
                                             int col0, int ncols) {
  float acc[2][N / 2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[a][i] = 0.f;
  const int ra = GLU ? wg : 2 * wg;         // weight boxes of the two products
  const int rb = GLU ? 2 + wg : 2 * wg + 1;
  for (int kt = 0; kt < k_tiles; ++kt, ++it) {
    const int slot = it % kStages;
    mbar_wait(&full[slot], (it / kStages) & 1);
    if (!idle) {
      const uint32_t st = smem_u32(ring + slot * kStageBytes);
      const uint32_t a0 = st + ra * kRegion, a1 = st + rb * kRegion;
      const uint32_t b = st + 4 * kRegion;
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 16 depth rows (2048 B) a step; B: 32 B inside each token row
        Wgmma<N>::mma(acc[0], wg_desc(a0 + kk * 2048), wg_desc(b + kk * 32));
        Wgmma<N>::mma(acc[1], wg_desc(a1 + kk * 2048), wg_desc(b + kk * 32));
      }
      wgmma_commit();
      // the products are short beside a stage's copies: free the slot as
      // soon as they are done, so that the most copies stay in flight
      wgmma_wait0();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
    }
    release_slot(&empty[slot], peer);
  }
  if (idle) return;

  // Epilogue.  Element 4j + e of a thread's accumulator is weight column
  // 16 * warp + gid + 8 * (e >> 1) and token 8j + 2 * tig + (e & 1): it is
  // staged as [token][64 columns] bf16, 16-byte chunk c of row r at
  // c ^ (r & 7), then written out a row of 16-byte stores at a time.
  const int wl = threadIdx.x & 127, warp = wl >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned char* stg = stage_out + wg * kOutBytes;
  const int bar = 1 + wg;
  constexpr int kPasses = GLU ? 1 : 2;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * warp + gid + 8 * (e >> 1);
        const int tok = 8 * j + 2 * tig + (e & 1);
        float v = GLU ? silu(acc[0][4 * j + e]) * acc[1][4 * j + e]
                      : acc[pass][4 * j + e];
        if (tok >= live) v = 0.f;
        *reinterpret_cast<__nv_bfloat16*>(stg + tok * 128 +
                                          (((m >> 3) ^ (tok & 7)) << 4) +
                                          (m & 7) * 2) = __float2bfloat16(v);
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    const int col = col0 + 64 * pass;
    if (col >= ncols) continue;
    // gate/up: rows past N are never read; down: they are zeros
    const int n_rows = GLU ? min(rows, N) : rows;
    for (int c = wl; c < n_rows * 8; c += 128) {
      const int tok = c >> 3, ch = c & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (tok < N)
        v = *reinterpret_cast<const uint4*>(stg + tok * 128 + ((ch ^ (tok & 7)) << 4));
      *reinterpret_cast<uint4*>(out + (row0 + tok) * ncols + col + ch * 8) = v;
    }
  }
}

// Gate/up (GLU: act = x, w0 = Wg, w1 = Wu, out = h [E, C, ff], ncols = ff)
// or down (act = h, w0 = Wd, out [E, C, d], ncols = d); k_tiles steps of
// kBK depth.  Launched as clusters of 2 blocks, gridDim.x = 2 * clusters.
template <bool GLU>
__global__ void __launch_bounds__(kWgThreads, 1)
moe_wgmma_kernel(const __grid_constant__ CUtensorMap act_map,
                 const __grid_constant__ CUtensorMap w0_map,
                 const __grid_constant__ CUtensorMap w1_map,
                 const int* __restrict__ counts, __nv_bfloat16* __restrict__ out,
                 int E, int C, int ncols, int k_tiles) {
  constexpr int kCols = GLU ? 128 : 256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* stage_out = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + 2 * kOutBytes);
  uint64_t* empty = full + kStages;

  const uint32_t rank = cluster_rank(), peer = rank ^ 1u;
  const int cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int col_tiles = (ncols + kCols - 1) / kCols;
  const int pairs = (col_tiles + 1) / 2;
  const int ttiles = (C + kTok - 1) / kTok;
  const int total = E * pairs * ttiles;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 16);   // 8 consumer warps in each block of the pair
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int warp = threadIdx.x >> 5;
  if (warp >= 8) {
    // ---- producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int i = cluster; i < total; i += clusters) {
        const Tile t = tile_at<GLU>(i, rank, counts, C, ncols, pairs, ttiles);
        if (t.live <= 0) continue;
        const int groups = (t.live + 7) / 8;
        int boxes = 0;    // live weight boxes: columns inside ncols
        if (!t.ghost)
          boxes = GLU ? 4 : min(4, (ncols - t.c0) / 64);
        const uint32_t bytes = boxes * kRegion + groups * kGroupBytes;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int slot = it % kStages;
          if (it >= kStages) mbar_wait(&empty[slot], ((it / kStages) - 1) & 1);
          unsigned char* st = ring + slot * kStageBytes;
          mbar_expect_tx(&full[slot], bytes);
          const int k0 = kt * kBK;
          for (int b = 0; b < boxes; ++b) {
            const CUtensorMap* map = GLU && b >= 2 ? &w1_map : &w0_map;
            const int col = t.c0 + 64 * (GLU ? (b & 1) : b);
            tma_load_3d(st + b * kRegion, map, &full[slot], col, k0, t.e);
          }
          for (int g = rank; g < groups; g += 2)
            tma_load_3d_multicast(st + 4 * kRegion + g * kGroupBytes, &act_map,
                                  &full[slot], k0, t.t0 + 8 * g, t.e, 0x3);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes 64 (gate/up) or 128 (down) columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2;
    int it = 0;
    for (int i = cluster; i < total; i += clusters) {
      const Tile t = tile_at<GLU>(i, rank, counts, C, ncols, pairs, ttiles);
      const int col0 = t.c0 + (GLU ? 64 : 128) * wg;
      const int rows = min(kTok, C - t.t0);
      const size_t row0 = (size_t)t.e * C + t.t0;
      if (t.live <= 0) {
        // no live row: gate/up has nothing to write; down writes zeros
        if (!GLU && col0 < ncols)
          for (int c = threadIdx.x & 127; c < rows * 16; c += 128)
            *reinterpret_cast<uint4*>(out + (row0 + (c >> 4)) * ncols + col0 +
                                      (c & 15) * 8) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const bool idle = t.ghost || col0 >= ncols;
#define MOE_CONSUME(N)                                                          \
  consume_tile<N, GLU>(ring, full, empty, peer, it, k_tiles, idle, wg, stage_out, \
                       out, row0, rows, t.live, col0, ncols)
      if (t.live <= 16)
        MOE_CONSUME(16);
      else if (t.live <= 32)
        MOE_CONSUME(32);
      else if (t.live <= 64)
        MOE_CONSUME(64);
      else
        MOE_CONSUME(96);
#undef MOE_CONSUME
    }
  }
  // no block exits while its peer may still copy into it or arrive on it
  cluster_sync();
}

// ---------------------------------------------------------------------------
// f32: split TF32 on mma.sync

constexpr int kF32Threads = 256;
constexpr int kF32Tok = 64;
constexpr int kF32BK = 32;
constexpr int kF32Stages = 4;
constexpr int kAS = 128 + 8;   // weight row stride (floats): distinct banks
constexpr int kXS = 32 + 4;    // token row stride (floats)
constexpr int kAElems = kF32BK * kAS;
constexpr int kXElems = kF32Tok * kXS;
constexpr int kF32Stage = kAElems + kXElems;
constexpr size_t kF32Smem = size_t(kF32Stages) * kF32Stage * sizeof(float);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo to ~2^-22 of v, hi = rna_tf32(v) and lo = rna_tf32(v - hi):
// rounding to nearest, ties away, to TF32 adds half of the 13 dropped bits
// to the bit pattern (the values of cvt.rna.tf32.f32, which on sm_90 costs
// about twice the instructions for its NaN and infinity checks; no input
// that reaches a live output is either).  The tensor cores read only a TF32
// operand's upper 19 bits, so hi and lo go to them unmasked, and hi is
// masked only to form the remainder.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in split TF32: the two cross terms, then hi . hi.
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          const uint32_t (&b_hi)[2],
                                          const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// One stage's products for a warp with NB live 8-token blocks: `pa`, `pb`
// point at the warp's first weight element of its two products (depth row
// tig, column gid), `xs` at its first token row's (token 8 * half + gid,
// depth tig); block j's tokens are 16 rows further on each.
template <int NB>
__device__ __forceinline__ void f32_step(float (&acc)[2][4][4], const float* pa,
                                         const float* pb, const float* xs) {
#pragma unroll
  for (int ks = 0; ks < kF32BK / 8; ++ks) {
    // A[m][k] = W[k][m]: rows gid, gid + 8 of 16 columns; depth tig, tig + 4
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float* p = (a ? pb : pa) + ks * 8 * kAS;
      split_tf32(p[0], a_hi[a][0], a_lo[a][0]);
      split_tf32(p[8], a_hi[a][1], a_lo[a][1]);
      split_tf32(p[4 * kAS], a_hi[a][2], a_lo[a][2]);
      split_tf32(p[4 * kAS + 8], a_hi[a][3], a_lo[a][3]);
    }
    // B[k][n] = x[n][k]: depth tig, tig + 4 of each block's token gid
    uint32_t b_hi[NB][2], b_lo[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* q = xs + 16 * j * kXS + ks * 8;
      split_tf32(q[0], b_hi[j][0], b_lo[j][0]);
      split_tf32(q[4], b_hi[j][1], b_lo[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mma_split(acc[0][j], a_hi[0], a_lo[0], b_hi[j], b_lo[j]);
      mma_split(acc[1][j], a_hi[1], a_lo[1], b_hi[j], b_lo[j]);
    }
  }
}

// Gate/up (GLU: act = x, w0 = Wg, w1 = Wu, out = h, ncols = ff; a block
// takes 64 ff columns of each) or down (act = h, w0 = Wd, ncols = d; 128 d
// columns).  Grid (token tiles, column tiles, E).
template <bool GLU>
__global__ void __launch_bounds__(kF32Threads, 2)
moe_f32_kernel(const float* __restrict__ act, const float* __restrict__ w0,
               const float* __restrict__ w1, const int* __restrict__ counts,
               float* __restrict__ out, int C, int K, int ncols, int k_tiles) {
  constexpr int kCols = GLU ? 64 : 128;
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.z, t0 = blockIdx.x * kF32Tok, c0 = blockIdx.y * kCols;
  const int live = min(live_rows(counts, e, C) - t0, kF32Tok);
  const int rows = min(kF32Tok, C - t0);
  out += ((size_t)e * C + t0) * ncols + c0;
  if (live <= 0) {
    // no live row: gate/up has nothing to write; down writes zeros
    if (!GLU)
      for (int c = threadIdx.x; c < rows * 32; c += kF32Threads)
        *reinterpret_cast<float4*>(out + (size_t)(c >> 5) * ncols + (c & 31) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  act += ((size_t)e * C + t0) * K;
  w0 += (size_t)e * K * ncols + c0;
  if (GLU) w1 += (size_t)e * K * ncols + c0;

  // Stage the depth slice k0 .. k0 + 31: weights [32][128 columns], then
  // the live token rows [64][32].
  auto load = [&](int slot, int k0) {
    float* as = sm + slot * kF32Stage;
    float* xs = as + kAElems;
    for (int c = threadIdx.x; c < kF32BK * 32; c += kF32Threads) {
      const int r = c >> 5, ch = c & 31;
      const float* src = GLU && ch >= 16 ? w1 + (size_t)(k0 + r) * ncols + (ch - 16) * 4
                                         : w0 + (size_t)(k0 + r) * ncols + ch * 4;
      cp_async16(as + r * kAS + ch * 4, src);
    }
    for (int c = threadIdx.x; c < live * 8; c += kF32Threads) {
      const int r = c >> 3, ch = c & 7;
      cp_async16(xs + r * kXS + ch * 4, act + (size_t)r * K + k0 + ch * 4);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mp = warp & 3, half = warp >> 2;        // columns, token blocks
  const int ma = GLU ? 16 * mp : 32 * mp;           // shared columns of the
  const int mb = GLU ? 64 + 16 * mp : 32 * mp + 16; // two products
  // live 8-token blocks of this warp: blocks 2j + half, j < nblk
  const int nblk = max(0, ((live + 7) / 8 - half + 1) / 2);

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < k_tiles) load(s, s * kF32BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    // refill the slot every warp finished reading in step kt - 1
    const int nk = kt + kF32Stages - 1;
    if (nk < k_tiles) load(nk % kF32Stages, nk * kF32BK);
    cp_async_commit();
    const float* as = sm + (kt % kF32Stages) * kF32Stage;
    const float* xs = as + kAElems + (8 * half + gid) * kXS + tig;
    const float* pa = as + tig * kAS + ma + gid;
    const float* pb = as + tig * kAS + mb + gid;
    switch (nblk) {
      case 4: f32_step<4>(acc, pa, pb, xs); break;
      case 3: f32_step<3>(acc, pa, pb, xs); break;
      case 2: f32_step<2>(acc, pa, pb, xs); break;
      case 1: f32_step<1>(acc, pa, pb, xs); break;
      default: break;
    }
  }
  cp_async_wait<0>();

  // Element i of acc[a][j] is column (a ? mb : ma) + gid + 8 * (i >> 1),
  // token 8 * (2j + half) + 2 * tig + (i & 1).
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = 8 * (2 * j + half) + 2 * tig + (i & 1);
      if (tok >= rows) continue;
      const int m = gid + 8 * (i >> 1);
      float* row = out + (size_t)tok * ncols;
      if (GLU) {
        if (tok < live) row[16 * mp + m] = silu(acc[0][j][i]) * acc[1][j][i];
      } else {
        row[ma + m] = tok < live ? acc[0][j][i] : 0.f;
        row[mb + m] = tok < live ? acc[1][j][i] : 0.f;
      }
    }
}

// ---------------------------------------------------------------------------
// Host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The TMA map of a bf16 array [outer, rows, inner] (inner contiguous), box
// [1, box_rows, 64], 128-byte swizzle; elements past the array read as 0.
int tensor_map(CUtensorMap* map, const void* base, int inner, int rows, int outer,
               int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <bool GLU>
int launch_wgmma(const CUtensorMap& act, const CUtensorMap& w0, const CUtensorMap& w1,
                 const int* counts, __nv_bfloat16* out, int E, int C, int ncols,
                 int k_tiles, cudaStream_t stream) {
  auto kernel = moe_wgmma_kernel<GLU>;
  int err = set_smem(kernel, kWgSmem);
  if (err) return err;
  // setmaxnreg moves registers inside the block's allocation: the consumers'
  // raise must fit in what the launch allocates, or they would wait forever
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  if (attr.numRegs * kWgThreads < 128 * (2 * kConsumerRegs + kProducerRegs))
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 2;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // as many clusters as the card holds at once (each walks its tiles)
  static int resident[2] = {0, 0};
  if (resident[GLU] == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cfg.gridDim = dim3(sms > 1 ? sms / 2 * 2 : 2);
    int n = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err) return err;
    resident[GLU] = n > 0 ? n : 1;
  }
  const int kCols = GLU ? 128 : 256;
  const int pairs = ((ncols + kCols - 1) / kCols + 1) / 2;
  const long long total = (long long)E * pairs * ((C + kTok - 1) / kTok);
  const int clusters = (int)(total < resident[GLU] ? total : resident[GLU]);
  cfg.gridDim = dim3(2 * clusters);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, act, w0, w1, counts, out, E, C, ncols,
                                k_tiles);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <bool GLU>
int launch_f32(const float* act, const float* w0, const float* w1, const int* counts,
               float* out, int E, int C, int K, int ncols, int k_tiles,
               cudaStream_t stream) {
  auto kernel = moe_f32_kernel<GLU>;
  int err = set_smem(kernel, kF32Smem);
  if (err) return err;
  dim3 grid((C + kF32Tok - 1) / kF32Tok, ncols / (GLU ? 64 : 128), E);
  kernel<<<grid, kF32Threads, kF32Smem, stream>>>(act, w0, w1, counts, out, C, K,
                                                   ncols, k_tiles);
  return (int)cudaGetLastError();
}

// Depth of one step of the down projection's loop over ff.
template <typename T> struct Depth;
template <> struct Depth<float> { static constexpr int kStep = kF32BK; };
template <> struct Depth<__nv_bfloat16> { static constexpr int kStep = kBK; };

template <typename T>
int moe_ffn(const void* x, const void* wg, const void* wu, const void* wd,
            const int* counts, void* hidden, void* out, int E, int C, int d, int ff,
            cudaStream_t stream) {
  const int bk = Depth<T>::kStep;
  const int d_tiles = d / bk;
  const int ff_tiles = ff / bk;
  if constexpr (std::is_same<T, float>::value) {
    const float* xf = static_cast<const float*>(x);
    float* hf = static_cast<float*>(hidden);
    int err = launch_f32<true>(xf, static_cast<const float*>(wg),
                               static_cast<const float*>(wu), counts, hf, E, C, d, ff,
                               d_tiles, stream);
    if (err) return err;
    return launch_f32<false>(hf, static_cast<const float*>(wd), nullptr, counts,
                             static_cast<float*>(out), E, C, ff, d, ff_tiles, stream);
  } else {
    CUtensorMap x_map, wg_map, wu_map, h_map, wd_map;
    int err = tensor_map(&x_map, x, d, C, E, 8);
    if (!err) err = tensor_map(&wg_map, wg, ff, d, E, kBK);
    if (!err) err = tensor_map(&wu_map, wu, ff, d, E, kBK);
    if (!err) err = tensor_map(&h_map, hidden, ff, C, E, 8);
    if (!err) err = tensor_map(&wd_map, wd, d, ff, E, kBK);
    if (err) return err;
    err = launch_wgmma<true>(x_map, wg_map, wu_map, counts,
                             static_cast<__nv_bfloat16*>(hidden), E, C, ff, d_tiles,
                             stream);
    if (err) return err;
    return launch_wgmma<false>(h_map, wd_map, wd_map, counts,
                               static_cast<__nv_bfloat16*>(out), E, C, d, ff_tiles,
                               stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `counts` is int32 [E] or null (every
// row live); `hidden` is the caller's [E, C, ff] scratch of x's dtype.
// Returns cudaGetLastError() after the second launch (0 on success), or a
// CUDA error code for a shape the kernel does not take or a set-up step that
// failed.  Launches on `stream`, does not synchronise, reads nothing back
// and allocates nothing.
extern "C" int moe_ffn_launch(const void* x, const void* w_gate, const void* w_up,
                              const void* w_down, const void* counts, void* hidden,
                              void* out, int E, int C, int d, int ff, int dtype,
                              void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || ff <= 0 || E > 65535 || d % 128 || ff % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* n = static_cast<const int*>(counts);
  if (dtype == 0)
    return moe_ffn<float>(x, w_gate, w_up, w_down, n, hidden, out, E, C, d, ff, st);
  if (dtype == 1)
    return moe_ffn<__nv_bfloat16>(x, w_gate, w_up, w_down, n, hidden, out, E, C, d,
                                  ff, st);
  return (int)cudaErrorInvalidValue;
}
