// Paged flash attention for Hopper (sm_90a), CUDA C++ with plain C entry
// points loaded through ctypes.
//
// Replaces repro/kernels/paged_attention.py::paged_flash_attention, the
// Pallas TPU kernel of the serving tick.  It computes the same function:
// flash attention of a merged prefill/decode micro-batch over a paged KV
// pool.
//   q            [S, TQ, H, D]         f32 or bf16
//   kv_pages     [P, page, 2, KH, D]   same dtype, K and V interleaved
//   block_tables [S, B]  int32,  context_lens [S] int32,  q_positions [S, TQ] int32
//   out          [S, TQ, H, D]         q's dtype
// GQA: q heads kh*G .. kh*G+G-1 read KV head kh; the TQ*G rows of one
// (sequence, KV head) are flattened as m = tq*G + g.  Key kpos of sequence s
// is attended when kpos < ctx[s] and kpos <= qpos; scores are scaled by
// D**-0.5 and the softmax runs online in f32.  Pages at or past
// min(ceil(ctx/page), B) are dead: never read.  A row with ctx == 0 reads no
// page and is written as exact zeros.
//
// Entry points.  paged_attention_workspace_bytes(S, TQ, H, KH, D, page, B,
// dtype, with_lse) gives the bytes of f32 scratch that a launch with these
// shapes needs (0 for none); the caller allocates it and passes it to
// paged_attention_launch.  Both derive the launch plan (`plan_for`) from these
// shapes alone, never from the tensors' values: nothing is read back from the
// card, so a launch never synchronises the stream and can be captured in a
// CUDA graph.  Nothing here allocates.
//
// Split-KV across blocks.  The grid is (row tiles, KH, S * splits).  A block
// takes one tile of flattened rows of one (sequence, KV head) and walks only
// its split's table pages, and none past the causal horizon of its rows (the
// page of their largest q position) or past the live pages.  Where the row
// tiles alone fill the card (a 512-token chunk at 64:8 heads is 64 tiles per
// KV head) there is one split and the block writes the output.  Otherwise
// (decode; prefill with few KV heads) each block writes f32 partials of its
// rows -- the unnormalised O, the running max m and the sum l -- into the
// workspace, and paged_attention_combine_kernel merges a row's partials as
// the JAX package's merge_flash_partials + finalize_flash do.  A split that
// holds none of a row's keys is never read by the combine (it follows from
// ctx, the row's q position and the split size), so a block with no pages to
// walk exits at once.
//
// Three paths, chosen from TQ*G (rows per (sequence, KV head)) and dtype:
//  * Decode (at most 16 rows): bound by device-memory bytes (each live KV
//    byte is read once for ~2 flops per row).  Each warp walks its own tiles
//    of 32 keys through a ring of 3 shared-memory stages filled by cp.async
//    16-byte copies, so two tiles are in flight while one is scored; the
//    warps of a block merge their (m, l, O) at the end.  With few rows
//    (f32, and bf16 below 4 rows) lanes run over keys on the CUDA cores: a
//    lane scores its key against every row (K from shared memory, q
//    broadcast from shared memory), one warp-wide max per row and tile, the
//    sums stay per lane until the end, no reduction per score; P goes
//    through shared memory and P.V runs with lanes over D.  bf16 GQA (4 to
//    16 rows: 40:8 and 64:8 heads) would spend most of its issue slots on
//    those broadcasts, so there the rows, padded to 16, go on the tensor
//    cores: mma.sync m16n8k16 for S = Q.K^T and O += P.V, fragments by
//    ldmatrix from the swizzled stage, the softmax on the S fragments (a
//    max over the 4 lanes of a row per tile).
//  * f32 prefill: bound by operations on the CUDA cores (no TF32: plain f32
//    FMAs, so the f32 check holds).  A block of 128 threads takes 64 rows,
//    K/V stages of 64 keys are double-buffered by cp.async, and each thread
//    owns an 8 x 4 micro-tile of S (8 rows, 4 keys) and the 8 x D/16 tile of
//    O for the same rows: the inner loops are shared-memory vector loads and
//    FMAs, with no shuffles.  The row max is reduced across the 16 threads of
//    a row group once per stage; P goes through shared memory.
//  * bf16 prefill: bound by operations on the tensor cores.  Warp
//    specialised: a producer warp fills a ring of stages of 64 keys (4 at
//    D=64, 2 at D=128 so that two blocks share an SM) with TMA copies (one
//    per page, per K or V, per 64-column half, 128-byte swizzle) signalled
//    through mbarriers, and zeroes the rows of dead pages instead of copying
//    them; one consumer warpgroup owns 64 rows and runs S = Q.K^T as wgmma
//    m64n64k16 (Q and K from shared memory), the online softmax on the
//    accumulator registers, and O += P.V as wgmma with P rounded to bf16 in
//    registers (as the JAX flash path casts p to v's dtype) and V read
//    MN-major from shared memory.  At these sizes the softmax, not the
//    products, sets the pace: it runs on unscaled scores with one FMA and
//    one ex2 per element, and skips the mask on tiles that lie wholly before
//    every row's q position.  setmaxnreg moves registers from the producer
//    warpgroup to the consumers.
// Every path masks keys at or past the block's key end and past each row's
// q position, and never reads a dead page.
//
// The log-sum-exp.  With a non-null `lse` (f32 [S, TQ, H]) a launch also
// writes each row's log(sum_k exp(score_k)) over its attended keys (kNegInf
// for a row with none), so that the normalised outputs of attention over
// disjoint key sets merge exactly: O = sum_r exp(lse_r - LSE) o_r.  Serving
// at a sequence-sharded pool (each data rank holds every n-th page of a
// sequence) calls it so.  The combine kernel already holds each row's max m
// and sum l, and lse = m + log(l); such a launch therefore always writes
// partials into the workspace and runs the combine, at one split too.  The
// interleave stays on the host side: on a shard the keys that pass
// kpos < ctx and kpos <= qpos are a prefix of the local keys, so the caller
// hands the kernel the local ctx and q positions of that prefix, and the
// kernel's masks and dead-page walk are those of any pool.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_maxf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 16-byte chunk c of shared row `row` is stored at chunk c ^ (row & 7): lanes
// that read the same chunk of 8 consecutive rows hit 8 distinct bank groups.
__device__ __forceinline__ int swz(int row, int c) { return c ^ (row & 7); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// What one block works on.

struct Block {
  int s, kh, split;   // sequence, KV head, split
  int m0, rows;       // flattened rows m0 .. m0 + rows - 1 of (s, kh)
  int ctx;
  int qmin, qmax;     // smallest and largest q position of the rows
  int p_lo, p_end;    // table pages [p_lo, p_end) to walk (empty when p_end <= p_lo)
  int kend;           // keys at or past kend are never attended by this block
};

// Every warp computes this alone from the tile's q positions (no barrier).
template <int PAGE>
__device__ Block block_of(const int* __restrict__ ctx_lens,
                          const int* __restrict__ q_positions, int TQ, int G,
                          int B, int tile_rows, int nsplit, int split_pages) {
  Block b;
  b.s = blockIdx.z / nsplit;
  b.split = blockIdx.z % nsplit;
  b.kh = blockIdx.y;
  b.m0 = blockIdx.x * tile_rows;
  b.rows = min(tile_rows, TQ * G - b.m0);
  b.ctx = ctx_lens[b.s];
  const int* qp = q_positions + (size_t)b.s * TQ;
  const int t_lo = b.m0 / G, t_hi = (b.m0 + b.rows - 1) / G;
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int t = t_lo + (int)(threadIdx.x & 31); t <= t_hi; t += 32) {
    qmin = min(qmin, qp[t]);
    qmax = max(qmax, qp[t]);
  }
  b.qmin = -warp_max(-qmin);
  b.qmax = warp_max(qmax);
  const int live = min((b.ctx + PAGE - 1) / PAGE, B);
  const int visit = b.qmax < 0 ? 0 : min(live, b.qmax / PAGE + 1);
  b.p_lo = b.split * split_pages;
  b.p_end = min(b.p_lo + split_pages, visit);
  b.kend = min(b.ctx, b.p_end * PAGE);
  return b;
}

// Offset of flattened row m of (s, kh) in q and out.
__device__ __forceinline__ size_t row_offset(int s, int m, int TQ, int H,
                                             int G, int kh, int D) {
  const int tq = m / G, h = kh * G + m % G;
  return ((size_t)(s * TQ + tq) * H + h) * D;
}

// Index of row m's partial in the workspace: o [S, nsplit, KH, M, D] and
// (m, l) [S, nsplit, KH, M, 2], all f32.
__device__ __forceinline__ size_t partial_index(const Block& b, int m, int KH,
                                                int M, int nsplit) {
  return ((size_t)(b.s * nsplit + b.split) * KH + b.kh) * M + m;
}

// ---------------------------------------------------------------------------
// Decode: at most kDecodeRows rows per (sequence, KV head); each warp walks
// its own tiles of kDecodeKeys keys through a cp.async ring.

constexpr int kDecodeRows = 16;
constexpr int kDecodeKeys = 32;     // keys per tile: one per lane
constexpr int kDecodeStages = 3;    // ring of tiles per warp

template <typename T, int D> struct DecodeShape {
  // 4 warps a block, or 2 where four rings of 512-byte rows (f32 at D=128)
  // would not fit in shared memory
  static constexpr int kWarps = D * sizeof(T) > 256 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte chunk
  static constexpr int kChunks = D / kVec;        // chunks per K or V row
  static constexpr int kDpl = D / 32;             // output dims per lane
  static constexpr size_t kTile = size_t(kDecodeKeys) * D;   // elements, K or V
  static constexpr size_t kRingBytes =
      size_t(kWarps) * kDecodeStages * 2 * kTile * sizeof(T);
  static constexpr size_t kQBytes = size_t(kDecodeRows) * D * sizeof(float);
  static constexpr size_t kPBytes =
      size_t(kWarps) * kDecodeRows * kDecodeKeys * sizeof(float);
  static constexpr size_t kSmem = kRingBytes + kQBytes + kPBytes;
  static_assert(kChunks >= 8, "the swizzle spans 8 chunks");
  static_assert(size_t(kWarps) * kDecodeRows * (D + 2) * sizeof(float) <=
                    kRingBytes,
                "the merge area reuses the ring");
};

// One warp copies the K and V rows of the tile's keys into (ks, vs) with
// cp.async.  Pages at or past p_end are not copied; their rows are zeroed, so
// that no stale or unwritten shared memory meets a product (P = 0 times a NaN
// is NaN).
template <typename T, int D, int PAGE>
__device__ __forceinline__ void decode_stage(T* ks, T* vs, const T* __restrict__ kv,
                                             const int* __restrict__ table, int b0,
                                             int p_end, int kh, int KH) {
  using Sh = DecodeShape<T, D>;
  constexpr int PPT = kDecodeKeys / PAGE;
  constexpr int PER = kDecodeKeys * Sh::kChunks;
  const int lane = threadIdx.x & 31;
  const int pg_lane = (lane < PPT && b0 + lane < p_end) ? table[b0 + lane] : -1;
#pragma unroll 4
  for (int c = lane; c < 2 * PER; c += 32) {
    const int which = c / PER, rest = c % PER;
    const int j = rest / Sh::kChunks, ch = rest % Sh::kChunks;
    const int pg = __shfl_sync(kFull, pg_lane, j / PAGE);
    if (pg < 0) continue;
    const T* src = kv + ((((size_t)pg * PAGE + j % PAGE) * 2 + which) * KH + kh) * D +
                   ch * Sh::kVec;
    cp_async16((which ? vs : ks) + j * D + swz(j, ch) * Sh::kVec, src);
  }
  const int live_rows = max(0, min(PPT, p_end - b0)) * PAGE;
  if (live_rows < kDecodeKeys) {
    // rows of the pages not copied: zero in K and V
    const int n = (kDecodeKeys - live_rows) * D / Sh::kVec;
    for (int c = lane; c < 2 * n; c += 32)
      reinterpret_cast<uint4*>((c < n ? ks : vs) + live_rows * D)[c % n] =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.  .trans delivers them transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// MMA: bf16 with 4 to 16 rows (GQA decode): the rows, padded to 16, go on the
// tensor cores (mma.sync m16n8k16) against each tile's 32 keys; otherwise
// lanes run over keys on the CUDA cores with NR rows in registers.
template <typename T, int D, int PAGE, int NR, bool MMA>
__global__ void __launch_bounds__(DecodeShape<T, D>::kThreads)
paged_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                              const int* __restrict__ tables,
                              const int* __restrict__ ctx_lens,
                              const int* __restrict__ q_positions,
                              T* __restrict__ out, float* __restrict__ ws_o,
                              float* __restrict__ ws_ml, int TQ, int H, int KH,
                              int B, int nsplit, int split_pages, float scale) {
  using Sh = DecodeShape<T, D>;
  constexpr int W = Sh::kWarps, VEC = Sh::kVec, DPL = Sh::kDpl;
  constexpr int PPT = kDecodeKeys / PAGE;
  static_assert(!MMA || (std::is_same<T, __nv_bfloat16>::value && NR == 16),
                "the tensor-core decode takes bf16 and 16 padded rows");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + Sh::kRingBytes);   // [NR][D]
  float* p_all = q_s + kDecodeRows * D;                // [W][NR][kDecodeKeys]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = H / KH, M = TQ * G;
  const Block b = block_of<PAGE>(ctx_lens, q_positions, TQ, G, B, kDecodeRows,
                                 nsplit, split_pages);
  // the combine reads no split that holds none of a row's keys
  if (b.p_end <= b.p_lo && ws_o != nullptr) return;

  // CUDA cores: q rows, scaled, in f32 in shared memory (rows past the tile
  // zero), and each row's q position.  Tensor cores: q as A fragments in
  // registers, this thread's rows gid and gid + 8.
  int qp[MMA ? 2 : NR];
  uint32_t qa[MMA ? D / 16 : 1][4];
  if constexpr (MMA) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = gid + 8 * h2;
      qp[h2] = r < b.rows ? q_positions[(size_t)b.s * TQ + (b.m0 + r) / G] : -1;
    }
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e & 1), col = kt * 16 + tig * 2 + 8 * (e >> 1);
        qa[kt][e] = r < b.rows ? *reinterpret_cast<const uint32_t*>(
                                     q + row_offset(b.s, b.m0 + r, TQ, H, G, b.kh, D) + col)
                               : 0u;
      }
  } else {
    for (int i = threadIdx.x; i < NR * D; i += blockDim.x) {
      const int r = i / D;
      q_s[i] = r < b.rows
                   ? to_float(q[row_offset(b.s, b.m0 + r, TQ, H, G, b.kh, D) + i % D]) *
                         scale
                   : 0.f;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
      qp[r] = r < b.rows ? q_positions[(size_t)b.s * TQ + (b.m0 + r) / G] : -1;
    __syncthreads();
  }

  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * kDecodeStages * 2 * Sh::kTile;
  float* p_s = p_all + warp * NR * kDecodeKeys;
  const int* table = tables + (size_t)b.s * B;
  const int n_tiles = b.p_end > b.p_lo ? (b.p_end - b.p_lo + PPT - 1) / PPT : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + W - 1) / W : 0;
  const int kstop = min(b.kend, b.qmax + 1);   // no row attends a key past it

  // CUDA cores: running max, this lane's share of the sum, and this lane's
  // dims of O for every row.  Tensor cores: the same for rows gid, gid + 8,
  // and O as D/8 accumulator tiles.
  constexpr int NM = MMA ? 2 : NR;
  float m_r[NM], l_r[NM], acc[MMA ? D / 8 : NR][MMA ? 4 : DPL];
#pragma unroll
  for (int r = 0; r < NM; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < (MMA ? D / 8 : NR); ++r)
#pragma unroll
    for (int e = 0; e < (MMA ? 4 : DPL); ++e) acc[r][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kDecodeStages - 1; ++i) {
    if (i < mine) {
      T* st = ring + (i % kDecodeStages) * 2 * Sh::kTile;
      decode_stage<T, D, PAGE>(st, st + Sh::kTile, kv, table,
                               b.p_lo + (warp + i * W) * PPT, b.p_end, b.kh, KH);
    }
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int nxt = i + kDecodeStages - 1;
    if (nxt < mine) {
      T* st = ring + (nxt % kDecodeStages) * 2 * Sh::kTile;
      decode_stage<T, D, PAGE>(st, st + Sh::kTile, kv, table,
                               b.p_lo + (warp + nxt * W) * PPT, b.p_end, b.kh, KH);
    }
    cp_async_commit();
    cp_async_wait<kDecodeStages - 1>();
    __syncwarp();
    const T* ks = ring + (i % kDecodeStages) * 2 * Sh::kTile;
    const T* vs = ks + Sh::kTile;
    const int kbase = (b.p_lo + (warp + i * W) * PPT) * PAGE;

    if constexpr (MMA) {
      // S [16 rows x 32 keys] = Q.K^T: n-tile j holds keys 8j .. 8j + 7;
      // element e of it is row gid + 8*(e>>1), key 8j + 2*tig + (e&1)
      float sc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        const int key = 8 * j + (lane & 7);
#pragma unroll
        for (int kt = 0; kt < D / 16; kt += 2) {
          uint32_t kb[4];   // chunks 2kt .. 2kt + 3 of keys 8j .. 8j + 7
          ldsm_x4(kb, ks + key * D + swz(key, 2 * kt + (lane >> 3)) * VEC);
          const uint32_t b0[2] = {kb[0], kb[2]}, b1[2] = {kb[1], kb[3]};
          mma_bf16(sc[j], qa[kt], b0[0], b1[0]);
          mma_bf16(sc[j], qa[kt + 1], b0[1], b1[1]);
        }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kbase + 8 * j + 2 * tig + (e & 1);
          const float v = sc[j][e];
          sc[j][e] = (kpos < b.kend && kpos <= qp[e >> 1]) ? v * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(kFull, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(kFull, mx[h2], 2));
        alpha[h2] = expf(m_r[h2] - mx[h2]);
        m_r[h2] = mx[h2];
        l_r[h2] *= alpha[h2];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[j][e] > kNegInf ? expf(sc[j][e] - mx[e >> 1]) : 0.f;
          sc[j][e] = p;
          l_r[e >> 1] += p;   // this thread's share
        }
      // P as A fragments, rounded to bf16 as the JAX flash path casts p to
      // v's dtype: keys 16kk .. 16kk + 15
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
      // O += P.V: V^T fragments by ldmatrix.trans, two d-chunks at a time
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int key = 16 * kk + (lane & 15);
#pragma unroll
        for (int c2 = 0; c2 < D / 16; ++c2) {
          uint32_t vb[4];   // chunks 2c2, 2c2 + 1 of keys 16kk .. 16kk + 15
          ldsm_x4_t(vb, vs + key * D + swz(key, 2 * c2 + (lane >> 4)) * VEC);
          mma_bf16(acc[2 * c2], pa[kk], vb[0], vb[1]);
          mma_bf16(acc[2 * c2 + 1], pa[kk], vb[2], vb[3]);
        }
      }
    } else {
      const int nk = min(kDecodeKeys, kstop - kbase);   // keys worth reading
      // scores: lane j scores key kbase + j against every row
      float sc[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) sc[r] = 0.f;
      if (lane < nk) {
        const T* krow = ks + lane * D;
#pragma unroll
        for (int c = 0; c < Sh::kChunks; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + swz(lane, c) * VEC);
          float kf[VEC];
          const T* kt = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] = to_float(kt[e]);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + r * D + c * VEC);
#pragma unroll
            for (int e4 = 0; e4 < VEC / 4; ++e4) {
              const float4 qq = qv[e4];
              sc[r] = fmaf(qq.x, kf[4 * e4], sc[r]);
              sc[r] = fmaf(qq.y, kf[4 * e4 + 1], sc[r]);
              sc[r] = fmaf(qq.z, kf[4 * e4 + 2], sc[r]);
              sc[r] = fmaf(qq.w, kf[4 * e4 + 3], sc[r]);
            }
          }
        }
      }
      // online softmax: one warp-wide max per row and tile
      const int kpos = kbase + lane;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const bool valid = kpos < b.kend && kpos <= qp[r];
        const float s = valid ? sc[r] : kNegInf;
        const float mx = fmaxf(m_r[r], warp_maxf(s));
        const float alpha = expf(m_r[r] - mx);
        const float p = valid ? expf(s - mx) : 0.f;
        l_r[r] = l_r[r] * alpha + p;   // this lane's share
        m_r[r] = mx;
        p_s[r * kDecodeKeys + lane] = p;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
      }
      __syncwarp();
      // P.V: lanes over D; lane owns dims lane*DPL .. lane*DPL + DPL - 1
      const int d0 = lane * DPL;
      for (int k = 0; k < nk; ++k) {
        const T* vrow = vs + k * D + swz(k, d0 / VEC) * VEC + d0 % VEC;
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = to_float(vrow[e]);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float p = p_s[r * kDecodeKeys + k];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // merge the warps' partials of each row through shared memory (the ring)
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem);          // [W][NR][D]
  float* mml = mo + (size_t)W * NR * D;                // [W][NR][2]
  if constexpr (MMA) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float l = l_r[h2];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const int r = gid + 8 * h2;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(mo + (warp * NR + r) * D + 8 * nt + 2 * tig) =
            make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
      if (tig == 0) {
        mml[(warp * NR + r) * 2] = m_r[h2];
        mml[(warp * NR + r) * 2 + 1] = l;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float l = warp_sum(l_r[r]);
      if (r >= b.rows) continue;
#pragma unroll
      for (int e = 0; e < DPL; ++e) mo[(warp * NR + r) * D + lane * DPL + e] = acc[r][e];
      if (lane == 0) {
        mml[(warp * NR + r) * 2] = m_r[r];
        mml[(warp * NR + r) * 2 + 1] = l;
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < b.rows; r += W) {
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mg = fmaxf(mg, mml[(w * NR + r) * 2]);
    float l = 0.f, o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float a = expf(mml[(w * NR + r) * 2] - mg);
      l = fmaf(mml[(w * NR + r) * 2 + 1], a, l);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        o[e] = fmaf(mo[(w * NR + r) * D + lane * DPL + e], a, o[e]);
    }
    const int m = b.m0 + r;
    if (ws_o == nullptr) {
      T* orow = out + row_offset(b.s, m, TQ, H, G, b.kh, D);
      const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
      for (int e = 0; e < DPL; ++e) orow[lane * DPL + e] = from_float<T>(o[e] * inv);
    } else {
      const size_t pi = partial_index(b, m, KH, M, nsplit);
#pragma unroll
      for (int e = 0; e < DPL; ++e) ws_o[pi * D + lane * DPL + e] = o[e];
      if (lane == 0) {
        ws_ml[2 * pi] = mg;
        ws_ml[2 * pi + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 prefill: CUDA cores, register micro-tiles.  128 threads; thread t owns
// rows rg*8 .. rg*8+7 (rg = t / 16) of the 64-row tile, keys tk + 16j (j < 4,
// tk = t % 16) of each 64-key stage, and output columns 4*(tk + 16u) .. +3.

constexpr int kTileRows = 64;    // flattened rows per prefill block
constexpr int kTileKeys = 64;    // keys per prefill stage

template <int D> struct F32Shape {
  static constexpr int kThreads = 128;
  static constexpr int kStages = 2;
  static constexpr int kChunks = D / 4;                  // float4 per row
  static constexpr size_t kQ = size_t(kTileRows) * D;    // floats
  static constexpr size_t kKV = size_t(kTileKeys) * D;   // floats, K or V
  static constexpr size_t kP = size_t(kTileKeys) * kTileRows;
  static constexpr size_t kSmem = (kQ + kStages * 2 * kKV + kP) * sizeof(float);
};

template <int D, int PAGE>
__device__ __forceinline__ void f32_stage(float* ks, float* vs,
                                          const float* __restrict__ kv,
                                          const int* __restrict__ table, int b0,
                                          int p_end, int kh, int KH) {
  constexpr int CH = F32Shape<D>::kChunks;
  for (int c = threadIdx.x; c < 2 * kTileKeys * CH; c += F32Shape<D>::kThreads) {
    const int which = c / (kTileKeys * CH), rest = c % (kTileKeys * CH);
    const int j = rest / CH, ch = rest % CH;
    const int bi = b0 + j / PAGE;
    if (bi >= p_end) continue;
    const size_t pg = (size_t)table[bi];
    const float* src = kv + (((pg * PAGE + j % PAGE) * 2 + which) * KH + kh) * D + ch * 4;
    cp_async16((which ? vs : ks) + j * D + swz(j, ch) * 4, src);
  }
}

template <int D, int PAGE>
__global__ void __launch_bounds__(128, 1)
paged_attention_f32_prefill_kernel(const float* __restrict__ q,
                                   const float* __restrict__ kv,
                                   const int* __restrict__ tables,
                                   const int* __restrict__ ctx_lens,
                                   const int* __restrict__ q_positions,
                                   float* __restrict__ out, float* __restrict__ ws_o,
                                   float* __restrict__ ws_ml, int TQ, int H, int KH,
                                   int B, int nsplit, int split_pages, float scale) {
  using Sh = F32Shape<D>;
  constexpr int CH = Sh::kChunks, CU = D / 64;   // output float4 per row and thread
  constexpr int PPT = kTileKeys / PAGE;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);          // [64][D]
  float* ring = q_s + Sh::kQ;                            // [stage][K|V][64][D]
  float* p_s = ring + Sh::kStages * 2 * Sh::kKV;         // [64 keys][64 rows]

  const int tid = threadIdx.x, rg = tid >> 4, tk = tid & 15;
  const int G = H / KH, M = TQ * G;
  const Block b = block_of<PAGE>(ctx_lens, q_positions, TQ, G, B, kTileRows,
                                 nsplit, split_pages);
  if (b.p_end <= b.p_lo && ws_o != nullptr) return;
  const int* table = tables + (size_t)b.s * B;
  const int n_tiles = b.p_end > b.p_lo ? (b.p_end - b.p_lo + PPT - 1) / PPT : 0;
  const int kstop = min(b.kend, b.qmax + 1);

  if (n_tiles > 0) {
    f32_stage<D, PAGE>(ring, ring + Sh::kKV, kv, table, b.p_lo, b.p_end, b.kh, KH);
  }
  cp_async_commit();
  for (int i = tid; i < kTileRows * CH; i += Sh::kThreads) {
    const int r = i / CH, c = i % CH;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < b.rows)
      v = *reinterpret_cast<const float4*>(
          q + row_offset(b.s, b.m0 + r, TQ, H, G, b.kh, D) + c * 4);
    reinterpret_cast<float4*>(q_s)[i] = v;
  }
  int qp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    qp[i] = r < b.rows ? q_positions[(size_t)b.s * TQ + (b.m0 + r) / G] : -1;
  }

  float o[8][4 * CU], m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CU; ++c) o[i][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      float* st = ring + ((it + 1) % Sh::kStages) * 2 * Sh::kKV;
      f32_stage<D, PAGE>(st, st + Sh::kKV, kv, table, b.p_lo + (it + 1) * PPT,
                         b.p_end, b.kh, KH);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = ring + (it % Sh::kStages) * 2 * Sh::kKV;
    const float* vs = ks + Sh::kKV;
    const int kbase = (b.p_lo + it * PPT) * PAGE;
    const int nk = min(kTileKeys, kstop - kbase);

    // S micro-tile: rows rg*8 + i, keys tk + 16j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      float4 kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tk + 16 * j;
        kb[j] = *reinterpret_cast<const float4*>(ks + key * D + swz(key, c) * 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(q_s + (rg * 8 + i) * D + c * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, kb[j].w, s[i][j]);
        }
      }
    }
    // mask, scale, online softmax; the row max is reduced over the 16
    // threads of the row group (lanes that differ in their low 4 bits)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kbase + tk + 16 * j;
        s[i][j] = (kpos < b.kend && kpos <= qp[i]) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o2 = 1; o2 < 16; o2 <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o2));
      const float alpha = expf(m_r[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] > kNegInf ? expf(s[i][j] - mx) : 0.f;
        psum += s[i][j];
      }
      l_r[i] = l_r[i] * alpha + psum;   // this thread's share
      m_r[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * CU; ++c) o[i][c] *= alpha;
    }
    // P [key][row]: this thread's 8 rows are 16-byte chunks 2*rg, 2*rg+1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tk + 16 * j;
      float4* prow = reinterpret_cast<float4*>(p_s + key * kTileRows);
      prow[swz(key, 2 * rg)] = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      prow[swz(key, 2 * rg + 1)] = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncwarp();   // a row group's P is written and read by its own half-warp
    // O micro-tile += P.V over the keys any row attends
    for (int k = 0; k < nk; ++k) {
      const float4* prow = reinterpret_cast<const float4*>(p_s + k * kTileRows);
      const float4 pa = prow[swz(k, 2 * rg)], pb = prow[swz(k, 2 * rg + 1)];
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const float4 v =
            *reinterpret_cast<const float4*>(vs + k * D + swz(k, tk + 16 * u) * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i][4 * u] = fmaf(p[i], v.x, o[i][4 * u]);
          o[i][4 * u + 1] = fmaf(p[i], v.y, o[i][4 * u + 1]);
          o[i][4 * u + 2] = fmaf(p[i], v.z, o[i][4 * u + 2]);
          o[i][4 * u + 3] = fmaf(p[i], v.w, o[i][4 * u + 3]);
        }
      }
    }
    __syncthreads();   // the stage and P are free for the next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int o2 = 1; o2 < 16; o2 <<= 1) l += __shfl_xor_sync(kFull, l, o2);
    const int r = rg * 8 + i;
    if (r >= b.rows) continue;
    const int m = b.m0 + r;
    if (ws_o == nullptr) {
      float* orow = out + row_offset(b.s, m, TQ, H, G, b.kh, D);
      const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
      for (int u = 0; u < CU; ++u)
        reinterpret_cast<float4*>(orow)[tk + 16 * u] =
            make_float4(o[i][4 * u] * inv, o[i][4 * u + 1] * inv,
                        o[i][4 * u + 2] * inv, o[i][4 * u + 3] * inv);
    } else {
      const size_t pi = partial_index(b, m, KH, M, nsplit);
#pragma unroll
      for (int u = 0; u < CU; ++u)
        reinterpret_cast<float4*>(ws_o + pi * D)[tk + 16 * u] =
            make_float4(o[i][4 * u], o[i][4 * u + 1], o[i][4 * u + 2], o[i][4 * u + 3]);
      if (tk == 0) {
        ws_ml[2 * pi] = m_r[i];
        ws_ml[2 * pi + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill: wgmma with TMA, warp specialised.  Threads 0..127 are the
// consumer warpgroup (64 rows), threads 128..255 the producer warpgroup, of
// which warp 4 issues the copies (setmaxnreg takes whole warpgroups: with a
// lone producer warp the consumers' raise never returned).  Shared memory
// holds the Q tile and a ring of stages of 64 keys, each K or V as D/64
// regions of 64 rows x 128 B (64 bf16 columns), 128-byte swizzled: the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with a
// B128 descriptor.

constexpr int kWgThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;
constexpr int kRegion = kTileKeys * 128;   // bytes of 64 rows x 64 bf16

// Stages: 4 at D=64; 2 at D=128, so that two blocks fit an SM and one
// block's softmax overlaps the other's products.
template <int D> struct WgShape {
  static constexpr int kHalves = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kQ = kHalves * kRegion;     // Q tile, and K or V of a stage
  static constexpr size_t kSmem =
      1024 /* alignment */ + size_t(kQ) * (1 + 2 * kStages) + 2 * kStages * 8;
};

// 2^x on the special-function unit (relative error ~2^-22, far inside the
// rounding of P to bf16 that follows).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// 8-row groups 1024 B apart (SBO); the leading offset is unused for these
// tiles (K-major: a k16 step stays inside the 128-byte row; MN-major: N = 64).
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
// Keeps the compiler from moving reads of accumulator registers across the
// wgmma fence/wait (the asm above names no registers).
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B^T, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B, A from registers, B from shared memory
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D, int PAGE>
__global__ void __launch_bounds__(kWgThreads, 2)
paged_attention_wgmma_kernel(const __grid_constant__ CUtensorMap kv_map,
                             const __nv_bfloat16* __restrict__ q,
                             const int* __restrict__ tables,
                             const int* __restrict__ ctx_lens,
                             const int* __restrict__ q_positions,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ ws_o, float* __restrict__ ws_ml,
                             int TQ, int H, int KH, int B, int nsplit,
                             int split_pages, float scale) {
  using Sh = WgShape<D>;
  constexpr int HALVES = Sh::kHalves;
  constexpr int PPT = kTileKeys / PAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                              // [HALVES][64][128 B]
  unsigned char* ring = q_s + Sh::kQ;                     // [stage][K|V][HALVES][64][128 B]
  constexpr int NS = Sh::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * NS * Sh::kQ);
  uint64_t* empty = full + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = H / KH, M = TQ * G;
  const Block b = block_of<PAGE>(ctx_lens, q_positions, TQ, G, B, kTileRows,
                                 nsplit, split_pages);
  const int n_tiles = b.p_end > b.p_lo ? (b.p_end - b.p_lo + PPT - 1) / PPT : 0;
  if (n_tiles == 0) {
    if (ws_o != nullptr) return;   // the combine reads no split without keys
    for (int i = threadIdx.x; i < b.rows * D; i += blockDim.x)
      out[row_offset(b.s, b.m0 + i / D, TQ, H, G, b.kh, D) + i % D] =
          __float2bfloat16(0.f);
    return;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {
    // ---- producer: TMA copies of the live pages, zeros for the dead ones
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int* table = tables + (size_t)b.s * B;
    for (int i = 0; warp == 4 && i < n_tiles; ++i) {
      const int slot = i % NS;
      if (i >= NS) mbar_wait(&empty[slot], ((i / NS) - 1) & 1);
      unsigned char* ks = ring + slot * 2 * Sh::kQ;
      const int b0 = b.p_lo + i * PPT;
      const int live = min(PPT, b.p_end - b0);
      const int dead_bytes = (PPT - live) * PAGE * 128;
      for (int c = lane; c < 2 * HALVES * dead_bytes / 16; c += 32) {
        const int region = c / (dead_bytes / 16), off = c % (dead_bytes / 16);
        *reinterpret_cast<uint4*>(ks + region * kRegion + live * PAGE * 128 + off * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[slot], 2 * HALVES * live * PAGE * 128);
        for (int ip = 0; ip < live; ++ip) {
          const int row = table[b0 + ip] * PAGE;
#pragma unroll
          for (int which = 0; which < 2; ++which)
#pragma unroll
            for (int h = 0; h < HALVES; ++h)
              tma_load_4d(ks + (which * HALVES + h) * kRegion + ip * PAGE * 128,
                          &kv_map, &full[slot], h * 64, b.kh, which, row);
        }
      }
      __syncwarp();
    }
  } else {
    // ---- consumers: 64 rows, warp w owns rows 16w .. 16w + 15
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int gid = lane >> 2, tig = lane & 3;
    // Q tile, 128-byte swizzled as TMA would write it; rows past the tile zero
    for (int i = threadIdx.x; i < kTileRows * D / 8; i += 128) {
      const int r = i / (D / 8), c = i % (D / 8), h = c / 8, cc = c % 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < b.rows)
        v = *reinterpret_cast<const uint4*>(
            q + row_offset(b.s, b.m0 + r, TQ, H, G, b.kh, D) + c * 8);
      *reinterpret_cast<uint4*>(q_s + h * kRegion + r * 128 + swz(r, cc) * 16) = v;
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

    int qp[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = warp * 16 + gid + 8 * h2;
      qp[h2] = r < b.rows ? q_positions[(size_t)b.s * TQ + (b.m0 + r) / G] : -1;
    }
    float o[HALVES][32], m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[h][e] = 0.f;
    const uint32_t q_addr = smem_u32(q_s);
    const float c = scale * 1.4426950408889634f;   // scale * log2(e)

    for (int i = 0; i < n_tiles; ++i) {
      const int slot = i % NS;
      mbar_wait(&full[slot], (i / NS) & 1);
      const uint32_t k_addr = smem_u32(ring + slot * 2 * Sh::kQ);
      const uint32_t v_addr = k_addr + Sh::kQ;

      // S = Q.K^T over D in k16 steps (32 B inside a 128-byte row)
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
        wgmma_ss(s, wg_desc(q_addr + off), wg_desc(k_addr + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      // mask, online softmax on unscaled scores (m_r is their running max;
      // exp(scale * x) = 2^(c * x)); element e of n-tile j is row
      // gid + 8*(e>>1) of this warp's 16, key 8j + 2*tig + (e&1).  A tile
      // whose keys lie before every row's q position and the key end needs
      // no mask.
      const int kbase = (b.p_lo + i * PPT) * PAGE;
      const bool whole = kbase + kTileKeys <= min(b.kend, b.qmin);
      float mx[2] = {m_r[0], m_r[1]};
      if (!whole) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kbase + 8 * j + 2 * tig + (e & 1);
            const float v = s[4 * j + e];
            s[4 * j + e] = (kpos < b.kend && kpos <= qp[e >> 1]) ? v : kNegInf;
          }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float alpha[2], mc[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(kFull, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(kFull, mx[h2], 2));
        alpha[h2] = fast_exp2((m_r[h2] - mx[h2]) * c);
        m_r[h2] = mx[h2];
        mc[h2] = mx[h2] * c;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float x = fast_exp2(fmaf(s[e], c, -mc[(e >> 1) & 1]));
        const float p = whole || s[e] > kNegInf ? x : 0.f;
        s[e] = p;
        psum[(e >> 1) & 1] += p;
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) l_r[h2] = l_r[h2] * alpha[h2] + psum[h2];
      // P as A fragments, rounded to bf16: keys 16kk .. 16kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
#pragma unroll
        for (int e = 0; e < 32; ++e) o[h][e] *= alpha[(e >> 1) & 1];
        reg_fence(o[h]);
      }
      // O += P.V: V MN-major, 16 keys (2048 B) per k16 step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
          wgmma_rs(o[h], pa[kk], wg_desc(v_addr + h * kRegion + kk * 2048));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int h = 0; h < HALVES; ++h) reg_fence(o[h]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float l = l_r[h2];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const int r = warp * 16 + gid + 8 * h2;
      if (r >= b.rows) continue;
      const int m = b.m0 + r;
      if (ws_o == nullptr) {
        __nv_bfloat16* orow = out + row_offset(b.s, m, TQ, H, G, b.kh, D);
        const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + h * 64 + 8 * j + 2 * tig) =
                pack_bf16(o[h][4 * j + 2 * h2] * inv, o[h][4 * j + 2 * h2 + 1] * inv);
      } else {
        const size_t pi = partial_index(b, m, KH, M, nsplit);
        float* orow = ws_o + pi * D;
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(orow + h * 64 + 8 * j + 2 * tig) =
                make_float2(o[h][4 * j + 2 * h2], o[h][4 * j + 2 * h2 + 1]);
        if (tig == 0) {
          ws_ml[2 * pi] = m_r[h2] * scale;   // the combine's units
          ws_ml[2 * pi + 1] = l;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Combine: one warp per output row (s, tq, h) merges the partials of the
// splits that hold any of the row's keys, and with `lse` writes the row's
// log-sum-exp of its scaled scores (kNegInf for a row with no key).

template <typename T, int D>
__global__ void __launch_bounds__(128)
paged_attention_combine_kernel(const float* __restrict__ ws_o,
                               const float* __restrict__ ws_ml,
                               const int* __restrict__ ctx_lens,
                               const int* __restrict__ q_positions,
                               T* __restrict__ out, float* __restrict__ lse,
                               int S, int TQ, int H, int KH, int nsplit,
                               int split_keys, int table_keys) {
  constexpr int DPL = D / 32;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= S * TQ * H) return;
  const int s = row / (TQ * H), tq = (row / H) % TQ, h = row % H;
  const int G = H / KH, kh = h / G, M = TQ * G, m = tq * G + h % G;
  const int kend = min(min(ctx_lens[s], q_positions[(size_t)s * TQ + tq] + 1),
                       table_keys);
  const int n_live = kend > 0 ? min(nsplit, (kend + split_keys - 1) / split_keys) : 0;
  float mg = kNegInf;
  for (int sp = 0; sp < n_live; ++sp)
    mg = fmaxf(mg, ws_ml[2 * ((((size_t)s * nsplit + sp) * KH + kh) * M + m)]);
  float l = 0.f, o[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = 0.f;
  for (int sp = 0; sp < n_live; ++sp) {
    const size_t pi = (((size_t)s * nsplit + sp) * KH + kh) * M + m;
    const float a = expf(ws_ml[2 * pi] - mg);
    l = fmaf(ws_ml[2 * pi + 1], a, l);
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = fmaf(ws_o[pi * D + lane * DPL + e], a, o[e]);
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
  T* orow = out + (size_t)row * D;
#pragma unroll
  for (int e = 0; e < DPL; ++e) orow[lane * DPL + e] = from_float<T>(o[e] * inv);
  if (lse != nullptr && lane == 0) lse[row] = l > 0.f ? mg + logf(l) : kNegInf;
}

// ---------------------------------------------------------------------------
// Host side: the plan of a launch, from shapes alone.

enum Path { kDecodePath, kF32PrefillPath, kWgmmaPath };

struct Plan {
  Path path;
  bool mma;          // decode: the rows go on the tensor cores (bf16, 4 to 16 rows)
  int nr;            // decode: rows a block holds in registers (1, 8 or 16)
  int tile_rows, row_tiles, nsplit, split_pages;
};

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// Blocks of `threads` threads and `smem` bytes one SM holds at once.
int resident(size_t smem, int threads, int reg_limit) {
  const int by_smem = (int)(233472 / (smem + 1024));
  const int by_threads = 2048 / threads;
  int n = by_smem < by_threads ? by_smem : by_threads;
  if (reg_limit > 0 && reg_limit < n) n = reg_limit;
  return n > 0 ? n : 1;
}

template <typename T, int D>
size_t path_smem(Path path) {
  if (path == kDecodePath) return DecodeShape<T, D>::kSmem;
  if (path == kF32PrefillPath) return F32Shape<D>::kSmem;
  return WgShape<D>::kSmem;
}

// Decode for at most kDecodeRows rows per (sequence, KV head), else the
// dtype's prefill path.  Splits: a prefill whose row tiles alone fill a wave
// of the card takes one; otherwise enough for two waves (decode always: its
// contexts differ, and shorter splits even out the blocks' work), each split
// at least two tiles per warp.
template <typename T, int D>
Plan plan_for(int S, int TQ, int H, int KH, int page, int B) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  Plan p;
  const int M = TQ * (H / KH);
  int threads, reg_limit = 0, tile_keys, warps;
  if (M <= kDecodeRows) {
    p.path = kDecodePath;
    p.mma = kBf16 && M >= 4;
    p.nr = p.mma || M > 8 ? 16 : (M <= 1 ? 1 : 8);
    p.tile_rows = kDecodeRows;
    threads = DecodeShape<T, D>::kThreads;
    warps = DecodeShape<T, D>::kWarps;
    tile_keys = kDecodeKeys;
  } else {
    p.path = kBf16 ? kWgmmaPath : kF32PrefillPath;
    p.mma = false;
    p.nr = 0;
    p.tile_rows = kTileRows;
    threads = kBf16 ? kWgThreads : F32Shape<D>::kThreads;
    reg_limit = kBf16 ? 2 : 0;
    warps = 1;
    tile_keys = kTileKeys;
  }
  p.row_tiles = (M + p.tile_rows - 1) / p.tile_rows;
  const int tile_pages = tile_keys / page;
  const int tiles = (B + tile_pages - 1) / tile_pages;
  const int base = S * KH * p.row_tiles;
  const int wave =
      sm_count() * resident(path_smem<T, D>(p.path), threads, reg_limit);
  int nsplit = p.path != kDecodePath && base >= wave ? 1 : (2 * wave + base - 1) / base;
  const int most = tiles / (2 * warps);
  if (nsplit > most) nsplit = most;
  if (nsplit < 1) nsplit = 1;
  const int split_tiles = (tiles + nsplit - 1) / nsplit;
  p.nsplit = (tiles + split_tiles - 1) / split_tiles;
  p.split_pages = split_tiles * tile_pages;
  return p;
}

template <typename T, int D>
size_t workspace_bytes(const Plan& p, int S, int TQ, int H, int KH, bool with_lse) {
  if (p.nsplit == 1 && !with_lse) return 0;
  const size_t rows = (size_t)S * p.nsplit * KH * TQ * (H / KH);
  return rows * (D + 2) * sizeof(float);
}

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

// The TMA map of the bf16 pool viewed as [P*page rows, 2, KH, D] (innermost
// last), box [page rows, 1, 1, 64 columns], 128-byte swizzle.  The pool's
// page count is not an argument of the entry point: the row extent is the
// largest a TMA coordinate takes, and the rows read are the table's, which
// index the pool by contract.
int kv_tensor_map(CUtensorMap* map, const void* kv, int KH, int D, int page) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KH, 2,
                              (cuuint64_t)INT_MAX};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KH * D * 2,
                                 (cuuint64_t)2 * KH * D * 2};
  const cuuint32_t box[4] = {64, 1, 1, (cuuint32_t)page};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(kv), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int D, int PAGE, int NR, bool MMA>
int launch_decode(const Plan& p, const void* q, const void* kv, const int* tables,
                  const int* ctx, const int* qpos, T* out, float* ws_o,
                  float* ws_ml, int S, int TQ, int H, int KH, int B, float scale,
                  cudaStream_t stream) {
  using Sh = DecodeShape<T, D>;
  auto kernel = paged_attention_decode_kernel<T, D, PAGE, NR, MMA>;
  int err = set_smem(kernel, Sh::kSmem);
  if (err) return err;
  dim3 grid(p.row_tiles, KH, S * p.nsplit);
  kernel<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), tables, ctx, qpos, out,
      ws_o, ws_ml, TQ, H, KH, B, p.nsplit, p.split_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int PAGE>
int launch_main(const Plan& p, const void* q, const void* kv, const int* tables,
                const int* ctx, const int* qpos, T* out, float* ws_o, float* ws_ml,
                int S, int TQ, int H, int KH, int B, float scale,
                cudaStream_t stream) {
  if (p.path == kDecodePath) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (p.mma)
        return launch_decode<T, D, PAGE, 16, true>(p, q, kv, tables, ctx, qpos, out,
                                                   ws_o, ws_ml, S, TQ, H, KH, B,
                                                   scale, stream);
    }
    if (p.nr == 1)
      return launch_decode<T, D, PAGE, 1, false>(p, q, kv, tables, ctx, qpos, out,
                                                 ws_o, ws_ml, S, TQ, H, KH, B,
                                                 scale, stream);
    if (p.nr == 8)
      return launch_decode<T, D, PAGE, 8, false>(p, q, kv, tables, ctx, qpos, out,
                                                 ws_o, ws_ml, S, TQ, H, KH, B,
                                                 scale, stream);
    return launch_decode<T, D, PAGE, 16, false>(p, q, kv, tables, ctx, qpos, out,
                                                ws_o, ws_ml, S, TQ, H, KH, B, scale,
                                                stream);
  }
  dim3 grid(p.row_tiles, KH, S * p.nsplit);
  if constexpr (std::is_same<T, float>::value) {
    using Sh = F32Shape<D>;
    auto kernel = paged_attention_f32_prefill_kernel<D, PAGE>;
    int err = set_smem(kernel, Sh::kSmem);
    if (err) return err;
    kernel<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kv), tables, ctx,
        qpos, out, ws_o, ws_ml, TQ, H, KH, B, p.nsplit, p.split_pages, scale);
    return (int)cudaGetLastError();
  } else {
    using Sh = WgShape<D>;
    auto kernel = paged_attention_wgmma_kernel<D, PAGE>;
    int err = set_smem(kernel, Sh::kSmem);
    if (err) return err;
    // setmaxnreg moves registers inside the block's allocation: the consumers'
    // raise must fit in what the launch allocates, or they would wait forever
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, kernel);
    if (err) return err;
    if (attr.numRegs * kWgThreads < 128 * (kConsumerRegs + kProducerRegs))
      return (int)cudaErrorInvalidConfiguration;
    CUtensorMap map;
    err = kv_tensor_map(&map, kv, KH, D, PAGE);
    if (err) return err;
    kernel<<<grid, kWgThreads, Sh::kSmem, stream>>>(
        map, static_cast<const __nv_bfloat16*>(q), tables, ctx, qpos, out, ws_o,
        ws_ml, TQ, H, KH, B, p.nsplit, p.split_pages, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D, int PAGE>
int launch(const void* q, const void* kv, const void* tables, const void* ctx,
           const void* qpos, void* out, float* lse, void* workspace, int S, int TQ,
           int H, int KH, int B, float scale, cudaStream_t stream) {
  const Plan p = plan_for<T, D>(S, TQ, H, KH, PAGE, B);
  // the log-sum-exp comes out of the combine, so a launch that asks for it
  // writes partials even at one split
  const bool partials = p.nsplit > 1 || lse != nullptr;
  float* ws_o = nullptr;
  float* ws_ml = nullptr;
  if (partials) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    ws_o = static_cast<float*>(workspace);
    ws_ml = ws_o + (size_t)S * p.nsplit * KH * TQ * (H / KH) * D;
  }
  const int* tab = static_cast<const int*>(tables);
  const int* ctx_i = static_cast<const int*>(ctx);
  const int* qpos_i = static_cast<const int*>(qpos);
  T* out_t = static_cast<T*>(out);
  int err = launch_main<T, D, PAGE>(p, q, kv, tab, ctx_i, qpos_i, out_t, ws_o, ws_ml,
                                    S, TQ, H, KH, B, scale, stream);
  if (err || !partials) return err;
  const int rows = S * TQ * H;
  paged_attention_combine_kernel<T, D><<<(rows + 3) / 4, 128, 0, stream>>>(
      ws_o, ws_ml, ctx_i, qpos_i, out_t, lse, S, TQ, H, KH, p.nsplit,
      p.split_pages * PAGE, B * PAGE);
  return (int)cudaGetLastError();
}

bool shapes_ok(int S, int TQ, int H, int KH, int B) {
  return S > 0 && TQ > 0 && KH > 0 && H % KH == 0 && B > 0;
}

#define REPRO_PA_SHAPES(X) X(64, 8) X(64, 16) X(128, 8) X(128, 16)

}  // namespace

// Bytes of f32 workspace a launch with these shapes needs (0: none), or -1
// for shapes the kernel does not take.  dtype: 0 = float32, 1 = bfloat16;
// with_lse: 1 when the launch writes the log-sum-exp.
extern "C" long long paged_attention_workspace_bytes(int S, int TQ, int H, int KH,
                                                     int D, int page, int B,
                                                     int dtype, int with_lse) {
  if (!shapes_ok(S, TQ, H, KH, B) || (dtype != 0 && dtype != 1)) return -1;
#define REPRO_PA_WS(DD, PP)                                                    \
  if (D == DD && page == PP)                                                   \
    return dtype == 0                                                          \
               ? (long long)workspace_bytes<float, DD>(                        \
                     plan_for<float, DD>(S, TQ, H, KH, PP, B), S, TQ, H, KH,   \
                     with_lse != 0)                                            \
               : (long long)workspace_bytes<__nv_bfloat16, DD>(                \
                     plan_for<__nv_bfloat16, DD>(S, TQ, H, KH, PP, B), S, TQ,  \
                     H, KH, with_lse != 0);
  REPRO_PA_SHAPES(REPRO_PA_WS)
#undef REPRO_PA_WS
  return -1;
}

// Launches on `stream` and does not synchronise; `workspace` holds at least
// paged_attention_workspace_bytes(...) bytes (it may be null when that is 0).
// `lse` (f32 [S, TQ, H], or null) receives each row's log-sum-exp.
// Returns cudaGetLastError() after the launches (0 on success), or a CUDA
// error code for a shape the kernel does not take or a set-up step that
// failed.
extern "C" int paged_attention_launch(
    const void* q, const void* kv, const void* tables, const void* ctx,
    const void* qpos, void* out, void* lse, void* workspace, int S, int TQ, int H,
    int KH, int D, int page, int B, int dtype, float scale, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  if (!shapes_ok(S, TQ, H, KH, B)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PA_LAUNCH(DD, PP)                                                \
  if (D == DD && page == PP) {                                                 \
    if (dtype == 0)                                                            \
      return launch<float, DD, PP>(q, kv, tables, ctx, qpos, out, lse_f,      \
                                   workspace, S, TQ, H, KH, B, scale, st);    \
    if (dtype == 1)                                                            \
      return launch<__nv_bfloat16, DD, PP>(q, kv, tables, ctx, qpos, out,      \
                                           lse_f, workspace, S, TQ, H, KH, B,  \
                                           scale, st);                         \
  }
  REPRO_PA_SHAPES(REPRO_PA_LAUNCH)
#undef REPRO_PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
