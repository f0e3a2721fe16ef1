// Paged flash attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces repro/kernels/paged_attention.py::paged_flash_attention, the
// Pallas TPU kernel of the serving tick.  It computes the same function:
// flash attention of a merged prefill/decode micro-batch over a paged KV
// pool.
//   q            [S, TQ, H, D]         f32 or bf16
//   kv_pages     [P, page, 2, KH, D]   same dtype, K and V interleaved
//   block_tables [S, B]  int32,  context_lens [S] int32,  q_positions [S, TQ] int32
//   out          [S, TQ, H, D]         q's dtype
// GQA: q heads kh*G .. kh*G+G-1 read KV head kh.  Key kpos of sequence s is
// attended when kpos < ctx[s] and kpos <= qpos; scores are scaled by
// D**-0.5 and the softmax runs online in f32.  Pages at or past
// min(ceil(ctx/page), B) are dead: never read.  A row with ctx == 0 reads no
// page and is written as exact zeros.
//
// What bounds it on an H100.  Decode (TQ = 1) reads each live KV byte once
// and does 4*D flops per key and head: about 2 flops per byte in bf16, far
// below the card's ~295 flops/byte, so it is bound by device-memory bytes;
// the design spreads a sequence's live pages over the four warps of a block
// (split-KV inside the block, merged through shared memory at the end) so
// one block keeps several pages in flight, and reads no dead page.  Prefill
// (TQ = chunk) does ~4*D flops per key per row: at long context it is bound
// by operations.  It reuses every staged page across a tile of query rows,
// runs bf16 tiles on the tensor cores (mma.sync), and skips pages past the
// tile's largest query position (causally masked for every row of the tile).
//
// Design.  One block of 4 warps per (sequence, KV head, tile of flattened
// (query position, grouped head) rows).  The block stages 4 live pages of
// this KV head in shared memory at a time (16-byte loads).  Two paths:
//  * CUDA cores (f32, and every tile of at most 16 rows): each warp keeps up
//    to 8 rows in registers — q, the f32 accumulator, running max and sum; a
//    lane owns the dims lane, lane+32, ... — scores its rows against the
//    keys of its pages (warp-shuffle dot products), updates the online
//    softmax and accumulates P.V.  Tiles with few rows (decode) split the
//    pages over the warps (ksplit = 4 or 2) and merge the partial (m, l,
//    acc) at the end; larger tiles give each warp its own rows over every
//    page (ksplit = 1).
//  * Tensor cores (bf16 tiles of more than 16 rows): each warp owns 16 rows
//    and runs mma.sync m16n8k16 for S = Q.K^T and O += P.V (see
//    paged_attention_mma_kernel).
// wgmma, TMA and a split-KV decode across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStagePages = 4;   // pages staged in shared memory at a time
constexpr int kMaxRows = 8;      // rows a warp keeps in registers
constexpr float kNegInf = -1e30f;

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Pages a block visits: the live pages, min(ceil(ctx/page), B), cut at the
// page of the largest query position of its tile (t_lo..t_hi): later pages
// are causally masked for every row of the tile.  Block-wide (syncs once).
template <int PAGE>
__device__ int pages_to_visit(const int* __restrict__ qpos, int t_lo, int t_hi,
                              int ctx, int B, int* scratch) {
  int qmax = INT_MIN;
  for (int t = t_lo + (int)threadIdx.x; t <= t_hi; t += (int)blockDim.x)
    qmax = max(qmax, qpos[t]);
  qmax = warp_max(qmax);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = qmax;
  __syncthreads();
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) qmax = max(qmax, scratch[w]);
  const int live = min((ctx + PAGE - 1) / PAGE, B);
  return qmax < 0 ? 0 : min(live, qmax / PAGE + 1);
}

template <typename T, int D, int PAGE>
__host__ __device__ constexpr size_t stage_bytes() {
  return size_t(kStagePages) * PAGE * 2 * D * sizeof(T);
}

template <int D>
__host__ __device__ constexpr size_t merge_bytes() {
  return size_t(kWarps) * kMaxRows * (D + 2) * sizeof(float);
}

template <typename T, int D, int PAGE>
__host__ __device__ constexpr size_t smem_bytes() {
  return stage_bytes<T, D, PAGE>() + merge_bytes<D>() + kWarps * sizeof(int);
}

template <typename T, int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                       const int* __restrict__ tables,
                       const int* __restrict__ ctx_lens,
                       const int* __restrict__ q_positions,
                       T* __restrict__ out, int TQ, int H, int KH, int B,
                       int rows_per_warp, int ksplit, float scale) {
  constexpr int DPL = D / 32;              // dims per lane
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int CHUNKS = D / VEC;          // 16-byte loads per K or V row

  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);   // [kStagePages][PAGE][2][D]
  float* merge = reinterpret_cast<float*>(smem + stage_bytes<T, D, PAGE>());
  int* qmax_s = reinterpret_cast<int*>(smem + stage_bytes<T, D, PAGE>() +
                                       merge_bytes<D>());

  const int s = blockIdx.z, kh = blockIdx.y;
  const int G = H / KH;
  const int M = TQ * G;                    // rows of this (s, kh): m = tq*G + g
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = warp % ksplit, rg = warp / ksplit;
  const int tile_rows = (kWarps / ksplit) * rows_per_warp;
  const int tile0 = blockIdx.x * tile_rows;
  const int tile_end = min(tile0 + tile_rows, M);
  const int row0 = tile0 + rg * rows_per_warp;
  const int nr = max(0, min(rows_per_warp, M - row0));

  const int ctx = ctx_lens[s];
  const int npages = pages_to_visit<PAGE>(q_positions + s * TQ, tile0 / G,
                                          (tile_end - 1) / G, ctx, B, qmax_s);

  float qr[kMaxRows][DPL], acc[kMaxRows][DPL], m_r[kMaxRows], l_r[kMaxRows];
  int qp[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
    qp[r] = -1;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[r][i] = 0.f;
      acc[r][i] = 0.f;
    }
    if (r < nr) {
      const int m = row0 + r, tq = m / G, h = kh * G + m % G;
      const T* qrow = q + ((size_t)(s * TQ + tq) * H + h) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[r][i] = to_float(qrow[lane + 32 * i]);
      qp[r] = q_positions[s * TQ + tq];
    }
  }

  for (int b0 = 0; b0 < npages; b0 += kStagePages) {
    const int np = min(kStagePages, npages - b0);
    // stage rows: (pi * PAGE + t) * 2 + which, each D elements of head kh
    for (int c = threadIdx.x; c < np * PAGE * 2 * CHUNKS; c += kThreads) {
      const int chunk = c % CHUNKS, row = c / CHUNKS;
      const int pi = row / (2 * PAGE), rest = row % (2 * PAGE);
      const size_t pg = (size_t)tables[s * B + b0 + pi];
      const T* src = kv + ((pg * PAGE * 2 + rest) * KH + kh) * D + chunk * VEC;
      reinterpret_cast<uint4*>(stage)[row * CHUNKS + chunk] =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();
    for (int pi = ks; pi < np; pi += ksplit) {
      const int kbase = (b0 + pi) * PAGE;
      const T* kp = stage + (size_t)pi * PAGE * 2 * D;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= nr) break;
        float sc[PAGE];
        float mx = m_r[r];
#pragma unroll
        for (int j = 0; j < PAGE; ++j) {
          const T* krow = kp + (2 * j) * D;
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            part = fmaf(qr[r][i], to_float(krow[lane + 32 * i]), part);
          const float dot = warp_sum(part) * scale;
          const int kpos = kbase + j;
          sc[j] = (kpos < ctx && kpos <= qp[r]) ? dot : kNegInf;
          mx = fmaxf(mx, sc[j]);
        }
        const float alpha = expf(m_r[r] - mx);
        float lsum = 0.f, pv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
#pragma unroll
        for (int j = 0; j < PAGE; ++j) {
          const int kpos = kbase + j;
          if (kpos < ctx && kpos <= qp[r]) {   // masked keys add nothing
            const float p = expf(sc[j] - mx);
            lsum += p;
            const T* vrow = kp + (2 * j + 1) * D;
#pragma unroll
            for (int i = 0; i < DPL; ++i)
              pv[i] = fmaf(p, to_float(vrow[lane + 32 * i]), pv[i]);
          }
        }
        l_r[r] = l_r[r] * alpha + lsum;
        m_r[r] = mx;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + pv[i];
      }
    }
    __syncthreads();
  }

  if (ksplit > 1) {
    // Merge the page-split partials of each row group into its ks == 0 warp.
    float* mine = merge + (size_t)warp * kMaxRows * (D + 2);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nr) break;
      if (lane == 0) {
        mine[r * (D + 2)] = m_r[r];
        mine[r * (D + 2) + 1] = l_r[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) mine[r * (D + 2) + 2 + lane + 32 * i] = acc[r][i];
    }
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nr) break;
      float mg = m_r[r];
      for (int k = 1; k < ksplit; ++k)
        mg = fmaxf(mg, merge[((size_t)(warp + k) * kMaxRows + r) * (D + 2)]);
      const float a0 = expf(m_r[r] - mg);
      l_r[r] *= a0;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= a0;
      for (int k = 1; k < ksplit; ++k) {
        const float* other = merge + ((size_t)(warp + k) * kMaxRows + r) * (D + 2);
        const float a = expf(other[0] - mg);
        l_r[r] += other[1] * a;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += other[2 + lane + 32 * i] * a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r >= nr) break;
    const int m = row0 + r, tq = m / G, h = kh * G + m % G;
    const float l = fmaxf(l_r[r], 1e-20f);
    T* orow = out + ((size_t)(s * TQ + tq) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = from_float<T>(acc[r][i] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16 tiles of many rows (prefill): tensor cores.  Each warp owns 16
// flattened rows and runs mma.sync m16n8k16 (bf16 in, f32 accumulate):
// S = Q.K^T per staged page, the online softmax on the S fragments, then
// O += P.V with P rounded to bf16 (as the JAX flash path casts p to v's
// dtype).  K and V are staged in separate shared arrays whose row stride
// (D + 8 elements) puts the fragment loads on distinct banks.

constexpr int kMmaRows = 16;     // rows per warp on the tensor-core path

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int PAGE>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return size_t(2) * kStagePages * PAGE * (D + 8) * sizeof(__nv_bfloat16) +
         kWarps * sizeof(int);
}

template <int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kv,
                           const int* __restrict__ tables,
                           const int* __restrict__ ctx_lens,
                           const int* __restrict__ q_positions,
                           __nv_bfloat16* __restrict__ out, int TQ, int H,
                           int KH, int B, float scale) {
  constexpr int RS = D + 8;        // shared row stride, elements
  constexpr int KT = D / 16;       // k-steps of S = Q.K^T
  constexpr int NT = D / 8;        // n-tiles of O
  constexpr int SN = PAGE / 8;     // n-tiles of S per page
  constexpr int VEC = 8;           // bf16 per 16-byte load
  constexpr int CHUNKS = D / VEC;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kStagePages * PAGE * RS;
  int* qmax_s = reinterpret_cast<int*>(v_s + kStagePages * PAGE * RS);

  const int s = blockIdx.z, kh = blockIdx.y;
  const int G = H / KH;
  const int M = TQ * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int tile0 = blockIdx.x * kWarps * kMmaRows;
  const int tile_end = min(tile0 + kWarps * kMmaRows, M);
  const int ctx = ctx_lens[s];
  const int npages = pages_to_visit<PAGE>(q_positions + s * TQ, tile0 / G,
                                          (tile_end - 1) / G, ctx, B, qmax_s);

  // this thread's two rows: gid and gid + 8 of the warp's 16
  int qp[2];
  size_t qoff[2];
  bool ok[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int m = tile0 + warp * kMmaRows + gid + 8 * h2;
    ok[h2] = m < M;
    const int mm = ok[h2] ? m : 0;
    const int tq = mm / G, h = kh * G + mm % G;
    qoff[h2] = ((size_t)(s * TQ + tq) * H + h) * D;
    qp[h2] = ok[h2] ? q_positions[s * TQ + tq] : -1;
  }
  uint32_t qa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h2 = r & 1, col = kt * 16 + tig * 2 + (r >> 1) * 8;
      qa[kt][r] = ok[h2] ? *reinterpret_cast<const uint32_t*>(q + qoff[h2] + col)
                         : 0u;
    }
  }

  float o[NT][4], m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int b0 = 0; b0 < npages; b0 += kStagePages) {
    const int np = min(kStagePages, npages - b0);
    for (int c = threadIdx.x; c < np * PAGE * 2 * CHUNKS; c += kThreads) {
      const int chunk = c % CHUNKS, row = c / CHUNKS;
      const int pi = row / (2 * PAGE), rest = row % (2 * PAGE);
      const int t = rest >> 1, which = rest & 1;
      const size_t pg = (size_t)tables[s * B + b0 + pi];
      const __nv_bfloat16* src =
          kv + ((pg * PAGE * 2 + rest) * KH + kh) * D + chunk * VEC;
      __nv_bfloat16* dst = (which ? v_s : k_s) + (pi * PAGE + t) * RS + chunk * VEC;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();
    for (int pi = 0; pi < np; ++pi) {
      const int kbase = (b0 + pi) * PAGE;
      const __nv_bfloat16* kp = k_s + pi * PAGE * RS;
      const __nv_bfloat16* vp = v_s + pi * PAGE * RS;
      float sc[SN][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
        const __nv_bfloat16* krow = kp + (nt * 8 + gid) * RS + tig * 2;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          mma_bf16(sc[nt], qa[kt],
                   *reinterpret_cast<const uint32_t*>(krow + kt * 16),
                   *reinterpret_cast<const uint32_t*>(krow + kt * 16 + 8));
      }
      // mask, scale, online softmax; element e of n-tile nt is row
      // gid + 8*(e>>1), key nt*8 + tig*2 + (e&1)
      bool valid[SN][4];
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kbase + nt * 8 + tig * 2 + (e & 1);
          valid[nt][e] = kpos < ctx && kpos <= qp[e >> 1];
          sc[nt][e] = valid[nt][e] ? sc[nt][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      }
      const float alpha[2] = {expf(m_r[0] - mx[0]), expf(m_r[1] - mx[1])};
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = valid[nt][e] ? expf(sc[nt][e] - mx[e >> 1]) : 0.f;
          sc[nt][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        l_r[h2] = l_r[h2] * alpha[h2] + psum[h2];   // this thread's share
        m_r[h2] = mx[h2];
      }
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[0][0], sc[0][1]);
      pa[1] = pack_bf16(sc[0][2], sc[0][3]);
      pa[2] = SN > 1 ? pack_bf16(sc[SN - 1][0], sc[SN - 1][1]) : 0u;
      pa[3] = SN > 1 ? pack_bf16(sc[SN - 1][2], sc[SN - 1][3]) : 0u;
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
        const __nv_bfloat16* vcol = vp + nt * 8 + gid;
        const uint32_t b0v = pack_bf16(vcol[(tig * 2) * RS], vcol[(tig * 2 + 1) * RS]);
        const uint32_t b1v =
            PAGE == 16 ? pack_bf16(vcol[(tig * 2 + 8) * RS], vcol[(tig * 2 + 9) * RS])
                       : pack_bf16(zero, zero);
        mma_bf16(o[nt], pa, b0v, b1v);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l_r[h2] += __shfl_xor_sync(0xffffffffu, l_r[h2], 1);
    l_r[h2] += __shfl_xor_sync(0xffffffffu, l_r[h2], 2);
    if (!ok[h2]) continue;
    const float l = fmaxf(l_r[h2], 1e-20f);
    __nv_bfloat16* orow = out + qoff[h2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + tig * 2) =
          pack_bf16(o[nt][2 * h2] / l, o[nt][2 * h2 + 1] / l);
  }
}

template <int D, int PAGE>
int launch_mma(const void* q, const void* kv, const void* tables,
               const void* ctx, const void* qpos, void* out, int S, int TQ,
               int H, int KH, int B, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D, PAGE>();
  auto kernel = paged_attention_mma_kernel<D, PAGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int M = TQ * (H / KH);
  const int tile_rows = kWarps * kMmaRows;
  dim3 grid((M + tile_rows - 1) / tile_rows, KH, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), static_cast<const int*>(qpos),
      static_cast<__nv_bfloat16*>(out), TQ, H, KH, B, scale);
  return (int)cudaGetLastError();
}

// Launch geometry of the TQ*G flattened rows of one (sequence, KV head):
// few rows (decode) form one row group whose pages are split over the warps;
// many rows (prefill) give each warp its own rows over every page, 16 of
// them on the tensor cores (bf16), else 4 on the CUDA cores.
struct Geometry {
  bool mma;
  int rows_per_warp, ksplit;
};

inline Geometry geometry(int M, bool bf16) {
  if (M <= kMaxRows) return {false, M, 4};
  if (M <= 2 * kMaxRows) return {false, (M + 1) / 2, 2};
  if (bf16) return {true, kMmaRows, 1};
  return {false, 4, 1};
}

template <typename T, int D, int PAGE>
int launch(const void* q, const void* kv, const void* tables, const void* ctx,
           const void* qpos, void* out, int S, int TQ, int H, int KH, int B,
           float scale, cudaStream_t stream) {
  const int M = TQ * (H / KH);
  const Geometry g = geometry(M, std::is_same<T, __nv_bfloat16>::value);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (g.mma)
      return launch_mma<D, PAGE>(q, kv, tables, ctx, qpos, out, S, TQ, H, KH,
                                 B, scale, stream);
  }
  constexpr size_t smem = smem_bytes<T, D, PAGE>();
  auto kernel = paged_attention_kernel<T, D, PAGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = (kWarps / g.ksplit) * g.rows_per_warp;
  dim3 grid((M + tile_rows - 1) / tile_rows, KH, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<const int*>(qpos), static_cast<T*>(out), TQ, H, KH, B,
      g.rows_per_warp, g.ksplit, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* kv, const void* tables,
                 const void* ctx, const void* qpos, void* out, int S, int TQ,
                 int H, int KH, int D, int page, int B, float scale,
                 cudaStream_t stream) {
#define REPRO_PA_CASE(DD, PP)                                                  \
  if (D == DD && page == PP)                                                   \
    return launch<T, DD, PP>(q, kv, tables, ctx, qpos, out, S, TQ, H, KH, B,   \
                             scale, stream);
  REPRO_PA_CASE(64, 8)
  REPRO_PA_CASE(64, 16)
  REPRO_PA_CASE(128, 8)
  REPRO_PA_CASE(128, 16)
#undef REPRO_PA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Picks the launch geometry from TQ,
// H/KH and dtype.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.
// Launches on `stream` and does not synchronise.
extern "C" int paged_attention_launch(
    const void* q, const void* kv, const void* tables, const void* ctx,
    const void* qpos, void* out, int S, int TQ, int H, int KH, int D, int page,
    int B, int dtype, float scale, void* stream) {
  if (S <= 0 || TQ <= 0 || KH <= 0 || H % KH != 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, kv, tables, ctx, qpos, out, S, TQ, H, KH, D,
                               page, B, scale, st);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, kv, tables, ctx, qpos, out, S, TQ,
                                       H, KH, D, page, B, scale, st);
  return (int)cudaErrorInvalidValue;
}
