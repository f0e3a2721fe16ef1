// WKV6 recurrence (the RWKV6 "Finch" time-mix) for Hopper (sm_90a), CUDA C++
// with plain C entry points loaded through ctypes.
//
// Replaces repro/kernels/rwkv6_scan.py::rwkv6_chunked_scan, the Pallas TPU
// kernel.  Per row s and head h, with an f32 [D, D] state S:
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   r, k, v  [S, T, H, D]  f32 or bf16;  w [S, T, H, D] f32;  u [H, D] f32
//   state    [slots, H, D, D] f32: the row starts from state[slots[s]] (from
//            zeros when fresh[s]) and its state after its last live token is
//            written back there
//   lens     [S] int32: tokens t < lens[s] (clipped to T) are live; the
//            output is 0 past them
//   out      [S, T, H, D] f32
// A row with lens == 0, or with a slot outside the pool, reads and writes no
// state.  Live rows hold distinct slots.  D = 64 (every published RWKV-6).
// At zero state and full lengths this is the Pallas kernel's function; the
// state in and out and the live lengths are what serving adds.
//
// Entry points: rwkv6_scan_launch picks the form from the shape -- decode
// (T == 1) runs the recurrent wkv6_kernel, T > 1 (serve prefill, ragged
// rows) the chunked form, three launches over a workspace the caller
// allocates; rwkv6_scan_workspace_bytes says how many bytes (0 for T == 1).
//
// What bounds it on an H100.  Per live token and head the recurrence does
// ~5 D^2 = 20k f32 operations and moves r, k, v, w and o (D values each: 896
// bytes with bf16 r, k, v).  Decode (T = 1, 32 rows of rwkv6-3b, H = 40) is
// bound by the state, read and written once per row and head (16 KB each
// way): 42 MB, 12.5 us.  Prefill (one 512-token chunk, 300 live tokens, bf16)
// moves 14.2 MB (r, k, v, w of the live tokens, the f32 output, the state
// once each way), 4.3 us at 3.35 TB/s.  Its operations, in chunks of L = 16
// tokens: (r (.) a) S and (k (.) b)^T V take 2 * 16 * 64 * 64 flops each and
// A V 2 * 16 * 16 * 64, 0.29 MFLOP per chunk and head; split TF32 does each
// product as 3 tensor-core products, 0.67 GFLOP over the 19 x 40 live chunks,
// 1.4 us at 495 TFLOP/s; the intra-chunk decays and scores run on the CUDA
// cores, ~25 k operations per chunk and head, 19 M in all, 0.6 us at 33.5 T
// fma/s.  So bytes bound it, 4.3 us.  The design adds the chunk states it
// hands from pass to pass through the workspace (12.5 MB, written, read and
// rewritten by the scan, read again: ~70 MB moved in all) and three
// dependent launches: it takes 35.6 us there (chunk state 8.8, scan 8.0,
// output 15.6), against 84.1 us for the recurrent form (chip_smoke.py and
// tools/scan_variants.py, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Recurrent form (T == 1).  Column j of S evolves on its own (S[:, j] reads
// only v_j), so a block owns 32 columns of one (row, head) -- grid (S, H,
// D / 32) -- and keeps them in registers for the whole row: 4 threads per
// column, each holding 16 of its 64 entries (lane = quarter * 8 + column, so
// the four threads of a column are lanes 8 apart and add their partial dot
// products with two shuffles).  The state is read once (or zeroed) and
// written once.  The block walks the row's live tokens in runs of 32: r, k,
// w (all 64 entries) and v (the block's 32 columns) are staged in shared
// memory as f32, with each quarter's bonus sum  sum_i r_i u_i k_i  per token;
// then every thread steps through the run: o_t from S_{t-1}, then its 16
// entries of S_t.  At decode it is 1.1x its bound; at prefill it is bound by
// the latency of the serial walk (~550 cycles a token).
//
// Chunked form (T > 1), division-free.  For a chunk of L tokens from c, with
// S = S_{c-1}, a_t = prod_{m=c}^{t-1} w_m, b_j = prod_{m=j+1}^{c+L-1} w_m and
// W = prod_{m=c}^{c+L-1} w_m (elementwise over the D key channels):
//   o_t = (r_t (.) a_t) S + sum_{c<=j<t} A_tj v_j + (r_t . (u (.) k_t)) v_t
//   A_tj = sum_i r_ti k_ji prod_{m=j+1}^{t-1} w_mi
//   S_{c+L-1} = diag(W) S + sum_j (k_j (.) b_j)^T v_j
// Every factor that multiplies r, k or S is a product of w over an interval,
// and every w lies in [0, 1], so every factor lies in [0, 1]: no factor can
// exceed 1, exact zeros stay exact, nothing overflows and nothing is divided.
// (The Pallas kernel forms k / P_t, P_t the decay since the chunk's start,
// which overflows f32 once -log w summed over a chunk passes 88.)  The
// intra-chunk decay prod_{m=j+1}^{t-1} w_m has no product form without a
// division, so it is a running product along t on the CUDA cores; the three
// matrix products go to the tensor cores.  Three launches, each filling the
// card from one prefill row:
//   1. wkv6_chunk_state_kernel, grid (S x chunks, H): a chunk's W and its own
//      state term U = (k (.) b)^T V into the workspace.
//   2. wkv6_chunk_scan_kernel, grid (S x D*D / 256, H): per state entry, the
//      short walk over the row's chunks S_c = W_c (.) S_{c-1} + U_c (19 steps
//      for 300 tokens), which leaves in each chunk's slot the state entering
//      it, and writes the last state to the pool.
//   3. wkv6_chunk_out_kernel, grid (S x chunks, H): the chunk's scores A (with
//      the bonus on the diagonal) and its outputs [(r (.) a) | A] [S; V], one
//      product of depth D + L.
// The workspace (~12.5 MB at the prefill above) stays in the 50 MB L2.  The
// other design -- one block per (row, head, few state columns) walking the
// chunks serially -- recomputes A per column group and waits on each chunk
// in turn (19 serial steps of ~1 us); these passes have no serial step longer
// than the scan's 19 fmas.
//
// Products on the tensor cores are split TF32 on mma.sync.m16n8k8 (as in
// moe_ffn.cu): a * b = hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b), hi =
// rna_tf32(v), lo = rna_tf32(v - hi), with f32 accumulation, for bf16 inputs
// too (r (.) a and k (.) b are f32 whatever r and k are).
//
// Accuracy against the plain version (rwkv6_scan.py's TOLERANCE, unchanged:
// per token 5 roundings, each <= u A_t, A_t the state of the recurrence run
// on absolute values, combined probabilistically, plus sqrt(D + 3) for the
// output's sum).  Every term of S_t or o_t is, exactly, an interval decay
// times r, k and v (or S_0).  The plain version rounds its running state a
// few times per token; the chunked form rounds each running decay product
// (a_t, b_j, W's chain of chunk products, the intra-chunk product) once per
// token, relative to a factor <= 1 of a term that A_t bounds, so one rounding
// a token.  Per chunk it adds a constant: a split-TF32 product drops lo * lo
// and the remainders' roundings, <= 3 * 2^-22 = 12 u of the product, and
// the mma sums 80 terms in f32; 12 u of o_abs plus the sum's roundings
// (~sqrt(80) u with random signs) is within the output's own sqrt(D + 3)
// term (8.2 * 8 u at lambda = 8), and at state level, spread over a chunk's
// 16 tokens, under one rounding a token.  So the form's roundings stay within
// the bound's 5 a token.  A single TF32 product errs by 2^-11 = 8192 u of
// itself and does not fit (chip_smoke.py plants such a copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kCols = 32;                     // columns of S per block
constexpr int kQuarters = 4;                  // threads per column
constexpr int kRows = kD / kQuarters;         // entries of S per thread
constexpr int kThreads = kCols * kQuarters;   // 128
constexpr int kRun = 32;                      // tokens staged at a time
constexpr int kPad = kRows + 4;               // quarter stride: the four
                                              // quarters' float4 loads hit
                                              // distinct banks

static_assert(kRun * kQuarters == kThreads, "one bonus sum per thread");

struct Stage {
  float r[kRun][kQuarters][kPad];
  float k[kRun][kQuarters][kPad];
  float w[kRun][kQuarters][kPad];
  float v[kRun][kCols];
  float bonus[kRun][kQuarters];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// o_t of this thread's column: its quarter's partial of r_t . S plus v_j
// times the quarter's bonus sum, summed over the four quarters.  Every lane
// of the warp calls it (shuffles).
__device__ __forceinline__ float read_out(const float (&S)[kRows],
                                          const float* rr, float vj,
                                          float bonus) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; i += 4) {
    const float4 r4 = *reinterpret_cast<const float4*>(rr + i);
    a0 = fmaf(r4.x, S[i], a0);
    a1 = fmaf(r4.y, S[i + 1], a1);
    a2 = fmaf(r4.z, S[i + 2], a2);
    a3 = fmaf(r4.w, S[i + 3], a3);
  }
  float o = fmaf(vj, bonus, (a0 + a1) + (a2 + a3));
  o += __shfl_xor_sync(0xffffffffu, o, 8);
  o += __shfl_xor_sync(0xffffffffu, o, 16);
  return o;
}

// S <- diag(w) S + k v_j on this thread's 16 entries of column j.
__device__ __forceinline__ void advance_state(float (&S)[kRows],
                                              const float* ww,
                                              const float* kk, float vj) {
#pragma unroll
  for (int i = 0; i < kRows; i += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(ww + i);
    const float4 k4 = *reinterpret_cast<const float4*>(kk + i);
    S[i] = fmaf(w4.x, S[i], k4.x * vj);
    S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
    S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
    S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
  }
}

template <typename Elt>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
            const Elt* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            const int* __restrict__ slots, const int* __restrict__ lens,
            const int* __restrict__ fresh, float* __restrict__ out, int T,
            int H, int n_slots) {
  __shared__ __align__(16) Stage sm;
  const int row = blockIdx.x, h = blockIdx.y;
  const int col0 = blockIdx.z * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3;                  // entries q*16 .. q*16+15
  const int jc = warp * 8 + (lane & 7);     // column within the block
  const int j = col0 + jc;                  // column of S

  const int slot = slots[row];
  int len = lens[row];
  if (slot < 0 || slot >= n_slots) len = 0;
  len = len < 0 ? 0 : (len > T ? T : len);

  const size_t tok = (size_t)H * kD;        // stride between tokens
  const size_t base = (size_t)row * T * tok + (size_t)h * kD;

  for (int e = tid; e < (T - len) * kCols; e += kThreads) {
    const int t = len + e / kCols, c = e % kCols;
    out[base + t * tok + col0 + c] = 0.f;
  }
  if (len == 0) return;                     // uniform over the block

  float S[kRows];
  float* st = state + (((size_t)slot * H + h) * kD + q * kRows) * kD + j;
  if (fresh[row]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) S[i] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) S[i] = st[(size_t)i * kD];
  }

  const float* uh = u + (size_t)h * kD;
  for (int t0 = 0; t0 < len; t0 += kRun) {
    const int run = min(kRun, len - t0);
    __syncthreads();                        // the last run's reads are done
    for (int e = tid; e < run * kD; e += kThreads) {
      const int t = e / kD, i = e % kD;
      const size_t g = base + (size_t)(t0 + t) * tok + i;
      sm.r[t][i / kRows][i % kRows] = to_float(r[g]);
      sm.k[t][i / kRows][i % kRows] = to_float(k[g]);
      sm.w[t][i / kRows][i % kRows] = w[g];
    }
    for (int e = tid; e < run * kCols; e += kThreads) {
      const int t = e / kCols, c = e % kCols;
      sm.v[t][c] = to_float(v[base + (size_t)(t0 + t) * tok + col0 + c]);
    }
    __syncthreads();
    {
      const int t = tid / kQuarters, qq = tid % kQuarters;
      if (t < run) {
        float b = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          b = fmaf(sm.r[t][qq][i] * __ldg(uh + qq * kRows + i),
                   sm.k[t][qq][i], b);
        sm.bonus[t][qq] = b;
      }
    }
    __syncthreads();
    for (int t = 0; t < run; ++t) {
      const float vj = sm.v[t][jc];
      const float o = read_out(S, sm.r[t][q], vj, sm.bonus[t][q]);
      advance_state(S, sm.w[t][q], sm.k[t][q], vj);
      if (q == 0) out[base + (size_t)(t0 + t) * tok + j] = o;
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) st[(size_t)i * kD] = S[i];
}

// ---------------------------------------------------------------------------
// Chunked form (T > 1)

constexpr int kL = 16;                  // tokens per chunk
constexpr int kChunkThreads = 128;      // 4 warps
constexpr int kScanThreads = 256;
constexpr int kLdA = kD + 4;            // rows read as an mma A operand
                                        // (row gid, column tig): 68 floats
                                        // put the 32 lanes on 32 banks
constexpr int kLdB = kD + 8;            // rows read as a B operand (row tig,
                                        // column gid): 72 floats
constexpr int kLdS = kL + 4;            // the scores, read as A: 20 floats
constexpr int kStateElems = kD * kD;
constexpr int kChunkElems = kStateElems + kD;   // U, then W, per chunk/head

static_assert(kL * kD == 8 * kChunkThreads, "8 values of a chunk a thread");
static_assert(kL * 8 == kChunkThreads, "a thread per (j, 8 key channels)");

// The chunk's entries in the workspace: [S][chunks][H] of (U [D][D], W [D]).
__device__ __forceinline__ size_t chunk_index(int row, int c, int h, int nch,
                                              int H) {
  return (((size_t)row * nch + c) * H + h) * kChunkElems;
}

__device__ __forceinline__ int live_length(const int* slots, const int* lens,
                                           int row, int T, int n_slots) {
  const int slot = slots[row];
  int len = lens[row];
  if (slot < 0 || slot >= n_slots) len = 0;
  return len < 0 ? 0 : (len > T ? T : len);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

// v = hi + lo to ~2^-22 of v, hi = rna_tf32(v), lo = rna_tf32(v - hi), by
// integer rounding of the bit pattern (the values of cvt.rna.tf32.f32 for
// finite inputs, at half its instructions on sm_90; moe_ffn.cu's split).
// The tensor cores read only a TF32 operand's upper 19 bits.
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

// The A fragment of an m16n8k8 product at (row m0, depth k0) of a matrix
// whose element (m, k) is at p[m * ld_m + k * ld_k]: rows gid, gid + 8,
// depths tig, tig + 4.
__device__ __forceinline__ void load_a(const float* p, int ld_m, int ld_k,
                                       int gid, int tig, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(p[gid * ld_m + tig * ld_k], hi[0], lo[0]);
  split_tf32(p[(gid + 8) * ld_m + tig * ld_k], hi[1], lo[1]);
  split_tf32(p[gid * ld_m + (tig + 4) * ld_k], hi[2], lo[2]);
  split_tf32(p[(gid + 8) * ld_m + (tig + 4) * ld_k], hi[3], lo[3]);
}

// The B fragment at (depth k0, column n0) of a row-major [k][n] matrix with
// row stride ld: depths tig, tig + 4 of column gid.
__device__ __forceinline__ void load_b(const float* p, int ld, int gid, int tig,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(p[tig * ld + gid], hi[0], lo[0]);
  split_tf32(p[(tig + 4) * ld + gid], hi[1], lo[1]);
}

// Eight consecutive values from 16-byte aligned memory, as f32.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

template <typename Elt>
__device__ __forceinline__ void load8_scalar(const Elt* p, float (&o)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = to_float(p[e]);
}

// Stage a chunk's tokens t0 .. t0 + cnt - 1 of one (row, head) as f32, 8
// values a thread (16-byte loads where r, k, v and w are 16-byte aligned,
// `vec`; the offsets within them are multiples of 64 values), every load
// issued before any store; the rest of the chunk reads as r = k = v = 0,
// w = 1 (no term, no decay).  `sr` may be null (r not needed).
template <typename Elt>
__device__ __forceinline__ void stage_chunk(
    const Elt* __restrict__ r, const Elt* __restrict__ k,
    const Elt* __restrict__ v, const float* __restrict__ w, size_t base,
    size_t tok, int t0, int cnt, bool vec, float (*sr)[kLdA],
    float (*sk)[kLdB], float (*sv)[kLdB], float (*sw)[kLdB]) {
  const int t = threadIdx.x / 8, i = (threadIdx.x % 8) * 8;
  float fr[8], fk[8], fv[8], fw[8];
  if (t < cnt && vec) {
    const size_t g = base + (size_t)(t0 + t) * tok + i;
    if (sr) load8(r + g, fr);
    load8(k + g, fk);
    load8(v + g, fv);
    load8(w + g, fw);
  } else if (t < cnt) {
    const size_t g = base + (size_t)(t0 + t) * tok + i;
    if (sr) load8_scalar(r + g, fr);
    load8_scalar(k + g, fk);
    load8_scalar(v + g, fv);
    load8_scalar(w + g, fw);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) fr[e] = fk[e] = fv[e] = 0.f, fw[e] = 1.f;
  }
  if (sr) store8(&sr[t][i], fr);
  store8(&sk[t][i], fk);
  store8(&sv[t][i], fv);
  store8(&sw[t][i], fw);
}

// Pass 1: a chunk's decay W = prod w and its own state term
// U = (k (.) b)^T V, b_j = prod_{m>j} w_m, into the workspace.
template <typename Elt>
__global__ void __launch_bounds__(kChunkThreads)
wkv6_chunk_state_kernel(const Elt* __restrict__ k, const Elt* __restrict__ v,
                        const float* __restrict__ w,
                        const int* __restrict__ slots,
                        const int* __restrict__ lens, float* __restrict__ ws,
                        int T, int H, int n_slots, int nch, bool vec) {
  __shared__ __align__(16) float sk[kL][kLdB];
  __shared__ __align__(16) float sv[kL][kLdB];
  __shared__ __align__(16) float sw[kL][kLdB];
  const int c = blockIdx.x % nch, row = blockIdx.x / nch, h = blockIdx.y;
  const int len = live_length(slots, lens, row, T, n_slots);
  const int t0 = c * kL;
  if (t0 >= len) return;                    // uniform over the block
  const int tid = threadIdx.x;
  const size_t tok = (size_t)H * kD;
  const size_t base = (size_t)row * T * tok + (size_t)h * kD;
  stage_chunk<Elt>(nullptr, k, v, w, base, tok, t0, min(kL, len - t0), vec,
                   nullptr, sk, sv, sw);
  __syncthreads();
  float* out = ws + chunk_index(row, c, h, nch, H);
  if (tid < kD) {                           // k_j <- k_j (.) b_j; W
    float b = 1.f;
#pragma unroll
    for (int t = kL - 1; t >= 0; --t) {
      sk[t][tid] = __fmul_rn(sk[t][tid], b);
      b = __fmul_rn(b, sw[t][tid]);
    }
    out[kStateElems + tid] = b;
  }
  __syncthreads();
  // U [D x D] = (k (.) b)^T [D x L] . V [L x D]: warp m takes rows 16 m ..
  // 16 m + 15 of U, all 64 columns.
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = (tid >> 5) * 16;
  float acc[kD / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < kL; ks += 8) {
    uint32_t a_hi[4], a_lo[4];
    load_a(&sk[ks][m0], 1, kLdB, gid, tig, a_hi, a_lo);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      uint32_t b_hi[2], b_lo[2];
      load_b(&sv[ks][nt * 8], kLdB, gid, tig, b_hi, b_lo);
      mma_split(acc[nt], a_hi, a_lo, b_hi, b_lo);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int j = nt * 8 + 2 * tig;
    *reinterpret_cast<float2*>(out + (m0 + gid) * kD + j) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (m0 + gid + 8) * kD + j) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Pass 2: per state entry (i, j) of a live row, S_c = W_c[i] S_{c-1} + U_c
// over the row's chunks from its start state; each chunk's U is replaced by
// the state entering the chunk, and the last state goes back to the pool.
__global__ void __launch_bounds__(kScanThreads)
wkv6_chunk_scan_kernel(float* __restrict__ ws, float* __restrict__ state,
                       const int* __restrict__ slots,
                       const int* __restrict__ lens,
                       const int* __restrict__ fresh, int T, int H,
                       int n_slots, int nch) {
  constexpr int kBlocks = kStateElems / kScanThreads;      // per row
  const int e = blockIdx.x % kBlocks * kScanThreads + threadIdx.x;  // i*D+j
  const int row = blockIdx.x / kBlocks, h = blockIdx.y;
  const int len = live_length(slots, lens, row, T, n_slots);
  if (len == 0) return;
  const int chunks = (len + kL - 1) / kL;
  float* st = state + ((size_t)slots[row] * H + h) * kStateElems + e;
  float S = fresh[row] ? 0.f : *st;
  float* p = ws + chunk_index(row, 0, h, nch, H) + e;
  const size_t step = (size_t)H * kChunkElems;
  const int wi = kStateElems - e + e / kD;   // p + wi: W[i], i = e / D
  for (int c0 = 0; c0 < chunks; c0 += 8, p += 8 * step) {
    float uc[8], wc[8];                      // eight chunks' loads in flight
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c0 + c < chunks) {
        uc[c] = p[c * step];
        wc[c] = p[c * step + wi];
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c0 + c < chunks) {
        p[c * step] = S;
        S = fmaf(wc[c], S, uc[c]);
      }
    }
  }
  *st = S;
}

// Pass 3: a chunk's outputs o = [(r (.) a) | A] . [S_{c-1}; V], zeros past
// the row's live tokens.
template <typename Elt>
__global__ void __launch_bounds__(kChunkThreads)
wkv6_chunk_out_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
                      const Elt* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const int* __restrict__ slots,
                      const int* __restrict__ lens,
                      const float* __restrict__ ws, float* __restrict__ out,
                      int T, int H, int n_slots, int nch, bool vec) {
  __shared__ __align__(16) float sr[kL][kLdA];      // r, then r (.) a
  __shared__ __align__(16) float sk[kL][kLdB];
  __shared__ __align__(16) float sv[kL][kLdB];
  __shared__ __align__(16) float sw[kL][kLdB];
  __shared__ __align__(16) float ss[kD][kLdB];      // S_{c-1}
  __shared__ __align__(16) float part[kL][kL][8];   // A's partial sums
  __shared__ __align__(16) float sa[kL][kLdS];      // A
  const int c = blockIdx.x % nch, row = blockIdx.x / nch, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = live_length(slots, lens, row, T, n_slots);
  const int t0 = c * kL;
  const size_t tok = (size_t)H * kD;
  const size_t base = (size_t)row * T * tok + (size_t)h * kD;
  const int tz = max(t0, len), te = min(t0 + kL, T);
  for (int e = tid; e < (te - tz) * kD; e += kChunkThreads)
    out[base + (size_t)(tz + e / kD) * tok + e % kD] = 0.f;
  if (t0 >= len) return;                    // uniform over the block
  const int cnt = min(kL, len - t0);

  const float* s_in = ws + chunk_index(row, c, h, nch, H);
  for (int e = tid; e < kStateElems / 4; e += kChunkThreads)
    cp_async16(&ss[e / (kD / 4)][(e % (kD / 4)) * 4], s_in + e * 4);
  asm volatile("cp.async.commit_group;\n" ::);
  stage_chunk<Elt>(r, k, v, w, base, tok, t0, cnt, vec, sr, sk, sv, sw);
  __syncthreads();

  // Scores: thread (j, key channels i0 .. i0 + 7) walks t > j with the
  // running products p_i = prod_{m=j+1}^{t-1} w_mi, and puts the bonus
  // r_j . (u (.) k_j) at t = j.
  {
    const int j = tid >> 3, g = tid & 7, i0 = g * 8;
    const float* uh = u + (size_t)h * kD + i0;
    float kj[8], p[8], d = 0.f;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      kj[ii] = sk[j][i0 + ii];
      p[ii] = 1.f;
      d = fmaf(sr[j][i0 + ii], __fmul_rn(__ldg(uh + ii), kj[ii]), d);
    }
    part[j][j][g] = d;
    for (int t = 1; t < kL; ++t) {
      if (t > j) {
        float s = 0.f;
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          s = fmaf(sr[t][i0 + ii], __fmul_rn(kj[ii], p[ii]), s);
          p[ii] = __fmul_rn(p[ii], sw[t][i0 + ii]);
        }
        part[t][j][g] = s;
      }
    }
  }
  __syncthreads();
  if (tid < kD) {                           // r_t <- r_t (.) a_t
    float a = 1.f;
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      sr[t][tid] = __fmul_rn(sr[t][tid], a);
      a = __fmul_rn(a, sw[t][tid]);
    }
  } else {                                  // A = the partial sums' total
    for (int e = tid - kD; e < kL * kL; e += kChunkThreads - kD) {
      const int t = e / kL, j = e % kL;
      float s = 0.f;
      if (j <= t) {
        const float4 x = *reinterpret_cast<const float4*>(&part[t][j][0]);
        const float4 y = *reinterpret_cast<const float4*>(&part[t][j][4]);
        s = ((x.x + x.y) + (x.z + x.w)) + ((y.x + y.y) + (y.z + y.w));
      }
      sa[t][j] = s;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // o [L x 16 columns of this warp] over depth D (S_{c-1}) then L (V).
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = (tid >> 5) * 16;
  float acc[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < kD; ks += 8) {
    uint32_t a_hi[4], a_lo[4];
    load_a(&sr[0][ks], kLdA, 1, gid, tig, a_hi, a_lo);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b_hi[2], b_lo[2];
      load_b(&ss[ks][n0 + nt * 8], kLdB, gid, tig, b_hi, b_lo);
      mma_split(acc[nt], a_hi, a_lo, b_hi, b_lo);
    }
  }
#pragma unroll
  for (int ks = 0; ks < kL; ks += 8) {
    uint32_t a_hi[4], a_lo[4];
    load_a(&sa[0][ks], kLdS, 1, gid, tig, a_hi, a_lo);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b_hi[2], b_lo[2];
      load_b(&sv[ks][n0 + nt * 8], kLdB, gid, tig, b_hi, b_lo);
      mma_split(acc[nt], a_hi, a_lo, b_hi, b_lo);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = n0 + nt * 8 + 2 * tig;
    if (gid < cnt)
      *reinterpret_cast<float2*>(out + base + (size_t)(t0 + gid) * tok + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (gid + 8 < cnt)
      *reinterpret_cast<float2*>(out + base + (size_t)(t0 + gid + 8) * tok +
                                 col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The form a shape takes: the chunked one for every T > 1.
__host__ __forceinline__ bool chunked(int T) {
  return T > 1;
}

size_t workspace_bytes(int S, int T, int H) {
  const size_t nch = (T + kL - 1) / kL;
  return chunked(T) ? (size_t)S * nch * H * kChunkElems * sizeof(float) : 0;
}

template <typename Elt>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, const void* slots, const void* lens,
           const void* fresh, void* out, void* workspace, int S, int T, int H,
           int n_slots, cudaStream_t st) {
  const Elt* r_ = static_cast<const Elt*>(r);
  const Elt* k_ = static_cast<const Elt*>(k);
  const Elt* v_ = static_cast<const Elt*>(v);
  const float* w_ = static_cast<const float*>(w);
  const float* u_ = static_cast<const float*>(u);
  float* state_ = static_cast<float*>(state);
  const int* slots_ = static_cast<const int*>(slots);
  const int* lens_ = static_cast<const int*>(lens);
  const int* fresh_ = static_cast<const int*>(fresh);
  float* out_ = static_cast<float*>(out);
  if (!chunked(T)) {
    const dim3 grid(S, H, kD / kCols);
    wkv6_kernel<Elt><<<grid, kThreads, 0, st>>>(
        r_, k_, v_, w_, u_, state_, slots_, lens_, fresh_, out_, T, H,
        n_slots);
    return (int)cudaGetLastError();
  }
  const int nch = (T + kL - 1) / kL;
  if (workspace == nullptr ||
      (long long)S * max(nch, kStateElems / kScanThreads) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool vec = aligned(r) && aligned(k) && aligned(v) && aligned(w);
  const dim3 chunks(S * nch, H);
  wkv6_chunk_state_kernel<Elt><<<chunks, kChunkThreads, 0, st>>>(
      k_, v_, w_, slots_, lens_, ws, T, H, n_slots, nch, vec);
  wkv6_chunk_scan_kernel<<<dim3(S * (kStateElems / kScanThreads), H),
                           kScanThreads, 0, st>>>(
      ws, state_, slots_, lens_, fresh_, T, H, n_slots, nch);
  wkv6_chunk_out_kernel<Elt><<<chunks, kChunkThreads, 0, st>>>(
      r_, k_, v_, w_, u_, slots_, lens_, ws, out_, T, H, n_slots, nch, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long rwkv6_scan_workspace_bytes(int S, int T, int H, int D) {
  if (S <= 0 || T <= 0 || H <= 0 || H > 65535 || D != kD) return -1;
  return (long long)workspace_bytes(S, T, H);
}

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* state,
                                 const void* slots, const void* lens,
                                 const void* fresh, void* out, void* workspace,
                                 int S, int T, int H, int D, int n_slots,
                                 int dtype, void* stream) {
  if (S <= 0 || T <= 0 || H <= 0 || H > 65535 || D != kD || n_slots <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, state, slots, lens, fresh, out,
                         workspace, S, T, H, n_slots, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, slots, lens, fresh,
                                 out, workspace, S, T, H, n_slots, st);
  return (int)cudaErrorInvalidValue;
}
