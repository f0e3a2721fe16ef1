// Mamba (S6) selective scan for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces repro/kernels/mamba_scan.py::mamba_chunked_scan, the Pallas TPU
// kernel.  Per row r, channel c and state s, with an f32 state h [di, ds]:
//   dA_t = exp(dt_t[c] A[c, s]),   dBx_t = (dt_t[c] x_t[c]) B_t[s]
//   h_t = dA_t h_{t-1} + dBx_t,    y_t[c] = sum_s C_t[s] h_t[c, s]
//   dt       [S, T, di] f32 (after the softplus)
//   x        [S, T, di] f32 or bf16 (the conv output)
//   B, C     [S, T, ds] f32;  A [di, ds] f32 (-exp(A_log))
//   state    [slots, di, ds] f32: the row starts from state[slots[r]] (from
//            zeros when fresh[r]) and its state after its last live token is
//            written back there
//   lens     [S] int32: tokens t < lens[r] (clipped to T) are live; the
//            output is 0 past them
//   out      [S, T, di] f32
// A row with lens == 0, or with a slot outside the pool, reads and writes no
// state.  Live rows hold distinct slots.  ds = 16 (jamba's).  At zero
// state and full lengths this is the Pallas kernel's function on dA and dBx
// formed the same way; the Pallas kernel takes dA and dBx as two
// [B, T, di, ds] tensors, this one forms them in registers.
//
// Entry point: mamba_scan_launch picks the form from the shape -- decode
// (T == 1) runs the recurrent mamba_scan_kernel, T > 1 (serve prefill, ragged
// rows) the segmented mamba_segment_kernel.
//
// What bounds it on an H100.  Per live token and channel it reads dt and x
// and writes y (10 bytes with a bf16 x; B and C are shared by a row's
// channels), and does ds exponentials and ~5 ds f32 operations.  A
// 512-token prefill chunk of jamba (di = 16384, ds = 16, 300 live tokens)
// moves ~63 MB (dt and y in f32 dominate), 19 us at 3.35 TB/s, and does 79 M
// exponentials, 19 us on the special-function units (16 per SM and clock):
// the two bounds meet, so each exponential is computed once.  Decode (T = 1,
// 32 rows) is bound by the f32 state, read and written once per live row
// (1 MB each way): ~60 MB, 18 us.
//
// Recurrent form (T == 1).  Channels evolve independently, so parallelism
// comes from rows x channels.  A channel's ds states are split over G = ds /
// 4 threads (4 states each, in registers; lane = quarter * (32 / G) +
// channel, so the G threads of a channel are lanes 32 / G apart and add their
// partial read-outs with log2(G) shuffles).  A block of 128 threads owns
// 128 / G channels of one row -- grid (di / channels, S) -- so a decode tick
// of 32 rows gives 16,384 blocks.  The state is read once (or zeroed) and
// written once.  It walks the live tokens in runs of 32 staged in shared
// memory; at decode that is one token, 1.39x its bound.  At prefill the
// serial walk (300 tokens, ~15 warps an SM) is bound by latency.
//
// Segmented form (T > 1).  A run of 32 tokens is split into 4 segments of 8
// handled by different warps, so a block of 16 channels has 8 warps (two
// per segment) and a prefill row of jamba gives 1,024 blocks.  The operator
// is the Pallas kernel's own, (a, b) o (a', b') = (a a', a' b + b'): no
// division, every factor a product of exponentials of dt A <= 0, in [0, 1].
// Per run:
//   1. each segment scans its tokens from a zero state, keeping in registers
//      h_local, its decay product P_t = prod dA up to t, its partial outputs
//      C_t . h_local_t and q_t = C_t (.) P_t (each exponential once);
//   2. the segments' carries are combined in shared memory, in order, from
//      the state entering the run: h_in(g + 1) = P_end(g) (.) h_in(g) +
//      h_local_end(g), the last one the state leaving the run;
//   3. each segment applies its carry: y_t = C_t . h_local_t + q_t . h_in,
//      since h_t = h_local_t + P_t (.) h_in.
// dt, x, B and C of the next run are staged with cp.async while the current
// one is computed (double buffered; rows that are not 16-byte aligned are
// staged with plain loads).  The segmented form does ~15.6 instructions per
// (token, channel, state) in its scan pass alone -- expf's 8, the products,
// the update, the read-out, P and q -- ~45 us at the prefill above at 128
// lane instructions per SM and clock: issue, not bytes or the
// exponentials, bounds this design.  It takes 101 us there, against 119.5
// us for the recurrent form (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// Rounding, both forms.  expf (never __expf, no --use_fast_math) keeps the
// exponential within 2 ulp, which the check's bound counts, and the products
// dt*A, dt*x and (dt*x)*B are __fmul_rn, never contracted into an fma, so
// they round as the plain version's do.  The segmented form rounds a few
// values more: the running product P_t (one rounding a token, relative to
// P_t <= 1), q_t = C_t P_t and the carry terms (P_t h_in and the combine's
// fma, each relative to a term of h_t that A_t, the absolute-value state of
// the check, bounds).  That is about one rounding a token more than the
// recurrent form's 3 (update and read-out), within the 11 a token that
// mamba_scan.py's ROUNDINGS_PER_TOKEN grants (8 of them for two
// exponentials that differ by at most 2 ulp each, which they seldom do).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;                       // states per thread
constexpr int kRun = 32;                      // tokens staged at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int DS>
struct Shape {
  static constexpr int kGroup = DS / kPer;              // threads per channel
  static constexpr int kLanes = 32 / kGroup;            // channels per warp
  static constexpr int kCh = kThreads / kGroup;         // channels per block
  static_assert(DS % kPer == 0 && 32 % kGroup == 0, "ds = 16");
};

template <int DS>
struct Stage {
  float dt[kRun][Shape<DS>::kCh];
  float x[kRun][Shape<DS>::kCh];
  float y[kRun][Shape<DS>::kCh];
  float b[kRun][DS];
  float c[kRun][DS];
};

template <typename Elt, int DS>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const Elt* __restrict__ x,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, float* __restrict__ state,
                  const int* __restrict__ slots, const int* __restrict__ lens,
                  const int* __restrict__ fresh, float* __restrict__ out,
                  int T, int di, int n_slots) {
  using Sh = Shape<DS>;
  __shared__ __align__(16) Stage<DS> sm;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * Sh::kCh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane / Sh::kLanes;                 // states q*4 .. q*4+3
  const int jc = warp * Sh::kLanes + lane % Sh::kLanes;   // channel in block
  const int c = c0 + jc;
  const bool active = c < di;
  const int nch = min(Sh::kCh, di - c0);           // channels of this block

  const int slot = slots[row];
  int len = lens[row];
  if (slot < 0 || slot >= n_slots) len = 0;
  len = len < 0 ? 0 : (len > T ? T : len);

  const size_t base = (size_t)row * T * di + c0;   // (row, t = 0, c0)
  for (int e = tid; e < (T - len) * Sh::kCh; e += kThreads) {
    const int t = len + e / Sh::kCh, cc = e % Sh::kCh;
    if (cc < nch) out[base + (size_t)t * di + cc] = 0.f;
  }
  if (len == 0) return;                            // uniform over the block

  float h[kPer], a[kPer];
  float4* st = reinterpret_cast<float4*>(
      state + ((size_t)slot * di + (active ? c : 0)) * DS + q * kPer);
  if (active && !fresh[row]) {
    const float4 v = *st;
    h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) h[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    a[i] = active ? __ldg(A + (size_t)c * DS + q * kPer + i) : 0.f;

  const size_t bc = (size_t)row * T * DS;
  for (int t0 = 0; t0 < len; t0 += kRun) {
    const int run = min(kRun, len - t0);
    __syncthreads();                    // the last run's reads are done
    for (int e = tid; e < run * Sh::kCh; e += kThreads) {
      const int t = e / Sh::kCh, cc = e % Sh::kCh;
      const size_t g = base + (size_t)(t0 + t) * di + cc;
      const bool in = cc < nch;
      sm.dt[t][cc] = in ? dt[g] : 0.f;
      sm.x[t][cc] = in ? to_float(x[g]) : 0.f;
    }
    for (int e = tid; e < run * DS; e += kThreads) {
      const int t = e / DS, s = e % DS;
      sm.b[t][s] = Bm[bc + (size_t)(t0 + t) * DS + s];
      sm.c[t][s] = Cm[bc + (size_t)(t0 + t) * DS + s];
    }
    __syncthreads();
    for (int t = 0; t < run; ++t) {
      const float dtv = sm.dt[t][jc];
      const float dtx = __fmul_rn(dtv, sm.x[t][jc]);
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int s = q * kPer + i;
        const float dA = expf(__fmul_rn(dtv, a[i]));
        h[i] = fmaf(dA, h[i], __fmul_rn(dtx, sm.b[t][s]));
        y = fmaf(sm.c[t][s], h[i], y);
      }
#pragma unroll
      for (int off = Sh::kLanes; off < 32; off <<= 1)
        y += __shfl_xor_sync(0xffffffffu, y, off);
      if (q == 0) sm.y[t][jc] = y;
    }
    __syncthreads();
    for (int e = tid; e < run * Sh::kCh; e += kThreads) {
      const int t = e / Sh::kCh, cc = e % Sh::kCh;
      if (cc < nch) out[base + (size_t)(t0 + t) * di + cc] = sm.y[t][cc];
    }
  }
  if (active) *st = make_float4(h[0], h[1], h[2], h[3]);
}

// ---------------------------------------------------------------------------
// Segmented form (T > 1), ds = 16

constexpr int kSegThreads = 256;          // 8 warps
constexpr int kSegCh = 16;                // channels per block
constexpr int kSegs = 4;                  // segments of a run
constexpr int kSegLen = 8;                // tokens per segment
constexpr int kSegRun = kSegs * kSegLen;  // tokens per run
constexpr int kDS = 16;

static_assert(kSegThreads == kSegs * kSegCh * (kDS / kPer), "thread map");

template <typename Elt>
struct SegStage {
  float dt[kSegRun][kSegCh];
  Elt x[kSegRun][kSegCh];
  float b[kSegRun][kDS];
  float c[kSegRun][kDS];
};

template <typename Elt>
struct SegShared {
  SegStage<Elt> buf[2];
  float p_end[kSegs][kSegCh][kDS];        // a segment's prod dA
  float h_end[kSegs][kSegCh][kDS];        // its state from zero
  float h_run[2][kSegCh][kDS];            // the state entering a run, by
                                          // the run's parity
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

// Stage a run's tokens t0 .. t0 + run - 1 of the block's channels (and the
// row's B, C) into `st`.  Tokens past the run (the row's last run) and
// channels past di are staged as dt = x = B = C = 0: exp(0 * A) = 1 and
// (0 * x) * B = 0 exactly, so they leave every segment's h and P as they
// are, and every segment scans all its kSegLen tokens.  Where every row is
// 16-byte aligned (`vec`) each thread issues a fixed set of 16-byte
// cp.async pieces (dt, x, B, C in that order; the range boundaries are
// multiples of 32, so each branch is uniform over a warp); otherwise plain
// loads.
template <typename Elt>
__device__ __forceinline__ void stage_run(
    SegStage<Elt>& st, const float* __restrict__ dt, const Elt* __restrict__ x,
    const float* __restrict__ Bm, const float* __restrict__ Cm, size_t base,
    size_t bc, int di, int t0, int run, int nch, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kXv = 16 / sizeof(Elt);            // x values a piece
    constexpr int kXp = kSegCh / kXv;                 // x pieces a token
    constexpr int kDtEnd = kSegRun * 4;
    constexpr int kXEnd = kDtEnd + kSegRun * kXp;
    constexpr int kBEnd = kXEnd + kSegRun * 4;
    constexpr int kTotal = kBEnd + kSegRun * 4;
#pragma unroll
    for (int k = 0; k < (kTotal + kSegThreads - 1) / kSegThreads; ++k) {
      const int e = tid + k * kSegThreads;
      if (e >= kTotal) break;
      void* dst;
      const void* src;
      bool live;
      if (e < kDtEnd) {
        const int t = e >> 2, cc = (e & 3) * 4;
        dst = &st.dt[t][cc];
        src = dt + base + (size_t)(t0 + t) * di + cc;
        live = t < run && cc < nch;
      } else if (e < kXEnd) {
        const int t = (e - kDtEnd) / kXp, cc = (e - kDtEnd) % kXp * kXv;
        dst = &st.x[t][cc];
        src = x + base + (size_t)(t0 + t) * di + cc;
        live = t < run && cc < nch;
      } else {
        const bool b = e < kBEnd;
        const int f = e - (b ? kXEnd : kBEnd), t = f >> 2, s = (f & 3) * 4;
        dst = b ? &st.b[t][s] : &st.c[t][s];
        src = (b ? Bm : Cm) + bc + (size_t)(t0 + t) * kDS + s;
        live = t < run;
      }
      if (live)
        cp_async16(dst, src);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kSegRun * kSegCh; e += kSegThreads) {
      const int t = e / kSegCh, cc = e % kSegCh;
      const bool live = t < run && cc < nch;
      const size_t g = base + (size_t)(t0 + t) * di + cc;
      st.dt[t][cc] = live ? dt[g] : 0.f;
      st.x[t][cc] = live ? x[g] : Elt(0.f);
    }
    for (int e = tid; e < kSegRun * kDS; e += kSegThreads) {
      const int t = e / kDS, s = e % kDS;
      const bool live = t < run;
      const size_t g = bc + (size_t)(t0 + t) * kDS + s;
      st.b[t][s] = live ? Bm[g] : 0.f;
      st.c[t][s] = live ? Cm[g] : 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Pass 1 of one segment: its kSegLen tokens u0 .. of the run from a zero
// state.  Keeps the partial read-outs y_loc and q_u = C_u (.) P_u in
// registers and leaves in p, h the segment's decay product and state.
template <typename Elt>
__device__ __forceinline__ void segment_scan(
    const SegStage<Elt>& sb, int u0, int jc, int q, const float (&a)[kPer],
    float (&h)[kPer], float (&p)[kPer], float (&y_loc)[kSegLen],
    float (&qv)[kSegLen][kPer]) {
#pragma unroll
  for (int u = 0; u < kSegLen; ++u) {
    const int t = u0 + u;
    const float dtv = sb.dt[t][jc];
    const float dtx = __fmul_rn(dtv, to_float(sb.x[t][jc]));
    const float4 b4 = *reinterpret_cast<const float4*>(&sb.b[t][q * kPer]);
    const float4 c4 = *reinterpret_cast<const float4*>(&sb.c[t][q * kPer]);
    const float bb[kPer] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[kPer] = {c4.x, c4.y, c4.z, c4.w};
    float y = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float dA = expf(__fmul_rn(dtv, a[i]));
      h[i] = fmaf(dA, h[i], __fmul_rn(dtx, bb[i]));
      y = fmaf(cc[i], h[i], y);
      p[i] = __fmul_rn(p[i], dA);
      qv[u][i] = __fmul_rn(cc[i], p[i]);
    }
    y_loc[u] = y;
  }
}

// Pass 3 of one segment: y_t = y_loc + q . h_in for its 8 tokens, summed
// over the channel's four threads (quarters q) by halving: quarters q and
// q ^ 2 swap 4 tokens' partial sums, then q and q ^ 1 swap 2, so that each
// quarter holds the whole sum of 2 tokens (6 shuffles for 8 tokens) and
// stores those of the segment's cnt live tokens.
__device__ __forceinline__ void segment_out(
    float* __restrict__ out, size_t at, size_t di, int cnt, int q,
    bool active, const float (&h_in)[kPer], const float (&y_loc)[kSegLen],
    const float (&qv)[kSegLen][kPer]) {
  static_assert(kSegLen == 8 && kDS / kPer == 4, "8 tokens over 4 quarters");
  float v[kSegLen];
#pragma unroll
  for (int u = 0; u < kSegLen; ++u) {
    v[u] = y_loc[u];
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[u] = fmaf(qv[u][i], h_in[i], v[u]);
  }
  const bool hi2 = q & 2, hi1 = q & 1;
  float w4[4], w2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = hi2 ? v[k] : v[k + 4];
    w4[k] = (hi2 ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = hi1 ? w4[k] : w4[k + 2];
    w2[k] = (hi1 ? w4[k + 2] : w4[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const int u0 = (hi2 ? 4 : 0) + (hi1 ? 2 : 0);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (active && u0 + k < cnt) out[at + (u0 + k) * di] = w2[k];
}

template <typename Elt>
__global__ void __launch_bounds__(kSegThreads, 3)
mamba_segment_kernel(const float* __restrict__ dt, const Elt* __restrict__ x,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ A, float* __restrict__ state,
                     const int* __restrict__ slots,
                     const int* __restrict__ lens,
                     const int* __restrict__ fresh, float* __restrict__ out,
                     int T, int di, int n_slots, bool vec) {
  __shared__ __align__(16) SegShared<Elt> sm;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * kSegCh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = warp >> 1;                         // segment
  const int q = lane >> 3;                         // states q*4 .. q*4+3
  const int jc = (warp & 1) * 8 + (lane & 7);      // channel in block
  const int c = c0 + jc;
  const bool active = c < di;
  const int nch = min(kSegCh, di - c0);

  const int slot = slots[row];
  int len = lens[row];
  if (slot < 0 || slot >= n_slots) len = 0;
  len = len < 0 ? 0 : (len > T ? T : len);

  const size_t base = (size_t)row * T * di + c0;   // (row, t = 0, c0)
  for (int e = tid; e < (T - len) * kSegCh; e += kSegThreads) {
    const int t = len + e / kSegCh, cc = e % kSegCh;
    if (cc < nch) out[base + (size_t)t * di + cc] = 0.f;
  }
  if (len == 0) return;                            // uniform over the block

  const size_t bc = (size_t)row * T * kDS;
  stage_run<Elt>(sm.buf[0], dt, x, Bm, Cm, base, bc, di, 0,
                 min(kSegRun, len), nch, vec);

  float* st = state + ((size_t)slot * di + (active ? c : 0)) * kDS + q * kPer;
  if (g == 0) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active && !fresh[row]) v = *reinterpret_cast<const float4*>(st);
    *reinterpret_cast<float4*>(&sm.h_run[0][jc][q * kPer]) = v;
  }
  float a[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    a[i] = active ? __ldg(A + (size_t)c * kDS + q * kPer + i) : 0.f;

  const int nruns = (len + kSegRun - 1) / kSegRun;
  for (int r = 0; r < nruns; ++r) {
    const int t0 = r * kSegRun, run = min(kSegRun, len - t0);
    if (r + 1 < nruns) {
      stage_run<Elt>(sm.buf[(r + 1) & 1], dt, x, Bm, Cm, base, bc, di,
                     t0 + kSegRun, min(kSegRun, len - t0 - kSegRun), nch, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();                    // run r staged, its h_run written
    const SegStage<Elt>& sb = sm.buf[r & 1];

    // 1. this segment's tokens from a zero state
    const int u0 = g * kSegLen;
    const int cnt = max(0, min(kSegLen, run - u0));   // live, of kSegLen
    float h[kPer] = {0.f, 0.f, 0.f, 0.f}, p[kPer] = {1.f, 1.f, 1.f, 1.f};
    float y_loc[kSegLen], qv[kSegLen][kPer];
    segment_scan(sb, u0, jc, q, a, h, p, y_loc, qv);
    *reinterpret_cast<float4*>(&sm.p_end[g][jc][q * kPer]) =
        make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(&sm.h_end[g][jc][q * kPer]) =
        make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();

    // 2. the state entering this segment: the run's, carried through the
    // segments before it; the last segment also forms the run's last state
    float h_in[kPer];
    {
      const float4 v =
          *reinterpret_cast<const float4*>(&sm.h_run[r & 1][jc][q * kPer]);
      h_in[0] = v.x; h_in[1] = v.y; h_in[2] = v.z; h_in[3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < kSegs - 1; ++s) {
      if (s < g) {
        const float4 pe =
            *reinterpret_cast<const float4*>(&sm.p_end[s][jc][q * kPer]);
        const float4 he =
            *reinterpret_cast<const float4*>(&sm.h_end[s][jc][q * kPer]);
        h_in[0] = fmaf(pe.x, h_in[0], he.x);
        h_in[1] = fmaf(pe.y, h_in[1], he.y);
        h_in[2] = fmaf(pe.z, h_in[2], he.z);
        h_in[3] = fmaf(pe.w, h_in[3], he.w);
      }
    }
    if (g == kSegs - 1) {
      const float4 h_out =
          make_float4(fmaf(p[0], h_in[0], h[0]), fmaf(p[1], h_in[1], h[1]),
                      fmaf(p[2], h_in[2], h[2]), fmaf(p[3], h_in[3], h[3]));
      *reinterpret_cast<float4*>(&sm.h_run[(r + 1) & 1][jc][q * kPer]) = h_out;
      if (r + 1 == nruns && active) *reinterpret_cast<float4*>(st) = h_out;
    }

    // 3. y_t = C_t . h_local_t + q_t . h_in
    const size_t at = base + (size_t)(t0 + u0) * di + jc;
    if (cnt > 0) segment_out(out, at, di, cnt, q, active, h_in, y_loc, qv);
  }
}

// The form a shape takes: the segmented one for every T > 1.
__host__ __forceinline__ bool segmented(int T) {
  return T > 1;
}

template <typename Elt, int DS>
int launch(const void* dt, const void* x, const void* B, const void* C,
           const void* A, void* state, const void* slots, const void* lens,
           const void* fresh, void* out, int S, int T, int di, int n_slots,
           cudaStream_t st) {
  if (!segmented(T)) {
    const dim3 grid((di + Shape<DS>::kCh - 1) / Shape<DS>::kCh, S);
    mamba_scan_kernel<Elt, DS><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dt), static_cast<const Elt*>(x),
        static_cast<const float*>(B), static_cast<const float*>(C),
        static_cast<const float*>(A), static_cast<float*>(state),
        static_cast<const int*>(slots), static_cast<const int*>(lens),
        static_cast<const int*>(fresh), static_cast<float*>(out), T, di,
        n_slots);
    return (int)cudaGetLastError();
  }
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool vec = di % (16 / (int)sizeof(Elt)) == 0 && aligned(dt) &&
                   aligned(x) && aligned(B) && aligned(C);
  const dim3 grid((di + kSegCh - 1) / kSegCh, S);
  mamba_segment_kernel<Elt><<<grid, kSegThreads, 0, st>>>(
      static_cast<const float*>(dt), static_cast<const Elt*>(x),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(A), static_cast<float*>(state),
      static_cast<const int*>(slots), static_cast<const int*>(lens),
      static_cast<const int*>(fresh), static_cast<float*>(out), T, di, n_slots,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mamba_scan_launch(const void* dt, const void* x, const void* B,
                                 const void* C, const void* A, void* state,
                                 const void* slots, const void* lens,
                                 const void* fresh, void* out, int S, int T,
                                 int di, int ds, int n_slots, int dtype,
                                 void* stream) {
  if (S <= 0 || S > 65535 || T <= 0 || di <= 0 || n_slots <= 0 || ds != 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 16>(dt, x, B, C, A, state, slots, lens, fresh, out, S,
                             T, di, n_slots, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 16>(dt, x, B, C, A, state, slots, lens, fresh,
                                     out, S, T, di, n_slots, st);
  return (int)cudaErrorInvalidValue;
}
