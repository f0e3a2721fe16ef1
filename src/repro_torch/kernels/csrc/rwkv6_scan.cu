// WKV6 recurrence (the RWKV6 "Finch" time-mix) for Hopper (sm_90a), CUDA C++
// with a plain C entry point loaded through ctypes.
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
// What bounds it on an H100.  Per live token and head the recurrence does
// ~5 D^2 = 20k f32 operations on the CUDA cores and moves r, k, v, w and o
// (D values each: 896 bytes with bf16 r, k, v), ~23 flops per byte: at the
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20).  Add the state, read
// and written once per row and head (16 KB each way): decode (T = 1, 32
// rows of rwkv6-3b, H = 40) is bound by those 42 MB, 12.5 us.
//
// Design.  Column j of S evolves on its own (S[:, j] reads only v_j), so a
// block owns 32 columns of one (row, head) -- grid (S, H, D / 32) -- and
// keeps them in registers for the whole row: 4 threads per column, each
// holding 16 of its 64 entries (lane = quarter * 8 + column, so the four
// threads of a column are lanes 8 apart and add their partial dot products
// with two shuffles).  The state is read once (or zeroed) and written once.
// The block walks the row's live tokens in runs of 32: r, k, w (all 64
// entries) and v (the block's 32 columns) are staged in shared memory as f32,
// with each quarter's bonus sum  sum_i r_i u_i k_i  per token; then every
// thread steps through the run: o_t from S_{t-1} (its quarter's partial of
// r_t . S_{t-1} plus v_j times the quarter's bonus sum, summed over the
// quarters), then its 16 entries of S_t.  Even a single prefill row gives
// 40 x 64 = 2,560 independent columns.  This is the recurrent form, safe at
// any decay: the chunked form of the Pallas kernel divides by the cumulative
// decay, which overflows f32 for strong decays (log w down to -22,026 per
// token).  A chunked tensor-core form that stays stable (sub-chunks) is later
// work.

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

template <typename Elt>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, const void* slots, const void* lens,
           const void* fresh, void* out, int S, int T, int H, int n_slots,
           cudaStream_t st) {
  const dim3 grid(S, H, kD / kCols);
  wkv6_kernel<Elt><<<grid, kThreads, 0, st>>>(
      static_cast<const Elt*>(r), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(state),
      static_cast<const int*>(slots), static_cast<const int*>(lens),
      static_cast<const int*>(fresh), static_cast<float*>(out), T, H,
      n_slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* state,
                                 const void* slots, const void* lens,
                                 const void* fresh, void* out, int S, int T,
                                 int H, int D, int n_slots, int dtype,
                                 void* stream) {
  if (S <= 0 || T <= 0 || H <= 0 || H > 65535 || D != kD || n_slots <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, state, slots, lens, fresh, out, S, T,
                         H, n_slots, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, slots, lens, fresh,
                                 out, S, T, H, n_slots, st);
  return (int)cudaErrorInvalidValue;
}
