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
// What bounds it on an H100.  Per live token and channel it reads dt and x
// and writes y (10 bytes with a bf16 x; B and C are shared by a row's
// channels), and does ds exponentials and ~5 ds f32 operations.  A
// 512-token prefill chunk of jamba (di = 16384, ds = 16, 300 live tokens)
// moves ~63 MB (dt and y in f32 dominate), 19 us at 3.35 TB/s, and does 79 M
// exponentials, 19 us on the special-function units (16 per SM and clock):
// the two bounds meet.  Decode (T = 1, 32 rows) is bound by the f32 state,
// read and written once per live row (1 MB each way): ~60 MB, 18 us.
//
// Design.  Channels evolve independently, so parallelism comes from rows x
// channels, and a row's tokens are walked serially (the recurrent form).  A
// channel's ds states are split over G = ds / 4 threads (4 states each, in
// registers for the whole row; lane = quarter * (32 / G) + channel, so the G
// threads of a channel are lanes 32 / G apart and add their partial read-outs
// with log2(G) shuffles).  A block of 128 threads owns 128 / G channels of
// one row -- grid (di / channels, S) -- so a prefill row of jamba gives 512
// blocks of 4 warps and a decode tick of 32 rows 16,384 blocks.  The state is
// read once (or zeroed) and written once.  The block walks the row's live
// tokens in runs of 32: dt and x of its channels and the row's B and C are
// staged in shared memory as f32 with coalesced loads, every thread steps
// through the run, and the run's outputs go back through shared memory as
// coalesced rows.  expf (never __expf, no --use_fast_math) keeps the
// exponential within 2 ulp, which the check's bound counts, and the products
// dt*A, dt*x and (dt*x)*B are __fmul_rn, never contracted into an fma, so
// they round as the plain version's do.  The chunked
// parallel form of the Pallas kernel (a doubling scan within a chunk) would
// cut the serial walk; it is later work.

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

template <typename Elt, int DS>
int launch(const void* dt, const void* x, const void* B, const void* C,
           const void* A, void* state, const void* slots, const void* lens,
           const void* fresh, void* out, int S, int T, int di, int n_slots,
           cudaStream_t st) {
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
