// Fused grouped-expert SwiGLU for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces repro/kernels/moe_gemm.py::fused_moe_ffn, the Pallas TPU kernel
// of the MoE layer.  It computes the same function, for every expert e and
// every one of its C capacity rows:
//   x      [E, C, d]    f32 or bf16 (capacity-padded per-expert buffers)
//   w_gate [E, d, ff],  w_up [E, d, ff],  w_down [E, ff, d]   same dtype
//   out[e] = (silu(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]
// with f32 accumulation; the hidden is rounded to x's dtype before the down
// projection, as the Pallas kernel does.  Empty capacity rows (zeros) are
// computed like any other row.
//
// What bounds it on an H100.  At the serve path's shapes (olmoe-1b-7b:
// E=64, C=88, d=2048, ff=1024, bf16) a call reads 805 MB of expert weights
// and does 6*E*C*d*ff = 70.9 GFLOP: ~88 flops per weight byte, well below
// the card's ~295, so it is bound by device-memory bytes (0.254 ms at
// 3.35 TB/s).  The design reads each expert's weights once per call: every
// block covers all of its expert's rows (up to 128 in bf16) for one tile of
// output columns, and the few blocks that share a weight tile (C > 128, or
// f32's 64-row tiles) are adjacent in the grid so that L2 catches the reuse.
//
// The accumulator does not fit.  The Pallas kernel keeps a [Ct, d] f32
// accumulator in VMEM (128 x 2048 x 4 B = 1 MB) across ff blocks, so the
// hidden never reaches HBM; a Hopper block has 227 KB of shared memory.  So
// the call is two launches of one grouped-GEMM kernel: the first computes
// h = silu(x Wg) * (x Wu) for a [rows, 64] tile of ff, both products in
// registers, and writes h in x's dtype to a scratch buffer the wrapper
// allocates ([64, 88, 1024] bf16 = 11.5 MB at the serve shapes, which stays
// in the 50 MB L2); the second computes out = h Wd.  The ff loop of the
// Pallas kernel is the depth loop of the second launch.
//
// Each launch: a block of 8 warps per (row tile, column tile, expert) walks
// the depth in steps of BK with a ring of cp.async stages in shared memory
// (rows past C are zero-filled and never stored).
//  * bf16: tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate); each
//    warp owns 16 rows of the 128-row tile, fragments come from shared
//    memory by ldmatrix (B transposed on the fly), rows padded by 8
//    elements so the fragment loads hit distinct banks.  Warps whose 16 rows
//    all lie past C skip the products.
//  * f32: CUDA cores, no TF32 (it would miss the f32 check); 16 x 16
//    threads each own a 4 x 4 block of a 64 x 64 tile.
// wgmma with TMA, and skipping empty capacity rows, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;     // 8 warps

// Tiles per element type and launch (GLU: the gate/up launch, two weight
// matrices and the silu * mul epilogue; otherwise the down projection).
template <typename T, bool GLU> struct Tile;
template <bool GLU> struct Tile<__nv_bfloat16, GLU> {
  static constexpr int BM = 128, BN = GLU ? 64 : 128, BK = 32, STAGES = 4;
  static constexpr int PAD = 8;
};
template <bool GLU> struct Tile<float, GLU> {
  static constexpr int BM = 64, BN = 64, BK = 16, STAGES = 3;
  static constexpr int PAD = 4;
};

// Shared memory of one stage: A [BM][BK + PAD], then B1 (and B2 for GLU)
// [BK][BN + PAD].  Every row and array starts on 16 bytes.
template <typename T, bool GLU> struct Smem {
  using Tl = Tile<T, GLU>;
  static constexpr int AS = Tl::BK + Tl::PAD;
  static constexpr int BS = Tl::BN + Tl::PAD;
  static constexpr int A_ELEMS = Tl::BM * AS;
  static constexpr int B_ELEMS = Tl::BK * BS;
  static constexpr int STAGE_ELEMS = A_ELEMS + (GLU ? 2 : 1) * B_ELEMS;
  static constexpr size_t BYTES = size_t(Tl::STAGES) * STAGE_ELEMS * sizeof(T);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;    // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
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

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Stage the depth slice k0 .. k0+BK of A's rows m0 .. m0+BM (rows >= M
// zero-filled) and of the weights' columns n0 .. n0+BN.
template <typename T, bool GLU>
__device__ __forceinline__ void load_stage(T* st, const T* A, const T* B1,
                                           const T* B2, int M, int K, int N,
                                           int m0, int n0, int k0) {
  using Tl = Tile<T, GLU>;
  using Sm = Smem<T, GLU>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int A_CH = Tl::BK / VEC;     // 16-byte chunks per A row
  constexpr int B_CH = Tl::BN / VEC;     // 16-byte chunks per B row
  for (int c = threadIdx.x; c < Tl::BM * A_CH; c += kThreads) {
    const int r = c / A_CH, ch = c % A_CH;
    const bool ok = m0 + r < M;
    const T* src = A + (size_t)(ok ? m0 + r : 0) * K + k0 + ch * VEC;
    cp_async16(st + r * Sm::AS + ch * VEC, src, ok);
  }
  T* b_s = st + Sm::A_ELEMS;
  for (int c = threadIdx.x; c < Tl::BK * B_CH; c += kThreads) {
    const int r = c / B_CH, ch = c % B_CH;
    const size_t off = (size_t)(k0 + r) * N + n0 + ch * VEC;
    cp_async16(b_s + r * Sm::BS + ch * VEC, B1 + off, true);
    if constexpr (GLU)
      cp_async16(b_s + Sm::B_ELEMS + r * Sm::BS + ch * VEC, B2 + off, true);
  }
}

// out[e] = A[e] @ B1[e] (or, GLU, silu(A[e] @ B1[e]) * (A[e] @ B2[e])) for
// A [E, M, K], B [E, K, N], out [E, M, N]; the depth loop runs k_tiles
// steps of BK.  Grid: (row tile, column tile, expert), row tiles fastest.
template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
grouped_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B1,
                    const T* __restrict__ B2, T* __restrict__ out, int M,
                    int K, int N, int k_tiles) {
  using Tl = Tile<T, GLU>;
  using Sm = Smem<T, GLU>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NB = GLU ? 2 : 1;                    // weight matrices
  constexpr int ACC = kMma ? Tl::BN / 2 : 16;        // f32 sums per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * Tl::BM, n0 = blockIdx.y * Tl::BN;
  A += (size_t)e * M * K;
  B1 += (size_t)e * K * N;
  if constexpr (GLU) B2 += (size_t)e * K * N;
  out += (size_t)e * M * N;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = m0 + warp * 16;                   // bf16: the warp's rows
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;   // f32 layout

  float acc[NB][ACC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[b][i] = 0.f;

#pragma unroll
  for (int s = 0; s < Tl::STAGES - 1; ++s) {
    if (s < k_tiles)
      load_stage<T, GLU>(smem + s * Sm::STAGE_ELEMS, A, B1, B2, M, K, N, m0,
                         n0, s * Tl::BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<Tl::STAGES - 2>();
    __syncthreads();
    // refill the slot every warp finished reading in step kt - 1
    const int nk = kt + Tl::STAGES - 1;
    if (nk < k_tiles)
      load_stage<T, GLU>(smem + (nk % Tl::STAGES) * Sm::STAGE_ELEMS, A, B1,
                         B2, M, K, N, m0, n0, nk * Tl::BK);
    cp_async_commit();

    const T* st = smem + (kt % Tl::STAGES) * Sm::STAGE_ELEMS;
    const T* a_s = st;
    const T* b_s = st + Sm::A_ELEMS;
    if constexpr (kMma) {
      if (wrow < M) {
#pragma unroll
        for (int ks = 0; ks < Tl::BK / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, a_s + (warp * 16 + (lane & 15)) * Sm::AS + ks * 16 +
                             (lane >> 4) * 8);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const T* bb = b_s + b * Sm::B_ELEMS;
#pragma unroll
            for (int np = 0; np < Tl::BN / 16; ++np) {
              uint32_t f[4];
              ldmatrix_x4_trans(f, bb + (ks * 16 + (lane & 15)) * Sm::BS +
                                       np * 16 + (lane >> 4) * 8);
              mma_bf16(&acc[b][(2 * np) * 4], a, f[0], f[1]);
              mma_bf16(&acc[b][(2 * np + 1) * 4], a, f[2], f[3]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < Tl::BK; ++k) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[(ty * 4 + i) * Sm::AS + k];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 bv = *reinterpret_cast<const float4*>(
              b_s + b * Sm::B_ELEMS + k * Sm::BS + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[b][i * 4 + 0] = fmaf(av[i], bv.x, acc[b][i * 4 + 0]);
            acc[b][i * 4 + 1] = fmaf(av[i], bv.y, acc[b][i * 4 + 1]);
            acc[b][i * 4 + 2] = fmaf(av[i], bv.z, acc[b][i * 4 + 2]);
            acc[b][i * 4 + 3] = fmaf(av[i], bv.w, acc[b][i * 4 + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: silu(gate) * up for GLU, then one rounding to T
  if constexpr (kMma) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < Tl::BN / 8; ++nt) {
      const int col = n0 + nt * 8 + tig * 2;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = wrow + gid + 8 * h2;
        if (row >= M) continue;
        float v0 = acc[0][nt * 4 + 2 * h2], v1 = acc[0][nt * 4 + 2 * h2 + 1];
        if constexpr (GLU) {
          v0 = silu(v0) * acc[1][nt * 4 + 2 * h2];
          v1 = silu(v1) * acc[1][nt * 4 + 2 * h2 + 1];
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16(v0, v1);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= M) continue;
      float4 v = make_float4(acc[0][i * 4], acc[0][i * 4 + 1],
                             acc[0][i * 4 + 2], acc[0][i * 4 + 3]);
      if constexpr (GLU) {
        v.x = silu(v.x) * acc[NB - 1][i * 4];
        v.y = silu(v.y) * acc[NB - 1][i * 4 + 1];
        v.z = silu(v.z) * acc[NB - 1][i * 4 + 2];
        v.w = silu(v.w) * acc[NB - 1][i * 4 + 3];
      }
      *reinterpret_cast<float4*>(out + (size_t)row * N + n0 + tx * 4) = v;
    }
  }
}

template <typename T, bool GLU>
int launch_gemm(const void* A, const void* B1, const void* B2, void* out,
                int E, int M, int K, int N, int k_tiles, cudaStream_t stream) {
  using Tl = Tile<T, GLU>;
  constexpr size_t smem = Smem<T, GLU>::BYTES;
  auto kernel = grouped_gemm_kernel<T, GLU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + Tl::BM - 1) / Tl::BM, N / Tl::BN, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B1),
      static_cast<const T*>(B2), static_cast<T*>(out), M, K, N, k_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int moe_ffn(const void* x, const void* wg, const void* wu, const void* wd,
            void* hidden, void* out, int E, int C, int d, int ff,
            cudaStream_t stream) {
  using Up = Tile<T, true>;
  using Down = Tile<T, false>;
  if (d % Up::BK || ff % Up::BN || ff % Down::BK || d % Down::BN)
    return (int)cudaErrorInvalidValue;
  const int d_tiles = d / Up::BK;
  const int bk = Down::BK;
  const int ff_tiles = ff / bk;
  int err = launch_gemm<T, true>(x, wg, wu, hidden, E, C, d, ff, d_tiles,
                                 stream);
  if (err != 0) return err;
  return launch_gemm<T, false>(hidden, wd, nullptr, out, E, C, ff, d,
                               ff_tiles, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `hidden` is the caller's [E, C, ff]
// scratch of x's dtype.  Returns cudaGetLastError() after the second launch
// (0 on success), or cudaErrorInvalidValue for a shape the kernel does not
// take.  Launches on `stream` and does not synchronise.
extern "C" int moe_ffn_launch(const void* x, const void* w_gate,
                              const void* w_up, const void* w_down,
                              void* hidden, void* out, int E, int C, int d,
                              int ff, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || ff <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return moe_ffn<float>(x, w_gate, w_up, w_down, hidden, out, E, C, d, ff,
                          st);
  if (dtype == 1)
    return moe_ffn<__nv_bfloat16>(x, w_gate, w_up, w_down, hidden, out, E, C,
                                  d, ff, st);
  return (int)cudaErrorInvalidValue;
}
