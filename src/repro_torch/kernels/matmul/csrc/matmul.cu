// The DLA matmul kernel, for sm_90a.
//
// Replaces matmul_pallas (src/repro/kernels/matmul/kernel.py:69), the
// TPU analogue of the paper's Intel DLA: one launch computes
//   out = act(x @ w + bias)
// with an fp32 accumulator, the bias added in fp32, the activation
// (none / relu / relu2 / silu / gelu, the tanh form) applied in fp32 and
// one cast to the output type, as the Pallas kernel's _finish step does.
//
// Each block computes one 64x64 output tile; K is walked inside the block
// (the Pallas grid's sequential K axis becomes a loop, since blocks run in
// no order and nothing carries between them).
//   * bf16 x bf16: nvcuda::wmma 16x16x16 fragments with fp32
//     accumulation, 4 warps (32x32 each), K in steps of 32 staged through
//     shared memory;
//   * fp32 x fp32: fp32 FMAs on the CUDA cores (no TF32: the reference's
//     fp32 dot is full fp32), 256 threads (4x4 each), K in steps of 16.
// The tile is staged in shared memory for the epilogue, which adds the
// bias, applies the activation and stores fp32 or bf16.
// Operands: x (M, K) with row stride sxm, w (K, N) with row stride swk,
// both with unit column stride; out (M, N) contiguous.  Ragged M, N and K
// are masked here (out-of-range elements load as zero and are not
// stored), so the wrapper pads nothing.
//
// What bounds it: at the shapes it is held at (a dense MLP edge, 4096 x
// 2560 @ 2560 x 6912 in bf16) the card's tensor-core rate; this simple
// version stages every tile through shared memory with plain loads (no
// cp.async/TMA pipelining, no wgmma) and is far from that bound (PERF.md).
// Every C entry point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int BM = 64;        // output rows per tile
constexpr int BN = 64;        // output columns per tile
constexpr int LDC = BN + 4;   // fp32 row pitch of the output staging tile

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU2 = 2, ACT_SILU = 3,
           ACT_GELU = 4 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// the reference's _apply_activation, in fp32
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_RELU2: {
      const float r = fmaxf(v, 0.f);
      return r * r;
    }
    case ACT_SILU:
      return v * (1.f / (1.f + expf(-v)));
    case ACT_GELU: {
      // jax.nn.gelu's default: x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
      const float c = 0.7978845608028654f;
      return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    }
    default:
      return v;
  }
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core main loop
// ---------------------------------------------------------------------------

struct FmaPath {
  using T = float;
  static constexpr int THREADS = 256;   // 16 x 16, each owns a 4 x 4 patch
  static constexpr int FK = 16;         // K step

  // Cs[r][c] = sum_k x[m0 + r][k] * w[k][n0 + c] for the tile at (m0, n0)
  __device__ static void mainloop(const float* __restrict__ x, ll sxm,
                                  const float* __restrict__ w, ll swk, int M,
                                  int N, int K, int m0, int n0,
                                  float (*Cs)[LDC]) {
    __shared__ float As[FK][BM + 4];   // x tile, transposed: As[k][row]
    __shared__ float Bs[FK][BN + 4];   // w tile: Bs[k][col]
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += FK) {
      for (int i = tid; i < BM * FK; i += THREADS) {
        const int r = i / FK, kk = i % FK;
        const int gm = m0 + r, gk = k0 + kk;
        As[kk][r] = (gm < M && gk < K) ? x[(ll)gm * sxm + gk] : 0.f;
      }
      for (int i = tid; i < FK * BN; i += THREADS) {
        const int kk = i / BN, cc = i % BN;
        const int gk = k0 + kk, gn = n0 + cc;
        Bs[kk][cc] = (gk < K && gn < N) ? w[(ll)gk * swk + gn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bv[j], c[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[ty + 16 * i][tx + 16 * j] = c[i][j];
  }
};

// ---------------------------------------------------------------------------
// bf16 x bf16 tensor-core main loop: wmma fragments, fp32 accumulation
// ---------------------------------------------------------------------------

struct WmmaPath {
  using T = bf16;
  static constexpr int THREADS = 128;   // 4 warps, 2 x 2, each 32 x 32
  static constexpr int WK = 32;         // K step
  static constexpr int LDA = WK + 8;    // bf16 row pitch of the x tile
  static constexpr int LDB = BN + 8;    // bf16 row pitch of the w tile

  __device__ static void mainloop(const bf16* __restrict__ x, ll sxm,
                                  const bf16* __restrict__ w, ll swk, int M,
                                  int N, int K, int m0, int n0,
                                  float (*Cs)[LDC]) {
    using namespace nvcuda;
    // fragment pointers must be 32-byte aligned: every 16-row/16-col
    // corner of these pitches is (1280 B, 2304 B and 4352 B per 16 rows)
    __shared__ __align__(128) bf16 As[BM][LDA];
    __shared__ __align__(128) bf16 Bs[WK][LDB];
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    const bf16 zero = __float2bfloat16(0.f);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += WK) {
      for (int i = tid; i < BM * WK; i += THREADS) {
        const int r = i / WK, kk = i % WK;
        const int gm = m0 + r, gk = k0 + kk;
        As[r][kk] = (gm < M && gk < K) ? x[(ll)gm * sxm + gk] : zero;
      }
      for (int i = tid; i < WK * BN; i += THREADS) {
        const int kk = i / BN, cc = i % BN;
        const int gk = k0 + kk, gn = n0 + cc;
        Bs[kk][cc] = (gk < K && gn < N) ? w[(ll)gk * swk + gn] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], &As[wm + 16 * i][kk], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], &Bs[kk][wn + 16 * j], LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(cf[i][j], af[i], bfr[j], cf[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], cf[i][j],
                                LDC, wmma::mem_row_major);
  }
};

// ---------------------------------------------------------------------------
// the kernel: one output tile a block, then the DLA epilogue
// ---------------------------------------------------------------------------

template <class Path, typename TO, typename TB>
__global__ void __launch_bounds__(Path::THREADS)
dla_gemm(const typename Path::T* __restrict__ x,
         const typename Path::T* __restrict__ w,
         const TB* __restrict__ bias, TO* __restrict__ out, int M, int N,
         int K, ll sxm, ll swk, int act) {
  __shared__ __align__(128) float Cs[BM][LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Path::mainloop(x, sxm, w, swk, M, N, K, m0, n0, Cs);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += Path::THREADS) {
    const int r = i / BN, cc = i % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= M || gn >= N) continue;
    float v = Cs[r][cc];
    if (bias != nullptr) v = v + to_f(bias[gn]);
    out[(ll)gm * N + gn] = from_f<TO>(activate(v, act));
  }
}

template <class Path, typename TO, typename TB>
int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, ll sxm, ll swk, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dla_gemm<Path, TO, TB><<<grid, Path::THREADS, 0, stream>>>(
      static_cast<const typename Path::T*>(x),
      static_cast<const typename Path::T*>(w), static_cast<const TB*>(bias),
      static_cast<TO*>(out), M, N, K, sxm, swk, act);
  return (int)cudaGetLastError();
}

template <class Path, typename TO>
int by_bias(int db, const void* x, const void* w, const void* bias,
            void* out, int M, int N, int K, ll sxm, ll swk, int act,
            cudaStream_t stream) {
  if (db == 1)
    return launch<Path, TO, bf16>(x, w, bias, out, M, N, K, sxm, swk, act,
                                  stream);
  // fp32 bias, or none (a null fp32 pointer)
  return launch<Path, TO, float>(x, w, db < 0 ? nullptr : bias, out, M, N,
                                 K, sxm, swk, act, stream);
}

template <class Path>
int by_out(int dout, int db, const void* x, const void* w, const void* bias,
           void* out, int M, int N, int K, ll sxm, ll swk, int act,
           cudaStream_t stream) {
  if (dout == 1)
    return by_bias<Path, bf16>(db, x, w, bias, out, M, N, K, sxm, swk, act,
                               stream);
  return by_bias<Path, float>(db, x, w, bias, out, M, N, K, sxm, swk, act,
                              stream);
}

}  // namespace

extern "C" {

// out = act(x @ w + bias); dtypes 0 = fp32, 1 = bf16 (dbias -1: no bias);
// act 0..4 = none, relu, relu2, silu, gelu
int repro_matmul(int din, int dout, int dbias, int act, const void* x,
                 const void* w, const void* bias, void* out, int M, int N,
                 int K, ll sxm, ll swk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (din == 1)
    return by_out<WmmaPath>(dout, dbias, x, w, bias, out, M, N, K, sxm, swk,
                            act, s);
  return by_out<FmaPath>(dout, dbias, x, w, bias, out, M, N, K, sxm, swk,
                         act, s);
}

}  // extern "C"
