// The DLA matmul kernel, for sm_90a.
//
// Replaces matmul_pallas (src/repro/kernels/matmul/kernel.py:69), the
// TPU analogue of the paper's Intel DLA: one launch computes
//   out = act(x @ w + bias)
// with an fp32 accumulator, the bias added in fp32, the activation
// (none / relu / relu2 / silu / gelu, the tanh form) applied in fp32 and
// one cast to the output type, as the Pallas kernel's _finish step does.
//
// The product runs through the main loops of the shared GEMM header
// (kernels/include/gemm.cuh), the same loops and the same tile choice as
// the collective-matmul kernels (so a DLA product without bias or
// activation equals theirs bit for bit):
//   * bf16 x bf16: WgmmaPath, wgmma on the tensor cores from 128-byte-
//     swizzled stages filled by TMA (rows 16-byte aligned) or cp.async;
//     128 x 128 tiles when they fill the card (the h2o MLP edge, 4096 x
//     2560 @ 2560 x 6912: 1728 tiles), else 64 x 64;
//   * fp32 x fp32: SimtPath, fp32 FMAs on the CUDA cores (no TF32: the
//     reference's fp32 dot is full fp32), four k-groups a block.
// The epilogue (DlaStore) adds the bias, applies the activation and
// stores fp32 or bf16 straight from the path's sums.
// Operands: x (M, K) with row stride sxm, w (K, N) with row stride swk,
// both with unit column stride; out (M, N) contiguous.  Ragged M, N and K
// are masked in the kernel (out-of-range elements load as zero and are not
// stored), so the wrapper pads nothing.
//
// What bounds it: at the MLP edge the tensor cores' 989 TFLOP/s (0.147 ms
// for 145 GFLOP); at the case study's fp32 sizes the CUDA cores'
// 67 TFLOP/s.
// Every C entry point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU2 = 2, ACT_SILU = 3,
           ACT_GELU = 4 };

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// the reference's _apply_activation, in fp32
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if (ACT == ACT_RELU2) {
    const float r = fmaxf(v, 0.f);
    return r * r;
  }
  if (ACT == ACT_SILU) return v * (1.f / (1.f + expf(-v)));
  if (ACT == ACT_GELU) {
    // jax.nn.gelu's default: x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
    const float c = 0.7978845608028654f;
    return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
  }
  return v;
}

// the DLA epilogue: out[gm][gn] = act(v + bias[gn]) in fp32, then one cast.
// The activation is a template argument: the bf16 path calls the epilogue
// from 64 unrolled sites, and a switch at each would crowd the
// instruction cache.
template <typename TO, int ACT>
struct DlaStore {
  const void* bias;   // (N,) fp32 or bf16, or null
  int bias_bf16;
  TO* out;
  int n;              // out's row pitch
  __device__ __forceinline__ void operator()(int gm, int gn, float v) const {
    if (bias != nullptr)
      v = v + (bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[gn])
                         : static_cast<const float*>(bias)[gn]);
    out[(ll)gm * n + gn] = from_f<TO>(activate<ACT>(v));
  }
};

// one output tile a block; M tiles on grid.x, so the blocks in flight
// share w's column tiles and x stays in L2 (the MLP edge's 21 MB x)
template <class Path, typename TO, int ACT>
__global__ void __launch_bounds__(Path::THREADS)
dla_gemm(const typename Path::TX* __restrict__ x,
         const typename Path::TW* __restrict__ w, const void* bias,
         int bias_bf16, TO* __restrict__ out, int M, int N, int K, ll sxm,
         ll swk, int vec, const __grid_constant__ gemm::TmaMaps tm,
         int use_tma) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int m0 = blockIdx.x * Path::BM, n0 = blockIdx.y * Path::BN;
  Path::tile(x, sxm, w, swk, M, N, K, m0, n0, vec != 0, dsmem,
             DlaStore<TO, ACT>{bias, bias_bf16, out, N},
             use_tma ? &tm : nullptr, 0);
}

template <class Path, typename TO, int ACT>
int launch(const void* x, const void* w, const void* bias, int bias_bf16,
           void* out, int M, int N, int K, ll sxm, ll swk,
           cudaStream_t stream) {
  if ((N + Path::BN - 1) / Path::BN > 65535)   // grid.y
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      hopper::set_smem((const void*)dla_gemm<Path, TO, ACT>, Path::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int vec = gemm::rows_aligned(x, w, 1, 0, sxm, swk,
                                     sizeof(typename Path::TX),
                                     sizeof(typename Path::TW));
  gemm::TmaMaps tm{};
  int use_tma = 0;
  if (Path::TMA && vec && K > 0) {
    if (!gemm::map_operands(&tm, x, w, 1, M, N, K, 0, sxm, swk, Path::BM))
      return (int)cudaErrorInvalidValue;
    use_tma = 1;
  }
  const dim3 grid((M + Path::BM - 1) / Path::BM, (N + Path::BN - 1) / Path::BN);
  dla_gemm<Path, TO, ACT><<<grid, Path::THREADS, Path::SMEM, stream>>>(
      static_cast<const typename Path::TX*>(x),
      static_cast<const typename Path::TW*>(w), bias, bias_bf16,
      static_cast<TO*>(out), M, N, K, sxm, swk, vec, tm, use_tma);
  return (int)cudaGetLastError();
}

template <class Path, typename TO>
int by_act(int act, const void* x, const void* w, const void* bias,
           int bias_bf16, void* out, int M, int N, int K, ll sxm, ll swk,
           cudaStream_t s) {
  switch (act) {
    case ACT_NONE:
      return launch<Path, TO, ACT_NONE>(x, w, bias, bias_bf16, out, M, N, K,
                                        sxm, swk, s);
    case ACT_RELU:
      return launch<Path, TO, ACT_RELU>(x, w, bias, bias_bf16, out, M, N, K,
                                        sxm, swk, s);
    case ACT_RELU2:
      return launch<Path, TO, ACT_RELU2>(x, w, bias, bias_bf16, out, M, N,
                                         K, sxm, swk, s);
    case ACT_SILU:
      return launch<Path, TO, ACT_SILU>(x, w, bias, bias_bf16, out, M, N, K,
                                        sxm, swk, s);
    case ACT_GELU:
      return launch<Path, TO, ACT_GELU>(x, w, bias, bias_bf16, out, M, N, K,
                                        sxm, swk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out = act(x @ w + bias); dtypes 0 = fp32, 1 = bf16 (dbias -1: no bias);
// act 0..4 = none, relu, relu2, silu, gelu; x and w of one dtype
int repro_matmul(int din, int dout, int dbias, int act, const void* x,
                 const void* w, const void* bias, void* out, int M, int N,
                 int K, ll sxm, ll swk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* b = dbias < 0 ? nullptr : bias;
  const int b16 = dbias == 1;
  auto run = [&](auto path) {
    using Path = decltype(path);
    if (dout == 1)
      return by_act<Path, bf16>(act, x, w, b, b16, out, M, N, K, sxm, swk, s);
    return by_act<Path, float>(act, x, w, b, b16, out, M, N, K, sxm, swk, s);
  };
  if (din == 1) return gemm::with_bf16_path(1, M, N, run);
  if (din == 0) return gemm::with_f32_path<float, float>(1, M, N, K, run);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
