// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with GQA, an explicit q offset, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas / _attn_kernel).  It computes the same function:
// out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[...]
// over the visible columns j, in fp32, written in q's type, with rows that
// see no column at all written as 0.  Unlike the Pallas kernel, q row i
// sits at absolute position q_offset + i (the Pallas kernel hard-codes 0),
// which is what lets chunked prefill attend a mid-sequence chunk against
// the full-length K/V scratch through this kernel.
//
// Design (the simple first version):
//  * One block per (b * Hq + h, tile of BLOCK_Q = 64 q rows); each of its
//    64 threads owns one q row and keeps q, the running max m, the
//    normaliser l and acc[D] in fp32 registers.  The loop over kv tiles
//    inside the block replaces the Pallas kernel's sequential kv grid axis.
//  * K and V tiles of BLOCK_KV = 32 rows are staged in shared memory as
//    fp32; every thread of a warp reads the same K/V element at the same
//    time, so the reads are broadcasts.
//  * Tiles wholly above the causal limit or below the window are never
//    visited (the _block_ranges rule of repro/models/layers.py), so chunk 0
//    of a long prompt does not scan the zero rows of the scratch.  The
//    ragged edge (col >= Skv) is masked here; the wrapper pads nothing.
//
// What bounds it on this card: at the serving shapes attention is
// compute-bound (the bulk 2048-token causal prefill of smollm-360m does
// ~8.1 GFLOP on ~10.5 MB: ~8 us at 989 TFLOP/s bf16).  This version does
// its arithmetic on the fp32 CUDA cores, one shared-memory read per four
// FMAs, with 2 warps per block — it is far from that bound by design.
// Reaching it needs wgmma on tensor cores with TMA-fed K/V tiles, which is
// later work; the plain version in ref.py is the oracle it is held to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_KV = 32;
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, skv;
  long long q_sb, q_sh, q_ss;  // element strides of q over (b, h, s)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int q_offset;  // absolute position of q row 0
  int causal;
  int window;    // <= 0: no window
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_Q) flash_fwd(const Args a) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[BLOCK_KV][D];
  __shared__ __align__(16) float vs[BLOCK_KV][D];

  const int bh = blockIdx.y;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = blockIdx.x * BLOCK_Q;
  const int i = i0 + threadIdx.x;
  const bool live = i < a.sq;
  const long long row = (long long)a.q_offset + i;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(q[(long long)i * a.q_ss + d]) * a.scale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // kv columns visible to some row of this tile: [c_lo, c_hi)
  const long long r_lo = (long long)a.q_offset + i0;
  const long long r_hi = (long long)a.q_offset + min(i0 + BLOCK_Q, a.sq) - 1;
  long long c_hi = a.skv;
  if (a.causal) c_hi = min(c_hi, r_hi + 1);
  long long c_lo = 0;
  if (a.window > 0) c_lo = max(0LL, r_lo - a.window + 1);
  const int t_lo = (int)(c_lo / BLOCK_KV);
  const int t_hi = c_hi > c_lo ? (int)((c_hi + BLOCK_KV - 1) / BLOCK_KV) : t_lo;

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * BLOCK_KV;
    __syncthreads();  // every row is done with the previous tile
    for (int idx = threadIdx.x; idx < BLOCK_KV * D; idx += BLOCK_Q) {
      const int j = idx / D;
      const int d = idx % D;
      const int c = c0 + j;
      const bool in = c < a.skv;
      ks[j][d] = in ? to_f32(k[(long long)c * a.k_ss + d]) : 0.f;
      vs[j][d] = in ? to_f32(v[(long long)c * a.v_ss + d]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    float s[BLOCK_KV];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      const long long c = c0 + j;
      bool vis = c < a.skv;
      if (a.causal) vis = vis && c <= row;
      if (a.window > 0) vis = vis && c > row - a.window;
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot += qr[4 * d4] * kk.x;
        dot += qr[4 * d4 + 1] * kk.y;
        dot += qr[4 * d4 + 2] * kk.z;
        dot += qr[4 * d4 + 3] * kk.w;
      }
      s[j] = vis ? dot : NEG_INF;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new <= 0.5f * NEG_INF) continue;  // nothing visible to this row yet
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_KV; ++j) {
      const float p = s[j] <= 0.5f * NEG_INF ? 0.f : expf(s[j] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] += p * vv.x;
        acc[4 * d4 + 1] += p * vv.y;
        acc[4 * d4 + 2] += p * vv.z;
        acc[4 * d4 + 3] += p * vv.w;
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!live) return;
  const float denom = l == 0.f ? 1.f : l;  // a row that saw nothing -> 0
  T* o = static_cast<T*>(a.o) + (((long long)b * a.hq + h) * a.sq + i) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_f32<T>(acc[d] / denom);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.sq + BLOCK_Q - 1) / BLOCK_Q, batch * a.hq);
  flash_fwd<T, D><<<grid, BLOCK_Q, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const Args& a, int batch,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 80: return launch<T, 80>(a, batch, stream);
    case 96: return launch<T, 96>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Output o is contiguous (B, Hq, Sq, D).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, int batch, int hq, int hkv, int sq, int skv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int q_offset, int causal, int window, float scale, void* stream) {
  Args a{q, k, v, o, hq, hkv, sq, skv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
         v_sb, v_sh, v_ss, q_offset, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dim<float>(head_dim, a, batch, st);
  } else if (dtype == 1) {
    err = dispatch_dim<__nv_bfloat16>(head_dim, a, batch, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
