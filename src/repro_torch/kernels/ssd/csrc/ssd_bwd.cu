// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the reference's gradient of the scan: XLA's autodiff of
// repro/models/layers.py:640 ssd_jnp (the reference trains through ssd_jnp,
// and no Pallas kernel of the repo has a custom_vjp).  It computes, for the
// cotangents dy of y and dstate of the final state, the gradients of x, dt,
// a, B, C, d and init_state of the forward in ssd.cu.  Per batch row b, head
// h (group g = h / (H / G)) and chunk k of L rows, with cum the inclusive
// within-chunk cumsum of a_h dt, total = cum[L - 1], u = exp(total - cum) dt,
// F_lm = exp(cum_l - cum_m) [l >= m], S = C B^T and W = S F dt_m:
//   dlocal_k = sum_l exp(cum_l) C_l^T dy_l                     (N x P)
//   g_k      = dstate for the last chunk, then g_{k-1} = exp(total_k) g_k
//              + dlocal_k; d init_state = exp(total_0) g_0 + dlocal_0
//   dx       = W^T dy + u (B g_k) + d dy
//   dB_h     = (dy x^T F dt_m)^T C + u (x g_k^T)               (per head)
//   dC_h     = (dy x^T F dt_m) B + exp(cum) (dy s_in^T)       (per head)
//   dcum     = the decay factors' rows minus columns of dy x^T * W, the
//              state-entry term dy . exp(cum) C s_in, minus u (dL/du), and
//              at the last row exp(total) <g_k, s_in> + sum u (dL/du)
//   ddt      = dL/dt from W and u directly + a * (reverse cumsum of dcum)
//   da       = sum dt * (reverse cumsum of dcum),  dd = sum dy x
// and dB, dC summed over the heads of a group.  ref.ssd_bwd_plain is the
// same split in plain PyTorch (Mamba-2's public Triton backward,
// mamba_ssm/ops/triton/ssd_combined.py, splits it the same way).
//
// The design follows the forward's split (ssd.cu) in reverse, four kernels
// on the stream, none with a float atomic: every sum is taken by one thread
// or in a fixed order, so two calls on the same inputs give the same bits.
//   1. ssd_bwd_dlocal: a block per (b, chunk, head) computes dlocal_k from C
//      and exp(cum) dy into fp32 scratch `gbuf`, and the chunk's total.
//   2. ssd_bwd_pass: one thread per 4 elements of a (b, h) state walks the
//      chunks backwards from dstate, replacing dlocal_k by g_k in place, and
//      writes d init_state -- the forward pass's update run in reverse.
//   3. ssd_bwd_chunks: a block per (b, chunk, head) computes dx, ddt and the
//      head's dB_h, dC_h (fp32 scratch, (B, S, H, N)) and its partial sums of
//      da and dd.  It reads the state that entered the chunk: init_state for
//      chunk 0, else the forward's s_in (kept in x's type: in bf16 a
//      rounding of ~2^-9 on the terms that use it).  The L x L matrices W
//      and dS stay in shared memory (two 128 x 132 fp32 buffers) while the
//      block runs its five products (C B^T, dy x^T, then dx, dB_h and dC_h,
//      each with its state term); dS^T, which dC_h contracts over its other
//      index, is transposed into W's buffer once dx has spent W.  The
//      operands stream through two staging slices 32 deep, converted to
//      fp32 (and transposed where a product contracts their columns) as
//      they land.
//   4. ssd_bwd_reduce: dB and dC summed over the heads of each group in head
//      order, and da, dd over (batch, chunk) in order, in a last block.
// Every product runs on the CUDA cores in fp32 (bf16 operands are exact in
// fp32; no TF32).  A warp takes 32 rows of the 128-row output and half its
// columns, a thread 8 consecutive rows by 4 or 8 columns in runs of 4, so
// each k of a product is two 16-byte reads of A and one or two of B for 32
// or 64 FMAs, and the 8 lanes of a row cover 128 contiguous bytes of it (in
// the epilogues' global loads and stores too).  A warp skips what the
// causal mask zeroes: its L x L tiles above the diagonal, and the 32-row
// slices of l (or m) that its rows cannot reach.  A thread issues all its
// loads of a staged slice before its first store.
//
// What bounds it: at mamba2-2.7b's widths (H 80, P 64, N 128, G 1, L 128)
// the function needs ~19 GFLOP at S 2048 a batch row, ~0.28 ms at the CUDA
// cores' fp32 peak (67 TFLOP/s) or ~0.02 ms at the bf16 tensor-core peak;
// its bytes are ~0.07 GB (~0.02 ms at 3.35 TB/s).  At the training
// microbatch (B 4, S 2048, bf16) the four kernels take ~7.6 ms on an H100
// SXM (700 W): dlocal 0.57, the pass 0.31, the chunks 6.49, the reduction
// 0.23 (the first design, a thread's rows and columns 16 apart and read one
// float at a time, 10.3).  Patched copies of the chunks kernel put ~1.9 ms
// in what is neither a product nor staging (the L x L epilogues, the
// transpose, the reductions, the epilogues' global traffic), ~2.0 ms in
// staging (one block an SM at 176 KB of shared memory: the slices' load
// latency is not hidden) and ~2.7 ms in the products.  What a redesign
// would take (ROADMAP queue 2): the bf16 products on wgmma (as the
// forward's; W, dS and g_k fed as bf16 high and low parts), slices brought
// in by TMA or cp.async a stage ahead, and C B^T shared by a block's heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int NT = 256;        // threads of a block: 8 warps
constexpr int MAXR = 128;      // rows of every product's output (L, N <= 128)
constexpr int KT = 32;         // depth of a staged slice
constexpr int LDM = MAXR + 4;  // row stride of the L x L buffers and of a
                               // transposed slice (16-byte rows)
constexpr int STG = KT * LDM;  // floats of a staging slice
constexpr int MAX_CHUNK = 128;

struct Args {
  const void* x;        // (B, S, H, P), strides x_sb, x_ss, x_sh
  const float* dt;      // (B, S, H), strides dt_sb, dt_ss, dt_sh
  const float* a;       // (H,)
  const void* b;        // (B, S, G, N), strides b_sb, b_ss, b_sg
  const void* c;        // (B, S, G, N), strides c_sb, c_ss, c_sg
  const float* d;       // (H,)
  const float* init;    // (B, H, N, P) contiguous, or null for zeros
  const void* s_in;     // (B, nc, H, N, P) x's type: states entering chunks
  const void* dy;       // (B, S, H, P) contiguous, x's type
  const float* dstate;  // (B, H, N, P) contiguous, or null for zeros
  void* dx;             // (B, S, H, P) contiguous, x's type
  float* ddt;           // (B, S, H) contiguous
  float* gbuf;          // (B, nc, H, N, P): dlocal_k, then g_k
  float* total;         // (B, nc, H)
  float* dbh;           // (B, S, H, N): each head's dB
  float* dch;           // (B, S, H, N): each head's dC
  float* part;          // (B, nc, H, 2): partial da and dd
  int seq, heads, groups, n, p, chunk, nc, hpg;
  ll x_sb, x_ss, x_sh;
  ll dt_sb, dt_ss, dt_sh;
  ll b_sb, b_ss, b_sg;
  ll c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// four consecutive elements, 16 (fp32) or 8 (bf16) bytes aligned
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ unsigned bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  uint2 u;
  u.x = bits(v.x) | bits(v.y) << 16;
  u.y = bits(v.z) | bits(v.w) << 16;
  *reinterpret_cast<uint2*>(p) = u;
}

// A slice of a row-major global tile src (row stride rs, columns
// contiguous) as fp32 in shared memory: element (r, q) of the ROWS x COLS
// tile to dst[r * ld + q] (`trans` false) or dst[q * ld + r] (true); zero
// where r >= nr or q >= nq (a ragged edge, rows past S, columns past N or
// P); each row times scale[r] when scale is given.  A thread loads all its
// elements before it stores one, so its loads are in flight together.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, bool trans,
                                      const T* __restrict__ src, ll rs,
                                      int nr, int nq,
                                      const float* scale = nullptr) {
  constexpr int PER = ROWS * COLS / NT;
  float v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT;
    const int r = e / COLS, q = e % COLS;
    v[u] = (r < nr && q < nq) ? to_f(src[r * rs + q]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT;
    const int r = e / COLS, q = e % COLS;
    dst[trans ? q * ld + r : r * ld + q] =
        scale != nullptr ? v[u] * scale[r] : v[u];
  }
}

// The register tile of a thread: warp w takes rows 32 (w / 2) .. + 32 and
// columns 8 CJ (w % 2) .. + 8 CJ of the block's 128 x 16 CJ output; lane l
// rows 8 (l / 8) + i, i < 8, and columns col0 + cofs(j), j < CJ: 4 (l % 8)
// + 32 (j / 4) + j % 4.  A thread reads 8 rows and CJ columns of a k as
// 16-byte vectors, and the 8 lanes of a row cover 128 contiguous bytes of
// it, in shared memory and in an epilogue's global row
__device__ __forceinline__ int row0() {
  return 32 * (threadIdx.x >> 6) + 8 * ((threadIdx.x & 31) >> 3);
}
template <int CJ>
__device__ __forceinline__ int col0() {
  return 8 * CJ * ((threadIdx.x >> 5) & 1) + 4 * (threadIdx.x & 7);
}
__device__ __forceinline__ int cofs(int j) { return 32 * (j >> 2) + (j & 3); }
// the first row of this thread's warp
__device__ __forceinline__ int warp_row0() { return 32 * (threadIdx.x >> 6); }

// acc[i][j] += sum_{k < KT} A[k * lda + row0 + i] B[k * ldb + col0 +
// cofs(j)]
template <int CJ>
__device__ __forceinline__ void mma(float (&acc)[8][CJ], const float* A,
                                    int lda, const float* B, int ldb) {
  const float* pa = A + row0();
  const float* pb = B + col0<CJ>();
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    float av[8], bv[CJ];
    const float4 a0 = *reinterpret_cast<const float4*>(pa + k * lda);
    const float4 a1 = *reinterpret_cast<const float4*>(pa + k * lda + 4);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
#pragma unroll
    for (int j = 0; j < CJ; j += 4) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(pb + k * ldb + 8 * j);
      bv[j] = b4.x; bv[j + 1] = b4.y; bv[j + 2] = b4.z; bv[j + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int CJ>
__device__ __forceinline__ void zero(float (&acc)[8][CJ]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// sum over the 16 threads that hold a row (8 lanes of 2 warps) of v[i],
// rows row0 + i, in a fixed order, added to out[row] by the first MAXR
// threads; red holds 128 x 16
__device__ __forceinline__ void row_sum(const float (&v)[8], float* red,
                                        float* out) {
  const int slot = 8 * ((threadIdx.x >> 5) & 1) + (threadIdx.x & 7);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) red[(row0() + i) * 16 + slot] = v[i];
  __syncthreads();
  if (threadIdx.x < MAXR) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[threadIdx.x * 16 + t];
    out[threadIdx.x] += s;
  }
  __syncthreads();
}

// a thread's register tile to rows row0 + i < nr of out (row stride rs),
// columns col0 + cofs(j) < nq, as 16-byte stores
template <int CJ>
__device__ __forceinline__ void store_rows(float* out, ll rs,
                                           const float (&acc)[8][CJ], int i0,
                                           int c0, int nr, int nq) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i0 + i >= nr) continue;
#pragma unroll
    for (int j = 0; j < CJ; j += 4)
      if (c0 + 8 * j < nq)
        st4(out + (i0 + i) * rs + c0 + 8 * j,
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]));
  }
}

// a block's rows of one (b, chunk, head): dt (zero past S and past the
// chunk), cum (held at its last value past the chunk) and the valid rows
struct Rows {
  int bi, k, h, grp, row0, lv;
};

__device__ __forceinline__ Rows chunk_rows(const Args& a, float* dts,
                                           float* cum) {
  Rows r;
  const int blk = blockIdx.x;
  r.h = blk % a.heads;
  r.k = (blk / a.heads) % a.nc;
  r.bi = blk / (a.heads * a.nc);
  r.grp = r.h / a.hpg;
  r.row0 = r.k * a.chunk;
  r.lv = a.seq - r.row0 < a.chunk ? a.seq - r.row0 : a.chunk;
  const int t = threadIdx.x;
  if (t < MAXR)
    dts[t] = t < r.lv ? a.dt[r.bi * a.dt_sb + (r.row0 + t) * a.dt_ss +
                             r.h * a.dt_sh]
                      : 0.f;
  __syncthreads();
  if (t == 0) {
    const float av = a.a[r.h];
    float s = 0.f;
    for (int l = 0; l < MAXR; ++l) {
      if (l < a.chunk) s += dts[l] * av;
      cum[l] = s;
    }
  }
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// 1. dlocal_k = sum_l exp(cum_l) C_l^T dy_l and the chunk totals
// ---------------------------------------------------------------------------

// two blocks an SM (128 registers a thread, some spilled): unbounded,
// ptxas gave it 198 registers and one block an SM, and it ran 2.3x slower
template <typename T, int PJ>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_dlocal(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* dts = sm;
  float* cum = dts + MAXR;
  float* ec = cum + MAXR;
  float* sa = ec + MAXR;              // C slice: KT x 128
  float* sb = sa + KT * MAXR;         // exp(cum) dy slice: KT x 16 PJ
  const Rows r = chunk_rows(a, dts, cum);
  if (threadIdx.x < MAXR) ec[threadIdx.x] = expf(cum[threadIdx.x]);
  const T* cb = static_cast<const T*>(a.c) + r.bi * a.c_sb +
                r.row0 * a.c_ss + r.grp * a.c_sg;
  const ll hp = (ll)a.heads * a.p;
  const T* dyb = static_cast<const T*>(a.dy) +
                 ((ll)r.bi * a.seq + r.row0) * hp + (ll)r.h * a.p;
  const bool active = warp_row0() < a.n;      // rows n of the output
  float acc[8][PJ];
  zero(acc);
  for (int l0 = 0; l0 < a.chunk; l0 += KT) {
    __syncthreads();
    stage<KT, MAXR>(sa, MAXR, false, cb + l0 * a.c_ss, a.c_ss, r.lv - l0,
          a.n);
    stage<KT, 16 * PJ>(sb, 16 * PJ, false, dyb + l0 * hp, hp, r.lv - l0,
          a.p, ec + l0);
    __syncthreads();
    if (active) mma<PJ>(acc, sa, MAXR, sb, 16 * PJ);
  }
  const ll hk = ((ll)r.bi * a.nc + r.k) * a.heads + r.h;
  float* out = a.gbuf + hk * a.n * a.p;
  const int n0 = row0(), q0 = col0<PJ>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (n0 + i >= a.n) continue;
#pragma unroll
    for (int j = 0; j < PJ; j += 4)
      if (q0 + 8 * j < a.p)
        st4(out + (ll)(n0 + i) * a.p + q0 + 8 * j,
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]));
  }
  if (threadIdx.x == 0) a.total[hk] = cum[a.chunk - 1];
}

// ---------------------------------------------------------------------------
// 2. the reverse pass over the chunks
// ---------------------------------------------------------------------------

// one thread per 4 elements of one (b, h) state: for k from the last chunk
// down, g_k replaces dlocal_k in gbuf, then g = exp(total_k) g + dlocal_k
__global__ void __launch_bounds__(256)
    ssd_bwd_pass(float* __restrict__ gbuf, const float* __restrict__ total,
                 const float* __restrict__ dstate, float* __restrict__ dinit,
                 int nc, int heads, int np4) {
  const int bh = blockIdx.y;
  const int bi = bh / heads, h = bh - bi * heads;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= np4) return;
  const ll sz = (ll)np4 * 4;
  float4 g = dstate != nullptr
                 ? reinterpret_cast<const float4*>(dstate + bh * sz)[e]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = nc - 1; k >= 0; --k) {
    const ll hk = ((ll)bi * nc + k) * heads + h;
    float4* slot = reinterpret_cast<float4*>(gbuf + hk * sz) + e;
    const float4 l = *slot;
    *slot = g;
    const float et = expf(total[hk]);
    g.x = et * g.x + l.x;
    g.y = et * g.y + l.y;
    g.z = et * g.z + l.z;
    g.w = et * g.w + l.w;
  }
  reinterpret_cast<float4*>(dinit + bh * sz)[e] = g;
}

// ---------------------------------------------------------------------------
// 3. every chunk's gradients
// ---------------------------------------------------------------------------

template <typename T, int NJ, int PJ>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_chunks(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* m1 = sm;               // S F, then W, then dS^T
  float* m2 = m1 + MAXR * LDM;  // dS
  float* sa = m2 + MAXR * LDM;  // staging slices
  float* sb = sa + STG;
  float* red = sb + STG;        // 128 x 16 partial sums
  float* dts = red + 16 * MAXR;
  float* cum = dts + MAXR;
  float* uu = cum + MAXR;       // u = exp(total - cum) dt
  float* dcum = uu + MAXR;      // dL/dcum, gathered from the phases
  float* ddtd = dcum + MAXR;    // dL/ddt through W
  float* du = ddtd + MAXR;      // dL/du
  const Rows r = chunk_rows(a, dts, cum);
  const int tid = threadIdx.x;
  const int L = a.chunk, N = a.n, P = a.p, lv = r.lv;
  const int i0 = row0(), wr0 = warp_row0();
  const float total = cum[L - 1];
  if (tid < MAXR) {
    uu[tid] = expf(total - cum[tid]) * dts[tid];
    dcum[tid] = ddtd[tid] = du[tid] = 0.f;
  }
  const T* xb = static_cast<const T*>(a.x) + r.bi * a.x_sb +
                r.row0 * a.x_ss + r.h * a.x_sh;
  const T* bb = static_cast<const T*>(a.b) + r.bi * a.b_sb +
                r.row0 * a.b_ss + r.grp * a.b_sg;
  const T* cb = static_cast<const T*>(a.c) + r.bi * a.c_sb +
                r.row0 * a.c_ss + r.grp * a.c_sg;
  const ll hp = (ll)a.heads * P;
  const ll rowbase = (ll)r.bi * a.seq + r.row0;   // (b, first row) of S
  const T* dyb = static_cast<const T*>(a.dy) + rowbase * hp + (ll)r.h * P;
  const ll hk = ((ll)r.bi * a.nc + r.k) * a.heads + r.h;
  const float* gk = a.gbuf + hk * N * P;
  const T* sin_k = r.k > 0 ? static_cast<const T*>(a.s_in) + hk * N * P
                           : nullptr;
  const float* init_k =
      a.init != nullptr ? a.init + ((ll)r.bi * a.heads + r.h) * N * P
                        : nullptr;
  auto decay = [&](int l, int m) {
    return (l >= m && l < L) ? expf(cum[l] - cum[m]) : 0.f;
  };
  // an L x L tile of this warp holds only zeros above the diagonal
  const int wc0 = 64 * ((tid >> 5) & 1);
  const bool tri = wc0 <= wr0 + 31 && wr0 < L;
  __syncthreads();

  // S F = (C B^T) F, kept in m1
  {
    float acc[8][8];
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += KT) {
      __syncthreads();
      stage<MAXR, KT>(sa, LDM, true, cb + n0, a.c_ss, lv, N - n0);
      stage<MAXR, KT>(sb, LDM, true, bb + n0, a.b_ss, lv, N - n0);
      __syncthreads();
      if (tri) mma<8>(acc, sa, LDM, sb, LDM);
    }
    const int c0 = col0<8>();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m1[(i0 + i) * LDM + c0 + cofs(j)] =
            acc[i][j] * decay(i0 + i, c0 + cofs(j));
  }

  // dW = dy x^T: W = S F dt_m into m1, dS = dW F dt_m into m2, and the
  // gradients of cum and dt through the decay factors and dt_m
  {
    float acc[8][8];
    zero(acc);
    for (int p0 = 0; p0 < P; p0 += KT) {
      __syncthreads();
      stage<MAXR, KT>(sa, LDM, true, dyb + p0, hp, lv, P - p0);
      stage<MAXR, KT>(sb, LDM, true, xb + p0, a.x_ss, lv, P - p0);
      __syncthreads();
      if (tri) mma<8>(acc, sa, LDM, sb, LDM);
    }
    const int c0 = col0<8>();
    float rowq[8], colr[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) colr[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rowq[i] = 0.f;
      const int l = i0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = c0 + cofs(j);
        const float sf = m1[l * LDM + m], dtm = dts[m];
        const float rr = acc[i][j] * sf;     // dW S F
        rowq[i] += rr * dtm;
        colr[j] += rr;
        m1[l * LDM + m] = sf * dtm;
        m2[l * LDM + m] = acc[i][j] * decay(l, m) * dtm;
      }
    }
    row_sum(rowq, red, dcum);
    // columns: 16 partials a column (4 lanes of 4 warps), in a fixed order
    const int slot = 4 * (tid >> 6) + ((tid & 31) >> 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) red[slot * MAXR + c0 + cofs(j)] = colr[j];
    __syncthreads();
    if (tid < MAXR) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += red[t * MAXR + tid];
      ddtd[tid] += s;
      dcum[tid] -= dts[tid] * s;
    }
    __syncthreads();
  }

  // dx = u (B g_k) + W^T dy + d dy, and dL/du = x . (B g_k)
  float dd_sum = 0.f;
  {
    const int c0 = col0<PJ>();
    float acc[8][PJ];
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += KT) {
      __syncthreads();
      stage<MAXR, KT>(sa, LDM, true, bb + n0, a.b_ss, lv, N - n0);
      stage<KT, 16 * PJ>(sb, 16 * PJ, false, gk + (ll)n0 * P, (ll)P,
            N - n0, P);
      __syncthreads();
      mma<PJ>(acc, sa, LDM, sb, 16 * PJ);
    }
    float rowu[8], xv[8][PJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int m = i0 + i, q = c0 + cofs(j);
        xv[i][j] = m < lv && q < P ? to_f(xb[m * a.x_ss + q]) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rowu[i] = 0.f;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        rowu[i] += xv[i][j] * acc[i][j];
        acc[i][j] *= uu[i0 + i];
      }
    }
    row_sum(rowu, red, du);
    for (int l0 = 0; l0 < L; l0 += KT) {
      __syncthreads();
      stage<KT, 16 * PJ>(sb, 16 * PJ, false, dyb + l0 * hp, hp, lv - l0, P);
      __syncthreads();
      if (l0 + KT > wr0) mma<PJ>(acc, m1 + l0 * LDM, LDM, sb, 16 * PJ);
    }
    const float dv = a.d[r.h];
    T* dxb = static_cast<T*>(a.dx) + rowbase * hp + (ll)r.h * P;
    float4 dyv[8][PJ / 4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < PJ; j += 4) {
        const int m = i0 + i, q = c0 + 8 * j;
        dyv[i][j / 4] = m < lv && q < P ? ld4(dyb + m * hp + q)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = i0 + i;
#pragma unroll
      for (int j = 0; j < PJ; j += 4) {
        const int q = c0 + 8 * j;
        const float4 g = dyv[i][j / 4];
        dd_sum += g.x * xv[i][j] + g.y * xv[i][j + 1] + g.z * xv[i][j + 2] +
                  g.w * xv[i][j + 3];
        if (m < lv && q < P)
          st4(dxb + m * hp + q,
              make_float4(acc[i][j] + dv * g.x, acc[i][j + 1] + dv * g.y,
                          acc[i][j + 2] + dv * g.z, acc[i][j + 3] + dv * g.w));
      }
    }
  }

  // dB_h = u (x g_k^T) + dS^T C
  {
    const int c0 = col0<NJ>();
    float acc[8][NJ];
    zero(acc);
    for (int p0 = 0; p0 < P; p0 += KT) {
      __syncthreads();
      stage<MAXR, KT>(sa, LDM, true, xb + p0, a.x_ss, lv, P - p0);
      stage<MAXR, KT>(sb, LDM, true, gk + p0, (ll)P, N, P - p0);
      __syncthreads();
      mma<NJ>(acc, sa, LDM, sb, LDM);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= uu[i0 + i];
    for (int l0 = 0; l0 < L; l0 += KT) {
      __syncthreads();
      stage<KT, 16 * NJ>(sb, 16 * NJ, false, cb + l0 * a.c_ss, a.c_ss,
            lv - l0, N);
      __syncthreads();
      if (l0 + KT > wr0) mma<NJ>(acc, m2 + l0 * LDM, LDM, sb, 16 * NJ);
    }
    store_rows(a.dbh + (rowbase * a.heads + r.h) * N, (ll)a.heads * N, acc,
               i0, c0, lv, N);
  }

  // dS^T into m1 (W is spent)
  __syncthreads();
  for (int e = tid; e < MAXR * MAXR; e += NT) {
    const int l = e / MAXR, m = e - l * MAXR;
    m1[m * LDM + l] = m2[l * LDM + m];
  }

  // dC_h = exp(cum) (dy s_in^T) + dS B, and dcum_l += C_l . exp(cum_l)
  // (dy s_in^T)_l
  {
    const int c0 = col0<NJ>();
    float acc[8][NJ];
    zero(acc);
    for (int p0 = 0; p0 < P; p0 += KT) {
      __syncthreads();
      stage<MAXR, KT>(sa, LDM, true, dyb + p0, hp, lv, P - p0);
      if (sin_k != nullptr)
        stage<MAXR, KT>(sb, LDM, true, sin_k + p0, (ll)P, N, P - p0);
      else
        stage<MAXR, KT>(sb, LDM, true, init_k + p0, (ll)P,
              init_k != nullptr ? N : 0, P - p0);
      __syncthreads();
      mma<NJ>(acc, sa, LDM, sb, LDM);
    }
    float rowc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rowc[i] = 0.f;
      const int l = i0 + i;
      const float e = expf(cum[l]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int q = c0 + cofs(j);
        acc[i][j] *= e;
        if (l < lv && q < N) rowc[i] += to_f(cb[l * a.c_ss + q]) * acc[i][j];
      }
    }
    row_sum(rowc, red, dcum);
    for (int m0 = 0; m0 < L; m0 += KT) {
      __syncthreads();
      stage<KT, 16 * NJ>(sb, 16 * NJ, false, bb + m0 * a.b_ss, a.b_ss,
            lv - m0, N);
      __syncthreads();
      if (m0 <= wr0 + 31) mma<NJ>(acc, m1 + m0 * LDM, LDM, sb, 16 * NJ);
    }
    store_rows(a.dch + (rowbase * a.heads + r.h) * N, (ll)a.heads * N, acc,
               i0, c0, lv, N);
  }

  // exp(total) <g_k, s_in[k]>, sum dy x, and the reverse cumsum of dcum
  // over the rows, by warp 0 in a fixed order: each lane sums 8 partials
  // and takes rows 4 lane .. + 4, then fixed shuffle trees and a suffix
  // scan over the lanes
  float gs = 0.f;
  for (int e = tid; e < N * P; e += NT) {
    const float s = sin_k != nullptr ? to_f(sin_k[e])
                    : init_k != nullptr ? init_k[e] : 0.f;
    gs += gk[e] * s;
  }
  __syncthreads();
  red[tid] = gs;
  red[NT + tid] = dd_sum;
  __syncthreads();
  if (tid < 32) {
    constexpr unsigned ALL = 0xffffffffu;
    float g8 = 0.f, d8 = 0.f, ud = 0.f;
    for (int t = 0; t < 8; ++t) {
      g8 += red[tid * 8 + t];
      d8 += red[NT + tid * 8 + t];
    }
    for (int t = 0; t < 4; ++t) ud += uu[4 * tid + t] * du[4 * tid + t];
    for (int off = 16; off > 0; off >>= 1) {
      g8 += __shfl_xor_sync(ALL, g8, off);
      d8 += __shfl_xor_sync(ALL, d8, off);
      ud += __shfl_xor_sync(ALL, ud, off);
    }
    const float dtot = __shfl_sync(ALL, ud, 0) +
                       expf(total) * __shfl_sync(ALL, g8, 0);
    // ddt_l = the direct terms + a * (reverse cumsum of dcum)_l
    float dc[4], own = 0.f;
    for (int t = 3; t >= 0; --t) {
      const int l = 4 * tid + t;
      dc[t] = l < L ? dcum[l] - uu[l] * du[l] + (l == L - 1 ? dtot : 0.f)
                    : 0.f;
      own += dc[t];
    }
    float suf = own;               // sum over lanes >= this one
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(ALL, suf, off);
      if (tid + off < 32) suf += o;
    }
    float rc = __shfl_down_sync(ALL, suf, 1);
    if (tid == 31) rc = 0.f;
    const float av = a.a[r.h];
    float da = 0.f;
    float* ddt = a.ddt + rowbase * a.heads + r.h;
    for (int t = 3; t >= 0; --t) {
      const int l = 4 * tid + t;
      rc += dc[t];
      if (l < lv)
        ddt[(ll)l * a.heads] =
            ddtd[l] + expf(total - cum[l]) * du[l] + av * rc;
      da += dts[l] * rc;
    }
    for (int off = 16; off > 0; off >>= 1)
      da += __shfl_xor_sync(ALL, da, off);
    if (tid == 0) {
      a.part[hk * 2] = da;
      a.part[hk * 2 + 1] = d8;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dB, dC over the heads of a group; da, dd over (batch, chunk)
// ---------------------------------------------------------------------------

// one thread per (row, group, n) of dB and dC, heads summed in order; the
// last block sums da and dd of each head over (batch, chunk) in order
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_reduce(const float* __restrict__ dbh, const float* __restrict__ dch,
                   T* __restrict__ db, T* __restrict__ dc,
                   const float* __restrict__ part, float* __restrict__ da,
                   float* __restrict__ dd, ll rows, int heads, int groups,
                   int n, int chunks) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < heads; h += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int j = 0; j < chunks; ++j) {
        sa += part[((ll)j * heads + h) * 2];
        sd += part[((ll)j * heads + h) * 2 + 1];
      }
      da[h] = sa;
      dd[h] = sd;
    }
    return;
  }
  const ll e = (ll)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * groups * n) return;
  const int q = e % n;
  const ll rg = e / n;
  const int g = rg % groups;
  const ll row = rg / groups;
  const int hpg = heads / groups;
  const ll o = (row * heads + (ll)g * hpg) * n + q;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < hpg; ++h) {
    sb += dbh[o + (ll)h * n];
    sc += dch[o + (ll)h * n];
  }
  from_f(db + e, sb);
  from_f(dc + e, sc);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int DLOCAL_SMEM = (3 * MAXR + 2 * KT * MAXR) * 4;
constexpr int CHUNKS_SMEM =
    (2 * MAXR * LDM + 2 * STG + 16 * MAXR + 6 * MAXR) * 4;

template <typename T, int NJ, int PJ>
cudaError_t run(const Args& a, int batch, void* dinit, void* db, void* dc,
                void* da, void* dd, cudaStream_t st) {
  const unsigned blocks = (unsigned)((ll)batch * a.nc * a.heads);
  ssd_bwd_dlocal<T, PJ><<<blocks, NT, DLOCAL_SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int np4 = a.n * a.p / 4;
  ssd_bwd_pass<<<dim3((np4 + 255) / 256, batch * a.heads), 256, 0, st>>>(
      a.gbuf, a.total, a.dstate, static_cast<float*>(dinit), a.nc, a.heads,
      np4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_bwd_chunks<T, NJ, PJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           CHUNKS_SMEM);
  if (e != cudaSuccess) return e;
  ssd_bwd_chunks<T, NJ, PJ><<<blocks, NT, CHUNKS_SMEM, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const ll rows = (ll)batch * a.seq;
  const ll out = rows * a.groups * a.n;
  ssd_bwd_reduce<T><<<(unsigned)((out + 255) / 256 + 1), 256, 0, st>>>(
      a.dbh, a.dch, static_cast<T*>(db), static_cast<T*>(dc), a.part,
      static_cast<float*>(da), static_cast<float*>(dd), rows, a.heads,
      a.groups, a.n, batch * a.nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_t(const Args& a, int batch, void* dinit, void* db, void* dc,
                  void* da, void* dd, cudaStream_t st) {
  if (a.n <= 64)
    return a.p <= 64 ? run<T, 4, 4>(a, batch, dinit, db, dc, da, dd, st)
                     : run<T, 4, 8>(a, batch, dinit, db, dc, da, dd, st);
  return a.p <= 64 ? run<T, 8, 4>(a, batch, dinit, db, dc, da, dd, st)
                   : run<T, 8, 8>(a, batch, dinit, db, dc, da, dd, st);
}

}  // namespace

// dtype of x/B/C/dy/dx/dB/dC and s_in: 0 = float32, 1 = bfloat16.  dt, a,
// d, init, dstate, ddt, da, dd, dinit and the scratch are float32.  dy, dx,
// ddt, init, dstate and s_in are contiguous; x, dt, B and C take strides
// (their last dim contiguous).  Scratch: gbuf (B, nc, H, N, P), total (B,
// nc, H), dbh and dch (B, S, H, N), part (B, nc, H, 2).  init and dstate may
// be null (zeros); s_in is read for chunks 1.. only (chunk 0 enters from
// init).  Four kernels on the stream (dlocal, the reverse pass, the chunks,
// the reduction).  Requires chunk <= 128, n <= 128, p <= 128, p % 4 == 0 and
// heads % groups == 0 (the wrapper checks).  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int repro_ssd_bwd(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* init, const void* s_in,
    const void* dy, const void* dstate, void* dx, void* ddt, void* da,
    void* db, void* dc, void* dd, void* dinit, void* gbuf, void* total,
    void* dbh, void* dch, void* part, int batch, int seq, int heads,
    int groups, int n, int p, int chunk, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || n < 1 || n > MAXR || p < 4 ||
      p > MAXR || p % 4 || groups < 1 || heads % groups || batch < 1 ||
      seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.d = static_cast<const float*>(d);
  args.init = static_cast<const float*>(init);
  args.s_in = s_in;
  args.dy = dy;
  args.dstate = static_cast<const float*>(dstate);
  args.dx = dx;
  args.ddt = static_cast<float*>(ddt);
  args.gbuf = static_cast<float*>(gbuf);
  args.total = static_cast<float*>(total);
  args.dbh = static_cast<float*>(dbh);
  args.dch = static_cast<float*>(dch);
  args.part = static_cast<float*>(part);
  args.seq = seq;
  args.heads = heads;
  args.groups = groups;
  args.n = n;
  args.p = p;
  args.chunk = chunk;
  args.nc = (seq + chunk - 1) / chunk;
  args.hpg = heads / groups;
  args.x_sb = x_sb;
  args.x_ss = x_ss;
  args.x_sh = x_sh;
  args.dt_sb = dt_sb;
  args.dt_ss = dt_ss;
  args.dt_sh = dt_sh;
  args.b_sb = b_sb;
  args.b_ss = b_ss;
  args.b_sg = b_sg;
  args.c_sb = c_sb;
  args.c_ss = c_ss;
  args.c_sg = c_sg;
  if (args.nc > 1 && s_in == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = run_t<float>(args, batch, dinit, db, dc, da, dd, st);
  else if (dtype == 1)
    err = run_t<bf16>(args, batch, dinit, db, dc, da, dd, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
