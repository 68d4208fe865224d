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
// mamba_ssm/ops/triton/ssd_combined.py, splits it the same way);
// ref.ssd_bwd_bf16_emulated repeats the bf16 path's roundings.
//
// Four kernels on the stream in both dtypes, none with a float atomic:
// every sum is taken by one thread or in a fixed order, so two calls on the
// same inputs give the same bits.
//   1. dlocal: dlocal_k of each (b, chunk, head) into fp32 scratch `gbuf`,
//      and the chunk's total.
//   2. the pass: one thread per 4 elements of a (b, h) state walks the
//      chunks backwards from dstate writing g_k, and d init_state -- the
//      forward pass's update run in reverse.
//   3. the chunks: dx, ddt, each head's (or head tile's) dB and dC (fp32
//      scratch) and the partial sums of da and dd.  It reads the state that
//      entered the chunk: init_state for chunk 0, else the forward's s_in
//      (kept in x's type: in bf16 a rounding of ~2^-9 on the terms that use
//      it).
//   4. the reduction: dB and dC summed over a group's heads (or head tiles)
//      in order, and da, dd over (batch, chunk) in order, in a last block.
//
// bf16 inputs (the training path) run on the tensor cores (wgmma m64nNk16,
// fp32 sums; hopper.cuh's 128-byte-swizzled tiles and descriptors):
//  * Products of two bf16 operands go to wgmma as they are (C B^T, dy x^T,
//    C s_in, B g_k's parts): exact products, only the sum order changes.
//    Every fp32 operand is split into a bf16 high part and the bf16
//    rounding of what it leaves, two products into one accumulator (~2^-17
//    relative, as the forward's u X): W and dS (formed in registers and fed
//    as register A operands), g_k (the pass writes its parts, `ghl`),
//    exp(cum) dy (dlocal, dC), u x (dB) and chunk 0's init_state.
//  * The L x L matrices never leave registers.  A block's two warpgroups
//    each own 64 rows of the chunk in both orientations: as rows m of S^T,
//    dW^T, W^T and dS^T (for dx = W^T dy and dB = dS^T C, contracting over
//    l) and as rows l of S, dW and dS (for dC = dS B).  Each k16 step of 16
//    columns recomputes that step's S and dW (64 x 16 accumulators, which
//    are the A fragments of the next product) from the tiles, masks them,
//    and feeds the next product: the causal triangle's steps only, no
//    transpose, no L x L buffer.  The warpgroup with more steps in one
//    orientation has fewer in the other.  C B^T is recomputed for each
//    head rather than kept: it keeps its fp32 sums and holds no registers
//    between heads (kept, it would take 32 registers a thread, or 32 KB of
//    shared memory that the block does not have).
//  * Head tiles: a block takes `ht` heads of one group (ops.ssd_bwd_plan
//    fills whole waves of the SMs).  B and C load once a block; dB and dC
//    are summed over its heads in head order in the accumulators and leave
//    once, so the scratch is (B, S, G ceil(H / G / ht), N), not (B, S, H,
//    N).  The row sums (dcum, dL/ddt through W, dL/du) are quad shuffles.
//  * Tiles a stage ahead: with a chunk of 64 or 128 rows B, C, x, dy, s_in
//    and g_k's parts arrive as TMA boxes completing on mbarriers; x and dy
//    come in two buffers, the next head's loading while this one computes.
//    With P in one 64-column half, every product that reads g_k or s_in
//    comes first in a head, and the next head's g_k and s_in load during
//    this head's loops (else during its tail).  Other chunks and views TMA
//    refuses take ssd.cu's cp.async fill, or its element fill where a base
//    or stride is off 16 bytes.
//  * dlocal is C^T (exp(cum) dy) with C's tile read as an MN-major
//    (transposed) A operand, a warpgroup per 64 rows of N (the forward's
//    local state); the pass writes g_k as bf16 high and low parts.
//  * Shaped for ptxas: the warpgroup and warp indices are broadcast from
//    lane 0 (provably warp-uniform), TMA copies are issued under a PTX
//    predicate rather than a branch, and the products' k16 chains over N
//    and P have compile-time lengths.  Without these ptxas serialized
//    every wgmma of the chunks kernel (C7520) or fenced them hundreds of
//    times (C7519): 2.32 and 1.75 ms at the training shape against 1.00.
// fp32 inputs keep the first design's kernels, full fp32 on the CUDA cores
// (no TF32): a block per (b, chunk, head), L x L matrices in two fp32
// shared buffers, operands staged 32 deep through shared memory.
//
// What bounds it: at mamba2-2.7b's widths (H 80, P 64, N 128, G 1, L 128)
// the function needs ~19 GFLOP at S 2048 a batch row (~0.02 ms at the bf16
// tensor-core peak, ~0.28 ms at the CUDA cores' fp32 peak); its bytes are
// ~0.07 GB (~0.02 ms at 3.35 TB/s).  The bf16 design moves ~0.19 GB of
// scratch a batch row (dlocal and g_k's parts written and read, the head
// tiles' dB and dC) and does its L x L elementwise work twice, once an
// orientation.  At the training microbatch (B 4, S 2048) on an H100 SXM
// (700 W) it takes ~1.35 ms: dlocal 0.21, the pass 0.12 (near the memory
// rate), the chunks 1.00 (one block an SM at 255 registers; patched copies
// put ~0.6 ms in the products' waits, ~0.26 in tile waits, ~0.15 in the
// elementwise work), the reduction 0.01.  PERF.md has the times
// (python -m repro_torch.kernels.ssd.probe_bwd splits them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
using hopper::desc_k;
using hopper::desc_mn;
using hopper::ex2;
using hopper::l2_drop;
using hopper::load4_drop;
using hopper::swz;
using hopper::tma_load_4d;
using hopper::unpack_bf16;

// ===========================================================================
// fp32 inputs: the products on the CUDA cores
// ===========================================================================

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
  float* dbh;           // (B, S, tiles, N): each head tile's dB
  float* dch;           // (B, S, tiles, N): each head tile's dC
  float* part;          // (B, nc, H, 2): partial da and dd
  bf16* ghl;            // bf16: (B, nc, H, 2, N, P) g_k's high, low parts
  int seq, heads, groups, n, p, chunk, nc, hpg;
  int ht, tpg, n_tiles;  // heads a block (bf16), head tiles a group, tiles
  int lp;               // the chunk rounded up to 64 (rows of a bf16 tile)
  int tma, aligned;     // bf16 tiles by TMA; x, B, C on 16 bytes
  ll x_sb, x_ss, x_sh;
  ll dt_sb, dt_ss, dt_sh;
  ll b_sb, b_ss, b_sg;
  ll c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// four consecutive floats, 16 bytes aligned
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// ===========================================================================
// bf16 inputs: the products on the tensor cores
// ===========================================================================

constexpr int WG = 128;            // threads of a warpgroup
constexpr int TILE = 64;           // rows of a warpgroup's row tile
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned ALL = 0xffffffffu;

// bf16 views as TMA tensor maps (make_maps), boxes of 64 columns x a
// tile's rows: x and dy as (P, S, H, B), B and C as (N, S, G, B), s_in as
// (P, N, B nc H) and g_k's pairs as (P, N, B nc H 2); rows past S or N and
// columns past N or P read as zero
struct Maps {
  CUtensorMap x, dy, b, c, s, g;
};


// One thread's TMA issue with no branch around it: the barrier's expected
// bytes and the box copies are predicated in PTX on `one`, so the chunks
// kernel, whose dB and dC accumulators live across its heads, has no
// divergent path for ptxas to serialize its wgmmas on (C7520)
__device__ __forceinline__ void expect_tx_if(bool one, uint32_t bar,
                                             uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes), "r"((int)one)
      : "memory");
}
__device__ __forceinline__ void tma4_if(bool one, uint32_t dst,
                                        const void* map, uint32_t bar, int c0,
                                        int c1, int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"((int)one)
      : "memory");
}
__device__ __forceinline__ void tma3_if(bool one, uint32_t dst,
                                        const void* map, uint32_t bar, int c0,
                                        int c1, int c2) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"((int)one)
      : "memory");
}


// the products, one k16 step each: acc (64 x N) += A B with A and B from
// shared memory (ss) or A from registers (rs); the probe
// (kernels/ssd/probe_bwd.py) switches them off to split the kernels' time
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  hopper::Wgmma<N>::template ss<TA, TB>(acc, da, db, scale_d);
}
template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2],
                                       const uint32_t (&fa)[4], uint64_t db) {
  hopper::Wgmma<N>::template rs<TB>(acc, fa, db, 1);
}
// the products issued since the last wait are done and their accumulators
// are the compiler's again
__device__ __forceinline__ void mma_done() {
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
}

// (v0, v1) as a bf16 high pair and the bf16 rounding of what it leaves
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = hopper::pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = hopper::pack_bf16(v0 - h.x, v1 - h.y);
}
// columns c, c + 1 (c even) of row r of a swizzled bf16 tile at byte `off`
__device__ __forceinline__ float2 pair_at(const char* sm, int off, int rows,
                                          int r, int c) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(
      sm + off + swz(rows, r, c >> 3) + (c & 7) * 2));
}

// `v` (the same on every lane of the warp) as lane 0's: a value the
// compiler knows is warp-uniform, so branches and loop bounds on the
// warpgroup or warp index are not divergent paths around the wgmmas
// (which ptxas would serialize, C7520) -- CUTLASS's warp-group index
__device__ __forceinline__ int uniform(int v) {
  return __shfl_sync(ALL, v, 0);
}

// sum over the four lanes that hold an accumulator row, and over a warp:
// butterflies, the same bits on every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(ALL, v, 1);
  return v + __shfl_xor_sync(ALL, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(ALL, v, off);
  return v;
}

// rows [0, rows) x columns [0, cols) of a tile at byte `dst` from a
// row-major source (row stride `ss` elements): source rows >= vr and
// columns >= vc read as zero.  By 16-byte cp.async (committed by the
// caller) when `async`, else element by element (a base or stride off 16
// bytes) -- ssd.cu's fill.  A tile's 16-byte chunks (64 or 128 rows of 64
// or 128 columns) are a whole number of rounds of the block's 256 threads:
// every thread takes the same number, no divergent loop.
__device__ void fill(uint32_t su, char* sm, int dst, const bf16* src, ll ss,
                     int rows, int cols, int vr, int vc, bool async) {
  const int cpr = cols / 8;
  for (int i0 = 0; i0 < rows * cpr; i0 += 2 * WG) {
    const int i = i0 + threadIdx.x;
    const int r = i / cpr, c8 = i - r * cpr;
    const int nv = r < vr ? min(8, vc - 8 * c8) : 0;
    const uint32_t o = dst + swz(rows, r, c8);
    const bf16* s = src + (ll)r * ss + 8 * c8;
    if (async) {
      hopper::cp_async16(su + o, nv > 0 ? s : src, nv > 0 ? 2 * nv : 0);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = e < nv ? s[e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(sm + o) = *reinterpret_cast<const uint4*>(v);
    }
  }
}
// the fp32 (n, p) state init_state (contiguous) as a bf16 tile: its high
// part (part 0) or the rounding of what that leaves (part 1)
__device__ void fill_init(char* sm, int dst, const float* src, int rows,
                          int cols, int n, int p, int part) {
  const int cpr = cols / 8;
  for (int i0 = 0; i0 < rows * cpr; i0 += 2 * WG) {   // whole rounds
    const int i = i0 + threadIdx.x;
    const int r = i / cpr, c8 = i - r * cpr;
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = 8 * c8 + 2 * m;    // p % 4 == 0: c < p covers c + 1
      const bool in = r < n && c < p;
      uint32_t hi, lo;
      split2(in ? src[r * p + c] : 0.f, in ? src[r * p + c + 1] : 0.f, hi,
             lo);
      w[m] = part == 0 ? hi : lo;
    }
    *reinterpret_cast<uint4*>(sm + dst + swz(rows, r, c8)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dt of head h on the chunk's rows (0 past them) and cum, the inclusive
// cumsum of a_h dt over MAXR rows (held past the chunk), by one warp;
// exp(cum) too when `ec` is given
__device__ __forceinline__ void head_rows(const Args& a, int bi, int s0,
                                          int lv, int h, float* dts,
                                          float* cum, float* ec) {
  const int lane = threadIdx.x & 31;
  const float ah = a.a[h];
  float carry = 0.f;
  for (int base = 0; base < MAXR; base += 32) {
    const int l = base + lane;
    const float d = l < lv ? a.dt[bi * a.dt_sb + (ll)(s0 + l) * a.dt_ss +
                                  (ll)h * a.dt_sh]
                           : 0.f;
    float v = ah * d;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(ALL, v, off);
      if (lane >= off) v += o;
    }
    v += carry;
    dts[l] = d;
    cum[l] = v;
    if (ec != nullptr) ec[l] = expf(v);
    carry = __shfl_sync(ALL, v, 31);
  }
}

// the block's (batch row, chunk, head tile) and the tile's heads
struct Block {
  int bi, k, tile, g, h0, nh, s0, lv;
};

__device__ __forceinline__ Block block_of(const Args& a) {
  Block r;
  int idx = blockIdx.x;
  r.tile = idx % a.n_tiles;     // head tiles fastest: the blocks of one
  idx /= a.n_tiles;             // chunk read the same B and C
  r.k = idx % a.nc;
  r.bi = idx / a.nc;
  r.g = r.tile / a.tpg;
  const int first = (r.tile % a.tpg) * a.ht;
  r.h0 = r.g * a.hpg + first;
  r.nh = min(a.ht, a.hpg - first);
  r.s0 = r.k * a.chunk;
  r.lv = min(a.chunk, a.seq - r.s0);
  return r;
}

// ---------------------------------------------------------------------------
// 1. dlocal_k = C^T (exp(cum) dy) on the tensor cores
// ---------------------------------------------------------------------------

// byte offsets from the 1024-aligned base: the C tile (lp x nb), dy in two
// buffers and the low part of exp(cum) dy (lp x pb each), dt, cum and
// exp(cum), three mbarriers
struct DLayout {
  int c, dy[2], lo, f, bar, bytes;
};

__host__ __device__ inline DLayout dlocal_layout(int lp, int nb, int pb) {
  DLayout s;
  const int xt = lp * pb * 2;
  s.c = 0;
  s.dy[0] = lp * nb * 2;
  s.dy[1] = s.dy[0] + xt;
  s.lo = s.dy[1] + xt;
  s.f = s.lo + xt;
  s.bar = s.f + 3 * MAXR * 4;
  s.bytes = s.bar + 3 * 8 + 1024;   // room to align the base to 1024
  return s;
}

// a block per (b, chunk, head tile): C once, each head's dy (the next
// head's loading meanwhile) scaled by exp(cum) and split in place into a
// bf16 high part and a low part; warpgroup w takes rows 64 w .. of the
// N x P output, C^T read as an MN-major (transposed) A operand
template <int PB>
__global__ void __launch_bounds__(2 * WG, PB == 64 ? 2 : 1)
    ssd_bwd_dlocal_wg(const Args a, const __grid_constant__ Maps tm) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t su0 = hopper::smem_u32(smem_raw);
  const uint32_t su = hopper::align1024(su0);
  char* sm = reinterpret_cast<char*>(smem_raw) + (su - su0);
  const int lp = a.lp, N = a.n, P = a.p;
  const int nb = N > TILE ? 2 * TILE : TILE;
  const DLayout lay = dlocal_layout(lp, nb, PB);
  float* dts = reinterpret_cast<float*>(sm + lay.f);
  float* cum = dts + MAXR;
  float* ec = cum + MAXR;
  const uint32_t bars = su + lay.bar;     // 0 C, 1 + buf dy
  const Block bk = block_of(a);
  const int tid = threadIdx.x, wg = uniform(tid / WG);
  const int warp = uniform((tid % WG) / 32), lane = tid % 32, gq = lane / 4,
            qd = lane % 4;
  const int nks = (bk.lv + 15) / 16;
  const bool tma = a.tma;
  const ll hp = (ll)a.heads * P;
  const bf16* dyg =
      static_cast<const bf16*>(a.dy) + ((ll)bk.bi * a.seq + bk.s0) * hp;
  const ll slot0 = ((ll)bk.bi * a.nc + bk.k) * a.heads;
  if (tma && tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  auto load_dy = [&](int t, int buf) {
    const int h = bk.h0 + t;
    if (tma) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * (1 + buf);
        hopper::mbar_expect_tx(bar, (PB / 64) * lp * 128);
        for (int at = 0; at < PB / 64; ++at)
          tma_load_4d(su + lay.dy[buf] + at * lp * 128, &tm.dy, bar, 64 * at,
                      bk.s0, h, bk.bi);
      }
    } else {
      fill(su, sm, lay.dy[buf], dyg + (ll)h * P, hp, lp, PB, bk.lv, P,
           P % 8 == 0);
    }
  };
  if (tma) {
    if (tid == 0) {
      hopper::mbar_expect_tx(bars, (nb / 64) * lp * 128);
      for (int at = 0; at < nb / 64; ++at)
        tma_load_4d(su + lay.c + at * lp * 128, &tm.c, bars, 64 * at, bk.s0,
                    bk.g, bk.bi);
    }
  } else {
    fill(su, sm, lay.c,
         static_cast<const bf16*>(a.c) + bk.bi * a.c_sb +
             (ll)bk.s0 * a.c_ss + bk.g * a.c_sg,
         a.c_ss, lp, nb, bk.lv, N, a.aligned);
  }
  load_dy(0, 0);
  hopper::cp_async_commit();

  for (int t = 0; t < bk.nh; ++t) {
    const int h = bk.h0 + t, buf = t & 1;
    // every thread is done with the buffer the next head loads into
    hopper::fence_proxy_async();
    __syncthreads();
    if (t + 1 < bk.nh) load_dy(t + 1, buf ^ 1);
    hopper::cp_async_commit();
    if (tid < 32) {
      head_rows(a, bk.bi, bk.s0, bk.lv, h, dts, cum, ec);
      __syncwarp();
      if (tid == 0) a.total[slot0 + h] = cum[a.chunk - 1];
    }
    if (tma) {
      if (t == 0) hopper::mbar_wait(bars, 0);
      hopper::mbar_wait(bars + 8 * (1 + buf), (t >> 1) & 1);
    }
    hopper::cp_async_wait<1>();     // this head's copies; the next's fly
    hopper::fence_proxy_async();
    __syncthreads();
    // exp(cum) dy: the high part over dy, the low part into `lo`
    for (int i = tid; i < lp * (PB / 8); i += 2 * WG) {
      const int r = i / (PB / 8), c8 = i - r * (PB / 8);
      const uint32_t o = swz(lp, r, c8);
      const uint4 v = *reinterpret_cast<const uint4*>(sm + lay.dy[buf] + o);
      const float e = ec[r];
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = unpack_bf16(in[m]);
        split2(f.x * e, f.y * e, hi[m], lo[m]);
      }
      *reinterpret_cast<uint4*>(sm + lay.dy[buf] + o) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sm + lay.lo + o) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    hopper::fence_proxy_async();
    __syncthreads();
    if (wg * TILE < N) {
      float acc[PB / 2];
      const uint32_t ct = su + lay.c + wg * lp * 128;   // n tile wg of C
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      for (int ks = 0; ks < nks; ++ks)
        mma_ss<PB, 1, 1>(acc, desc_mn(ct, lp, ks),
                         desc_mn(su + lay.dy[buf], lp, ks), ks > 0);
      for (int ks = 0; ks < nks; ++ks)
        mma_ss<PB, 1, 1>(acc, desc_mn(ct, lp, ks),
                         desc_mn(su + lay.lo, lp, ks), 1);
      mma_done();
      hopper::fence_regs(acc);
      float* out = a.gbuf + (slot0 + h) * N * P;
#pragma unroll
      for (int j = 0; j < PB / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = wg * TILE + warp * 16 + gq + 8 * i;
          const int p = 8 * j + 2 * qd;
          if (n < N && p < P)
            *reinterpret_cast<float2*>(out + (ll)n * P + p) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse pass, g_k written as bf16 high and low parts
// ---------------------------------------------------------------------------


// one thread per 4 elements of one (b, h) state: for k from the last chunk
// down, g_k to ghl (b, k, h, 0) as bf16 high parts and to (b, k, h, 1) as
// the rounding of the rest, then g = exp(total_k) g + dlocal_k
__global__ void __launch_bounds__(256)
    ssd_bwd_pass_hl(const float* __restrict__ dl, const float* __restrict__ total,
                    const float* __restrict__ dstate, float* __restrict__ dinit,
                    bf16* __restrict__ ghl, int nc, int heads, int np4) {
  const int bh = blockIdx.y;
  const int bi = bh / heads, h = bh - bi * heads;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= np4) return;
  const ll sz = (ll)np4 * 4;
  float4 g = dstate != nullptr
                 ? reinterpret_cast<const float4*>(dstate + bh * sz)[e]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const uint64_t drop = l2_drop();
  for (int k = nc - 1; k >= 0; --k) {
    const ll hk = ((ll)bi * nc + k) * heads + h;
    const float4 l = load4_drop(dl + hk * sz + 4 * (ll)e, drop);
    uint2 hi, lo;
    split2(g.x, g.y, hi.x, lo.x);
    split2(g.z, g.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(ghl + 2 * hk * sz + 4 * (ll)e) = hi;
    *reinterpret_cast<uint2*>(ghl + (2 * hk + 1) * sz + 4 * (ll)e) = lo;
    const float et = expf(total[hk]);
    g.x = et * g.x + l.x;
    g.y = et * g.y + l.y;
    g.z = et * g.z + l.z;
    g.w = et * g.w + l.w;
  }
  reinterpret_cast<float4*>(dinit + bh * sz)[e] = g;
}

// ---------------------------------------------------------------------------
// 3. every chunk's gradients on the tensor cores
// ---------------------------------------------------------------------------

// byte offsets from the 1024-aligned base: C and B (lp x nb), g_k's high
// and low parts and the entering state (nb x pb each; the state over g_k's
// low part when the block would not fit otherwise), x and dy (lp x pb, two
// buffers when they fit), the row arrays (dt, cum, dcum, dL/ddt through W,
// dL/du) and the reduction, five mbarriers
constexpr int F_BYTES = 5 * MAXR * 4 + 16 * 4;
constexpr int N_BARS = 5;

struct Layout {
  int c, b, ghi, glo, s, x[2], dy[2], f, bar, bytes, nbuf, s_alias;
};

__host__ __device__ inline Layout chunks_layout(int lp, int nb, int pb) {
  const int ct = lp * nb * 2, xt = lp * pb * 2, st = nb * pb * 2;
  const int fixed = F_BYTES + N_BARS * 8 + 1024;
  Layout s;
  s.c = 0;
  s.b = ct;
  int off = 2 * ct;
  s.ghi = off;
  s.glo = off + st;
  off += 2 * st;
  s.s_alias = off + st + 2 * xt + fixed > SMEM_LIMIT;
  s.s = s.s_alias ? s.glo : off;
  if (!s.s_alias) off += st;
  s.nbuf = off + 4 * xt + fixed <= SMEM_LIMIT ? 2 : 1;
  for (int i = 0; i < 2; ++i) {
    if (i < s.nbuf) {
      s.x[i] = off;
      s.dy[i] = off + xt;
      off += 2 * xt;
    } else {
      s.x[i] = s.x[0];
      s.dy[i] = s.dy[0];
    }
  }
  s.f = off;
  s.bar = off + F_BYTES;
  s.bytes = s.bar + N_BARS * 8 + 1024;   // room to align the base to 1024
  return s;
}

// A block per (b, chunk, head tile) of `ht` heads of one group, two
// warpgroups; warpgroup w owns rows 64 w .. 64 w + 63 of the chunk in both
// orientations of the L x L matrices: as rows m of W^T and dS^T (dx, dB)
// and as rows l of dS (dC, dcum).  C B^T is recomputed for each head on
// the tensor cores (k16 steps of 16 columns: C B^T's and dy x^T's 64 x 16
// accumulator is the A fragment of the next product), so it keeps its fp32
// sums and holds no registers between heads.  dB and dC are summed over
// the block's heads in head order in registers and leave once.
template <int NB, int PB>
__global__ void __launch_bounds__(2 * WG, 1)
    ssd_bwd_chunks_wg(const Args a, const __grid_constant__ Maps tm) {
  constexpr int NH = PB / 64;           // 64-column halves of P
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t su0 = hopper::smem_u32(smem_raw);
  const uint32_t su = hopper::align1024(su0);
  char* sm = reinterpret_cast<char*>(smem_raw) + (su - su0);
  const int lp = a.lp, L = a.chunk, N = a.n, P = a.p;
  const Layout lay = chunks_layout(lp, NB, PB);
  float* dts = reinterpret_cast<float*>(sm + lay.f);
  float* cum = dts + MAXR;
  float* dcum = cum + MAXR;      // dL/dcum
  float* ddtd = dcum + MAXR;     // dL/ddt through W
  float* dus = ddtd + MAXR;      // dL/du
  float* red = dus + MAXR;       // a warp's <g_k, s_in> and sum dy x
  // mbarriers: 0 C and B, 1 + buf x and dy, 3 g_k, 4 the entering state
  const uint32_t bars = su + lay.bar;
  const Block bk = block_of(a);
  const int k = bk.k, lv = bk.lv;
  const int tid = threadIdx.x, wg = uniform(tid / WG);
  const int warp = uniform((tid % WG) / 32), lane = tid % 32, gq = lane / 4,
            qd = lane % 4;
  const int wid = uniform(tid / 32);            // the block's warp
  const int r0 = wg * TILE + warp * 16 + gq;   // this thread's rows r0, r0 + 8
  const int w0 = wg * TILE + warp * 16;        // this warp's first row
  const bool act = wg * TILE < lv;
  const int nks = (lv + 15) / 16;              // k16 steps of the chunk's rows
  // the products' k16 steps over N and P: whole tiles (columns past N or
  // P are zero), compile-time chains that ptxas schedules as one
  constexpr int KN = NB / 16, KP = PB / 16;
  const bool tma = a.tma, p8 = P % 8 == 0;
  // the entering state: s_in (chunks 1..), or init_state's high and low
  // parts (chunk 0), or none; s_pre: it loads with g_k, a head ahead
  const int nparts = k > 0 ? 1 : (a.init != nullptr ? 2 : 0);
  const bool s_pre = k > 0 && !lay.s_alias;
  const ll hp = (ll)a.heads * P;
  const ll rowbase = (ll)bk.bi * a.seq + bk.s0;
  const bf16* xg = static_cast<const bf16*>(a.x) + bk.bi * a.x_sb +
                   (ll)bk.s0 * a.x_ss;
  const bf16* dyg = static_cast<const bf16*>(a.dy) + rowbase * hp;
  bf16* dxg = static_cast<bf16*>(a.dx) + rowbase * hp;
  const ll slot0 = ((ll)bk.bi * a.nc + k) * a.heads;   // + h
  const ll np_ = (ll)N * P;
  const uint32_t cb_c = su + lay.c, cb_b = su + lay.b;
  const uint32_t g_hi = su + lay.ghi, g_lo = su + lay.glo, s_t = su + lay.s;

  if (tma && tid == 0) {
    for (int i = 0; i < N_BARS; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const bool one = tid == 0;       // the thread that issues TMA copies
  auto load_cb = [&]() {
    if (tma) {
      expect_tx_if(one, bars, 2 * (NB / 64) * lp * 128);
      for (int at = 0; at < NB / 64; ++at) {
        tma4_if(one, cb_c + at * lp * 128, &tm.c, bars, 64 * at, bk.s0, bk.g,
                bk.bi);
        tma4_if(one, cb_b + at * lp * 128, &tm.b, bars, 64 * at, bk.s0, bk.g,
                bk.bi);
      }
    } else {
      const ll o = bk.bi * a.b_sb + (ll)bk.s0 * a.b_ss + bk.g * a.b_sg;
      const ll oc = bk.bi * a.c_sb + (ll)bk.s0 * a.c_ss + bk.g * a.c_sg;
      fill(su, sm, lay.c, static_cast<const bf16*>(a.c) + oc, a.c_ss, lp, NB,
           lv, N, a.aligned);
      fill(su, sm, lay.b, static_cast<const bf16*>(a.b) + o, a.b_ss, lp, NB,
           lv, N, a.aligned);
    }
  };
  auto load_xd = [&](int t, int buf) {
    const int h = bk.h0 + t;
    if (tma) {
      const uint32_t bar = bars + 8 * (1 + buf);
      expect_tx_if(one, bar, 2 * NH * lp * 128);
      for (int at = 0; at < NH; ++at) {
        tma4_if(one, su + lay.x[buf] + at * lp * 128, &tm.x, bar, 64 * at,
                bk.s0, h, bk.bi);
        tma4_if(one, su + lay.dy[buf] + at * lp * 128, &tm.dy, bar, 64 * at,
                bk.s0, h, bk.bi);
      }
    } else {
      fill(su, sm, lay.x[buf], xg + (ll)h * a.x_sh, a.x_ss, lp, PB, lv, P,
           a.aligned);
      fill(su, sm, lay.dy[buf], dyg + (ll)h * P, hp, lp, PB, lv, P, p8);
    }
  };
  auto load_g = [&](int t) {
    const ll sl = slot0 + bk.h0 + t;
    if (tma) {
      const uint32_t bar = bars + 24;
      expect_tx_if(one, bar, 2 * NH * NB * 128);
      for (int at = 0; at < NH; ++at) {
        tma3_if(one, g_hi + at * NB * 128, &tm.g, bar, 64 * at, 0,
                (int)(2 * sl));
        tma3_if(one, g_lo + at * NB * 128, &tm.g, bar, 64 * at, 0,
                (int)(2 * sl + 1));
      }
    } else {
      const bf16* src = a.ghl + 2 * sl * np_;
      fill(su, sm, lay.ghi, src, P, NB, PB, N, P, p8);
      fill(su, sm, lay.glo, src + np_, P, NB, PB, N, P, p8);
    }
  };
  auto load_s = [&](int t, int part) {
    const int h = bk.h0 + t;
    if (k == 0) {
      fill_init(sm, lay.s, a.init + ((ll)bk.bi * a.heads + h) * np_, NB, PB,
                N, P, part);
      return;
    }
    const ll sl = slot0 + h;
    if (tma) {
      const uint32_t bar = bars + 32;
      expect_tx_if(one, bar, NH * NB * 128);
      for (int at = 0; at < NH; ++at)
        tma3_if(one, s_t + at * NB * 128, &tm.s, bar, 64 * at, 0, (int)sl);
    } else {
      fill(su, sm, lay.s, static_cast<const bf16*>(a.s_in) + sl * np_, P, NB,
           PB, N, P, p8);
    }
  };

  load_cb();
  load_xd(0, 0);
  load_g(0);
  if (s_pre) load_s(0, 0);
  hopper::cp_async_commit();

  float db[NB / 2], dc[NB / 2];   // dB and dC, summed over the heads
#pragma unroll
  for (int r = 0; r < NB / 2; ++r) db[r] = dc[r] = 0.f;

  for (int t = 0; t < bk.nh; ++t) {
    const int h = bk.h0 + t, buf = t % lay.nbuf;
    const int ox = lay.x[buf], oy = lay.dy[buf];
    const uint32_t sx = su + ox, sdy = su + oy;
    // the previous head is done with every tile and row array
    hopper::fence_proxy_async();
    __syncthreads();
    if (lay.nbuf == 2 && t + 1 < bk.nh) load_xd(t + 1, buf ^ 1);
    hopper::cp_async_commit();
    if (wid == 0) head_rows(a, bk.bi, bk.s0, lv, h, dts, cum, nullptr);
    if (tma) {
      if (t == 0) hopper::mbar_wait(bars, 0);
      hopper::mbar_wait(bars + 8 * (1 + buf), (t / lay.nbuf) & 1);
      hopper::mbar_wait(bars + 24, t & 1);
      if (s_pre) hopper::mbar_wait(bars + 32, t & 1);
    }
    hopper::cp_async_wait<1>();     // this head's copies; the next's fly
    hopper::fence_proxy_async();
    __syncthreads();

    const float total = cum[L - 1];
    float cm[2], dtr[2], ur[2], ecr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      cm[i] = cum[r];
      dtr[i] = dts[r];
      ur[i] = expf(total - cm[i]) * dtr[i];   // u = exp(total - cum) dt
      ecr[i] = expf(cm[i]);
    }
    // this thread's parts of its rows' sums: dW S F (dL/ddt through W),
    // x . (B g_k) (dL/du), dL/dcum; and of <g_k, s> and sum dy x
    float rowt[2] = {0.f, 0.f}, rowu[2] = {0.f, 0.f}, rowd[2] = {0.f, 0.f};
    float gsp = 0.f, ddp = 0.f;

    // ---- dx = u (B g_k) (the 64 columns of half hf of P), dL/du = x . (B
    // g_k); g_k as high + low -------------------------------------------------
    float dx[32];
    auto bg_terms = [&](int hf) {
      hopper::fence_regs(dx);
      hopper::wgmma_fence();
#pragma unroll
      for (int kn = 0; kn < KN; ++kn)
        mma_ss<64, 0, 1>(dx, desc_k(cb_b + wg * 8192, lp, kn),
                         desc_mn(g_hi + hf * NB * 128, NB, kn), kn > 0);
#pragma unroll
      for (int kn = 0; kn < KN; ++kn)
        mma_ss<64, 0, 1>(dx, desc_k(cb_b + wg * 8192, lp, kn),
                         desc_mn(g_lo + hf * NB * 128, NB, kn), 1);
      mma_done();
      hopper::fence_regs(dx);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 xv =
              pair_at(sm, ox, lp, r0 + 8 * i, 64 * hf + 8 * j + 2 * qd);
          float& d0 = dx[4 * j + 2 * i];
          float& d1 = dx[4 * j + 2 * i + 1];
          rowu[i] += xv.x * d0 + xv.y * d1;
          d0 *= ur[i];
          d1 *= ur[i];
        }
    };

    // ---- the entering state: dcum_l += exp(cum_l) dy_l . (C s)_l and
    // dC += (exp(cum) dy) s^T; chunk 0 takes init_state's high and low
    // parts in turn --------------------------------------------------------
    auto state_terms = [&]() {
      for (int part = 0; part < nparts; ++part) {
        if (!s_pre) {
          __syncthreads();   // every thread is done with the tile it replaces
          load_s(t, part);
          hopper::cp_async_commit();
          if (tma && k > 0) hopper::mbar_wait(bars + 32, t & 1);
          hopper::cp_async_wait<0>();
          hopper::fence_proxy_async();
          __syncthreads();
        }
        if (part == 0) {
          // <g_k, s>: g_k as high + low, the state as kept (chunk 0: init_state
          // in fp32); g_k's low part from memory when the state is over it.
          // 16-byte chunks of the tiles, whole rounds of the block's threads.
          const float* init = k == 0 ? a.init + ((ll)bk.bi * a.heads + h) * np_
                                     : nullptr;
          const bf16* glo_g = a.ghl + (2 * (slot0 + h) + 1) * np_;
          constexpr int CPR = PB / 8;
          for (int i0 = 0; i0 < NB * CPR; i0 += 2 * WG) {
            const int i = i0 + tid, n = i / CPR, c8 = i - n * CPR;
            const uint32_t o = swz(NB, n, c8);
            const uint4 h4 = *reinterpret_cast<const uint4*>(sm + lay.ghi + o);
            const uint4 l4 = *reinterpret_cast<const uint4*>(sm + lay.glo + o);
            const uint4 s4 = *reinterpret_cast<const uint4*>(sm + lay.s + o);
            const uint32_t hw[4] = {h4.x, h4.y, h4.z, h4.w};
            const uint32_t lw[4] = {l4.x, l4.y, l4.z, l4.w};
            const uint32_t sw[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int c = 8 * c8 + 2 * m;
              const bool in = n < N && c < P;      // p % 4 == 0: c + 1 too
              const ll e = (ll)n * P + c;
              const float2 hv = unpack_bf16(hw[m]);
              float2 lv2 = unpack_bf16(lw[m]), sv2 = unpack_bf16(sw[m]);
              if (lay.s_alias)
                lv2 = in ? make_float2(__bfloat162float(glo_g[e]),
                                       __bfloat162float(glo_g[e + 1]))
                         : make_float2(0.f, 0.f);
              if (k == 0)
                sv2 = in ? make_float2(init[e], init[e + 1])
                         : make_float2(0.f, 0.f);
              gsp += (hv.x + lv2.x) * sv2.x + (hv.y + lv2.y) * sv2.y;
            }
          }
        }
        if (!act) continue;
#pragma unroll
        for (int hf = 0; hf < NH; ++hf) {
          if (64 * hf >= P) break;
          float cs[32];
          hopper::fence_regs(cs);
          hopper::wgmma_fence();
#pragma unroll
          for (int kn = 0; kn < KN; ++kn)
            mma_ss<64, 0, 1>(cs, desc_k(cb_c + wg * 8192, lp, kn),
                             desc_mn(s_t + hf * NB * 128, NB, kn), kn > 0);
          mma_done();
          hopper::fence_regs(cs);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float2 yv =
                  pair_at(sm, oy, lp, r0 + 8 * i, 64 * hf + 8 * j + 2 * qd);
              rowd[i] += ecr[i] * (yv.x * cs[4 * j + 2 * i] +
                                   yv.y * cs[4 * j + 2 * i + 1]);
            }
        }
#pragma unroll
        for (int kb = 0; kb < PB / 16; kb += 4) {
          if (16 * kb >= P) break;
          uint32_t fh[4][4], fl[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const float2 v = pair_at(sm, oy, lp, r0 + 8 * (m & 1),
                                       16 * (kb + kk) + 8 * (m >> 1) + 2 * qd);
              const float e = ecr[m & 1];
              split2(v.x * e, v.y * e, fh[kk][m], fl[kk][m]);
            }
          hopper::fence_regs(dc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int kp = kb + kk;
            if (16 * kp >= P) break;
            mma_rs<NB, 0>(dc, fh[kk], desc_k(s_t, NB, kp));
            mma_rs<NB, 0>(dc, fl[kk], desc_k(s_t, NB, kp));
          }
          mma_done();
          hopper::fence_regs(dc);
        }
      }
    };

    // P in one half: every product that reads g_k or the entering state
    // comes first, and the next head's g_k and state load during the loops
    if (NH == 1 && act) bg_terms(0);

    // ---- dB += (u x) g_k^T: u x and g_k each as high and low parts -------
    if (act) {
#pragma unroll
      for (int kb = 0; kb < PB / 16; kb += 4) {
        if (16 * kb >= P) break;
        uint32_t fh[4][4], fl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            // A fragment register m of k16 step kb + kk: row r0 + 8 (m % 2),
            // columns 16 (kb + kk) + 8 (m / 2) + 2 qd + {0, 1}
            const float2 v = pair_at(sm, ox, lp, r0 + 8 * (m & 1),
                                     16 * (kb + kk) + 8 * (m >> 1) + 2 * qd);
            const float u = ur[m & 1];
            split2(v.x * u, v.y * u, fh[kk][m], fl[kk][m]);
          }
        hopper::fence_regs(db);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int kp = kb + kk;
          if (16 * kp >= P) break;
          mma_rs<NB, 0>(db, fh[kk], desc_k(g_hi, NB, kp));
          mma_rs<NB, 0>(db, fh[kk], desc_k(g_lo, NB, kp));
          mma_rs<NB, 0>(db, fl[kk], desc_k(g_hi, NB, kp));
        }
        mma_done();
        hopper::fence_regs(db);
      }
    }

    if (NH == 1) {
      state_terms();
      hopper::fence_proxy_async();
      __syncthreads();                // every thread is done with g_k and s
      if (t + 1 < bk.nh) {
        load_g(t + 1);
        if (s_pre) load_s(t + 1, 0);
      }
      hopper::cp_async_commit();
    }

    // ---- dx += W^T dy, then + d dy, by 64-column halves of P; on the first
    // half dB += dS^T C and the rows of dW S F --------------------------------
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      if (64 * hf >= P) break;
      if (!act) continue;
      if (NH > 1) bg_terms(hf);
      // the l steps at or right of this row tile (l >= m)
      for (int ks = wg * 4; ks < nks; ++ks) {
        float sv[8], wv[8];   // S^T and dW^T: rows m, columns l of step ks
        hopper::fence_regs(sv);
        hopper::fence_regs(wv);
        hopper::wgmma_fence();
#pragma unroll
        for (int kn = 0; kn < KN; ++kn)
          mma_ss<16, 0, 0>(sv, desc_k(cb_b + wg * 8192, lp, kn),
                           desc_k(cb_c + ks * 2048, lp, kn), kn > 0);
#pragma unroll
        for (int kp = 0; kp < KP; ++kp)
          mma_ss<16, 0, 0>(wv, desc_k(sx + wg * 8192, lp, kp),
                           desc_k(sdy + ks * 2048, lp, kp), kp > 0);
        mma_done();       // and the previous step's dx and dB products
        hopper::fence_regs(sv);
        hopper::fence_regs(wv);
        uint32_t wh[4], wl[4], sh[4], sl[4];
        if (16 * ks + 15 >= w0) {          // some l >= m in this warp's rows
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int l0 = 16 * ks + 8 * j + 2 * qd;
            const float2 cl = *reinterpret_cast<const float2*>(cum + l0);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int m = r0 + 8 * i;
              float w2[2], s2[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int l = l0 + e, r = 4 * j + 2 * i + e;
                // F_lm = exp(cum_l - cum_m) [l >= m]
                const float f =
                    (l >= m && l < L) ? ex2(((e ? cl.y : cl.x) - cm[i]) * LOG2E)
                                      : 0.f;
                const float sf = sv[r] * f;
                w2[e] = sf * dtr[i];            // W^T = S^T F^T dt_m
                s2[e] = wv[r] * f * dtr[i];     // dS^T
                if (hf == 0) rowt[i] += wv[r] * sf;
              }
              split2(w2[0], w2[1], wh[2 * j + i], wl[2 * j + i]);
              split2(s2[0], s2[1], sh[2 * j + i], sl[2 * j + i]);
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) wh[m] = wl[m] = sh[m] = sl[m] = 0u;
        }
        hopper::fence_regs(dx);
        hopper::fence_regs(db);
        hopper::wgmma_fence();
        const uint64_t ddy = desc_mn(sdy + hf * lp * 128, lp, ks);
        mma_rs<64, 1>(dx, wh, ddy);
        mma_rs<64, 1>(dx, wl, ddy);
        if (hf == 0) {
          const uint64_t dcc = desc_mn(cb_c, lp, ks);
          mma_rs<NB, 1>(db, sh, dcc);
          mma_rs<NB, 1>(db, sl, dcc);
        }
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dx);
      hopper::fence_regs(db);
      // + d dy, and the block's sum dy x; dx leaves in bf16
      const float dv = a.d[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = r0 + 8 * i, p = 64 * hf + 8 * j + 2 * qd;
          const float2 yv = pair_at(sm, oy, lp, m, p);
          const float2 xv = pair_at(sm, ox, lp, m, p);
          ddp += yv.x * xv.x + yv.y * xv.y;
          if (m < lv && p < P)
            *reinterpret_cast<uint32_t*>(dxg + m * hp + (ll)h * P + p) =
                hopper::pack_bf16(dx[4 * j + 2 * i] + dv * yv.x,
                                  dx[4 * j + 2 * i + 1] + dv * yv.y);
        }
    }

    if (NH > 1) state_terms();

    // ---- dC += dS B over the m steps at or left of this row tile (m <= l),
    // and dcum_l += the rows of dW S F dt_m --------------------------------
    if (act) {
      const int mend = min(wg * 4 + 4, nks);
      for (int ks = 0; ks < mend; ++ks) {
        float sv[8], wv[8];   // S and dW: rows l, columns m of step ks
        hopper::fence_regs(sv);
        hopper::fence_regs(wv);
        hopper::wgmma_fence();
#pragma unroll
        for (int kn = 0; kn < KN; ++kn)
          mma_ss<16, 0, 0>(sv, desc_k(cb_c + wg * 8192, lp, kn),
                           desc_k(cb_b + ks * 2048, lp, kn), kn > 0);
#pragma unroll
        for (int kp = 0; kp < KP; ++kp)
          mma_ss<16, 0, 0>(wv, desc_k(sdy + wg * 8192, lp, kp),
                           desc_k(sx + ks * 2048, lp, kp), kp > 0);
        mma_done();       // and the previous step's dC product
        hopper::fence_regs(sv);
        hopper::fence_regs(wv);
        uint32_t sh[4], sl[4];
        if (16 * ks <= w0 + 15) {          // some m <= l in this warp's rows
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int m0 = 16 * ks + 8 * j + 2 * qd;
            const float2 cc = *reinterpret_cast<const float2*>(cum + m0);
            const float2 dd = *reinterpret_cast<const float2*>(dts + m0);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int l = r0 + 8 * i;
              float s2[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = m0 + e, r = 4 * j + 2 * i + e;
                const float fd =
                    (l >= m && l < L)
                        ? ex2((cm[i] - (e ? cc.y : cc.x)) * LOG2E) *
                              (e ? dd.y : dd.x)
                        : 0.f;
                s2[e] = wv[r] * fd;            // dS = dW F dt_m
                rowd[i] += wv[r] * sv[r] * fd;
              }
              split2(s2[0], s2[1], sh[2 * j + i], sl[2 * j + i]);
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) sh[m] = sl[m] = 0u;
        }
        hopper::fence_regs(dc);
        hopper::wgmma_fence();
        const uint64_t dbb = desc_mn(cb_b, lp, ks);
        mma_rs<NB, 1>(dc, sh, dbb);
        mma_rs<NB, 1>(dc, sl, dbb);
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dc);
    }

    // ---- the rows' sums over their quads into the row arrays; dcum_m
    // loses dt_m (the column sums of dW S F) -----------------------------
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowt[i] = quad_sum(rowt[i]);
      rowu[i] = quad_sum(rowu[i]);
      rowd[i] = quad_sum(rowd[i]) - dtr[i] * rowt[i];
      // the quad's four lanes hold the same sums: each stores them (no
      // divergent path)
      ddtd[r0 + 8 * i] = rowt[i];
      dus[r0 + 8 * i] = rowu[i];
      dcum[r0 + 8 * i] = rowd[i];
    }
    red[wid] = warp_sum(gsp);     // the same on every lane
    red[8 + wid] = warp_sum(ddp);
    hopper::fence_proxy_async();
    __syncthreads();
    // the next head's g_k and state (P in two halves) and x and dy (one
    // buffer)
    if (t + 1 < bk.nh) {
      if (NH > 1) {
        load_g(t + 1);
        if (s_pre) load_s(t + 1, 0);
      }
      if (lay.nbuf == 1) load_xd(t + 1, 0);
    }
    hopper::cp_async_commit();

    // ---- exp(total) <g_k, s>, sum dy x, and the reverse cumsum of dcum over
    // the rows, by warp 0 in a fixed order (as the fp32 kernel's tail) -----------------
    if (wid == 0) {
      float g8 = 0.f, d8 = 0.f, ud = 0.f;
      for (int w = 0; w < 8; ++w) {
        g8 += red[w];
        d8 += red[8 + w];
      }
      float uu[4];
      for (int e = 0; e < 4; ++e) {
        const int l = 4 * lane + e;
        uu[e] = expf(total - cum[l]) * dts[l];
        ud += uu[e] * dus[l];
      }
      ud = warp_sum(ud);
      const float dtot = ud + expf(total) * g8;
      // ddt_l = the direct terms + a * (reverse cumsum of dcum)_l
      float dcv[4], own = 0.f;
      for (int e = 3; e >= 0; --e) {
        const int l = 4 * lane + e;
        dcv[e] = l < L ? dcum[l] - uu[e] * dus[l] + (l == L - 1 ? dtot : 0.f)
                       : 0.f;
        own += dcv[e];
      }
      float suf = own;               // sum over lanes >= this one
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(ALL, suf, off);
        suf += lane + off < 32 ? o : 0.f;
      }
      float rc = __shfl_down_sync(ALL, suf, 1);
      rc = lane == 31 ? 0.f : rc;
      const float av = a.a[h];
      float da = 0.f;
      float* ddt = a.ddt + rowbase * a.heads + h;
      for (int e = 3; e >= 0; --e) {
        const int l = 4 * lane + e;
        rc += dcv[e];
        if (l < lv)
          ddt[(ll)l * a.heads] =
              ddtd[l] + expf(total - cum[l]) * dus[l] + av * rc;
        da += dts[l] * rc;
      }
      da = warp_sum(da);              // the same on every lane
      a.part[(slot0 + h) * 2] = da;
      a.part[(slot0 + h) * 2 + 1] = d8;
    }
  }

  // ---- dB and dC of the block's heads to this head tile's slot --------
  if (act) {
    const ll rs = (ll)a.n_tiles * N;
    float* dbo = a.dbh + rowbase * rs + (ll)bk.tile * N;
    float* dco = a.dch + rowbase * rs + (ll)bk.tile * N;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = r0 + 8 * i, n = 8 * j + 2 * qd;
        if (m < lv && n < N) {
          *reinterpret_cast<float2*>(dbo + m * rs + n) =
              make_float2(db[4 * j + 2 * i], db[4 * j + 2 * i + 1]);
          *reinterpret_cast<float2*>(dco + m * rs + n) =
              make_float2(dc[4 * j + 2 * i], dc[4 * j + 2 * i + 1]);
        }
      }
  }
}

// ===========================================================================
// 4. dB, dC over the head tiles of a group; da, dd over (batch, chunk)
// ===========================================================================

// one thread per (row, group, n) of dB and dC, the `tpg` head tiles of its
// group (fp32: one head each; bf16: the chunks kernel's head tiles) summed
// in order; the last block sums da and dd of each head over (batch, chunk)
// in order
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_reduce(const float* __restrict__ dbh, const float* __restrict__ dch,
                   T* __restrict__ db, T* __restrict__ dc,
                   const float* __restrict__ part, float* __restrict__ da,
                   float* __restrict__ dd, ll rows, int heads, int groups,
                   int n, int chunks, int tpg) {
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
  const ll o = (row * groups * tpg + (ll)g * tpg) * n + q;
  float sb = 0.f, sc = 0.f;
  for (int t = 0; t < tpg; ++t) {
    sb += dbh[o + (ll)t * n];
    sc += dch[o + (ll)t * n];
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

template <typename T>
cudaError_t reduce(const Args& a, int batch, void* db, void* dc, void* da,
                   void* dd, cudaStream_t st) {
  const ll rows = (ll)batch * a.seq;
  const ll out = rows * a.groups * a.n;
  ssd_bwd_reduce<T><<<(unsigned)((out + 255) / 256 + 1), 256, 0, st>>>(
      a.dbh, a.dch, static_cast<T*>(db), static_cast<T*>(dc), a.part,
      static_cast<float*>(da), static_cast<float*>(dd), rows, a.heads,
      a.groups, a.n, batch * a.nc, a.tpg);
  return cudaGetLastError();
}

template <int NJ, int PJ>
cudaError_t run_f32(const Args& a, int batch, void* dinit, void* db,
                    void* dc, void* da, void* dd, cudaStream_t st) {
  const unsigned blocks = (unsigned)((ll)batch * a.nc * a.heads);
  ssd_bwd_dlocal<float, PJ><<<blocks, NT, DLOCAL_SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int np4 = a.n * a.p / 4;
  ssd_bwd_pass<<<dim3((np4 + 255) / 256, batch * a.heads), 256, 0, st>>>(
      a.gbuf, a.total, a.dstate, static_cast<float*>(dinit), a.nc, a.heads,
      np4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = hopper::set_smem((const void*)ssd_bwd_chunks<float, NJ, PJ>,
                       CHUNKS_SMEM);
  if (e != cudaSuccess) return e;
  ssd_bwd_chunks<float, NJ, PJ><<<blocks, NT, CHUNKS_SMEM, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce<float>(a, batch, db, dc, da, dd, st);
}

// the tensor maps of a bf16 call whose chunk fills its tiles (a multiple
// of 64 rows: past-the-chunk rows are never in a box) and whose views TMA
// can describe; false leaves the call on the cp.async (or element) fill
bool make_maps(Maps* m, const Args& a, int batch) {
  if (a.chunk % TILE) return false;
  const int nb = a.n > TILE ? 2 * TILE : TILE;
  const ll xd[4] = {a.p, a.seq, a.heads, batch};
  const ll xs[3] = {a.x_ss, a.x_sh, a.x_sb};
  const ll ys[3] = {(ll)a.heads * a.p, a.p, (ll)a.seq * a.heads * a.p};
  const ll bd[4] = {a.n, a.seq, a.groups, batch};
  const ll bs[3] = {a.b_ss, a.b_sg, a.b_sb};
  const ll cs[3] = {a.c_ss, a.c_sg, a.c_sb};
  const ll slots = (ll)batch * a.nc * a.heads;
  const ll sd[3] = {a.p, a.n, slots};
  const ll gd[3] = {a.p, a.n, 2 * slots};
  const ll ss[2] = {a.p, (ll)a.n * a.p};
  return hopper::map_bf16(&m->x, a.x, 4, xd, xs, a.lp) &&
         hopper::map_bf16(&m->dy, a.dy, 4, xd, ys, a.lp) &&
         hopper::map_bf16(&m->b, a.b, 4, bd, bs, a.lp) &&
         hopper::map_bf16(&m->c, a.c, 4, bd, cs, a.lp) &&
         (a.nc == 1 || hopper::map_bf16(&m->s, a.s_in, 3, sd, ss, nb)) &&
         hopper::map_bf16(&m->g, a.ghl, 3, gd, ss, nb);
}

template <int NB, int PB>
cudaError_t run_bf16(Args a, int batch, void* dinit, void* db, void* dc,
                     void* da, void* dd, cudaStream_t st) {
  Maps tm;
  a.tma = make_maps(&tm, a, batch);
  const Layout cl = chunks_layout(a.lp, NB, PB);
  const DLayout dl = dlocal_layout(a.lp, NB, PB);
  if (cl.bytes > SMEM_LIMIT || dl.bytes > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((ll)batch * a.nc * a.n_tiles);
  cudaError_t e =
      hopper::set_smem((const void*)ssd_bwd_dlocal_wg<PB>, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  ssd_bwd_dlocal_wg<PB><<<blocks, 2 * WG, dl.bytes, st>>>(a, tm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int np4 = a.n * a.p / 4;
  ssd_bwd_pass_hl<<<dim3((np4 + 255) / 256, batch * a.heads), 256, 0, st>>>(
      a.gbuf, a.total, a.dstate, static_cast<float*>(dinit), a.ghl, a.nc,
      a.heads, np4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = hopper::set_smem((const void*)ssd_bwd_chunks_wg<NB, PB>, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  ssd_bwd_chunks_wg<NB, PB><<<blocks, 2 * WG, cl.bytes, st>>>(a, tm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce<bf16>(a, batch, db, dc, da, dd, st);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the kernels of a call by dtype and widths, for the occupancy query
const void* dlocal_fn(int dtype, int n, int p) {
  if (dtype == 0)
    return p <= 64 ? (const void*)ssd_bwd_dlocal<float, 4>
                   : (const void*)ssd_bwd_dlocal<float, 8>;
  return p <= 64 ? (const void*)ssd_bwd_dlocal_wg<64>
                 : (const void*)ssd_bwd_dlocal_wg<128>;
}
const void* chunks_fn(int dtype, int n, int p) {
  if (dtype == 0) {
    if (n <= 64)
      return p <= 64 ? (const void*)ssd_bwd_chunks<float, 4, 4>
                     : (const void*)ssd_bwd_chunks<float, 4, 8>;
    return p <= 64 ? (const void*)ssd_bwd_chunks<float, 8, 4>
                   : (const void*)ssd_bwd_chunks<float, 8, 8>;
  }
  if (n <= 64)
    return p <= 64 ? (const void*)ssd_bwd_chunks_wg<64, 64>
                   : (const void*)ssd_bwd_chunks_wg<64, 128>;
  return p <= 64 ? (const void*)ssd_bwd_chunks_wg<128, 64>
                 : (const void*)ssd_bwd_chunks_wg<128, 128>;
}

}  // namespace

// Dynamic shared memory of one block of the dlocal (`kernel` 0) or the
// chunks kernel (1) of a call, as the launch lays it out.  dtype
// 0 = float32, 1 = bfloat16.
extern "C" int repro_ssd_bwd_smem_bytes(int dtype, int kernel, int chunk,
                                        int n, int p) {
  if (dtype == 0) return kernel == 0 ? DLOCAL_SMEM : CHUNKS_SMEM;
  const int lp = round_up(chunk, TILE);
  const int nb = n > TILE ? 2 * TILE : TILE, pb = p > TILE ? 2 * TILE : TILE;
  return kernel == 0 ? dlocal_layout(lp, nb, pb).bytes
                     : chunks_layout(lp, nb, pb).bytes;
}

// Blocks of the dlocal and the chunks kernel that fit one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's threads
// and shared memory) into out[0] and out[1]; returns the CUDA error.
extern "C" int repro_ssd_bwd_occupancy(int dtype, int chunk, int n, int p,
                                       int* out) {
  const void* fns[2] = {dlocal_fn(dtype, n, p), chunks_fn(dtype, n, p)};
  for (int i = 0; i < 2; ++i) {
    cudaError_t e = hopper::set_smem(fns[i], SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[i], fns[i], dtype == 0 ? NT : 2 * WG,
        repro_ssd_bwd_smem_bytes(dtype, i, chunk, n, p));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// dtype of x/B/C/dy/dx/dB/dC and s_in: 0 = float32, 1 = bfloat16.  dt, a,
// d, init, dstate, ddt, da, dd, dinit and the fp32 scratch are float32.
// dy, dx, ddt, init, dstate and s_in are contiguous; x, dt, B and C take
// strides (their last dim contiguous; `aligned`: x, B and C have bases and
// strides that are multiples of 16 bytes).  Scratch: gbuf (B, nc, H, N, P)
// fp32, total (B, nc, H), part (B, nc, H, 2); fp32: dbh and dch (B, S, H,
// N); bf16: ghl (B, nc, H, 2, N, P) bf16 (g_k's high and low parts) and dbh
// and dch (B, S, G ceil(H / G / ht), N), one slot per head tile of `ht`
// heads.  init and dstate may be null (zeros); s_in is read for chunks 1..
// only (chunk 0 enters from init).  Four kernels on the stream (dlocal,
// the reverse pass, the chunks, the reduction).  Requires chunk <= 128,
// n % 8 == 0, n <= 128, p <= 128, p % 4 == 0 and heads % groups == 0 (the
// wrapper checks).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int repro_ssd_bwd(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* init, const void* s_in,
    const void* dy, const void* dstate, void* dx, void* ddt, void* da,
    void* db, void* dc, void* dd, void* dinit, void* gbuf, void* ghl,
    void* total, void* dbh, void* dch, void* part, int batch, int seq,
    int heads, int groups, int n, int p, int chunk, int ht, int aligned,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg,
    void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || n < 8 || n > MAXR || n % 8 ||
      p < 4 || p > MAXR || p % 4 || groups < 1 || heads % groups ||
      batch < 1 || seq < 1 || ht < 1 || (dtype == 1 && ghl == nullptr))
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
  args.ghl = static_cast<bf16*>(ghl);
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
  // fp32 takes one head a block (the reduction's tiles are the heads)
  args.ht = dtype == 0 ? 1 : (ht < args.hpg ? ht : args.hpg);
  args.tpg = (args.hpg + args.ht - 1) / args.ht;
  args.n_tiles = groups * args.tpg;
  args.lp = round_up(chunk, TILE);
  args.tma = 0;
  args.aligned = aligned;
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
  if (dtype == 0) {
    if (n <= 64)
      err = p <= 64 ? run_f32<4, 4>(args, batch, dinit, db, dc, da, dd, st)
                    : run_f32<4, 8>(args, batch, dinit, db, dc, da, dd, st);
    else
      err = p <= 64 ? run_f32<8, 4>(args, batch, dinit, db, dc, da, dd, st)
                    : run_f32<8, 8>(args, batch, dinit, db, dc, da, dd, st);
  } else if (dtype == 1) {
    if (n <= 64)
      err = p <= 64 ? run_bf16<64, 64>(args, batch, dinit, db, dc, da, dd, st)
                    : run_bf16<64, 128>(args, batch, dinit, db, dc, da, dd, st);
    else
      err = p <= 64
                ? run_bf16<128, 64>(args, batch, dinit, db, dc, da, dd, st)
                : run_bf16<128, 128>(args, batch, dinit, db, dc, da, dd, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
