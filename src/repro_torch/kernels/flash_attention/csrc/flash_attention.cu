// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with GQA, an explicit q offset, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas / _attn_kernel).  It computes the same function:
// out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[...]
// over the visible columns j, with fp32 statistics, written in q's type,
// with rows that see no column at all written as 0.  Unlike the Pallas
// kernel, q row i sits at absolute position q_offset + i (the Pallas kernel
// hard-codes 0), which is what lets chunked prefill attend a mid-sequence
// chunk against the full-length K/V scratch through this kernel.
//
// What bounds it on this card: the bulk 2048-token causal prefill of
// smollm-360m does ~8.1 GFLOP of visible work on ~10.5 MB, so it is
// compute-bound (~8 us at 989 TFLOP/s bf16).  A 128-row prefill chunk has
// little work per (head, q tile) and is bound by how many SMs it keeps
// busy: 2 q tiles x 15 heads is 30 blocks for 132 SMs.
//
// bf16 (the serving path), designed for those two bounds:
//  * One warpgroup (128 threads) per 64 q rows of one head.  S = Q K^T and
//    O += P V both run on the tensor cores with wgmma (m64n64k16 and
//    m64nDVk16, fp32 accumulators in registers).  Q and K are K-major
//    operands in shared memory; P is rounded to bf16 in registers and fed
//    as the A operand; V is an MN-major B operand read in place (no
//    transpose pass).  The row max and normaliser stay in fp32 registers,
//    reduced over the 4 lanes that share a row of the accumulator.
//  * K/V tiles of 64 rows arrive by 16-byte cp.async copies into a ring of
//    two shared-memory stages: tile t + 1 lands while tile t multiplies.
//    Strides come from the view (q as a transposed projection, k/v as
//    layer slices of the scratch): any multiple of 16 bytes works, which
//    the wrapper checks.  Tiles use the 128-byte swizzle (hopper.cuh):
//    8 threads copy one 128-byte line and store without bank conflicts.
//    Head dims 80, 96 and 112 fill part of a second 64-column atom: 16, 32
//    and 48 columns, so their K/V tiles take 16 KB of shared memory for 10,
//    12 and 14 KB of data, and no product is padded (zamba2-7b's 112 is
//    seven k16 steps of Q K^T and an m64n112k16 P V).  Rows past Skv or Sq are
//    zero-filled by the copy.
//  * q/k and v head dims are template arguments of their own (DK, DV):
//    MLA (minicpm3-4b) attends with q/k rows of 96 (64 latent-expanded +
//    32 rope) and v rows of 64.  Q and K tiles are loaded at DK and V
//    tiles at DV, Q K^T is DK / 16 k16 steps and P V an m64nDVk16
//    product, so neither is padded; the O accumulator, the split partials
//    and the merge are DV wide.
//  * Split-KV: when (q tiles x Hq) is below a wave of 132 SMs, the
//    visible kv tiles of each q tile are cut into `splits` ranges of
//    `tiles_per_split` (ops.kv_split_plan, which depends only on the
//    visible column range and Hq, not on the batch).  Each split writes its unnormalised O, its row
//    max and its row sum in fp32; flash_merge combines the splits in split
//    order (no atomics), so a chunk sums in the same order whatever the
//    cache layout.
//  * Masks as before: tiles wholly above the causal limit or below the
//    window are not visited (the _block_ranges rule of
//    repro/models/layers.py); the ragged edge (col >= Skv) is masked here.
//  * Heavy q tiles first: under a causal mask the last q tile of a head
//    walks the most kv tiles, so the grid starts those.
//  What holds it back now (PERF.md): within a block the two products and
//  the softmax run one after another (QK^T, wait, softmax, PV, wait); a
//  TMA fill of the same tiles and a three-stage ring measured no faster,
//  and issuing the next tile's QK^T under this tile's softmax measured
//  slower (ptxas serialises the wgmmas).  Two consumer warpgroups taking
//  turns on the tensor cores is the next step.
//
// fp32 keeps the CUDA-core kernel (flash_fwd_f32): the reference's full-fp32
// dot, which tensor cores would turn into TF32.  One thread per q row with
// q[DK] and acc[DV] in registers, K/V tiles of 32 rows staged in shared
// memory; far from the bound by design, and not the serving path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_o;   // splits > 1: (splits, B * Hq, Sq, DV) unnormalised O
  float* part_ml;  // splits > 1: (splits, B * Hq, Sq, 2) row max, row sum
  int hq, hkv, sq, skv;
  ll q_sb, q_sh, q_ss;  // element strides of q over (b, h, s)
  ll k_sb, k_sh, k_ss;
  ll v_sb, v_sh, v_ss;
  int q_offset;  // absolute position of q row 0
  int causal;
  int has_window;  // 0: no window (the caller's None)
  int window;      // with has_window (any int, 0 too): c > row - window
  float scale;
  int splits, tiles_per_split;
};

// kv tiles [t_lo, t_hi) of `tile` columns that hold a column visible to
// some row of the q rows [i0, i1) (ops.visible_tiles is the same rule)
__device__ __forceinline__ void visible_tiles(const Args& a, int i0, int i1,
                                              int tile, int& t_lo,
                                              int& t_hi) {
  const ll r_lo = (ll)a.q_offset + i0;
  const ll r_hi = (ll)a.q_offset + i1 - 1;
  ll c_hi = a.skv;
  if (a.causal) c_hi = min(c_hi, r_hi + 1);
  ll c_lo = 0;
  if (a.has_window) c_lo = max(0LL, r_lo - a.window + 1);
  // causal under a window below 1: no row sees any column
  if (a.causal && a.has_window && a.window < 1) c_hi = c_lo;
  t_lo = (int)(c_lo / tile);
  t_hi = c_hi > c_lo ? (int)((c_hi + tile - 1) / tile) : t_lo;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full-fp32 products
// ---------------------------------------------------------------------------

constexpr int F32_Q = 64;
constexpr int F32_KV = 32;
constexpr float NEG_BIG = -1.0e30f;

template <int DK, int DV>
__global__ void __launch_bounds__(F32_Q) flash_fwd_f32(const Args a) {
  static_assert(DK % 4 == 0 && DV % 4 == 0,
                "head dims must be multiples of 4");
  __shared__ __align__(16) float ks[F32_KV][DK];
  __shared__ __align__(16) float vs[F32_KV][DV];

  const int bh = blockIdx.y;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = blockIdx.x * F32_Q;
  const int i = i0 + threadIdx.x;
  const bool live = i < a.sq;
  const ll row = (ll)a.q_offset + i;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qr[DK];
  float acc[DV];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    qr[d] = live ? q[(ll)i * a.q_ss + d] * a.scale : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) acc[d] = 0.f;
  float m = NEG_BIG;
  float l = 0.f;

  int t_lo, t_hi;
  visible_tiles(a, i0, min(i0 + F32_Q, a.sq), F32_KV, t_lo, t_hi);

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * F32_KV;
    __syncthreads();  // every row is done with the previous tile
    for (int idx = threadIdx.x; idx < F32_KV * DK; idx += F32_Q) {
      const int j = idx / DK;
      const int d = idx % DK;
      const int c = c0 + j;
      ks[j][d] = c < a.skv ? k[(ll)c * a.k_ss + d] : 0.f;
    }
    for (int idx = threadIdx.x; idx < F32_KV * DV; idx += F32_Q) {
      const int j = idx / DV;
      const int d = idx % DV;
      const int c = c0 + j;
      vs[j][d] = c < a.skv ? v[(ll)c * a.v_ss + d] : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    float s[F32_KV];
    float tile_max = NEG_BIG;
#pragma unroll
    for (int j = 0; j < F32_KV; ++j) {
      const ll c = c0 + j;
      bool vis = c < a.skv;
      if (a.causal) vis = vis && c <= row;
      if (a.has_window) vis = vis && c > row - a.window;
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DK / 4; ++d4) {
        const float4 kk = kr[d4];
        dot += qr[4 * d4] * kk.x;
        dot += qr[4 * d4 + 1] * kk.y;
        dot += qr[4 * d4 + 2] * kk.z;
        dot += qr[4 * d4 + 3] * kk.w;
      }
      s[j] = vis ? dot : NEG_BIG;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new <= 0.5f * NEG_BIG) continue;  // nothing visible to this row yet
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < F32_KV; ++j) {
      const float p = s[j] <= 0.5f * NEG_BIG ? 0.f : expf(s[j] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < DV / 4; ++d4) {
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
  float* o = static_cast<float*>(a.o) + (((ll)b * a.hq + h) * a.sq + i) * DV;
#pragma unroll
  for (int d = 0; d < DV; ++d) o[d] = acc[d] / denom;
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, cp.async K/V ring, split-KV
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // q rows a block (one warpgroup)
constexpr int BKV = 64;      // kv rows a tile
constexpr int THREADS = 128;
constexpr int STAGES = 2;    // K/V ring depth (3 measured no faster)
constexpr float LOG2E = 1.4426950408889634f;

template <int DK, int DV>
constexpr int smem_bytes() {   // Q, then K and V a stage, and alignment
  return 1024 + (1 + STAGES) * hopper::tile_bytes<BKV, DK>() +
         STAGES * hopper::tile_bytes<BKV, DV>();
}

// this thread's 16-byte chunks of a 64 x D tile: tile row, element offset
// (row * stride + column) and place in the swizzled tile of each, fixed
// for the block, so a tile costs a few instructions a chunk
template <int D>
struct TileChunks {
  static constexpr int N = 64 * D / 8 / THREADS;   // D / 16
  int row[N];
  ll off[N];
  uint32_t dst[N];
  __device__ TileChunks(ll ss) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      int c8;
      hopper::tile_chunk<D>(threadIdx.x + u * THREADS, row[u], c8);
      off[u] = (ll)row[u] * ss + 8 * c8;
      dst[u] = hopper::swz_offset<BKV>(row[u], c8);
    }
  }
};

// rows [row0, row0 + 64) of a (rows, D) bf16 matrix with row stride `ss`
// into a 64 x D tile at `dst`; rows >= `rows` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          ll ss, const TileChunks<D>& c,
                                          int row0, int rows) {
  const bf16* base = src + (ll)row0 * ss;
#pragma unroll
  for (int u = 0; u < TileChunks<D>::N; ++u) {
    const bool in = row0 + c.row[u] < rows;
    hopper::cp_async16(dst + c.dst[u], in ? base + c.off[u] : src,
                       in ? 16 : 0);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(const Args a) {
  using MMA_S = hopper::Wgmma<BKV>;
  using MMA_O = hopper::Wgmma<DV>;
  constexpr int TILE_K = hopper::tile_bytes<BKV, DK>();   // a 64 x DK tile
  constexpr int TILE_V = hopper::tile_bytes<BKV, DV>();   // a 64 x DV tile
  constexpr int STAGE = TILE_K + TILE_V;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = hopper::align1024(hopper::smem_u32(smem));
  const uint32_t s_kv = s_q + TILE_K;   // stage s: K, then V, at s * STAGE

  // heads on x, q tiles on y: the scheduler starts every head's last
  // (under a causal mask the longest) q tile first
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int split = blockIdx.z;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  int t_lo, t_hi;
  visible_tiles(a, i0, min(i0 + BQ, a.sq), BKV, t_lo, t_hi);
  int t_begin = t_lo, t_end = t_hi;
  if (a.splits > 1) {
    t_begin = min(t_lo + split * a.tiles_per_split, t_hi);
    t_end = min(t_begin + a.tiles_per_split, t_hi);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  // this thread's two rows (absolute positions) of the accumulators
  const ll row_abs[2] = {(ll)a.q_offset + i0 + 16 * warp + g,
                         (ll)a.q_offset + i0 + 16 * warp + g + 8};
  const float sl2 = a.scale * LOG2E;

  // Q with the first kv tile, then the next STAGES - 2 tiles, a commit
  // group each
  const TileChunks<DK> cq(a.q_ss), ck(a.k_ss);
  const TileChunks<DV> cv(a.v_ss);
  load_tile<DK>(s_q, q, a.q_ss, cq, i0, a.sq);
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    const int t = t_begin + u;
    if (t < t_end) {
      load_tile<DK>(s_kv + u * STAGE, k, a.k_ss, ck, t * BKV, a.skv);
      load_tile<DV>(s_kv + u * STAGE + TILE_K, v, a.v_ss, cv, t * BKV,
                    a.skv);
    }
    hopper::cp_async_commit();
  }

  float o[MMA_O::REGS];
#pragma unroll
  for (int r = 0; r < MMA_O::REGS; ++r) o[r] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
  float l[2] = {0.f, 0.f};               // this thread's share of the sum

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % STAGES;
    const uint32_t s_k = s_kv + st * STAGE;
    const uint32_t s_v = s_k + TILE_K;
    hopper::cp_async_wait<STAGES - 2>();
    hopper::fence_proxy_async();
    __syncthreads();   // tile t landed for all; tile t - 1 no longer read
    const int tn = t + STAGES - 1;   // into the stage tile t - 1 left
    if (tn < t_end) {
      const uint32_t n_k = s_kv + ((tn - t_begin) % STAGES) * STAGE;
      load_tile<DK>(n_k, k, a.k_ss, ck, tn * BKV, a.skv);
      load_tile<DV>(n_k + TILE_K, v, a.v_ss, cv, tn * BKV, a.skv);
    }
    hopper::cp_async_commit();

    // S = Q K^T (64 x 64, fp32)
    float s[MMA_S::REGS];
#pragma unroll
    for (int r = 0; r < MMA_S::REGS; ++r) s[r] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      MMA_S::template ss<0, 0>(s, hopper::desc_k_major<BQ>(s_q, ks),
                               hopper::desc_k_major<BKV>(s_k, ks), ks > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // online softmax over this tile, rows g and g + 8 of the warp's 16;
    // only tiles that cross the ragged edge, the causal diagonal or the
    // window's edge for some row of the block are masked
    const int c0 = t * BKV;
    const ll first = (ll)a.q_offset + i0, last = first + BQ - 1;
    const bool mask = c0 + BKV > a.skv || (a.causal && c0 + BKV - 1 > first) ||
                      (a.has_window && c0 <= last - a.window);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const ll row = row_abs[i];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const ll c = c0 + 8 * j + 2 * qd + e;
          bool vis = true;
          if (mask) {
            vis = c < a.skv;
            if (a.causal) vis = vis && c <= row;
            if (a.has_window) vis = vis && c > row - a.window;
          }
          float& x = s[4 * j + 2 * i + e];
          x = vis ? x * sl2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = exp2f(x - m_use);
          sum += x;
        }
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += P V: P as the bf16 A fragment of each k16 step (kv cols 16 ks..)
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      p[ks][0] = hopper::pack_bf16(s[8 * ks], s[8 * ks + 1]);
      p[ks][1] = hopper::pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
      p[ks][2] = hopper::pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
      p[ks][3] = hopper::pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
    }
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks)
      MMA_O::template rs<1>(o, p[ks], hopper::desc_mn_major<BKV>(s_v, ks),
                            1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int bh_rows = gridDim.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i0 + 16 * warp + g + 8 * i;
    if (r >= a.sq) continue;
    const ll orow = ((ll)bh * a.sq + r) * DV;
    if (a.splits == 1) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // saw nothing -> 0
      bf16* out = static_cast<bf16*>(a.o) + orow;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * qd) = v2;
      }
    } else {
      const ll prow = ((ll)split * bh_rows + bh) * a.sq + r;
      float* po = a.part_o + prow * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(po + 8 * j + 2 * qd) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (qd == 0)
        *reinterpret_cast<float2*>(a.part_ml + 2 * prow) =
            make_float2(m[i], l[i]);
    }
  }
}

// out = sum_s O_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s, the
// splits taken in order; a row no split saw is 0
template <int DV>
__global__ void __launch_bounds__(256)
flash_merge(const float* __restrict__ part_o, const float* __restrict__ ml,
            bf16* __restrict__ out, ll rows, int splits) {
  const ll idx = (ll)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * (DV / 2)) return;
  const ll row = idx / (DV / 2);
  const int col = 2 * (int)(idx % (DV / 2));
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * (s * rows + row)]);
  float sum = 0.f, o0 = 0.f, o1 = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const ll pr = s * rows + row;
      const float w = exp2f(ml[2 * pr] - mx);
      const float2 po =
          *reinterpret_cast<const float2*>(part_o + pr * DV + col);
      sum += ml[2 * pr + 1] * w;
      o0 += po.x * w;
      o1 += po.y * w;
    }
  }
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(out + row * DV + col) =
      __floats2bfloat162_rn(o0 * inv, o1 * inv);
}

template <int DK, int DV>
cudaError_t launch_f32(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.sq + F32_Q - 1) / F32_Q, batch * a.hq);
  flash_fwd_f32<DK, DV><<<grid, F32_Q, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  cudaError_t e =
      hopper::set_smem((const void*)flash_fwd_bf16<DK, DV>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * a.hq, (a.sq + BQ - 1) / BQ, a.splits);
  flash_fwd_bf16<DK, DV><<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const ll rows = (ll)batch * a.hq * a.sq;
  const ll n = rows * (DV / 2);
  flash_merge<DV><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.part_o, a.part_ml, static_cast<bf16*>(a.o), rows, a.splits);
  return cudaGetLastError();
}

// the (q/k, v) head dim pairs built: every equal pair, and MLA's (96, 64)
// (ops.HEAD_DIM_PAIRS is the same list)
cudaError_t dispatch(int dtype, int dk, int dv, const Args& a, int batch,
                     cudaStream_t st) {
#define REPRO_FLASH_DIMS(DK, DV)                                  \
  if (dk == DK && dv == DV)                                       \
    return dtype == 0 ? launch_f32<DK, DV>(a, batch, st)          \
                      : launch_bf16<DK, DV>(a, batch, st);
  REPRO_FLASH_DIMS(16, 16)
  REPRO_FLASH_DIMS(32, 32)
  REPRO_FLASH_DIMS(64, 64)
  REPRO_FLASH_DIMS(80, 80)
  REPRO_FLASH_DIMS(96, 96)
  REPRO_FLASH_DIMS(112, 112)
  REPRO_FLASH_DIMS(128, 128)
  REPRO_FLASH_DIMS(96, 64)
#undef REPRO_FLASH_DIMS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; splits must be 1), 1 = bfloat16 (wgmma).
// head_dim is q's and k's, head_dim_v v's.  Output o is contiguous
// (B, Hq, Sq, head_dim_v).  With splits > 1 (bf16 only), part_o
// (splits, B * Hq, Sq, head_dim_v) and part_ml (splits, B * Hq, Sq, 2) are
// fp32 scratch and a merge kernel follows on the same stream.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int repro_flash_attention_fwd(
    int dtype, int head_dim, int head_dim_v, const void* q, const void* k,
    const void* v,
    void* o, int batch, int hq, int hkv, int sq, int skv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int q_offset, int causal, int has_window, int window, float scale,
    int splits, int tiles_per_split, float* part_o, float* part_ml,
    void* stream) {
  if ((dtype != 0 && dtype != 1) || splits < 1 ||
      (splits > 1 && (dtype != 1 || tiles_per_split < 1 || !part_o ||
                      !part_ml)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    o,    part_o, part_ml, hq,     hkv,
         sq,   skv,  q_sb, q_sh, q_ss,   k_sb,    k_sh,   k_ss,
         v_sb, v_sh, v_ss, q_offset,     causal,  has_window,
         window, scale,  splits, tiles_per_split};
  return static_cast<int>(
      dispatch(dtype, head_dim, head_dim_v, a, batch,
               static_cast<cudaStream_t>(stream)));
}
