// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/kernel.py (ssd_pallas /
// _ssd_kernel).  It computes the same function, per batch row b and head h
// (group g = h / (H / G)), over chunks of L rows with cum the inclusive
// within-chunk cumsum of a_h * dt and total = cum[L - 1]:
//   y_intra = ((C B^T) * exp(cum_i - cum_j) * dt_j * [i >= j]) @ X
//   y_inter = exp(cum_i) * (C @ state)
//   y       = y_intra + y_inter + d_h * X              (written in x's type)
//   state   = exp(total) * state + (B * exp(total - cum) * dt)^T @ X
// starting from init_state (or zeros) and writing the final fp32 state.
// Rows past S act as dt = 0 and x = 0 (exact: decay 1, no injection) and
// their y is not written.  x, B and C may be strided views (the model
// passes slices of the conv output); only their last dim is contiguous.
//
// The design (the Pallas kernel walks the chunks in order on one core; on
// this card the chunks run in parallel):
//  * Chunks in parallel, then one ordered pass over the states.  A call of
//    more than one chunk launches three kernels on the stream:
//      1. ssd_chunks, MODE_STATE: each block takes one (b, chunk, head
//         tile, P tile) and writes each head's chunk-local state
//         (B * u)^T X, u = exp(total - cum) dt, and the chunk's total, to
//         fp32 scratch (`local`, `total`);
//      2. ssd_pass: state_k = exp(total_k) state_{k-1} + local_k in chunk
//         order, one thread per 4 state elements -- the sequential
//         kernel's own update, the same operations in the same order for
//         each element -- writing the state entering each chunk (`s_in`,
//         in x's type) and the final state; its loads and stores take an
//         evict-first L2 policy, so they do not push out of L2 what the
//         output kernel reads next (faster than plain in probes);
//      3. ssd_chunks, MODE_OUT: each block computes its chunk's
//         y = exp(cum) (C @ s_in) + W @ X + d X.
//    A call of one chunk (the serving prefill chunk) is one launch,
//    MODE_BOTH: its entering state is init_state, so the block computes y
//    and the final state exp(total) init + local at once.  The scratch is
//    (B, chunks, H, N, P) fp32 plus the same in x's type, allocated by the
//    wrapper (42 + 21 MB at S 2048 for mamba2-2.7b); nothing syncs the host.
//    A sequential scan instead (one block per head and P tile walking the
//    chunks, the state in registers, no `local`) measured slower than
//    kernels 1 and 2 together in probes: latency-bound at 80 blocks.
//  * Enough blocks for the card.  A block is one warpgroup per 64-row tile
//    of the chunk (two at chunk 128), or per 64-row tile of the state for
//    MODE_STATE, and takes `ht` heads of one group and `pt` columns of P;
//    ops.ssd_plan picks them so the grid fills whole waves of 132 SMs (two
//    bf16 blocks an SM): at S 2048, ht 5 and pt 64 (256 blocks, one wave);
//    for the 128-row serving chunk, ht 1 and pt 32 (160 blocks).  The next
//    head's tiles load while this head computes (two buffers).
//  * One C B^T for the heads of a block.  Each row tile's S = C B^T (the
//    j tiles at or left of the diagonal) is computed once and kept in
//    registers (as bf16 pairs in the bf16 path) while the block walks its
//    heads; each head applies its own decay mask exp(cum_i - cum_j) dt_j
//    [i >= j] to it (2^x on the special function unit; k16 steps right of a
//    warp's rows are skipped).  With G = 1 and ht 5 that is a fifth of the
//    C B^T work of one product per head.
//  * bf16 products on the tensor cores (wgmma m64nNk16, fp32 sums): C B^T
//    (both operands K-major tiles); C @ state (the state an MN-major tile,
//    rounded to bf16: ~2^-9 of y); W @ X (W masked in fp32, rounded to
//    bf16 and fed from registers; X an MN-major tile read in place); and
//    the local state B^T (u X), where B^T is the B tile read as an MN-major (transposed) A
//    operand, no second copy.  u X is not rounded to bf16 once: it is
//    split into a bf16 high part and the bf16 rounding of the remainder,
//    two wgmmas, ~2^-17 relative, so the fp32 state keeps its 1e-4
//    tolerance.
//  * fp32 inputs take the same blocks, grid and pass with full-fp32 FMAs on
//    the CUDA cores (no TF32): C B^T, C @ state and W @ X give each thread
//    the elements a wgmma accumulator would (W staged in shared memory); the
//    local state takes 4 rows x pt / 8 columns a thread.
//  * Tiles by TMA: in bf16 with a chunk of 64 or 128 rows, B, C, X and
//    the entering state arrive as TMA boxes into 128-byte-swizzled tiles
//    (one thread issues them; rows past S or N read as zero), completing on
//    an mbarrier a buffer.  Issuing per-thread 16-byte cp.async copies of
//    the same tiles was a long phase of each head in the output kernel
//    (clock64 probes); with TMA the chip smoke's S 2048 went from 0.113 to
//    0.099 ms (H100 SXM, 700 W).
//    A view TMA refuses, fp32, and other chunks take the cp.async fill
//    (rows past the chunk and columns past N or P zero-filled), or the
//    kernel's element fill where a base or stride is not a multiple of 16
//    bytes.  y is staged in shared
//    memory and leaves in 16-byte stores (fp32 y: 8-byte stores straight
//    from the registers).
//  * Shared memory: bf16 at mamba2 widths ~100 KB a block, two blocks an
//    SM (256 threads, at most 128 registers a thread, ~150 bytes spilled);
//    fp32 (pt 32) ~210 KB, one block.
//
// What bounds it: at mamba2-2.7b's widths (H 80, P 64, N 128, G 1, L 128)
// the function moves ~46 MB at S 2048 (~14 us at 3.35 TB/s).  This design
// moves ~190 MB (the scratch round trip: local written and read, s_in
// written and read, x read twice), a floor of ~57 us, and reaches about
// half the memory rate: the pass runs at the rate; in the output kernel
// the masking and W @ X of the second row tile are the longest phase of a
// head (clock64 probes), register-bound at two blocks an SM (128
// registers, spills), and in the local-state kernel the fp32 stores.
// Probes that rebalanced the masking across the warpgroups or issued
// C @ state under it did not move the times.  PERF.md has them
// (python -m repro_torch.kernels.ssd.sweep splits them by CUDA kernel).

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

constexpr int WG = 128;      // threads of a warpgroup
constexpr int MAX_WG = 2;    // warpgroups a block (row tiles of a chunk)
constexpr int TILE = 64;     // rows of a row tile, n tile and j tile
constexpr int MAX_CHUNK = 128;
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// what a launch of ssd_chunks computes: the chunk-local states, the
// outputs, or both (a one-chunk call: the final state and y)
enum { MODE_STATE = 1, MODE_OUT = 2, MODE_BOTH = 3 };

struct Args {
  const void* x;      // (B, S, H, P), element strides x_sb, x_ss, x_sh
  const float* dt;    // (B, S, H), strides dt_sb, dt_ss, dt_sh
  const float* a;     // (H,)
  const void* b;      // (B, S, G, N), strides b_sb, b_ss, b_sg
  const void* c;      // (B, S, G, N), strides c_sb, c_ss, c_sg
  const float* d;     // (H,)
  const float* init;  // (B, H, N, P) contiguous, or null for zeros
  void* y;            // (B, S, H, P) contiguous, x's type
  float* state;       // (B, H, N, P) contiguous, the final state
  float* local;       // (B, nc, H, N, P): chunk-local states (MODE_STATE)
  void* s_in;         // (B, nc, H, N, P), x's type: entering states (OUT)
  float* total;       // (B, nc, H): cum at each chunk's last row
  int mode;
  int seq, heads, groups, n, p, chunk;
  int nc;             // chunks
  int lp;             // chunk rounded up to 64 (rows of a tile)
  int np;             // n rounded up to the K step (16 bf16, n for fp32)
  int ht, n_ht, tpg, hpg;  // heads a block, head tiles, tiles a group
  int n_pt;           // P tiles
  int nwg;            // warpgroups a block
  int aligned;        // x, b, c base and strides multiples of 16 bytes
  int tma;            // bf16 tiles of x, B, C and s_in arrive by TMA
  ll x_sb, x_ss, x_sh;
  ll dt_sb, dt_ss, dt_sh;
  ll b_sb, b_ss, b_sg;
  ll c_sb, c_ss, c_sg;
};

__host__ __device__ inline int imax(int u, int v) { return u > v ? u : v; }

// bytes of a tile of `rows` x `cols`: bf16 in whole 64-column atom columns
// of the 128-byte swizzle (hopper.cuh), fp32 row-major with rows padded by 4
template <typename T>
__host__ __device__ inline int tile_bytes(int rows, int cols) {
  return sizeof(T) == 2 ? (cols + 63) / 64 * rows * 128 : rows * (cols + 4) * 4;
}

// warpgroups of a block in `mode`: one per row tile (OUT), one per 64-row
// tile of the state (STATE), at most MAX_WG
__host__ __device__ inline int n_wg(int mode, int lp, int n) {
  const int rt = (mode & MODE_OUT) ? lp / TILE : 0;
  const int nt = (mode & MODE_STATE) ? (n + TILE - 1) / TILE : 0;
  const int w = imax(rt, nt);
  return w < MAX_WG ? w : MAX_WG;
}

// Byte offsets of the shared-memory regions from the 1024-aligned base:
// C and B tiles (lp x np), a head's X tile (lp x pt), T (the entering
// state np x pt for OUT, then the staged y; the low part of u X for STATE
// in bf16), W (fp32 OUT: each warpgroup's 64 x 64 masked weights), F (cum
// and dt of each head, u of the current head, the TMA mbarriers).  With more than one head a
// block (and not MODE_BOTH), X and T come twice: the next head's tiles
// load while this head computes.  OUT's second buffer takes the B tile's
// place when it fits (B is read only for C B^T, before the heads); STATE's
// second buffer is a second X (T holds this head's low part only).
// ops.ssd_plan reads it through repro_ssd_smem_bytes.
struct Layout {
  int c, b, x[2], t[2], w, f, bytes, nbuf;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int mode, int lp, int np,
                                              int pt, int ht, int nwg) {
  const bool out = mode & MODE_OUT, sta = mode & MODE_STATE;
  Layout s;
  int off = 0;
  s.c = off;
  if (out) off += tile_bytes<T>(lp, np);
  s.b = off;
  off += tile_bytes<T>(lp, np);
  const int xs = tile_bytes<T>(lp, pt);
  int t = 0;
  if (out) t = imax(tile_bytes<T>(np, pt), sizeof(T) == 2 ? tile_bytes<T>(lp, pt) : 0);
  if (sta && sizeof(T) == 2) t = imax(t, tile_bytes<T>(lp, pt));
  s.x[0] = off;
  off += xs;
  s.t[0] = off;
  off += t;
  s.nbuf = (ht > 1 && mode != MODE_BOTH) ? 2 : 1;
  s.x[1] = s.x[0];
  s.t[1] = s.t[0];
  if (s.nbuf == 2) {
    if (mode == MODE_OUT && tile_bytes<T>(lp, np) >= xs + t) {
      s.x[1] = s.b;
      s.t[1] = s.b + xs;
    } else {
      s.x[1] = off;
      off += xs;
      if (mode == MODE_OUT) {
        s.t[1] = off;
        off += t;
      }
    }
  }
  s.w = off;
  if (out && sizeof(T) == 4) off += nwg * TILE * (TILE + 4) * 4;
  s.f = off;
  off += (2 * ht + 1) * lp * 4 + 3 * 8;  // and three mbarriers
  s.bytes = off + 1024;  // room to align the dynamic base to 1024
  return s;
}

// ---------------------------------------------------------------------------
// tiles and copies
// ---------------------------------------------------------------------------


// bf16 views as TMA tensor maps, boxes of 64 columns x a tile's rows
// (make_maps): x as (P, S, H, B), B and C as (N, S, G, B), s_in as
// (P, N, B nc H); rows past S or N read as zero
struct Maps {
  CUtensorMap x, b, c, s;
};


// rows [0, rows) x columns [0, cols) of a tile at byte `dst` from a
// row-major source (row stride `ss` elements): source rows >= vr and
// columns >= vc read as zero.  By 16-byte cp.async (committed by the
// caller) when `async`, else element by element.
__device__ void fill(uint32_t su, char* sm, int dst, const bf16* src, ll ss,
                     int rows, int cols, int vr, int vc, bool async) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
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
__device__ void fill(uint32_t su, char* sm, int dst, const float* src, ll ss,
                     int rows, int cols, int vr, int vc, bool async) {
  const int cpr = cols / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c4 = i - r * cpr;
    const int nv = r < vr ? min(4, vc - 4 * c4) : 0;
    const uint32_t o = dst + (r * (cols + 4) + 4 * c4) * 4;
    const float* s = src + (ll)r * ss + 4 * c4;
    if (async) {
      hopper::cp_async16(su + o, nv > 0 ? s : src, nv > 0 ? 4 * nv : 0);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = e < nv ? s[e] : 0.f;
      *reinterpret_cast<float4*>(sm + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}
// the fp32 entering state into a bf16 tile (rounded); the source is a
// contiguous row-major (N, P) state whose columns come in fours
__device__ void fill_state_bf16(char* sm, int dst, const float* src, ll ss,
                                int rows, int cols, int vr, int vc) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c8 = i - r * cpr;
    const int nv = r < vr ? min(8, vc - 8 * c8) : 0;
    float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
    const float* s = src + (ll)r * ss + 8 * c8;
    if (nv >= 4) lo4 = *reinterpret_cast<const float4*>(s);
    if (nv >= 8) hi4 = *reinterpret_cast<const float4*>(s + 4);
    uint4 v;
    v.x = hopper::pack_bf16(lo4.x, lo4.y);
    v.y = hopper::pack_bf16(lo4.z, lo4.w);
    v.z = hopper::pack_bf16(hi4.x, hi4.y);
    v.w = hopper::pack_bf16(hi4.z, hi4.w);
    *reinterpret_cast<uint4*>(sm + dst + swz(rows, r, c8)) = v;
  }
}


// ---------------------------------------------------------------------------
// fp32 products on the CUDA cores.  Each thread computes the elements a
// wgmma accumulator of 64 rows x NC columns would give it (hopper.cuh):
// register 4 j + 2 i + e is row 16 warp + lane / 4 + 8 i, column
// 8 j + 2 (lane % 4) + e.  Tiles are row-major fp32 with padded rows.
// ---------------------------------------------------------------------------

// acc += A (64 x K, rows of `a`) B (K x NC, rows of `b`)
template <int NC>
__device__ __forceinline__ void simt_nn(float (&acc)[NC / 2], const float* a,
                                        int lda, const float* b, int ldb,
                                        int K, int warp, int gq, int q) {
  const float* a0 = a + (warp * 16 + gq) * lda;
  const float* a1 = a0 + 8 * lda;
  for (int k = 0; k < K; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
    const float v0[4] = {x0.x, x0.y, x0.z, x0.w};
    const float v1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* br = b + (k + kk) * ldb + 2 * q;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(br + 8 * j);
        acc[4 * j] += v0[kk] * bv.x;
        acc[4 * j + 1] += v0[kk] * bv.y;
        acc[4 * j + 2] += v1[kk] * bv.x;
        acc[4 * j + 3] += v1[kk] * bv.y;
      }
    }
  }
}

// acc = A (64 x K, rows of `a`) B^T, B (64 x K, rows of `bt`)
__device__ __forceinline__ void simt_nt(float (&acc)[32], const float* a,
                                        int lda, const float* bt, int ldb,
                                        int K, int warp, int gq, int q) {
  const float* a0 = a + (warp * 16 + gq) * lda;
  const float* a1 = a0 + 8 * lda;
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bt + (8 * j + 2 * q + e) * ldb + k);
        float& r0 = acc[4 * j + e];
        float& r1 = acc[4 * j + 2 + e];
        r0 += x0.x * bv.x;
        r0 += x0.y * bv.y;
        r0 += x0.z * bv.z;
        r0 += x0.w * bv.w;
        r1 += x1.x * bv.x;
        r1 += x1.y * bv.y;
        r1 += x1.z * bv.z;
        r1 += x1.w * bv.w;
      }
    }
  }
}

// acc = (B * u)^T X over rows j < K for one 64 (n) x NC (p) tile, in its
// own layout (frag_coord): thread tw of the warpgroup takes rows
// 4 (tw / 8) .. + 3 (columns of `bt`, the B tile at this n tile) and
// columns (tw % 8) NC / 8 .. + NC / 8 - 1 -- 4 x NC / 8 sums for one float4
// of B and NC / 32 float4s of X a row.  Rows at or past `nvalid` stay 0.
template <int NC>
__device__ __forceinline__ void simt_state(float (&acc)[NC / 2],
                                           const float* bt, int ldb,
                                           const float* u, const float* x,
                                           int ldx, int K, int nvalid,
                                           int tw) {
  constexpr int CW = NC / 8;
  const int n0 = 4 * (tw / 8), c0 = CW * (tw % 8);
#pragma unroll
  for (int r = 0; r < NC / 2; ++r) acc[r] = 0.f;
  if (n0 >= nvalid) return;   // nvalid is a multiple of 8
  for (int k = 0; k < K; ++k) {
    const float uk = u[k];
    const float4 bv = *reinterpret_cast<const float4*>(bt + k * ldb + n0);
    const float bw[4] = {bv.x * uk, bv.y * uk, bv.z * uk, bv.w * uk};
#pragma unroll
    for (int j4 = 0; j4 < CW / 4; ++j4) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + k * ldx + c0 + 4 * j4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r * CW + 4 * j4] += bw[r] * xv.x;
        acc[r * CW + 4 * j4 + 1] += bw[r] * xv.y;
        acc[r * CW + 4 * j4 + 2] += bw[r] * xv.z;
        acc[r * CW + 4 * j4 + 3] += bw[r] * xv.w;
      }
    }
  }
}

// row and column, in a 64 x PT state tile, of register r of the local
// state: the wgmma accumulator's (bf16) or simt_state's (fp32) layout.
// Registers r and r + 1 (r even) are columns col and col + 1 of one row.
template <bool BF, int PT>
__device__ __forceinline__ void frag_coord(int r, int tw, int& n, int& col) {
  if constexpr (BF) {
    const int warp = tw / 32, lane = tw % 32;
    n = warp * 16 + lane / 4 + 8 * ((r >> 1) & 1);
    col = 8 * (r >> 2) + 2 * (lane % 4) + (r & 1);
  } else {
    n = 4 * (tw / 8) + r / (PT / 8);
    col = (PT / 8) * (tw % 8) + r % (PT / 8);
  }
}


// u X split into a bf16 high part (over the X tile at `ox`) and the bf16
// rounding of the remainder (the tile at `ot`, same layout), u_r for row r
// of the lp x pt tile; every thread of the block takes part
template <int PT>
__device__ __forceinline__ void split_ux(char* sm, int ox, int ot,
                                         const float* u, int lp) {
  for (int i = threadIdx.x; i < lp * (PT / 8); i += blockDim.x) {
    const int r = i / (PT / 8), c8 = i - r * (PT / 8);
    const uint32_t o = swz(lp, r, c8);
    const uint4 v = *reinterpret_cast<const uint4*>(sm + ox + o);
    const float ur = u[r];
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float2 f = unpack_bf16(in[m]);
      f.x *= ur;
      f.y *= ur;
      hi[m] = hopper::pack_bf16(f.x, f.y);
      const float2 hf = unpack_bf16(hi[m]);
      lo[m] = hopper::pack_bf16(f.x - hf.x, f.y - hf.y);
    }
    *reinterpret_cast<uint4*>(sm + ox + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(sm + ot + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// acc = (B u)^T X = B^T hi + B^T lo over the first kv16 k16 steps (rows of
// the chunk), on the tensor cores: `bt` the B tile's n tile (an MN-major,
// transposed A operand), `hi` and `lo` MN-major B operands; one warpgroup
template <int PT>
__device__ __forceinline__ void local_wgmma(float (&acc)[PT / 2], uint32_t bt,
                                            uint32_t hi, uint32_t lo, int lp,
                                            int kv16) {
#pragma unroll
  for (int r = 0; r < PT / 2; ++r) acc[r] = 0.f;
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  for (int ks = 0; ks < kv16; ++ks)
    hopper::Wgmma<PT>::template ss<1, 1>(acc, desc_mn(bt, lp, ks),
                                         desc_mn(hi, lp, ks), ks > 0 ? 1 : 0);
  for (int ks = 0; ks < kv16; ++ks)
    hopper::Wgmma<PT>::template ss<1, 1>(acc, desc_mn(bt, lp, ks),
                                         desc_mn(lo, lp, ks), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// ---------------------------------------------------------------------------
// the chunk kernel: local states (MODE_STATE), outputs (MODE_OUT), or both
// for a one-chunk call (MODE_BOTH)
// ---------------------------------------------------------------------------

template <typename T, int PT>
__global__ void __launch_bounds__(MAX_WG* WG, sizeof(T) == 2 ? 2 : 1)
    ssd_chunks(const Args a, const __grid_constant__ Maps tm) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NR = PT / 2;  // registers of a 64 x PT accumulator
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t su0 = hopper::smem_u32(smem_raw);
  const uint32_t su = hopper::align1024(su0);
  char* sm = reinterpret_cast<char*>(smem_raw) + (su - su0);
  const Layout lay = make_layout<T>(a.mode, a.lp, a.np, PT, a.ht, a.nwg);
  float* cum_s = reinterpret_cast<float*>(sm + lay.f);  // [ht][lp]
  float* dt_s = cum_s + a.ht * a.lp;                     // [ht][lp]
  float* u_s = dt_s + a.ht * a.lp;                       // [lp]
  const int lp = a.lp, np = a.np;

  // block -> (b, chunk, head tile, P tile); P tiles fastest, so the blocks
  // of one chunk, which read the same B and C, run together
  int idx = blockIdx.x;
  const int pti = idx % a.n_pt;
  idx /= a.n_pt;
  const int hti = idx % a.n_ht;
  idx /= a.n_ht;
  const int k = idx % a.nc;
  const int bi = idx / a.nc;
  const int g = hti / a.tpg;
  const int h0 = g * a.hpg + (hti % a.tpg) * a.ht;
  const int nh = min(a.ht, a.hpg - (hti % a.tpg) * a.ht);
  const int p0 = pti * PT;
  const int pc = min(PT, a.p - p0);     // columns of P in this tile
  const int s0 = k * a.chunk;
  const int rows = min(a.chunk, a.seq - s0);   // rows of the chunk in S
  const bool out = a.mode & MODE_OUT, sta = a.mode & MODE_STATE;
  const int n_nt = (a.n + TILE - 1) / TILE;

  const int wg = threadIdx.x / WG;
  const int tw = threadIdx.x % WG;
  const int warp = tw / 32, lane = tw % 32, gq = lane / 4, q = lane % 4;
  const int rt = wg;                                 // this row tile
  const bool my_out = out && rt * TILE < rows;
  const int i0 = rt * TILE + warp * 16 + gq;         // rows i0, i0 + 8

  const T* xg = static_cast<const T*>(a.x) + bi * a.x_sb + (ll)s0 * a.x_ss + p0;
  const T* bg = static_cast<const T*>(a.b) + bi * a.b_sb + (ll)s0 * a.b_ss +
                g * a.b_sg;
  const T* cg = static_cast<const T*>(a.c) + bi * a.c_sb + (ll)s0 * a.c_ss +
                g * a.c_sg;
  const bool async = a.aligned;
  // TMA: one thread starts each tile's copy, and the tiles of a load
  // complete on one mbarrier: bars[0] B and C, bars[1 + buf] a head's
  const bool tma = BF && a.tma;
  const uint32_t bar0 = su + lay.f + (2 * a.ht + 1) * lp * 4;
  if (tma && threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(bar0 + 8 * i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // X (and for OUT the entering state) of head slot t into buffer `buf`
  const T* s_in_g = static_cast<const T*>(a.s_in);
  auto load_head = [&](int t, int buf) {
    const int h = h0 + t;
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = bar0 + 8 * (1 + buf);
        const bool st = a.mode == MODE_OUT;
        hopper::mbar_expect_tx(bar, (lp + (st ? np : 0)) * 128);
        tma_load_4d(su + lay.x[buf], &tm.x, bar, p0, s0, h, bi);
        if (st)
          hopper::tma_load_3d(su + lay.t[buf], &tm.s, bar, p0, 0,
                              (bi * a.nc + k) * a.heads + h);
      }
      if (a.mode == MODE_OUT) return;
    } else {
      fill(su, sm, lay.x[buf], xg + h * a.x_sh, a.x_ss, lp, PT, rows, pc,
           async);
    }
    if (!out) return;
    if (a.mode == MODE_OUT) {
      const T* src =
          s_in_g + (((ll)bi * a.nc + k) * a.heads + h) * a.n * a.p + p0;
      fill(su, sm, lay.t[buf], src, (ll)a.p, np, PT, a.n, pc,
           !BF || a.p % 8 == 0);
    } else if (a.init != nullptr) {
      const float* src = a.init + ((ll)bi * a.heads + h) * a.n * a.p + p0;
      if constexpr (BF)
        fill_state_bf16(sm, lay.t[buf], src, (ll)a.p, np, PT, a.n, pc);
      else
        fill(su, sm, lay.t[buf], src, (ll)a.p, np, PT, a.n, pc, true);
    }
  };

  // B, C, the first head's tiles and every head's dt
  if (tma) {
    if (threadIdx.x == 0) {
      const int atoms = (np + 63) / 64;
      hopper::mbar_expect_tx(bar0, (out ? 2 : 1) * atoms * lp * 128);
      for (int at = 0; at < atoms; ++at) {
        tma_load_4d(su + lay.b + at * lp * 128, &tm.b, bar0, 64 * at, s0, g,
                    bi);
        if (out)
          tma_load_4d(su + lay.c + at * lp * 128, &tm.c, bar0, 64 * at, s0,
                      g, bi);
      }
    }
  } else {
    fill(su, sm, lay.b, bg, a.b_ss, lp, np, rows, a.n, async);
    if (out) fill(su, sm, lay.c, cg, a.c_ss, lp, np, rows, a.n, async);
  }
  load_head(0, 0);
  hopper::cp_async_commit();
  for (int i = threadIdx.x; i < lp * nh; i += blockDim.x) {
    const int l = i / nh, t = i - l * nh;
    dt_s[t * lp + l] =
        l < rows ? a.dt[bi * a.dt_sb + (ll)(s0 + l) * a.dt_ss +
                        (ll)(h0 + t) * a.dt_sh]
                 : 0.f;
  }
  __syncthreads();
  // inclusive cumsum of a_h * dt over the chunk: one warp a head
  for (int t = threadIdx.x / 32; t < nh; t += blockDim.x / 32) {
    const float ah = a.a[h0 + t];
    float carry = 0.f;
    for (int base = 0; base < lp; base += 32) {
      float v = ah * dt_s[t * lp + base + lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      v += carry;
      cum_s[t * lp + base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  hopper::cp_async_wait<0>();
  if (tma) {
    hopper::mbar_wait(bar0, 0);
    hopper::mbar_wait(bar0 + 8, 0);
  }
  hopper::fence_proxy_async();
  __syncthreads();

  // S = C B^T for this row tile's j tiles 0..rt, kept across the heads
  uint32_t sp[BF ? 2 : 1][BF ? 16 : 1];    // bf16: S as bf16 pairs
  float sf[BF ? 1 : 2][BF ? 1 : 32];       // fp32: S
  if (my_out) {
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      if (jt > rt) continue;
      if constexpr (BF) {
        float s[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) s[r] = 0.f;
        hopper::fence_regs(s);
        hopper::wgmma_fence();
        for (int ks = 0; ks < np / 16; ++ks)
          hopper::Wgmma<64>::template ss<0, 0>(
              s, desc_k(su + lay.c + rt * 8192, lp, ks),
              desc_k(su + lay.b + jt * 8192, lp, ks), ks > 0 ? 1 : 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          sp[jt][r] = hopper::pack_bf16(s[2 * r], s[2 * r + 1]);
      } else {
        const float* cs = reinterpret_cast<const float*>(sm + lay.c);
        const float* bs = reinterpret_cast<const float*>(sm + lay.b);
        simt_nt(sf[jt], cs + rt * TILE * (np + 4), np + 4,
                bs + jt * TILE * (np + 4), np + 4, np, warp, gq, q);
      }
    }
  }

  const bool has_st = out && (a.mode == MODE_OUT || a.init != nullptr);

  for (int t = 0; t < nh; ++t) {
    const int h = h0 + t;
    const int buf = t % lay.nbuf;
    const int ox = lay.x[buf], ot = lay.t[buf];
    const float* cum = cum_s + t * lp;
    const float* dth = dt_s + t * lp;
    const float total = cum[lp - 1];
    // the previous head (and C B^T) is done with its tiles; this thread's
    // writes to them are ordered before the copies that refill them
    hopper::fence_proxy_async();
    __syncthreads();
    if (lay.nbuf == 2) {
      if (t + 1 < nh) load_head(t + 1, (t + 1) % 2);   // prefetch
    } else if (t > 0) {
      load_head(t, 0);
    }
    hopper::cp_async_commit();
    // u_j = exp(total - cum_j) dt_j (0 past the chunk's rows: dt = 0)
    if (sta)
      for (int l = threadIdx.x; l < lp; l += blockDim.x)
        u_s[l] = expf(total - cum[l]) * dth[l];
    if (lay.nbuf == 2)
      hopper::cp_async_wait<1>();   // this head's group; the next in flight
    else
      hopper::cp_async_wait<0>();
    if (tma && t > 0) hopper::mbar_wait(bar0 + 8 * (1 + buf), (t / lay.nbuf) & 1);
    hopper::fence_proxy_async();
    __syncthreads();

    // ---- y = exp(cum) (C @ state) + W @ X + d X --------------------------
    if (out) {
      float acc[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = 0.f;
      if (my_out) {
        const float c0 = cum[i0], c1 = cum[i0 + 8];
        if constexpr (BF) {
          if (has_st) {
            hopper::fence_regs(acc);
            hopper::wgmma_fence();
            for (int ks = 0; ks < np / 16; ++ks)
              hopper::Wgmma<PT>::template ss<0, 1>(
                  acc, desc_k(su + lay.c + rt * 8192, lp, ks),
                  desc_mn(su + ot, np, ks), ks > 0 ? 1 : 0);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(acc);
            const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
            for (int j = 0; j < PT / 8; ++j) {
              acc[4 * j] *= e0;
              acc[4 * j + 1] *= e0;
              acc[4 * j + 2] *= e1;
              acc[4 * j + 3] *= e1;
            }
          }
          // W @ X over the j tiles 0..rt: the masked weights of a tile as
          // the bf16 A fragments of its four k16 steps
          const float l0 = c0 * LOG2E, l1 = c1 * LOG2E;
#pragma unroll
          for (int jt = 0; jt < 2; ++jt) {
            if (jt > rt) continue;
            uint32_t fr[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              // on the diagonal, k16 steps right of this warp's 16 rows
              // are wholly masked
              if (jt == rt && kk > warp) {
#pragma unroll
                for (int m = 0; m < 4; ++m) fr[kk][m] = 0u;
                continue;
              }
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                // fragment register m of step kk: S registers 8 kk + 2 m,
                // + 1 = row i0 + 8 (m % 2), columns 16 kk + 8 (m / 2) +
                // 2 q + {0, 1} of the tile
                const int col = TILE * jt + 16 * kk + 8 * (m / 2) + 2 * q;
                const int row = i0 + 8 * (m % 2);
                const float lr = (m % 2) ? l1 : l0;
                const float2 sv = unpack_bf16(sp[jt][4 * kk + m]);
                const float2 cc = *reinterpret_cast<const float2*>(cum + col);
                const float2 dd = *reinterpret_cast<const float2*>(dth + col);
                const float w0 =
                    col <= row ? sv.x * ex2(fmaf(cc.x, -LOG2E, lr)) * dd.x : 0.f;
                const float w1 =
                    col + 1 <= row ? sv.y * ex2(fmaf(cc.y, -LOG2E, lr)) * dd.y
                                   : 0.f;
                fr[kk][m] = hopper::pack_bf16(w0, w1);
              }
            }
            hopper::fence_regs(acc);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              hopper::Wgmma<PT>::template rs<1>(
                  acc, fr[kk], desc_mn(su + ox + jt * 8192, lp, kk), 1);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(acc);
          }
        } else {
          if (has_st) {
            const float* cs = reinterpret_cast<const float*>(sm + lay.c);
            simt_nn<PT>(acc, cs + rt * TILE * (np + 4), np + 4,
                        reinterpret_cast<const float*>(sm + ot), PT + 4,
                        np, warp, gq, q);
            const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
            for (int j = 0; j < PT / 8; ++j) {
              acc[4 * j] *= e0;
              acc[4 * j + 1] *= e0;
              acc[4 * j + 2] *= e1;
              acc[4 * j + 3] *= e1;
            }
          }
          // W @ X over the j tiles 0..rt, W staged in shared memory
          float* wst = reinterpret_cast<float*>(sm + lay.w) + wg * TILE * (TILE + 4);
#pragma unroll
          for (int jt = 0; jt < 2; ++jt) {
            if (jt > rt) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int col = 8 * j + 2 * q + e;
                  const int cj = TILE * jt + col;
                  const int row = i0 + 8 * i;
                  const float w = cj <= row && (jt < rt || j <= 2 * warp + 1)
                                      ? sf[jt][4 * j + 2 * i + e] *
                                            expf(cum[row] - cum[cj]) * dth[cj]
                                      : 0.f;
                  wst[(warp * 16 + gq + 8 * i) * (TILE + 4) + col] = w;
                }
              }
            }
            __syncwarp();
            simt_nn<PT>(acc, wst, TILE + 4,
                        reinterpret_cast<const float*>(sm + ox) +
                            jt * TILE * (PT + 4),
                        PT + 4, TILE, warp, gq, q);
            __syncwarp();
          }
        }
        // + d X
        const float dh = a.d[h];
#pragma unroll
        for (int j = 0; j < PT / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = i0 + 8 * i;
            float2 xv;
            if constexpr (BF) {
              xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                  sm + ox + swz(lp, row, j) + 4 * q));
            } else {
              xv = *reinterpret_cast<const float2*>(
                  sm + ox + (row * (PT + 4) + 8 * j + 2 * q) * 4);
            }
            acc[4 * j + 2 * i] += dh * xv.x;
            acc[4 * j + 2 * i + 1] += dh * xv.y;
          }
        }
      }
      T* yg = static_cast<T*>(a.y) + ((ll)bi * a.seq + s0) * a.heads * a.p +
              (ll)h * a.p + p0;
      const ll y_ss = (ll)a.heads * a.p;
      if constexpr (BF) {
        __syncthreads();  // every row tile is done reading the state tile
        if (my_out) {
#pragma unroll
          for (int j = 0; j < PT / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              *reinterpret_cast<uint32_t*>(sm + ot + swz(lp, i0 + 8 * i, j) +
                                           4 * q) =
                  hopper::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
        __syncthreads();
        // y in 16-byte stores: 8 columns of one row a thread
        const bool y16 = a.p % 8 == 0;
        for (int i = threadIdx.x; i < rows * (PT / 8); i += blockDim.x) {
          const int r = i / (PT / 8), c8 = i - r * (PT / 8);
          const int nv = min(8, pc - 8 * c8);
          if (nv <= 0) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(sm + ot + swz(lp, r, c8));
          bf16* dst = yg + r * y_ss + 8 * c8;
          if (nv == 8 && y16) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const bf16* vs = reinterpret_cast<const bf16*>(&v);
            for (int e = 0; e < nv; ++e) dst[e] = vs[e];
          }
        }
      } else if (my_out) {
#pragma unroll
        for (int j = 0; j < PT / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = i0 + 8 * i;
            const int col = 8 * j + 2 * q;
            if (row < rows && col < pc)
              *reinterpret_cast<float2*>(yg + row * y_ss + col) =
                  make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
      }
    }

    // ---- the chunk-local state (B * u)^T X: to `local` (STATE), or the
    // final state exp(total) init + (B * u)^T X (BOTH) ----------------------
    if (sta) {
      if constexpr (BF) {
        __syncthreads();  // the staged y has left (T is reused)
        split_ux<PT>(sm, ox, ot, u_s, lp);
        hopper::fence_proxy_async();
        __syncthreads();
      }
      const ll hoff =
          (a.mode == MODE_STATE ? (((ll)bi * a.nc + k) * a.heads + h)
                                : ((ll)bi * a.heads + h)) * a.n * a.p + p0;
      const float et = expf(total);
      for (int nt = wg; nt < n_nt; nt += a.nwg) {
        float acc[NR];
        if constexpr (BF)
          local_wgmma<PT>(acc, su + lay.b + nt * lp * 128, su + ox, su + ot,
                          lp, (rows + 15) / 16);
        else
          simt_state<PT>(acc,
                         reinterpret_cast<const float*>(sm + lay.b) + nt * TILE,
                         np + 4, u_s, reinterpret_cast<const float*>(sm + ox),
                         PT + 4, rows, a.n - nt * TILE, tw);
#pragma unroll
        for (int r = 0; r < NR; r += 2) {
          int n, col;
          frag_coord<BF, PT>(r, tw, n, col);
          n += nt * TILE;
          if (n >= a.n || col >= pc) continue;
          const ll o = hoff + (ll)n * a.p + col;
          float v0 = acc[r], v1 = acc[r + 1];
          if (a.mode == MODE_STATE) {
            store2(a.local + o, v0, v1);
            continue;
          }
          if (a.init != nullptr) {
            const float2 s = *reinterpret_cast<const float2*>(a.init + o);
            v0 = et * s.x + v0;
            v1 = et * s.y + v1;
          }
          store2(a.state + o, v0, v1);
        }
      }
      if (a.mode == MODE_STATE && pti == 0 && threadIdx.x == 0)
        a.total[((ll)bi * a.nc + k) * a.heads + h] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// the ordered pass over the chunk states
// ---------------------------------------------------------------------------


__device__ __forceinline__ void store4(float* p, float4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::
                   "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
               : "memory");
}
__device__ __forceinline__ void store4(bf16* p, float4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;\n" ::"l"(p),
               "r"(hopper::pack_bf16(v.x, v.y)), "r"(hopper::pack_bf16(v.z, v.w)),
               "l"(pol)
               : "memory");
}

// one thread per 4 elements of one (b, h) state: s_in[k] = state, then
// state = exp(total_k) state + local_k, for k in chunk order -- the
// sequential kernel's update, the same operations in the same order for
// each element
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_pass(const float* __restrict__ local, const float* __restrict__ total,
             const float* __restrict__ init, T* __restrict__ s_in,
             float* __restrict__ state, int nc, int heads, int np4) {
  const int bh = blockIdx.y;
  const int bi = bh / heads, h = bh - bi * heads;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= np4) return;
  const ll sz = (ll)np4 * 4;
  float4 st = init != nullptr
                  ? reinterpret_cast<const float4*>(init + bh * sz)[e]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  const uint64_t drop = l2_drop();
  for (int k = 0; k < nc; ++k) {
    const ll hk = ((ll)bi * nc + k) * heads + h;
    const float4 l = load4_drop(local + hk * sz + 4 * (ll)e, drop);
    const float et = expf(total[hk]);
    store4(s_in + hk * sz + 4 * (ll)e, st, drop);
    st.x = et * st.x + l.x;
    st.y = et * st.y + l.y;
    st.z = et * st.z + l.z;
    st.w = et * st.w + l.w;
  }
  reinterpret_cast<float4*>(state + bh * sz)[e] = st;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int PT>
cudaError_t launch_chunks(Args a, const Maps& tm, int batch, int mode,
                          cudaStream_t st) {
  a.mode = mode;
  a.nwg = n_wg(mode, a.lp, a.n);
  const Layout lay = make_layout<T>(mode, a.lp, a.np, PT, a.ht, a.nwg);
  if (lay.bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = hopper::set_smem((const void*)ssd_chunks<T, PT>, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  const ll blocks = (ll)batch * a.nc * a.n_ht * a.n_pt;
  ssd_chunks<T, PT><<<(unsigned)blocks, a.nwg * WG, lay.bytes, st>>>(a, tm);
  return cudaGetLastError();
}

// the tensor maps of a bf16 call whose chunk fills its tiles (a multiple
// of 64 rows: past-the-chunk rows are never in a box) and whose views TMA
// can describe; false leaves the call on the cp.async fill
bool make_maps(Maps* m, const Args& a, int batch) {
  if (a.chunk % TILE) return false;
  const ll xd[4] = {a.p, a.seq, a.heads, batch};
  const ll xs[3] = {a.x_ss, a.x_sh, a.x_sb};
  const ll bd[4] = {a.n, a.seq, a.groups, batch};
  const ll bs[3] = {a.b_ss, a.b_sg, a.b_sb};
  const ll cs[3] = {a.c_ss, a.c_sg, a.c_sb};
  const ll sd[3] = {a.p, a.n, (ll)batch * a.nc * a.heads};
  const ll ss[2] = {a.p, (ll)a.n * a.p};
  return hopper::map_bf16(&m->x, a.x, 4, xd, xs, a.lp) &&
         hopper::map_bf16(&m->b, a.b, 4, bd, bs, a.lp) &&
         hopper::map_bf16(&m->c, a.c, 4, bd, cs, a.lp) &&
         (a.nc == 1 || hopper::map_bf16(&m->s, a.s_in, 3, sd, ss, a.np));
}

template <typename T, int PT>
cudaError_t run(Args a, int batch, cudaStream_t st) {
  Maps tm;
  a.tma = sizeof(T) == 2 && make_maps(&tm, a, batch);
  if (a.nc == 1) return launch_chunks<T, PT>(a, tm, batch, MODE_BOTH, st);
  cudaError_t e = launch_chunks<T, PT>(a, tm, batch, MODE_STATE, st);
  if (e != cudaSuccess) return e;
  const int np4 = a.n * a.p / 4;
  const dim3 grid((np4 + 255) / 256, batch * a.heads);
  ssd_pass<T><<<grid, 256, 0, st>>>(a.local, a.total, a.init,
                                    static_cast<T*>(a.s_in), a.state, a.nc,
                                    a.heads, np4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_chunks<T, PT>(a, tm, batch, MODE_OUT, st);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

// Shared memory of one block of ssd_chunks in `mode` (1 state, 2 out, 3
// both), as the launch lays it out (ops.ssd_plan plans by it).  dtype
// 0 = float32, 1 = bfloat16.
extern "C" int repro_ssd_smem_bytes(int dtype, int mode, int chunk, int n,
                                    int pt, int ht) {
  const int lp = round_up(chunk, TILE);
  const int np = dtype == 1 ? round_up(n, 16) : n;
  const int nwg = n_wg(mode, lp, n);
  return dtype == 1 ? make_layout<bf16>(mode, lp, np, pt, ht, nwg).bytes
                    : make_layout<float>(mode, lp, np, pt, ht, nwg).bytes;
}

// dtype of x/B/C/y and s_in: 0 = float32, 1 = bfloat16.  dt, a, d, init,
// state, local and total are float32.  ht heads and pt (32 or 64) columns
// of P a block.  A call of one chunk is one launch (MODE_BOTH); of more,
// three: the chunk-local states into local (B, nc, H, N, P) and total
// (B, nc, H), the ordered pass into s_in (B, nc, H, N, P) and the final
// state, then the outputs -- all three scratch.  Requires chunk <= 128,
// n % 8 == 0, p % 4 == 0 and heads % groups == 0 (the wrapper checks).
// `aligned`: x, b and c have base addresses and strides that are multiples
// of 16 bytes (cp.async fill; otherwise element fill).  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int repro_ssd_fwd(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* init, void* y, void* state,
    void* local, void* s_in, void* total, int batch, int seq, int heads,
    int groups, int n, int p, int chunk, int ht, int pt, int aligned,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || n % 8 || p % 4 || groups < 1 ||
      heads % groups || ht < 1 || (pt != 32 && pt != 64) || batch < 1 ||
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
  args.y = y;
  args.state = static_cast<float*>(state);
  args.local = static_cast<float*>(local);
  args.s_in = s_in;
  args.total = static_cast<float*>(total);
  args.mode = 0;
  args.seq = seq;
  args.heads = heads;
  args.groups = groups;
  args.n = n;
  args.p = p;
  args.chunk = chunk;
  args.nc = (seq + chunk - 1) / chunk;
  args.lp = round_up(chunk, TILE);
  args.np = dtype == 1 ? round_up(n, 16) : n;
  args.hpg = heads / groups;
  args.ht = ht < args.hpg ? ht : args.hpg;
  args.tpg = (args.hpg + args.ht - 1) / args.ht;
  args.n_ht = groups * args.tpg;
  args.n_pt = (p + pt - 1) / pt;
  args.nwg = 0;
  args.aligned = aligned;
  args.tma = 0;
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
  if (args.nc > 1 && (!local || !s_in || !total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = pt == 64 ? run<float, 64>(args, batch, st) : run<float, 32>(args, batch, st);
  else if (dtype == 1)
    err = pt == 64 ? run<bf16, 64>(args, batch, st) : run<bf16, 32>(args, batch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
