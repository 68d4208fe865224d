// GEMM main loops shared by the port's matmul kernels, for sm_90a: the
// collective-matmul hop and ring kernels (cc_matmul.cu) and the DLA matmul
// (matmul.cu) run every product through one of the two paths below.
//
// A path computes one output tile, (x @ w)[m0 : m0 + BM, n0 : n0 + BN] with
// fp32 sums, and hands each in-range element to the caller's epilogue
// functor `epi(gm, gn, v)` (the hop kernels: "acc + v -> fp32"; the DLA:
// "act(v + bias) -> TO").
// Operands: x (M, K) with row stride sxm (a batch is the caller's offset),
// w (K, N) with row stride swk, both with unit column stride.  Ragged M, N
// and K are masked in the kernel: out-of-range elements load as zero and
// are not stored.  `vec`: every row of x and w starts 16-byte aligned, so
// the tiles are filled by 16-byte asynchronous copies; else by L2-only
// scalar loads into the same tiles, so the same sums.  All fills read
// through L2 only (cp.async.cg, ld.global.cg).
//
// bf16 x bf16 -- WgmmaPath (tensor cores):
//  * one or two warpgroups (128 threads each, 64 output rows each) a
//    BM x BN output tile, fp32 accumulators in registers, wgmma
//    m64nBNk16 with both operands in shared memory: x K-major, w (K, N)
//    read in place as an MN-major B operand; two warpgroups share w's tile;
//  * x and w tiles of 64-deep K land in a ring of shared-memory stages:
//    all but two in flight while one multiplies and the products of the
//    one before retire.  Tiles use the 128-byte swizzle (hopper.cuh).
//    Given TMA tensor maps (`tm`: the hop kernels and the DLA, when rows
//    are 16-byte aligned) one thread issues a stage's boxes and an
//    mbarrier a stage counts the bytes (out-of-range rows and columns
//    arrive as zeros); else every thread issues 16-byte cp.async.cg copies
//    (8 threads copy one 128-byte line, zero-filled past the edge by the
//    copy's source size), or 2-byte loads for unaligned rows;
//  * the epilogue reads straight from the accumulator registers;
//  * every output element is summed over K in the same order (64-deep
//    stages, k16 steps in order) whatever the tile shape or the fill.
//  Tile shape (with_bf16_path): 128 x 128 with 4 stages (128 KB) when
//  that still gives about a block for every SM (B ceil(M/128) ceil(N/128)
//  >= 96); else 64 x 64 with 6 stages.  No split-K.
//
// any other mix of fp32 and bf16 -- SimtPath (fp32 FMAs on the CUDA cores,
// full fp32: tf32 products would keep ~3 decimal digits, and the
// reference's fp32 dot is held at 1e-5):
//  * G k-groups a block, each with its own partial of the block's BM x BN
//    outputs: 8 x 8 of them a thread (8 rows BM/8 apart, 8 columns), so a
//    block has G BM BN / 64 threads.  A stage holds 8 G rows of K, in
//    units of 4; group g multiplies units g and g + G.  Per 4 k a thread
//    makes 8 loads of x (4 k of one row each) and 8 of w (2 a k) for 256
//    FMAs;
//  * stages are filled by 16-byte cp.async.cg copies into a ring of four,
//    three in flight; bf16 operands land as bf16 (cp.async cannot convert)
//    and are widened as they are read into registers.  The x tile keeps
//    rows of K (copied as they lie) at a pitch 32 bytes past their width
//    (for fp32 2 mod 8 16-byte slots), so the 4 rows and 2 groups a warp
//    reads at once fall in distinct banks; the w tile is (k, n);
//  * the partials meet in shared memory and are added in group order,
//    ((p0 + p1) + p2) + ..., each p_g a chain of fmaf over its k in
//    increasing order.  G is 8 for a K of DEEP_K or more, else 4: an
//    output's sum order depends on K alone, not on the tile shape, the
//    fill or which kernel runs it (no split of K across blocks);
//  * the epilogue walks the tile row by row, neighbouring threads on
//    neighbouring columns (coalesced loads of an accumulator and stores),
//    unrolled so that its loads are in flight together.
//  What bounds it: the CUDA cores' 67 TFLOP/s at the TP edges (the q edge,
//  2 x 256 x 2560 @ 2560 x 640 fp32 x bf16, 0.025 ms), where cuBLAS's
//  fp32 GEMM takes about twice that; this loop reaches ~40-50% of it,
//  held back by its small output tiles (few blocks at the q edge, operands
//  streamed from L2 at ~11-21 flop a byte).
//  Tile shape (with_f32_path): below DEEP_K 32 x 64 (4 groups, 128
//  threads), or 64 x 64 (256 threads) when 132 to 264 such tiles fill one
//  or two whole waves; at DEEP_K or more 32 x 64 (256 threads) when there
//  are 2 x 132 such tiles or more, else 32 x 32 (128 threads: the q edge's
//  160 tiles of 32 x 64 would leave SMs with one block beside SMs with
//  two).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace gemm {

using bf16 = __nv_bfloat16;
using ll = long long;

// out[gm][gn] = (acc ? acc[gm][gn] : 0) + v, fp32 (the hop kernel, in
// the reference's order: arrived + dot)
struct AddStore {
  const float* acc;
  ll sam;
  float* out;
  ll som;
  __device__ __forceinline__ void operator()(int gm, int gn, float v) const {
    if (acc != nullptr) v = acc[(ll)gm * sam + gn] + v;
    out[(ll)gm * som + gn] = v;
  }
};

// ---------------------------------------------------------------------------
// host side: operand alignment and TMA tensor maps
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

// rows of x (B, M, K) and w (K, N), elements of ex and ew bytes, all start
// 16-byte aligned
inline bool rows_aligned(const void* x, const void* w, int B, ll sxb, ll sxm,
                         ll swk, int ex, int ew) {
  return aligned16(x) && aligned16(w) && sxm * ex % 16 == 0 &&
         swk * ew % 16 == 0 && (B == 1 || sxb * ex % 16 == 0);
}

// bf16 operands as TMA tensor maps (rows 16-byte aligned)
struct TmaMaps {
  CUtensorMap x;   // (K, M, B): boxes of 64 x BM x 1
  CUtensorMap w;   // (N, K): boxes of 64 x 64
};

inline bool map_operands(TmaMaps* tm, const void* x, const void* w, int B,
                         int M, int N, int K, ll sxb, ll sxm, ll swk,
                         int bm) {
  const ll xd[3] = {K, M, B}, xs[2] = {sxm, sxb};
  const ll wd[2] = {N, K}, ws[1] = {swk};
  return hopper::map_bf16(&tm->x, x, 3, xd, xs, bm) &&
         hopper::map_bf16(&tm->w, w, 2, wd, ws, 64);
}

// ---------------------------------------------------------------------------
// bf16 x bf16 tensor-core main loop: wgmma, a ring of TMA / cp.async stages
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int STAGES_>
struct WgmmaPath {
  using TX = bf16;
  using TW = bf16;
  static constexpr bool TMA = true;      // takes tensor maps when given
  static constexpr int BM = BM_;         // 64 rows a warpgroup
  static constexpr int BN = BN_;
  static constexpr int BK = 64;          // K depth of a stage
  static constexpr int STAGES = STAGES_;
  static constexpr int WG = BM / 64;     // warpgroups; they share w's tile
  static constexpr int THREADS = 128 * WG;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES);
  using MMA = hopper::Wgmma<BN>;
  static_assert(BM % 64 == 0 && STAGES >= 3, "tile shape");

  // 8 bf16 from p, those at index >= n read as zero (2-byte loads: the
  // fill of operands whose rows are not 16-byte aligned)
  __device__ static uint4 ld8(const bf16* p, int n) {
    unsigned short h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      h[e] = e < n ? __ldcg(reinterpret_cast<const unsigned short*>(p) + e)
                   : (unsigned short)0;
    return make_uint4(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16,
                      h[4] | (unsigned)h[5] << 16, h[6] | (unsigned)h[7] << 16);
  }

  // one 16-byte chunk of `valid` elements (0..8) from p into shared `dst`
  __device__ static void chunk(uint32_t dst, const bf16* p, int valid,
                               bool vec) {
    if (vec) {
      hopper::cp_async16(dst, p, 2 * valid);
    } else {
      const uint4 u = ld8(p, valid);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                   : "memory");
    }
  }

  static constexpr int UA = BM * BK / 8 / THREADS;   // x chunks a thread
  static constexpr int UB = BK * BN / 8 / THREADS;   // w chunks a thread

  // this thread's chunks of every stage, fixed for a tile: where each
  // starts at k = 0 and how much of it is in range (computed once, so a
  // stage costs a few instructions a chunk)
  struct Chunks {
    const bf16* a[UA];   // x row (clamped into range) at its column chunk
    const bf16* b[UB];   // w row r of the stage at its column chunk
    int a_row_ok;        // bit u: row of x chunk u < M
    int b_cols[UB];      // valid columns of w chunk u (0..8)
  };

  __device__ static void chunks(Chunks& c, const bf16* x, ll sxm,
                                const bf16* w, ll swk, int M, int N, int m0,
                                int n0) {
    c.a_row_ok = 0;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      int r, c8;
      hopper::tile_chunk<BK>(threadIdx.x + u * THREADS, r, c8);
      const int gm = m0 + r;
      if (gm < M) c.a_row_ok |= 1 << u;
      c.a[u] = x + (ll)min(gm, M - 1) * sxm + 8 * c8;
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      int r, c8;
      hopper::tile_chunk<BN>(threadIdx.x + u * THREADS, r, c8);
      const int gn = n0 + 8 * c8;
      c.b_cols[u] = max(0, min(8, N - gn));
      c.b[u] = w + (ll)r * swk + min(gn, N - 1);
    }
  }

  // K tile kt of x (K-major) and of w (N contiguous) into the stage at s_a
  __device__ static void load_stage(uint32_t s_a, const Chunks& c, ll swk,
                                    int K, int kt, bool vec) {
    const int k0 = kt * BK;
    const bool full = k0 + BK <= K;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int i = threadIdx.x + u * THREADS;
      int r, c8;
      hopper::tile_chunk<BK>(i, r, c8);
      int valid = 0;
      if (c.a_row_ok >> u & 1)
        valid = full ? 8 : max(0, min(8, K - k0 - 8 * c8));
      chunk(s_a + hopper::swz_offset<BM>(r, c8), c.a[u] + (valid ? k0 : 0),
            valid, vec);
    }
    const uint32_t s_b = s_a + A_BYTES;
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int i = threadIdx.x + u * THREADS;
      int r, c8;
      hopper::tile_chunk<BN>(i, r, c8);
      const int valid = full || k0 + r < K ? c.b_cols[u] : 0;
      chunk(s_b + hopper::swz_offset<BK>(r, c8),
            c.b[u] + (valid ? (ll)k0 * swk : 0), valid, vec);
    }
  }

  // the tile at (m0, n0), each in-range element through epi.  The stages
  // are filled by TMA from the maps `tm` (batch `b` of x) when given, else
  // by cp.async.
  template <class Epi>
  __device__ static void tile(const bf16* __restrict__ x, ll sxm,
                              const bf16* __restrict__ w, ll swk, int M,
                              int N, int K, int m0, int n0, bool vec,
                              unsigned char* smem, Epi epi,
                              const TmaMaps* tm = nullptr, int b = 0) {
    __shared__ __align__(8) uint64_t bars[STAGES];   // TMA: one a stage
    const uint32_t base = hopper::align1024(hopper::smem_u32(smem));
    const uint32_t bar0 = hopper::smem_u32(bars);
    constexpr int STAGE = A_BYTES + B_BYTES;
    constexpr int AHEAD = STAGES - 2;   // tiles in flight beyond this one
    const int wg = threadIdx.x / 128;   // this warpgroup's 64 rows of x
    const int nk = (K + BK - 1) / BK;
    Chunks c;
    chunks(c, x, sxm, w, swk, M, N, m0, n0);
    // K tile t into its stage: one thread's TMA boxes, or every thread's
    // 16-byte copies (a commit group a tile)
    auto fill = [&](int t) {
      const uint32_t s_a = base + (t % STAGES) * STAGE;
      if (tm == nullptr) {
        load_stage(s_a, c, swk, K, t, vec);
      } else if (threadIdx.x == 0) {
        const uint32_t bar = bar0 + 8 * (t % STAGES);
        hopper::mbar_expect_tx(bar, STAGE);
        hopper::tma_load_3d(s_a, &tm->x, bar, t * BK, m0, b);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          hopper::tma_load_2d(s_a + A_BYTES + a * BK * 128, &tm->w, bar,
                              n0 + 64 * a, t * BK);
      }
    };
    if (tm != nullptr && threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) hopper::mbar_init(bar0 + 8 * s, 1);
      hopper::mbar_init_fence();
    }
    __syncthreads();   // the previous tile's stages are no longer read
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      if (s < nk) fill(s);
      hopper::cp_async_commit();
    }
    float d[MMA::REGS];
#pragma unroll
    for (int r = 0; r < MMA::REGS; ++r) d[r] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      if (tm != nullptr) {
        hopper::mbar_wait(bar0 + 8 * (kt % STAGES), kt / STAGES & 1);
      } else {
        hopper::cp_async_wait<AHEAD - 1>();
        hopper::fence_proxy_async();
      }
      // stage kt landed for every thread, and every warp is past the wait
      // that retired the products of tile kt - 2, whose stage is refilled
      __syncthreads();
      const int nt = kt + AHEAD;
      if (nt < nk) fill(nt);
      hopper::cp_async_commit();
      const uint32_t s_a = base + (kt % STAGES) * STAGE;
      hopper::fence_regs(d);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        MMA::template ss<0, 1>(
            d, hopper::desc_k_major<BM>(s_a + wg * 64 * BK * 2, ks),
            hopper::desc_mn_major<BK>(s_a + A_BYTES, ks), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // tile kt - 1 retired; tile kt runs on
      hopper::fence_regs(d);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d);
    hopper::cp_async_wait<0>();
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + 8 * j + 2 * (lane % 4) + e;
          if (gn < N) epi(gm, gn, d[4 * j + 2 * i + e]);
        }
    }
  }
};

// ---------------------------------------------------------------------------
// fp32 CUDA-core main loop: any mix of fp32 / bf16 operands
// ---------------------------------------------------------------------------

// 4 consecutive values at shared memory p (one 16-byte load of fp32, two
// 4-byte loads of bf16), widened to fp32
__device__ __forceinline__ void lds4(float* v, const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void lds4(float* v, const bf16* p) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t u = q[e];
    v[2 * e] = __uint_as_float(u << 16);
    v[2 * e + 1] = __uint_as_float(u & 0xffff0000u);
  }
}

template <int BM_, int BN_, int GROUPS_, typename TX_, typename TW_,
          int STAGES_ = 4>
struct SimtPath {
  using TX = TX_;
  using TW = TW_;
  static constexpr bool TMA = false;
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  // group g of a stage takes its 4-k units g and g + GROUPS
  static constexpr int GROUPS = GROUPS_;
  static constexpr int BK = 8 * GROUPS;    // K depth of a stage
  static constexpr int STAGES = STAGES_;
  static constexpr int TX_N = BN / 8;      // threads of a group along N
  static constexpr int GT = BM / 8 * TX_N;   // threads of a group
  static constexpr int THREADS = GROUPS * GT;
  static constexpr int EX = sizeof(TX), EW = sizeof(TW);
  // bytes a row of x's tile (fp32: 2 mod 8 16-byte slots), so that the 4
  // rows x 2 groups a warp reads at once fall in distinct banks
  static constexpr int A_PITCH = BK * EX + 32;
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr int B_PITCH = BN * EW;        // bytes a k row of w's
  static constexpr int STAGE = A_BYTES + BK * B_PITCH;
  static constexpr int R_PITCH = BN + 4;         // floats a partial's row
  static constexpr int R_BYTES = GROUPS * BM * R_PITCH * 4;
  static constexpr int SMEM = STAGES * STAGE > R_BYTES ? STAGES * STAGE
                                                       : R_BYTES;
  static constexpr int AX = 16 / EX;             // elements a 16-byte chunk
  static constexpr int AW = 16 / EW;
  static constexpr int CX = BK / AX;             // x chunks a row
  static constexpr int CW = BN / AW;             // w chunks a k row
  static constexpr int NA = BM * CX, NB = BK * CW;   // chunks a stage
  static constexpr int UA = (NA + THREADS - 1) / THREADS;   // a thread
  static constexpr int UB = (NB + THREADS - 1) / THREADS;
  static_assert(BM % 8 == 0 && BN % 16 == 0 && GT % 16 == 0 &&
                    BM * BN % THREADS == 0 && STAGES >= 2,
                "tile shape");

  // column j (0..7) of a thread's 8: for fp32 w two runs of 4 (BN / 2
  // apart), for bf16 one run of 8 -- a warp's 16-byte loads of a w row
  // then fall in distinct banks
  __device__ static int col(int tx, int j) {
    return EW == 4 ? (j < 4 ? 4 * tx + j : BN / 2 + 4 * tx + j - 4)
                   : 8 * tx + j;
  }

  // elements [0, n) of 16 bytes at p (L2-only loads), the rest zero
  __device__ static uint4 ld16(const float* p, int n) {
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = e < n ? __float_as_uint(__ldcg(p + e)) : 0u;
    return make_uint4(h[0], h[1], h[2], h[3]);
  }
  __device__ static uint4 ld16(const bf16* p, int n) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned short h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = e < n ? __ldcg(q + e) : (unsigned short)0;
    return make_uint4(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16,
                      h[4] | (unsigned)h[5] << 16, h[6] | (unsigned)h[7] << 16);
  }

  // `valid` elements (0..16 / sizeof(T)) from p into the 16 bytes at dst
  template <typename T>
  __device__ static void chunk(uint32_t dst, const T* p, int valid, bool vec) {
    if (vec) {
      hopper::cp_async16(dst, p, valid * (int)sizeof(T));
    } else {
      const uint4 u = ld16(p, valid);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                   : "memory");
    }
  }

  // this thread's chunks, fixed for a tile (see WgmmaPath::Chunks)
  struct Chunks {
    const TX* a[UA];     // x row (clamped into range), k 0 of its chunk
    const TW* b[UB];     // w row r of a stage at its column chunk
    int a_ok;            // bit u: row of x chunk u < M
    int b_cols[UB];      // valid columns of w chunk u
  };

  __device__ static void chunks(Chunks& c, const TX* x, ll sxm, const TW* w,
                                ll swk, int M, int N, int m0, int n0) {
    c.a_ok = 0;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int i = threadIdx.x + u * THREADS, r = min(i / CX, BM - 1);
      if (m0 + r < M) c.a_ok |= 1 << u;
      c.a[u] = x + (ll)min(m0 + r, M - 1) * sxm;
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int gn = n0 + i % CW * AW;
      c.b_cols[u] = max(0, min(AW, N - gn));
      c.b[u] = w + (ll)min(i / CW, BK - 1) * swk + min(gn, N - 1);
    }
  }

  // K rows [32 kt, 32 kt + 32) of x and w into the stage at s
  __device__ static void load_stage(uint32_t s, const Chunks& c, const TW* w,
                                    ll swk, int K, int kt, bool vec) {
    const int k0 = kt * BK;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int i = threadIdx.x + u * THREADS, r = i / CX, kc = i % CX * AX;
      if (NA % THREADS != 0 && i >= NA) break;
      const int valid =
          c.a_ok >> u & 1 ? max(0, min(AX, K - k0 - kc)) : 0;
      chunk(s + r * A_PITCH + kc * EX, valid ? c.a[u] + k0 + kc : c.a[u],
            valid, vec);
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int i = threadIdx.x + u * THREADS, r = i / CW;
      if (NB % THREADS != 0 && i >= NB) break;
      const int valid = k0 + r < K ? c.b_cols[u] : 0;
      chunk(s + A_BYTES + r * B_PITCH + i % CW * 16,
            valid ? c.b[u] + (ll)k0 * swk : w, valid, vec);
    }
  }

  // as WgmmaPath::tile (no tensor maps)
  template <class Epi>
  __device__ static void tile(const TX* __restrict__ x, ll sxm,
                              const TW* __restrict__ w, ll swk, int M,
                              int N, int K, int m0, int n0, bool vec,
                              unsigned char* smem, Epi epi,
                              const TmaMaps* /*tm*/ = nullptr,
                              int /*b*/ = 0) {
    const uint32_t base = hopper::smem_u32(smem);
    const int g = threadIdx.x / GT, t = threadIdx.x % GT;
    const int tx = t % TX_N, ty = t / TX_N;
    const int nk = (K + BK - 1) / BK;
    Chunks c;
    chunks(c, x, sxm, w, swk, M, N, m0, n0);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // this thread's x rows ty + BM/8 i and w columns col(tx, .), at this
    // group's first unit of a stage
    const unsigned char* a0 = smem + ty * A_PITCH + 4 * g * EX;
    const unsigned char* b0 = smem + A_BYTES + 4 * g * B_PITCH +
                              col(tx, 0) * EW;

    __syncthreads();   // the previous tile's epilogue no longer reads
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load_stage(base + s * STAGE, c, w, swk, K, s, vec);
      hopper::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      hopper::cp_async_wait<STAGES - 2>();
      // stage kt landed for every thread; every thread is done with the
      // stage of kt - 1, which is refilled now
      __syncthreads();
      const int nt = kt + STAGES - 1;
      if (nt < nk)
        load_stage(base + nt % STAGES * STAGE, c, w, swk, K, nt, vec);
      hopper::cp_async_commit();
      const int so = kt % STAGES * STAGE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // units g, g + GROUPS
        float a[8][4];   // the unit's 4 k of the thread's 8 rows
#pragma unroll
        for (int i = 0; i < 8; ++i)
          lds4(a[i], reinterpret_cast<const TX*>(
                         a0 + so + i * (BM / 8) * A_PITCH +
                         4 * GROUPS * h * EX));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned char* pb = b0 + so + (4 * GROUPS * h + q) * B_PITCH;
          float bv[8];
          lds4(bv, reinterpret_cast<const TW*>(pb));
          lds4(bv + 4, reinterpret_cast<const TW*>(
                             pb + (EW == 4 ? BN / 2 * 4 : 8)));
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i][q], bv[j], acc[i][j]);
        }
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();   // every thread is done with the stages
    // the four groups' partials, (group, row, col) fp32
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 4)
        *reinterpret_cast<float4*>(
            red + (g * BM + ty + BM / 8 * i) * R_PITCH + col(tx, j)) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]);
    __syncthreads();
#pragma unroll   // the accumulator loads of every element in flight
    for (int u = 0; u < BM * BN / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS, r = e / BN, cc = e % BN;
      const int gm = m0 + r, gn = n0 + cc;
      if (gm >= M || gn >= N) continue;
      const float* p = red + r * R_PITCH + cc;
      float v = p[0];
#pragma unroll
      for (int q = 1; q < GROUPS; ++q) v = v + p[q * BM * R_PITCH];
      epi(gm, gn, v);
    }
  }
};

// ---------------------------------------------------------------------------
// tile choice: the hop, ring and DLA kernels take the same tile for the
// same shape (and every tile shape sums in the same order)
// ---------------------------------------------------------------------------

constexpr int SMS = 132;   // H100 SXM; only the tile choice reads it
// 32 x 64 blocks of 8 groups (256 threads) from this many on
constexpr ll WIDE_TILES = 2 * SMS;

// the bf16 x bf16 path for B batches of an M x N output, passed to f as a
// value of its type
template <class F>
int with_bf16_path(int B, int M, int N, F f) {
  const ll tiles128 = (ll)B * ((M + 127) / 128) * ((N + 127) / 128);
  if (tiles128 >= 96) return f(WgmmaPath<128, 128, 4>{});
  return f(WgmmaPath<64, 64, 6>{});
}

// the fp32 path for operand types TX, TW.  The k-groups are set by K alone
// (and so is every output's sum order): a K of DEEP_K or more is split 8
// ways in stages of 64 -- parallelism for a small output (the q edge, 2 x
// 256 x 640 at K 2560) -- a shallower one 4 ways in stages of 32, which
// keeps more k a group between barriers.  The tile then follows the output.
constexpr int DEEP_K = 2048;

template <typename TX, typename TW, class F>
int with_f32_path(int B, int M, int N, int K, F f) {
  if (K < DEEP_K) {
    // 64 x 64 tiles (one 256-thread block an SM) halve the operand traffic
    // of an output; taken when they fill one or two whole waves of the
    // card, where 32 x 64's three blocks an SM would leave a thin last one
    // (the DLA's 1024^3: 256 tiles of 64 x 64; the o edge's 320 keep 32 x
    // 64)
    const ll t64 = (ll)B * ((M + 63) / 64) * ((N + 63) / 64);
    if (t64 >= SMS && t64 <= 2 * SMS)
      return f(SimtPath<64, 64, 4, TX, TW>{});
    return f(SimtPath<32, 64, 4, TX, TW>{});
  }
  const ll tiles = (ll)B * ((M + 31) / 32) * ((N + 63) / 64);
  if (tiles >= WIDE_TILES) return f(SimtPath<32, 64, 8, TX, TW>{});
  return f(SimtPath<32, 32, 8, TX, TW>{});
}

// the path for dtype codes dx, dw (0 fp32, 1 bf16); cudaErrorInvalidValue
// for any other code
template <class F>
int with_path(int dx, int dw, int B, int M, int N, int K, F f) {
  if (dx == 1 && dw == 1) return with_bf16_path(B, M, N, f);
  if (dx == 0 && dw == 0) return with_f32_path<float, float>(B, M, N, K, f);
  if (dx == 0 && dw == 1) return with_f32_path<float, bf16>(B, M, N, K, f);
  if (dx == 1 && dw == 0) return with_f32_path<bf16, float>(B, M, N, K, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gemm
