// Fused collective matmul kernels, for sm_90a.
//
// Replaces the five Pallas kernels of src/repro/kernels/cc_matmul/kernel.py.
//
// The hop kernels of the emulated schedule (the hop itself runs outside
// the kernel, over the group's wire):
//   matmul_tile        (kernel.py:65)   out = x @ w
//   consume_matmul     (kernel.py:84)   out = scratch[slot] @ w
//   consume_matmul_acc (kernel.py:106)  out = scratch[slot] + x @ w
// and the whole ring in one kernel, one ring direction a launch:
//   ag_matmul_ring     (kernel.py:170)  out = all_gather(x) @ w
//   rs_matmul_ring     (kernel.py:223)  out = reduce_scatter(x @ w)
//
// All five run one output tile at a time through a main loop chosen by the
// operand types (Path::tile), whose epilogue optionally adds an fp32
// accumulator (in the reference's order: arrived + dot) and stores fp32.
//
// bf16 x bf16 (the forward AG edges) -- WgmmaPath:
//  * one or two warpgroups (128 threads each, 64 output rows each) a
//    BM x BN output tile, fp32 accumulators in registers, wgmma
//    m64nBNk16 with both operands in shared memory: x K-major, w (K, N)
//    read in place as an MN-major B operand; two warpgroups share w's tile;
//  * x and w tiles of 64-deep K land in a ring of shared-memory stages:
//    all but two in flight while one multiplies and the products of the
//    one before retire.  Tiles use the 128-byte swizzle (hopper.cuh).  The
//    hop kernels fill them by TMA when the rows of x and w are 16-byte
//    aligned (one thread issues a stage's boxes, an mbarrier a stage counts
//    the bytes; out-of-range rows and columns arrive as zeros).  The ring
//    kernels fill them by 16-byte cp.async.cg copies (L2 only: their slots
//    are written by the neighbour rank while they run; 8 threads copy one
//    128-byte line, zero-filled past the edge by the copy's source size),
//    and rows that are not 16-byte aligned (a ragged K that is also the
//    row stride) are staged by 2-byte loads.  All three fills give the same
//    tile, so the same sums;
//  * the epilogue stores straight from the accumulator registers (no
//    staging tile);
//  * every output element is summed over K in the same order (64-deep
//    stages, k16 steps in order) whatever the tile shape or the fill, and
//    the hop and ring kernels take the same tile for the same (B, rows,
//    N): the emulated schedule and the in-kernel ring agree bit for bit.
//  What bounds these edges: the q edge (B 2, 256 rows a hop, N 640, K
//  2560) is 1.7 GFLOP on 4.6 MB of operands, the up|gate edge (N 3456) 9.1
//  GFLOP on 20.3 MB -- by bytes and by operations ~2 and ~9 us; what
//  limits the kernel is how fast each SM streams its operands from L2,
//  which is why the hop kernels take TMA (per-thread copies reached about
//  half its rate on this card).
//  Tile shape (with_bf16_path): 128 x 128 with 4 stages (128 KB) when
//  that still gives ~a block for every SM (B ceil(M/128) ceil(N/128) >= 96;
//  up|gate: 108 blocks, each streaming 1.3 MB, 141 MB in all against 283
//  MB for 432 blocks of 64 x 64); else 64 x 64 with 6 stages (q edge: 80
//  blocks of 0.66 MB; 128-wide tiles would leave 112 of 132 SMs idle).
//  No split-K: it would change the sum order.
// Any other mix of fp32 and bf16 (the fp32 activations of the RS edges and
// of the backward meet bf16 weights there) -- FmaPath: fp32 FMAs on the
// CUDA cores, 256 threads (4x4 each) a 64 x 64 tile, K in steps of 16,
// bf16 widened to fp32 on the way into shared memory, the tile staged in
// shared memory for the epilogue.
// Operands: x (B, M, K) with element strides (sxb, sxm, 1), w (K, N) with
// row stride swk and unit column stride; the accumulator and the output
// are fp32 with strides (batch, row, 1).  Ragged M, N and K are masked in
// the kernel (out-of-range elements load as zero and are not stored).
//
// The ring kernels: the rank processes of the TP group share the card,
// and each maps its ring neighbour's channel (device memory exported with
// CUDA IPC).  A channel is a header of flags and two slots.  Each launch
// is cooperative (every block resident) and walks the ring as the TPU
// kernel does: at hop h the block in slot h%2 is forwarded into the next
// rank's other slot (the remote DMA, here stores into the mapped memory)
// while this rank's blocks multiply it.  Two counters stand in for the
// DMA semaphores:
//   arrive  (receiver's header) — the sender's blocks each add 1 once
//           their share of a forwarded slot is written; the receiver
//           waits for the count its host expects for this hop;
//   done    (owner's header) — the last hop this rank has finished; a
//           sender writes a slot of the next rank only once the next
//           rank is done with the hop that last read that slot.
// Both only grow (the host passes the bases for the call), so neither
// is ever reset.  Waits poll with acquire loads; the data a wait guards
// is read with L2-only loads (ld.global.cg), never through L1.  A wait
// that lasts longer than the caller's timeout traps: the launch fails
// instead of hanging the card.
// Every C entry point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdio>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
using ull = unsigned long long;

// ---------------------------------------------------------------------------
// loads: plain, or L2-only for memory another block or rank writes while
// this kernel runs
// ---------------------------------------------------------------------------

template <bool CG>
__device__ __forceinline__ float ldf(const float* p) {
  return CG ? __ldcg(p) : *p;
}
template <bool CG>
__device__ __forceinline__ float ldf(const bf16* p) {
  if (CG) {
    unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
  return __bfloat162float(*p);
}

template <bool CG>
__device__ __forceinline__ void stf(float* p, float v) {
  if (CG)
    __stcg(p, v);
  else
    *p = v;
}

// no wait between a tile's main loop and its epilogue
struct NoWait {
  __device__ void operator()() const {}
};

// a hop kernel's bf16 operands as TMA tensor maps (rows 16-byte aligned)
struct TmaMaps {
  CUtensorMap x;   // (K, M, B): boxes of 64 x BM x 1
  CUtensorMap w;   // (N, K): boxes of 64 x 64
};

// ---------------------------------------------------------------------------
// fp32 CUDA-core main loop: any mix of fp32 / bf16 operands
// ---------------------------------------------------------------------------

template <typename TX_, typename TW_>
struct FmaPath {
  using TX = TX_;
  using TW = TW_;
  static constexpr int BM = 64;         // output rows per tile
  static constexpr int BN = 64;         // output columns per tile
  static constexpr int LDC = BN + 4;    // fp32 row pitch of the staging tile
  static constexpr int THREADS = 256;   // 16 x 16, each owns a 4 x 4 patch
  static constexpr int FK = 16;         // K step
  static constexpr int SMEM = 0;        // dynamic shared memory bytes

  // Cs[r][c] = sum_k x[m0 + r][k] * w[k][n0 + c] for the tile at (m0, n0)
  template <bool CG>
  __device__ static void mainloop(const TX* __restrict__ x, ll sxm,
                                  const TW* __restrict__ w, ll swk, int M,
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
        As[kk][r] = (gm < M && gk < K) ? ldf<CG>(x + (ll)gm * sxm + gk) : 0.f;
      }
      for (int i = tid; i < FK * BN; i += THREADS) {
        const int kk = i / BN, cc = i % BN;
        const int gk = k0 + kk, gn = n0 + cc;
        Bs[kk][cc] = (gk < K && gn < N) ? ldf<false>(w + (ll)gk * swk + gn)
                                        : 0.f;
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

  // out[r][c] = (acc ? acc[r][c] : 0) + (x @ w)[r][c] over the tile at
  // (m0, n0); `wait` runs between the main loop and the epilogue.  CG_X:
  // x is memory others write during the kernel; CG_OUT: so are the
  // accumulator and the output.
  template <bool CG_X, bool CG_OUT, class Wait>
  __device__ static void tile(const TX* __restrict__ x, ll sxm,
                              const TW* __restrict__ w, ll swk, int M,
                              int N, int K, int m0, int n0, bool /*vec*/,
                              const float* acc, ll sam, float* out, ll som,
                              unsigned char* /*smem*/, Wait wait,
                              const TmaMaps* /*tm*/ = nullptr, int /*b*/ = 0) {
    __shared__ __align__(128) float Cs[BM][LDC];
    mainloop<CG_X>(x, sxm, w, swk, M, N, K, m0, n0, Cs);
    __syncthreads();
    wait();
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = i / BN, cc = i % BN;
      const int gm = m0 + r, gn = n0 + cc;
      if (gm >= M || gn >= N) continue;
      float v = Cs[r][cc];
      if (acc != nullptr) v = ldf<CG_OUT>(acc + (ll)gm * sam + gn) + v;
      stf<CG_OUT>(out + (ll)gm * som + gn, v);
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// bf16 x bf16 tensor-core main loop: wgmma, a 4-stage cp.async ring
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int STAGES_>
struct WgmmaPath {
  using TX = bf16;
  using TW = bf16;
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

  // as FmaPath::tile.  The stages are filled by TMA from the maps `tm`
  // (batch `b` of x) when given, else by cp.async; `vec`: every row of x
  // and w starts 16-byte aligned.  Both fills give the same tiles.
  template <bool CG_X, bool CG_OUT, class Wait>
  __device__ static void tile(const bf16* __restrict__ x, ll sxm,
                              const bf16* __restrict__ w, ll swk, int M,
                              int N, int K, int m0, int n0, bool vec,
                              const float* acc, ll sam, float* out, ll som,
                              unsigned char* smem, Wait wait,
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
    wait();
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
          if (gn >= N) continue;
          float v = d[4 * j + 2 * i + e];
          if (acc != nullptr) v = ldf<CG_OUT>(acc + (ll)gm * sam + gn) + v;
          stf<CG_OUT>(out + (ll)gm * som + gn, v);
        }
    }
  }
};

// the bf16 tile for B batches of an M x N output, passed to f as a value
// of its path type (see the note at the top).  The hop and ring kernels
// take the same tile for the same shape, so their sums agree bit for bit.
template <class F>
int with_bf16_path(int B, int M, int N, F f) {
  const ll tiles128 = (ll)B * ((M + 127) / 128) * ((N + 127) / 128);
  if (tiles128 >= 96) return f(WgmmaPath<128, 128, 4>{});
  return f(WgmmaPath<64, 64, 6>{});
}

// ---------------------------------------------------------------------------
// the hop kernels: one output tile a block, batch on blockIdx.z
// ---------------------------------------------------------------------------

template <class Path, bool ACC>
__global__ void __launch_bounds__(Path::THREADS)
hop_gemm(const typename Path::TX* __restrict__ x,
         const typename Path::TW* __restrict__ w,
         const float* __restrict__ acc, float* __restrict__ out, int M,
         int N, int K, ll sxb, ll sxm, ll swk, ll sab, ll sam, int vec,
         const __grid_constant__ TmaMaps tm, int use_tma) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * Path::BM, n0 = blockIdx.x * Path::BN;
  Path::template tile<false, false>(
      x + (ll)b * sxb, sxm, w, swk, M, N, K, m0, n0, vec != 0,
      ACC ? acc + (ll)b * sab : nullptr, sam, out + (ll)b * M * N, N, dsmem,
      NoWait{}, use_tma ? &tm : nullptr, b);
}

// ---------------------------------------------------------------------------
// the ring kernels
// ---------------------------------------------------------------------------

constexpr ll HEADER = 256;   // channel header bytes; the slots follow

// channel header: [0] arrive (u64), [8] done (u64), [64] grid barrier
// count (u32), [68] grid barrier generation (u32)
struct Ring {
  char* mine;      // this rank's channel
  char* next;      // the next rank's channel (mapped), in this direction
  ll slot_stride;  // bytes between the two slots
  ull done_base;   // `done` before this call (calls on the channel × n)
  ull arrive_base; // `arrive` before this call
  ull timeout_ns;  // the longest a wait may last before the kernel traps
  int n, rank, dir;
};

__device__ __forceinline__ ull* arrive_of(char* ch) { return (ull*)ch; }
__device__ __forceinline__ ull* done_of(char* ch) { return (ull*)(ch + 8); }
__device__ __forceinline__ char* slot_of(char* ch, ll stride, int s) {
  return ch + HEADER + s * stride;
}

__device__ __forceinline__ ull ld_acquire(const ull* p) {
  ull v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(ull* p, ull v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ ull global_ns() {
  ull t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// thread 0 polls until *p >= target, then the block goes on
__device__ void block_wait(const ull* p, ull target, const Ring& R,
                           const char* what) {
  if (threadIdx.x == 0) {
    const ull t0 = global_ns();
    while (ld_acquire(p) < target) {
      if (global_ns() - t0 > R.timeout_ns) {
        printf("cc_matmul ring: rank %d block %d waited %llu ns for %s "
               "(%llu < %llu)\n", R.rank, blockIdx.x, R.timeout_ns, what,
               ld_acquire(p), target);
        __trap();
      }
      __nanosleep(256);
    }
    __threadfence();
  }
  __syncthreads();
}

// every block of the (cooperative, all-resident) grid meets here
__device__ void grid_sync(char* ch) {
  unsigned* count = (unsigned*)(ch + 64);
  volatile unsigned* gen = (volatile unsigned*)(ch + 68);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = *gen;
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd((unsigned*)gen, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// this block's share of a slot forwarded into the next rank's channel,
// then one count on the next rank's `arrive`
template <int THREADS>
__device__ void forward_slot(const char* src, char* dst, ll bytes,
                             ull* next_arrive) {
  const int4* s = (const int4*)src;
  int4* d = (int4*)dst;
  const ll n16 = (bytes + 15) / 16;
  for (ll i = (ll)blockIdx.x * THREADS + threadIdx.x; i < n16;
       i += (ll)gridDim.x * THREADS)
    __stcg(d + i, __ldcg(s + i));
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd_system(next_arrive, 1ull);
}

__device__ __forceinline__ int mod(int a, int n) { return ((a % n) + n) % n; }

struct AgArgs {
  const void* x;   // (B, b, K), strides (sxb, sxm, 1)
  const void* w;   // (K, N), row stride swk
  float* out;      // (B, n, b, N) view, strides (sob, sos, som, 1)
  int B, b, N, K;
  ll sxb, sxm, swk, sob, sos, som;
  int vec;         // rows of the slot and of w start 16-byte aligned
  Ring ring;
};

// all_gather(x) @ w over one ring direction (ag_matmul_ring_tpu): hop h
// multiplies the block of rank (rank - dir*h) mod n from slot h%2 while
// forwarding it into the next rank's slot (h+1)%2
template <class Path>
__global__ void __launch_bounds__(Path::THREADS) ag_ring(AgArgs a) {
  using TX = typename Path::TX;
  using TW = typename Path::TW;
  extern __shared__ __align__(128) unsigned char dsmem[];
  const Ring& R = a.ring;
  const ll slot_elems = (ll)a.B * a.b * a.K;
  const ll slot_bytes = slot_elems * (ll)sizeof(TX);

  // seed slot 0 with the resident block (contiguous (B, b, K))
  TX* s0 = (TX*)slot_of(R.mine, R.slot_stride, 0);
  const TX* x = (const TX*)a.x;
  for (ll i = (ll)blockIdx.x * Path::THREADS + threadIdx.x; i < slot_elems;
       i += (ll)gridDim.x * Path::THREADS) {
    const ll bb = i / ((ll)a.b * a.K), r = (i / a.K) % a.b, k = i % a.K;
    s0[i] = x[bb * a.sxb + r * a.sxm + k];
  }
  grid_sync(R.mine);

  const int mt = (a.b + Path::BM - 1) / Path::BM;
  const int nt = (a.N + Path::BN - 1) / Path::BN;
  const int tiles = a.B * mt * nt;
  const ull per_hop = gridDim.x;
  for (int hop = 0; hop < R.n; ++hop) {
    const int cur = hop & 1;
    char* slot = slot_of(R.mine, R.slot_stride, cur);
    if (hop > 0)
      block_wait(arrive_of(R.mine), R.arrive_base + per_hop * hop, R,
                 "an arrival");
    if (hop + 1 < R.n) {
      // the next rank last read its slot (hop+1)%2 at its hop - 1
      block_wait(done_of(R.next), R.done_base + hop, R, "the next rank");
      forward_slot<Path::THREADS>(slot, slot_of(R.next, R.slot_stride,
                                                cur ^ 1),
                                  slot_bytes, arrive_of(R.next));
    }
    const int src = mod(R.rank - R.dir * hop, R.n);
    const TX* xs = (const TX*)slot;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int bb = t / (mt * nt), m0 = (t / nt) % mt * Path::BM,
                n0 = t % nt * Path::BN;
      Path::template tile<true, false>(
          xs + (ll)bb * a.b * a.K, a.K, (const TW*)a.w, a.swk, a.b, a.N,
          a.K, m0, n0, a.vec != 0, nullptr, 0,
          a.out + bb * a.sob + src * a.sos, a.som, dsmem, NoWait{});
    }
    grid_sync(R.mine);
    if (blockIdx.x == 0 && threadIdx.x == 0)
      st_release(done_of(R.mine), R.done_base + hop + 1);
  }
}

struct RsArgs {
  const void* x;   // (B, n*b, K), strides (sxb, sxm, 1)
  const void* w;   // (K, N), row stride swk
  float* out;      // (B, b, N) view, strides (sob, som, 1)
  int B, b, N, K;
  ll sxb, sxm, swk, sob, som;
  int vec;         // rows of x and w start 16-byte aligned
  Ring ring;
};

// reduce_scatter(x @ w) over one ring direction (rs_matmul_ring_tpu):
// the fp32 accumulator rides the ring; at hop h it arrives in slot h%2
// and gets the local partial of row block (rank - dir*(h+1)) mod n added
template <class Path>
__global__ void __launch_bounds__(Path::THREADS) rs_ring(RsArgs a) {
  using TX = typename Path::TX;
  using TW = typename Path::TW;
  extern __shared__ __align__(128) unsigned char dsmem[];
  const Ring& R = a.ring;
  const ll slot_bytes = (ll)a.B * a.b * a.N * 4;
  const ll ssb = (ll)a.b * a.N;   // slot batch stride (contiguous slot)
  const int mt = (a.b + Path::BM - 1) / Path::BM;
  const int nt = (a.N + Path::BN - 1) / Path::BN;
  const int tiles = a.B * mt * nt;
  const ull per_hop = gridDim.x;
  const TX* x = (const TX*)a.x;

  for (int hop = 0; hop < R.n; ++hop) {
    const int cur = hop & 1;
    float* slot = (float*)slot_of(R.mine, R.slot_stride, cur);
    if (hop > 0) {
      // the accumulator of hop - 1 rides on; the next rank last read its
      // slot hop%2 at its hop - 1
      block_wait(done_of(R.next), R.done_base + hop, R, "the next rank");
      forward_slot<Path::THREADS>(
          slot_of(R.mine, R.slot_stride, cur ^ 1),
          slot_of(R.next, R.slot_stride, cur), slot_bytes,
          arrive_of(R.next));
    }
    const ll row0 = (ll)mod(R.rank - R.dir * (hop + 1), R.n) * a.b;
    const bool last = hop + 1 == R.n;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int bb = t / (mt * nt), m0 = (t / nt) % mt * Path::BM,
                n0 = t % nt * Path::BN;
      // the local partial is computed before the arrival is waited for
      auto arrival = [&]() {
        if (hop > 0)
          block_wait(arrive_of(R.mine), R.arrive_base + per_hop * hop, R,
                     "an arrival");
      };
      const float* acc = hop > 0 ? slot + bb * ssb : nullptr;
      Path::template tile<false, true>(
          x + bb * a.sxb + row0 * a.sxm, a.sxm, (const TW*)a.w, a.swk, a.b,
          a.N, a.K, m0, n0, a.vec != 0, acc, a.N,
          last ? a.out + bb * a.sob : slot + bb * ssb, last ? a.som : a.N,
          dsmem, arrival);
    }
    grid_sync(R.mine);
    if (blockIdx.x == 0 && threadIdx.x == 0)
      st_release(done_of(R.mine), R.done_base + hop + 1);
  }
}

// ---------------------------------------------------------------------------
// launchers; dtype codes of the wrapper: 0 fp32, 1 bf16
// ---------------------------------------------------------------------------

// the card's SM count (a cooperative ring launch is sized by it)
int sm_count() {
  static int sms = 0;   // the port runs on one model of card
  int dev = 0;
  if (sms == 0 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 0;
  return sms;
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

// rows of x (B, M, K) and w (K, N) all start 16-byte aligned (bf16)
bool rows_aligned(const void* x, const void* w, int B, ll sxb, ll sxm,
                  ll swk) {
  return aligned16(x) && aligned16(w) && sxm % 8 == 0 && swk % 8 == 0 &&
         (B == 1 || sxb % 8 == 0);
}

template <class Path, bool ACC>
int launch_hop(const void* x, const void* w, const float* acc, float* out,
               int B, int M, int N, int K, ll sxb, ll sxm, ll swk, ll sab,
               ll sam, int vec, cudaStream_t stream) {
  cudaError_t e =
      hopper::set_smem((const void*)hop_gemm<Path, ACC>, Path::SMEM);
  if (e != cudaSuccess) return (int)e;
  // bf16 operands with aligned rows go by TMA (the cooperative ring
  // kernels keep the per-thread copies)
  TmaMaps tm{};
  int use_tma = 0;
  if (Path::SMEM > 0 && vec && K > 0) {
    const ll xd[3] = {K, M, B}, xs[2] = {sxm, sxb};
    const ll wd[2] = {N, K}, ws[1] = {swk};
    if (!hopper::map_bf16(&tm.x, x, 3, xd, xs, Path::BM) ||
        !hopper::map_bf16(&tm.w, w, 2, wd, ws, 64))
      return (int)cudaErrorInvalidValue;
    use_tma = 1;
  }
  const dim3 grid((N + Path::BN - 1) / Path::BN,
                  (M + Path::BM - 1) / Path::BM, B);
  hop_gemm<Path, ACC><<<grid, Path::THREADS, Path::SMEM, stream>>>(
      (const typename Path::TX*)x, (const typename Path::TW*)w, acc, out, M,
      N, K, sxb, sxm, swk, sab, sam, vec, tm, use_tma);
  return (int)cudaGetLastError();
}

template <bool ACC>
int hop(int dx, int dw, const void* x, const void* w, const float* acc,
        float* out, int B, int M, int N, int K, ll sxb, ll sxm, ll swk,
        ll sab, ll sam, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || K < 0 || B > 65535 ||
      (M + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (dx == 1 && dw == 1) {
    const int vec = rows_aligned(x, w, B, sxb, sxm, swk);
    return with_bf16_path(B, M, N, [&](auto path) {
      return launch_hop<decltype(path), ACC>(x, w, acc, out, B, M, N, K, sxb,
                                             sxm, swk, sab, sam, vec, stream);
    });
  }
  if (dx == 0 && dw == 0)
    return launch_hop<FmaPath<float, float>, ACC>(
        x, w, acc, out, B, M, N, K, sxb, sxm, swk, sab, sam, 0, stream);
  if (dx == 0 && dw == 1)
    return launch_hop<FmaPath<float, bf16>, ACC>(
        x, w, acc, out, B, M, N, K, sxb, sxm, swk, sab, sam, 0, stream);
  if (dx == 1 && dw == 0)
    return launch_hop<FmaPath<bf16, float>, ACC>(
        x, w, acc, out, B, M, N, K, sxb, sxm, swk, sab, sam, 0, stream);
  return (int)cudaErrorInvalidValue;
}

// a cooperative launch of one ring kernel: as many blocks as there are
// output tiles of a hop, at most as many as the card holds at once (the
// occupancy query and the launch pass the same dynamic shared memory)
template <class Path, class Args>
int launch_ring(void (*kernel)(Args), int tiles, Args args, int* grid_out,
                cudaStream_t stream) {
  int per_sm = 0;
  const int sms = sm_count();
  cudaError_t e = sms > 0 ? hopper::set_smem((const void*)kernel, Path::SMEM)
                          : cudaErrorInvalidDevice;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, Path::THREADS, Path::SMEM);
  if (e != cudaSuccess) return (int)e;
  int grid = sms * per_sm;
  if (tiles < grid) grid = tiles;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  *grid_out = grid;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(Path::THREADS), params, Path::SMEM,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Path>
int ag_path(AgArgs a, int* grid_out, cudaStream_t stream) {
  const int tiles = a.B * ((a.b + Path::BM - 1) / Path::BM) *
                    ((a.N + Path::BN - 1) / Path::BN);
  return launch_ring<Path>(ag_ring<Path>, tiles, a, grid_out, stream);
}

template <class Path>
int rs_path(RsArgs a, int* grid_out, cudaStream_t stream) {
  const int tiles = a.B * ((a.b + Path::BM - 1) / Path::BM) *
                    ((a.N + Path::BN - 1) / Path::BN);
  return launch_ring<Path>(rs_ring<Path>, tiles, a, grid_out, stream);
}

ll elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

bool ring_ok(const Ring& r) {
  return r.n >= 2 && r.rank >= 0 && r.rank < r.n &&
         (r.dir == 1 || r.dir == -1) && r.mine != nullptr &&
         r.next != nullptr && r.slot_stride % 256 == 0;
}

}  // namespace

extern "C" {

// out = x @ w  (the resident block's tile, RS hop 0)
int repro_cc_matmul_tile(int dx, int dw, const void* x, const void* w,
                         float* out, int B, int M, int N, int K, ll sxb,
                         ll sxm, ll swk, void* stream) {
  return hop<false>(dx, dw, x, w, nullptr, out, B, M, N, K, sxb, sxm, swk, 0,
                    0, (cudaStream_t)stream);
}

// out = scratch[slot] @ w  (AG hop consume; the slot is s_slot elements
// past the scratch's base)
int repro_cc_consume_matmul(int dx, int dw, const void* scratch, int slot,
                            const void* w, float* out, int B, int M, int N,
                            int K, ll s_slot, ll sxb, ll sxm, ll swk,
                            void* stream) {
  const char* xs = (const char*)scratch + (ll)slot * s_slot * elem_bytes(dx);
  return hop<false>(dx, dw, xs, w, nullptr, out, B, M, N, K, sxb, sxm, swk,
                    0, 0, (cudaStream_t)stream);
}

// out = scratch[slot] + x @ w  (RS hop consume: the arrived fp32
// accumulator plus the local partial)
int repro_cc_consume_matmul_acc(int dx, int dw, const float* scratch,
                                int slot, const void* x, const void* w,
                                float* out, int B, int M, int N, int K,
                                ll s_slot, ll sab, ll sam, ll sxb, ll sxm,
                                ll swk, void* stream) {
  return hop<true>(dx, dw, x, w, scratch + (ll)slot * s_slot, out, B, M, N,
                   K, sxb, sxm, swk, sab, sam, (cudaStream_t)stream);
}

// out[:, src] = x_src @ w for every rank src of the ring: x (B, b, K);
// out a (B, n, b, N) fp32 view.  `grid_out` receives the grid size: the
// next rank's `arrive` grows by it for every slot forwarded.
int repro_cc_ag_matmul_ring(int dx, int dw, const void* x, const void* w,
                            float* out, int B, int b, int N, int K, ll sxb,
                            ll sxm, ll swk, ll sob, ll sos, ll som,
                            void* mine, void* next, ll slot_stride, int n,
                            int rank, int dir, ull done_base,
                            ull arrive_base, ull timeout_ns, int* grid_out,
                            void* stream) {
  AgArgs a{x, w, out, B, b, N, K, sxb, sxm, swk, sob, sos, som,
           // the slot holds x contiguous: rows K elements apart
           rows_aligned(mine, w, B, (ll)b * K, K, swk),
           Ring{(char*)mine, (char*)next, slot_stride, done_base,
                arrive_base, timeout_ns, n, rank, dir}};
  if (B <= 0 || b <= 0 || N <= 0 || K < 0 || !ring_ok(a.ring) ||
      (ll)B * b * K * elem_bytes(dx) > slot_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dx == 1 && dw == 1)
    return with_bf16_path(B, b, N, [&](auto path) {
      return ag_path<decltype(path)>(a, grid_out, s);
    });
  if (dx == 0 && dw == 0) return ag_path<FmaPath<float, float>>(a, grid_out, s);
  if (dx == 0 && dw == 1) return ag_path<FmaPath<float, bf16>>(a, grid_out, s);
  if (dx == 1 && dw == 0) return ag_path<FmaPath<bf16, float>>(a, grid_out, s);
  return (int)cudaErrorInvalidValue;
}

// out = this rank's row block of sum over ranks of x @ w: x (B, n*b, K);
// out a (B, b, N) fp32 view
int repro_cc_rs_matmul_ring(int dx, int dw, const void* x, const void* w,
                            float* out, int B, int b, int N, int K, ll sxb,
                            ll sxm, ll swk, ll sob, ll som, void* mine,
                            void* next, ll slot_stride, int n, int rank,
                            int dir, ull done_base, ull arrive_base,
                            ull timeout_ns, int* grid_out, void* stream) {
  RsArgs a{x, w, out, B, b, N, K, sxb, sxm, swk, sob, som,
           rows_aligned(x, w, B, sxb, sxm, swk),
           Ring{(char*)mine, (char*)next, slot_stride, done_base,
                arrive_base, timeout_ns, n, rank, dir}};
  if (B <= 0 || b <= 0 || N <= 0 || K < 0 || !ring_ok(a.ring) ||
      (ll)B * b * N * 4 > slot_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dx == 1 && dw == 1)
    return with_bf16_path(B, b, N, [&](auto path) {
      return rs_path<decltype(path)>(a, grid_out, s);
    });
  if (dx == 0 && dw == 0) return rs_path<FmaPath<float, float>>(a, grid_out, s);
  if (dx == 0 && dw == 1) return rs_path<FmaPath<float, bf16>>(a, grid_out, s);
  if (dx == 1 && dw == 0) return rs_path<FmaPath<bf16, float>>(a, grid_out, s);
  return (int)cudaErrorInvalidValue;
}

// a zeroed channel of `bytes` this rank exports: its pointer, and the
// 64-byte IPC handle the ring neighbours open
int repro_cc_channel_alloc(ll bytes, void** ptr, unsigned char* handle) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, *ptr);
  if (e == cudaSuccess)
    for (int i = 0; i < (int)sizeof(h); ++i)
      handle[i] = (unsigned char)h.reserved[i];
  return (int)e;
}

// map a neighbour's channel from its handle
int repro_cc_channel_open(const unsigned char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  for (int i = 0; i < (int)sizeof(h); ++i) h.reserved[i] = (char)handle[i];
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int repro_cc_channel_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

int repro_cc_channel_free(void* ptr) { return (int)cudaFree(ptr); }

}  // extern "C"
