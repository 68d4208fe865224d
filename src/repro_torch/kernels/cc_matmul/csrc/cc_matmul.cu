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
// All five share one tiled GEMM body: a 64x64 output tile is computed into
// shared memory (the main loop), then the epilogue optionally adds an fp32
// accumulator (in the reference's order: arrived + dot) and stores.
//   * bf16 x bf16: nvcuda::wmma 16x16x16 fragments with fp32 accumulation,
//     4 warps (32x32 each), K in steps of 32 staged through shared memory;
//     no cp.async/TMA pipelining, no wgmma (later work);
//   * any other mix of fp32 and bf16 (the fp32 activations of the RS edges
//     and of the backward meet bf16 weights there): fp32 FMAs on the CUDA
//     cores, 256 threads (4x4 each), K in steps of 16, bf16 widened to
//     fp32 on the way into shared memory.
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
#include <mma.h>
#include <cstdio>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
using ull = unsigned long long;

constexpr int BM = 64;        // output rows per tile
constexpr int BN = 64;        // output columns per tile
constexpr int LDC = BN + 4;   // fp32 row pitch of the output staging tile

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
__device__ __forceinline__ bf16 ldh(const bf16* p) {
  if (CG)
    return __ushort_as_bfloat16(
        __ldcg(reinterpret_cast<const unsigned short*>(p)));
  return *p;
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core main loop: any mix of fp32 / bf16 operands
// ---------------------------------------------------------------------------

template <typename TX_, typename TW_>
struct FmaPath {
  using TX = TX_;
  using TW = TW_;
  static constexpr int THREADS = 256;   // 16 x 16, each owns a 4 x 4 patch
  static constexpr int FK = 16;         // K step

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
};

// ---------------------------------------------------------------------------
// bf16 x bf16 tensor-core main loop: wmma fragments, fp32 accumulation
// ---------------------------------------------------------------------------

struct WmmaPath {
  using TX = bf16;
  using TW = bf16;
  static constexpr int THREADS = 128;   // 4 warps, 2 x 2, each 32 x 32
  static constexpr int WK = 32;         // K step
  static constexpr int LDA = WK + 8;    // bf16 row pitch of the x tile
  static constexpr int LDB = BN + 8;    // bf16 row pitch of the w tile

  template <bool CG>
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
        As[r][kk] = (gm < M && gk < K) ? ldh<CG>(x + (ll)gm * sxm + gk) : zero;
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

// out[r][c] = (acc ? acc[r][c] : 0) + Cs[r][c] over the tile at (m0, n0);
// CG: the accumulator and the output are memory other blocks or ranks use
// while the kernel runs
template <int THREADS, bool CG>
__device__ __forceinline__ void epilogue(float (*Cs)[LDC],
                                         const float* acc, ll sam,
                                         float* out, ll som, int M, int N,
                                         int m0, int n0) {
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, cc = i % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= M || gn >= N) continue;
    float v = Cs[r][cc];
    if (acc != nullptr) v = ldf<CG>(acc + (ll)gm * sam + gn) + v;
    if (CG)
      __stcg(out + (ll)gm * som + gn, v);
    else
      out[(ll)gm * som + gn] = v;
  }
}

// ---------------------------------------------------------------------------
// the hop kernels: one output tile a block, batch on blockIdx.z
// ---------------------------------------------------------------------------

template <class Path, bool ACC>
__global__ void __launch_bounds__(Path::THREADS)
hop_gemm(const typename Path::TX* __restrict__ x,
         const typename Path::TW* __restrict__ w,
         const float* __restrict__ acc, float* __restrict__ out, int M,
         int N, int K, ll sxb, ll sxm, ll swk, ll sab, ll sam) {
  __shared__ __align__(128) float Cs[BM][LDC];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Path::template mainloop<false>(x + (ll)b * sxb, sxm, w, swk, M, N, K, m0,
                                 n0, Cs);
  __syncthreads();
  epilogue<Path::THREADS, false>(Cs, ACC ? acc + (ll)b * sab : nullptr, sam,
                                 out + (ll)b * M * N, N, M, N, m0, n0);
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
  Ring ring;
};

// all_gather(x) @ w over one ring direction (ag_matmul_ring_tpu): hop h
// multiplies the block of rank (rank - dir*h) mod n from slot h%2 while
// forwarding it into the next rank's slot (h+1)%2
template <class Path>
__global__ void __launch_bounds__(Path::THREADS) ag_ring(AgArgs a) {
  using TX = typename Path::TX;
  using TW = typename Path::TW;
  __shared__ __align__(128) float Cs[BM][LDC];
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

  const int mt = (a.b + BM - 1) / BM, nt = (a.N + BN - 1) / BN;
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
      const int bb = t / (mt * nt), m0 = (t / nt) % mt * BM,
                n0 = t % nt * BN;
      Path::template mainloop<true>(xs + (ll)bb * a.b * a.K, a.K,
                                    (const TW*)a.w, a.swk, a.b, a.N, a.K,
                                    m0, n0, Cs);
      __syncthreads();
      epilogue<Path::THREADS, false>(
          Cs, nullptr, 0, a.out + bb * a.sob + src * a.sos, a.som, a.b, a.N,
          m0, n0);
      __syncthreads();
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
  Ring ring;
};

// reduce_scatter(x @ w) over one ring direction (rs_matmul_ring_tpu):
// the fp32 accumulator rides the ring; at hop h it arrives in slot h%2
// and gets the local partial of row block (rank - dir*(h+1)) mod n added
template <class Path>
__global__ void __launch_bounds__(Path::THREADS) rs_ring(RsArgs a) {
  using TX = typename Path::TX;
  using TW = typename Path::TW;
  __shared__ __align__(128) float Cs[BM][LDC];
  const Ring& R = a.ring;
  const ll slot_bytes = (ll)a.B * a.b * a.N * 4;
  const ll ssb = (ll)a.b * a.N;   // slot batch stride (contiguous slot)
  const int mt = (a.b + BM - 1) / BM, nt = (a.N + BN - 1) / BN;
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
      const int bb = t / (mt * nt), m0 = (t / nt) % mt * BM,
                n0 = t % nt * BN;
      Path::template mainloop<false>(x + bb * a.sxb + row0 * a.sxm, a.sxm,
                                     (const TW*)a.w, a.swk, a.b, a.N, a.K,
                                     m0, n0, Cs);
      __syncthreads();
      if (hop > 0)
        block_wait(arrive_of(R.mine), R.arrive_base + per_hop * hop, R,
                   "an arrival");
      const float* acc = hop > 0 ? slot + bb * ssb : nullptr;
      if (last)
        epilogue<Path::THREADS, true>(Cs, acc, a.N, a.out + bb * a.sob,
                                      a.som, a.b, a.N, m0, n0);
      else
        epilogue<Path::THREADS, true>(Cs, acc, a.N, slot + bb * ssb, a.N,
                                      a.b, a.N, m0, n0);
      __syncthreads();
    }
    grid_sync(R.mine);
    if (blockIdx.x == 0 && threadIdx.x == 0)
      st_release(done_of(R.mine), R.done_base + hop + 1);
  }
}

// ---------------------------------------------------------------------------
// launchers; dtype codes of the wrapper: 0 fp32, 1 bf16
// ---------------------------------------------------------------------------

template <class Path, bool ACC>
int launch_hop(const void* x, const void* w, const float* acc, float* out,
               int B, int M, int N, int K, ll sxb, ll sxm, ll swk, ll sab,
               ll sam, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, B);
  hop_gemm<Path, ACC><<<grid, Path::THREADS, 0, stream>>>(
      (const typename Path::TX*)x, (const typename Path::TW*)w, acc, out, M,
      N, K, sxb, sxm, swk, sab, sam);
  return (int)cudaGetLastError();
}

template <bool ACC>
int hop(int dx, int dw, const void* x, const void* w, const float* acc,
        float* out, int B, int M, int N, int K, ll sxb, ll sxm, ll swk,
        ll sab, ll sam, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || K < 0 || B > 65535 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (dx == 1 && dw == 1)
    return launch_hop<WmmaPath, ACC>(x, w, acc, out, B, M, N, K, sxb, sxm,
                                     swk, sab, sam, stream);
  if (dx == 0 && dw == 0)
    return launch_hop<FmaPath<float, float>, ACC>(
        x, w, acc, out, B, M, N, K, sxb, sxm, swk, sab, sam, stream);
  if (dx == 0 && dw == 1)
    return launch_hop<FmaPath<float, bf16>, ACC>(
        x, w, acc, out, B, M, N, K, sxb, sxm, swk, sab, sam, stream);
  if (dx == 1 && dw == 0)
    return launch_hop<FmaPath<bf16, float>, ACC>(
        x, w, acc, out, B, M, N, K, sxb, sxm, swk, sab, sam, stream);
  return (int)cudaErrorInvalidValue;
}

// a cooperative launch of one ring kernel: as many blocks as there are
// output tiles of a hop, at most as many as the card holds at once
template <class Args>
int launch_ring(void (*kernel)(Args), int threads, int tiles, Args args,
                int* grid_out, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return (int)e;
  int grid = sms * per_sm;
  if (tiles < grid) grid = tiles;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  *grid_out = grid;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(threads), params, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Path>
int ag_path(AgArgs a, int* grid_out, cudaStream_t stream) {
  const int tiles = a.B * ((a.b + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  return launch_ring(ag_ring<Path>, Path::THREADS, tiles, a, grid_out,
                     stream);
}

template <class Path>
int rs_path(RsArgs a, int* grid_out, cudaStream_t stream) {
  const int tiles = a.B * ((a.b + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  return launch_ring(rs_ring<Path>, Path::THREADS, tiles, a, grid_out,
                     stream);
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
           Ring{(char*)mine, (char*)next, slot_stride, done_base,
                arrive_base, timeout_ns, n, rank, dir}};
  if (B <= 0 || b <= 0 || N <= 0 || K < 0 || !ring_ok(a.ring) ||
      (ll)B * b * K * elem_bytes(dx) > slot_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dx == 1 && dw == 1) return ag_path<WmmaPath>(a, grid_out, s);
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
           Ring{(char*)mine, (char*)next, slot_stride, done_base,
                arrive_base, timeout_ns, n, rank, dir}};
  if (B <= 0 || b <= 0 || N <= 0 || K < 0 || !ring_ok(a.ring) ||
      (ll)B * b * N * 4 > slot_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dx == 1 && dw == 1) return rs_path<WmmaPath>(a, grid_out, s);
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
