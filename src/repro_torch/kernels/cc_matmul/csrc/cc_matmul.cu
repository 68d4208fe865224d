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
// All five run one output tile at a time through a main loop of the shared
// GEMM header (kernels/include/gemm.cuh), chosen by the operand types and
// the shape (gemm::with_path): bf16 x bf16 (the forward AG edges) on the
// tensor cores (WgmmaPath: wgmma fed by TMA in the hop kernels, by
// cp.async.cg in the ring kernels), any other mix of fp32 and bf16 (the fp32
// activations of the RS edges and of the backward meet bf16 weights there)
// on the CUDA cores in full fp32 (SimtPath: 8 x 8 outputs a thread, four
// k-groups a block, a cp.async.cg ring).  The epilogue adds an optional fp32
// accumulator in the reference's order (arrived + dot) and stores fp32
// (gemm::AddStore).  Every output element is summed over K in an order
// that depends on K alone, and the hop and ring kernels take the same tile
// for the same (B, rows, N): the emulated schedule and the in-kernel ring
// agree bit for bit.
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

#include "gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
using ull = unsigned long long;
using gemm::AddStore;
using gemm::NoWait;
using gemm::TmaMaps;

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
  Path::template tile<false>(
      x + (ll)b * sxb, sxm, w, swk, M, N, K, m0, n0, vec != 0, dsmem,
      NoWait{},
      AddStore<false>{ACC ? acc + (ll)b * sab : nullptr, sam,
                      out + (ll)b * M * N, N},
      use_tma ? &tm : nullptr, b);
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
__global__ void __launch_bounds__(Path::THREADS)
ag_ring(AgArgs a) {
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
      Path::template tile<true>(
          xs + (ll)bb * a.b * a.K, a.K, (const TW*)a.w, a.swk, a.b, a.N,
          a.K, m0, n0, a.vec != 0, dsmem, NoWait{},
          AddStore<false>{nullptr, 0, a.out + bb * a.sob + src * a.sos,
                          a.som});
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
__global__ void __launch_bounds__(Path::THREADS)
rs_ring(RsArgs a) {
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
      Path::template tile<false>(
          x + bb * a.sxb + row0 * a.sxm, a.sxm, (const TW*)a.w, a.swk, a.b,
          a.N, a.K, m0, n0, a.vec != 0, dsmem, arrival,
          AddStore<true>{acc, a.N,
                         last ? a.out + bb * a.sob : slot + bb * ssb,
                         last ? a.som : a.N});
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

template <class Path, bool ACC>
int launch_hop(const void* x, const void* w, const float* acc, float* out,
               int B, int M, int N, int K, ll sxb, ll sxm, ll swk, ll sab,
               ll sam, cudaStream_t stream) {
  if ((M + Path::BM - 1) / Path::BM > 65535)   // grid.y
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      hopper::set_smem((const void*)hop_gemm<Path, ACC>, Path::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int vec = gemm::rows_aligned(x, w, B, sxb, sxm, swk,
                                     sizeof(typename Path::TX),
                                     sizeof(typename Path::TW));
  // bf16 operands with aligned rows go by TMA (the cooperative ring
  // kernels keep the per-thread copies)
  TmaMaps tm{};
  int use_tma = 0;
  if (Path::TMA && vec && K > 0) {
    if (!gemm::map_operands(&tm, x, w, B, M, N, K, sxb, sxm, swk, Path::BM))
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
  if (B <= 0 || M <= 0 || N <= 0 || K < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return gemm::with_path(dx, dw, B, M, N, K, [&](auto path) {
    return launch_hop<decltype(path), ACC>(x, w, acc, out, B, M, N, K, sxb,
                                           sxm, swk, sab, sam, stream);
  });
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
  if (tiles < 0) return (int)cudaErrorInvalidValue;
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

// the output tiles of one hop (B batches of rows x N), or -1 when they
// overflow the kernels' int tile index
template <class Path>
int ring_tiles(int B, int rows, int N) {
  const ll t = (ll)B * ((rows + Path::BM - 1) / Path::BM) *
               ((N + Path::BN - 1) / Path::BN);
  return t > 0x7fffffffLL ? -1 : (int)t;
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
           gemm::rows_aligned(mine, w, B, (ll)b * K, K, swk, elem_bytes(dx),
                              elem_bytes(dw)),
           Ring{(char*)mine, (char*)next, slot_stride, done_base,
                arrive_base, timeout_ns, n, rank, dir}};
  if (B <= 0 || b <= 0 || N <= 0 || K < 0 || !ring_ok(a.ring) ||
      (ll)B * b * K * elem_bytes(dx) > slot_stride)
    return (int)cudaErrorInvalidValue;
  return gemm::with_path(dx, dw, B, b, N, K, [&](auto path) {
    using Path = decltype(path);
    return launch_ring<Path>(ag_ring<Path>, ring_tiles<Path>(B, b, N), a,
                             grid_out, (cudaStream_t)stream);
  });
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
           gemm::rows_aligned(x, w, B, sxb, sxm, swk, elem_bytes(dx),
                              elem_bytes(dw)),
           Ring{(char*)mine, (char*)next, slot_stride, done_base,
                arrive_base, timeout_ns, n, rank, dir}};
  if (B <= 0 || b <= 0 || N <= 0 || K < 0 || !ring_ok(a.ring) ||
      (ll)B * b * N * 4 > slot_stride)
    return (int)cudaErrorInvalidValue;
  return gemm::with_path(dx, dw, B, b, N, K, [&](auto path) {
    using Path = decltype(path);
    return launch_ring<Path>(rs_ring<Path>, ring_tiles<Path>(B, b, N), a,
                             grid_out, (cudaStream_t)stream);
  });
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
