// Fused collective matmul kernels, for sm_90a.
//
// Replaces the five Pallas kernels of src/repro/kernels/cc_matmul/kernel.py.
//
// The hop kernels of the emulated schedule (the hop itself runs outside
// the kernel, over the group's wire):
//   matmul_tile        (kernel.py:65)   out = x @ w
//   consume_matmul     (kernel.py:84)   out = scratch[slot] @ w
//   consume_matmul_acc (kernel.py:106)  out = scratch[slot] + x @ w
// and the whole ring, one ring direction a call, as a stream-ordered
// sequence of those same hop products:
//   ag_matmul_ring     (kernel.py:170)  out = all_gather(x) @ w
//   rs_matmul_ring     (kernel.py:223)  out = reduce_scatter(x @ w)
//
// Every product runs one output tile a block through a main loop of the
// shared GEMM header (kernels/include/gemm.cuh), chosen by the operand
// types and the shape (gemm::with_path): bf16 x bf16 (the forward AG
// edges) on the tensor cores (WgmmaPath: wgmma fed by TMA when rows are
// 16-byte aligned), any other mix of fp32 and bf16 (the fp32 activations of
// the RS edges and of the backward meet bf16 weights there) on the CUDA
// cores in full fp32 (SimtPath: 8 x 8 outputs a thread, four or eight
// k-groups a block, a cp.async.cg ring).  The epilogue adds an optional
// fp32 accumulator in the reference's order (arrived + dot) and stores fp32
// (gemm::AddStore).  Every output element is summed over K in an order that
// depends on K alone, and the emulated schedule and the ring launch the
// same kernel for the same (B, rows, N): the two agree bit for bit.
// Operands: x (B, M, K) with element strides (sxb, sxm, 1), w (K, N) with
// row stride swk and unit column stride; the accumulator and the output
// are fp32 with strides (batch, row, 1).  Ragged M, N and K are masked in
// the kernel (out-of-range elements load as zero and are not stored).
//
// The ring: the rank processes of the TP group share the card, and each
// maps its next rank's channel (device memory exported with CUDA IPC).  A
// channel is a header of two 64-bit counters and two slots.  The host
// passes the call's plan (ring.py's ring_plan: the protocol is written
// there once), and run_plan below enqueues it as it stands on PyTorch's
// current stream: the n hop products (one hop_gemm launch each) and the
// n - 1 forwards (cudaMemcpyAsync device to device into the next rank's
// mapped slot: the copy engine moves it), each after the one before.  The
// two counters stand in for the TPU kernel's DMA semaphores:
//   arrive  (receiver's header) -- the number of slots forwarded into the
//           channel this call, written by the sender after its copy;
//   done    (owner's header) -- the hops this rank has finished (product,
//           and for AG the forward: every read of the hop's slot); a
//           sender copies into a slot of the next rank only once that
//           rank is done with the hop that last read it.
// Every hand-off between ranks is a wait the card's front end holds in
// stream order: cuStreamWaitValue64 (greater or equal) on a counter, and
// cuStreamWriteValue64 (with its memory barrier) after the copy or product
// it publishes.  No kernel spins: a rank whose neighbour is behind has no
// runnable work, so the card runs another rank's context.  Both counters
// only grow (the host passes the bases for the call), so neither is ever
// reset.  A wait has no timeout: a neighbour that never arrives leaves the
// stream waiting until its process goes (the rank pool's timeout kills
// the ranks, and their contexts with them).
// Every C entry point returns cudaGetLastError() (or the first error of an
// enqueued call; a driver error as streamops::DRIVER_ERROR + its CUresult).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"
#include "stream_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
using ull = unsigned long long;
using gemm::AddStore;
using gemm::TmaMaps;

// ---------------------------------------------------------------------------
// the hop kernel: one output tile a block, batch on blockIdx.z
// ---------------------------------------------------------------------------

template <class Path, bool ACC>
__global__ void __launch_bounds__(Path::THREADS)
hop_gemm(const typename Path::TX* __restrict__ x,
         const typename Path::TW* __restrict__ w,
         const float* __restrict__ acc, float* __restrict__ out, int M,
         int N, int K, ll sxb, ll sxm, ll swk, ll sab, ll sam, ll sob,
         ll som, int vec, const __grid_constant__ TmaMaps tm, int use_tma) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * Path::BM, n0 = blockIdx.x * Path::BN;
  Path::tile(x + (ll)b * sxb, sxm, w, swk, M, N, K, m0, n0, vec != 0,
             dsmem,
             AddStore{ACC ? acc + (ll)b * sab : nullptr, sam,
                      out + (ll)b * sob, som},
             use_tma ? &tm : nullptr, b);
}

// ---------------------------------------------------------------------------
// launchers; dtype codes of the wrapper: 0 fp32, 1 bf16
// ---------------------------------------------------------------------------

template <class Path, bool ACC>
int launch_hop(const void* x, const void* w, const float* acc, float* out,
               int B, int M, int N, int K, ll sxb, ll sxm, ll swk, ll sab,
               ll sam, ll sob, ll som, cudaStream_t stream) {
  if ((M + Path::BM - 1) / Path::BM > 65535)   // grid.y
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      hopper::set_smem((const void*)hop_gemm<Path, ACC>, Path::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int vec = gemm::rows_aligned(x, w, B, sxb, sxm, swk,
                                     sizeof(typename Path::TX),
                                     sizeof(typename Path::TW));
  // bf16 operands with aligned rows go by TMA
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
      N, K, sxb, sxm, swk, sab, sam, sob, som, vec, tm, use_tma);
  return (int)cudaGetLastError();
}

// one hop product: out (strides sob, som) = [acc +] x @ w
template <bool ACC>
int hop(int dx, int dw, const void* x, const void* w, const float* acc,
        float* out, int B, int M, int N, int K, ll sxb, ll sxm, ll swk,
        ll sab, ll sam, ll sob, ll som, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || K < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return gemm::with_path(dx, dw, B, M, N, K, [&](auto path) {
    return launch_hop<decltype(path), ACC>(x, w, acc, out, B, M, N, K, sxb,
                                           sxm, swk, sab, sam, sob, som,
                                           stream);
  });
}

ll elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

// ---------------------------------------------------------------------------
// the ring: a plan of ring.py run on the rank's stream
// ---------------------------------------------------------------------------

constexpr ll HEADER = 256;   // channel header bytes; the slots follow
// channel header: [0] arrive (u64), [8] done (u64)

// ring.py's codes
enum Kind { WAIT = 1, WRITE = 2, GEMM = 3, COPY = 4 };
enum Buf { NONE = -1, X = 0, SLOT0 = 1, SLOT1 = 2, RES = 3, OUT = 4 };
enum Counter { ARRIVE = 0, NEXT_DONE = 1, DONE = 2, NEXT_ARRIVE = 3 };
constexpr int FIELDS = 5;    // kind, a, b, c, d

// one ring call: AG x (B, b, K) strided, out (B, n, b, N) strides (sob,
// sos, som); RS x (B, n*b, K) strided, out (B, b, N) strides (sob, som),
// res a contiguous (B, b, N) fp32 accumulator
struct RingCall {
  bool ag;
  int dx, dw;
  const char* x;
  const void* w;
  float* out;
  float* res;
  int B, b, N, K, n;
  ll sxb, sxm, swk, sob, sos, som;
  char* mine;        // this rank's channel
  char* next;        // the next rank's channel (mapped), in this direction
  ll slot_stride;    // bytes between the two slots
  ull done_base;     // `done` before this call
  ull arrive_base;   // `arrive` before this call
};

char* slot_of(char* ch, ll stride, ll s) { return ch + HEADER + s * stride; }

// bytes a slot carries: AG a (B, b, K) block, RS a (B, b, N) fp32 sum
ll slot_bytes(const RingCall& c) {
  return c.ag ? (ll)c.B * c.b * c.K * elem_bytes(c.dx)
              : (ll)c.B * c.b * c.N * 4;
}

bool slot_buf(ll v) { return v == SLOT0 || v == SLOT1; }

// every operation's codes in range, before anything is enqueued (a call
// refused half way would leave the other ranks waiting)
bool plan_ok(const RingCall& c, const ll* plan, int n_ops) {
  for (int i = 0; i < n_ops; ++i) {
    const ll* o = plan + (ll)i * FIELDS;
    const ll a = o[1], b = o[2], acc = o[3], dst = o[4];
    switch (o[0]) {
      case WAIT:
        if ((a != ARRIVE && a != NEXT_DONE) || b < 0) return false;
        break;
      case WRITE:
        if ((a != DONE && a != NEXT_ARRIVE) || b < 0) return false;
        break;
      case GEMM:
        if (b < 0 || b >= c.n) return false;
        if (c.ag ? !((a == X || slot_buf(a)) && acc == NONE && dst == OUT)
                 : !(a == X && (acc == NONE || slot_buf(acc)) &&
                     (dst == OUT || dst == RES)))
          return false;
        break;
      case COPY:
        if (!(c.ag ? a == X || slot_buf(a) : a == RES) || b < 0 || b > 1)
          return false;
        break;
      default:
        return false;
    }
  }
  return true;
}

int run_gemm(const RingCall& c, const ll* o, cudaStream_t s) {
  if (c.ag) {
    const bool from_x = o[1] == X;
    const char* xs =
        from_x ? c.x : slot_of(c.mine, c.slot_stride, o[1] - SLOT0);
    const ll sb = from_x ? c.sxb : (ll)c.b * c.K, sm = from_x ? c.sxm : c.K;
    return hop<false>(c.dx, c.dw, xs, c.w, nullptr, c.out + o[2] * c.sos,
                      c.B, c.b, c.N, c.K, sb, sm, c.swk, 0, 0, c.sob, c.som,
                      s);
  }
  const char* xs = c.x + o[2] * c.b * c.sxm * elem_bytes(c.dx);
  const bool to_out = o[4] == OUT;
  float* out = to_out ? c.out : c.res;
  const ll sob = to_out ? c.sob : (ll)c.b * c.N, som = to_out ? c.som : c.N;
  if (o[3] == NONE)
    return hop<false>(c.dx, c.dw, xs, c.w, nullptr, out, c.B, c.b, c.N,
                      c.K, c.sxb, c.sxm, c.swk, 0, 0, sob, som, s);
  const float* acc =
      (const float*)slot_of(c.mine, c.slot_stride, o[3] - SLOT0);
  return hop<true>(c.dx, c.dw, xs, c.w, acc, out, c.B, c.b, c.N, c.K, c.sxb,
                   c.sxm, c.swk, (ll)c.b * c.N, c.N, sob, som, s);
}

// a slot's payload into the next rank's slot `o[2]`
int run_copy(const RingCall& c, const ll* o, cudaStream_t s) {
  char* dst = slot_of(c.next, c.slot_stride, o[2]);
  const ll bytes = slot_bytes(c);
  if (bytes == 0) return 0;
  if (o[1] == X) {   // AG hop 0: x straight from the caller's tensor
    const ll ex = elem_bytes(c.dx), row = (ll)c.K * ex;
    for (int bb = 0; bb < c.B; ++bb) {
      const cudaError_t e = cudaMemcpy2DAsync(
          dst + bb * c.b * row, row, c.x + bb * c.sxb * ex, c.sxm * ex, row,
          c.b, cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
  const void* src = slot_buf(o[1])
                        ? (const void*)slot_of(c.mine, c.slot_stride,
                                               o[1] - SLOT0)
                        : (const void*)c.res;
  return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s);
}

// enqueue the plan; *hops counts the hop_gemm launches it made
int run_plan(const RingCall& c, const ll* plan, int n_ops, int* hops,
             cudaStream_t s) {
  if (hops == nullptr) return (int)cudaErrorInvalidValue;
  *hops = 0;
  if (c.n < 2 || c.B <= 0 || c.b <= 0 || c.N <= 0 || c.K < 0 ||
      c.mine == nullptr || c.next == nullptr || c.slot_stride % 256 != 0 ||
      slot_bytes(c) > c.slot_stride || (!c.ag && c.res == nullptr) ||
      !plan_ok(c, plan, n_ops))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ops; ++i) {
    const ll* o = plan + (ll)i * FIELDS;
    int rc = 0;
    switch (o[0]) {
      case WAIT:
        rc = o[1] == ARRIVE
                 ? streamops::wait_geq(s, c.mine, c.arrive_base + o[2])
                 : streamops::wait_geq(s, c.next + 8, c.done_base + o[2]);
        break;
      case WRITE:
        rc = o[1] == DONE ? streamops::write(s, c.mine + 8, c.done_base + o[2])
                          : streamops::write(s, c.next, c.arrive_base + o[2]);
        break;
      case GEMM:
        rc = run_gemm(c, o, s);
        if (rc == 0) ++*hops;
        break;
      case COPY:
        rc = run_copy(c, o, s);
        break;
    }
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x @ w  (the resident block's tile, RS hop 0)
int repro_cc_matmul_tile(int dx, int dw, const void* x, const void* w,
                         float* out, int B, int M, int N, int K, ll sxb,
                         ll sxm, ll swk, void* stream) {
  return hop<false>(dx, dw, x, w, nullptr, out, B, M, N, K, sxb, sxm, swk, 0,
                    0, (ll)M * N, N, (cudaStream_t)stream);
}

// out = scratch[slot] @ w  (AG hop consume; the slot is s_slot elements
// past the scratch's base)
int repro_cc_consume_matmul(int dx, int dw, const void* scratch, int slot,
                            const void* w, float* out, int B, int M, int N,
                            int K, ll s_slot, ll sxb, ll sxm, ll swk,
                            void* stream) {
  const char* xs = (const char*)scratch + (ll)slot * s_slot * elem_bytes(dx);
  return hop<false>(dx, dw, xs, w, nullptr, out, B, M, N, K, sxb, sxm, swk,
                    0, 0, (ll)M * N, N, (cudaStream_t)stream);
}

// out = scratch[slot] + x @ w  (RS hop consume: the arrived fp32
// accumulator plus the local partial)
int repro_cc_consume_matmul_acc(int dx, int dw, const float* scratch,
                                int slot, const void* x, const void* w,
                                float* out, int B, int M, int N, int K,
                                ll s_slot, ll sab, ll sam, ll sxb, ll sxm,
                                ll swk, void* stream) {
  return hop<true>(dx, dw, x, w, scratch + (ll)slot * s_slot, out, B, M, N,
                   K, sxb, sxm, swk, sab, sam, (ll)M * N, N,
                   (cudaStream_t)stream);
}

// 0 when the card takes the ring's waits: can_64 and can_nor receive its
// CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS and
// CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR
int repro_cc_stream_ops(int* can_64, int* can_nor) {
  return streamops::query(can_64, can_nor);
}

// all_gather(x) @ w over one ring direction: x (B, b, K); out a
// (B, n, b, N) fp32 view; plan the n_ops x 5 codes of ring.ring_plan;
// *hops receives the hop products it launched (n for a whole plan)
int repro_cc_ag_matmul_ring(int dx, int dw, const void* x, const void* w,
                            float* out, int B, int b, int N, int K, ll sxb,
                            ll sxm, ll swk, ll sob, ll sos, ll som,
                            void* mine, void* next, ll slot_stride, int n,
                            ull done_base, ull arrive_base, const ll* plan,
                            int n_ops, int* hops, void* stream) {
  const RingCall c{true, dx, dw, (const char*)x, w, out, nullptr, B, b, N,
                   K, n, sxb, sxm, swk, sob, sos, som, (char*)mine,
                   (char*)next, slot_stride, done_base, arrive_base};
  return run_plan(c, plan, n_ops, hops, (cudaStream_t)stream);
}

// this rank's row block of sum over ranks of x @ w: x (B, n*b, K); out a
// (B, b, N) fp32 view; res a contiguous (B, b, N) fp32 accumulator
int repro_cc_rs_matmul_ring(int dx, int dw, const void* x, const void* w,
                            float* out, float* res, int B, int b, int N,
                            int K, ll sxb, ll sxm, ll swk, ll sob, ll som,
                            void* mine, void* next, ll slot_stride, int n,
                            ull done_base, ull arrive_base, const ll* plan,
                            int n_ops, int* hops, void* stream) {
  const RingCall c{false, dx, dw, (const char*)x, w, out, res, B, b, N, K,
                   n, sxb, sxm, swk, sob, 0, som, (char*)mine, (char*)next,
                   slot_stride, done_base, arrive_base};
  return run_plan(c, plan, n_ops, hops, (cudaStream_t)stream);
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
