// The hand-off probe of cc_matmul/probe_handoff.py, for sm_90a: n rank
// processes sharing the card pass a token around their ring `iters` times,
// each hand-off by one of three means:
//   spin    -- one kernel a rank, whose thread polls its flag with
//              ld.acquire.sys and __nanosleep and then releases the next
//              rank's (the old whole-ring kernels' wait);
//   memops  -- cuStreamWaitValue64 (greater or equal) on the rank's flag,
//              then cuStreamWriteValue64 of the next rank's (the ring's
//              hand-off);
//   events  -- IPC events: cudaStreamWaitEvent on the previous rank's
//              event, then cudaEventRecord of the rank's own, after a host
//              handshake (a wait sees only the last record enqueued before
//              it, so the host waits until the previous rank has enqueued
//              its record).
// The flags are 64-bit counters in device memory every rank maps (CUDA
// IPC).  In round i rank 0 waits for its flag to reach i and the others for
// i + 1; a rank then adds one to the token (rank 0's memory) and sets the
// next rank's flag to i + 1.  memops and events add the token with a
// one-thread kernel, so every hand-off also puts the rank's context on the
// SMs, as the ring's hop products do.
// Every entry returns 0, a cudaError_t, or streamops::DRIVER_ERROR + a
// CUresult.

#include <cuda_runtime.h>

#include <chrono>
#include <thread>

#include "stream_ops.cuh"

namespace {

using ull = unsigned long long;

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

// one thread: every round of the ring on this rank; traps after
// `timeout_ns` of waiting for one hand-off (the launch then fails)
__global__ void probe_spin(const ull* mine, ull* next, ull* token,
                           int first, int iters, ull timeout_ns) {
  for (int i = 0; i < iters; ++i) {
    const ull want = (ull)i + (first ? 0 : 1);
    const ull t0 = global_ns();
    while (ld_acquire(mine) < want) {
      if (global_ns() - t0 > timeout_ns) __trap();
      __nanosleep(256);
    }
    atomicAdd_system(token, 1ull);
    __threadfence_system();
    st_release(next, (ull)i + 1);
  }
}

__global__ void probe_bump(ull* token) { atomicAdd_system(token, 1ull); }

}  // namespace

extern "C" {

int repro_probe_spin(const ull* mine, ull* next, ull* token, int first,
                     int iters, double timeout_s, void* stream) {
  probe_spin<<<1, 1, 0, (cudaStream_t)stream>>>(
      mine, next, token, first, iters, (ull)(timeout_s * 1e9));
  return (int)cudaGetLastError();
}

int repro_probe_memops(const ull* mine, ull* next, ull* token, int first,
                       int iters, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < iters; ++i) {
    int rc = streamops::wait_geq(s, mine, (ull)i + (first ? 0 : 1));
    if (rc != 0) return rc;
    probe_bump<<<1, 1, 0, s>>>(token);
    rc = streamops::write(s, next, (ull)i + 1);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

// an IPC event of this rank: the event, and its 64-byte handle
int repro_probe_event_create(void** event, unsigned char* handle) {
  cudaEvent_t e;
  cudaError_t rc = cudaEventCreateWithFlags(
      &e, cudaEventInterprocess | cudaEventDisableTiming);
  cudaIpcEventHandle_t h;
  if (rc == cudaSuccess) rc = cudaIpcGetEventHandle(&h, e);
  if (rc != cudaSuccess) return (int)rc;
  for (int i = 0; i < (int)sizeof(h); ++i)
    handle[i] = (unsigned char)h.reserved[i];
  *event = e;
  return 0;
}

int repro_probe_event_open(const unsigned char* handle, void** event) {
  cudaIpcEventHandle_t h;
  for (int i = 0; i < (int)sizeof(h); ++i) h.reserved[i] = (char)handle[i];
  cudaEvent_t e;
  const cudaError_t rc = cudaIpcOpenEventHandle(&e, h);
  if (rc == cudaSuccess) *event = e;
  return (int)rc;
}

// a 64-bit value of device memory, read on the host
int repro_probe_read(const ull* p, ull* value) {
  return (int)cudaMemcpy(value, p, sizeof(ull), cudaMemcpyDeviceToHost);
}

int repro_probe_event_destroy(void* event) {
  return (int)cudaEventDestroy((cudaEvent_t)event);
}

// `host` the n rounds-enqueued counters of the ranks in memory every rank
// process maps; `prev` the previous rank's index in it
int repro_probe_events(void* mine, void* prev_event, long long* host,
                       int rank, int prev, int iters, ull* token,
                       double timeout_s, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::duration<double>(timeout_s);
  for (int i = 0; i < iters; ++i) {
    const long long want = i + (rank == 0 ? 0 : 1);
    while (__atomic_load_n(host + prev, __ATOMIC_ACQUIRE) < want) {
      if (std::chrono::steady_clock::now() > deadline)
        return (int)cudaErrorTimeout;
      std::this_thread::yield();
    }
    cudaError_t rc = cudaSuccess;
    if (want > 0) rc = cudaStreamWaitEvent(s, (cudaEvent_t)prev_event, 0);
    if (rc == cudaSuccess) {
      probe_bump<<<1, 1, 0, s>>>(token);
      rc = cudaEventRecord((cudaEvent_t)mine, s);
    }
    if (rc != cudaSuccess) return (int)rc;
    __atomic_store_n(host + rank, (long long)i + 1, __ATOMIC_RELEASE);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
