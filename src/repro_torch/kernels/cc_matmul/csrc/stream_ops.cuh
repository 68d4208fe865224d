// Stream memory operations: a wait on a 64-bit value in device memory that
// the card's front end holds in stream order (cuStreamWaitValue64), and a
// write of one after the stream's earlier work (cuStreamWriteValue64, with
// its memory barrier).  The driver entry points come through the runtime
// (cudaGetDriverEntryPoint), so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace streamops {

using Value64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t, unsigned int);
using GetAttribute = CUresult (*)(int*, CUdevice_attribute, CUdevice);
using DeviceGet = CUresult (*)(CUdevice*, int);

struct Api {
  Value64 wait = nullptr;
  Value64 write = nullptr;
  GetAttribute attribute = nullptr;
  DeviceGet device = nullptr;
};

inline void* entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) !=
          cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

inline const Api& api() {
  static const Api a = [] {
    Api r;
    r.wait = reinterpret_cast<Value64>(entry("cuStreamWaitValue64"));
    r.write = reinterpret_cast<Value64>(entry("cuStreamWriteValue64"));
    r.attribute =
        reinterpret_cast<GetAttribute>(entry("cuDeviceGetAttribute"));
    r.device = reinterpret_cast<DeviceGet>(entry("cuDeviceGet"));
    return r;
  }();
  return a;
}

// a driver error as the entry points return it: apart from cudaError_t's
constexpr int DRIVER_ERROR = 100000;

// the current card's CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS and
// CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR; 0, a cudaError_t, or
// DRIVER_ERROR + a CUresult
inline int query(int* can_64, int* can_nor) {
  const Api& a = api();
  if (!a.wait || !a.write || !a.attribute || !a.device)
    return (int)cudaErrorSymbolNotFound;
  int ordinal = 0;
  cudaError_t e = cudaGetDevice(&ordinal);
  if (e != cudaSuccess) return (int)e;
  CUdevice dev;
  CUresult r = a.device(&dev, ordinal);
  if (r == CUDA_SUCCESS)
    r = a.attribute(can_64, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
                    dev);
  if (r == CUDA_SUCCESS)
    r = a.attribute(can_nor, CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR,
                    dev);
  return r == CUDA_SUCCESS ? 0 : DRIVER_ERROR + (int)r;
}

// wait until *p >= v (64-bit), in stream order
inline int wait_geq(cudaStream_t s, const void* p, unsigned long long v) {
  const CUresult r = api().wait((CUstream)s, (CUdeviceptr)p, (cuuint64_t)v,
                                CU_STREAM_WAIT_VALUE_GEQ);
  return r == CUDA_SUCCESS ? 0 : DRIVER_ERROR + (int)r;
}

// *p = v once the stream's earlier work is done and visible
inline int write(cudaStream_t s, void* p, unsigned long long v) {
  const CUresult r = api().write((CUstream)s, (CUdeviceptr)p, (cuuint64_t)v,
                                 CU_STREAM_WRITE_VALUE_DEFAULT);
  return r == CUDA_SUCCESS ? 0 : DRIVER_ERROR + (int)r;
}

}  // namespace streamops
