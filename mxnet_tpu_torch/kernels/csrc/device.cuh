// The device guard of the port's CUDA sources (batchnorm.cu, nms.cu,
// roi_pooling.cu and, through stream.cuh, copy.cu and the rtc bodies):
// each C entry takes the device of its tensors and launches under a guard.
#pragma once

#include <cuda_runtime.h>

namespace mxcuda {
// Internal linkage: each library that includes the header keeps its own.
namespace {

// Makes `device` current for the launches of its scope and then restores
// the caller's device, as PyTorch's device guard does. `err` is the
// first failure of cudaGetDevice/cudaSetDevice; launch nothing unless it
// is cudaSuccess.
struct DeviceGuard {
  int prev = -1, device;
  cudaError_t err;
  explicit DeviceGuard(int d) : device(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (err == cudaSuccess && prev != device) cudaSetDevice(prev);
  }
};

}  // namespace
}  // namespace mxcuda
