// Shared by the port's CUDA sources.
#pragma once

#include <cuda_runtime.h>

// Each library links its own (static) CUDA runtime, whose current device
// is not the caller's: every entry point makes the tensors' device current
// for the call and restores the previous one after it.
struct DeviceScope {
  int prev = -1;
  bool moved = false;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      moved = err == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (moved) cudaSetDevice(prev);
  }
};
