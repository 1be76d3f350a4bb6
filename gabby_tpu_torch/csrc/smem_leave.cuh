// A kernel's leave to take more than 48 KB of dynamic shared memory, raised
// once per device with cudaFuncSetAttribute. Shared by the attention
// sources whose blocks outgrow the static limit (at head_dim 128 and in
// the bf16-cache forms). One object per kernel instantiation (a static
// local of its launch function); the leave is raised under a lock, so
// launches may come from several threads and go to several devices.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace gabby_smem {

constexpr int kMaxDevices = 64;

struct SmemLeave {
  std::mutex mu;
  int allowed[kMaxDevices] = {};

  template <typename Kernel>
  cudaError_t raise(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (bytes > allowed[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess) allowed[dev] = bytes;
    }
    return err;
  }
};

}  // namespace gabby_smem
