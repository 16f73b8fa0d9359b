// The dynamic shared-memory limit of a kernel that needs more than the
// default 48 KB: one static SmemLimit for each kernel, at the site that
// launches it, raises the limit for each device when a launch needs more
// than the last raise. A driver call on every launch would cost host time;
// raising twice from two threads is harmless.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace cdae {

class SmemLimit {
 public:
  // cudaSuccess, or the error of the raise, cleared here so that it is not
  // left for the next launch
  template <typename Kernel>
  cudaError_t raise(Kernel* kernel, size_t smem) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < kMaxDevices && raised_[dev] >= smem) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (dev < kMaxDevices) raised_[dev] = smem;
    return cudaSuccess;
  }

 private:
  static constexpr int kMaxDevices = 64;
  size_t raised_[kMaxDevices] = {};
};

}  // namespace cdae
