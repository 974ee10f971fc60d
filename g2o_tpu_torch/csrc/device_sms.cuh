// The host helper the kernel libraries of this directory share: the
// current device and its SM count, asked of the CUDA runtime once per device.
// Each library is one translation unit, so the unnamed namespace gives each
// its own copy and its own cache.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int MAX_DEVICES = 64;

int device_sms(int* dev, int* sms) {
  static std::atomic<int> cache[MAX_DEVICES];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  *sms = cache[*dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return (int)err;
    cache[*dev].store(*sms, std::memory_order_relaxed);
  }
  return 0;
}

}  // namespace
