// Dynamic shared memory limits set once, so that a launch can be captured.
//
// A kernel asking for more than 48 KB of dynamic shared memory needs
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) first.  Calling it at every
// launch would put a non-stream call into every CUDA graph capture of a train
// step (train/graphs.py); raising the limit only when a launch asks for more
// than the device's limit so far means that once the warm-up launches have run
// at a step's shapes, a launch enqueues its kernel and nothing else.  The limit
// is per device, so each launcher keeps one entry per device.

#pragma once

#include <cuda_runtime.h>

constexpr int kSmemLimitDevices = 64;

// Raise kern's limit on the current device to at least ``smem`` bytes;
// ``allowed`` is the caller's per-device record of the limit set so far.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kern, int smem, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kSmemLimitDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}
