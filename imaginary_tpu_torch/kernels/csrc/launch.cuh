// Launch helpers shared by K3 (yuv420_pack.cu), K5 (orient.cu) and K8
// (gray.cu).
//
// Programmatic dependent launch (Hopper): a kernel launched by `launch_pdl`
// may be scheduled while the kernel ahead of it in the stream is still
// running, so its launch latency overlaps that kernel's tail. It calls
// `await_previous_kernel()` before its first read of anything that kernel
// (or anything before it) wrote; that waits for its completion and its
// memory, then lets the kernel behind this one be scheduled in turn.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

__device__ __forceinline__ void await_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The current device's SM count, read once a device.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = dev < kMaxDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    if (dev < kMaxDevices) cached[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}
