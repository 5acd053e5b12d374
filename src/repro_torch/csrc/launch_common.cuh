// Host-side launch helpers shared by the port's CUDA sources.
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace repro {

// Set the dynamic shared-memory limit of `kernel` when a block needs more
// than the 48 KB available without opting in.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace repro
