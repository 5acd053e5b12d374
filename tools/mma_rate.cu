// Throughput probe of the integer mma.sync the port's kernels use.
//
// Built and run by tools/int8_check.py (nvcc into a shared library with a
// plain C interface, loaded with ctypes). Every warp issues `iters` rounds
// of CHAINS independent mma.sync.m16n8k32 (u8 x s8 or s8 x s8 -> s32) on
// register operands: no memory traffic, so the time is the tensor cores'
// issue rate for this instruction (or the latency of one chain, when too
// few chains are in flight). Each warp writes one checksum so nothing is
// optimised away.
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

template <int CHAINS, bool UNSIGNED_A>
__global__ void mma_rate_kernel(int iters, int32_t* out) {
  int32_t acc[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u;
  const uint32_t b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if constexpr (UNSIGNED_A)
        repro::mma_u8s8(acc[c], a, b0, b1);
      else
        repro::mma_s8s8(acc[c], a, b0, b1);
    }
  }
  int32_t sum = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    sum += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int CHAINS>
int launch(int blocks, int threads, int iters, int unsigned_a, void* out,
           cudaStream_t s) {
  if (unsigned_a)
    mma_rate_kernel<CHAINS, true><<<blocks, threads, 0, s>>>(
        iters, static_cast<int32_t*>(out));
  else
    mma_rate_kernel<CHAINS, false><<<blocks, threads, 0, s>>>(
        iters, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// out: blocks * threads int32. Returns the launch's CUDA error.
extern "C" int repro_mma_rate(int blocks, int threads, int iters, int chains,
                              int unsigned_a, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch<1>(blocks, threads, iters, unsigned_a, out, s);
    case 2: return launch<2>(blocks, threads, iters, unsigned_a, out, s);
    case 4: return launch<4>(blocks, threads, iters, unsigned_a, out, s);
    case 8: return launch<8>(blocks, threads, iters, unsigned_a, out, s);
    default: return cudaErrorInvalidValue;
  }
}
