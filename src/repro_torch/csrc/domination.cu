// NSGA-II pairwise domination on Hopper.
//
// Replaces the TPU kernel repro/kernels/domination.py::domination_block
// (and its square case domination_matrix): for minimised objectives,
// dom[i, j] = all_k(a[i,k] <= b[j,k]) and any_k(a[i,k] < b[j,k]).
//
// What bounds it on the H100: bytes. It reads (Pi + Pj) * M floats and
// writes Pi * Pj bytes with 3M comparisons per entry, so at the main
// path's 1024 x 1024 pool the write of the 1 MB matrix dominates, and a
// launch takes longer than either. Design: an elementwise tile kernel, one
// thread per entry with neighbouring threads on neighbouring columns
// (coalesced byte stores), M unrolled by the compiler for small M, ragged
// edges masked in the kernel (no +inf padding), the matrix written as
// uint8 {0, 1}, which a torch.bool tensor holds as is.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 32;  // columns per block (one warp)
constexpr int kTileI = 8;   // rows per block

__global__ void __launch_bounds__(kTileI * kTileJ) domination_kernel(
    const float* __restrict__ objs_i,  // (Pi, M)
    const float* __restrict__ objs_j,  // (Pj, M)
    uint8_t* __restrict__ dom,         // (Pi, Pj)
    int pi, int pj, int m) {
  const int j = blockIdx.x * kTileJ + threadIdx.x;
  const int i = blockIdx.y * kTileI + threadIdx.y;
  if (i >= pi || j >= pj) return;
  const float* a = objs_i + static_cast<size_t>(i) * m;
  const float* b = objs_j + static_cast<size_t>(j) * m;
  bool le = true;
  bool lt = false;
#pragma unroll 4
  for (int k = 0; k < m; ++k) {
    le &= a[k] <= b[k];
    lt |= a[k] < b[k];
  }
  dom[static_cast<size_t>(i) * pj + j] = le && lt;
}

}  // namespace

extern "C" int repro_domination_block(const void* objs_i, const void* objs_j,
                                      void* dom, int pi, int pj, int m,
                                      void* stream) {
  if (pi <= 0 || pj <= 0 || m <= 0) return cudaErrorInvalidValue;
  const dim3 block(kTileJ, kTileI);
  const dim3 grid((pj + kTileJ - 1) / kTileJ, (pi + kTileI - 1) / kTileI);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  domination_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(objs_i), static_cast<const float*>(objs_j),
      static_cast<uint8_t*>(dom), pi, pj, m);
  return cudaGetLastError();
}
