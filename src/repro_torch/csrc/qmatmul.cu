// Mixed-precision dequantize-matmul on Hopper: out = (x @ w_q) * scale.
//
// Replaces the TPU kernel repro/kernels/qmatmul.py::qmatmul (and the
// padding wrapper repro/kernels/ops.py::qmatmul). x is (M, K) float32 or
// bfloat16, w_q (K, N) int8 codes, scale (N,) float32 per output channel,
// out (M, N) float32. Every product and every partial sum is a float32 FMA
// (no TF32, no bf16 rounding anywhere), and the scale multiplies the
// finished sum once. On the printed-MLP path x holds 8-bit input codes in
// 0..255 and w_q integers in [-8, 7], so every partial sum is an integer
// below 2^24 (255 * 8 * 561 = 1.14e6 for the har dataset) and the result is
// exact in any summation order.
//
// What bounds it on the H100: bytes. At the main path's shape (the
// fitness of a pop-512 har generation: M=3090, K=561, N=8192) it reads x
// once (6.93 MB) and w_q once (4.60 MB) and writes the float32 output
// (101.25 MB): 112,815,560 bytes, 0.0337 ms at 3.35 TB/s. Its 2.84e10
// operations take 0.0144 ms at the int8 tensor-core rate (1979 TOP/s), but
// x is unsigned (0..255) and does not fit int8, and a CUDA-core float32
// kernel such as this one cannot go below 2.84e10 / 67e12 = 0.424 ms.
//
// Design: a classic tiled CUDA-core GEMM. A block of 256 threads owns an
// output tile and walks K in steps: it stages the x tile (widened from bf16
// where needed) transposed in shared memory and the int8 weight tile
// widened to float32 in shared memory, then every thread accumulates a
// small register tile with FMAs, its rows and columns strided by the
// thread grid so that the shared-memory reads are broadcasts or
// conflict-free. Two tile shapes: 128 x 128 with K steps of 16 for wide
// outputs (the population's N = P * 16), and 64 x 16 with K steps of 64 for
// N <= 32 (the verify and serving legs, N = 16), where the wide tile would
// spend 7/8 of its FMAs on masked columns and its 36 K steps on latency.
// Ragged M, K and N (K=561 and N=16 fit no tile) are masked in the loads
// (zeros) and in the stores, so nothing is padded in device memory. The
// u8 x s8 -> s32 tensor-core route (mma/wgmma) is a later redesign; the
// float32 output it would still write is what bounds it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 16;                   // threads along N
constexpr int kTY = 16;                   // threads along M
constexpr int kThreads = kTX * kTY;
constexpr int kNarrowN = 32;              // widest N the narrow tile takes

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// BM x BN output tile per block, BK of K staged per step
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads) qmatmul_kernel(
    const T* __restrict__ x,           // (M, K)
    const int8_t* __restrict__ w,      // (K, N)
    const float* __restrict__ scale,   // (N,)
    float* __restrict__ out,           // (M, N)
    int m, int n, int k) {
  constexpr int RM = BM / kTY;         // rows per thread
  constexpr int RN = BN / kTX;         // columns per thread
  static_assert(BM % kTY == 0 && BN % kTX == 0, "tile must cover threads");
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0,
                "tile loads must split evenly over the block");
  // x tile transposed (k-major); one float of padding per row spreads the
  // transposing stores over the banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // x tile (BM x BK): neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / BK;
      const int c = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < m && gk < k)
                     ? widen(x[static_cast<size_t>(gm) * k + gk])
                     : 0.f;
    }
    // weight tile (BK x BN): neighbouring threads read neighbouring bytes
#pragma unroll
    for (int i = 0; i < BK * BN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      ws[r][c] = (gk < k && gn < n)
                     ? static_cast<float>(w[static_cast<size_t>(gk) * n + gn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM];
      float b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[kk][ty + i * kTY];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = ws[kk][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int gn = n0 + tx + j * kTX;
    if (gn >= n) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gm = m0 + ty + i * kTY;
      if (gm < m) out[static_cast<size_t>(gm) * n + gn] = acc[i][j] * s;
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch_tile(const void* x, const void* w, const void* scale, void* out,
                int m, int n, int k, cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  qmatmul_kernel<T, BM, BN, BK><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), m, n, k);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* out, int m,
           int n, int k, cudaStream_t stream) {
  return n <= kNarrowN
             ? launch_tile<T, 64, 16, 64>(x, w, scale, out, m, n, k, stream)
             : launch_tile<T, 128, 128, 16>(x, w, scale, out, m, n, k,
                                            stream);
}

}  // namespace

// x_is_bf16: 0 for float32 x, 1 for bfloat16 x.
extern "C" int repro_qmatmul(const void* x, const void* w, const void* scale,
                             void* out, int m, int n, int k, int x_is_bf16,
                             void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(x, w, scale, out, m, n, k, s)
                   : launch<float>(x, w, scale, out, m, n, k, s);
}
