// Mixed-precision dequantize-matmul on Hopper: out = (x @ w_q) * scale.
//
// Replaces the TPU kernel repro/kernels/qmatmul.py::qmatmul (and the
// padding wrapper repro/kernels/ops.py::qmatmul). w_q is (K, N) int8 codes,
// scale (N,) float32 per output channel, out (M, N) float32; the TPU kernel
// casts x to float32 whatever its type, so x may be uint8, float32 or
// bfloat16. Two kernels:
//
// uint8 x (the printed MLP's 8-bit input codes, on every path of the port:
// its fitness, verify leg and serving) runs on the integer tensor cores,
// mma.sync m16n8k32 u8 x s8 -> s32. The int32 sum is exact by
// construction (Hopper's bf16 accumulation is not documented to keep 24
// bits; int32 keeps every bit), and the epilogue writes
// float(acc) * scale[n]: one rounding, so for sums below 2^24 (every sum on
// the MLP path, 255 * 8 * 561 = 1.14e6 for har) it equals the float64 plain
// version bit for bit. What bounds it on the H100: bytes. At the fitness
// shape (M=3090, K=561, N=8192) it reads x (1.73 MB) and w_q (4.60 MB) once
// and writes the float32 output (101.25 MB): 107,615,090 bytes, 0.0321 ms
// at 3.35 TB/s; its 2.84e10 operations take 0.0144 ms at 1979 TOP/s. Design:
//   - wide N (> 32): 128 x 128 block tiles, 8 warps of 64 x 32, two blocks
//     an SM. Both operands stream through a four-stage cp.async ring, K in
//     stages of 64 bytes: the x tile with 80-byte rows (conflict-free
//     fragment reads), the weight tile as it lies in memory, N-contiguous,
//     its 16-byte chunks XOR-swizzled by row. The mma's col B operand wants
//     4 consecutive k bytes per column and sm_90's ldmatrix has no 8-bit
//     transpose, so a lane reads one 4 x 4 byte block (4 k rows of 4
//     columns) and transposes it with __byte_perm into the b registers of
//     all four of its n-tiles: n-tile c's column g is real column 4g + c.
//     A lane's accumulators then hold 8 consecutive columns of a row, which
//     the epilogue writes as two float4.
//   - narrow N (<= 32: the verify and serving legs, N=16): 16-row blocks
//     (194 blocks at M=3090, one at M=1) of 8 warps that split K between
//     them (a warp takes 2-3 of the 18 k-steps of K=561, loading all their
//     fragments before their mma) and reduce their int32 partial tiles in
//     shared memory. Each byte of x is read once, so the fragments are
//     loaded straight into registers.
//   - x's rows need not be contiguous: the kernel takes x's row stride.
//     When it and x's address are multiples of 16 bytes (the printed-MLP
//     problem and the server hold their codes in such buffers,
//     kernels/qmatmul.py::code_buffer) x moves in 16-byte cp.async copies
//     (4-byte loads in the narrow kernel) and the ragged end of K=561 is
//     masked by the copies' byte counts (zero fill); otherwise by single
//     bytes. The weight tile moves in 16-byte copies when N is a multiple
//     of 16, else by single bytes; ragged M, K and N are masked, never
//     padded in memory.
//
// float32 or bfloat16 x keeps the CUDA-core kernel of the first port: a
// tiled float32 FMA GEMM (no TF32, no bf16 rounding), 128 x 128 tiles with K
// steps of 16 for wide outputs and 64 x 16 tiles with K steps of 64 for
// N <= 32. No path of the port calls it with float x (the LM quantization
// caller, quantize/bespoke.py, is not ported); it is kept for the contract.
// It cannot go below 2.84e10 / 67e12 = 0.424 ms at the fitness shape.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// uint8 x on the integer tensor cores
// ---------------------------------------------------------------------------

constexpr int kIWarpsM = 2;      // warps along M, 64 rows each
constexpr int kIBM = 64 * kIWarpsM;   // wide tile rows
constexpr int kIBN = 128;        // wide tile columns: 4 warps of 32
constexpr int kIBK = 64;         // K bytes per ring stage
constexpr int kIStages = 4;      // cp.async ring depth
constexpr int kIThreads = kIWarpsM * 4 * 32;
constexpr int kIMT = 4;          // m-tiles of 16 per warp
constexpr int kARowW = 20;       // x tile row stride in 32-bit words (80 B)
constexpr int kBRowW = kIBN / 4; // weight tile row stride in words (128 B)
constexpr int kAStage = kIBM * kARowW;   // words
constexpr int kBStage = kIBK * kBRowW;   // words
constexpr int kNThreads = 256;   // narrow kernel: 8 warps split K
constexpr int kNRows = 16;       // narrow tile rows
constexpr int kNBatch = 3;       // k-steps a narrow warp loads at once

// Word `w` of weight-tile row `r` lives at w ^ swz(r): the four rows a lane
// reads for one fragment (r = 4t + i, t = lane % 4) land on four distinct
// groups of 8 banks. Multiples of 8 words keep 16-byte chunks whole.
__device__ __forceinline__ int swz(int r) { return ((r >> 2) & 3) << 3; }

// 16 bytes into shared memory: a cp.async copy of `valid` bytes (zero-filled
// past them) when the source is 16-byte aligned, else byte loads.
__device__ __forceinline__ void stage16(uint32_t* dst, const uint8_t* src,
                                        int valid, bool aligned) {
  if (aligned) {
    repro::cp_async16(dst, src, valid);
  } else {
    uint4 v;
    v.x = repro::load_bytes4(src, valid);
    v.y = repro::load_bytes4(src + 4, valid - 4);
    v.z = repro::load_bytes4(src + 8, valid - 8);
    v.w = repro::load_bytes4(src + 12, valid - 12);
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// One ring stage: the x tile (rows m0.., bytes k0..) and the weight tile
// (rows k0.., columns n0..) as they lie in memory (N contiguous).
__device__ __forceinline__ void load_stage(uint32_t* as, uint32_t* bs,
                                           const uint8_t* x, const int8_t* w,
                                           int lda, int m, int n, int k,
                                           int m0, int n0, int k0, bool x16,
                                           bool w16) {
#pragma unroll
  for (int i = 0; i < kIBM * kIBK / 16 / kIThreads; ++i) {
    const int c = threadIdx.x + i * kIThreads;
    const int r = c / (kIBK / 16);
    const int kc = (c % (kIBK / 16)) * 16;
    const int gm = m0 + r;
    const int valid = gm < m ? max(0, min(16, k - (k0 + kc))) : 0;
    stage16(as + r * kARowW + kc / 4,
            x + (valid ? static_cast<size_t>(gm) * lda + k0 + kc : 0), valid,
            x16);
  }
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
#pragma unroll
  for (int i = 0; i < kIBK * kIBN / 16 / kIThreads; ++i) {
    const int c = threadIdx.x + i * kIThreads;
    const int r = c / (kIBN / 16);
    const int nc = (c % (kIBN / 16)) * 16;
    const int gk = k0 + r;
    const int valid = gk < k ? max(0, min(16, n - (n0 + nc))) : 0;
    stage16(bs + r * kBRowW + ((nc / 4) ^ swz(r)),
            wb + (valid ? static_cast<size_t>(gk) * n + n0 + nc : 0), valid,
            w16);
  }
}

__device__ __forceinline__ void store4(float* o, int col, int n, bool vec,
                                       float4 v) {
  if (vec && col + 3 < n) {
    *reinterpret_cast<float4*>(o) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (col + c < n) o[c] = e[c];
}

// N > 32: 128 x 128 output tiles, 8 warps of 64 x 32, K in ring stages of
// 64. The weight tile stays N-major in shared memory; a lane reads the
// 4 x 4 byte block (k rows 4t..4t+3, columns 4g..4g+3 of its warp's 32) and
// transposes it with __byte_perm into the b0 registers of all four of its
// n-tiles: n-tile c's column g is real column 4g + c. So a lane's
// accumulators hold the real columns 8t..8t+7 of a row, stored as two
// float4.
__global__ void __launch_bounds__(kIThreads, 2) qmatmul_u8_wide_kernel(
    const uint8_t* __restrict__ x,     // (M, K), row stride lda
    const int8_t* __restrict__ w,      // (K, N)
    const float* __restrict__ scale,   // (N,)
    float* __restrict__ out,           // (M, N)
    int m, int n, int k, int lda, int x16, int w16) {
  extern __shared__ __align__(16) uint32_t ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;     // warp's rows in the tile
  const int wn = (warp & 3) * 32;      // warp's columns in the tile
  const int m0 = blockIdx.y * kIBM;
  const int n0 = blockIdx.x * kIBN;
  const int steps = (k + kIBK - 1) / kIBK;
  auto a_stage = [&](int s) { return ring + (s % kIStages) * (kAStage + kBStage); };

  int32_t acc[kIMT][4][4];
#pragma unroll
  for (int i = 0; i < kIMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kIStages - 1; ++s) {
    if (s < steps)
      load_stage(a_stage(s), a_stage(s) + kAStage, x, w, lda, m, n, k, m0,
                 n0, s * kIBK, x16, w16);
    repro::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    repro::cp_async_wait<kIStages - 2>();
    __syncthreads();  // stage s is in; stage s - 1 is consumed by all warps
    const int next = s + kIStages - 1;
    if (next < steps)
      load_stage(a_stage(next), a_stage(next) + kAStage, x, w, lda, m, n, k,
                 m0, n0, next * kIBK, x16, w16);
    repro::cp_async_commit();
    const uint32_t* a_s = a_stage(s);
    const uint32_t* b_s = a_s + kAStage;
#pragma unroll
    for (int ks = 0; ks < kIBK / 32; ++ks) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ks * 32 + h * 16 + 4 * t + i;
          b[h][i] = b_s[r * kBRowW + (((wn >> 2) + g) ^ swz(r))];
        }
        repro::transpose4x4(b[h]);   // b[h][c]: n-tile c, column 4g + c
      }
#pragma unroll
      for (int i = 0; i < kIMT; ++i) {
        const uint32_t* row = a_s + (wm + i * 16 + g) * kARowW + ks * 8 + t;
        const uint32_t a[4] = {row[0], row[8 * kARowW], row[4],
                               row[8 * kARowW + 4]};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          repro::mma_u8s8(acc[i][c], a, b[0][c], b[1][c]);
      }
    }
  }

  // accumulator (i, c, 2h + e) is row wm + 16 i + g + 8 h, column 8 t + 4 e
  // + c of the warp's 32
  const int col = n0 + wn + 8 * t;
  if (col >= n) return;
  const bool vec = (n & 3) == 0;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = col + e < n ? scale[col + e] : 0.f;
#pragma unroll
  for (int i = 0; i < kIMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + i * 16 + g + 8 * h;
      if (gm >= m) continue;
      float* o = out + static_cast<size_t>(gm) * n + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float4 v;
        v.x = static_cast<float>(acc[i][0][2 * h + e]) * sc[4 * e];
        v.y = static_cast<float>(acc[i][1][2 * h + e]) * sc[4 * e + 1];
        v.z = static_cast<float>(acc[i][2][2 * h + e]) * sc[4 * e + 2];
        v.w = static_cast<float>(acc[i][3][2 * h + e]) * sc[4 * e + 3];
        store4(o + 4 * e, col + 4 * e, n, vec, v);
      }
    }
  }
}

// Four bytes of row `p` (of `valid` bytes left in the row).
__device__ __forceinline__ uint32_t x_word(const uint8_t* p, int valid,
                                           bool x4) {
  if (valid >= 4 && x4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  return repro::load_bytes4(p, valid);
}

// N <= 8 NT columns: 16 rows per block, K split over the 8 warps; each
// warp loads the fragments of up to kNBatch of its k-steps before their
// mma, so their loads are in flight together.
template <int NT>
__global__ void __launch_bounds__(kNThreads) qmatmul_u8_narrow_kernel(
    const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int m, int n,
    int k, int lda, int x4) {
  constexpr int kCols = NT * 8;
  constexpr int kWarps = kNThreads / 32;
  __shared__ int32_t part[kWarps][kNRows][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kNRows;
  const int r0 = m0 + g;
  const int r1 = m0 + g + 8;
  const uint8_t* x0 = x + static_cast<size_t>(r0 < m ? r0 : 0) * lda;
  const uint8_t* x1 = x + static_cast<size_t>(r1 < m ? r1 : 0) * lda;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  const bool x4b = x4 != 0;

  int32_t acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  const int steps = (k + 31) / 32;
  for (int s0 = warp; s0 < steps; s0 += kNBatch * kWarps) {
    uint32_t a[kNBatch][4];
    uint32_t b[kNBatch][NT][2];
#pragma unroll
    for (int q = 0; q < kNBatch; ++q) {
      const int ka = (s0 + q * kWarps) * 32 + 4 * t;  // + 16: a2, a3, b1
      const int va = k - ka;
      const int vb = k - ka - 16;
      a[q][0] = r0 < m ? x_word(x0 + ka, va, x4b) : 0u;
      a[q][1] = r1 < m ? x_word(x1 + ka, va, x4b) : 0u;
      a[q][2] = r0 < m && vb > 0 ? x_word(x0 + ka + 16, vb, x4b) : 0u;
      a[q][3] = r1 < m && vb > 0 ? x_word(x1 + ka + 16, vb, x4b) : 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = j * 8 + g;
        const bool in = col < n;
        b[q][j][0] = in ? repro::load_bytes4(
                              wb + static_cast<size_t>(max(ka, 0)) * n + col,
                              va, n)
                        : 0u;
        b[q][j][1] = in && vb > 0
                         ? repro::load_bytes4(
                               wb + static_cast<size_t>(ka + 16) * n + col,
                               vb, n)
                         : 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < kNBatch; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        repro::mma_u8s8(acc[j], a[q], b[q][j][0], b[q][j][1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    part[warp][g][j * 8 + 2 * t] = acc[j][0];
    part[warp][g][j * 8 + 2 * t + 1] = acc[j][1];
    part[warp][g + 8][j * 8 + 2 * t] = acc[j][2];
    part[warp][g + 8][j * 8 + 2 * t + 1] = acc[j][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kNRows * kCols; e += kNThreads) {
    const int r = e / kCols;
    const int c = e % kCols;
    if (m0 + r >= m || c >= n) continue;
    int32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sum += part[q][r][c];
    out[static_cast<size_t>(m0 + r) * n + c] = static_cast<float>(sum) *
                                               scale[c];
  }
}

template <int NT>
int launch_narrow(const uint8_t* x, const int8_t* w, const float* scale,
                  float* out, int m, int n, int k, int lda, int x4,
                  cudaStream_t stream) {
  const unsigned blocks = (m + kNRows - 1) / kNRows;
  qmatmul_u8_narrow_kernel<NT><<<blocks, kNThreads, 0, stream>>>(
      x, w, scale, out, m, n, k, lda, x4);
  return cudaGetLastError();
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

// uint8 x with row stride lda (>= k) in bytes; the kernel is chosen by N.
extern "C" int repro_qmatmul_u8(const void* x, const void* w,
                                const void* scale, void* out, int m, int n,
                                int k, int lda, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || lda < k) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const uint8_t*>(x);
  const auto wp = static_cast<const int8_t*>(w);
  const auto sp = static_cast<const float*>(scale);
  const auto op = static_cast<float*>(out);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (n <= 32) {
    const int x4 = lda % 4 == 0 && xa % 4 == 0;
    switch ((n + 7) / 8) {
      case 1: return launch_narrow<1>(xp, wp, sp, op, m, n, k, lda, x4, s);
      case 2: return launch_narrow<2>(xp, wp, sp, op, m, n, k, lda, x4, s);
      case 3: return launch_narrow<3>(xp, wp, sp, op, m, n, k, lda, x4, s);
      default: return launch_narrow<4>(xp, wp, sp, op, m, n, k, lda, x4, s);
    }
  }
  const dim3 grid((n + kIBN - 1) / kIBN, (m + kIBM - 1) / kIBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int x16 = lda % 16 == 0 && xa % 16 == 0;
  const int w16 = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t smem = sizeof(uint32_t) * kIStages * (kAStage + kBStage);
  const cudaError_t err =
      repro::allow_dynamic_smem(qmatmul_u8_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  qmatmul_u8_wide_kernel<<<grid, kIThreads, smem, s>>>(xp, wp, sp, op, m, n,
                                                       k, lda, x16, w16);
  return cudaGetLastError();
}
