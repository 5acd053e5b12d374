// Causal GQA flash attention on Hopper: online softmax, optional tanh softcap.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attention (its
// body `_kernel`), which computes, for q (H, Sq, hd) and k, v (Hkv, Skv, hd)
// with query head h reading kv head h / G (G = H / Hkv, the batch folded
// into the head axis):
//
//   s   = dot(q, k) in float32, times hd^-0.5 after the dot
//   s   = tanh(s / cap) * cap                      (when cap > 0)
//   s   = q_pos >= k_pos ? s : -1e30               (absolute positions)
//   (m, l, acc) updated per key tile in float32, p = exp(s - m_new) rounded
//   to v's dtype before the PV product, which accumulates in float32
//   out = acc / max(l, 1e-30) in q's dtype
//
// in that order. Every product is a float32 FMA on operands widened from
// float32 or bfloat16, so the score and the PV sum differ from the plain
// version only in summation order.
//
// What bounds it on the H100: operations. On the LM prefill path (llama3.2-3b,
// B=4, S=4096: H=96, Hkv=32, hd=128, bf16) the causal half of the score and
// PV products is 4 * (S^2 / 2) * hd * H = 4.12e11 FLOPs, 0.417 ms at the bf16
// tensor-core rate (989 TFLOP/s), against 0.20 GB of q, k, v and out (0.06 ms
// at 3.35 TB/s). This kernel runs them on the CUDA cores instead, whose
// float32 peak (67 TFLOP/s) puts its own floor at 6.2 ms: it is simple and
// right, not fast. The tensor-core redesign (wgmma with TMA-fed K/V tiles) is
// later work.
//
// Design: one block of 256 threads per (head, 64-query tile); the tiles run
// heaviest (last on the diagonal) first. The block stages its q tile once and
// then walks the key tiles of 32 keys from the first up to the one that holds
// the diagonal: tiles wholly above it are skipped, which gives the same
// result, because key tile 0 gives every row a finite max first, and a fully
// masked tile then adds p = 0 with alpha = 1. q, k and v tiles are widened to
// float32 in shared memory (rows of q and k padded by 4 floats so that the
// float4 reads of 8 neighbouring threads hit distinct banks). Thread (ty, tx)
// of the 16 x 16 grid owns query rows ty + 16 i (i < 4): their scores against
// keys tx + 16 j (j < 2), their (m, l) state, replicated over the 16 threads
// of a half-warp and reduced with shuffles, and their accumulator columns
// 4 tx + 64 u + e. Ragged Sq and Skv are masked in the loads (zeros), in the
// scores (-1e30) and in the stores, so nothing is padded in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// p rounded to v's dtype (the TPU kernel's p.astype(v.dtype))
__device__ __forceinline__ float round_like(float p, const float*) {
  return p;
}
__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// rows [row0, row0 + n_rows) of one head's (S, HD) matrix into a float32
// shared tile of row stride `stride`; rows at or past `s` read as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int row0, int n_rows,
                                          int s) {
  constexpr int kChunks = HD / 4;
  for (int c = threadIdx.x; c < n_rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 4;
    const int g = row0 + r;
    const float4 v = g < s ? load4(src + static_cast<size_t>(g) * HD + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * stride + d, v);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * kPStride);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const T* __restrict__ q,   // (H, Sq, HD)
    const T* __restrict__ k,   // (Hkv, Skv, HD)
    const T* __restrict__ v,   // (Hkv, Skv, HD)
    T* __restrict__ out,       // (H, Sq, HD)
    int sq, int skv, int group, float scale, float softcap) {
  constexpr int kQK = HD + 4;     // padded row stride of the q and k tiles
  constexpr int kVec = HD / 64;   // float4 accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * kQK;
  float* vs = ks + kBK * kQK;
  float* ps = vs + kBK * HD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int head = blockIdx.y;
  const int q0 = qt * kBQ;
  const T* qh = q + static_cast<size_t>(head) * sq * HD;
  const T* kh = k + static_cast<size_t>(head / group) * skv * HD;
  const T* vh = v + static_cast<size_t>(head / group) * skv * HD;

  load_tile<T, HD>(qs, kQK, qh, q0, kBQ, sq);

  float m[kRows], l[kRows];
  float4 acc[kRows][kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kVec; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the last key tile that holds a key at or below this tile's last row
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int n_tiles = min((skv + kBK - 1) / kBK, last_q / kBK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    load_tile<T, HD>(ks, kQK, kh, k0, kBK, skv);
    load_tile<T, HD>(vs, HD, vh, k0, kBK, skv);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = load4(qs + (ty + 16 * i) * kQK + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = load4(ks + (tx + 16 * j) * kQK + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask; online softmax update of each owned row
    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = (q_pos >= k_pos && k_pos < skv) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = round_like(p, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + p @ v over this tile's keys
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        acc[i][u].x *= alpha[i];
        acc[i][u].y *= alpha[i];
        acc[i][u].z *= alpha[i];
        acc[i][u].w *= alpha[i];
      }
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = load4(ps + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float4 vb[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) vb[u] = load4(vs + (kk + t) * HD + 4 * tx + 64 * u);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = t == 0 ? pa[i].x : t == 1 ? pa[i].y
                        : t == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            acc[i][u].x = fmaf(p, vb[u].x, acc[i][u].x);
            acc[i][u].y = fmaf(p, vb[u].y, acc[i][u].y);
            acc[i][u].z = fmaf(p, vb[u].z, acc[i][u].z);
            acc[i][u].w = fmaf(p, vb[u].w, acc[i][u].w);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = out + (static_cast<size_t>(head) * sq + q_pos) * HD;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const float4 a = acc[i][u];
      store4(row + 4 * tx + 64 * u,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int h,
           int sq, int skv, int group, float scale, float softcap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h);
  flash_attn_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, group, scale,
      softcap);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int h,
              int sq, int skv, int hd, int group, float scale, float softcap,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, h, sq, skv, group, scale, softcap,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, h, sq, skv, group, scale, softcap,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, out, h, sq, skv, group, scale, softcap,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (h, sq, hd), k/v (h / group, skv, hd), out (h, sq, hd), all contiguous,
// 16-byte aligned and of one dtype: float32 (is_bf16 = 0) or bfloat16 (1).
// hd is 64, 128 or 256; softcap <= 0 turns the cap off.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int h, int sq,
                                     int skv, int hd, int group, int is_bf16,
                                     float scale, float softcap,
                                     void* stream) {
  if (h <= 0 || sq <= 0 || skv <= 0 || group <= 0 || h % group != 0 ||
      h > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, h, sq, skv, hd,
                                            group, scale, softcap, s)
                 : launch_hd<float>(q, k, v, out, h, sq, skv, hd, group,
                                    scale, softcap, s);
}
