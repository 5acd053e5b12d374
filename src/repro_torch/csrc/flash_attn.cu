// Causal GQA flash attention on Hopper: online softmax, optional tanh softcap.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attention (its
// body `_kernel`), which computes, for q (H, Sq, hd) and k, v (Hkv, Skv, hd)
// with query head h reading kv head h / G (G = H / Hkv):
//
//   s   = dot(q, k) in float32, times hd^-0.5 after the dot
//   s   = tanh(s / cap) * cap                      (when cap > 0)
//   s   = q_pos >= k_pos ? s : -1e30               (absolute positions)
//   (m, l, acc) updated per key tile in float32, p = exp(s - m_new) rounded
//   to v's dtype before the PV product, which accumulates in float32
//   out = acc / max(l, 1e-30) in q's dtype
//
// in that order, and, when asked, each query row's log-sum-exp
//
//   lse = m + log(max(l, 1e-30))                   (natural log, float32)
//
// into lse (batch, heads, Sq), which the backward (flash_attn_bwd.cu) takes
// to rebuild p without a second softmax pass; a null lse pointer stores
// nothing and leaves the kernels as they were. Both kernels below read q,
// k, v and write out as (batch,
// seq, head, hd) with element strides for the first three axes and a
// contiguous last axis: the model's (B, S, H, hd) projections where they lie,
// and the JAX contract's (H, S, hd) as batch 1 with head stride S * hd. The
// entry point dispatches on the dtype.
//
// bfloat16: flash_attn_tc_kernel, on the tensor cores. What bounds it on the
// H100: operations. On the LM prefill path (llama3.2-3b, B=4, S=4096: H=96,
// Hkv=32, hd=128) the causal half of the two products is
// 4 * (S^2 / 2) * hd * H = 4.12e11 FLOPs, 0.417 ms at the bf16 tensor-core
// rate (989 TFLOP/s), against 0.27 GB of q, k, v and out (0.08 ms at 3.35
// TB/s). A bf16 x bf16 product is exact in float32, so wgmma with float32
// accumulation differs from float32 FMAs only in summation order.
// Design: a block of three warpgroups owns 128 queries of one head (one
// block per SM: 384 threads at the launch bound's 168 registers). The last
// warpgroup is the producer: it returns its registers to the block's pool
// (setmaxnreg 24), and one of its threads loads the block's q tile once,
// then walks the key tiles (BK keys: 128, or 64 at hd 256) through a ring of
// two K and two V stages by TMA, 128-byte swizzled, with one mbarrier per K
// stage and per V stage that the copy completes and one per stage that the
// consumers release. The other two warpgroups (setmaxnreg 240) own 64 query
// rows each: S = q k^T by wgmma m64nBKk16 from shared memory (both
// K-major), then scale (log2(e) folded in, for exp2), softcap, mask and
// online softmax in registers; p is rounded to bf16 straight from the S
// accumulator into wgmma's A fragments, and O += p v by wgmma m64nHDk16
// with v read N-major from shared memory. The mbarrier, TMA and wgmma
// pieces and the TMA maps live in hopper.cuh, shared with the backward.
// Key tiles wholly above the diagonal are skipped, which gives the same
// result because key tile 0 gives every row a finite max first, and a fully
// masked tile then adds p = 0 with alpha = 1. Only a tile that reaches the
// diagonal or the ragged key edge is masked, by position: TMA's zero fill
// past Skv is a zero score, not a masked one. Query tiles run heaviest first
// across all heads (the tile index is the grid's slowest axis). The output
// is stored from registers, masked at the ragged Sq edge.
// Head dim 112 (zamba2-7b's shared attention; 224-byte rows are not a whole
// number of 128-byte chunks) runs the HD = 128 instantiation on TMA maps
// 112 columns wide: each row's second 64-column box reads 48 columns and TMA
// fills the other 16 with zeros (OOB fill NONE is zeros, and the expected
// transaction bytes stay the whole box). Zero columns of q and k add
// nothing to q k^T, zero columns of v give zero columns of O that the
// epilogue does not store, and the scale is 112^-0.5 from the wrapper. The
// cost is 128 / 112 = 1.14x the tensor-core work of the exact product: at
// the zamba2 prefill (B=4, S=4096, H=Hkv=32) the bound is 4 * (S^2 / 2) *
// 112 * H = 4.81e11 FLOPs, 0.486 ms at 989 TFLOP/s, and the padded kernel
// issues 5.50e11.
//
// float32: flash_attn_kernel, on the CUDA cores (the tensor cores take
// float32 only as TF32, which would break float32 parity with the plain
// version); its float32 peak (67 TFLOP/s) would put its floor on the shape
// above at 6.2 ms. One block of 256 threads per (64-query tile, head,
// batch), the tiles heaviest first within a head; it stages its q tile once
// and walks the key tiles of 32 keys up to the one that holds the diagonal,
// q and k rows padded by 4 floats so that the float4 reads of 8 neighbouring
// threads hit distinct banks. Thread (ty, tx) of the 16 x 16 grid owns query
// rows ty + 16 i (i < 4): their scores against keys tx + 16 j (j < 2), their
// (m, l) state, replicated over the 16 threads of a half-warp and reduced
// with shuffles, and their accumulator columns 4 tx + 64 u + e. Ragged Sq
// and Skv are masked in the loads (zeros), in the scores (-1e30) and in the
// stores. Head dim 112 runs the HD = 128 tiles with columns 112-127 loaded
// as zeros and not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::Layout;
using hopper::tensor_map;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kPStride = kBK + 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [row0, row0 + n_rows) of one head (row stride `ld`, HDR columns)
// into a shared tile of HD columns and row stride `stride`; rows at or past
// `s` and columns at or past HDR read as zeros
template <int HD, int HDR>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, long long ld,
                                          int row0, int n_rows, int s) {
  constexpr int kChunks = HD / 4;
  for (int c = threadIdx.x; c < n_rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 4;
    const int g = row0 + r;
    const float4 v = g < s && d < HDR ? load4(src + g * ld + d)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * stride + d, v);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * kPStride);
}

// HD: the tile's head dim (64, 128 or 256); HDR <= HD: the operands' own,
// whose columns past HDR the tiles hold as zeros and the store skips
template <int HD, int HDR>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, Layout lq, Layout lk, Layout lv, Layout lo,
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
  const int batch = blockIdx.z;
  const int q0 = qt * kBQ;
  const float* qh = q + batch * lq.b + head * lq.h;
  const float* kh = k + batch * lk.b + (head / group) * lk.h;
  const float* vh = v + batch * lv.b + (head / group) * lv.h;

  load_tile<HD, HDR>(qs, kQK, qh, lq.s, q0, kBQ, sq);

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
    load_tile<HD, HDR>(ks, kQK, kh, lk.s, k0, kBK, skv);
    load_tile<HD, HDR>(vs, HD, vh, lv.s, k0, kBK, skv);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDR; d += 4) {
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
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
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
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(batch) * gridDim.y + head) * sq + q_pos] =
          m[i] + logf(den);
    float* row = out + batch * lo.b + q_pos * lo.s + head * lo.h;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if (4 * tx + 64 * u >= HDR) continue;
      const float4 a = acc[i][u];
      store4(row + 4 * tx + 64 * u,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), K and V by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBQ = 128;                      // queries per block
constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                    // K and V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Shape {
  static constexpr int kBK = HD == 256 ? 64 : 128;  // keys per tile
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;   // one K or V stage
  static constexpr int kTiles = kQBytes + 2 * kStages * kTileBytes;
  // + 1024 for aligning the swizzled tiles, + 64 for the mbarriers
  static constexpr int kSmem = kTiles + 1024 + 64;
};

// HD: the tiles' head dim (64, 128 or 256); HDR <= HD: the operands' own.
// The TMA maps are HDR wide, so a box's columns past HDR arrive as zeros:
// q k^T is the exact product, the zero columns of v give zero columns of O,
// and the store skips them
template <int HD, int HDR>
__global__ void __launch_bounds__(kThreads, 1) flash_attn_tc_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, Layout lo, int sq, int skv, int group,
    float scale, float softcap) {
  using S = Shape<HD>;
  constexpr int kBK = S::kBK;
  constexpr int kChunks = HD / 64;   // 128-byte column chunks of a row
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t q_tile = base;                  // [chunk][kBQ rows][64]
  const uint32_t k_ring = q_tile + S::kQBytes;   // [stage][chunk][kBK][64]
  const uint32_t v_ring = k_ring + kStages * S::kTileBytes;
  const uint32_t q_full = v_ring + kStages * S::kTileBytes;
  const uint32_t k_full = q_full + 8;            // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  // the last key tile that holds a key at or below this tile's last row
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int n_tiles = min((skv + kBK - 1) / kBK, last_q / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 == 0) {
      const int kv_head = head / group;
      mbar_expect(q_full, S::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(q_tile + c * kBQ * 128, &tm_q, q_full, 64 * c, q0, head,
                 batch);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect(k_full + 8 * s, S::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(k_ring + s * S::kTileBytes + c * kBK * 128, &tm_k,
                   k_full + 8 * s, 64 * c, j * kBK, kv_head, batch);
        mbar_expect(v_full + 8 * s, S::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(v_ring + s * S::kTileBytes + c * kBK * 128, &tm_v,
                   v_full + 8 * s, 64 * c, j * kBK, kv_head, batch);
      }
    }
  } else {
    // consumer: query rows [qw, qw + 64) of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int row = 16 * (t / 32) + (t % 32) / 4;   // and row + 8
    const int col = 2 * (t % 4);                     // of each 8 columns
    const int qw = q0 + 64 * wg;
    const uint32_t q_rows = q_tile + wg * 64 * 128;
    const float scale_log2 = scale * kLog2e;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t k_tile = k_ring + stage * S::kTileBytes;
      const uint32_t v_tile = v_ring + stage * S::kTileBytes;
      const int k0 = j * kBK;

      // S = q k^T: HD / 16 steps of 16 columns, 4 per 128-byte chunk
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
      mbar_wait(k_full + 8 * stage, parity);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Mma<kBK>::ss(
            s, desc(q_rows + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
            desc(k_tile + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // scores in log2 units, then the causal and ragged-edge mask
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          s[i] = tanhf(s[i] * scale / softcap) * softcap * kLog2e;
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) s[i] *= scale_log2;
      }
      if (k0 + kBK - 1 > qw || k0 + kBK > skv) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int k_pos = k0 + 8 * (i / 4) + col + i % 2;
          const int q_pos = qw + row + 8 * ((i / 2) % 2);
          if (k_pos > q_pos || k_pos >= skv) s[i] = kNegInf;
        }
      }

      // online softmax of rows row and row + 8, each spread over 4 lanes;
      // l holds this lane's share of the row sum until the end
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        s[i] = exp2f(s[i] - m[(i / 2) % 2]);
        l[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      // p in bf16 as the A fragments of kBK / 16 steps of 16 keys
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);

      // O += p v: v's 16-key steps are 2048 bytes apart, its 64-column
      // chunks kBK * 128 bytes (the leading byte offset)
      mbar_wait(v_full + 8 * stage, parity);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Mma<HD>::rs(o, p[kk], desc(v_tile + kk * 2048, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(empty + 8 * stage);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int q_pos = qw + row + 8 * r;
      if (q_pos >= sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      // m and the scores are in log2 units (log2(e) folded into the scale)
      if (lse != nullptr && t % 4 == 0)
        lse[(static_cast<long long>(batch) * gridDim.x + head) * sq + q_pos] =
            (m[r] + log2f(den)) * kLn2;
      __nv_bfloat16* dst = out + batch * lo.b + q_pos * lo.s + head * lo.h;
#pragma unroll
      for (int jb = 0; jb < HDR / 8; ++jb)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb + col) =
            __floats2bfloat162_rn(o[4 * jb + 2 * r] / den,
                                  o[4 * jb + 2 * r + 1] / den);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int b, h, hkv, sq, skv;
  Layout lq, lk, lv, lo;
  float scale, softcap;
};

template <int HD, int HDR>
int launch_tc(const Args& a, cudaStream_t stream) {
  using S = tc::Shape<HD>;
  CUtensorMap mq, mk, mv;
  int rc = tensor_map(&mq, a.q, HDR, a.sq, a.h, a.b, a.lq, tc::kBQ);
  if (rc == 0) rc = tensor_map(&mk, a.k, HDR, a.skv, a.hkv, a.b, a.lk, S::kBK);
  if (rc == 0) rc = tensor_map(&mv, a.v, HDR, a.skv, a.hkv, a.b, a.lv, S::kBK);
  if (rc != 0) return rc;
  const int n_qt = (a.sq + tc::kBQ - 1) / tc::kBQ;
  if (a.b > 65535 || n_qt > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tc::flash_attn_tc_kernel<HD, HDR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  tc::flash_attn_tc_kernel<HD, HDR>
      <<<dim3(a.h, a.b, n_qt), tc::kThreads, S::kSmem, stream>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(a.out), a.lse, a.lo, a.sq,
          a.skv,
          a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int HD, int HDR>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f32::smem_bytes<HD>();
  const int n_qt = (a.sq + f32::kBQ - 1) / f32::kBQ;
  if (a.h > 65535 || a.b > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      f32::flash_attn_kernel<HD, HDR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  f32::flash_attn_kernel<HD, HDR>
      <<<dim3(n_qt, a.h, a.b), f32::kThreads, smem, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse,
          a.lq, a.lk, a.lv, a.lo, a.sq, a.skv, a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

// HD: the kernels' tile width; HDR: the operands' head dim (HDR < HD pads
// the tiles with zero columns)
template <int HD, int HDR = HD>
int launch(const Args& a, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_tc<HD, HDR>(a, stream) : launch_f32<HD, HDR>(a, stream);
}

}  // namespace

// q, out (b, sq, h, hd) and k, v (b, skv, hkv, hd), each with element
// strides (sb, ss, sh) for its first three axes and a contiguous last axis,
// 16-byte aligned rows and strides; one dtype: float32 (is_bf16 = 0, CUDA
// cores) or bfloat16 (1, tensor cores). Query head i reads kv head
// i / (h / hkv). hd is 64, 112, 128 or 256 (112 runs the 128-wide kernels
// on zero-padded tiles); softcap <= 0 turns the cap off. lse, when not
// null, receives each query row's natural-log log-sum-exp as float32
// (b, h, sq), contiguous.
// Returns the launch's CUDA error, or hopper::kNoEncoder / kMapError +
// CUresult when a TMA map could not be made.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int b, int h,
    int hkv, int sq, int skv, int hd, int is_bf16, int q_sb, int q_ss,
    int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
    int o_sb, int o_ss, int o_sh, float scale, float softcap, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, b, h, hkv, sq, skv,
               Layout{q_sb, q_ss, q_sh}, Layout{k_sb, k_ss, k_sh},
               Layout{v_sb, v_ss, v_sh}, Layout{o_sb, o_ss, o_sh},
               scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(a, is_bf16, s);
    case 112:
      return launch<128, 112>(a, is_bf16, s);
    case 128:
      return launch<128>(a, is_bf16, s);
    case 256:
      return launch<256>(a, is_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}
