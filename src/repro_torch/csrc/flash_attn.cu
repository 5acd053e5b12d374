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
// in that order. Both kernels below read q, k, v and write out as (batch,
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
// with v read N-major from shared memory.
// Key tiles wholly above the diagonal are skipped, which gives the same
// result because key tile 0 gives every row a finite max first, and a fully
// masked tile then adds p = 0 with alpha = 1. Only a tile that reaches the
// diagonal or the ragged key edge is masked, by position: TMA's zero fill
// past Skv is a zero score, not a masked one. Query tiles run heaviest first
// across all heads (the tile index is the grid's slowest axis). The output
// is stored from registers, masked at the ragged Sq edge.
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
// stores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// element strides of the (batch, seq, head) axes; hd is contiguous
struct Layout {
  long long b, s, h;
};

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

// rows [row0, row0 + n_rows) of one head (row stride `ld`) into a shared tile
// of row stride `stride`; rows at or past `s` read as zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, long long ld,
                                          int row0, int n_rows, int s) {
  constexpr int kChunks = HD / 4;
  for (int c = threadIdx.x; c < n_rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 4;
    const int g = row0 + r;
    const float4 v = g < s ? load4(src + g * ld + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * stride + d, v);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * kPStride);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, Layout lq,
    Layout lk, Layout lv, Layout lo, int sq, int skv, int group, float scale,
    float softcap) {
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

  load_tile<HD>(qs, kQK, qh, lq.s, q0, kBQ, sq);

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
    load_tile<HD>(ks, kQK, kh, lk.s, k0, kBK, skv);
    load_tile<HD>(vs, HD, vh, lv.s, k0, kBK, skv);
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
    float* row = out + batch * lo.b + q_pos * lo.s + head * lo.h;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
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

constexpr int kBQ = 128;                      // queries per block
constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                    // K and V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Shape {
  static constexpr int kBK = HD == 256 ? 64 : 128;  // keys per tile
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;   // one K or V stage
  static constexpr int kTiles = kQBytes + 2 * kStages * kTileBytes;
  // + 1024 for aligning the swizzled tiles, + 64 for the mbarriers
  static constexpr int kSmem = kTiles + 1024 + 64;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed; a phase that never
// completes is a fault of this kernel, so trap (a launch error) after about
// ten seconds instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// box {64 columns, rows, 1 head, 1 batch} at (col, row, head, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 inputs, float32 accumulator; per thread, d[4 j + e]
// is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of
// the 64 x N tile (w the warp of the warpgroup). `ss` reads A (K-major) and
// B (K-major) from shared memory, `rs` reads A from registers (the same
// fragment layout as d for 16 columns) and B N-major from shared memory.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  // D (64 x 64, float32) (+)= A (64 x 16, smem) * B (16 x 64, smem)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, smem,
  // N-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // D (64 x 128, float32) (+)= A (64 x 16, smem) * B (16 x 128, smem)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, smem,
  // N-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  // D (64 x 256, float32) += A (64 x 16, registers) * B (16 x 256, smem,
  // N-major)
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attn_tc_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    Layout lo, int sq, int skv, int group, float scale, float softcap) {
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
      __nv_bfloat16* dst = out + batch * lo.b + q_pos * lo.s + head * lo.h;
#pragma unroll
      for (int jb = 0; jb < HD / 8; ++jb)
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
  int b, h, hkv, sq, skv;
  Layout lq, lk, lv, lo;
  float scale, softcap;
};

// return codes past the CUDA runtime's errors: cuTensorMapEncodeTiled could
// not be found, or refused a map (kMapError + its CUresult)
constexpr int kNoEncoder = 999;
constexpr int kMapError = 1000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiled encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// the bf16 (batch, rows, heads, hd) tensor at `ptr` as a 4-D TMA map read in
// boxes of {64 columns, box_rows rows}, 128-byte swizzled, zeros past its
// edges
int tensor_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
               int batch, Layout lay, int box_rows) {
  static const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(lay.s) * 2,
                                 static_cast<cuuint64_t>(lay.h) * 2,
                                 static_cast<cuuint64_t>(lay.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

template <int HD>
int launch_tc(const Args& a, cudaStream_t stream) {
  using S = tc::Shape<HD>;
  CUtensorMap mq, mk, mv;
  int rc = tensor_map(&mq, a.q, HD, a.sq, a.h, a.b, a.lq, tc::kBQ);
  if (rc == 0) rc = tensor_map(&mk, a.k, HD, a.skv, a.hkv, a.b, a.lk, S::kBK);
  if (rc == 0) rc = tensor_map(&mv, a.v, HD, a.skv, a.hkv, a.b, a.lv, S::kBK);
  if (rc != 0) return rc;
  const int n_qt = (a.sq + tc::kBQ - 1) / tc::kBQ;
  if (a.b > 65535 || n_qt > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tc::flash_attn_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  tc::flash_attn_tc_kernel<HD>
      <<<dim3(a.h, a.b, n_qt), tc::kThreads, S::kSmem, stream>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(a.out), a.lo, a.sq, a.skv,
          a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f32::smem_bytes<HD>();
  const int n_qt = (a.sq + f32::kBQ - 1) / f32::kBQ;
  if (a.h > 65535 || a.b > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      f32::flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  f32::flash_attn_kernel<HD>
      <<<dim3(n_qt, a.h, a.b), f32::kThreads, smem, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lq,
          a.lk, a.lv, a.lo, a.sq, a.skv, a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int HD>
int launch(const Args& a, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_tc<HD>(a, stream) : launch_f32<HD>(a, stream);
}

}  // namespace

// q, out (b, sq, h, hd) and k, v (b, skv, hkv, hd), each with element
// strides (sb, ss, sh) for its first three axes and a contiguous last axis,
// 16-byte aligned rows and strides; one dtype: float32 (is_bf16 = 0, CUDA
// cores) or bfloat16 (1, tensor cores). Query head i reads kv head
// i / (h / hkv). hd is 64, 128 or 256; softcap <= 0 turns the cap off.
// Returns the launch's CUDA error, or kNoEncoder / kMapError + CUresult when
// a TMA map could not be made.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int b, int h,
    int hkv, int sq, int skv, int hd, int is_bf16, int q_sb, int q_ss,
    int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
    int o_sb, int o_ss, int o_sh, float scale, float softcap, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, out, b, h, hkv, sq, skv,
               Layout{q_sb, q_ss, q_sh}, Layout{k_sb, k_ss, k_sh},
               Layout{v_sb, v_ss, v_sh}, Layout{o_sb, o_ss, o_sh},
               scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(a, is_bf16, s);
    case 128:
      return launch<128>(a, is_bf16, s);
    case 256:
      return launch<256>(a, is_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}
