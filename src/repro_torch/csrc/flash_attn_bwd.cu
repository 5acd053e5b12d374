// Backward of causal GQA flash attention on Hopper: dq, dk, dv from the
// forward's per-row log-sum-exp, deterministic, no atomics.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/flash_attn.py::
// flash_attention has no gradient, and the JAX package trains through its
// jnp chunked_prefill_attention, which XLA differentiates. The port's
// attention is the hand-written forward (flash_attn.cu) on every prefill
// path, so its gradient is a kernel too. For q, out, dout (B, Sq, H, hd),
// k, v (B, Skv, Hkv, hd), query head h on kv head h / G (G = H / Hkv) and
// lse (B, H, Sq), the natural-log log-sum-exp the forward stores, it
// computes the flash-attention-2 equations:
//
//   u   = dot(q, k) * scale                     (float32)
//   s   = cap > 0 ? cap * tanh(u / cap) : u,   masked where k_pos > q_pos
//   P   = exp(s - lse)                          (0 where masked)
//   D   = rowsum(dout * out)                    (float32, per query row)
//   dV  = P^T dout          dP = dout V^T
//   dS  = P * (dP - D) * (cap > 0 ? 1 - tanh^2(u / cap) : 1) * scale
//   dK  = dS^T q            dQ = dS k
//
// dK and dV of a kv head sum over its G query heads. Positions are absolute
// from 0 on both axes, as in the forward; any Sq and Skv (ragged edges are
// masked), head dims 64, 112, 128 and 256 (112 on the 128-wide tiles with
// columns 112-127 loaded as zeros and never stored).
//
// Two launches on the caller's stream. The query-tile kernel first writes D
// of its rows into a float32 scratch (B, H, Sq), then walks the key tiles up
// to the diagonal and accumulates dQ in registers. The kv-tile kernel then
// owns a tile of keys of one kv head: it loops over the G query heads of its
// group and, within each, over the query tiles from the diagonal on,
// accumulating dK and dV in registers. Every sum has one owner and a fixed
// order, so two calls on the same inputs give the same bits.
//
// What bounds it on the H100: operations. The function needs the score
// product again and four more (dV, dP, dK, dQ), 5/2 of the forward's causal
// FLOPs: at llama3.2-3b's training shape (B=2, S=4096, H=24, Hkv=8, hd 128)
// 10 * (S (S + 1) / 2) * hd * B * H = 5.15e11 FLOPs, 0.52 ms at 989 TFLOP/s
// bf16, against 0.25 GB of operands (0.08 ms at 3.35 TB/s). This design
// issues 7/2 of the forward's FLOPs (the query-tile kernel recomputes the
// score and dP products the kv-tile kernel also forms).
//
// bfloat16: mma.sync m16n8k16 (bf16 in, float32 accumulate) on the tensor
// cores, operands staged in shared memory by plain 16-byte loads, fragments
// by ldmatrix (row pitch hd + 8 elements, so the eight rows of an ldmatrix
// hit distinct banks). A warp owns 16 rows (keys or queries) of its block's
// 64; P and dS go from the score accumulators straight into the A fragments
// of the next product, rounded to bf16 as the forward rounds p. At hd 256 a
// warp pair shares a row group: both form the scores, each accumulates half
// of the columns, which keeps the accumulators at 128 floats a thread.
// Neither wgmma nor TMA, nor a load pipeline: a simple kernel first.
//
// float32: the CUDA cores (TF32 would break float32 parity with the plain
// version), 256 threads on tiles of 32 rows, each product a loop of FMAs
// over shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// element strides of the (batch, seq, head) axes; hd is contiguous
struct Layout {
  long long b, s, h;
};

// a row of operand `p` with layout `l`: (batch, seq position, head)
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* p, const Layout& l,
                                            int batch, int pos, int head) {
  return p + batch * l.b + pos * l.s + head * l.h;
}

// score, softcap and its derivative: (s, ds/du) for the raw dot `dot`
__device__ __forceinline__ void capped(float dot, float scale, float softcap,
                                       float& s, float& dcap) {
  const float u = dot * scale;
  if (softcap > 0.f) {
    const float t = tanhf(u / softcap);
    s = t * softcap;
    dcap = 1.f - t * t;
  } else {
    s = u;
    dcap = 1.f;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int kWarpRows = 4;          // row groups of 16 per block
constexpr int kRows = 16 * kWarpRows; // queries (dq) or keys (dkv) a block
constexpr int kStep = 32;             // keys (dq) or queries (dkv) a tile

template <int HD>
struct Shape {
  static constexpr int kSplit = HD > 128 ? 2 : 1;   // column groups
  static constexpr int kCols = HD / kSplit;          // accumulator columns
  static constexpr int kThreads = 32 * kWarpRows * kSplit;
  static constexpr int kLd = HD + 8;                 // smem row pitch
  // two tiles of kRows rows, two of kStep rows, then lse and D of the
  // block's query rows (at most kRows each)
  static constexpr int kSmem =
      (2 * kRows + 2 * kStep) * kLd * 2 + 2 * kRows * 4;
};

using bf = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + n) of one head of a (B, S, heads, hd) operand into a
// shared tile of pitch LD, 16 bytes a thread a step; rows at or past `limit`
// and columns at or past HDR read as zeros
template <int HD, int HDR, int LD, int NT>
__device__ __forceinline__ void load_tile(bf* dst, const bf* src,
                                          const Layout& l, int batch,
                                          int head, int row0, int n,
                                          int limit) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < n * kChunks; c += NT) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit && col < HDR)
      v = *reinterpret_cast<const uint4*>(
          row_ptr(src, l, batch, row0 + r, head) + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// c (16 x N) += A (16 x KD) * B^T: A the 16 rows of a shared tile at `a`,
// B the N rows of a shared tile at `b` (both row-major, pitch LD, K along
// the row)
template <int N, int KD, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], uint32_t a,
                                        uint32_t b, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    ldsm(af, a + ((lane % 16) * LD + kk + 8 * (lane / 16)) * 2);
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      uint32_t bfr[4];
      ldsm(bfr, b + ((n + lane % 8 + 8 * (lane / 16)) * LD + kk +
                     8 * ((lane / 8) % 2)) * 2);
      mma(c[n / 8], af, bfr[0], bfr[1]);
      mma(c[n / 8 + 1], af, bfr[2], bfr[3]);
    }
  }
}

// c (16 x N) += P (16 x KD, the float32 accumulators of a 16 x KD product,
// rounded to bf16) * B: B the KD rows x N columns from column `col0` of a
// shared tile at `b` (row-major, pitch LD, read transposed)
template <int N, int KD, int LD>
__device__ __forceinline__ void mma_pb(float (&c)[N / 8][4],
                                       const float (&p)[KD / 8][4],
                                       uint32_t b, int col0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    const int j = kk / 8;
    const uint32_t af[4] = {pack(p[j][0], p[j][1]), pack(p[j][2], p[j][3]),
                            pack(p[j + 1][0], p[j + 1][1]),
                            pack(p[j + 1][2], p[j + 1][3])};
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      uint32_t bfr[4];
      ldsm_t(bfr, b + ((kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD + col0 +
                       n + 8 * (lane / 16)) * 2);
      mma(c[n / 8], af, bfr[0], bfr[1]);
      mma(c[n / 8 + 1], af, bfr[2], bfr[3]);
    }
  }
}

// store a warp's 16 x kCols float32 accumulators as bf16 rows of a
// contiguous (B, S, heads, hd) output: rows at or past `limit`, columns at
// or past HDR are not stored
template <int HD, int HDR>
__device__ __forceinline__ void store_acc(
    bf* out, const float (&acc)[Shape<HD>::kCols / 8][4], const Layout& l,
    int batch, int head, int row0, int col0, int limit, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= limit) continue;
    bf* dst = out + batch * l.b + row * l.s + head * l.h;
#pragma unroll
    for (int j = 0; j < Shape<HD>::kCols / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane % 4);
      if (col < HDR)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// dQ and D: a block owns kRows queries of one head (heaviest tiles first)
template <int HD, int HDR>
__global__ void __launch_bounds__(Shape<HD>::kThreads) flash_bwd_dq_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k,
    const bf* __restrict__ v, const bf* __restrict__ o,
    const float* __restrict__ lse, const bf* __restrict__ dout,
    bf* __restrict__ dq, float* __restrict__ delta, Layout lq, Layout lk,
    Layout lv, Layout lo, Layout ldo, Layout ldq, int sq, int skv, int group,
    float scale, float softcap) {
  using S = Shape<HD>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* qs = reinterpret_cast<bf*>(smem);
  bf* dos = qs + kRows * LD;
  bf* ks = dos + kRows * LD;
  bf* vs = ks + kStep * LD;
  float* lse_s = reinterpret_cast<float*>(vs + kStep * LD);
  float* d_s = lse_s + kRows;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rw = warp % kWarpRows;   // row group
  const int cg = warp / kWarpRows;   // column group
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const long long bh = static_cast<long long>(batch) * gridDim.y + head;

  load_tile<HD, HDR, LD, S::kThreads>(qs, q, lq, batch, head, q0, kRows, sq);
  load_tile<HD, HDR, LD, S::kThreads>(dos, dout, ldo, batch, head, q0, kRows,
                                      sq);
  for (int r = threadIdx.x; r < kRows; r += S::kThreads)
    lse_s[r] = q0 + r < sq ? lse[bh * sq + q0 + r] : 0.f;
  __syncthreads();

  // D = rowsum(dout * out): each row by one warp, 8 columns a lane, then
  // the lanes' sums by a shuffle tree
  for (int r = warp; r < kRows; r += S::kThreads / 32) {
    float sum = 0.f;
    const int row = q0 + r;
    if (row < sq) {
      for (int col = 8 * lane; col < HDR; col += 256) {
        const uint4 ov = *reinterpret_cast<const uint4*>(
            row_ptr(o, lo, batch, row, head) + col);
        const bf* ob = reinterpret_cast<const bf*>(&ov);
        const bf* db = dos + r * LD + col;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum = fmaf(__bfloat162float(db[e]), __bfloat162float(ob[e]), sum);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      d_s[r] = sum;
      if (row < sq) delta[bh * sq + row] = sum;
    }
  }

  float acc[S::kCols / 8][4];
#pragma unroll
  for (int j = 0; j < S::kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const uint32_t q_rows = smem_addr(qs + 16 * rw * LD);
  const uint32_t do_rows = smem_addr(dos + 16 * rw * LD);
  const uint32_t k_tile = smem_addr(ks);
  const uint32_t v_tile = smem_addr(vs);
  const int last_q = min(q0 + kRows, sq) - 1;
  const int n_tiles = min((skv + kStep - 1) / kStep, last_q / kStep + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kStep;
    __syncthreads();   // the previous tile is read
    load_tile<HD, HDR, LD, S::kThreads>(ks, k, lk, batch, kv_head, k0, kStep,
                                        skv);
    load_tile<HD, HDR, LD, S::kThreads>(vs, v, lv, batch, kv_head, k0, kStep,
                                        skv);
    __syncthreads();

    float s[kStep / 8][4], dp[kStep / 8][4], dcap[kStep / 8][4];
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<kStep, HD, LD>(s, q_rows, k_tile, lane);
    mma_abt<kStep, HD, LD>(dp, do_rows, v_tile, lane);
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rw + lane / 4 + 8 * (e / 2);
        const int q_pos = q0 + r;
        const int k_pos = k0 + 8 * j + 2 * (lane % 4) + e % 2;
        float sc;
        capped(s[j][e], scale, softcap, sc, dcap[j][e]);
        const float p = (k_pos <= q_pos && k_pos < skv && q_pos < sq)
                            ? expf(sc - lse_s[r])
                            : 0.f;
        s[j][e] = p * (dp[j][e] - d_s[r]) * dcap[j][e] * scale;
      }
    mma_pb<S::kCols, kStep, LD>(acc, s, k_tile, cg * S::kCols, lane);
  }
  store_acc<HD, HDR>(dq, acc, ldq, batch, head, q0 + 16 * rw, cg * S::kCols,
                     sq, lane);
}

// dK and dV: a block owns kRows keys of one kv head; loops over the group's
// query heads, then over the query tiles from the diagonal on
template <int HD, int HDR>
__global__ void __launch_bounds__(Shape<HD>::kThreads) flash_bwd_dkv_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k,
    const bf* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const bf* __restrict__ dout,
    bf* __restrict__ dk, bf* __restrict__ dv, Layout lq, Layout lk, Layout lv,
    Layout ldo, Layout ldk, int h, int sq, int skv, int group, float scale,
    float softcap) {
  using S = Shape<HD>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* ks = reinterpret_cast<bf*>(smem);
  bf* vs = ks + kRows * LD;
  bf* qs = vs + kRows * LD;
  bf* dos = qs + kStep * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kStep * LD);
  float* d_s = lse_s + kStep;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rw = warp % kWarpRows;
  const int cg = warp / kWarpRows;
  const int kv_head = blockIdx.y;
  const int batch = blockIdx.z;
  const int k0 = blockIdx.x * kRows;   // tile 0 sees the most queries

  load_tile<HD, HDR, LD, S::kThreads>(ks, k, lk, batch, kv_head, k0, kRows,
                                      skv);
  load_tile<HD, HDR, LD, S::kThreads>(vs, v, lv, batch, kv_head, k0, kRows,
                                      skv);

  float dk_acc[S::kCols / 8][4], dv_acc[S::kCols / 8][4];
#pragma unroll
  for (int j = 0; j < S::kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const uint32_t k_rows = smem_addr(ks + 16 * rw * LD);
  const uint32_t v_rows = smem_addr(vs + 16 * rw * LD);
  const uint32_t q_tile = smem_addr(qs);
  const uint32_t do_tile = smem_addr(dos);
  const int q_first = k0 < skv ? (k0 / kStep) * kStep : sq;
  for (int gi = 0; gi < group; ++gi) {
    const int head = kv_head * group + gi;
    const long long bh = static_cast<long long>(batch) * h + head;
    for (int q0 = q_first; q0 < sq; q0 += kStep) {
      __syncthreads();   // the previous tile is read
      load_tile<HD, HDR, LD, S::kThreads>(qs, q, lq, batch, head, q0, kStep,
                                          sq);
      load_tile<HD, HDR, LD, S::kThreads>(dos, dout, ldo, batch, head, q0,
                                          kStep, sq);
      for (int r = threadIdx.x; r < kStep; r += S::kThreads) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[bh * sq + q0 + r] : 0.f;
        d_s[r] = in ? delta[bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();

      // P^T and dP^T: 16 keys x kStep queries
      float pt[kStep / 8][4], dpt[kStep / 8][4], dcap[kStep / 8][4];
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[j][e] = dpt[j][e] = 0.f;
      mma_abt<kStep, HD, LD>(pt, k_rows, q_tile, lane);
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 16 * rw + lane / 4 + 8 * (e / 2);
          const int c = 8 * j + 2 * (lane % 4) + e % 2;
          const int q_pos = q0 + c;
          float sc;
          capped(pt[j][e], scale, softcap, sc, dcap[j][e]);
          pt[j][e] = (k_pos <= q_pos && k_pos < skv && q_pos < sq)
                         ? expf(sc - lse_s[c])
                         : 0.f;
        }
      mma_pb<S::kCols, kStep, LD>(dv_acc, pt, do_tile, cg * S::kCols, lane);
      mma_abt<kStep, HD, LD>(dpt, v_rows, do_tile, lane);
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + e % 2;
          dpt[j][e] = pt[j][e] * (dpt[j][e] - d_s[c]) * dcap[j][e] * scale;
        }
      mma_pb<S::kCols, kStep, LD>(dk_acc, dpt, q_tile, cg * S::kCols, lane);
    }
  }
  store_acc<HD, HDR>(dk, dk_acc, ldk, batch, kv_head, k0 + 16 * rw,
                     cg * S::kCols, skv, lane);
  store_acc<HD, HDR>(dv, dv_acc, ldk, batch, kv_head, k0 + 16 * rw,
                     cg * S::kCols, skv, lane);
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kRows = 32;        // queries (dq) or keys (dkv) a block
constexpr int kStep = 32;        // keys (dq) or queries (dkv) a tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPLd = kStep + 1;  // pitch of the P and dS tiles

template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 4;   // float4 reads of neighbouring rows hit distinct banks
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * 32 * ld<HD>() + 2 * kRows * kPLd + 2 * 32);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD, int HDR>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const Layout& l, int batch,
                                          int head, int row0, int n,
                                          int limit) {
  constexpr int kChunks = HD / 4;
  for (int c = threadIdx.x; c < n * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit && col < HDR)
      v = load4(row_ptr(src, l, batch, row0 + r, head) + col);
    *reinterpret_cast<float4*>(dst + r * ld<HD>() + col) = v;
  }
}

// the 2 x 2 dots of rows ty, ty + 16 of `a` with rows tx, tx + 16 of `b`
template <int HD>
__device__ __forceinline__ void dots(float (&d)[2][2], const float* a,
                                     const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) d[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float4 x[2], y[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x[i] = load4(a + (ty + 16 * i) * ld<HD>() + c);
      y[i] = load4(b + (tx + 16 * i) * ld<HD>() + c);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        d[i][j] = fmaf(x[i].x, y[j].x, d[i][j]);
        d[i][j] = fmaf(x[i].y, y[j].y, d[i][j]);
        d[i][j] = fmaf(x[i].z, y[j].z, d[i][j]);
        d[i][j] = fmaf(x[i].w, y[j].w, d[i][j]);
      }
  }
}

// acc (rows ty, ty + 16; columns 4 tx + 64 u + e) += w (32 x kStep) * b
// (kStep rows of pitch ld<HD>)
template <int HD>
__device__ __forceinline__ void accumulate(float4 (&acc)[2][HD / 64],
                                           const float* w, const float* b,
                                           int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kStep; ++kk) {
    const float w0 = w[ty * kPLd + kk], w1 = w[(ty + 16) * kPLd + kk];
#pragma unroll
    for (int u = 0; u < HD / 64; ++u) {
      const float4 y = load4(b + kk * ld<HD>() + 4 * tx + 64 * u);
      acc[0][u].x = fmaf(w0, y.x, acc[0][u].x);
      acc[0][u].y = fmaf(w0, y.y, acc[0][u].y);
      acc[0][u].z = fmaf(w0, y.z, acc[0][u].z);
      acc[0][u].w = fmaf(w0, y.w, acc[0][u].w);
      acc[1][u].x = fmaf(w1, y.x, acc[1][u].x);
      acc[1][u].y = fmaf(w1, y.y, acc[1][u].y);
      acc[1][u].z = fmaf(w1, y.z, acc[1][u].z);
      acc[1][u].w = fmaf(w1, y.w, acc[1][u].w);
    }
  }
}

template <int HD, int HDR>
__device__ __forceinline__ void store_acc(float* out,
                                          const float4 (&acc)[2][HD / 64],
                                          const Layout& l, int batch,
                                          int head, int row0, int limit,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= limit) continue;
    float* dst = out + batch * l.b + row * l.s + head * l.h;
#pragma unroll
    for (int u = 0; u < HD / 64; ++u)
      if (4 * tx + 64 * u < HDR)
        *reinterpret_cast<float4*>(dst + 4 * tx + 64 * u) = acc[i][u];
  }
}

template <int HD, int HDR>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ delta, Layout lq, Layout lk,
    Layout lv, Layout lo, Layout ldo, Layout ldq, int sq, int skv, int group,
    float scale, float softcap) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + 32 * ld<HD>();
  float* ks = dos + 32 * ld<HD>();
  float* vs = ks + 32 * ld<HD>();
  float* ds = vs + 32 * ld<HD>();
  float* lse_s = ds + 2 * kRows * kPLd;
  float* d_s = lse_s + 32;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const long long bh = static_cast<long long>(batch) * gridDim.y + head;

  load_tile<HD, HDR>(qs, q, lq, batch, head, q0, kRows, sq);
  load_tile<HD, HDR>(dos, dout, ldo, batch, head, q0, kRows, sq);
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    lse_s[r] = q0 + r < sq ? lse[bh * sq + q0 + r] : 0.f;
  __syncthreads();
  // D = rowsum(dout * out): each row by one warp, a column a lane
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < sq)
      for (int c = lane; c < HDR; c += 32)
        sum = fmaf(dos[r * ld<HD>() + c], row_ptr(o, lo, batch, row, head)[c],
                   sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      d_s[r] = sum;
      if (row < sq) delta[bh * sq + row] = sum;
    }
  }

  float4 acc[2][HD / 64];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < HD / 64; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int last_q = min(q0 + kRows, sq) - 1;
  const int n_tiles = min((skv + kStep - 1) / kStep, last_q / kStep + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kStep;
    __syncthreads();
    load_tile<HD, HDR>(ks, k, lk, batch, kv_head, k0, kStep, skv);
    load_tile<HD, HDR>(vs, v, lv, batch, kv_head, k0, kStep, skv);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots<HD>(s, qs, ks, ty, tx);
    dots<HD>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int q_pos = q0 + r, k_pos = k0 + c;
        float sc, dcap;
        capped(s[i][j], scale, softcap, sc, dcap);
        const float p = (k_pos <= q_pos && k_pos < skv && q_pos < sq)
                            ? expf(sc - lse_s[r])
                            : 0.f;
        ds[r * kPLd + c] = p * (dp[i][j] - d_s[r]) * dcap * scale;
      }
    __syncthreads();
    accumulate<HD>(acc, ds, ks, ty, tx);
  }
  store_acc<HD, HDR>(dq, acc, ldq, batch, head, q0, sq, ty, tx);
}

template <int HD, int HDR>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, Layout lq, Layout lk,
    Layout lv, Layout ldo, Layout ldk, int h, int sq, int skv, int group,
    float scale, float softcap) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + 32 * ld<HD>();
  float* qs = vs + 32 * ld<HD>();
  float* dos = qs + 32 * ld<HD>();
  float* pt = dos + 32 * ld<HD>();
  float* dst = pt + kRows * kPLd;
  float* lse_s = dst + kRows * kPLd;
  float* d_s = lse_s + 32;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kv_head = blockIdx.y, batch = blockIdx.z;
  const int k0 = blockIdx.x * kRows;

  load_tile<HD, HDR>(ks, k, lk, batch, kv_head, k0, kRows, skv);
  load_tile<HD, HDR>(vs, v, lv, batch, kv_head, k0, kRows, skv);

  float4 dk_acc[2][HD / 64], dv_acc[2][HD / 64];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < HD / 64; ++u)
      dk_acc[i][u] = dv_acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_first = k0 < skv ? (k0 / kStep) * kStep : sq;
  for (int gi = 0; gi < group; ++gi) {
    const int head = kv_head * group + gi;
    const long long bh = static_cast<long long>(batch) * h + head;
    for (int q0 = q_first; q0 < sq; q0 += kStep) {
      __syncthreads();
      load_tile<HD, HDR>(qs, q, lq, batch, head, q0, kStep, sq);
      load_tile<HD, HDR>(dos, dout, ldo, batch, head, q0, kStep, sq);
      for (int r = threadIdx.x; r < kStep; r += kThreads) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[bh * sq + q0 + r] : 0.f;
        d_s[r] = in ? delta[bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      dots<HD>(s, ks, qs, ty, tx);    // keys ty + 16 i, queries tx + 16 j
      dots<HD>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const int k_pos = k0 + r, q_pos = q0 + c;
          float sc, dcap;
          capped(s[i][j], scale, softcap, sc, dcap);
          const float p = (k_pos <= q_pos && k_pos < skv && q_pos < sq)
                              ? expf(sc - lse_s[c])
                              : 0.f;
          pt[r * kPLd + c] = p;
          dst[r * kPLd + c] = p * (dp[i][j] - d_s[c]) * dcap * scale;
        }
      __syncthreads();
      accumulate<HD>(dv_acc, pt, dos, ty, tx);
      accumulate<HD>(dk_acc, dst, qs, ty, tx);
    }
  }
  store_acc<HD, HDR>(dk, dk_acc, ldk, batch, kv_head, k0, skv, ty, tx);
  store_acc<HD, HDR>(dv, dv_acc, ldk, batch, kv_head, k0, skv, ty, tx);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o;
  const float* lse;
  const void* dout;
  void *dq, *dk, *dv;
  float* delta;
  int b, h, hkv, sq, skv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk;
  float scale, softcap;
};

template <int HD, int HDR>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using S = bf16::Shape<HD>;
  using bf = __nv_bfloat16;
  const int n_qt = (a.sq + bf16::kRows - 1) / bf16::kRows;
  const int n_kt = (a.skv + bf16::kRows - 1) / bf16::kRows;
  cudaError_t err = cudaFuncSetAttribute(
      bf16::flash_bwd_dq_kernel<HD, HDR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bf16::flash_bwd_dkv_kernel<HD, HDR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kSmem);
  if (err != cudaSuccess) return err;
  bf16::flash_bwd_dq_kernel<HD, HDR>
      <<<dim3(n_qt, a.h, a.b), S::kThreads, S::kSmem, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), static_cast<const bf*>(a.o), a.lse,
          static_cast<const bf*>(a.dout), static_cast<bf*>(a.dq), a.delta,
          a.lq, a.lk, a.lv, a.lo, a.ldo, a.ldq, a.sq, a.skv, a.h / a.hkv,
          a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bf16::flash_bwd_dkv_kernel<HD, HDR>
      <<<dim3(n_kt, a.hkv, a.b), S::kThreads, S::kSmem, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), a.lse, a.delta,
          static_cast<const bf*>(a.dout), static_cast<bf*>(a.dk),
          static_cast<bf*>(a.dv), a.lq, a.lk, a.lv, a.ldo, a.ldk, a.h, a.sq,
          a.skv, a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int HD, int HDR>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(f32::smem_bytes<HD>());
  const int n_qt = (a.sq + f32::kRows - 1) / f32::kRows;
  const int n_kt = (a.skv + f32::kRows - 1) / f32::kRows;
  cudaError_t err = cudaFuncSetAttribute(
      f32::flash_bwd_dq_kernel<HD, HDR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(f32::flash_bwd_dkv_kernel<HD, HDR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  f32::flash_bwd_dq_kernel<HD, HDR>
      <<<dim3(n_qt, a.h, a.b), f32::kThreads, smem, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.o),
          a.lse, static_cast<const float*>(a.dout),
          static_cast<float*>(a.dq), a.delta, a.lq, a.lk, a.lv, a.lo, a.ldo,
          a.ldq, a.sq, a.skv, a.h / a.hkv, a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32::flash_bwd_dkv_kernel<HD, HDR>
      <<<dim3(n_kt, a.hkv, a.b), f32::kThreads, smem, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), a.lse, a.delta,
          static_cast<const float*>(a.dout), static_cast<float*>(a.dk),
          static_cast<float*>(a.dv), a.lq, a.lk, a.lv, a.ldo, a.ldk, a.h,
          a.sq, a.skv, a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int HD, int HDR = HD>
int launch(const Args& a, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<HD, HDR>(a, stream) : launch_f32<HD, HDR>(a, stream);
}

}  // namespace

// q, o, dout (b, sq, h, hd) and k, v (b, skv, hkv, hd), each with element
// strides (sb, ss, sh) for its first three axes, a contiguous last axis and
// 16-byte aligned rows and strides; lse (b, h, sq) float32 from the forward
// (natural log); dq (b, sq, h, hd) and dk, dv (b, skv, hkv, hd) contiguous
// outputs and delta (b, h, sq) float32 scratch, all written here. One dtype:
// float32 (is_bf16 = 0, CUDA cores) or bfloat16 (1, mma.sync). hd is 64,
// 112, 128 or 256; softcap <= 0 turns the cap off. Two launches on `stream`;
// returns the CUDA error of the first that fails, else 0.
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int b, int h, int hkv, int sq, int skv, int hd,
    int is_bf16, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, int d_sb,
    int d_ss, int d_sh, float scale, float softcap, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0 ||
      b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  const long long hd_ll = hd;
  const Layout ldq{static_cast<long long>(sq) * h * hd_ll, h * hd_ll, hd_ll};
  const Layout ldk{static_cast<long long>(skv) * hkv * hd_ll, hkv * hd_ll,
                   hd_ll};
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, delta, b, h, hkv, sq, skv,
               Layout{q_sb, q_ss, q_sh}, Layout{k_sb, k_ss, k_sh},
               Layout{v_sb, v_ss, v_sh}, Layout{o_sb, o_ss, o_sh},
               Layout{d_sb, d_ss, d_sh}, ldq, ldk, scale, softcap};
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
