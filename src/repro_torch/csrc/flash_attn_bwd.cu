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
// of its rows into a float32 scratch, then walks the key tiles up to the
// diagonal and accumulates dQ in registers. The kv-tile kernel then owns a
// tile of keys of one kv head: it loops over the G query heads of its
// group and, within each, over the query tiles from the diagonal on,
// accumulating dK and dV in registers. Every sum has one owner and a fixed
// order, so two calls on the same inputs give the same bits.
//
// What bounds it on the H100: operations. The function needs the score
// product again and four more (dV, dP, dK, dQ), 5/2 of the forward's causal
// FLOPs: at llama3.2-3b's training shape (B=2, S=4096, H=24, Hkv=8, hd 128)
// 10 * (S (S + 1) / 2) * hd * B * H = 5.15e11 FLOPs, 0.52 ms at 989 TFLOP/s
// bf16, against 0.25 GB of operands (0.08 ms at 3.35 TB/s). This design
// issues 7/2 of the forward's FLOPs: the query-tile kernel forms S and dP
// again (3/2), beside the kv-tile kernel's four products (2). One kernel
// that also summed dQ would issue 5/2, but every deterministic way to sum
// dQ across kv tiles costs more than it saves here (float32 atomics are not
// bit-reproducible; ordered semaphores wait on blocks that may not be
// resident; float32 partials, one set a 128-key tile, are ~1.7 GB at
// llama's shape).
//
// bfloat16 at head dims 64, 112 and 128 (tc::flash_bwd_dq_tc_kernel,
// tc::flash_bwd_dkv_tc_kernel): the forward's machinery (hopper.cuh). A
// block of three warpgroups, one block per SM. The last warpgroup is the
// producer (setmaxnreg 24): one thread loads the block's own two tiles once
// and keeps the other operands in flight by TMA through a ring of three
// stages, 128-byte swizzled, with mbarriers that the copies complete and
// that the consumers release. The other two warpgroups (setmaxnreg 240)
// run wgmma m64 products. What shapes the design is registers: a
// 384-thread block puts three warps on each SM sub-partition, so ptxas
// compiles every thread into 168 registers (16384 / (3 x 32)), setmaxnreg
// or not, and a warpgroup that held 64 x 128 of both dK and dV (128 floats
// a thread) beside its two score tiles spilled and had its wgmma
// serialised (2.4 ms where the kernel now takes 1.0 at llama's shape). So
// each consumer keeps one 64-float accumulator:
//   dQ kernel: a block owns 128 queries of one head, 64 a warpgroup; Q and
//     dO are its own tiles, K and V (64 keys a stage, separate barriers)
//     come through the ring up to the diagonal. S = Q K^T and dP = dO V^T
//     by `ss` (K and V K-major), dS in registers, dQ += dS K by `rs` (dS
//     packed to bf16 into A fragments, K read N-major). Before its first
//     tile each thread takes D of its two rows from global dO and out (four
//     lanes a row, summed by shuffles) and stores D and lse in log2 units
//     for every row of the block into the scratch, rows past Sq as zeros.
//   dK/dV kernel: a block owns 64 keys of one kv head; K and V are its own
//     tiles, and for each query head of the group, each 64-query tile from
//     the diagonal on comes through the ring: Q and dO by TMA, and that
//     tile's lse and D as two 256-byte bulk copies from the scratch (its
//     rows padded to a multiple of 128 so that every copy is aligned; the
//     model's lse, (B, H, Sq) with Sq = 777, is not). Warpgroup 0 forms S^T
//     = K Q^T by `ss` and P^T, leaves P^T dscale (float32) in the stage's
//     shared buffer under an mbarrier and accumulates dV += P^T dO by `rs`;
//     warpgroup 1 forms dP^T = V dO^T by `ss`, dS^T = P^T dscale (dP^T - D)
//     from the buffer, and accumulates dK += dS^T Q by `rs` (dO and Q read
//     N-major). Each sum stays in registers across the whole group.
// A dQ warpgroup skips the key tiles wholly above its diagonal (it releases
// the stage unread once it is filled; the branch is on a warp-uniform
// warpgroup index, or ptxas serialises the wgmma around it); the diagonal
// and ragged tiles are masked by position, since TMA's zero fill past Sq or
// Skv is a zero score, not a masked one. Keys that no query sees (Sq < Skv)
// get zero rows of dK and dV. exp2 with log2(e) folded into the scale and
// the lse, as in the forward; P and dS are rounded to bf16 as the operands
// of their products, as the forward rounds p.
//
// bfloat16 at head dim 256 (bf16::flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// mma.sync m16n8k16 on the tensor cores, operands staged in shared memory
// by plain 16-byte loads, fragments by ldmatrix (row pitch hd + 8
// elements, so the eight rows of an ldmatrix hit distinct banks), 64 rows
// a block against steps of 32. At hd 256 one 64 x 256 accumulator is 128
// floats a thread of a warpgroup, which with a score tile is past the 168
// registers above, so this head dim keeps these kernels: a warp pair shares
// a row group, both form the scores, each accumulates half of the columns
// (128 floats a thread). The entry point dispatches by head dim.
//
// float32: the CUDA cores (TF32 would break float32 parity with the plain
// version), 256 threads on tiles of 32 rows, each product a loop of FMAs
// over shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::Layout;
using bf = __nv_bfloat16;

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
// bfloat16, head dims 64, 112, 128: wgmma, a TMA ring, warp specialisation
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kQueries = 64 * kConsumers;      // queries a dQ block
constexpr int kKeys = 64;                      // keys a dK/dV block
constexpr int kStep = 64;                      // keys (dQ), queries (dK/dV)
constexpr int kStages = 3;                     // ring stages in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Shape {
  static constexpr int kTileBytes = 64 * HD * 2;   // 64 rows of one operand
  static constexpr int kRowBytes = kStep * 4;      // lse or D of a stage
  static constexpr int kWBytes = 64 * kStep * 4;   // P dscale of a stage
  // dQ: Q and dO (kQueries rows each), a ring of K and V; dK/dV: K and V
  // (kKeys rows each), a ring of Q, dO, lse, D and P dscale; + 1024 for
  // aligning the swizzled tiles, + 128 for the mbarriers
  static constexpr int kSmemDq =
      2 * kQueries / 64 * kTileBytes + 2 * kStages * kTileBytes + 1024 + 128;
  static constexpr int kSmemDkv =
      2 * kKeys / 64 * kTileBytes +
      kStages * (2 * kTileBytes + 2 * kRowBytes + kWBytes) + 1024 + 128;
};

// the rows a scratch holds for each (batch, head): Sq rounded up to a dQ
// block
__host__ __device__ __forceinline__ int padded(int sq) {
  return (sq + kQueries - 1) / kQueries * kQueries;
}

// the warpgroup of this thread, as a value the compiler knows to be the
// same across the warp (branches on it are not divergent, so they do not
// serialise the wgmma around them)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
}

// P = exp(score - lse) for the raw dot s (lse2: lse in log2 units), and
// dscale = dscore/du * scale, so that dS = P dscale (dP - D)
__device__ __forceinline__ float prob(float s, float lse2, float scale,
                                      float softcap, float& dscale) {
  if (softcap > 0.f) {
    const float t = tanhf(s * scale / softcap);
    dscale = (1.f - t * t) * scale;
    return exp2f(t * softcap * kLog2e - lse2);
  }
  dscale = scale;
  return exp2f(s * (scale * kLog2e) - lse2);
}

// the float32 accumulators of a 64 x 64 product, rounded to bf16, as the A
// fragments of four k16 steps
__device__ __forceinline__ void to_a(uint32_t (&a)[kStep / 16][4],
                                     const float (&x)[kStep / 2]) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// d (64 x 64) = A B^T over HD columns: A 64 rows of a block's own tile
// (`rows` rows a chunk), B a ring stage's kStep rows, both K-major
template <int HD>
__device__ __forceinline__ void product_abt(float (&d)[kStep / 2],
                                            uint32_t a, int rows,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    Mma<kStep>::ss(d, desc(a + (kk / 4) * rows * 128 + (kk % 4) * 32, 16,
                           1024),
                   desc(b + (kk / 4) * kStep * 128 + (kk % 4) * 32, 16, 1024),
                   kk > 0);
}

// d (64 x HD) += A (64 x kStep, registers) B: B a ring stage's kStep rows
// read N-major
template <int HD>
__device__ __forceinline__ void product_ab(float (&d)[HD / 2],
                                           const uint32_t (&a)[kStep / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk)
    Mma<HD>::rs(d, a[kk], desc(b + kk * 2048, kStep * 128, 1024));
}

// a warpgroup's 64 x HD accumulators as bf16 rows row0 + its rows, rows at
// or past `limit` and columns at or past HDR not stored
template <int HD, int HDR>
__device__ __forceinline__ void store_rows(bf* out, const float (&acc)[HD / 2],
                                           const Layout& l, int batch,
                                           int head, int row0, int limit) {
  const int t = threadIdx.x % 128;
  const int row = row0 + 16 * (t / 32) + (t % 32) / 4;
  const int col = 2 * (t % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= limit) continue;
    bf* dst = out + batch * l.b + (row + 8 * r) * l.s + head * l.h;
#pragma unroll
    for (int jb = 0; jb < HDR / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb + col) =
          __floats2bfloat162_rn(acc[4 * jb + 2 * r], acc[4 * jb + 2 * r + 1]);
  }
}

// dQ and D: a block owns kQueries queries of one head (heaviest tiles
// first), 64 a consumer warpgroup; K and V tiles of kStep keys through the
// ring up to the diagonal. `scratch` receives D (the first B H padded(Sq)
// floats) and lse in log2 units (the next as many), rows past Sq as zeros
template <int HD, int HDR>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_tc_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_do,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, const bf* __restrict__ o,
    const bf* __restrict__ dout, const float* __restrict__ lse,
    bf* __restrict__ dq, float* __restrict__ scratch, Layout lo, Layout ldo,
    Layout ldq, int sq, int skv, int group, float scale, float softcap) {
  using S = Shape<HD>;
  constexpr int kOwn = kQueries / 64 * S::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t q_tile = base;                    // [chunk][kQueries][64]
  const uint32_t do_tile = q_tile + kOwn;
  const uint32_t k_ring = do_tile + kOwn;          // [stage][chunk][kStep][64]
  const uint32_t v_ring = k_ring + kStages * S::kTileBytes;
  const uint32_t own_full = v_ring + kStages * S::kTileBytes;
  const uint32_t k_full = own_full + 8;            // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQueries;   // heaviest first
  // the last key tile that holds a key at or below this block's last row
  const int last_q = min(q0 + kQueries, sq) - 1;
  const int n_tiles = min((skv + kStep - 1) / kStep, last_q / kStep + 1);
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 == 0) {
      const int kv_head = head / group;
      mbar_expect(own_full, 2 * kOwn);
      for (int c = 0; c < HD / 64; ++c) {
        tma_load(q_tile + c * kQueries * 128, &tm_q, own_full, 64 * c, q0,
                 head, batch);
        tma_load(do_tile + c * kQueries * 128, &tm_do, own_full, 64 * c, q0,
                 head, batch);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect(k_full + 8 * s, S::kTileBytes);
        for (int c = 0; c < HD / 64; ++c)
          tma_load(k_ring + s * S::kTileBytes + c * kStep * 128, &tm_k,
                   k_full + 8 * s, 64 * c, j * kStep, kv_head, batch);
        mbar_expect(v_full + 8 * s, S::kTileBytes);
        for (int c = 0; c < HD / 64; ++c)
          tma_load(v_ring + s * S::kTileBytes + c * kStep * 128, &tm_v,
                   v_full + 8 * s, 64 * c, j * kStep, kv_head, batch);
      }
    }
    return;
  }
  // consumer: query rows [qw, qw + 64) of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % 128;
  const int row = 16 * (t / 32) + (t % 32) / 4;   // and row + 8
  const int col = 2 * (t % 4);                     // of each 8 columns
  const int qw = q0 + 64 * wg;
  const long long bh = static_cast<long long>(batch) * gridDim.x + head;
  const long long pad = padded(sq);

  // D of rows row and row + 8, four lanes a row (16-byte chunks t % 4 +
  // 4 i), summed by shuffles; lse in log2 units
  float dd[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = qw + row + 8 * r;
    float sum = 0.f;
    if (q_pos < sq) {
      const bf* orow = row_ptr(o, lo, batch, q_pos, head);
      const bf* drow = row_ptr(dout, ldo, batch, q_pos, head);
      for (int c = t % 4; c < HDR / 8; c += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
        const bf* ob = reinterpret_cast<const bf*>(&ov);
        const bf* db = reinterpret_cast<const bf*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum = fmaf(__bfloat162float(db[e]), __bfloat162float(ob[e]), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dd[r] = sum;
    lse2[r] = q_pos < sq ? lse[bh * sq + q_pos] * kLog2e : 0.f;
    if (t % 4 == 0) {
      scratch[bh * pad + q_pos] = dd[r];
      scratch[(gridDim.y * gridDim.x + bh) * pad + q_pos] = lse2[r];
    }
  }

  const uint32_t q_rows = q_tile + wg * 64 * 128;
  const uint32_t do_rows = do_tile + wg * 64 * 128;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * kStep;
    if (k0 > qw + 63 || qw >= sq) {   // wholly above the diagonal, or idle:
      // release the stage once it is filled (an earlier release would count
      // towards an earlier phase of the ring)
      mbar_wait(k_full + 8 * stage, parity);
      mbar_arrive(empty + 8 * stage);
      continue;
    }
    const uint32_t k_tile = k_ring + stage * S::kTileBytes;
    const uint32_t v_tile = v_ring + stage * S::kTileBytes;

    // S = Q K^T and dP = dO V^T
    float s[kStep / 2], dp[kStep / 2];
#pragma unroll
    for (int i = 0; i < kStep / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    mbar_wait(k_full + 8 * stage, parity);
    wgmma_fence();
    product_abt<HD>(s, q_rows, kQueries, k_tile);
    wgmma_commit();
    mbar_wait(v_full + 8 * stage, parity);
    product_abt<HD>(dp, do_rows, kQueries, v_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // dS = P dscale (dP - D), masked by position on the diagonal and
    // ragged-key tiles
    const bool edge = k0 + kStep - 1 > qw || k0 + kStep > skv;
#pragma unroll
    for (int i = 0; i < kStep / 2; ++i) {
      const int r = (i / 2) % 2;
      const int k_pos = k0 + 8 * (i / 4) + col + i % 2;
      float dscale;
      float p = prob(s[i], lse2[r], scale, softcap, dscale);
      if (edge && (k_pos > qw + row + 8 * r || k_pos >= skv)) p = 0.f;
      dp[i] = p * dscale * (dp[i] - dd[r]);
    }
    uint32_t a[kStep / 16][4];
    to_a(a, dp);

    // dQ += dS K
    fence_regs(acc);
    wgmma_fence();
    product_ab<HD>(acc, a, k_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(empty + 8 * stage);
  }
  store_rows<HD, HDR>(dq, acc, ldq, batch, head, qw, sq);
}

// dK and dV: a block owns kKeys keys of one kv head (tile 0, which sees the
// most queries, first); for each query head of the group, Q, dO and the
// scratch's lse and D of kStep queries come through the ring from the
// diagonal on. Warpgroup 0 forms S^T = K Q^T and P^T, leaves P^T dscale in
// the stage's shared buffer and accumulates dV += P^T dO; warpgroup 1 forms
// dP^T = V dO^T, then dS^T from the buffer, and accumulates dK += dS^T Q.
// Each holds 64 accumulator floats a thread (hd 128), within the 168
// registers a thread of a 384-thread block has.
template <int HD, int HDR>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_tc_kernel(
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_do,
    const float* __restrict__ scratch, bf* __restrict__ dk,
    bf* __restrict__ dv, Layout ldk, int h, int sq, int skv, int group,
    float scale, float softcap) {
  using S = Shape<HD>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t k_tile = base;                    // [chunk][kKeys][64]
  const uint32_t v_tile = k_tile + S::kTileBytes;
  const uint32_t q_ring = v_tile + S::kTileBytes;  // [stage][chunk][kStep][64]
  const uint32_t do_ring = q_ring + kStages * S::kTileBytes;
  const uint32_t lse_ring = do_ring + kStages * S::kTileBytes;  // [stage][kStep]
  const uint32_t d_ring = lse_ring + kStages * S::kRowBytes;
  const uint32_t w_ring = d_ring + kStages * S::kRowBytes;  // [stage][32][128]
  const uint32_t own_full = w_ring + kStages * S::kWBytes;
  const uint32_t full = own_full + 8;              // + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  const uint32_t w_full = empty + 8 * kStages;

  const int kv_head = blockIdx.x;
  const int batch = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;
  // query tiles from the diagonal on, for each query head of the group
  const int n_q = k0 < sq ? (sq - k0 + kStep - 1) / kStep : 0;
  const int n_tiles = group * n_q;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
      mbar_init(w_full + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 == 0) {
      const long long pad = padded(sq);
      mbar_expect(own_full, 2 * S::kTileBytes);
      for (int c = 0; c < HD / 64; ++c) {
        tma_load(k_tile + c * kKeys * 128, &tm_k, own_full, 64 * c, k0,
                 kv_head, batch);
        tma_load(v_tile + c * kKeys * 128, &tm_v, own_full, 64 * c, k0,
                 kv_head, batch);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int head = kv_head * group + j / n_q;
        const int q0 = k0 + (j % n_q) * kStep;
        const float* rows = scratch + (static_cast<long long>(batch) * h +
                                       head) * pad + q0;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect(full + 8 * s, 2 * S::kTileBytes + 2 * S::kRowBytes);
        for (int c = 0; c < HD / 64; ++c) {
          tma_load(q_ring + s * S::kTileBytes + c * kStep * 128, &tm_q,
                   full + 8 * s, 64 * c, q0, head, batch);
          tma_load(do_ring + s * S::kTileBytes + c * kStep * 128, &tm_do,
                   full + 8 * s, 64 * c, q0, head, batch);
        }
        bulk_load(d_ring + s * S::kRowBytes, rows, S::kRowBytes, full + 8 * s);
        bulk_load(lse_ring + s * S::kRowBytes, rows + gridDim.y * h * pad,
                  S::kRowBytes, full + 8 * s);
      }
    }
    return;
  }
  // consumer: warpgroup 0 the dV side, 1 the dK side, of the block's keys
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % 128;
  const int row = 16 * (t / 32) + (t % 32) / 4;   // and row + 8
  const int col = 2 * (t % 4);                     // of each 8 columns
  const bool dv_side = wg == 0;
  // the shared rings as generic pointers; a thread's P dscale elements sit
  // 128 floats apart, so a warp's accesses are conflict-free
  const auto generic = [&](uint32_t addr) {
    return reinterpret_cast<float*>(smem + (addr - smem_addr(smem)));
  };
  const float* lse_s = generic(lse_ring);
  const float* d_s = generic(d_ring);
  float* w_s = generic(w_ring) + t;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int q0 = k0 + (j % n_q) * kStep;
    const uint32_t q_tile = q_ring + stage * S::kTileBytes;
    const uint32_t do_tile = do_ring + stage * S::kTileBytes;

    // S^T = K Q^T (dV side) or dP^T = V dO^T (dK side)
    float x[kStep / 2];
#pragma unroll
    for (int i = 0; i < kStep / 2; ++i) x[i] = 0.f;
    fence_regs(x);
    mbar_wait(full + 8 * stage, parity);
    wgmma_fence();
    product_abt<HD>(x, dv_side ? k_tile : v_tile, kKeys,
                    dv_side ? q_tile : do_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(x);

    // column c of the tile is query q0 + c, whose lse and D the stage holds
    float* w = w_s + stage * (kStep / 2) * 128;
    if (dv_side) {
      // P^T, masked by position on the diagonal and ragged-query tiles
      const float* ls = lse_s + stage * kStep;
      const bool edge = q0 < k0 + kKeys - 1 || q0 + kStep > sq;
#pragma unroll
      for (int jb = 0; jb < kStep / 8; ++jb) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * jb + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jb + e;
          const int q_pos = q0 + 8 * jb + col + e % 2;
          const int k_pos = k0 + row + 8 * (e / 2);
          float dscale;
          float p = prob(x[i], e % 2 ? l2.y : l2.x, scale, softcap, dscale);
          if (edge && (k_pos > q_pos || q_pos >= sq)) p = 0.f;
          x[i] = p;
          w[i * 128] = p * dscale;
        }
      }
      mbar_arrive(w_full + 8 * stage);
    } else {
      // dS^T = P^T dscale (dP^T - D)
      const float* ds = d_s + stage * kStep;
      mbar_wait(w_full + 8 * stage, parity);
#pragma unroll
      for (int jb = 0; jb < kStep / 8; ++jb) {
        const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * jb + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jb + e;
          x[i] = w[i * 128] * (x[i] - (e % 2 ? d2.y : d2.x));
        }
      }
    }
    uint32_t a[kStep / 16][4];
    to_a(a, x);

    // dV += P^T dO or dK += dS^T Q
    fence_regs(acc);
    wgmma_fence();
    product_ab<HD>(acc, a, dv_side ? do_tile : q_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(empty + 8 * stage);
  }
  store_rows<HD, HDR>(dv_side ? dv : dk, acc, ldk, batch, kv_head, k0, skv);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bfloat16, head dim 256: tensor cores (mma.sync)
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

using hopper::pack_bf16;
using hopper::smem_addr;

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
    const uint32_t af[4] = {pack_bf16(p[j][0], p[j][1]), pack_bf16(p[j][2], p[j][3]),
                            pack_bf16(p[j + 1][0], p[j + 1][1]),
                            pack_bf16(p[j + 1][2], p[j + 1][3])};
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
  float* scratch;
  int b, h, hkv, sq, skv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk;
  float scale, softcap;
};

template <int HD, int HDR>
int launch_tc(const Args& a, cudaStream_t stream) {
  using S = tc::Shape<HD>;
  using hopper::tensor_map;
  const int n_qt = (a.sq + tc::kQueries - 1) / tc::kQueries;
  const int n_kt = (a.skv + tc::kKeys - 1) / tc::kKeys;
  if (n_qt > 65535 || n_kt > 65535) return cudaErrorInvalidValue;
  // the dQ kernel's own tiles in boxes of kQueries rows; every other tile
  // in boxes of 64 rows
  CUtensorMap q_own, do_own, q64, do64, k64, v64;
  int rc = tensor_map(&q_own, a.q, HDR, a.sq, a.h, a.b, a.lq, tc::kQueries);
  if (rc == 0)
    rc = tensor_map(&do_own, a.dout, HDR, a.sq, a.h, a.b, a.ldo,
                    tc::kQueries);
  if (rc == 0) rc = tensor_map(&q64, a.q, HDR, a.sq, a.h, a.b, a.lq, 64);
  if (rc == 0) rc = tensor_map(&do64, a.dout, HDR, a.sq, a.h, a.b, a.ldo, 64);
  if (rc == 0) rc = tensor_map(&k64, a.k, HDR, a.skv, a.hkv, a.b, a.lk, 64);
  if (rc == 0) rc = tensor_map(&v64, a.v, HDR, a.skv, a.hkv, a.b, a.lv, 64);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_bwd_dq_tc_kernel<HD, HDR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemDq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tc::flash_bwd_dkv_tc_kernel<HD, HDR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kSmemDkv);
  if (err != cudaSuccess) return err;
  tc::flash_bwd_dq_tc_kernel<HD, HDR>
      <<<dim3(a.h, a.b, n_qt), tc::kThreads, S::kSmemDq, stream>>>(
          q_own, do_own, k64, v64, static_cast<const bf*>(a.o),
          static_cast<const bf*>(a.dout), a.lse, static_cast<bf*>(a.dq),
          a.scratch, a.lo, a.ldo, a.ldq, a.sq, a.skv, a.h / a.hkv, a.scale,
          a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tc::flash_bwd_dkv_tc_kernel<HD, HDR>
      <<<dim3(a.hkv, a.b, n_kt), tc::kThreads, S::kSmemDkv, stream>>>(
          k64, v64, q64, do64, a.scratch, static_cast<bf*>(a.dk),
          static_cast<bf*>(a.dv), a.ldk, a.h, a.sq, a.skv, a.h / a.hkv,
          a.scale, a.softcap);
  return cudaGetLastError();
}

template <int HD, int HDR>
int launch_sync(const Args& a, cudaStream_t stream) {
  using S = bf16::Shape<HD>;
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
          static_cast<const bf*>(a.dout), static_cast<bf*>(a.dq), a.scratch,
          a.lq, a.lk, a.lv, a.lo, a.ldo, a.ldq, a.sq, a.skv, a.h / a.hkv,
          a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bf16::flash_bwd_dkv_kernel<HD, HDR>
      <<<dim3(n_kt, a.hkv, a.b), S::kThreads, S::kSmem, stream>>>(
          static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
          static_cast<const bf*>(a.v), a.lse, a.scratch,
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
          static_cast<float*>(a.dq), a.scratch, a.lq, a.lk, a.lv, a.lo, a.ldo,
          a.ldq, a.sq, a.skv, a.h / a.hkv, a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32::flash_bwd_dkv_kernel<HD, HDR>
      <<<dim3(n_kt, a.hkv, a.b), f32::kThreads, smem, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), a.lse, a.scratch,
          static_cast<const float*>(a.dout), static_cast<float*>(a.dk),
          static_cast<float*>(a.dv), a.lq, a.lk, a.lv, a.ldo, a.ldk, a.h,
          a.sq, a.skv, a.h / a.hkv, a.scale, a.softcap);
  return cudaGetLastError();
}

// bf16 on the wgmma kernels, but at hd 256 on the mma.sync ones
template <int HD, int HDR = HD>
int launch(const Args& a, bool is_bf16, cudaStream_t stream) {
  if (!is_bf16) return launch_f32<HD, HDR>(a, stream);
  if constexpr (HD == 256)
    return launch_sync<HD, HDR>(a, stream);
  else
    return launch_tc<HD, HDR>(a, stream);
}

}  // namespace

// q, o, dout (b, sq, h, hd) and k, v (b, skv, hkv, hd), each with element
// strides (sb, ss, sh) for its first three axes, a contiguous last axis and
// 16-byte aligned rows and strides; lse (b, h, sq) float32 from the forward
// (natural log); dq (b, sq, h, hd) and dk, dv (b, skv, hkv, hd) contiguous
// outputs and `scratch`, float32 of 2 b h P where P is sq rounded up to a
// multiple of 128 (the first b h sq hold D at hd 256 and in float32), all
// written here. One dtype: float32 (is_bf16 = 0, CUDA cores) or bfloat16
// (1: wgmma at hd 64, 112 and 128, mma.sync at 256). softcap <= 0 turns the
// cap off. Two launches on `stream`; returns the CUDA error of the first
// that fails, hopper::kNoEncoder / kMapError + CUresult when a TMA map
// could not be made, else 0.
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* scratch, int b, int h, int hkv, int sq, int skv, int hd,
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
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, scratch, b, h, hkv, sq, skv,
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
