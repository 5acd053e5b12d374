// Fused population fitness on Hopper's int8 tensor cores.
//
// Replaces the TPU kernel repro/kernels/fitness.py::fitness_errors. For
// every chromosome p and test sample b it runs the approximate tree, clips
// the votes to the chromosome's cap, takes the first-max argmax, compares
// it with the label and counts the correct samples per chromosome; only
// the (P,) counts reach device memory:
//
//   D[(p,b), n] = (x_sel[b, n] >> shift[p, n]) > thr[p, n]     in {0, 1}
//   S[(p,b), l] = sum_n D[(p,b), n] * PATH[l, n]               exact in s32
//   votes[(p,b), class[l]] += (S == target[l])
//   count[p]    = sum_b (first-max argmax_c min(votes, cap[p]) == y[b])
//
// What bounds it on the H100: operations. The path product is an
// s8 x s8 -> s32 matrix product of (P * B) rows by L leaves over N
// comparators, 2 * P * B * N * L = 1.1e12 operations for the har dataset at
// P=512 (0.56 ms at 1979 TOP/s), against a few MB of operands. The TPU
// kernel ran it on the MXU; here it is mma.sync m16n8k32 s8 x s8 -> s32.
//
// Design. Rows are (chromosome, sample) pairs: a block owns one chromosome
// and 256 samples, each of its 8 warps two row tiles of 16. The decisions
// are built once per block: each comparator becomes one byte compare on
// the code (code >= a threshold derived from shift and thr), so four
// decisions cost one __vcmpgeu4 on the codes (held (B, K_pad), K
// contiguous), and a lane keeps the 0/1 bytes of its A registers as bit
// planes in shared memory (two k-steps per word: 1/8 of the bytes), which
// two instructions per register expand again. The path matrix (int8, K
// contiguous: the col B operand as stored, zero past N; leaves past L carry
// a target no score reaches) is staged with shared rows of kc + 16 bytes
// (kc the chunk below), an odd number of 16-byte units, so the 8 leaves of
// one ldmatrix fall on distinct banks. The tiles stream through
// a two-stage cp.async ring that all warps of the block share; at 74
// registers and 88 KB of shared memory (har) three blocks share an SM,
// which hides the ring's barrier better than a deeper ring or 16 warps a
// block (measured: tools/int8_check.py). Per tile and k-step a
// warp reads the B fragments of the tile's 4 n-tiles (two ldmatrix.x4) and
// runs them against both of its row tiles: 128 bytes of shared memory per
// mma, half of what one row tile per warp reads, since those reads and not
// the mma bound a warp that holds one row tile. Each accumulator is
// compared with its leaf's target and a satisfied leaf adds one vote to
// its row's class in a shared-memory table (shared atomics: a row may
// satisfy several leaves). After the last tile each row caps its votes,
// takes the first-max argmax and compares it with its label, and each warp
// adds its count with one integer atomicAdd, so the result is
// deterministic. Every block re-reads its tiles' spans of the path from L2
// (at most 13 x 512 blocks x 384 KB = 2.56 GB per har call).
//
// Any comparator count. A leaf tile needs only the comparators its leaves'
// paths touch: the span [lo, hi) of its tile (`spans`, multiples of 32,
// from the nonzero columns of its 32 path rows). A forest's super-tree is
// block diagonal, so a tile spans one tree (two where it straddles a
// boundary) and the product costs the sum of the trees' products, not the
// dense N x L one; a tree's own tiles start at its root's column. The block
// walks a work list of (tile, chunk): each tile's span in chunks of at
// most kc comparators (kc <= kMaxChunk, the widest span up to that), so
// the ring stages, the byte thresholds and the bit planes hold kc
// comparators whatever N is. The planes cover a window of kc comparators
// that is rebuilt, at the chunk's start, only when a chunk leaves it (a
// five-tree forest rebuilds it about three times a block). Accumulators
// carry across a tile's chunks and vote after its last.
#include "mma_common.cuh"

namespace {

constexpr int kLeafTile = 32;     // leaves per ring stage (4 n-tiles)
constexpr int kWarps = 8;
constexpr int kRowTiles = 2;      // row tiles of 16 per warp
constexpr int kRows = kWarps * kRowTiles * 16;   // 256 rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 1024;   // comparators a block holds at a time
constexpr int kStages = 2;        // ring depth

// shared row of a path tile: kc + 16 bytes, an odd number of 16-byte units
__host__ __device__ constexpr int row_bytes(int kc) { return kc + 16; }

__host__ __device__ constexpr size_t stage_bytes(int kc) {
  return static_cast<size_t>(kLeafTile) * row_bytes(kc) +
         2 * kLeafTile * sizeof(int32_t);
}

// 32-bit plane words of one lane and row tile: two k-steps per word
__host__ __device__ constexpr int plane_words(int kc) {
  return (kc / 32 + 1) / 2;
}

size_t smem_bytes(int kc, int n_classes) {
  return kStages * stage_bytes(kc) +
         sizeof(int32_t) * kRows * static_cast<size_t>(n_classes) +
         2 * static_cast<size_t>(kc) +
         sizeof(uint32_t) * kRowTiles * plane_words(kc) * kThreads;
}

// (code >> shift) > thr  <=>  code >= (thr + 1) << shift for codes in
// [0, 255] and shift >= 0, so each comparator becomes one byte compare:
// `at` holds the least code that fires and `on` is 1 unless none does.
__device__ __forceinline__ void code_threshold(int shift, int thr,
                                               uint8_t& at, uint8_t& on) {
  if (thr < 0) {
    at = 0;
    on = 1;
  } else if (shift >= 8 || thr >= 255 || ((thr + 1) << shift) > 255) {
    at = 0;
    on = 0;
  } else {
    at = static_cast<uint8_t>((thr + 1) << shift);
    on = 1;
  }
}

// Four decision bytes (0 or 1) of a sample row at window comparators
// j0..j0+3 (global comparators w0 + j0 ..).
__device__ __forceinline__ uint32_t decide4(const uint8_t* __restrict__ xrow,
                                            const uint8_t* at,
                                            const uint8_t* on, int j0) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(xrow + j0);
  return __vcmpgeu4(x, *reinterpret_cast<const uint32_t*>(at + j0)) &
         *reinterpret_cast<const uint32_t*>(on + j0);
}

// The epilogue of a leaf tile for one row tile (local rows `row`, row + 8):
// accumulator j against the targets tt[0..32) of its leaves; a satisfied
// leaf adds a vote to its row's class (tt[32 + l]).
__device__ __forceinline__ void vote(const int32_t (&acc)[kLeafTile / 8][4],
                                     const int32_t* tt, int32_t* votes,
                                     int row, int t, int row0, int batch) {
  const bool ok[2] = {row0 + row < batch, row0 + row + 8 < batch};
#pragma unroll
  for (int j = 0; j < kLeafTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = j * 8 + 2 * t + (e & 1);
      if (ok[e >> 1] && acc[j][e] == tt[l])
        atomicAdd(votes + tt[kLeafTile + l] * kRows + row + (e >> 1) * 8, 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) fitness_mma_kernel(
    const uint8_t* __restrict__ x_sel,       // (B, K_pad) codes
    const int32_t* __restrict__ shift,       // (P, N) 8 - effective bits
    const int32_t* __restrict__ thr,         // (P, N) effective thresholds
    const int8_t* __restrict__ path,         // (L_pad, K_pad), {-1, 0, 1}
    const int32_t* __restrict__ spans,       // (L_pad / 32, 2) [lo, hi)
    const int32_t* __restrict__ target,      // (L_pad,) satisfied-leaf score
    const int32_t* __restrict__ leaf_class,  // (L_pad,) in [0, n_classes)
    const int32_t* __restrict__ y,           // (B,) labels, -1 never matches
    const int32_t* __restrict__ vote_cap,    // (P,) vote saturation
    int32_t* __restrict__ correct,           // (P,) zeroed by the caller
    int batch, int n_comp, int k_pad, int l_pad, int n_classes, int kc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rs = row_bytes(kc);
  const size_t sb = stage_bytes(kc);
  int32_t* votes = reinterpret_cast<int32_t*>(smem + kStages * sb);
  uint8_t* at = reinterpret_cast<uint8_t*>(votes + kRows * n_classes);
  uint8_t* on = at + kc;
  uint32_t* planes = reinterpret_cast<uint32_t*>(on + kc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tiles = l_pad / kLeafTile;
  const int words = plane_words(kc);
  const int32_t* sh = shift + static_cast<size_t>(p) * n_comp;
  const int32_t* th = thr + static_cast<size_t>(p) * n_comp;

  // the work list: each tile's span [lo, hi) in chunks of at most kc
  auto chunk_end = [&](int tile, int c0) {
    return min(c0 + kc, __ldg(spans + 2 * tile + 1));
  };
  auto advance = [&](int& tile, int& c0) {
    c0 += kc;
    if (c0 >= __ldg(spans + 2 * tile + 1)) {
      ++tile;
      if (tile < tiles) c0 = __ldg(spans + 2 * tile);
    }
  };
  // the chunk [c0, c1) of a tile's 32 path rows into a stage (rows of kc +
  // 16 bytes), then the tile's targets and classes
  auto issue = [&](int tile, int c0, int stage) {
    uint8_t* st = smem + stage * sb;
    const int units = (chunk_end(tile, c0) - c0) / 16;
    const int8_t* src = path + static_cast<size_t>(tile) * kLeafTile * k_pad + c0;
    for (int c = threadIdx.x; c < kLeafTile * units; c += kThreads) {
      const int r = c / units, u = c - r * units;
      repro::cp_async16(st + r * rs + 16 * u,
                        src + static_cast<size_t>(r) * k_pad + 16 * u, 16);
    }
    int32_t* tt = reinterpret_cast<int32_t*>(st + kLeafTile * rs);
    if (threadIdx.x < 2 * kLeafTile / 4) {
      const int half = threadIdx.x / (kLeafTile / 4);   // 0 target, 1 class
      const int q = (threadIdx.x % (kLeafTile / 4)) * 4;
      const int32_t* from = (half ? leaf_class : target) + tile * kLeafTile;
      repro::cp_async16(tt + half * kLeafTile + q, from + q, 16);
    }
  };

  int it_tile = 0, it_c0 = __ldg(spans);      // the item computed
  int nx_tile = it_tile, nx_c0 = it_c0;       // the next item to issue
  issue(nx_tile, nx_c0, 0);
  repro::cp_async_commit();
  advance(nx_tile, nx_c0);
  for (int i = threadIdx.x; i < kRows * n_classes; i += kThreads) votes[i] = 0;

  // ldmatrix lane addressing: matrix q = lane / 8, its row lane % 8;
  // B matrices (n-tile 2 h, k 0-15), (2 h, 16-31), (2 h + 1, 0-15), ...
  const int mq = lane >> 3;
  const int mr = lane & 7;
  const int b_off = ((mq >> 1) * 8 + mr) * rs + (mq & 1) * 16;
  uint32_t* my_planes = planes + threadIdx.x;
  int w0 = -kc - 1;   // the window [w0, w0 + kc) the planes hold; none yet
  int32_t acc[kRowTiles][kLeafTile / 8][4];
  for (int item = 0; it_tile < tiles; ++item) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();  // the item is in the ring (and votes ready)
    if (nx_tile < tiles) {
      issue(nx_tile, nx_c0, (item + 1) % kStages);
      advance(nx_tile, nx_c0);
    }
    repro::cp_async_commit();
    const int c1 = chunk_end(it_tile, it_c0);
    if (it_c0 < w0 || c1 > w0 + kc) {
      // a new window at the chunk's start: byte thresholds (shared), then
      // this lane's bit planes. Bit 8i + 4 (ks % 2) + q of plane word
      // (rt, ks / 2) is byte i of the lane's A register a_q at window
      // k-step ks of row tile rt: q % 2 picks the row (g or g + 8), q / 2
      // the half of the 32 k. Only this lane reads its words (column
      // threadIdx.x: conflict-free), so they need no barrier.
      w0 = it_c0;
      for (int j = threadIdx.x; j < kc; j += kThreads) {
        uint8_t a = 0, o = 0;
        if (w0 + j < n_comp) code_threshold(sh[w0 + j], th[w0 + j], a, o);
        at[j] = a;
        on[j] = o;
      }
      __syncthreads();
      const int live = min(kc, k_pad - w0) / 32;   // k-steps with codes
      for (int rt = 0; rt < kRowTiles; ++rt) {
        const int r0 = row0 + (warp * kRowTiles + rt) * 16 + g;
        for (int w = 0; w < words; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = r0 + 8 * (q & 1);
              const int ks = 2 * w + h;
              if (r < batch && ks < live)
                word |= decide4(x_sel + static_cast<size_t>(r) * k_pad + w0,
                                at, on, ks * 32 + (q >> 1) * 16 + 4 * t)
                        << (4 * h + q);
            }
          }
          my_planes[(rt * words + w) * kThreads] = word;
        }
      }
    }
    if (it_c0 == __ldg(spans + 2 * it_tile)) {   // the tile's first chunk
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt)
#pragma unroll
        for (int j = 0; j < kLeafTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0;
    }
    const uint8_t* st = smem + (item % kStages) * sb;
    const int ks0 = (it_c0 - w0) / 32;
    const int ks1 = (c1 - w0) / 32;
#pragma unroll 2
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t b[kLeafTile / 16][4];
#pragma unroll
      for (int h = 0; h < kLeafTile / 16; ++h)
        repro::ldmatrix_x4(b[h], st + b_off + h * 16 * rs + (ks - ks0) * 32);
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        const uint32_t plane =
            my_planes[(rt * words + ks / 2) * kThreads] >> (4 * (ks & 1));
        const uint32_t a[4] = {plane & 0x01010101u, (plane >> 1) & 0x01010101u,
                               (plane >> 2) & 0x01010101u,
                               (plane >> 3) & 0x01010101u};
#pragma unroll
        for (int j = 0; j < kLeafTile / 8; ++j)
          repro::mma_s8s8(acc[rt][j], a, b[j / 2][2 * (j % 2)],
                          b[j / 2][2 * (j % 2) + 1]);
      }
    }
    if (c1 == __ldg(spans + 2 * it_tile + 1)) {   // the tile's last chunk
      const int32_t* tt =
          reinterpret_cast<const int32_t*>(st + kLeafTile * rs);
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt)
        vote(acc[rt], tt, votes, (warp * kRowTiles + rt) * 16 + g, t, row0,
             batch);
    }
    advance(it_tile, it_c0);
  }
  __syncthreads();  // every vote is in

  // one row per thread (kThreads == kRows): cap, first-max argmax, label
  static_assert(kThreads == kRows, "one row per thread");
  const int b = row0 + threadIdx.x;
  int ok = 0;
  if (b < batch) {
    const int cap = vote_cap[p];
    int best = -1;
    int pred = 0;
    for (int c = 0; c < n_classes; ++c) {  // first max wins ties
      const int v = min(votes[c * kRows + threadIdx.x], cap);
      if (v > best) {
        best = v;
        pred = c;
      }
    }
    ok = pred == y[b];
  }
  ok = __reduce_add_sync(0xffffffffu, ok);
  if (lane == 0 && ok) atomicAdd(correct + p, ok);
}

cudaError_t launch(const void* x_sel, const void* shift, const void* thr,
                   const void* path, const void* spans, const void* target,
                   const void* leaf_class, const void* y, const void* vote_cap,
                   void* correct, int n_pop, int batch, int n_comp, int k_pad,
                   int l_pad, int n_classes, int kc, cudaStream_t stream) {
  const size_t smem = smem_bytes(kc, n_classes);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err =
      repro::allow_dynamic_smem(fitness_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kRows - 1) / kRows, n_pop);
  fitness_mma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x_sel), static_cast<const int32_t*>(shift),
      static_cast<const int32_t*>(thr), static_cast<const int8_t*>(path),
      static_cast<const int32_t*>(spans), static_cast<const int32_t*>(target),
      static_cast<const int32_t*>(leaf_class), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(vote_cap), static_cast<int32_t*>(correct),
      batch, n_comp, k_pad, l_pad, n_classes, kc);
  return cudaGetLastError();
}

}  // namespace

// x_sel (B, K_pad) uint8, path (L_pad, K_pad) int8, K_pad a multiple of 32
// >= N, L_pad a multiple of 32, spans (L_pad / 32, 2) int32 with each
// [lo, hi) a non-empty multiple-of-32 range within [0, K_pad) holding every
// nonzero path column of its tile, kc a multiple of 32 in [32, 1024]; every
// buffer 16-byte aligned.
extern "C" int repro_fitness_correct_counts(
    const void* x_sel, const void* shift, const void* thr, const void* path,
    const void* spans, const void* target, const void* leaf_class,
    const void* y, const void* vote_cap, void* correct, int n_pop, int batch,
    int n_comp, int k_pad, int l_pad, int n_classes, int kc, void* stream) {
  if (n_pop <= 0 || batch <= 0 || n_pop > 65535 || n_classes <= 0 ||
      k_pad % 32 != 0 || k_pad < n_comp || l_pad <= 0 ||
      l_pad % kLeafTile != 0 || kc % 32 != 0 || kc < 32 || kc > kMaxChunk)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(x_sel, shift, thr, path, spans, target, leaf_class, y,
                vote_cap, correct, n_pop, batch, n_comp, k_pad, l_pad,
                n_classes, kc, s);
}
