// Stuck-at fault lanes of one levelized circuit on Hopper, in one launch.
//
// Replaces no TPU kernel: the JAX package's simulator
// (repro/core/faults.py::FaultSimulator) is jnp, a vmapped gather and
// `where` chain per logic level. This kernel does the same boolean work
// for every lane of a `FaultSimulator.run_masks` call:
//
//   value[g]  = op(value[a[g]], value[b[g]])    every logic gate, in level
//                                               order (NOT, AND, OR, XOR)
//   value[g]  = stuck value of g                where the lane's mask sets g,
//                                               base gates (inputs and
//                                               constants) included
//   class     = sum_i value[out_bit[i]] << i    every sample
//
// Samples are packed 32 to a 32-bit word (bit j of word w is sample
// 32w + j), so one boolean op acts on 32 samples and a stuck value is a
// word of 0s or of 1s. Table rows are the gates in level order: the base
// gates first, then each logic level's gates; a gate's operands are rows of
// lower levels. A link codes a gate's op as its truth table over (a, b),
// so a gate is three bitwise selects a word, and a stuck gate is the same
// selects over a constant table.
//
// A block takes one (lane, tile of T words) unit after another. Its lane
// state is the lane's stuck bits in row order (a mask word and a value
// word for 32 rows), built from the lane's (G,) mask and value bytes read
// in gate order, and the tile's value table, (G, T) words, in shared
// memory. One thread takes one row and all T words of it: it fills the
// base rows from the call's fault-free base words with the override
// applied, then walks the levels in order, one __syncthreads() a level,
// each thread's first link of the next level loaded while it works on
// this one; the epilogue turns the output rows into classes, written
// straight into the (S, B) int32 result.
//
// What bounds it on the H100: not bytes (the (S, G) masks and values and
// the (S, B) classes, ~96 MB for a har campaign: 0.03 ms) nor operations
// (one logic op a gate a word a lane, ~1e9 for that campaign: 0.015 ms at
// 67 T int ops/s), but the chain of levels each unit walks: a level's
// operands are the previous levels' outputs, so each level is a round of
// shared-memory gathers behind a barrier, and a narrow level leaves most
// threads idle. So a unit takes several words (T = 4: the fixed cost of a
// unit, its stuck bits, barriers and loads, spread over 128 samples), read
// and written 16 bytes at a time, and the grid is a few blocks an SM, each
// looping over units.
//
// Any circuit. Where the lane state at T = 4 does not fit in a block's
// shared memory (past 14,304 gates), it lives in a global scratch buffer,
// one region a block, at T = 8.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 232448;
// a link's b row in its low 28 bits, its truth table above them: bit
// 2a + b is op(a, b)
constexpr int kTruthShift = 28;
constexpr int kRowMask = (1 << kTruthShift) - 1;

__host__ __device__ constexpr int log2_of(int t) {
  return t <= 1 ? 0 : 1 + log2_of(t / 2);
}

__host__ __device__ inline size_t round4(size_t words) {
  return (words + 3) / 4 * 4;
}

// Words of a block's lane state: the (G, T) value table, then the stuck
// bits, (mask, value) word pairs for 32 rows each; each part a multiple of
// 4 words, so that every part and every region of the scratch starts on
// 16 bytes.
__host__ __device__ inline size_t state_words(int n_gates, int log_t) {
  return round4(static_cast<size_t>(n_gates) << log_t) +
         round4(2 * static_cast<size_t>((n_gates + 31) / 32));
}

// T words (a multiple of 4) at ``p`` (16-byte aligned) into ``w``.
template <int T>
__device__ inline void load_words(const uint32_t* p, uint32_t (&w)[T]) {
#pragma unroll
  for (int k = 0; k < T; k += 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + k);
    w[k] = q.x;
    w[k + 1] = q.y;
    w[k + 2] = q.z;
    w[k + 3] = q.w;
  }
}

template <int T>
__device__ inline void store_words(uint32_t* p, const uint32_t (&w)[T]) {
#pragma unroll
  for (int k = 0; k < T; k += 4)
    *reinterpret_cast<uint4*>(p + k) =
        make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
}

// Whether row ``r`` is stuck; its stuck word of 0s or 1s into ``word``.
__device__ inline bool stuck_at(const uint2* stuck, int r, uint32_t* word) {
  const uint2 s = stuck[r >> 5];
  *word = 0u - ((s.y >> (r & 31)) & 1u);
  return (s.x >> (r & 31)) & 1u;
}

template <int T>
__global__ void __launch_bounds__(kThreads) fault_lanes_kernel(
    const uint32_t* __restrict__ base,     // (n_base, base_stride) fault-free
    const int2* __restrict__ links,        // (G - n_base,) {a row, b | truth}
    const int32_t* __restrict__ level_off, // (n_levels + 1,) first rows
    const int32_t* __restrict__ gate_row,  // (G,) row of each gate id
    const int32_t* __restrict__ out_rows,  // (n_out,) rows of the class bits
    const uint8_t* __restrict__ mask,      // (S, G) stuck, by gate id
    const uint8_t* __restrict__ value,     // (S, G) stuck value, by gate id
    int32_t* __restrict__ cls,             // (S, B) classes
    uint32_t* __restrict__ scratch,        // per-block lane states, or null
    int n_lanes, int batch, int n_gates, int n_base, int n_levels, int n_out,
    int n_words, int base_stride) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* table =
      scratch == nullptr
          ? smem
          : scratch + static_cast<size_t>(blockIdx.x) *
                          state_words(n_gates, log2_of(T));
  unsigned int* stuck_words =
      table + round4(static_cast<size_t>(n_gates) * T);
  const uint2* stuck = reinterpret_cast<const uint2*>(stuck_words);
  const int bit_words = (n_gates + 31) / 32;
  const int tiles = (n_words + T - 1) / T;
  const long long units = static_cast<long long>(n_lanes) * tiles;

  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int lane = static_cast<int>(unit / tiles);
    const int w0 = static_cast<int>(unit % tiles) * T;
    const uint8_t* m = mask + static_cast<size_t>(lane) * n_gates;
    const uint8_t* v = value + static_cast<size_t>(lane) * n_gates;

    // the lane's stuck bits in row order: its mask read in gate order,
    // four bytes a thread at a time, each set gate's bit put at its row
    for (int i = threadIdx.x; i < 2 * bit_words; i += blockDim.x)
      stuck_words[i] = 0u;
    __syncthreads();
    for (int g0 = threadIdx.x; g0 < n_gates; g0 += 4 * blockDim.x) {
      uint8_t mk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int g = g0 + k * blockDim.x;
        mk[k] = g < n_gates ? m[g] : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (mk[k] == 0) continue;
        const int g = g0 + k * blockDim.x;
        const int r = gate_row[g];
        const unsigned int bit = 1u << (r & 31);
        atomicOr(&stuck_words[2 * (r >> 5)], bit);
        if (v[g] != 0) atomicOr(&stuck_words[2 * (r >> 5) + 1], bit);
      }
    }
    __syncthreads();

    // each thread's first link of a level is loaded a level ahead, so that
    // its latency passes while the rows below it are made
    int2 ahead = make_int2(0, 0);
    if (n_levels > 0 && n_base + static_cast<int>(threadIdx.x) < level_off[1])
      ahead = links[threadIdx.x];

    // the base rows, overridden (``base`` holds 0 past the last word)
#pragma unroll 4
    for (int r = threadIdx.x; r < n_base; r += blockDim.x) {
      uint32_t w[T];
      load_words<T>(base + static_cast<size_t>(r) * base_stride + w0, w);
      uint32_t sv;
      if (stuck_at(stuck, r, &sv)) {
#pragma unroll
        for (int k = 0; k < T; ++k) w[k] = sv;
      }
      store_words<T>(table + static_cast<size_t>(r) * T, w);
    }
    __syncthreads();

    // the logic levels, in order: a level reads only rows below it
    for (int l = 0; l < n_levels; ++l) {
      const int first = level_off[l] + threadIdx.x;
      const int hi = level_off[l + 1];
      const int2 mine = ahead;
      if (l + 1 < n_levels && hi + static_cast<int>(threadIdx.x) <
                                  level_off[l + 2])
        ahead = links[hi + threadIdx.x - n_base];
      for (int r = first; r < hi; r += blockDim.x) {
        const int2 e = r == first ? mine : links[r - n_base];
        const unsigned int truth =
            static_cast<unsigned int>(e.y) >> kTruthShift;
        uint32_t sv;
        const bool st = stuck_at(stuck, r, &sv);
        // the four entries of the gate's table as words; a stuck gate's
        // are its stuck value
        uint32_t t[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          t[k] = st ? sv : 0u - ((truth >> k) & 1u);
        uint32_t a[T], b[T], out[T];
        load_words<T>(table + static_cast<size_t>(e.x) * T, a);
        load_words<T>(table + static_cast<size_t>(e.y & kRowMask) * T, b);
#pragma unroll
        for (int k = 0; k < T; ++k) {
          const uint32_t if_a = (b[k] & t[3]) | (~b[k] & t[2]);
          const uint32_t if_not_a = (b[k] & t[1]) | (~b[k] & t[0]);
          out[k] = (a[k] & if_a) | (~a[k] & if_not_a);
        }
        store_words<T>(table + static_cast<size_t>(r) * T, out);
      }
      __syncthreads();
    }

    // classes of the tile's samples
    int32_t* out = cls + static_cast<size_t>(lane) * batch;
    for (int k = threadIdx.x; k < 32 * T; k += blockDim.x) {
      const int t = k >> 5;
      const int b = ((w0 + t) << 5) + (k & 31);
      if (b < batch) {
        int c = 0;
        for (int o = 0; o < n_out; ++o)
          c |= static_cast<int>(
                   (table[static_cast<size_t>(out_rows[o]) * T + t] >>
                    (k & 31)) & 1u) << o;
        out[b] = c;
      }
    }
    __syncthreads();   // the next unit rewrites the lane state
  }
}

template <int T>
cudaError_t launch(const void* base, const void* links, const void* level_off,
                   const void* gate_row, const void* out_rows,
                   const void* mask, const void* value, void* cls,
                   void* scratch, int n_lanes, int batch, int n_gates,
                   int n_base, int n_levels, int n_out, int n_words,
                   int base_stride, int grid, cudaStream_t stream) {
  const size_t smem =
      scratch == nullptr
          ? sizeof(uint32_t) * state_words(n_gates, log2_of(T))
          : 0;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = repro::allow_dynamic_smem(fault_lanes_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  fault_lanes_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(base), static_cast<const int2*>(links),
      static_cast<const int32_t*>(level_off),
      static_cast<const int32_t*>(gate_row),
      static_cast<const int32_t*>(out_rows),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(value),
      static_cast<int32_t*>(cls), static_cast<uint32_t*>(scratch), n_lanes,
      batch, n_gates, n_base, n_levels, n_out, n_words, base_stride);
  return cudaGetLastError();
}

}  // namespace

// base (n_base, base_stride) uint32 with base_stride a multiple of 8 and
// at least n_words, 0 past word n_words; links (G - n_base,) int2 with
// every row below its own level's first row; level_off (n_levels + 1,)
// with level_off[0] = n_base and level_off[n_levels] = G; masks and values
// (n_lanes, G) bytes; cls (n_lanes, batch) int32 with batch <= 32 n_words.
// T = 2^log_t words a tile, 4 or 8; scratch null (the lane state in
// shared memory) or `grid` regions of state_words(G, log_t) words; `grid`
// blocks loop over the (lane, tile) units.
extern "C" int repro_fault_lanes(
    const void* base, const void* links, const void* level_off,
    const void* gate_row, const void* out_rows, const void* mask,
    const void* value, void* cls, void* scratch, int n_lanes, int batch,
    int n_gates, int n_base, int n_levels, int n_out, int n_words,
    int base_stride, int log_t, int grid, void* stream) {
  if (n_lanes <= 0 || batch <= 0 || n_words <= 0 || grid <= 0 ||
      batch > 32 * n_words || base_stride < n_words || base_stride % 8 ||
      n_base < 0 || n_gates < n_base || n_gates > kRowMask || n_out > 31)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CASE(LOG_T)                                                  \
  case LOG_T:                                                              \
    return launch<1 << LOG_T>(base, links, level_off, gate_row, out_rows,  \
                              mask, value, cls, scratch, n_lanes, batch,   \
                              n_gates, n_base, n_levels, n_out, n_words,   \
                              base_stride, grid, s);
  switch (log_t) {
    REPRO_CASE(2)
    REPRO_CASE(3)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_CASE
}
