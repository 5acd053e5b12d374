// NSGA-II pairwise domination and the non-dominated sort on Hopper.
//
// Replaces the TPU kernel repro/kernels/domination.py::domination_block
// (and its square case domination_matrix): for minimised objectives,
// dom[i, j] = all_k(a[i,k] <= b[j,k]) and any_k(a[i,k] < b[j,k]); and, with
// it, the front peel the reference runs after that kernel in a
// jax.lax.while_loop (repro/core/nsga2.py::non_dominated_sort, _peel_fronts).
//
// domination_kernel: the (Pi, Pj) bool slab of the TPU kernel's contract.
// Bound by bytes (the Pi * Pj byte matrix; 1 MB at the 1024 pool), and by
// the launch below that. One thread per entry, neighbouring threads on
// neighbouring columns (coalesced byte stores), ragged edges masked in the
// kernel, the matrix written as uint8 {0, 1}, which a torch.bool tensor
// holds as is.
//
// The sort is two launches and no host round trip:
//  1. domination_bits_kernel writes the relation as bits, transposed:
//     rel[w * P + j] bit k says that row 32w + k dominates column j, so
//     column j's words hold its dominators and a warp that reads 32
//     neighbouring columns reads 128 contiguous bytes. A block owns 32
//     columns; its warps take the words in turn (two objectives: 8-byte
//     rows, 32 loads in flight), and the column's dominator count (popc
//     of its words) is summed in shared memory. P^2 / 8 bytes: 128 KB at
//     the 1024 pool.
//  2. peel_kernel, one block of up to 1024 threads, peels every front:
//     the unranked columns with no dominator left get rank r, and each
//     warp's ballot of them adds the front's non-zero words to a list in
//     shared memory; then every unranked column j drops
//     popc(rel[w, j] & front[w]) dominators over that list only. One block
//     barrier a front, and it stops when every column is ranked. The
//     relation is staged in shared memory where it fits (pools up to about
//     1300) and read from global memory (L2) beyond; counts and ranks live
//     in shared memory up to pools of about 29000 and in global memory
//     beyond, so any pool is sorted.
// What bounds the sort is the chain of fronts, not bytes or operations:
// a front costs about 0.7 us of latency (its ballots, list, barrier and
// the dependent loads of the decrement) plus its popcounts, 16 a clock on
// one SM, so 35 fronts at the 1024 pool take some 0.05 ms.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kTileJ = 32;  // columns per block (one warp)
constexpr int kTileI = 8;   // rows per block

__device__ inline bool dominates(const float* __restrict__ a,
                                 const float* __restrict__ b, int m) {
  bool le = true;
  bool lt = false;
#pragma unroll 4
  for (int k = 0; k < m; ++k) {
    le &= a[k] <= b[k];
    lt |= a[k] < b[k];
  }
  return le && lt;
}

__global__ void __launch_bounds__(kTileI * kTileJ) domination_kernel(
    const float* __restrict__ objs_i,  // (Pi, M)
    const float* __restrict__ objs_j,  // (Pj, M)
    uint8_t* __restrict__ dom,         // (Pi, Pj)
    int pi, int pj, int m) {
  const int j = blockIdx.x * kTileJ + threadIdx.x;
  const int i = blockIdx.y * kTileI + threadIdx.y;
  if (i >= pi || j >= pj) return;
  dom[static_cast<size_t>(i) * pj + j] =
      dominates(objs_i + static_cast<size_t>(i) * m,
                objs_j + static_cast<size_t>(j) * m, m);
}

constexpr int kBitsWarps = 16;     // warps per block of the relation
constexpr int kPeelThreads = 1024;
constexpr size_t kSmemLimit = 227 * 1024 - 64;  // beside static smem

__device__ inline uint32_t dominates2(float2 a, float2 b) {
  return (a.x <= b.x) & (a.y <= b.y) & ((a.x < b.x) | (a.y < b.y));
}

__global__ void __launch_bounds__(kTileJ * kBitsWarps) domination_bits_kernel(
    const float* __restrict__ objs,  // (P, M)
    uint32_t* __restrict__ rel,      // (W, P) dominators of each column
    int32_t* __restrict__ counts,    // (P,) dominators of each column
    int p, int m, int words) {
  __shared__ int partial[kBitsWarps][kTileJ];
  const int j = blockIdx.x * kTileJ + threadIdx.x;
  const bool live = j < p;
  const int jj = live ? j : 0;
  // two objectives (the search's) from 8-byte rows, unrolled over the 32
  // rows of a word so that their loads overlap
  const bool pair =
      m == 2 && (reinterpret_cast<uintptr_t>(objs) & 7) == 0;
  const float2* objs2 = reinterpret_cast<const float2*>(objs);
  const float2 bj = pair ? objs2[jj] : make_float2(0.f, 0.f);
  int count = 0;
  for (int w = threadIdx.y; w < words; w += kBitsWarps) {
    uint32_t bits = 0;
    const int i0 = w * 32;
    const int rows = min(32, p - i0);
    if (pair && rows == 32) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        bits |= dominates2(__ldg(objs2 + i0 + k), bj) << k;
    } else if (pair) {
      for (int k = 0; k < rows; ++k)
        bits |= dominates2(__ldg(objs2 + i0 + k), bj) << k;
    } else {
      const float* b = objs + static_cast<size_t>(jj) * m;
      for (int k = 0; k < rows; ++k)
        bits |= static_cast<uint32_t>(
                    dominates(objs + static_cast<size_t>(i0 + k) * m, b, m))
                << k;
    }
    if (live) {
      rel[static_cast<size_t>(w) * p + j] = bits;
      count += __popc(bits);
    }
  }
  partial[threadIdx.y][threadIdx.x] = count;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    int total = 0;
    for (int y = 0; y < kBitsWarps; ++y) total += partial[y][threadIdx.x];
    counts[j] = total;
  }
}

// Shared-memory layout of the peel, in 32-bit words:
//   front[2][2 * W] (two lists of a front's non-zero words as (w, bits)
//   pairs, by parity of the front) | counts[P] rank[P] (kStateSmem) |
//   rel[W * P] (kRelSmem)
inline size_t peel_smem(int p, int words, bool state, bool rel) {
  return sizeof(uint32_t) * (4 * static_cast<size_t>(words) +
                             (state ? 2 * static_cast<size_t>(p) : 0) +
                             (rel ? static_cast<size_t>(words) * p : 0));
}

// One front per iteration and one block barrier per front: a thread owns
// columns j = threadIdx.x (mod blockDim.x) in both phases, so its counts
// and ranks need no barrier between them; the front lists alternate by
// parity, so writing front r + 1's list cannot race with reads of front
// r's; and the list lengths rotate through three counters: front r zeroes
// front r + 1's, whose last reader (front r - 2) finished before the
// barrier of front r - 1.
template <bool kStateSmem, bool kRelSmem>
__global__ void __launch_bounds__(kPeelThreads) peel_kernel(
    const uint32_t* __restrict__ rel_g,  // (W, P)
    int32_t* __restrict__ counts_g,      // (P,) consumed
    int32_t* __restrict__ rank_g,        // (P,) out
    int p, int words) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int n_front[3];
  uint2* fronts = reinterpret_cast<uint2*>(smem);
  uint32_t* next = smem + 4 * static_cast<size_t>(words);
  int32_t* counts = counts_g;
  int32_t* rank = rank_g;
  if constexpr (kStateSmem) {
    counts = reinterpret_cast<int32_t*>(next);
    rank = counts + p;
    next += 2 * static_cast<size_t>(p);
  }
  const uint32_t* rel = rel_g;
  if constexpr (kRelSmem) {
    const size_t n_rel = static_cast<size_t>(words) * p;
    for (size_t i = threadIdx.x; i < n_rel; i += blockDim.x) next[i] = rel_g[i];
    rel = next;
  }
  const int span = words * 32;  // columns rounded up to whole words
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    if constexpr (kStateSmem) counts[j] = counts_g[j];
    rank[j] = -1;
  }
  if (threadIdx.x < 3) n_front[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int stride = blockDim.x;
  for (int r = 0; r < p; ++r) {
    // the front: unranked columns that no unranked column dominates, kept
    // as its non-zero words (in any order: the counts below are sums)
    uint2* front = fronts + (r & 1) * words;
    int* n_words = n_front + r % 3;
    if (threadIdx.x == 0) n_front[(r + 1) % 3] = 0;
    int left = 0;
    for (int j0 = 0; j0 < span; j0 += stride) {
      const int j = j0 + threadIdx.x;
      if (j0 + (threadIdx.x & ~31) >= span) break;  // whole warps leave
      bool in = false;
      if (j < p && rank[j] < 0) {
        if (counts[j] == 0) {
          rank[j] = r;
          in = true;
        } else {
          left = 1;
        }
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, in);
      if (lane == 0 && bits)
        front[atomicAdd(n_words, 1)] = make_uint2(j >> 5, bits);
    }
    if (!__syncthreads_or(left)) break;
    // removing the front drops the dominator count of its dominatees
    const int nw = *n_words;
    for (int j = threadIdx.x; j < p; j += stride) {
      if (rank[j] >= 0) continue;
      int dec = 0;
#pragma unroll 4
      for (int k = 0; k < nw; ++k) {
        const uint2 f = front[k];
        dec += __popc(rel[static_cast<size_t>(f.x) * p + j] & f.y);
      }
      counts[j] -= dec;
    }
  }
  if constexpr (kStateSmem)
    for (int j = threadIdx.x; j < p; j += stride) rank_g[j] = rank[j];
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

// Launch 1 of the sort: rel (W, P) and counts (P,) of objs (P, M),
// W = ceil(P / 32).
extern "C" int repro_domination_bits(const void* objs, void* rel, void* counts,
                                     int p, int m, void* stream) {
  if (p <= 0 || m <= 0) return cudaErrorInvalidValue;
  const int words = (p + 31) / 32;
  const dim3 block(kTileJ, kBitsWarps);
  domination_bits_kernel<<<words, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(objs), static_cast<uint32_t*>(rel),
      static_cast<int32_t*>(counts), p, m, words);
  return cudaGetLastError();
}

// Launch 2 of the sort: rank (P,) int32 from rel and counts (counts is
// consumed: for pools too large for shared memory it is the peel's state).
extern "C" int repro_peel_fronts(const void* rel, void* counts, void* rank,
                                 int p, void* stream) {
  if (p <= 0) return cudaErrorInvalidValue;
  const int words = (p + 31) / 32;
  const bool state = peel_smem(p, words, true, false) <= kSmemLimit;
  const bool in_smem = state && peel_smem(p, words, true, true) <= kSmemLimit;
  const size_t bytes = peel_smem(p, words, state, in_smem);
  auto kernel = in_smem ? peel_kernel<true, true>
                : state ? peel_kernel<true, false>
                        : peel_kernel<false, false>;
  cudaError_t err = repro::allow_dynamic_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int threads = p < kPeelThreads ? (p + 31) / 32 * 32 : kPeelThreads;
  kernel<<<1, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rel), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(rank), p, words);
  return cudaGetLastError();
}
