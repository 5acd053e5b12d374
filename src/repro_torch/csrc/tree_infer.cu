// Materialised per-class votes of approximate trees on Hopper.
//
// Replaces the TPU kernel repro/kernels/tree_infer.py::tree_infer_scores:
// for every chromosome p and sample b, the per-class vote counts (P, B, C)
// of the comparator -> path -> leaf -> vote dataflow. The TPU gathered each
// comparator's feature with a one-hot matmul X8 @ SEL; here each lane loads
// x8[b, feature[n]] directly. The caller clips the votes to the vote cap
// and takes the argmax.
//
// A block owns one chromosome and a tile of kSamples samples, and spreads
// the leaf axis over its threads:
//
//   d      = (x >> shift) > thr           one bit per comparator; the tile's
//                                         kSamples x NWP words are built by
//                                         warps, 32 comparators of one sample
//                                         per __ballot_sync, into shared
//                                         memory (tile_decisions)
//   score  = popc(d & pos) - popc(d & neg) per leaf, where pos/neg are the
//                                         leaf's +1 / -1 path entries as bit
//                                         masks: exactly d . PATH[l] for any
//                                         path matrix in {-1, 0, 1}
//   sat    = score == target              leaf decode
//   votes[s][class[l]] += sat             shared-memory atomicAdd (exact in
//                                         any order)
//
// One thread takes one leaf at a time (a har tree's 589 leaves are one
// round of 608 threads), holds its masks in registers and runs it against
// every sample of the tile, reading the sample's decision words as a
// broadcast from shared memory (tile_votes). A leaf whose target is its
// number of +1 entries (every leaf of a real tree) is satisfied iff d
// covers pos and misses neg, so its test is two LOP3s a word, in four
// independent chains, and no popcount; any other target takes the popcount
// score. Everything is integer: nothing passes through floating point.
//
// What bounds it on the H100: not bytes (about 7 MB at B = 3090: 2 us) nor
// operations (the 2NL path product per row at the int8 rate: under 1 us),
// but the latency of each block's chain: its decisions, then each sample of
// its tile against its leaves. With kSamples = 16, B = 3090 gives 194
// blocks. Votes are counted with shared-memory atomics and written once,
// so no pass merges partial votes and the output needs no zeroing. The
// fitness kernel's int8 mma.sync path product was the other option for
// P = 1: its 13 row blocks each walk every leaf tile, 3.7x slower than this
// kernel at the verify leg's shape (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_common.cuh"

// Mask widths (32-bit words per leaf) the kernels are instantiated for; the
// Python side packs the path masks to the smallest width >= ceil(N / 32).
#define REPRO_NWP_CASES(X) \
  X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(32) X(48) X(64)

namespace {

constexpr int kSamples = 16;  // samples per block

// Leaf threads a block may have at mask width NWP: as many as the registers
// allow (the masks take 2 * NWP of them), so that a har tree's 589 leaves
// are one round of 608 threads.
template <int NWP>
constexpr int kMaxThreads = NWP <= 24 ? 768 : NWP <= 32 ? 512 : 256;

// Dynamic shared memory of one block, in 32-bit words, 16-byte aligned:
//   d[kSamples * NWP] | votes[kSamples * n_classes]
inline size_t smem_bytes(int nwp, int n_classes) {
  return sizeof(uint32_t) * static_cast<size_t>(kSamples) *
         static_cast<size_t>(nwp + n_classes);
}

// Threads of a block for n_leaves leaves: the fewest leaf rounds of at most
// max_threads threads, then the fewest whole warps that cover the leaves in
// that many rounds.
inline int block_threads(int n_leaves, int max_threads) {
  if (n_leaves <= 0) return 32;
  const int rounds = (n_leaves + max_threads - 1) / max_threads;
  const int per_round = (n_leaves + rounds - 1) / rounds;
  const int threads = (per_round + 31) / 32 * 32;
  return threads < 32 ? 32 : threads;
}

// Decision words of the tile's samples b0 .. b0 + kSamples - 1 into
// d[s * NWP + w] (bit k: comparator 32w + k). Warp i builds words i,
// i + warps, ...: each lane holds its comparator's feature, shift and
// threshold once and compares it for every sample. Words of samples past
// `batch` and bits past `n_comp` are 0.
template <int NWP>
__device__ inline void tile_decisions(uint32_t* __restrict__ d,
                                      const int32_t* __restrict__ x8,
                                      const int32_t* __restrict__ feature,
                                      const int32_t* __restrict__ shift,
                                      const int32_t* __restrict__ thr,
                                      int b0, int batch, int n_features,
                                      int n_comp) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int w = threadIdx.x >> 5; w < NWP; w += warps) {
    const int n = w * 32 + lane;
    const bool live = n < n_comp;
    const int f = live ? feature[n] : 0;
    const int sh = live ? shift[n] : 0;
    const int th = live ? thr[n] : 0;
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      const int b = b0 + s;
      const bool bit =
          live && b < batch &&
          (x8[static_cast<size_t>(b) * n_features + f] >> sh) > th;
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) d[s * NWP + w] = word;
    }
  }
}

// Count, per sample of the tile and class, the leaves the sample satisfies,
// into votes[s * n_classes + class] (zeroed by the caller). Thread t takes
// leaves t, t + blockDim.x, ...
template <int NWP>
__device__ inline void tile_votes(const uint32_t* __restrict__ d,
                                  int* __restrict__ votes,
                                  const uint32_t* __restrict__ pos,
                                  const uint32_t* __restrict__ neg,
                                  const int32_t* __restrict__ target,
                                  const int32_t* __restrict__ leaf_class,
                                  int n_leaves, int n_samples, int n_classes) {
  for (int l = threadIdx.x; l < n_leaves; l += blockDim.x) {
    uint32_t mp[NWP], mn[NWP];
    const uint4* p4 = reinterpret_cast<const uint4*>(pos + static_cast<size_t>(l) * NWP);
    const uint4* n4 = reinterpret_cast<const uint4*>(neg + static_cast<size_t>(l) * NWP);
    int n_pos = 0;
#pragma unroll
    for (int q = 0; q < NWP / 4; ++q) {
      const uint4 a = __ldg(p4 + q);
      const uint4 b = __ldg(n4 + q);
      mp[4 * q] = a.x; mp[4 * q + 1] = a.y; mp[4 * q + 2] = a.z; mp[4 * q + 3] = a.w;
      mn[4 * q] = b.x; mn[4 * q + 1] = b.y; mn[4 * q + 2] = b.z; mn[4 * q + 3] = b.w;
      n_pos += __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
    }
    const int tgt = target[l];
    int* col = votes + leaf_class[l];
    if (tgt == n_pos) {  // satisfied iff d covers pos and misses neg
#pragma unroll 2
      for (int s = 0; s < n_samples; ++s) {
        const uint4* d4 = reinterpret_cast<const uint4*>(d + s * NWP);
        uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;  // four short chains
#pragma unroll
        for (int q = 0; q < NWP / 4; ++q) {
          const uint4 v = d4[q];
          m0 |= (~v.x & mp[4 * q]) | (v.x & mn[4 * q]);
          m1 |= (~v.y & mp[4 * q + 1]) | (v.y & mn[4 * q + 1]);
          m2 |= (~v.z & mp[4 * q + 2]) | (v.z & mn[4 * q + 2]);
          m3 |= (~v.w & mp[4 * q + 3]) | (v.w & mn[4 * q + 3]);
        }
        if ((m0 | m1 | m2 | m3) == 0) atomicAdd(col + s * n_classes, 1);
      }
    } else if (tgt < n_pos) {  // the score d . PATH[l] can reach it
      for (int s = 0; s < n_samples; ++s) {
        const uint4* d4 = reinterpret_cast<const uint4*>(d + s * NWP);
        int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
        for (int q = 0; q < NWP / 4; ++q) {
          const uint4 v = d4[q];
          s0 += __popc(v.x & mp[4 * q]) - __popc(v.x & mn[4 * q]);
          s1 += __popc(v.y & mp[4 * q + 1]) - __popc(v.y & mn[4 * q + 1]);
          s2 += __popc(v.z & mp[4 * q + 2]) - __popc(v.z & mn[4 * q + 2]);
          s3 += __popc(v.w & mp[4 * q + 3]) - __popc(v.w & mn[4 * q + 3]);
        }
        if (s0 + s1 + s2 + s3 == tgt) atomicAdd(col + s * n_classes, 1);
      }
    }  // a target above the leaf's +1 entries is never reached
  }
}

template <int NWP>
__global__ void __launch_bounds__(kMaxThreads<NWP>) tree_infer_kernel(
    const int32_t* __restrict__ x8,          // (B, F) master codes
    const int32_t* __restrict__ feature,     // (N,) feature per comparator
    const int32_t* __restrict__ shift,       // (P, N) 8 - effective bits
    const int32_t* __restrict__ thr,         // (P, N) effective thresholds
    const uint32_t* __restrict__ pos,        // (L, NWP) +1 path entry bits
    const uint32_t* __restrict__ neg,        // (L, NWP) -1 path entry bits
    const int32_t* __restrict__ target,      // (L,)
    const int32_t* __restrict__ leaf_class,  // (L,) in [0, n_classes)
    int32_t* __restrict__ votes,             // (P, B, C)
    int batch, int n_features, int n_comp, int n_leaves, int n_classes) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* d = smem;
  int* counts = reinterpret_cast<int*>(smem + kSamples * NWP);
  const int p = blockIdx.y;
  const int b0 = blockIdx.x * kSamples;
  const int n_samples = min(kSamples, batch - b0);

  for (int i = threadIdx.x; i < kSamples * n_classes; i += blockDim.x)
    counts[i] = 0;
  tile_decisions<NWP>(d, x8, feature,
                      shift + static_cast<size_t>(p) * n_comp,
                      thr + static_cast<size_t>(p) * n_comp, b0, batch,
                      n_features, n_comp);
  __syncthreads();
  tile_votes<NWP>(d, counts, pos, neg, target, leaf_class, n_leaves,
                  n_samples, n_classes);
  __syncthreads();
  int32_t* out = votes + (static_cast<size_t>(p) * batch + b0) * n_classes;
  for (int i = threadIdx.x; i < n_samples * n_classes; i += blockDim.x)
    out[i] = counts[i];
}

template <int NWP>
cudaError_t launch(const void* x8, const void* feature, const void* shift,
                   const void* thr, const void* pos, const void* neg,
                   const void* target, const void* leaf_class, void* votes,
                   int n_pop, int batch, int n_features, int n_comp,
                   int n_leaves, int n_classes, cudaStream_t stream) {
  const size_t smem = smem_bytes(NWP, n_classes);
  cudaError_t err = repro::allow_dynamic_smem(tree_infer_kernel<NWP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kSamples - 1) / kSamples, n_pop);
  tree_infer_kernel<NWP><<<grid, block_threads(n_leaves, kMaxThreads<NWP>),
                           smem, stream>>>(
      static_cast<const int32_t*>(x8), static_cast<const int32_t*>(feature),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(thr),
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const int32_t*>(target),
      static_cast<const int32_t*>(leaf_class), static_cast<int32_t*>(votes),
      batch, n_features, n_comp, n_leaves, n_classes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_tree_infer_scores(
    const void* x8, const void* feature, const void* shift, const void* thr,
    const void* pos, const void* neg, const void* target,
    const void* leaf_class, void* votes, int n_pop, int batch, int n_features,
    int n_comp, int n_leaves, int n_classes, int nwp, void* stream) {
  if (n_pop <= 0 || batch <= 0 || n_pop > 65535 || n_classes <= 0)
    return cudaErrorInvalidValue;
  switch (nwp) {
#define REPRO_CASE(W)                                                        \
  case W:                                                                    \
    return launch<W>(x8, feature, shift, thr, pos, neg, target, leaf_class,  \
                     votes, n_pop, batch, n_features, n_comp, n_leaves,      \
                     n_classes, static_cast<cudaStream_t>(stream));
    REPRO_NWP_CASES(REPRO_CASE)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
