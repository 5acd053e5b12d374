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
//                                         kSamples x d_words words are built by
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
//
// Any comparator count. The decision tile holds every comparator (d_words
// words a sample); a leaf's masks hold only the words of its own path,
// from its word offset (a multiple of 4, for 16-byte loads), so the
// kernel is instantiated on the widest leaf's span, not on N: a forest's
// leaf sees only its own tree's comparators. A leaf wider than the widest
// instantiation (64 words, 2048 comparators) holds n_seg segments of 64
// words, loaded one after the other, and sums its popcount score per
// sample across them. Where the decision tile does not fit in shared
// memory (past ~29000 comparators), it lives in a global scratch buffer,
// one slice per block.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_common.cuh"

// Mask widths (32-bit words per leaf) the kernels are instantiated for; the
// Python side packs the path masks to the smallest width >= the widest
// leaf's span (in segments of the last width past it).
#define REPRO_NWP_CASES(X) \
  X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(32) X(48) X(64)

namespace {

constexpr int kSamples = 16;  // samples per block
constexpr int kWideNwp = 64;  // the segment width of a leaf past 64 words
constexpr size_t kSmemLimit = 232448;

// Leaf threads a block may have at mask width NWP: as many as the registers
// allow (the masks take 2 * NWP of them), so that a har tree's 589 leaves
// are one round of 608 threads.
template <int NWP>
constexpr int kMaxThreads = NWP <= 24 ? 768 : NWP <= 32 ? 512 : 256;

// Dynamic shared memory of one block, in 32-bit words, 16-byte aligned:
//   d[kSamples * d_words] (unless in global scratch) | votes[kSamples * C]
inline size_t smem_bytes(int d_words, int n_classes, bool d_in_smem) {
  return sizeof(uint32_t) * static_cast<size_t>(kSamples) *
         (static_cast<size_t>(d_in_smem ? d_words : 0) +
          static_cast<size_t>(n_classes));
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
// d[s * d_words + w] (bit k: comparator 32w + k). Warp i builds words i,
// i + warps, ...: each lane holds its comparator's feature, shift and
// threshold once and compares it for every sample. Words of samples past
// `batch` and bits past `n_comp` are 0.
__device__ inline void tile_decisions(uint32_t* __restrict__ d, int d_words,
                                      const int32_t* __restrict__ x8,
                                      const int32_t* __restrict__ feature,
                                      const int32_t* __restrict__ shift,
                                      const int32_t* __restrict__ thr,
                                      int b0, int batch, int n_features,
                                      int n_comp) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int w = threadIdx.x >> 5; w < d_words; w += warps) {
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
      if (lane == 0) d[s * d_words + w] = word;
    }
  }
}

// Count, per sample of the tile and class, the leaves the sample satisfies,
// into votes[s * n_classes + class] (zeroed by the caller). Thread t takes
// leaves t, t + blockDim.x, ...; leaf l's masks are n_seg segments of NWP
// words, covering decision words word_off[l] onwards.
template <int NWP>
__device__ inline void tile_votes(const uint32_t* __restrict__ d, int d_words,
                                  int* __restrict__ votes,
                                  const uint32_t* __restrict__ pos,
                                  const uint32_t* __restrict__ neg,
                                  const int32_t* __restrict__ word_off,
                                  const int32_t* __restrict__ target,
                                  const int32_t* __restrict__ leaf_class,
                                  int n_leaves, int n_seg, int n_samples,
                                  int n_classes) {
  for (int l = threadIdx.x; l < n_leaves; l += blockDim.x) {
    const uint32_t* dl = d + word_off[l];
    const int tgt = target[l];
    int* col = votes + leaf_class[l];
    if constexpr (NWP == kWideNwp) {
      if (n_seg > 1) {  // segment by segment: a popcount score per sample
        int score[kSamples] = {};
        for (int seg = 0; seg < n_seg; ++seg) {
          const size_t m0 = (static_cast<size_t>(l) * n_seg + seg) * NWP;
          const uint4* p4 = reinterpret_cast<const uint4*>(pos + m0);
          const uint4* n4 = reinterpret_cast<const uint4*>(neg + m0);
          uint32_t mp[NWP], mn[NWP];
#pragma unroll
          for (int q = 0; q < NWP / 4; ++q) {
            const uint4 a = __ldg(p4 + q);
            const uint4 b = __ldg(n4 + q);
            mp[4 * q] = a.x; mp[4 * q + 1] = a.y; mp[4 * q + 2] = a.z; mp[4 * q + 3] = a.w;
            mn[4 * q] = b.x; mn[4 * q + 1] = b.y; mn[4 * q + 2] = b.z; mn[4 * q + 3] = b.w;
          }
#pragma unroll
          for (int s = 0; s < kSamples; ++s) {
            const uint4* d4 =
                reinterpret_cast<const uint4*>(dl + s * d_words + seg * NWP);
            int acc = 0;
#pragma unroll
            for (int q = 0; q < NWP / 4; ++q) {
              const uint4 v = d4[q];
              acc += __popc(v.x & mp[4 * q]) - __popc(v.x & mn[4 * q]) +
                     __popc(v.y & mp[4 * q + 1]) - __popc(v.y & mn[4 * q + 1]) +
                     __popc(v.z & mp[4 * q + 2]) - __popc(v.z & mn[4 * q + 2]) +
                     __popc(v.w & mp[4 * q + 3]) - __popc(v.w & mn[4 * q + 3]);
            }
            score[s] += acc;
          }
        }
#pragma unroll
        for (int s = 0; s < kSamples; ++s)
          if (s < n_samples && score[s] == tgt)
            atomicAdd(col + s * n_classes, 1);
        continue;
      }
    }
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
    if (tgt == n_pos) {  // satisfied iff d covers pos and misses neg
#pragma unroll 2
      for (int s = 0; s < n_samples; ++s) {
        const uint4* d4 = reinterpret_cast<const uint4*>(dl + s * d_words);
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
        const uint4* d4 = reinterpret_cast<const uint4*>(dl + s * d_words);
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
    const uint32_t* __restrict__ pos,        // (L, n_seg * NWP) +1 bits
    const uint32_t* __restrict__ neg,        // (L, n_seg * NWP) -1 bits
    const int32_t* __restrict__ word_off,    // (L,) first mask word
    const int32_t* __restrict__ target,      // (L,)
    const int32_t* __restrict__ leaf_class,  // (L,) in [0, n_classes)
    int32_t* __restrict__ votes,             // (P, B, C)
    uint32_t* __restrict__ d_scratch,        // per-block decisions, or null
    int batch, int n_features, int n_comp, int n_leaves, int n_classes,
    int n_seg, int d_words) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int p = blockIdx.y;
  const int b0 = blockIdx.x * kSamples;
  const int n_samples = min(kSamples, batch - b0);
  uint32_t* d = smem;
  int* counts = reinterpret_cast<int*>(smem + kSamples * d_words);
  if (d_scratch != nullptr) {
    d = d_scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                     blockIdx.x) * kSamples * d_words;
    counts = reinterpret_cast<int*>(smem);
  }

  for (int i = threadIdx.x; i < kSamples * n_classes; i += blockDim.x)
    counts[i] = 0;
  tile_decisions(d, d_words, x8, feature,
                 shift + static_cast<size_t>(p) * n_comp,
                 thr + static_cast<size_t>(p) * n_comp, b0, batch,
                 n_features, n_comp);
  __syncthreads();
  tile_votes<NWP>(d, d_words, counts, pos, neg, word_off, target, leaf_class,
                  n_leaves, n_seg, n_samples, n_classes);
  __syncthreads();
  int32_t* out = votes + (static_cast<size_t>(p) * batch + b0) * n_classes;
  for (int i = threadIdx.x; i < n_samples * n_classes; i += blockDim.x)
    out[i] = counts[i];
}

template <int NWP>
cudaError_t launch(const void* x8, const void* feature, const void* shift,
                   const void* thr, const void* pos, const void* neg,
                   const void* word_off, const void* target,
                   const void* leaf_class, void* votes, void* d_scratch,
                   int n_pop, int batch, int n_features, int n_comp,
                   int n_leaves, int n_classes, int n_seg, int d_words,
                   cudaStream_t stream) {
  if (n_seg > 1 && NWP != kWideNwp) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d_words, n_classes, d_scratch == nullptr);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = repro::allow_dynamic_smem(tree_infer_kernel<NWP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kSamples - 1) / kSamples, n_pop);
  tree_infer_kernel<NWP><<<grid, block_threads(n_leaves, kMaxThreads<NWP>),
                           smem, stream>>>(
      static_cast<const int32_t*>(x8), static_cast<const int32_t*>(feature),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(thr),
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const int32_t*>(word_off),
      static_cast<const int32_t*>(target),
      static_cast<const int32_t*>(leaf_class), static_cast<int32_t*>(votes),
      static_cast<uint32_t*>(d_scratch), batch, n_features, n_comp, n_leaves,
      n_classes, n_seg, d_words);
  return cudaGetLastError();
}

}  // namespace

// pos/neg (L, n_seg * nwp) and d_words multiples of 4 words, every
// word_off[l] a multiple of 4 with word_off[l] + n_seg * nwp <= d_words;
// d_scratch null (decisions in shared memory) or ceil(B / 16) * P * 16 *
// d_words words.
extern "C" int repro_tree_infer_scores(
    const void* x8, const void* feature, const void* shift, const void* thr,
    const void* pos, const void* neg, const void* word_off,
    const void* target, const void* leaf_class, void* votes, void* d_scratch,
    int n_pop, int batch, int n_features, int n_comp, int n_leaves,
    int n_classes, int nwp, int n_seg, int d_words, void* stream) {
  if (n_pop <= 0 || batch <= 0 || n_pop > 65535 || n_classes <= 0 ||
      n_seg < 1 || d_words % 4 != 0 || d_words < 4)
    return cudaErrorInvalidValue;
  switch (nwp) {
#define REPRO_CASE(W)                                                        \
  case W:                                                                    \
    return launch<W>(x8, feature, shift, thr, pos, neg, word_off, target,    \
                     leaf_class, votes, d_scratch, n_pop, batch, n_features, \
                     n_comp, n_leaves, n_classes, n_seg, d_words,            \
                     static_cast<cudaStream_t>(stream));
    REPRO_NWP_CASES(REPRO_CASE)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
