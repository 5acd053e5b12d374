// Shared device code of the comparator -> path -> leaf -> vote dataflow.
//
// Used by tree_infer.cu (materialised per-class votes). One thread owns
// one (chromosome, sample) pair for the whole leaf axis:
//
//   d      = (x >> shift) > thr           one bit per comparator, kept in
//                                         NWP 32-bit registers
//   score  = popc(d & pos) - popc(d & neg) per leaf, where pos/neg are the
//                                         leaf's +1 / -1 path entries as bit
//                                         masks: exactly d . PATH[l] for any
//                                         path matrix in {-1, 0, 1}
//   sat    = score == target              leaf decode
//   votes[class[l]] += sat                per-thread column in shared memory
//
// The leaf axis is walked in tiles of kLeafTile leaves staged in shared
// memory; every thread of the block reads the same tile entry at the same
// time (a broadcast), so the path masks cost one shared-memory transaction
// per warp. Everything is integer: nothing passes through floating point.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 128;  // samples per block, one per thread
constexpr int kLeafTile = 32;  // leaves staged in shared memory per step

// Dynamic shared memory of one block, in 32-bit words, 16-byte aligned:
//   pos[kLeafTile * NWP] | neg[kLeafTile * NWP] | target[kLeafTile] |
//   cls[kLeafTile] | shift[n_comp] | thr[n_comp] | feature[n_comp] |
//   votes[n_classes * kThreads]   (class-major: votes[c * kThreads + t])
inline size_t smem_bytes(int nwp, int n_comp, int n_classes) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(2 * kLeafTile * nwp) + 2 * kLeafTile +
          3 * static_cast<size_t>(n_comp) +
          static_cast<size_t>(n_classes) * kThreads);
}

struct Smem {
  uint32_t* pos;
  uint32_t* neg;
  int32_t* target;
  int32_t* cls;
  int32_t* shift;
  int32_t* thr;
  int32_t* feature;
  int32_t* votes;
};

template <int NWP>
__device__ inline Smem carve(uint32_t* base, int n_comp) {
  Smem s;
  s.pos = base;
  s.neg = s.pos + kLeafTile * NWP;
  s.target = reinterpret_cast<int32_t*>(s.neg + kLeafTile * NWP);
  s.cls = s.target + kLeafTile;
  s.shift = s.cls + kLeafTile;
  s.thr = s.shift + n_comp;
  s.feature = s.thr + n_comp;
  s.votes = s.feature + n_comp;
  return s;
}

// Stage one chromosome's per-comparator operands and clear the votes.
__device__ inline void load_chromosome(const Smem& s,
                                       const int32_t* __restrict__ shift,
                                       const int32_t* __restrict__ thr,
                                       int n_comp, int n_classes) {
  for (int n = threadIdx.x; n < n_comp; n += kThreads) {
    s.shift[n] = shift[n];
    s.thr[n] = thr[n];
  }
  for (int c = 0; c < n_classes; ++c) s.votes[c * kThreads + threadIdx.x] = 0;
}

// Comparator array for one sample: bit n of d is (x_n >> shift_n) > thr_n.
// `load_x(n)` returns the sample's master code for comparator n.
template <int NWP, typename LoadX>
__device__ inline void decisions(uint32_t (&d)[NWP], bool active, LoadX load_x,
                                 const Smem& s, int n_comp) {
#pragma unroll
  for (int w = 0; w < NWP; ++w) {
    uint32_t word = 0;
    const int n0 = w * 32;
    const int nk = active ? min(32, n_comp - n0) : 0;
    for (int k = 0; k < nk; ++k) {
      const int n = n0 + k;
      word |= static_cast<uint32_t>((load_x(n) >> s.shift[n]) > s.thr[n]) << k;
    }
    d[w] = word;
  }
}

// Walk the leaf axis in shared-memory tiles and count, per class, the
// leaves whose path the sample satisfies. Every thread of the block must
// call this (it synchronises); inactive threads only help with the staging.
template <int NWP>
__device__ inline void accumulate_votes(const uint32_t (&d)[NWP], bool active,
                                        const uint32_t* __restrict__ pos,
                                        const uint32_t* __restrict__ neg,
                                        const int32_t* __restrict__ target,
                                        const int32_t* __restrict__ leaf_class,
                                        int n_leaves, const Smem& s) {
  for (int l0 = 0; l0 < n_leaves; l0 += kLeafTile) {
    const int nl = min(kLeafTile, n_leaves - l0);
    __syncthreads();  // the previous tile has been consumed
    const size_t off = static_cast<size_t>(l0) * NWP;
    for (int i = threadIdx.x; i < nl * NWP; i += kThreads) {
      s.pos[i] = pos[off + i];
      s.neg[i] = neg[off + i];
    }
    for (int i = threadIdx.x; i < nl; i += kThreads) {
      s.target[i] = target[l0 + i];
      s.cls[i] = leaf_class[l0 + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nl; ++j) {
      const uint4* p4 = reinterpret_cast<const uint4*>(s.pos + j * NWP);
      const uint4* n4 = reinterpret_cast<const uint4*>(s.neg + j * NWP);
      int score = 0;
#pragma unroll
      for (int q = 0; q < NWP / 4; ++q) {
        const uint4 a = p4[q];
        const uint4 b = n4[q];
        score += __popc(d[4 * q] & a.x) + __popc(d[4 * q + 1] & a.y) +
                 __popc(d[4 * q + 2] & a.z) + __popc(d[4 * q + 3] & a.w);
        score -= __popc(d[4 * q] & b.x) + __popc(d[4 * q + 1] & b.y) +
                 __popc(d[4 * q + 2] & b.z) + __popc(d[4 * q + 3] & b.w);
      }
      if (score == s.target[j]) s.votes[s.cls[j] * kThreads + threadIdx.x] += 1;
    }
  }
}

// Set the dynamic shared-memory limit of `kernel` when a block needs more
// than the 48 KB available without opting in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

// Mask widths (32-bit words per leaf) the kernels are instantiated for; the
// Python side packs the path masks to the smallest width >= ceil(N / 32).
#define REPRO_NWP_CASES(X) \
  X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(32) X(48) X(64)
