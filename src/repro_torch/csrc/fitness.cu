// Fused population fitness on Hopper.
//
// Replaces the TPU kernel repro/kernels/fitness.py::fitness_errors. For
// every chromosome p and test sample b it runs the approximate tree
// (comparator array -> path product -> leaf decode -> class votes), clips
// the votes to the chromosome's cap, takes the first-max argmax, compares
// it with the label and counts the correct samples per chromosome. Only the
// (P,) counts reach device memory.
//
// What bounds it on the H100: operations. The path product alone is
// 2*P*B*N*L integer operations (about 1.1e12 for the har dataset at P=512),
// against a few MB of operands. Design: the TPU grid carried votes across a
// sequential leaf axis and counts across a sequential batch axis; Hopper
// blocks run in no order, so each block owns one chromosome x 128 samples,
// keeps each sample's comparator decisions as a bit set in registers, walks
// the leaf axis in shared-memory tiles (tree_common.cuh) with the votes in
// shared memory, and adds its per-chromosome count with one int32 atomicAdd
// per warp. Integer atomics commute, so the counts are deterministic. The
// bit-set form turns 32 multiply-adds of the path product into one AND and
// one population count.
#include "tree_common.cuh"

namespace {

using repro::kThreads;

template <int NWP>
__global__ void __launch_bounds__(kThreads) fitness_kernel(
    const uint8_t* __restrict__ xsel_t,      // (N, B) codes, sample-minor
    const int32_t* __restrict__ shift,       // (P, N) 8 - effective bits
    const int32_t* __restrict__ thr,         // (P, N) effective thresholds
    const uint32_t* __restrict__ pos,        // (L, NWP) +1 path entry bits
    const uint32_t* __restrict__ neg,        // (L, NWP) -1 path entry bits
    const int32_t* __restrict__ target,      // (L,) satisfied-leaf score
    const int32_t* __restrict__ leaf_class,  // (L,) in [0, n_classes)
    const int32_t* __restrict__ y,           // (B,) labels, -1 never matches
    const int32_t* __restrict__ vote_cap,    // (P,) vote saturation
    int32_t* __restrict__ correct,           // (P,) zeroed by the caller
    int batch, int n_comp, int n_leaves, int n_classes) {
  extern __shared__ __align__(16) uint32_t smem[];
  const repro::Smem s = repro::carve<NWP>(smem, n_comp);
  const int p = blockIdx.y;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool active = b < batch;

  repro::load_chromosome(s, shift + static_cast<size_t>(p) * n_comp,
                         thr + static_cast<size_t>(p) * n_comp, n_comp,
                         n_classes);
  __syncthreads();
  uint32_t d[NWP];
  repro::decisions<NWP>(
      d, active,
      [&](int n) {
        return static_cast<int>(xsel_t[static_cast<size_t>(n) * batch + b]);
      },
      s, n_comp);
  repro::accumulate_votes<NWP>(d, active, pos, neg, target, leaf_class,
                               n_leaves, s);

  int ok = 0;
  if (active) {
    const int cap = vote_cap[p];
    int best = -1;
    int pred = 0;
    for (int c = 0; c < n_classes; ++c) {  // first max wins ties
      const int v = min(s.votes[c * kThreads + threadIdx.x], cap);
      if (v > best) {
        best = v;
        pred = c;
      }
    }
    ok = pred == y[b];
  }
  ok = __reduce_add_sync(0xffffffffu, ok);
  if ((threadIdx.x & 31) == 0 && ok) atomicAdd(correct + p, ok);
}

template <int NWP>
cudaError_t launch(const void* xsel_t, const void* shift, const void* thr,
                   const void* pos, const void* neg, const void* target,
                   const void* leaf_class, const void* y, const void* vote_cap,
                   void* correct, int n_pop, int batch, int n_comp,
                   int n_leaves, int n_classes, cudaStream_t stream) {
  const size_t smem = repro::smem_bytes(NWP, n_comp, n_classes);
  cudaError_t err = repro::allow_smem(fitness_kernel<NWP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kThreads - 1) / kThreads, n_pop);
  fitness_kernel<NWP><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(xsel_t), static_cast<const int32_t*>(shift),
      static_cast<const int32_t*>(thr), static_cast<const uint32_t*>(pos),
      static_cast<const uint32_t*>(neg), static_cast<const int32_t*>(target),
      static_cast<const int32_t*>(leaf_class), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(vote_cap), static_cast<int32_t*>(correct),
      batch, n_comp, n_leaves, n_classes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_fitness_correct_counts(
    const void* xsel_t, const void* shift, const void* thr, const void* pos,
    const void* neg, const void* target, const void* leaf_class,
    const void* y, const void* vote_cap, void* correct, int n_pop, int batch,
    int n_comp, int n_leaves, int n_classes, int nwp, void* stream) {
  if (n_pop <= 0 || batch <= 0 || n_pop > 65535) return cudaErrorInvalidValue;
  switch (nwp) {
#define REPRO_CASE(W)                                                       \
  case W:                                                                   \
    return launch<W>(xsel_t, shift, thr, pos, neg, target, leaf_class, y,   \
                     vote_cap, correct, n_pop, batch, n_comp, n_leaves,     \
                     n_classes, static_cast<cudaStream_t>(stream));
    REPRO_NWP_CASES(REPRO_CASE)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
