// Materialised per-class votes of approximate trees on Hopper.
//
// Replaces the TPU kernel repro/kernels/tree_infer.py::tree_infer_scores:
// for every chromosome p and sample b, the per-class vote counts (P, B, C)
// of the comparator -> path -> leaf -> vote dataflow. The TPU gathered each
// comparator's feature with a one-hot matmul X8 @ SEL; here each thread
// loads x8[b, feature[n]] directly. The caller clips the votes to the vote
// cap and takes the argmax.
//
// What bounds it on the H100: at the serving shapes (P = 1, B <= 1024) the
// launch itself and the bytes of the static operands (path masks, about
// 2*L*N/8 bytes); at the verification shape (P = 1, B = 3090 for har) the
// 2*P*B*N*L operations of the path product. Design (tree_common.cuh): one
// chromosome x 128 samples per block, decisions as a bit set in registers,
// leaf tiles in shared memory, the votes written out.
#include "tree_common.cuh"

namespace {

using repro::kThreads;

template <int NWP>
__global__ void __launch_bounds__(kThreads) tree_infer_kernel(
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
  const repro::Smem s = repro::carve<NWP>(smem, n_comp);
  const int p = blockIdx.y;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool active = b < batch;

  repro::load_chromosome(s, shift + static_cast<size_t>(p) * n_comp,
                         thr + static_cast<size_t>(p) * n_comp, n_comp,
                         n_classes);
  for (int n = threadIdx.x; n < n_comp; n += kThreads) s.feature[n] = feature[n];
  __syncthreads();
  const int32_t* row = x8 + static_cast<size_t>(active ? b : 0) * n_features;
  uint32_t d[NWP];
  repro::decisions<NWP>(
      d, active, [&](int n) { return static_cast<int>(row[s.feature[n]]); }, s,
      n_comp);
  repro::accumulate_votes<NWP>(d, active, pos, neg, target, leaf_class,
                               n_leaves, s);
  if (!active) return;
  int32_t* out = votes + (static_cast<size_t>(p) * batch + b) * n_classes;
  for (int c = 0; c < n_classes; ++c) out[c] = s.votes[c * kThreads + threadIdx.x];
}

template <int NWP>
cudaError_t launch(const void* x8, const void* feature, const void* shift,
                   const void* thr, const void* pos, const void* neg,
                   const void* target, const void* leaf_class, void* votes,
                   int n_pop, int batch, int n_features, int n_comp,
                   int n_leaves, int n_classes, cudaStream_t stream) {
  const size_t smem = repro::smem_bytes(NWP, n_comp, n_classes);
  cudaError_t err = repro::allow_smem(tree_infer_kernel<NWP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kThreads - 1) / kThreads, n_pop);
  tree_infer_kernel<NWP><<<grid, kThreads, smem, stream>>>(
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
  if (n_pop <= 0 || batch <= 0 || n_pop > 65535) return cudaErrorInvalidValue;
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
