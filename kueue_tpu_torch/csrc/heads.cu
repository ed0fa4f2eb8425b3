// Per-ClusterQueue head selection: a segment-min of the workloads'
// effective rank into C bins.
//
//   out[c] = min { rank[i] : cq[i] == c, rank[i] < big_rank }, else big_rank
//
// Replaces kueue_tpu/ops/pallas_kernels.py:_heads_pallas (body
// _make_heads_kernel), which folds W in 256-row tiles against a
// (256 x C_pad) iota compare in int32 on the TPU. Here every row is one
// thread and the reduction is atomicMin on int64, so the TPU version's
// int32 clamp and its padding of C to a multiple of 128 go away.
//
// Bound: bytes. The function reads 8 B of rank and 4 or 8 B of cq per
// row and writes 8 B per bin: about 12*W + 8*C bytes, 0.6 MB at
// W = 50,000 and C = 1,000, which the card moves in well under a
// microsecond. A launch costs more than that, so the kernel is bound by
// launch latency; the design keeps it to one launch per call and keeps
// global atomic traffic to one atomicMin per (block, touched bin):
//   * each block keeps C partial minima in shared memory, initialised
//     to big_rank, and its rows atomicMin into them;
//   * after a barrier the block folds every bin it touched into the
//     output with one global atomicMin;
//   * where 8*C bytes exceed the default 48 KB of shared memory, rows
//     atomicMin straight into global memory instead.
// Minimum is order-independent, so the result is exact whatever order
// the atomics run in. The caller fills `out` with big_rank first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSharedBudget = 48 * 1024;

template <typename CqT, bool kShared>
__global__ void heads_segment_min_kernel(const long long* __restrict__ rank,
                                         const CqT* __restrict__ cq,
                                         long long n, int num_cqs,
                                         long long big_rank,
                                         long long* __restrict__ out) {
  extern __shared__ long long partial[];
  if constexpr (kShared) {
    for (int j = threadIdx.x; j < num_cqs; j += blockDim.x) {
      partial[j] = big_rank;
    }
    __syncthreads();
  }
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n) {
    const long long q = static_cast<long long>(cq[i]);
    const long long r = rank[i];
    if (q >= 0 && q < num_cqs && r < big_rank) {
      if constexpr (kShared) {
        atomicMin(&partial[q], r);
      } else {
        atomicMin(&out[q], r);
      }
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < num_cqs; j += blockDim.x) {
      const long long v = partial[j];
      if (v < big_rank) {
        atomicMin(&out[j], v);
      }
    }
  }
}

template <typename CqT>
cudaError_t launch(const long long* rank, const CqT* cq, long long n,
                   int num_cqs, long long big_rank, long long* out,
                   cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t shared = static_cast<size_t>(num_cqs) * sizeof(long long);
  if (shared <= kSharedBudget) {
    heads_segment_min_kernel<CqT, true>
        <<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(
            rank, cq, n, num_cqs, big_rank, out);
  } else {
    heads_segment_min_kernel<CqT, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            rank, cq, n, num_cqs, big_rank, out);
  }
  return cudaGetLastError();
}

}  // namespace

// rank: int64[n]; cq: int32[n] (cq_bytes = 4) or int64[n] (cq_bytes = 8);
// out: int64[num_cqs], filled with big_rank by the caller. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kueue_heads_segment_min(const void* rank, const void* cq,
                                       int cq_bytes, long long n,
                                       int num_cqs, long long big_rank,
                                       void* out, void* stream) {
  if (n <= 0 || num_cqs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* r = static_cast<const long long*>(rank);
  auto* o = static_cast<long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cq_bytes == 4) {
    return static_cast<int>(
        launch(r, static_cast<const int*>(cq), n, num_cqs, big_rank, o, s));
  }
  if (cq_bytes == 8) {
    return static_cast<int>(launch(r, static_cast<const long long*>(cq), n,
                                   num_cqs, big_rank, o, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
