// Per-ClusterQueue head selection: a segment-min of the workloads'
// effective rank into C bins.
//
//   out[c] = min { rank[i] : cq[i] == c, rank[i] < big_rank }, else big_rank
//
// Replaces kueue_tpu/ops/pallas_kernels.py:_heads_pallas (body
// _make_heads_kernel), which folds W in 256-row tiles against a
// (256 x C_pad) iota compare in int32 on the TPU, carrying the minima from
// one grid step to the next. Here the arithmetic is int64, so the TPU
// version's int32 clamp and its padding of C to a multiple of 128 go away.
//
// Bound: bytes. The function reads 8 B of rank and 4 or 8 B of cq per row
// and writes 8 B per bin: 12*W + 8*C bytes, 0.6 MB at the drain's
// W = 50,000 and C = 1,000, well under a microsecond at 3.35 TB/s. A
// launch costs more than that, so the design spends as few launches, and
// as little work outside the rows, as it can. Three branches, chosen by
// the wrapper from the shape alone (ops/heads.py:plan):
//
//   * One thread-block cluster (clusters = 1; the drain's shape). Eight
//     CTAs of 1,024 threads, the portable cluster size, each fold a
//     grid-stride share of the rows into C partial minima in their own
//     shared memory (8 B a bin, at most 227 KB: 29,056 bins). After
//     cluster.sync(), CTA k reads its eighth of the bins from all eight
//     CTAs through distributed shared memory, takes the minimum and stores
//     it straight to `out`. Every bin is written by the kernel, so the
//     caller needs no fill; there is no global atomic; the result does not
//     depend on the order in which rows arrive; and a call is one launch.
//   * Several clusters (clusters > 1; over 65,536 rows, eight clusters):
//     each cluster merges its CTAs as above into its own row of a
//     [clusters, C] scratch, and a second small launch folds the rows into
//     `out`. Two launches and no ticket counter, so nothing is kept on the
//     device between calls. One cluster folds rows at a few hundred GB/s,
//     so at 1,000,000 rows eight clusters take about a third of one's
//     device time (kueue_tpu_torch/bench/profile_kernels.py --sweep).
//   * C beyond shared memory (clusters = 0; no deployment has 29,057
//     ClusterQueues): a fill launch writes big_rank, then one thread per
//     row does a global int64 atomicMin. Two launches.
// Minimum is order-independent, so every branch is exact.
//
// On the H100 (profile_kernels.py) the one-cluster launch takes about
// 5.7 us on the device at the drain's shape: more than the 2.9 us kernel
// plus 1.1 us fill it replaced, since the rows' 64-bit shared-memory
// atomics now go through eight SMs instead of 196 blocks, and two cluster
// barriers come on top. A call's time is set by the host's dispatch, which
// dropping the fill and the device switch cut.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterSize = 8;
constexpr int kClusterThreads = 1024;
constexpr int kUnroll = 8;  // rows whose loads a thread has in flight
constexpr int kThreads = 256;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr int kMaxDevices = 64;

template <typename CqT>
__global__ void __launch_bounds__(kClusterThreads)
    heads_cluster_kernel(const long long* __restrict__ rank,
                         const CqT* __restrict__ cq, long long n, int num_cqs,
                         long long big_rank, long long* __restrict__ rows) {
  extern __shared__ long long partial[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int j = threadIdx.x; j < num_cqs; j += blockDim.x) {
    partial[j] = big_rank;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride * kUnroll) {
    long long q[kUnroll];
    long long r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = i + u * stride;
      q[u] = k < n ? static_cast<long long>(cq[k]) : -1;
      r[u] = k < n ? rank[k] : big_rank;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q[u] >= 0 && q[u] < num_cqs && r[u] < big_rank) {
        atomicMin(&partial[q[u]], r[u]);
      }
    }
  }
  cluster.sync();
  const int me = static_cast<int>(cluster.block_rank());
  const int per = (num_cqs + kClusterSize - 1) / kClusterSize;
  const int hi = min(num_cqs, (me + 1) * per);
  long long* dst = rows + static_cast<long long>(blockIdx.x / kClusterSize) *
                              num_cqs;
  for (int j = me * per + threadIdx.x; j < hi; j += blockDim.x) {
    long long v = partial[j];
#pragma unroll
    for (int b = 0; b < kClusterSize; ++b) {
      const long long w = cluster.map_shared_rank(partial, b)[j];
      v = w < v ? w : v;
    }
    dst[j] = v;
  }
  // No CTA may leave while another still reads its shared memory.
  cluster.sync();
}

__global__ void heads_fold_kernel(const long long* __restrict__ rows,
                                  int num_rows, int num_cqs,
                                  long long* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= num_cqs) {
    return;
  }
  long long v = rows[j];
  for (int k = 1; k < num_rows; ++k) {
    const long long w = rows[static_cast<long long>(k) * num_cqs + j];
    v = w < v ? w : v;
  }
  out[j] = v;
}

__global__ void heads_fill_kernel(long long* __restrict__ out, int num_cqs,
                                  long long big_rank) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < num_cqs) {
    out[j] = big_rank;
  }
}

template <typename CqT>
__global__ void heads_atomic_kernel(const long long* __restrict__ rank,
                                    const CqT* __restrict__ cq, long long n,
                                    int num_cqs, long long big_rank,
                                    long long* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n) {
    const long long q = static_cast<long long>(cq[i]);
    const long long r = rank[i];
    if (q >= 0 && q < num_cqs && r < big_rank) {
      atomicMin(&out[q], r);
    }
  }
}

// Lets heads_cluster_kernel<CqT> take more than the default 48 KB of
// dynamic shared memory on the current device, once per device.
template <typename CqT>
cudaError_t allow_shared(size_t bytes) {
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  if (dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (bytes <= kDefaultShared || bytes <= allowed[dev]) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(heads_cluster_kernel<CqT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) {
    allowed[dev] = bytes;
  }
  return err;
}

template <typename CqT>
cudaError_t launch(const long long* rank, const CqT* cq, long long n,
                   int num_cqs, long long big_rank, int clusters,
                   long long* scratch, long long* out, cudaStream_t stream) {
  if (clusters == 0) {
    const unsigned bins = static_cast<unsigned>(
        (num_cqs + kThreads - 1) / kThreads);
    heads_fill_kernel<<<bins, kThreads, 0, stream>>>(out, num_cqs, big_rank);
    if (n > 0) {
      heads_atomic_kernel<CqT>
          <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
             0, stream>>>(rank, cq, n, num_cqs, big_rank, out);
    }
    return cudaGetLastError();
  }
  if (clusters > 1 && scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  const size_t shared = static_cast<size_t>(num_cqs) * sizeof(long long);
  cudaError_t err = allow_shared<CqT>(shared);
  if (err != cudaSuccess) {
    return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(clusters) * kClusterSize);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = shared;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, heads_cluster_kernel<CqT>, rank, cq, n,
                           num_cqs, big_rank, clusters > 1 ? scratch : out);
  if (err != cudaSuccess || clusters == 1) {
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  heads_fold_kernel<<<static_cast<unsigned>((num_cqs + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, stream>>>(scratch, clusters, num_cqs, out);
  return cudaGetLastError();
}

}  // namespace

// rank: int64[n]; cq: int32[n] (cq_bytes = 4) or int64[n] (cq_bytes = 8);
// out: int64[num_cqs], written in full by the kernel. clusters: 1 for one
// cluster, k > 1 for k clusters folding through scratch (int64[k,
// num_cqs]; unused otherwise), 0 for the global-atomic branch. Launches on
// `stream` and returns the first cudaError_t met (0 = success).
extern "C" int kueue_heads_segment_min(const void* rank, const void* cq,
                                       int cq_bytes, long long n,
                                       int num_cqs, long long big_rank,
                                       int clusters, void* scratch,
                                       void* out, void* stream) {
  if (n < 0 || num_cqs <= 0 || clusters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* r = static_cast<const long long*>(rank);
  auto* sc = static_cast<long long*>(scratch);
  auto* o = static_cast<long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cq_bytes == 4) {
    return static_cast<int>(launch(r, static_cast<const int*>(cq), n,
                                   num_cqs, big_rank, clusters, sc, o, s));
  }
  if (cq_bytes == 8) {
    return static_cast<int>(launch(r, static_cast<const long long*>(cq), n,
                                   num_cqs, big_rank, clusters, sc, o, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
