// TAS leaf fit counts: how many pods of one per-pod request fit on each
// topology leaf.
//
//   rem[i, s]  = free[i, s] - tas[i, s] - assumed[i, s]   (int64, wrapping)
//   count[i]   = min over s with per_pod[s] > 0 of max(0, rem[i, s]) / per_pod[s]
//   out[i]     = mask[i] && any(per_pod > 0) ? int32(count[i]) : 0
//
// Replaces kueue_tpu/ops/pallas_kernels.py:_leaf_pallas (body
// _leaf_kernel), whose contract is the int64 reference
// kueue_tpu/ops/tas.py:_leaf_states_jnp. The TPU kernel clamps every
// operand to int32, pads S to 128 lanes, folds L in 256-row tiles with a
// sequential loop, and hands inputs >= 2^31 back to the int64 program.
// Here the arithmetic is int64 throughout, so there is no clamp and no
// range gate:
//   * the subtraction runs in unsigned 64-bit, so it wraps exactly as
//     XLA's int64 does (signed overflow is undefined in C++);
//   * an unrequested column contributes INT_MAX = 2^62, as in the
//     reference, and a request with no column at all gives 0;
//   * the division operands are non-negative, so C++'s truncating
//     division equals the reference's floor division;
//   * the result keeps the low 32 bits of the int64 count, as
//     .astype(jnp.int32) and torch's .to(torch.int32) do.
//
// Bound: bytes. Each leaf reads 3*S int64 quantities and a mask byte and
// writes one int32, about 24*S + 5 bytes: 0.27 MB for the 5,120-leaf
// forest at S = 2, a tenth of a microsecond at 3.35 TB/s, so a call is
// bound by launch latency. The design is one launch, one thread per leaf
// row in a grid-stride loop, per_pod staged once per block in shared
// memory, no atomics and no second pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks per SM on an H100
constexpr long long kIntMax = 1LL << 62;

__global__ void leaf_fit_counts_kernel(const long long* __restrict__ free_cap,
                                       const long long* __restrict__ tas,
                                       const long long* __restrict__ assumed,
                                       const long long* __restrict__ per_pod,
                                       const unsigned char* __restrict__ mask,
                                       long long num_leaves, int num_cols,
                                       int* __restrict__ out) {
  extern __shared__ long long need[];
  for (int s = threadIdx.x; s < num_cols; s += blockDim.x) {
    need[s] = per_pod[s];
  }
  __syncthreads();
  bool any_requested = false;
  for (int s = 0; s < num_cols; ++s) {
    any_requested |= need[s] > 0;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < num_leaves; i += stride) {
    long long best = kIntMax;
    const long long row = i * num_cols;
    for (int s = 0; s < num_cols; ++s) {
      const long long q = need[s];
      if (q <= 0) {
        continue;
      }
      const unsigned long long wrapped =
          static_cast<unsigned long long>(free_cap[row + s]) -
          static_cast<unsigned long long>(tas[row + s]) -
          static_cast<unsigned long long>(assumed[row + s]);
      const long long rem = static_cast<long long>(wrapped);
      const long long cnt = rem > 0 ? rem / q : 0;
      best = cnt < best ? cnt : best;
    }
    const long long state = (any_requested && mask[i]) ? best : 0;
    out[i] = static_cast<int>(
        static_cast<unsigned int>(static_cast<unsigned long long>(state)));
  }
}

}  // namespace

// free_cap, tas, assumed: int64[num_leaves, num_cols], row-major;
// per_pod: int64[num_cols]; mask: bool[num_leaves] (one byte each);
// out: int32[num_leaves]. Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int kueue_leaf_fit_counts(const void* free_cap, const void* tas,
                                     const void* assumed, const void* per_pod,
                                     const void* mask, long long num_leaves,
                                     int num_cols, void* out, void* stream) {
  if (num_leaves <= 0 || num_cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (num_leaves + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  const size_t shared = static_cast<size_t>(num_cols) * sizeof(long long);
  leaf_fit_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, shared,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(free_cap),
      static_cast<const long long*>(tas),
      static_cast<const long long*>(assumed),
      static_cast<const long long*>(per_pod),
      static_cast<const unsigned char*>(mask), num_leaves, num_cols,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
