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
//     division equals the reference's floor division. When both fit in 32
//     unsigned bits (every real quantity but memory in bytes) it divides
//     in 32 bits, which is exact for such operands; 64-bit integer division
//     is a long software sequence on this card;
//   * the result keeps the low 32 bits of the int64 count, as
//     .astype(jnp.int32) and torch's .to(torch.int32) do.
//
// Bound: bytes. Each leaf reads 3*S int64 quantities and a mask byte and
// writes one int32, about 24*S + 5 bytes: 0.27 MB for the 5,120-leaf
// forest at S = 2 (a tenth of a microsecond at 3.35 TB/s, so a call there
// is bound by launch latency) and 12.6 MB at 65,536 x 8 (3.8 us). The
// design spreads the rows over every SM of the card:
//   * one thread per leaf row, in a grid-stride loop;
//   * the block is the largest of 256, 128, 64 or 32 threads that still
//     gives every SM a block, with the SM count read from the card
//     (cudaDevAttrMultiProcessorCount), so the forest's 5,120 rows make
//     160 blocks of 32 threads on 132 SMs; the grid is capped at the
//     blocks the SMs hold at once;
//   * where S is even and the three quantity arrays start on 16 bytes,
//     every row does too, and a thread reads its row as longlong2 column
//     pairs, skipping a pair that holds no requested column; otherwise it
//     reads the requested columns as scalars;
//   * per_pod is staged once per block in shared memory; no atomics and no
//     second pass.
// Groups of lanes per row with a warp-shuffle minimum were tried and were
// no faster at the forest and slower at 65,536 x 8, so a row stays in one
// thread. On the H100 (profile_kernels.py) a launch takes 1.9 us on the
// device at the forest (2.1 us for the 20-block grid it replaced) and
// 5.3 us at 65,536 x 8, 72% of the byte bound; a call's time is set by
// the host's dispatch.

#include <cuda_runtime.h>

namespace {

constexpr long long kIntMax = 1LL << 62;
constexpr int kMaxBlock = 256;
constexpr int kMinBlock = 32;
constexpr int kMaxThreadsPerSM = 2048;
constexpr int kMaxBlocksPerSM = 32;
constexpr int kMaxDevices = 64;

// Pods of per-pod quantity q that fit in free - tas - assumed.
__device__ __forceinline__ long long fit(long long free_q, long long tas_q,
                                         long long assumed_q, long long q) {
  if (q <= 0) {
    return kIntMax;
  }
  const long long rem = static_cast<long long>(
      static_cast<unsigned long long>(free_q) -
      static_cast<unsigned long long>(tas_q) -
      static_cast<unsigned long long>(assumed_q));
  if (rem <= 0) {
    return 0;
  }
  if ((static_cast<unsigned long long>(rem) |
       static_cast<unsigned long long>(q)) <= 0xffffffffULL) {
    return static_cast<unsigned int>(rem) / static_cast<unsigned int>(q);
  }
  return rem / q;
}

// kPair: read each row as longlong2 column pairs (S even, rows on 16 B).
template <bool kPair>
__global__ void leaf_fit_counts_kernel(const long long* __restrict__ free_cap,
                                       const long long* __restrict__ tas,
                                       const long long* __restrict__ assumed,
                                       const long long* __restrict__ per_pod,
                                       const unsigned char* __restrict__ mask,
                                       long long num_leaves, int num_cols,
                                       int* __restrict__ out) {
  extern __shared__ long long need[];
  int requested = 0;
  for (int s = threadIdx.x; s < num_cols; s += blockDim.x) {
    need[s] = per_pod[s];
    requested |= per_pod[s] > 0;
  }
  const bool any_requested = __syncthreads_or(requested) != 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < num_leaves; i += stride) {
    const long long row = i * num_cols;
    long long best = kIntMax;
    if constexpr (kPair) {
      const auto* f2 = reinterpret_cast<const longlong2*>(free_cap + row);
      const auto* t2 = reinterpret_cast<const longlong2*>(tas + row);
      const auto* a2 = reinterpret_cast<const longlong2*>(assumed + row);
      for (int u = 0; u < num_cols / 2; ++u) {
        const long long q0 = need[2 * u];
        const long long q1 = need[2 * u + 1];
        if (q0 <= 0 && q1 <= 0) {
          continue;
        }
        const longlong2 f = f2[u];
        const longlong2 t = t2[u];
        const longlong2 a = a2[u];
        const long long c0 = fit(f.x, t.x, a.x, q0);
        const long long c1 = fit(f.y, t.y, a.y, q1);
        best = c0 < best ? c0 : best;
        best = c1 < best ? c1 : best;
      }
    } else {
      for (int s = 0; s < num_cols; ++s) {
        const long long q = need[s];
        if (q <= 0) {
          continue;
        }
        const long long c =
            fit(free_cap[row + s], tas[row + s], assumed[row + s], q);
        best = c < best ? c : best;
      }
    }
    const long long state = (any_requested && mask[i]) ? best : 0;
    out[i] = static_cast<int>(
        static_cast<unsigned int>(static_cast<unsigned long long>(state)));
  }
}

cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  if (dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      return err;
    }
  }
  *sms = cached[dev];
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
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
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const bool pair = num_cols % 2 == 0 && aligned16(free_cap) &&
                    aligned16(tas) && aligned16(assumed);
  int block = kMaxBlock;
  while (block > kMinBlock && (num_leaves + block - 1) / block < sms) {
    block /= 2;
  }
  const int per_sm = kMaxThreadsPerSM / block < kMaxBlocksPerSM
                         ? kMaxThreadsPerSM / block
                         : kMaxBlocksPerSM;
  long long blocks = (num_leaves + block - 1) / block;
  if (blocks > static_cast<long long>(sms) * per_sm) {
    blocks = static_cast<long long>(sms) * per_sm;
  }
  const size_t shared = static_cast<size_t>(num_cols) * sizeof(long long);
  const auto* f = static_cast<const long long*>(free_cap);
  const auto* t = static_cast<const long long*>(tas);
  const auto* a = static_cast<const long long*>(assumed);
  const auto* q = static_cast<const long long*>(per_pod);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (pair) {
    leaf_fit_counts_kernel<true>
        <<<static_cast<unsigned>(blocks), block, shared, s>>>(
            f, t, a, q, m, num_leaves, num_cols, o);
  } else {
    leaf_fit_counts_kernel<false>
        <<<static_cast<unsigned>(blocks), block, shared, s>>>(
            f, t, a, q, m, num_leaves, num_cols, o);
  }
  return static_cast<int>(cudaGetLastError());
}
