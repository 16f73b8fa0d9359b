// Row aggregation out[n] = sum over p with ids[p] == n of vals[p], for n in
// [0, N); ids outside [0, N) contribute nothing.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:scatter_matmul (kernel
// _scatter_mm_kernel), which builds a (block_p, block_n) one-hot tile in
// VMEM and contracts it with the values on the MXU, because scatters
// serialize on a TPU. On a GPU the same sum is a segment sum.
//
// What bounds it on an H100: it reads every value row and id once and
// writes every output row once, with one add per value, so device memory
// bandwidth. FISM's largest item aggregation at ML-1M scale is 1,124,352
// rows of 11 floats (59 MB with the ids): 0.0175 ms at the published 3.35
// TB/s of an NVIDIA H100 80GB HBM3 at 700 W.
//
// Design. The wrapper (ops/pallas_kernels.py scatter_matmul) sorts the ids
// with a stable sort and passes the sorted ids and the permutation. Here:
//   * one warp per output row n, lanes on its columns (32 at a time). The
//     warp finds its segment [lo, hi) of the sorted ids by two binary
//     searches, so ids < 0 and >= N fall outside every segment;
//   * each lane sums its column over the segment in ascending k, which is
//     ascending p (the sort is stable), in f32 with _rn adds that nvcc
//     never contracts. Four loads are in flight ahead of the adds;
//   * every output row is written, zeros for an empty segment.
// No atomics: the bits of the result do not depend on the schedule, so a
// run is reproducible, unlike index_add_ on the card. With bf16 != 0 each
// value is rounded to bf16 (round to nearest even) before it is added, as
// the TPU kernel's bf16 operands do; the sum stays f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// first k in [0, P) with sorted[k] >= key (P when none)
__device__ __forceinline__ long long lower_bound(const long long* sorted,
                                                 long long P, long long key) {
  long long lo = 0, hi = P;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sorted[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kBf16>
__device__ __forceinline__ float value(const float* __restrict__ vals,
                                       long long p, int C, int c) {
  const float v = __ldg(vals + p * C + c);
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const long long* __restrict__ sorted_ids,
                    const long long* __restrict__ order,
                    const float* __restrict__ vals, float* __restrict__ out,
                    long long P, int N, int C) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  // every lane searches (the same addresses, so the loads broadcast)
  const long long lo = lower_bound(sorted_ids, P, n);
  const long long hi = lower_bound(sorted_ids, P, static_cast<long long>(n) + 1);
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
    long long k = lo;
    for (; k + 4 <= hi; k += 4) {
      const float v0 = value<kBf16>(vals, __ldg(order + k), C, c);
      const float v1 = value<kBf16>(vals, __ldg(order + k + 1), C, c);
      const float v2 = value<kBf16>(vals, __ldg(order + k + 2), C, c);
      const float v3 = value<kBf16>(vals, __ldg(order + k + 3), C, c);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v0), v1), v2), v3);
    }
    for (; k < hi; ++k) {
      acc = __fadd_rn(acc, value<kBf16>(vals, __ldg(order + k), C, c));
    }
    out[static_cast<long long>(n) * C + c] = acc;
  }
}

}  // namespace

// sorted_ids, order: (P,) int64, the ids sorted ascending by a stable sort
// and the permutation that sorts them; vals (P, C) f32; out (N, C) f32.
// Launches on ``stream`` and returns cudaGetLastError() (0 = launched).
extern "C" int cdae_scatter_rows(const void* sorted_ids, const void* order,
                                 const float* vals, float* out, int P, int N,
                                 int C, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((N + kWarps - 1) / kWarps);
  const long long* ids = static_cast<const long long*>(sorted_ids);
  const long long* perm = static_cast<const long long*>(order);
  if (bf16) {
    scatter_rows_kernel<true><<<grid, kThreads, 0, s>>>(ids, perm, vals, out,
                                                        P, N, C);
  } else {
    scatter_rows_kernel<false><<<grid, kThreads, 0, s>>>(ids, perm, vals, out,
                                                         P, N, C);
  }
  return static_cast<int>(cudaGetLastError());
}
