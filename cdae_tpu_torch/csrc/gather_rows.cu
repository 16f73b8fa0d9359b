// Row gather out[p] = table[ids[p]], a zero row where ids[p] is outside
// [0, N).
//
// Replaces cdae_tpu/ops/pallas_kernels.py:gather_rows_mxu (kernel
// _packed_gather_kernel), which packs G narrow rows per 128 lanes and
// gathers them by a one-hot contraction on the MXU, because row gathers of
// narrow rows serialize on a TPU. A GPU gathers rows directly.
//
// What bounds it on an H100: every id is read once, every gathered row is
// read and written once, nothing is computed, so device memory bandwidth.
// WARP's item gather at ML-1M scale is 49,152 rows of 11 floats: 2.7 MB
// with the ids and the table, 0.0008 ms at the published 3.35 TB/s of an
// NVIDIA H100 80GB HBM3 at 700 W, so at that size the launch dominates.
//
// Design: one thread per (row, vector of V columns), a grid-stride loop,
// neighbouring threads on neighbouring addresses of one output row. V is
// 4 (16-byte loads and stores) when C is a multiple of 4 and the pointers
// allow it, else 2 or 1; the wrapper picks it. An id out of range writes
// zeros, with no read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const long long* __restrict__ ids, float* __restrict__ out,
                   int P, int N, int C) {
  using T = typename Vec<V>::T;
  // 64-bit flat index: the stride (up to 132*16*256) added to an index
  // just below P*C < 2**31 must not overflow
  const long long chunks = C / V;
  const long long total = static_cast<long long>(P) * chunks;
  const T* tbl = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out);
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * kThreads) {
    const long long p = t / chunks;
    const long long j = t - p * chunks;
    const long long id = __ldg(ids + p);
    T v;
    if (id >= 0 && id < N) {
      v = __ldg(tbl + id * chunks + j);
    } else {
      v = T{};  // value-initialised: every component 0
    }
    dst[t] = v;
  }
}

}  // namespace

// table (N, C) f32, ids (P,) int64, out (P, C) f32; vec = V in {1, 2, 4}
// divides C, and both pointers are 4*V-byte aligned. Launches on ``stream``
// and returns cudaGetLastError() (0 = launched).
extern "C" int cdae_gather_rows(const float* table, const void* ids,
                                float* out, int P, int N, int C, int vec,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(P) * (C / vec);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  const unsigned grid = static_cast<unsigned>(blocks);
  const long long* id = static_cast<const long long*>(ids);
  switch (vec) {
    case 4:
      gather_rows_kernel<4><<<grid, kThreads, 0, s>>>(table, id, out, P, N, C);
      break;
    case 2:
      gather_rows_kernel<2><<<grid, kThreads, 0, s>>>(table, id, out, P, N, C);
      break;
    default:
      gather_rows_kernel<1><<<grid, kThreads, 0, s>>>(table, id, out, P, N, C);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
