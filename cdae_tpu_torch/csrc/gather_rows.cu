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
// Design: a block copies 64 consecutive output rows. It stages their ids in
// shared memory once (an id out of range as -1), so no thread reloads an
// 8-byte id per element. The block's output, 64*C floats, starts on a
// 16-byte boundary whatever C is, so the block writes it as 16-byte stores
// of the flat (row, column) sequence: at WARP's C = 11 a quad spans a row
// boundary, and its four floats come from one or two table rows by 4-byte
// reads (the narrow table stays in L2). Where C is a multiple of 4 and the
// table 16-byte aligned, a quad lies in one row and is one 16-byte read. A
// row out of range is written as zeros, with no read. A pure copy: exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;  // a multiple of 4: every block's output aligned

template <bool kRowVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const long long* __restrict__ ids, float* __restrict__ out,
                   int P, int N, int C) {
  __shared__ int row_of[kRows];
  const int p0 = blockIdx.x * kRows;
  const int rows = min(kRows, P - p0);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long id = __ldg(ids + p0 + r);
    row_of[r] = (id >= 0 && id < N) ? static_cast<int>(id) : -1;
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(p0) * C;
  const int total = rows * C;
  const int quads = total >> 2;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int e = q << 2;
    int r = e / C;
    int c = e - r * C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kRowVec) {
      const int id = row_of[r];
      if (id >= 0) {
        v = __ldg(reinterpret_cast<const float4*>(
            table + static_cast<size_t>(id) * C + c));
      }
    } else {
      float x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int id = row_of[r];
        x[k] = 0.f;
        if (id >= 0) x[k] = __ldg(table + static_cast<size_t>(id) * C + c);
        if (++c == C) {
          c = 0;
          ++r;
        }
      }
      v = make_float4(x[0], x[1], x[2], x[3]);
    }
    reinterpret_cast<float4*>(dst)[q] = v;
  }
  // the last block's ragged end: fewer than 4 floats
  for (int e = (quads << 2) + threadIdx.x; e < total; e += kThreads) {
    const int r = e / C;
    const int id = row_of[r];
    float x = 0.f;
    if (id >= 0) x = __ldg(table + static_cast<size_t>(id) * C + (e - r * C));
    dst[e] = x;
  }
}

}  // namespace

// table (N, C) f32, ids (P,) int64, out (P, C) f32 with out 16-byte
// aligned; vec = 4 when C % 4 == 0 and table is 16-byte aligned (whole
// 16-byte reads of a row), else 1. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cdae_gather_rows(const float* table, const void* ids,
                                float* out, int P, int N, int C, int vec,
                                void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((P + kRows - 1) / kRows);
  const long long* id = static_cast<const long long*>(ids);
  if (vec == 4) {
    gather_rows_kernel<true><<<grid, kThreads, 0, s>>>(table, id, out, P, N,
                                                       C);
  } else {
    gather_rows_kernel<false><<<grid, kThreads, 0, s>>>(table, id, out, P, N,
                                                        C);
  }
  return static_cast<int>(cudaGetLastError());
}
