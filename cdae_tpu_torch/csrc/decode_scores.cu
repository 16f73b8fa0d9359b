// Full-catalog decoder scores: out = z @ W^T + b'  (B, I), float32.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:decode_scores (the Pallas MXU
// kernel with a fused bias).
//
// What bounds it on an H100: at D = 50 the kernel does 2*D = 100 flops for
// every 4-byte score it writes, about 25 flops per byte of output. The
// (B, I) f32 store is the only large stream (z and W are re-read from L2),
// so writing the output bounds it well before the FMA units do.
//
// Design: one 256-thread block per 64x64 output tile. The block walks D in
// chunks of 16, staging a 64x16 slice of z and of W in shared memory
// (padded rows, so neither the transposing stores nor the reads conflict on
// banks); every thread keeps a 4x4 register tile of sums and adds b' in the
// epilogue, where the ragged B and I edges are masked. Plain f32 FMA: no
// tensor cores, no TMA -- this is the simple, exact first version.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileB = 64;
constexpr int kTileI = 64;
constexpr int kChunkD = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
decode_scores_kernel(const float* __restrict__ z, const float* __restrict__ W,
                     const float* __restrict__ bp, float* __restrict__ out,
                     int B, int I, int D) {
  __shared__ float zs[kChunkD][kTileB + 1];
  __shared__ float ws[kChunkD][kTileI + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b0 = blockIdx.y * kTileB;
  const int i0 = blockIdx.x * kTileI;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int d0 = 0; d0 < D; d0 += kChunkD) {
    for (int e = threadIdx.x; e < kTileB * kChunkD; e += kThreads) {
      const int r = e / kChunkD, d = e % kChunkD;
      const int gb = b0 + r, gd = d0 + d;
      zs[d][r] = (gb < B && gd < D) ? z[(size_t)gb * D + gd] : 0.f;
    }
    for (int e = threadIdx.x; e < kTileI * kChunkD; e += kThreads) {
      const int r = e / kChunkD, d = e % kChunkD;
      const int gi = i0 + r, gd = d0 + d;
      ws[d][r] = (gi < I && gd < D) ? W[(size_t)gi * D + gd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kChunkD; ++d) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = zs[d][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = ws[d][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = b0 + ty + 16 * r;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = i0 + tx + 16 * c;
      if (col < I) out[(size_t)row * I + col] = acc[r][c] + bp[col];
    }
  }
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 = launched).
extern "C" int cdae_decode_scores(const float* z, const float* W,
                                  const float* bp, float* out, int B, int I,
                                  int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((I + kTileI - 1) / kTileI, (B + kTileB - 1) / kTileB);
  decode_scores_kernel<<<grid, kThreads, 0, s>>>(z, W, bp, out, B, I, D);
  return static_cast<int>(cudaGetLastError());
}

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* cdae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
