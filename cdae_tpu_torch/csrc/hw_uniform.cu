// (rows, cols) float32 uniforms in [0, 1), element (r, c) =
// hash_uniform(seed, r, c, draw).
//
// Replaces cdae_tpu/ops/pallas_kernels.py:hw_uniform (the Pallas kernel
// that draws the corruption and negative masks from the TPU's hardware
// PRNG). The TPU's bits cannot be reproduced; this draws cdae_tpu's
// tiling-invariant hash stream instead, which the fused step (cdae_fused.cu)
// regenerates in place.
//
// What bounds it on an H100: it reads nothing and writes 4 bytes per
// element after ~12 integer operations, so the store stream bounds it
// (a (1024, 20000) draw is 82 MB, about 25 us at 3.35 TB/s).
//
// Design: the output is treated as one flat row-major array. Each thread
// makes 4 consecutive elements and writes them with one 16-byte store; the
// flat start of every group of 4 is 16-byte aligned (torch allocations
// are), whatever cols is. Row and column follow from the flat index, with
// one division per thread. The ragged end is stored element by element.

#include <cuda_runtime.h>

#include <cstdint>

#include "hash_uniform.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hw_uniform_kernel(float* __restrict__ out, int rows, int cols, uint32_t seed,
                  uint32_t draw) {
  const long long n = static_cast<long long>(rows) * cols;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * 4;
  for (long long e = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * 4;
       e < n; e += stride) {
    int r = static_cast<int>(e / cols);
    int c = static_cast<int>(e - static_cast<long long>(r) * cols);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cdae::hash_uniform(seed, r, c, draw);
      if (++c == cols) {
        c = 0;
        ++r;
      }
    }
    if (e + 4 <= n) {
      *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    } else {
      for (int k = 0; e + k < n; ++k) out[e + k] = v[k];
    }
  }
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 = launched).
extern "C" int cdae_hw_uniform(float* out, int rows, int cols, int seed,
                               int draw, void* stream) {
  const long long groups = (static_cast<long long>(rows) * cols + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond
  hw_uniform_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      out, rows, cols, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(draw));
  return static_cast<int>(cudaGetLastError());
}
