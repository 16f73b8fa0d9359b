// WARP's violator count and nn uniform violator picks per row, without the
// (B, I) scores.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:warp_violator_select (kernel
// _warp_select_kernel). For row b, column c is a violator when the item is
// unrated (mask == 0) and uv[b] . iv[c] + ib[c] > thr[b]. Outputs nviol[b],
// the exact violator count, and j[b, k] for each slot k < nn: the violator
// with the largest 24-bit noise of (seed, b, c, k), the lowest column on
// equal noise (what jnp.argmax plus the strict > across the TPU's catalog
// tiles gives); 0 for a row with no violator. The noise is cdae_tpu's hash
// of the global coordinates, bit for bit, in unsigned 32-bit arithmetic:
//   mshift (default): base = mix(seed + c*C1 + b*C2), base2 = a second mix
//     of base, noise_k = (base*a_k + base2*b_k) >> 8;
//   hash: noise_k = mix(seed + c*C1 + b*C2 + k*K1) & 0xFFFFFF.
//
// What bounds it on an H100: the int8 mask rows (B*I bytes, 30 MB at
// B = 8192, I = 3706) are the only large input, 9 us at 3.35 TB/s; the
// scores are 2*B*I*D f32 flops (0.6 GFLOP at D = 10) and each violator
// costs about 15 + 6*nn integer operations of noise and selection. So the
// kernel is bound by operations, not bytes, and the operations count only
// where a cell violates.
//
// Design. The TPU kernel walks the catalog as a sequential grid, carrying
// the per-row (count, nn best) in VMEM. Here:
//   * grid = (row blocks of 32) x (catalog splits). A block stages its
//     split's item table transposed (iv[d][item]) and bias in shared
//     memory, and its 32 user rows; the split is sized so that all of it
//     fits in 48 KB;
//   * each warp takes one row at a time; lane l walks the split's columns
//     l, l+32, ... upward, so neighbouring lanes read neighbouring mask
//     bytes and shared-memory words. The lane keeps the row's count and,
//     per slot, its best (noise, column) in registers; a strict > keeps the
//     lower column on equal noise;
//   * a butterfly over the warp combines the lanes with the total order
//     (larger noise, then lower column), and lane 0 writes the split's
//     partial (count, nn x (noise, column));
//   * a second kernel, one thread per (row, slot), merges the splits in
//     column order with the same rule and sums the counts. No atomics: the
//     result does not depend on the schedule.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;  // ops/pallas_kernels.py _ROWS_PER_BLOCK
constexpr unsigned kFull = 0xffffffffu;

// cdae_tpu's constants: C1 multiplies the column, C2 the row
constexpr uint32_t kC1 = 0x9E3779B9u;  // -1640531527 as int32
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kK1 = 0xC2B2AE3Du;

enum Noise { kMshift = 0, kHash = 1 };

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// the selection order: larger noise first, then the lower column
__device__ __forceinline__ bool better(int n1, int c1, int n2, int c2) {
  return n1 > n2 || (n1 == n2 && c1 < c2);
}

template <int kMaxNN, int NOISE>
__global__ void __launch_bounds__(kThreads)
warp_select_kernel(uint32_t seed, const float* __restrict__ uv,
                   const float* __restrict__ iv, const float* __restrict__ ib,
                   const float* __restrict__ thr,
                   const int8_t* __restrict__ mask, int* __restrict__ part_cnt,
                   int* __restrict__ part_best, int* __restrict__ part_col,
                   int B, int I, int D, int nn, int S, int per_split) {
  extern __shared__ float smem[];
  float* ivs = smem;                            // [D][per_split]
  float* ibs = ivs + (size_t)D * per_split;     // [per_split]
  float* us = ibs + per_split;                  // [kRowsPerBlock][D]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int split = blockIdx.y;
  const int i_begin = split * per_split;
  const int n_items = min(per_split, I - i_begin);

  for (int e = threadIdx.x; e < n_items * D; e += kThreads) {
    const int it = e / D;
    ivs[(e - it * D) * per_split + it] = iv[(size_t)i_begin * D + e];
  }
  for (int e = threadIdx.x; e < n_items; e += kThreads) {
    ibs[e] = ib[i_begin + e];
  }
  for (int e = threadIdx.x; e < kRowsPerBlock * D; e += kThreads) {
    us[e] = (r0 + e / D < B) ? uv[(size_t)r0 * D + e] : 0.f;
  }
  __syncthreads();

  for (int rr = warp; rr < kRowsPerBlock; rr += kWarps) {
    const int row = r0 + rr;
    if (row >= B) break;  // warp-uniform
    const float t = thr[row];
    const float* u = us + rr * D;
    const int8_t* mrow = mask + (size_t)row * I;
    const uint32_t h_row = seed + static_cast<uint32_t>(row) * kC2;
    int cnt = 0;
    int best[kMaxNN];
    int col[kMaxNN];
#pragma unroll
    for (int k = 0; k < kMaxNN; ++k) {
      best[k] = -1;
      col[k] = INT_MAX;
    }
    for (int it = lane; it < n_items; it += 32) {
      const int c = i_begin + it;
      const bool unrated = mrow[c] == 0;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(u[d], ivs[d * per_split + it], s);
      s += ibs[it];
      if (!(unrated && s > t)) continue;
      ++cnt;
      const uint32_t h = h_row + static_cast<uint32_t>(c) * kC1;
      if (NOISE == kMshift) {
        const uint32_t base = mix(h);
        uint32_t base2 = (base ^ 0x9E3779B9u) * kM2;
        base2 ^= base2 >> 15;
        base2 *= kM1;
        base2 ^= base2 >> 17;
#pragma unroll
        for (int k = 0; k < kMaxNN; ++k) {
          if (k < nn) {
            // per-slot odd multipliers, compile-time constants
            const uint32_t a = (0x9E3779B1u * (2u * k + 1u)) | 1u;
            const uint32_t b = (0x85EBCA77u * (2u * k + 3u)) | 1u;
            const int x = static_cast<int>((base * a + base2 * b) >> 8);
            if (x > best[k]) {
              best[k] = x;
              col[k] = c;
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxNN; ++k) {
          if (k < nn) {
            const int x = static_cast<int>(
                mix(h + static_cast<uint32_t>(k) * kK1) & 0xFFFFFFu);
            if (x > best[k]) {
              best[k] = x;
              col[k] = c;
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(kFull, cnt, off);
    }
#pragma unroll
    for (int k = 0; k < kMaxNN; ++k) {
      if (k < nn) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int n2 = __shfl_xor_sync(kFull, best[k], off);
          const int c2 = __shfl_xor_sync(kFull, col[k], off);
          if (better(n2, c2, best[k], col[k])) {
            best[k] = n2;
            col[k] = c2;
          }
        }
      }
    }
    if (lane == 0) {
      const size_t o = (size_t)row * S + split;
      part_cnt[o] = cnt;
#pragma unroll
      for (int k = 0; k < kMaxNN; ++k) {
        if (k < nn) {
          part_best[o * nn + k] = best[k];
          part_col[o * nn + k] = col[k];
        }
      }
    }
  }
}

// One thread per (row, slot): merge the S splits in column order; the
// slot-0 thread also sums the row's counts.
__global__ void warp_merge_kernel(const int* __restrict__ part_cnt,
                                  const int* __restrict__ part_best,
                                  const int* __restrict__ part_col,
                                  int* __restrict__ nviol, int* __restrict__ j,
                                  int B, int I, int nn, int S) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * nn) return;
  const int row = static_cast<int>(t / nn);
  const int k = static_cast<int>(t - (long long)row * nn);
  int bn = -1, bc = INT_MAX;
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)row * S + s) * nn + k;
    const int n = part_best[o], c = part_col[o];
    if (better(n, c, bn, bc)) {
      bn = n;
      bc = c;
    }
  }
  j[t] = bn < 0 ? 0 : min(max(bc, 0), I - 1);
  if (k == 0) {
    int cnt = 0;
    for (int s = 0; s < S; ++s) cnt += part_cnt[(size_t)row * S + s];
    nviol[row] = cnt;
  }
}

template <int kMaxNN, int NOISE>
cudaError_t launch_select(uint32_t seed, const float* uv, const float* iv,
                          const float* ib, const float* thr,
                          const int8_t* mask, int* part_cnt, int* part_best,
                          int* part_col, int B, int I, int D, int nn, int S,
                          int per_split, size_t smem, cudaStream_t s) {
  dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, S);
  warp_select_kernel<kMaxNN, NOISE><<<grid, kThreads, smem, s>>>(
      seed, uv, iv, ib, thr, mask, part_cnt, part_best, part_col, B, I, D, nn,
      S, per_split);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after its two launches (0 = launched).
// part_cnt: (B, S), part_best/part_col: (B, S, nn) scratch; nviol: (B,),
// j: (B, nn). 1 <= nn <= 32; the caller sizes per_split so that the
// shared memory, (D*per_split + per_split + 32*D) floats, fits 48 KB.
extern "C" int cdae_warp_select(int seed, const float* uv, const float* iv,
                                const float* ib, const float* thr,
                                const int8_t* mask, int* part_cnt,
                                int* part_best, int* part_col, int* nviol,
                                int* j, int B, int I, int D, int nn, int S,
                                int per_split, int noise, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t useed = static_cast<uint32_t>(seed);
  const size_t smem =
      ((size_t)D * per_split + per_split + (size_t)kRowsPerBlock * D) *
      sizeof(float);
  cudaError_t err;
  if (nn <= 8) {
    err = noise == kHash
              ? launch_select<8, kHash>(useed, uv, iv, ib, thr, mask, part_cnt,
                                        part_best, part_col, B, I, D, nn, S,
                                        per_split, smem, s)
              : launch_select<8, kMshift>(useed, uv, iv, ib, thr, mask,
                                          part_cnt, part_best, part_col, B, I,
                                          D, nn, S, per_split, smem, s);
  } else {
    err = noise == kHash
              ? launch_select<32, kHash>(useed, uv, iv, ib, thr, mask,
                                         part_cnt, part_best, part_col, B, I,
                                         D, nn, S, per_split, smem, s)
              : launch_select<32, kMshift>(useed, uv, iv, ib, thr, mask,
                                           part_cnt, part_best, part_col, B,
                                           I, D, nn, S, per_split, smem, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const long long work = (long long)B * nn;
  warp_merge_kernel<<<static_cast<unsigned>((work + threads - 1) / threads),
                      threads, 0, s>>>(part_cnt, part_best, part_col, nviol,
                                       j, B, I, nn, S);
  return static_cast<int>(cudaGetLastError());
}
