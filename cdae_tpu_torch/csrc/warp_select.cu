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
// scores are 2*B*I*D f32 flops (0.6 GFLOP at D = 10), and every unrated
// cell that violates costs ~35 integer operations of noise and selection.
// Hopper runs 32-bit integer operations at half the f32 rate, so the
// kernel is bound by the integer work of the violators.
//
// Design. The TPU kernel walks the catalog as a sequential grid, carrying
// the per-row (count, nn best) in VMEM. Here one launch does it all:
//   * grid = (row blocks of 64) x (catalog splits); 1,024 threads a block,
//     64 registers a thread. A block stages its split's item table
//     transposed (iv[d][item]) and bias in dynamic shared memory (up to
//     227 KB, so at D = 10 one split holds 5,120 items: the ML-1M catalog
//     whole) and its rows of uv;
//   * register tiles: each warp owns 2 rows and each lane 4 consecutive
//     columns of every 128-column chunk, so one 16-byte shared load of iv
//     feeds 8 FMAs; uv is read as shared-memory broadcasts (holding it in
//     registers cost more occupancy than it saved). The lane reads its 4
//     mask bytes of a row as one aligned 32-bit word (two where the row's
//     offset straddles a word), loaded two chunks ahead of use, and a
//     funnel shift;
//   * no divergent branch per violator: the lane packs each cell's noise
//     with its lane-local column index into one 32-bit key (noise << 8 |
//     255 - index; 0 for a non-violator), so a slot's running best is one
//     unsigned max. Larger key = larger noise, then lower column. mshift's
//     slots follow from one another by one add; each nn <= 8 has its own
//     kernel, with no branch between the slots. A chunk in which no lane of
//     the warp has a violator skips the noise;
//   * a butterfly over the warp combines the lanes with the total order
//     (larger noise, then lower column) on global columns;
//   * one split: the warp writes nviol and j. Several: each block writes its
//     partial (count, nn x (noise, column)); the row block's last block to
//     finish (an atomic count) merges the splits in split order with the
//     same rule and sums the counts. The result does not depend on the
//     schedule.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "smem_limit.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kTR = 2;  // rows a warp owns for nn <= 8, one for nn > 8
constexpr int kCols = 4;             // consecutive columns a lane owns
constexpr int kChunk = 32 * kCols;   // columns a warp scores per pass
constexpr int kMaxChunks = 63;       // per split: lane index < 252, 8 bits
constexpr int kAhead = 2;            // chunks of mask words in flight
// Hopper's opt-in limit of 227 KB a block, less 1 KB for the static flag
constexpr int kSmemMax = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// cdae_tpu's constants: C1 multiplies the column, C2 the row
constexpr uint32_t kC1 = 0x9E3779B9u;  // -1640531527 as int32
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kK1 = 0xC2B2AE3Du;
constexpr uint32_t kA = 0x9E3779B1u;  // mshift's slot multipliers
constexpr uint32_t kB = 0x85EBCA77u;

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

template <int TR, int kMaxNN, bool kExact, int NOISE>
__global__ void __launch_bounds__(kThreads, 1)
warp_select_kernel(uint32_t seed, const float* __restrict__ uv,
                   const float* __restrict__ iv, const float* __restrict__ ib,
                   const float* __restrict__ thr,
                   const int8_t* __restrict__ mask, int* __restrict__ part,
                   int* __restrict__ nviol, int* __restrict__ j, int B, int I,
                   int D, int nn, int S, int per_split) {
  constexpr int kRows = kWarps * TR;
  // kExact: nn == kMaxNN, so the slot loops carry no branch and the
  // compiler interleaves the cells' integer chains
  const int slots = kExact ? kMaxNN : nn;
  // an odd multiple of 4: the staging stores spread over the banks
  const int stride = per_split + 4;
  extern __shared__ __align__(16) float smem[];
  float* ivs = smem;                      // [D][stride]
  float* ibs = ivs + (size_t)D * stride;  // [per_split]
  float* us = ibs + per_split;            // [kRows][D]
  __shared__ int merge_here;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int i_begin = split * per_split;
  const int n_items = min(per_split, I - i_begin);
  const int cend = i_begin + n_items;

  // coalesced reads of the split's rows of iv, transposed into shared
  // memory; zeros past the catalog so every 16-byte read of a chunk is
  // defined
  const float* src = iv + (size_t)i_begin * D;
  for (int e = threadIdx.x; e < n_items * D; e += kThreads) {
    const int it = e / D;
    ivs[(e - it * D) * stride + it] = src[e];
  }
  for (int e = threadIdx.x; e < (per_split - n_items) * D; e += kThreads) {
    const int it = n_items + e / D;
    ivs[(e % D) * stride + it] = 0.f;
  }
  for (int it = threadIdx.x; it < per_split; it += kThreads) {
    ibs[it] = 0.f;
    if (it < n_items) ibs[it] = ib[i_begin + it];
  }
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    us[e] = 0.f;
    if (r0 + e / D < B) us[e] = uv[(size_t)r0 * D + e];
  }
  __syncthreads();

  // part: [B*S counts][B*S*nn noises][B*S*nn columns][row-block counters]
  int* part_cnt = part;
  int* part_best = part + (size_t)B * S;
  int* part_col = part_best + (size_t)B * S * nn;
  int* done = part_col + (size_t)B * S * nn;

  const int wr0 = r0 + warp * TR;  // the warp's first row
  if (wr0 < B) {                   // warp-uniform
    const float* uw = us + warp * TR * D;
    float t[TR];
    uint32_t hrow[TR];
    bool live[TR];
    int cnt[TR];
    uint32_t best[TR][kMaxNN];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      live[r] = wr0 + r < B;
      t[r] = live[r] ? thr[wr0 + r] : 0.f;
      hrow[r] = seed + static_cast<uint32_t>(wr0 + r) * kC2;
      cnt[r] = 0;
#pragma unroll
      for (int k = 0; k < kMaxNN; ++k) best[r][k] = 0u;
    }

    // the raw mask words of the next kAhead chunks: loads sent that far
    // ahead of their use, so the rows' bytes stream while the card scores
    // (a word is shifted into place only where it is used)
    const int n_chunks = (n_items + kChunk - 1) / kChunk;
    const int8_t* mrow[TR];
    int skew[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      mrow[r] = mask + (size_t)(live[r] ? wr0 + r : 0) * I;
      skew[r] = static_cast<int>(reinterpret_cast<uintptr_t>(mrow[r]) & 3);
    }
    uint32_t lo[kAhead][TR], hi[kAhead][TR];
    auto fetch = [&](int q, int ch) {
      const int c0 = i_begin + ch * kChunk + lane * kCols;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        // c0 - skew[r] is 4-byte aligned in the row's address space
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(mrow[r] + c0 - skew[r]);
        lo[q][r] = 0xFFFFFFFFu;  // rated: no violator
        hi[q][r] = 0xFFFFFFFFu;
        if (live[r] && ch < n_chunks && c0 < cend) {
          lo[q][r] = __ldg(w);
          // the next word's first column, c0 + 4 - skew, inside the split
          if (skew[r] && c0 + 4 - skew[r] < cend) hi[q][r] = __ldg(w + 1);
        }
      }
    };
#pragma unroll
    for (int q = 0; q < kAhead; ++q) fetch(q, q);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int it0 = ch * kChunk + lane * kCols;  // split-local column
      const int c0 = i_begin + it0;
      uint32_t unrated[TR];  // 0xFF in byte k where column c0 + k is unrated
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        uint32_t word = __funnelshift_r(lo[0][r], hi[0][r], 8 * skew[r]);
        // columns past the split read as rated
        if (c0 + kCols > cend) word |= 0xFFFFFFFFu << (8 * max(cend - c0, 0));
        unrated[r] = __vcmpeq4(word, 0u);
      }
#pragma unroll
      for (int q = 0; q + 1 < kAhead; ++q) {
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          lo[q][r] = lo[q + 1][r];
          hi[q][r] = hi[q + 1][r];
        }
      }
      fetch(kAhead - 1, ch + kAhead);

      float s[TR][kCols];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float4 w =
            *reinterpret_cast<const float4*>(ivs + d * stride + it0);
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const float u = uw[r * D + d];  // a broadcast read
          s[r][0] = fmaf(u, w.x, s[r][0]);
          s[r][1] = fmaf(u, w.y, s[r][1]);
          s[r][2] = fmaf(u, w.z, s[r][2]);
          s[r][3] = fmaf(u, w.w, s[r][3]);
        }
      }
      const float4 bq = *reinterpret_cast<const float4*>(ibs + it0);
      const float bias[kCols] = {bq.x, bq.y, bq.z, bq.w};

      // violators: unrated, in the split, score above the row's threshold
      bool viol[TR][kCols];
      bool any = false;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          viol[r][c] = (unrated[r] & (1u << (8 * c))) != 0u &&
                       s[r][c] + bias[c] > t[r];
          cnt[r] += viol[r][c];
          any = any || viol[r][c];
        }
      }
      if (!__any_sync(kFull, any)) continue;  // warp-uniform

#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t hc = static_cast<uint32_t>(c0 + c) * kC1;
        const uint32_t idx = 255u - static_cast<uint32_t>(ch * kCols + c);
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          // a non-violator's key is 0, below every violator's (>= 4)
          const uint32_t keep = viol[r][c] ? 0xFFFFFF00u : 0u;
          const uint32_t low = viol[r][c] ? idx : 0u;
          const uint32_t h = hrow[r] + hc;
          if (NOISE == kMshift) {
            const uint32_t base = mix(h);
            uint32_t base2 = (base ^ 0x9E3779B9u) * kM2;
            base2 ^= base2 >> 15;
            base2 *= kM1;
            base2 ^= base2 >> 17;
            // slot k's odd multipliers are kA*(2k+1) and kB*(2k+3), so
            // noise_k = ((2k+1)*X + (2k+3)*Y) >> 8 with X = base*kA and
            // Y = base2*kB: one add from slot to slot
            const uint32_t x = base * kA, y = base2 * kB;
            const uint32_t step = 2u * (x + y);
            uint32_t v = x + 3u * y;
#pragma unroll
            for (int k = 0; k < kMaxNN; ++k) {
              if (k < slots) {
                const uint32_t key = (v & keep) | low;
                best[r][k] = max(best[r][k], key);
                v += step;
              }
            }
          } else {
#pragma unroll
            for (int k = 0; k < kMaxNN; ++k) {
              if (k < slots) {
                const uint32_t x = mix(h + static_cast<uint32_t>(k) * kK1);
                const uint32_t key = ((x << 8) & keep) | low;
                best[r][k] = key > best[r][k] ? key : best[r][k];
              }
            }
          }
        }
      }
    }

    // across the warp: counts, then each slot's (noise, global column)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt[r] += __shfl_xor_sync(kFull, cnt[r], off);
      }
      const int row = wr0 + r;
      const size_t o = (size_t)row * S + split;
      if (lane == 0 && live[r]) {
        if (S == 1) {
          nviol[row] = cnt[r];
        } else {
          part_cnt[o] = cnt[r];
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxNN; ++k) {
        if (k < slots) {
          const uint32_t key = best[r][k];
          int n = -1, col = INT_MAX;
          if (key) {
            const int li = 255 - static_cast<int>(key & 0xFFu);
            n = static_cast<int>(key >> 8);
            col = i_begin + (li / kCols) * kChunk + lane * kCols + li % kCols;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const int n2 = __shfl_xor_sync(kFull, n, off);
            const int c2 = __shfl_xor_sync(kFull, col, off);
            if (better(n2, c2, n, col)) {
              n = n2;
              col = c2;
            }
          }
          if (lane == k % 32 && live[r]) {
            if (S == 1) {
              j[(size_t)row * nn + k] = n < 0 ? 0 : min(max(col, 0), I - 1);
            } else {
              part_best[o * nn + k] = n;
              part_col[o * nn + k] = col;
            }
          }
        }
      }
    }
  }
  if (S == 1) return;  // grid-uniform

  // the row block's last block merges its splits, in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    merge_here = atomicAdd(done + blockIdx.x, 1) == S - 1;
  }
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  for (int e = threadIdx.x; e < kRows * nn; e += kThreads) {
    const int row = r0 + e / nn;
    const int k = e - (e / nn) * nn;
    if (row >= B) break;
    int bn = -1, bc = INT_MAX;
    for (int sp = 0; sp < S; ++sp) {
      const size_t o = ((size_t)row * S + sp) * nn + k;
      const int n = __ldcg(part_best + o), c = __ldcg(part_col + o);
      if (better(n, c, bn, bc)) {
        bn = n;
        bc = c;
      }
    }
    j[(size_t)row * nn + k] = bn < 0 ? 0 : min(max(bc, 0), I - 1);
    if (k == 0) {
      int total = 0;
      for (int sp = 0; sp < S; ++sp) {
        total += __ldcg(part_cnt + (size_t)row * S + sp);
      }
      nviol[row] = total;
    }
  }
}

template <int TR, int kMaxNN, bool kExact, int NOISE>
cudaError_t launch_select(uint32_t seed, const float* uv, const float* iv,
                          const float* ib, const float* thr,
                          const int8_t* mask, int* part, int* nviol, int* j,
                          int B, int I, int D, int nn, int S, int per_split,
                          cudaStream_t s) {
  auto* kernel = warp_select_kernel<TR, kMaxNN, kExact, NOISE>;
  static cdae::SmemLimit limit;  // above the default 48 KB
  if (const cudaError_t err = limit.raise(kernel, kSmemMax);
      err != cudaSuccess)
    return err;
  constexpr int kRows = kWarps * TR;
  const int row_blocks = (B + kRows - 1) / kRows;
  if (S > 1) {
    // the row blocks' finish counters, after the partials
    const size_t partials = (size_t)B * S * (1 + 2 * (size_t)nn);
    const cudaError_t err =
        cudaMemsetAsync(part + partials, 0, sizeof(int) * row_blocks, s);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = ((size_t)D * (per_split + 4) + per_split +
                       (size_t)kRows * D) * sizeof(float);
  kernel<<<dim3(row_blocks, S), kThreads, smem, s>>>(
      seed, uv, iv, ib, thr, mask, part, nviol, j, B, I, D, nn, S, per_split);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or the error
// of raising the shared-memory limit. nviol: (B,), j: (B, nn). 1 <= nn <=
// 32 (rows per block: 64 for nn <= 8, else 32); per_split is a multiple of
// 128, at most 63 * 128, with (D + 1) * per_split + 4 * D + rows * D
// floats within 226 KB; S = ceil(I / per_split). With S > 1, part holds
// B*S*(1 + 2*nn) ints of partials and one counter per row block (zeroed
// here); with S == 1 it is not read and may be null.
extern "C" int cdae_warp_select(int seed, const float* uv, const float* iv,
                                const float* ib, const float* thr,
                                const int8_t* mask, int* part, int* nviol,
                                int* j, int B, int I, int D, int nn, int S,
                                int per_split, int noise, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t useed = static_cast<uint32_t>(seed);
  if (per_split % kChunk || per_split > kMaxChunks * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define CDAE_SELECT(TR, NN, EXACT, NOISE)                                 \
  launch_select<TR, NN, EXACT, NOISE>(useed, uv, iv, ib, thr, mask, part,   \
                                      nviol, j, B, I, D, nn, S, per_split, \
                                      s)
  // mshift, WARP's noise, has a kernel for each nn <= 8; hash (the tests')
  // one for nn <= 8; nn > 8 one each, with fewer rows a thread
  cudaError_t err;
  if (noise == kHash) {
    err = nn <= 8 ? CDAE_SELECT(kTR, 8, false, kHash)
                  : CDAE_SELECT(1, 32, false, kHash);
  } else {
    switch (nn) {
      case 1: err = CDAE_SELECT(kTR, 1, true, kMshift); break;
      case 2: err = CDAE_SELECT(kTR, 2, true, kMshift); break;
      case 3: err = CDAE_SELECT(kTR, 3, true, kMshift); break;
      case 4: err = CDAE_SELECT(kTR, 4, true, kMshift); break;
      case 5: err = CDAE_SELECT(kTR, 5, true, kMshift); break;
      case 6: err = CDAE_SELECT(kTR, 6, true, kMshift); break;
      case 7: err = CDAE_SELECT(kTR, 7, true, kMshift); break;
      case 8: err = CDAE_SELECT(kTR, 8, true, kMshift); break;
      default: err = CDAE_SELECT(1, 32, false, kMshift); break;
    }
  }
#undef CDAE_SELECT
  return static_cast<int>(err);
}
