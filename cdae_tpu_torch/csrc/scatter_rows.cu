// Row aggregation out[n] = sum over p with ids[p] == n of vals[p], for n in
// [0, N); ids outside [0, N) contribute nothing. Two entry points: a plan
// (the ids sorted into per-row segments) and a reduce over that plan.
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
// TB/s of an NVIDIA H100 80GB HBM3 at 700 W. At WARP's shapes (49,152 rows
// of 11) the work is ~2 MB, so what counts there is the number of launches.
//
// The plan (cdae_scatter_plan), built once per distinct id vector of a step
// and shared by every aggregation over that vector or a prefix of it:
//   * keys: an id in [0, N) is its own key, any other id the sentinel N,
//     which sorts last and lies outside every segment;
//   * a stable LSD radix sort of the int32 keys over only the bits N needs,
//     8-bit digits (two passes at N < 65536): one launch counts the digits
//     of every pass, then one launch a pass, whose 1024-key tiles find the
//     keys of each digit in earlier tiles by decoupled look-back (no scan
//     launch) and scatter stably. The first pass reads the int64 ids and
//     the positions are implicit;
//   * offsets[n] = the first sorted position with key >= n (one thread per
//     n), so segment n is [offsets[n], offsets[n + 1]).
//   The plan is the same on every run.
//
// The reduce (cdae_scatter_reduce): a warp is split into 32 / C' lane
// groups, C' = C rounded up to a power of two (at most 32; wider rows loop
// over 32 columns at a time). The groups of a row take every Grow-th element
// of its segment (Grow a power of two chosen from the mean segment length;
// with short segments the warp's groups serve 32 / C' / Grow rows), sum them
// in ascending position with _rn adds, and a fixed xor-shuffle tree combines
// the groups, so the result is the same bits on every run. Elements at
// positions >= limit are skipped: the sort is stable, so they form the tail
// of each segment, and a binary search cuts it off -- an aggregation over a
// prefix of the plan's ids gives the same bits as one over its own plan.
// With bf16 != 0 each value is rounded to bf16 (round to nearest even)
// before it is added, as the TPU kernel's bf16 operands do; the sum stays
// f32. The reduce has no atomics; the plan's add integer counts, whose
// totals do not depend on the order of the adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread per digit in the radix kernels
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;      // radix rounds of 256 keys per pass tile
constexpr int kTile = kThreads * kItems;
constexpr int kHistItems = 16;  // keys a thread counts in the digit counts
constexpr int kHistTile = kThreads * kHistItems;
constexpr int kMaxPasses = 4;  // 8-bit digits of keys below 2**31
// a tile's published count of one digit: 2 flag bits over a 30-bit count
constexpr unsigned kAggregate = 1u << 30;  // this tile's own count
constexpr unsigned kPrefix = 2u << 30;     // the count of tiles 0..t
constexpr unsigned kCountMask = kAggregate - 1;

// the sort key of position p: the id, or the sentinel N out of range
__device__ __forceinline__ int load_key(const long long* __restrict__ ids,
                                        const int* __restrict__ keys,
                                        long long p, int N) {
  if (ids != nullptr) {
    const long long id = ids[p];
    return (id >= 0 && id < N) ? static_cast<int>(id) : N;
  }
  return keys[p];
}

// the digit counts of every pass over all keys, hist[pass * 256 + digit]:
// per-block shared counts, then one global atomic add per nonzero count
// (integers, so the totals do not depend on the order of the adds)
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const long long* __restrict__ ids, int P, int N,
                  int passes, unsigned* __restrict__ hist) {
  __shared__ unsigned h[kMaxPasses][256];
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) h[i][tid] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kHistTile;
#pragma unroll 4
  for (int r = 0; r < kHistItems; ++r) {
    const long long p = base + r * kThreads + tid;
    if (p < P) {
      const int key = load_key(ids, nullptr, p, N);
      for (int i = 0; i < passes; ++i) {
        atomicAdd(&h[i][(key >> (8 * i)) & 255], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < passes; ++i) {
    if (h[i][tid] != 0) atomicAdd(&hist[i * 256 + tid], h[i][tid]);
  }
}

// One stable pass over 8-bit digit (key >> shift) & 255. Tiles take their
// index from a counter in launch order, count their digits, and find how
// many keys of each digit all earlier tiles hold by decoupled look-back
// over the tiles' published counts (status, zeroed before the pass). Then
// each tile takes its keys in rounds of 256 (ascending p) and ranks equal
// digits inside a warp by __match_any_sync and across the 8 warps by a
// prefix of per-warp counts.
__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const long long* __restrict__ ids,
                  const int* __restrict__ keys_in,
                  const int* __restrict__ vals_in, int P, int N, int shift,
                  const unsigned* __restrict__ hist,
                  unsigned* __restrict__ status,
                  unsigned* __restrict__ tile_counter,
                  int* __restrict__ keys_out, int* __restrict__ vals_out) {
  __shared__ int cnt[2][kWarps][256];  // per-warp digit counts, 2 buffers
  __shared__ unsigned tile_count[256];
  __shared__ unsigned warp_total[kWarps];
  __shared__ int tile_index;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  if (tid == 0) tile_index = static_cast<int>(atomicAdd(tile_counter, 1u));
  tile_count[tid] = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[0][w][tid] = cnt[1][w][tid] = 0;
  // digit tid starts after every key of a smaller digit: an exclusive
  // scan of the pass's totals across the block
  const unsigned total = hist[tid];
  unsigned incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  unsigned start = incl - total;
  for (int w = 0; w < warp; ++w) start += warp_total[w];
  const int tile = tile_index;
  const long long base = static_cast<long long>(tile) * kTile;

  int key[kItems], val[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long p = base + r * kThreads + tid;
    key[r] = -1;  // no key in this slot
    val[r] = 0;
    if (p < P) {
      key[r] = load_key(ids, keys_in, p, N);
      val[r] = vals_in != nullptr ? vals_in[p] : static_cast<int>(p);
      atomicAdd(&tile_count[(key[r] >> shift) & 255], 1u);
    }
  }
  __syncthreads();

  // look-back for digit tid: publish this tile's count, add the earlier
  // tiles' counts back to the first tile that published its prefix
  const unsigned mine = tile_count[tid];
  unsigned before = 0;
  volatile unsigned* slot = status + static_cast<long long>(tile) * 256;
  if (tile == 0) {
    slot[tid] = kPrefix | mine;
  } else {
    slot[tid] = kAggregate | mine;
    for (int t = tile - 1;; --t) {
      const volatile unsigned* prev = status + static_cast<long long>(t) * 256;
      unsigned v;
      do {
        v = prev[tid];
      } while ((v & ~kCountMask) == 0);
      before += v & kCountMask;
      if ((v & ~kCountMask) == kPrefix) break;
    }
    slot[tid] = kPrefix | (before + mine);
  }
  int next = static_cast<int>(start + before);  // digit tid's next slot

#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int buf = r & 1;
    const bool valid = key[r] >= 0;
    const int d = valid ? (key[r] >> shift) & 255 : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt_mask);
    if (valid && lane == __ffs(peers) - 1) cnt[buf][warp][d] = __popc(peers);
    __syncthreads();
    // digit tid: the warps' counts become absolute starts; the other
    // buffer (last read before this round's first barrier) is cleared
    int run = next;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[buf][w][tid];
      cnt[buf][w][tid] = run;
      run += c;
      cnt[buf ^ 1][w][tid] = 0;
    }
    next = run;
    __syncthreads();
    if (valid) {
      const int pos = cnt[buf][warp][d] + rank;
      keys_out[pos] = key[r];
      vals_out[pos] = val[r];
    }
  }
}

// offsets[n] = first k with sorted[k] >= n, for n in [0, N]
__global__ void __launch_bounds__(kThreads)
segment_offsets_kernel(const int* __restrict__ sorted, int P, int N,
                       int* __restrict__ offsets) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (n > N) return;
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (sorted[mid] < n) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  offsets[n] = lo;
}

template <bool kBf16>
__device__ __forceinline__ float value(const float* __restrict__ vals,
                                       int p, int C, int c) {
  const float v = __ldg(vals + static_cast<long long>(p) * C + c);
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
scatter_reduce_kernel(const int* __restrict__ offsets,
                      const int* __restrict__ order,
                      const float* __restrict__ vals, float* __restrict__ out,
                      int N, int C, int limit, bool cut, int cw_log2,
                      int grow_log2) {
  const int lane = threadIdx.x & 31;
  const int cw = 1 << cw_log2, grow = 1 << grow_log2;
  const int group = lane >> cw_log2;
  const int col = lane & (cw - 1);
  const int g = group & (grow - 1);  // this lane's share of its row
  const int rows_per_warp = (32 >> cw_log2) >> grow_log2;
  const long long warp_id =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long n = warp_id * rows_per_warp + (group >> grow_log2);
  const bool live = n < N;
  int lo = 0, hi = 0;
  if (live) {
    lo = offsets[n];
    hi = offsets[n + 1];
    if (cut) {  // the positions >= limit are the segment's tail
      int a = lo, b = hi;
      while (a < b) {
        const int mid = a + ((b - a) >> 1);
        if (order[mid] < limit) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      hi = a;
    }
  }
  for (int c0 = 0; c0 < C; c0 += cw) {  // the same trip count on every lane
    const int c = c0 + col;
    const bool has = live && c < C;
    float acc = 0.0f;
    if (has) {
      int k = lo + g;
      for (; k + 3 * grow < hi; k += 4 * grow) {
        const float v0 = value<kBf16>(vals, __ldg(order + k), C, c);
        const float v1 = value<kBf16>(vals, __ldg(order + k + grow), C, c);
        const float v2 = value<kBf16>(vals, __ldg(order + k + 2 * grow), C, c);
        const float v3 = value<kBf16>(vals, __ldg(order + k + 3 * grow), C, c);
        acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v0), v1), v2), v3);
      }
      for (; k < hi; k += grow) {
        acc = __fadd_rn(acc, value<kBf16>(vals, __ldg(order + k), C, c));
      }
    }
    // a fixed tree over the row's groups; x + y == y + x, so every lane
    // of the row ends with the same bits
    for (int off = cw; off < (cw << grow_log2); off <<= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (has && g == 0) out[n * C + c] = acc;
  }
}

int log2_ceil(long long x) {  // smallest e with 2**e >= x, x >= 1
  int e = 0;
  while ((1LL << e) < x) ++e;
  return e;
}

}  // namespace

// Sort plan of ids (P,) int64 over num_rows N, P < 2**30: order (P,)
// int32, the positions stably sorted by key, and offsets (N + 1,) int32,
// the segment starts. scratch: 3 * P + 1056 + 1024 * ceil(P / 1024) int32
// words. Launches on ``stream`` (a memset, the digit counts, one launch a
// pass, the offsets) and returns cudaGetLastError() (0 = launched).
extern "C" int cdae_scatter_plan(const void* ids, int P, int N, int* order,
                                 int* offsets, int* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ids64 = static_cast<const long long*>(ids);
  const int tiles = (P + kTile - 1) / kTile;
  // keys lie in [0, N]; one pass even at N = 0, where every key is 0
  const int bits = log2_ceil(static_cast<long long>(N) + 1);
  const int passes = P > 0 ? (bits > 8 ? (bits + 7) / 8 : 1) : 0;
  int* keys_a = scratch;
  int* keys_b = scratch + P;
  int* vals_tmp = scratch + 2LL * P;
  unsigned* hist = reinterpret_cast<unsigned*>(scratch + 3LL * P);
  unsigned* counters = hist + kMaxPasses * 256;
  unsigned* status = counters + 32;
  if (passes > 0) {
    const size_t zeroed =
        (kMaxPasses * 256 + 32 + static_cast<size_t>(passes) * tiles * 256) *
        sizeof(unsigned);
    cudaMemsetAsync(hist, 0, zeroed, s);
    radix_hist_kernel<<<(P + kHistTile - 1) / kHistTile, kThreads, 0, s>>>(
        ids64, P, N, passes, hist);
  }
  const int* keys_in = nullptr;
  const int* vals_in = nullptr;
  for (int i = 0; i < passes; ++i) {
    // the last pass lands in (keys_a, order); earlier ones alternate
    const bool last_parity = ((passes - 1 - i) & 1) == 0;
    int* keys_out = last_parity ? keys_a : keys_b;
    int* vals_out = last_parity ? order : vals_tmp;
    radix_pass_kernel<<<tiles, kThreads, 0, s>>>(
        i == 0 ? ids64 : nullptr, keys_in, vals_in, P, N, 8 * i,
        hist + i * 256, status + static_cast<size_t>(i) * tiles * 256,
        counters + i, keys_out, vals_out);
    keys_in = keys_out;
    vals_in = vals_out;
  }
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(N) + 1 + kThreads - 1) / kThreads);
  segment_offsets_kernel<<<grid, kThreads, 0, s>>>(keys_a, P, N, offsets);
  return static_cast<int>(cudaGetLastError());
}

// out (N, C) f32 = per-row sums of vals (limit, C) f32 over a plan of P
// positions (offsets (N + 1,), order (P,) int32); positions >= limit are
// skipped. Launches on ``stream`` and returns cudaGetLastError().
extern "C" int cdae_scatter_reduce(const int* offsets, const int* order,
                                   const float* vals, float* out, int N,
                                   int C, int P, int limit, int bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cw_log2 = log2_ceil(C < 32 ? (C > 0 ? C : 1) : 32);
  const int groups_log2 = 5 - cw_log2;
  // groups per row: about 8 elements each, from the mean segment length
  // of the positions that count (min(P, limit)), so a prefix's reduce over
  // a shared plan splits its rows exactly as one over its own plan
  const long long eff = P < limit ? P : limit;
  const long long per_row = N > 0 ? (eff + N - 1) / N : 0;
  int grow_log2 = per_row > 8 ? log2_ceil((per_row + 7) / 8) : 0;
  if (grow_log2 > groups_log2) grow_log2 = groups_log2;
  const long long rows_per_block =
      static_cast<long long>(kWarps) << (groups_log2 - grow_log2);
  const unsigned grid =
      static_cast<unsigned>((N + rows_per_block - 1) / rows_per_block);
  const bool cut = limit < P;
  if (bf16) {
    scatter_reduce_kernel<true><<<grid, kThreads, 0, s>>>(
        offsets, order, vals, out, N, C, limit, cut, cw_log2, grow_log2);
  } else {
    scatter_reduce_kernel<false><<<grid, kThreads, 0, s>>>(
        offsets, order, vals, out, N, C, limit, cut, cw_log2, grow_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
