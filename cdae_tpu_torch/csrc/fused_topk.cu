// Fused decode + top-k over the catalog, never storing the (B, I) scores.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:fused_topk_scores (rated exclusion
// from dense int8 rows, MODE kDense) and :fused_topk_scores_csr (rated
// exclusion from sorted, padded CSR rows, MODE kCsr).
//
// What bounds it on an H100: the decode is 2*B*I*D flops of f32 FMA (no
// tensor cores in this version), about 1e11 at B = 1024, I = 1e6, D = 50;
// the bytes are W (I*D*4, read once per user tile; the user tile is the
// fast grid index, so the blocks sharing a catalog split run together and
// share it through L2) and, in kDense, the int8 rows (B*I). The scores
// themselves never leave registers, so the running top-k, not a (B, I)
// store, is what the design must keep cheap.
//
// Design. The TPU kernel walks the catalog as a sequential grid carrying a
// (B, k) top-k in VMEM; here blocks run in parallel with no carried state:
//   * grid = (user tiles of 32) x (catalog splits); each block decodes its
//     users against its split one 128-item tile at a time (W and z staged
//     through shared memory in chunks of 32 along D);
//   * warp w owns 4 users; lane l of that warp holds the scores of items
//     l, l+32, l+64, l+96 of the tile for each of them, so no score goes to
//     shared memory;
//   * each user's running top-k lives in registers, one entry per lane
//     (lane j holds the j-th best). A tile score is offered only if it beats
//     the current k-th entry (warp ballot); winners are inserted one at a
//     time with a ballot for the position and a shuffle for the shift. After
//     the first tiles almost nothing passes the threshold, so the merge costs
//     about one compare per score;
//   * kCsr: each user walks its own sorted rated list as the catalog
//     advances (one cursor per user, started by binary search at the split's
//     first item); the tile's rated items become a 128-bit mask in shared
//     memory. There are no per-block query lists and no overflow;
//   * every block writes a partial (B, S, k); a second kernel (one warp per
//     user) merges the S*k candidates into the final k.
// Order: the larger score wins; on equal scores the lower item id wins.
// Empty slots come out as (-inf, I), the streaming scan's convention; the
// Python wrapper turns them into cdae_tpu's NEG tail.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUsersPerWarp = 4;
constexpr int kTileU = kWarps * kUsersPerWarp;  // 32 users per block
constexpr int kTileI = 128;                     // catalog items per tile
constexpr int kItemsPerLane = kTileI / 32;
constexpr int kChunkD = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmptyId = INT_MAX;

enum Mode { kDense = 0, kCsr = 1 };

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Insert (cv, cid) into the warp's sorted list (lane j < k holds entry j).
__device__ __forceinline__ void insert(float& ev, int& eid, float cv, int cid,
                                       int k, int lane) {
  const bool ahead = lane < k && better(ev, eid, cv, cid);
  const int pos = __popc(__ballot_sync(kFull, ahead));
  const float up_v = __shfl_up_sync(kFull, ev, 1);
  const int up_id = __shfl_up_sync(kFull, eid, 1);
  if (lane == pos) {
    ev = cv;
    eid = cid;
  } else if (lane > pos) {
    ev = up_v;
    eid = up_id;
  }
}

// Offer one candidate per lane; those that beat the k-th entry go in.
__device__ __forceinline__ void offer(float& ev, int& eid, float v, int id,
                                      bool valid, int k, int lane) {
  float tv = __shfl_sync(kFull, ev, k - 1);
  int ti = __shfl_sync(kFull, eid, k - 1);
  bool want = valid && better(v, id, tv, ti);
  unsigned m = __ballot_sync(kFull, want);
  while (m) {
    const int src = __ffs(m) - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int cid = __shfl_sync(kFull, id, src);
    insert(ev, eid, cv, cid, k, lane);
    tv = __shfl_sync(kFull, ev, k - 1);
    ti = __shfl_sync(kFull, eid, k - 1);
    want = want && lane != src && better(v, id, tv, ti);
    m = __ballot_sync(kFull, want);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const float* __restrict__ z, const float* __restrict__ W,
                  const float* __restrict__ bp,
                  const int8_t* __restrict__ rated_rows,
                  const int* __restrict__ rated_items, int L,
                  float* __restrict__ part_v, int* __restrict__ part_i, int B,
                  int I, int D, int k, int S, int items_per_split) {
  __shared__ float zs[kChunkD][kTileU + 1];
  __shared__ float ws[kChunkD][kTileI + 1];
  __shared__ unsigned rated_bits[kWarps][kItemsPerLane];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * kTileU;
  const int split = blockIdx.y;
  const int i_begin = split * items_per_split;
  const int i_end = min(I, i_begin + items_per_split);

  float ev[kUsersPerWarp];
  int eid[kUsersPerWarp];
  int cursor[kUsersPerWarp];
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    ev[u] = neg_inf();
    eid[u] = kEmptyId;
    cursor[u] = 0;
    const int user = u0 + warp * kUsersPerWarp + u;
    if (MODE == kCsr && user < B) {
      // first rated entry >= i_begin (rows are sorted ascending)
      const int* row = rated_items + (size_t)user * L;
      int lo = 0, hi = L;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < i_begin) lo = mid + 1; else hi = mid;
      }
      cursor[u] = lo;
    }
  }

  for (int i0 = i_begin; i0 < i_end; i0 += kTileI) {
    float acc[kUsersPerWarp][kItemsPerLane];
#pragma unroll
    for (int u = 0; u < kUsersPerWarp; ++u) {
#pragma unroll
      for (int j = 0; j < kItemsPerLane; ++j) acc[u][j] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += kChunkD) {
      for (int e = threadIdx.x; e < kTileU * kChunkD; e += kThreads) {
        const int r = e / kChunkD, d = e % kChunkD;
        const int gu = u0 + r, gd = d0 + d;
        zs[d][r] = (gu < B && gd < D) ? z[(size_t)gu * D + gd] : 0.f;
      }
      for (int e = threadIdx.x; e < kTileI * kChunkD; e += kThreads) {
        const int r = e / kChunkD, d = e % kChunkD;
        const int gi = i0 + r, gd = d0 + d;
        ws[d][r] = (gi < I && gd < D) ? W[(size_t)gi * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kChunkD; ++d) {
        float a[kUsersPerWarp], w[kItemsPerLane];
#pragma unroll
        for (int u = 0; u < kUsersPerWarp; ++u) a[u] = zs[d][warp * kUsersPerWarp + u];
#pragma unroll
        for (int j = 0; j < kItemsPerLane; ++j) w[j] = ws[d][lane + 32 * j];
#pragma unroll
        for (int u = 0; u < kUsersPerWarp; ++u) {
#pragma unroll
          for (int j = 0; j < kItemsPerLane; ++j) acc[u][j] = fmaf(a[u], w[j], acc[u][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int u = 0; u < kUsersPerWarp; ++u) {
      const int user = u0 + warp * kUsersPerWarp + u;  // warp-uniform
      if (user >= B) continue;
      if (MODE == kCsr) {
        if (lane < kItemsPerLane) rated_bits[warp][lane] = 0u;
        __syncwarp();
        const int* row = rated_items + (size_t)user * L;
        int c = cursor[u];
        while (true) {
          const int p = c + lane;
          const int r = p < L ? row[p] : INT_MAX;
          const bool consumed = r < i0 + kTileI;
          if (consumed && r >= i0) {
            const int off = r - i0;
            atomicOr(&rated_bits[warp][off >> 5], 1u << (off & 31));
          }
          const int n = __popc(__ballot_sync(kFull, consumed));
          c += n;
          if (n < 32) break;
        }
        cursor[u] = c;
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < kItemsPerLane; ++j) {
        const int id = i0 + lane + 32 * j;
        bool rated;
        if (MODE == kCsr) {
          rated = (rated_bits[warp][j] >> lane) & 1u;
        } else {
          rated = id < I && rated_rows[(size_t)user * I + id] > 0;
        }
        const bool valid = id < i_end && !rated;
        const float v = acc[u][j] + (id < I ? bp[id] : 0.f);
        offer(ev[u], eid[u], v, id, valid, k, lane);
      }
      if (MODE == kCsr) __syncwarp();
    }
  }

#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    const int user = u0 + warp * kUsersPerWarp + u;
    if (user < B && lane < k) {
      const size_t o = ((size_t)user * S + split) * k + lane;
      part_v[o] = ev[u];
      part_i[o] = eid[u];
    }
  }
}

// One warp per user: merge the S*k partial candidates into the final k.
__global__ void merge_topk_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i, int B, int S, int k,
                                  int I) {
  const int lane = threadIdx.x & 31;
  const int user = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (user >= B) return;  // whole warp leaves together
  float ev = neg_inf();
  int eid = kEmptyId;
  const int n = S * k;
  const float* pv = part_v + (size_t)user * n;
  const int* pi = part_i + (size_t)user * n;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    const bool in = p < n;
    const float v = in ? pv[p] : neg_inf();
    const int id = in ? pi[p] : kEmptyId;
    offer(ev, eid, v, id, in && id != kEmptyId, k, lane);
  }
  if (lane < k) {
    const bool empty = eid == kEmptyId;
    out_v[(size_t)user * k + lane] = empty ? neg_inf() : ev;
    out_i[(size_t)user * k + lane] = empty ? I : eid;
  }
}

template <int MODE>
int launch(const float* z, const float* W, const float* bp,
           const int8_t* rated_rows, const int* rated_items, int L,
           float* part_v, int* part_i, float* out_v, int* out_i, int B, int I,
           int D, int k, int S, int items_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((B + kTileU - 1) / kTileU, S);
  fused_topk_kernel<MODE><<<grid, kThreads, 0, s>>>(
      z, W, bp, rated_rows, rated_items, L, part_v, part_i, B, I, D, k, S,
      items_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = 4;
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  merge_topk_kernel<<<blocks, warps_per_block * 32, 0, s>>>(
      part_v, part_i, out_v, out_i, B, S, k, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after their launches (0 = launched).
// part_v/part_i: (B, S, k) scratch; out_v/out_i: (B, k). 1 <= k <= 32.
extern "C" int cdae_fused_topk_dense(const float* z, const float* W,
                                     const float* bp, const int8_t* rated_rows,
                                     float* part_v, int* part_i, float* out_v,
                                     int* out_i, int B, int I, int D, int k,
                                     int S, int items_per_split,
                                     void* stream) {
  return launch<kDense>(z, W, bp, rated_rows, nullptr, 0, part_v, part_i,
                        out_v, out_i, B, I, D, k, S, items_per_split, stream);
}

extern "C" int cdae_fused_topk_csr(const float* z, const float* W,
                                   const float* bp, const int* rated_items,
                                   int L, float* part_v, int* part_i,
                                   float* out_v, int* out_i, int B, int I,
                                   int D, int k, int S, int items_per_split,
                                   void* stream) {
  return launch<kCsr>(z, W, bp, nullptr, rated_items, L, part_v, part_i,
                      out_v, out_i, B, I, D, k, S, items_per_split, stream);
}
