// Fused decode + top-k over the catalog, never storing the (B, I) scores.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:fused_topk_scores (rated exclusion
// from dense int8 rows, MODE kDense) and :fused_topk_scores_csr (rated
// exclusion from sorted, padded CSR rows, MODE kCsr).
//
// What bounds it on an H100: the decode, 2*B*I*D flops, runs on the tensor
// cores in 3xTF32 (mma_tf32.cuh): three TF32 products per f32 one at the
// published 495 TFLOP/s, 0.62 ms at B = 1024, I = 1e6, D = 50. The bytes
// are W (I*D*4, read once per user tile of 128 rows; the user tile is the
// fast grid index, so the blocks that share a catalog split run together
// and share it through L2) and, in kDense, the int8 rows (B*I). The scores
// never leave registers, so the running top-k, not a (B, I) store, is what
// the design must keep cheap: about one compare a score.
//
// Design. The TPU kernel walks the catalog as a sequential grid carrying a
// (B, k) top-k in VMEM; here blocks run in parallel with no carried state:
//   * grid = (user tiles of 128) x (catalog splits). A block of 8 warps
//     (2 along users x 4 along items, 64 x 32 scores each: 4 x 4 m16n8
//     accumulator tiles, B3's warp tile) decodes its 128 users against its
//     split one 128-item tile at a time with mma.sync.m16n8k8 in 3xTF32;
//     two blocks share an SM (at D <= 64 and k <= 16), so one block's
//     products overlap the other's top-k work and barriers;
//   * operands arrive by cp.async. At D <= 64 the z tile is staged once, all
//     of D padded to the MMA's k = 8 (D = 50 runs 56), and the W tiles
//     (with their 128 b' values) stream through one buffer: the copy of
//     tile j + 1 starts as soon as the products of tile j are done and
//     overlaps its top-k work; at D > 64, z and W are staged together in
//     32-wide chunks of D through the same buffer. Shared rows are padded
//     so that a fragment's eight rows fall on distinct banks;
//   * the top-k: every row's k-th best score so far is its threshold, held
//     in registers by each lane that owns accumulators of the row (rows
//     lane/4 and lane/4 + 8 of each m-tile). A score (plus b', NaN past the
//     split so that it drops out) costs an add and a max: the max of a
//     lane's 8 scores of a row is compared with the row's threshold, and the
//     8 only when it reaches it. A score that reaches it is looked up in the
//     rated mask and, if unrated, pushed to the row's candidate buffer in
//     shared memory (a slot from a shared atomic count). When a buffer is
//     full -- and at the end of the split -- one warp merges it into the
//     row's sorted top-k in shared memory with the warp routines
//     insert/offer below, and refreshes the threshold; pushes that found the
//     buffer full are retried after the merge against the new threshold.
//     After the first tile almost nothing reaches a threshold;
//   * rated exclusion is a 128-bit mask per row and tile in shared memory
//     (bit (c >> 2) of word (c & 3) for tile column c). kCsr: a thread per
//     row walks the row's sorted rated list as the catalog advances (its
//     cursor started by binary search at the split's first item), so any
//     number of rated items per tile is exact; kDense: each warp reads
//     rows of the int8 tile, four bytes a lane, one ballot a byte;
//   * every block writes a partial (B, S, k); a second kernel (one warp per
//     user) merges the S*k candidates into the final k.
// Order: the larger score wins; on equal scores the lower item id wins, in
// the merges and in the final one (a score equal to the threshold is
// pushed, and the merge decides). Empty slots come out as (-inf, I), the
// streaming scan's convention; the Python wrapper turns them into cdae_tpu's
// NEG tail.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_tf32.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileU = 128;  // users per block
constexpr int kTileI = 128;  // catalog items per tile
constexpr int kWarpU = 64, kWarpI = 32;  // 2 x 4 warps over the tile
constexpr int kMt = kWarpU / 16, kNt = kWarpI / 8;
constexpr int kResidentMaxD = 64;  // z staged once at D <= 64
constexpr int kChunk = 32;         // the D chunk when D > 64
constexpr int kChunkRow = kChunk + 4;
constexpr int kCand = 32;  // candidate slots per row
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

// Shared memory of a block, in floats (ints and words take a float's
// room). zr: the padded row of the resident z and W tiles.
struct Layout {
  int zr, z, stage, w_in_stage, bp, bits, thr, cnt, top_v, top_i, cand_v,
      cand_i, total;
  __host__ __device__ Layout(int D, int k, bool resident) {
    const int dk = (D + 7) / 8 * 8;
    zr = resident ? dk + 4 : kChunkRow;  // (zr / 4) odd: distinct banks
    z = 0;
    const int z_floats = resident ? kTileU * zr : 0;
    stage = z_floats;
    // the stage: [z chunk (chunked only)][W tile]
    w_in_stage = resident ? 0 : kTileU * kChunkRow;
    bp = stage + w_in_stage + kTileI * zr;
    bits = bp + 2 * kTileI;
    thr = bits + kTileU * 4;
    cnt = thr + kTileU;
    top_v = cnt + kTileU;
    top_i = top_v + kTileU * k;
    cand_v = top_i + kTileU * k;
    cand_i = cand_v + kTileU * kCand;
    total = cand_i + kTileU * kCand;
  }
};

template <int MODE, bool kResident, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
fused_topk_kernel(const float* __restrict__ z, const float* __restrict__ W,
                  const float* __restrict__ bp,
                  const int8_t* __restrict__ rated_rows,
                  const int* __restrict__ rated_items, int L,
                  float* __restrict__ part_v, int* __restrict__ part_i, int B,
                  int I, int D, int k, int S, int items_per_split) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(D, k, kResident);
  const int zr = lay.zr;
  float* const bps = smem + lay.bp;  // [2][kTileI], by tile parity
  unsigned* const bits = reinterpret_cast<unsigned*>(smem + lay.bits);
  float* const thr_s = smem + lay.thr;
  int* const cnt = reinterpret_cast<int*>(smem + lay.cnt);
  float* const top_v = smem + lay.top_v;
  int* const top_i = reinterpret_cast<int*>(smem + lay.top_i);
  float* const cand_v = smem + lay.cand_v;
  int* const cand_i = reinterpret_cast<int*>(smem + lay.cand_i);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wu = (warp & 1) * kWarpU, wi = (warp >> 1) * kWarpI;
  const int u0 = blockIdx.x * kTileU;
  const int split = blockIdx.y;
  const int i_begin = split * items_per_split;
  const int i_end = min(I, i_begin + items_per_split);
  const int dk = (D + 7) / 8 * 8;
  const int chunks = kResident ? 1 : (D + kChunk - 1) / kChunk;
  const int tiles = (i_end - i_begin + kTileI - 1) / kTileI;
  const int steps = tiles * chunks;
  const int width = kResident ? dk : kChunk;  // columns a stage holds

  for (int r = tid; r < kTileU; r += kThreads) {
    // rows past the batch never take a candidate
    thr_s[r] = u0 + r < B ? neg_inf() : __int_as_float(0x7f800000);
    cnt[r] = 0;
  }
  for (int e = tid; e < kTileU * k; e += kThreads) {
    top_v[e] = neg_inf();
    top_i[e] = kEmptyId;
  }

  // stage rows [r0, r0 + 128) x columns [d0, d0 + width) of a (rows, D)
  // matrix into dst (rows of `row` floats); columns >= D are zero
  auto load_rows = [&](float* dst, const float* src, int r0, int rows,
                       int d0, int row) {
    const int per_row = width / kVec;
    for (int e = tid; e < kTileI * per_row; e += kThreads) {
      const int r = e / per_row, d = (e - r * per_row) * kVec;
      const int gr = r0 + r, gd = d0 + d;
      const bool valid = gr < rows && gd < D;  // D % kVec == 0
      cdae::copy_async<kVec>(
          dst + r * row + d,
          valid ? src + static_cast<size_t>(gr) * D + gd : src, valid);
    }
  };
  auto issue = [&](int s) {
    const int tile = s / chunks, c = s - tile * chunks;
    const int i0 = i_begin + tile * kTileI;
    float* st = smem + lay.stage;
    if (!kResident) load_rows(st, z, u0, B, c * kChunk, kChunkRow);
    load_rows(st + lay.w_in_stage, W, i0, i_end, c * kChunk, zr);
    if (c == 0) {
      for (int e = tid; e < kTileI; e += kThreads) {
        const bool valid = i0 + e < i_end;
        cdae::copy_async<1>(bps + (tile & 1) * kTileI + e,
                            valid ? bp + i0 + e : bp, valid);
      }
    }
    cdae::cp_async_commit();
  };

  // kCsr: thread r < kTileU walks row u0 + r; nxt is its next rated id
  int cursor = 0, nxt = INT_MAX;
  if (MODE == kCsr && tid < kTileU && u0 + tid < B) {
    const int* row = rated_items + static_cast<size_t>(u0 + tid) * L;
    int lo = 0, hi = L;  // first rated entry >= i_begin (rows are sorted)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < i_begin) lo = mid + 1; else hi = mid;
    }
    cursor = lo;
    nxt = lo < L ? row[lo] : INT_MAX;
  }

  if (kResident) {  // z once, in the same copy group as the first W tile
    load_rows(smem + lay.z, z, u0, B, 0, zr);
  }
  if (steps > 0) issue(0);

  float acc[kMt][kNt][4];
  // one warp merges row r's candidates into its top-k
  auto merge_row = [&](int r) {
    const int n = min(cnt[r], kCand);
    float ev = lane < k ? top_v[r * k + lane] : neg_inf();
    int eid = lane < k ? top_i[r * k + lane] : kEmptyId;
    const bool in = lane < n;
    const float v = in ? cand_v[r * kCand + lane] : neg_inf();
    const int id = in ? cand_i[r * kCand + lane] : kEmptyId;
    offer(ev, eid, v, id, in, k, lane);
    if (lane < k) {
      top_v[r * k + lane] = ev;
      top_i[r * k + lane] = eid;
    }
    if (lane == k - 1) thr_s[r] = ev;
    if (lane == 0) cnt[r] = 0;
  };

  for (int s = 0; s < steps; ++s) {
    const int tile = s / chunks, c = s - tile * chunks;
    const int i0 = i_begin + tile * kTileI;
    cdae::cp_async_wait<0>();
    __syncthreads();
    if (c == chunks - 1) {
      // the tile's rated mask, before the products (the barrier after them
      // publishes it)
      if (MODE == kCsr) {
        if (tid < kTileU && u0 + tid < B) {
          unsigned w4[4] = {0u, 0u, 0u, 0u};
          const int* row = rated_items + static_cast<size_t>(u0 + tid) * L;
          while (nxt < i0 + kTileI) {
            const int off = nxt - i0;
            w4[off & 3] |= 1u << (off >> 2);
            ++cursor;
            nxt = cursor < L ? row[cursor] : INT_MAX;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bits[tid * 4 + j] = w4[j];
        }
      } else {
        for (int r = warp; r < kTileU && u0 + r < B; r += kWarps) {
          const int8_t* row = rated_rows + static_cast<size_t>(u0 + r) * I;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = i0 + 4 * lane + j;
            const bool rated = col < I && row[col] > 0;
            const unsigned w = __ballot_sync(kFull, rated);
            if (lane == 0) bits[r * 4 + j] = w;
          }
        }
      }
    }
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
        }
      }
    }
    {
      const float* st = smem + lay.stage;
      const float* zc = kResident ? smem + lay.z : st;
      const float* wc = st + lay.w_in_stage;
      const int ksteps =
          kResident ? dk / 8 : min(kChunk / 8, (D - c * kChunk + 7) / 8);
      for (int kk = 0; kk < ksteps; ++kk) {
        const int kc = kk * 8;
        uint32_t bh[kNt][2], bl[kNt][2];
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          cdae::load_b(bh[n], bl[n], wc + (wi + n * 8) * zr + kc, 1, zr, g,
                       t);
        }
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          uint32_t ah[4], al[4];
          cdae::load_a(ah, al, zc + (wu + m * 16) * zr + kc, zr, 1, g, t);
          // the small terms first; one product of each of the kNt
          // accumulators between two that update the same one
#pragma unroll
          for (int n = 0; n < kNt; ++n) cdae::mma_tf32(acc[m][n], al, bh[n]);
#pragma unroll
          for (int n = 0; n < kNt; ++n) cdae::mma_tf32(acc[m][n], ah, bl[n]);
#pragma unroll
          for (int n = 0; n < kNt; ++n) cdae::mma_tf32(acc[m][n], ah, bh[n]);
        }
      }
    }

    __syncthreads();  // the stage is free: the next copy overlaps the rest
    if (s + 1 < steps) issue(s + 1);

    if (c == chunks - 1) {
      // ---- compare every score with its row's threshold; push winners
      const float* bpt = bps + (tile & 1) * kTileI;
      // b' of the lane's columns, NaN past the split's end: those scores
      // fail every compare (rows past the batch hold an infinite threshold)
      float bpv[kNt][2];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wi + n * 8 + 2 * t + e;
          bpv[n][e] = i0 + col < i_end ? bpt[col] : __int_as_float(0x7fc00000);
        }
      }
      float thr[kMt][2];
      auto reload = [&]() {
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            thr[m][h] = thr_s[wu + m * 16 + g + 8 * h];
          }
        }
      };
      // the scores of `want` (bit ((m*2 + h)*kNt + n)*2 + e) that still
      // reach their threshold and are unrated take a slot of their row's
      // buffer; returns those that found it full
      auto push = [&](uint64_t want) {
        uint64_t pend = 0u;
        if (want == 0u) return pend;
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wu + m * 16 + g + 8 * h;
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint64_t bit = 1ull
                                     << ((((m * 2 + h) * kNt + n) * 2) + e);
                if (!(want & bit)) continue;
                const int col = wi + n * 8 + 2 * t + e;
                const float v = acc[m][n][2 * h + e] + bpv[n][e];
                if (!(v >= thr[m][h])) continue;
                if ((bits[r * 4 + (col & 3)] >> (col >> 2)) & 1u) continue;
                const int slot = atomicAdd(cnt + r, 1);
                if (slot < kCand) {
                  cand_v[r * kCand + slot] = v;
                  cand_i[r * kCand + slot] = i0 + col;
                } else {
                  pend |= bit;
                }
              }
            }
          }
        }
        return pend;
      };
      // the scores that reach their row's threshold (the rated ones among
      // them are dropped by push): an add and a max a score, and one
      // compare for the lane's 8 scores of a row
      reload();
      uint64_t want = 0u;
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[kNt][2];
          float vmax = neg_inf();
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[n][e] = acc[m][n][2 * h + e] + bpv[n][e];
              vmax = fmaxf(vmax, v[n][e]);  // a NaN column drops out
            }
          }
          if (vmax >= thr[m][h]) {
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (v[n][e] >= thr[m][h]) {
                  want |= 1ull << ((((m * 2 + h) * kNt + n) * 2) + e);
                }
              }
            }
          }
        }
      }
      // (one call site of push, so that acc stays in registers)
      while (true) {
        want = push(want);
        if (!__syncthreads_or(want != 0u)) break;
        for (int r = warp; r < kTileU; r += kWarps) {
          if (cnt[r] >= kCand) merge_row(r);  // warp-uniform
        }
        __syncthreads();
        reload();
      }
    }
  }

  // ---- the split's end: merge what the buffers hold, write the partials
  __syncthreads();  // (a split of no tile has run no barrier yet)
  for (int r = warp; r < kTileU; r += kWarps) {
    const int user = u0 + r;
    if (user >= B) break;
    if (cnt[r] > 0) merge_row(r);
    __syncwarp();
    if (lane < k) {
      const size_t o = (static_cast<size_t>(user) * S + split) * k + lane;
      part_v[o] = top_v[r * k + lane];
      part_i[o] = top_i[r * k + lane];
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

template <int MODE, bool kResident, int kVec>
cudaError_t launch_tile(const float* z, const float* W, const float* bp,
                        const int8_t* rated_rows, const int* rated_items,
                        int L, float* part_v, int* part_i, int B, int I, int D,
                        int k, int S, int items_per_split, cudaStream_t s) {
  auto* kernel = fused_topk_kernel<MODE, kResident, kVec>;
  const size_t smem = sizeof(float) * Layout(D, k, kResident).total;
  static cdae::SmemLimit limit;  // above the default 48 KB
  const cudaError_t err = limit.raise(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + kTileU - 1) / kTileU, S);
  kernel<<<grid, kThreads, smem, s>>>(z, W, bp, rated_rows, rated_items, L,
                                      part_v, part_i, B, I, D, k, S,
                                      items_per_split);
  return cudaGetLastError();
}

template <int MODE>
int launch(const float* z, const float* W, const float* bp,
           const int8_t* rated_rows, const int* rated_items, int L,
           float* part_v, int* part_i, float* out_v, int* out_i, int B, int I,
           int D, int k, int S, int items_per_split, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_per_split % kTileI != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define CDAE_TILE(RES, VEC)                                                  \
  launch_tile<MODE, RES, VEC>(z, W, bp, rated_rows, rated_items, L, part_v, \
                              part_i, B, I, D, k, S, items_per_split, s)
  cudaError_t err;
  const bool resident = D <= kResidentMaxD;
  if (vec == 4) {
    err = resident ? CDAE_TILE(true, 4) : CDAE_TILE(false, 4);
  } else if (vec == 2) {
    err = resident ? CDAE_TILE(true, 2) : CDAE_TILE(false, 2);
  } else {
    err = resident ? CDAE_TILE(true, 1) : CDAE_TILE(false, 1);
  }
#undef CDAE_TILE
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = 4;
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  merge_topk_kernel<<<blocks, warps_per_block * 32, 0, s>>>(
      part_v, part_i, out_v, out_i, B, S, k, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after their launches (0 = launched).
// part_v/part_i: (B, S, k) scratch; out_v/out_i: (B, k). 1 <= k <= 32;
// items_per_split a multiple of 128; ``vec`` (4, 2 or 1): floats a copy
// moves -- D % vec == 0 and z, W 4 * vec-byte aligned.
extern "C" int cdae_fused_topk_dense(const float* z, const float* W,
                                     const float* bp, const int8_t* rated_rows,
                                     float* part_v, int* part_i, float* out_v,
                                     int* out_i, int B, int I, int D, int k,
                                     int S, int items_per_split, int vec,
                                     void* stream) {
  return launch<kDense>(z, W, bp, rated_rows, nullptr, 0, part_v, part_i,
                        out_v, out_i, B, I, D, k, S, items_per_split, vec,
                        stream);
}

extern "C" int cdae_fused_topk_csr(const float* z, const float* W,
                                   const float* bp, const int* rated_items,
                                   int L, float* part_v, int* part_i,
                                   float* out_v, int* out_i, int B, int I,
                                   int D, int k, int S, int items_per_split,
                                   int vec, void* stream) {
  return launch<kCsr>(z, W, bp, nullptr, rated_items, L, part_v, part_i,
                      out_v, out_i, B, I, D, k, S, items_per_split, vec,
                      stream);
}
