// One whole tied-decoder CDAE dense train step, with no (B, I) f32 slab in
// device memory.
//
// Replaces cdae_tpu/ops/cdae_fused.py:cdae_dense_step_fused (the Pallas
// kernel on a (3 phases, item tiles, user tiles) grid that carries h, the
// hidden gradient, d_b' and the touch counts in VMEM). Same contract: the
// corruption and negative masks are regenerated from (seed, row, col) with
// hash_uniform (the same numbers hw_uniform.cu draws), the step is
//   kept = rows * (u_c > q) * w_user,  h = kept @ W,  z = act(s*h + h_bias)
//   pred = z @ W^T + b',  w_mat = rows*w_user + neg_sel,  g = loss'(pred,
//   rows) * w_mat,  hg = (g @ W) * act'(z)
//   d_W = g^T z + kept^T (s*hg) + lam * touches * W,  d_b' = sum_b g +
//   lam * touches * b'
// then AdaGrad (or SGD) on W and b' IN PLACE; hg goes back to the caller for
// the small b / Wu updates.
//
// What bounds it on an H100: the four products of the step (encode, decode,
// the hidden gradient, d_W's two), 10*B*I*D flops, run on the tensor cores
// in 3xTF32 (mma_tf32.cuh). The operand that is the corrupted input is
// rows * mask, small integers exact in TF32 (w_user, 0 or 1, is applied to
// the other side: to h after the encode sum, to s*hg before d_W's second
// product), so its two products take two TF32 products, not three: 13
// TF32 products of 2*B*I*D in all. At the published 495 TFLOP/s:
// 26*B*I*D / 495e12 s, 0.0100 ms at 1024 x 3706 x 50 and 0.215 ms at
// 1024 x 20000 x 200, against B*I bytes of int8 rows read three times. Small shapes are bound by the launches and
// the phases' barriers, not by either.
//
// Design. On the TPU the phase boundaries are free because the grid runs in
// order. Here each boundary is a grid-wide dependency, so each phase is its
// own launch -- five in all, with programmatic dependent launch, so that a
// kernel's blocks are scheduled while the one before it drains -- and every
// reduction is ordered: a block
// writes its partial and a later kernel (or the last block of a group)
// sums the partials in a fixed order. No atomics touch a sum, so a step is
// deterministic run to run. Streamed operands (W chunks, z and hg chunks)
// arrive by cp.async in rings of buffers, the copies of the next chunks
// overlapping the products of this one (see launch_step).
//   1. encode   grid (user tiles of 64, catalog splits): kept tile (64
//      users x 32 items, built from the rows and the hash) @ W chunk on
//      mma.sync; partial h.
//   2. encode_finalize  z = act(s * w_user * sum_splits h + h_bias); it
//      also sets the grads' item-tile counters to 0.
//   3. decode   grid (user tiles, catalog splits): per 32-item chunk, the
//      scores z @ W^T on mma.sync, then g and w_mat; the partial hidden
//      gradient g @ W on mma.sync, and the tile's column sums of g and
//      w_mat (d_b' and touches: a fixed shuffle tree over each m-tile's 16
//      rows, then the four m-tiles in order).
//   4. decode_finalize  hg = sum_splits(hidden gradient) * act'(z), and
//      hs = s * w_user * hg for d_W.
//   5. grads    grid (item tiles of 32, user splits), enough blocks to fill
//      the card: per chunk of users (64 at D <= 64, else 32) the block
//      recomputes its scores z @ W^T
//      on the tensor cores (the decode launch cannot hand g over without a
//      (B, I) slab, and the recompute is one product of the five, at D = 50
//      a few us of the card), then g and the kept mask in shared memory,
//      and d_W's partial g^T z + kept^T hs on mma.sync. Each block writes
//      its partial; the item tile's last block (an atomic count after a
//      fence) sums them in split order with d_b', the touches and the
//      decay, and applies the update to the tile's rows of W, b' and their
//      AdaGrad state. A block reads only its own rows of W and b', and the
//      last block of a tile writes them after every block of the tile has
//      read them, so the in-place update is safe.
// A warp holds one d n-tile of the (users or items) x D products at
// D <= 64 and four at D <= 256 (a template), so the small widths keep few
// registers and several blocks an SM. Shared rows are padded so the
// fragment reads of the main products fall on distinct banks (the
// recomputed and hidden-gradient products read one of their operands in
// the other orientation, two ways to a bank). The tensor cores add into
// their accumulators with truncation; over a sum of thousands of products
// that drifts well past f32's rounding, so each 32-deep chunk of a product
// goes to fresh accumulators that are added to the running sum with
// rounded f32 adds.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash_uniform.cuh"
#include "mma_tf32.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileU = 64;   // users per encode / decode tile
constexpr int kChunkI = 32;  // items per chunk / per grads block
constexpr int kUsplit = 64;  // a user split is whole 64-user chunks
constexpr int kMaxD = 256;
constexpr int kMaxNt = kMaxD / 8 / kWarps;  // d n-tiles per warp
constexpr int kSk = kChunkI + 4;  // (user, item) tiles read as A rows
constexpr int kSt = kChunkI + 8;  // (user, item) tiles read transposed

struct Step {
  uint32_t seed;
  int B, I, D, Dk;
  float q, scale, lam, lr, beta;
  int use_ada, act, loss;
};

// row strides (floats) of a (rows, D) operand: sa when its fragments read
// along D (A rows, or B columns of z @ W^T), sb when they read across rows
// (B of a product whose k runs over the rows)
__host__ __device__ inline int stride_a(int Dk) { return Dk + 4; }
__host__ __device__ inline int stride_b(int Dk) {
  return (Dk + 31) / 32 * 32 + 8;
}

enum Act { kSigmoid = 0, kTanh = 1, kLinear = 2 };
enum LossKind {
  kSquare = 0,
  kLogistic = 1,
  kCrossEntropy = 2,
  kLog = 3,
  kLogm = 4,
  kHinge = 5,
  kSqHinge = 6
};


__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// the activations of models/cdae.py _activation, with its +-18 / +-9 clamps
__device__ __forceinline__ float activate(int act, float h) {
  if (act == kLinear) return h;
  if (act == kTanh) {
    const float t = tanhf(h);
    return h > 9.0f ? 1.0f : (h < -9.0f ? -1.0f : t);
  }
  const float s = 1.0f / (1.0f + expf(-h));
  return h > 18.0f ? 1.0f : (h < -18.0f ? 0.0f : s);
}

__device__ __forceinline__ float act_grad(int act, float z) {
  if (act == kLinear) return 1.0f;
  if (act == kTanh) return 1.0f - z * z;
  return z - z * z;
}

// d loss / d pred of ops/losses.py, with its clamps
__device__ float loss_grad(int loss, float pred, float truth) {
  switch (loss) {
    case kSquare:
      return -2.0f * (truth - pred);
    case kLogistic: {
      const float p = clampf(pred, 1e-7f, static_cast<float>(1.0 - 1e-7));
      return (p - truth) / (p * (1.0f - p));
    }
    case kCrossEntropy: {
      if (pred < -18.0f) return expf(fmaxf(pred, -80.0f)) - truth;
      if (pred > 18.0f) return 1.0f - truth;
      return 1.0f / (1.0f + expf(-clampf(pred, -18.0f, 18.0f))) - truth;
    }
    case kLog:
    case kLogm: {
      const float z = loss == kLog ? pred * truth : pred;
      if (z > 18.0f) return -truth * expf(-fminf(z, 80.0f));
      if (z < -18.0f) return -truth;
      return -truth / (1.0f + expf(clampf(z, -18.0f, 18.0f)));
    }
    case kHinge:
      return pred * truth > 1.0f ? 0.0f : -truth;
    default: {  // kSqHinge
      const float z = pred * truth;
      return z > 1.0f ? 0.0f : -truth * (1.0f - z);
    }
  }
}

// The masks of batch row b at column col, from its row value r (rows01),
// w_user and p_neg (loaded by the caller ahead of the products, so their
// latency hides behind them): kept01 (the row where the corruption keeps
// it, before w_user) and w_mat (the touch weight: the row plus the
// negatives). Only the draw that can matter is made: u_c only on rated
// cells, u_n only on unrated ones.
__device__ __forceinline__ void cell(const Step& s, float r, float wu,
                                     float pn, int b, int col, float* kept01,
                                     float* wmat) {
  float k = r;
  float neg = 0.0f;
  if (r != 0.0f) {
    if (s.q > 0.0f && !(cdae::hash_uniform(s.seed, b, col, 0) > s.q)) k = 0.0f;
  } else if (cdae::hash_uniform(s.seed, b, col, 1) < pn) {
    neg = wu;
  }
  *kept01 = k;
  *wmat = r * wu + neg;
}

// rows01 at (b, col), 0 outside the batch rows [0, rows) or columns
// [0, cols)
__device__ __forceinline__ float row_value(const Step& s,
                                           const int8_t* __restrict__ rows,
                                           int b, int nrows, int col,
                                           int ncols) {
  return b < nrows && col < ncols
             ? static_cast<float>(__ldg(rows + static_cast<size_t>(b) * s.I +
                                        col))
             : 0.0f;
}

// copy rows [r0, r0 + n) x [0, Dk) of a (rows, D) matrix into dst (rows of
// `stride` floats) with cp.async of kVec floats (16 bytes when D % 4 == 0
// and the source is aligned, else 4), a warp per row, zero past its rows
// and past D
template <int kVec>
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int r0, int n, int rows,
                                          const Step& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += kWarps) {
    const int gr = r0 + r;
    const float* row = src + static_cast<size_t>(gr) * s.D;
    for (int d = lane * kVec; d < s.Dk; d += 32 * kVec) {
      const bool valid = gr < rows && d < s.D;  // D % kVec == 0
      cdae::copy_async<kVec>(dst + r * stride + d, valid ? row + d : src,
                             valid);
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = 0.0f;
}

// acc[j][m] += A (64 rows x 32: 4 m-tiles) @ B (32 x the warp's d n-tiles
// w + 8j, j < kNT); A element (row, k) at a_s[row * sa + k], B element
// (k, d) at b_s[k * sb + d]. An exact A (0/1) takes two products, else
// three. The tensor cores add into their accumulators with truncation, so
// the chunk's products go to fresh accumulators that are then added to acc
// with rounded f32 adds: a long sum keeps f32's error, not the truncation's
template <bool kExactA, int kNT>
__device__ __forceinline__ void rows_by_items(
    float (&acc)[kNT][4][4], const float* a_s, int sa, const float* b_s,
    int sb, int nt, int warp, int g, int t) {
  float part[kNT][4][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) zero(part[j][m]);
  }
#pragma unroll
  for (int kk = 0; kk < kChunkI / 8; ++kk) {
    const int kc = kk * 8;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if constexpr (kExactA) {
        cdae::load_a_exact(ah[m], a_s + m * 16 * sa + kc, sa, 1, g, t);
      } else {
        cdae::load_a(ah[m], al[m], a_s + m * 16 * sa + kc, sa, 1, g, t);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = warp + kWarps * j;
      if (n >= nt) break;  // warp-uniform
      uint32_t bh[2], bl[2];
      cdae::load_b(bh, bl, b_s + kc * sb + n * 8, sb, 1, g, t);
      // one product of each m-tile between two on the same accumulator
      if constexpr (!kExactA) {
#pragma unroll
        for (int m = 0; m < 4; ++m) cdae::mma_tf32(part[j][m], al[m], bh);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) cdae::mma_tf32(part[j][m], ah[m], bl);
#pragma unroll
      for (int m = 0; m < 4; ++m) cdae::mma_tf32(part[j][m], ah[m], bh);
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][m][q] += part[j][m][q];
    }
  }
}

// acc[n] += scores of 16 rows of z (z_s, stride sz, A along D) x the kT
// 8-item tiles of W at w_s + n * 8 * sw (B along D) over Dk, in 3xTF32:
// each 32-deep chunk of D in fresh accumulators, one for each of the three
// products of each tile, so that 3 * kT chains run side by side
template <int kT>
__device__ __forceinline__ void scores(float (&acc)[kT][4], const float* z_s,
                                       int sz, const float* w_s, int sw,
                                       int Dk, int g, int t) {
  for (int k0 = 0; k0 < Dk; k0 += 32) {
    float p[kT][3][4];
#pragma unroll
    for (int n = 0; n < kT; ++n) {
#pragma unroll
      for (int v = 0; v < 3; ++v) zero(p[n][v]);
    }
    const int k1 = min(Dk, k0 + 32);
    for (int kc = k0; kc < k1; kc += 8) {
      uint32_t ah[4], al[4], bh[kT][2], bl[kT][2];
      cdae::load_a(ah, al, z_s + kc, sz, 1, g, t);
#pragma unroll
      for (int n = 0; n < kT; ++n) {
        cdae::load_b(bh[n], bl[n], w_s + n * 8 * sw + kc, 1, sw, g, t);
      }
#pragma unroll
      for (int n = 0; n < kT; ++n) cdae::mma_tf32(p[n][0], al, bh[n]);
#pragma unroll
      for (int n = 0; n < kT; ++n) cdae::mma_tf32(p[n][1], ah, bl[n]);
#pragma unroll
      for (int n = 0; n < kT; ++n) cdae::mma_tf32(p[n][2], ah, bh[n]);
    }
#pragma unroll
    for (int n = 0; n < kT; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[n][q] += (p[n][0][q] + p[n][1][q]) + p[n][2][q];
      }
    }
  }
}

template <int kNT, int kVec, int kWS>
__global__ void __launch_bounds__(kThreads)
encode_kernel(Step s, const int8_t* __restrict__ rows,
              const float* __restrict__ W, float* __restrict__ part_h,
              int per_split) {
  cdae::grid_dependency_wait();
  extern __shared__ __align__(16) float smem[];
  const int sb = stride_b(s.Dk);
  float* k_s = smem;                  // [kTileU][kSk]  kept01
  float* w_s = k_s + kTileU * kSk;    // [kWS][kChunkI][sb]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kTileU;
  const int i_begin = blockIdx.y * per_split;
  const int i_end = min(s.I, i_begin + per_split);
  const int nt = s.Dk / 8;
  const int chunks = (i_end - i_begin + kChunkI - 1) / kChunkI;
  // W chunks through a ring of kWS buffers, kWS - 1 chunks ahead (a group
  // is committed for every chunk index, empty past the end)
  auto issue = [&](int c) {
    if (c < chunks) {
      copy_rows<kVec>(w_s + (c % kWS) * kChunkI * sb, sb, W,
                      i_begin + c * kChunkI, kChunkI, i_end, s);
    }
    cdae::cp_async_commit();
  };
  float acc[kNT][4][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) zero(acc[j][m]);
  }
  // this thread's cells of the kept tile: row rr0 + 8 i, column cc
  constexpr int kCells = kTileU * kChunkI / kThreads;
  const int rr0 = threadIdx.x / kChunkI, cc = threadIdx.x % kChunkI;
  float rv[kCells];  // the next chunk's row values, loaded ahead
  auto prefetch = [&](int i0) {
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      rv[i] = row_value(s, rows, b0 + rr0 + 8 * i, s.B, i0 + cc, i_end);
    }
  };

  for (int c = 0; c < kWS - 1; ++c) issue(c);
  prefetch(i_begin);
  for (int c = 0; c < chunks; ++c) {
    const int i0 = i_begin + c * kChunkI;
    // the kept tile, while the chunk's W rows arrive
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int rr = rr0 + 8 * i, b = b0 + rr, col = i0 + cc;
      float k = rv[i];
      if (k != 0.0f && s.q > 0.0f &&
          !(cdae::hash_uniform(s.seed, b, col, 0) > s.q))
        k = 0.0f;
      k_s[rr * kSk + cc] = k;
    }
    if (c + 1 < chunks) prefetch(i0 + kChunkI);  // in flight meanwhile
    issue(c + kWS - 1);
    cdae::cp_async_wait<kWS - 1>();
    __syncthreads();
    rows_by_items<true, kNT>(acc, k_s, kSk, w_s + (c % kWS) * kChunkI * sb, sb,
                             nt, warp, g, t);
    __syncthreads();
  }
  float* out = part_h + static_cast<size_t>(blockIdx.y) * s.B * s.D;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = warp + kWarps * j;
    if (n >= nt) break;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = b0 + m * 16 + g + 8 * (q >> 1);
        const int d = n * 8 + 2 * t + (q & 1);
        if (b < s.B && d < s.D) out[static_cast<size_t>(b) * s.D + d] =
            acc[j][m][q];
      }
    }
  }
}

// z = act(scale * w_user * sum_splits part_h + h_bias); and the grads'
// item-tile counters set to 0
__global__ void encode_finalize(Step s, const float* __restrict__ part_h,
                                int splits, const float* __restrict__ w_user,
                                const float* __restrict__ h_bias,
                                float* __restrict__ z, int* __restrict__ done,
                                int item_tiles) {
  cdae::grid_dependency_wait();
  const size_t n = static_cast<size_t>(s.B) * s.D;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (size_t j = i; j < static_cast<size_t>(item_tiles);
       j += static_cast<size_t>(gridDim.x) * kThreads) {
    done[j] = 0;
  }
  if (i >= n) return;
  float h = 0.0f;
  for (int k = 0; k < splits; ++k) h += part_h[k * n + i];
  h *= w_user[i / s.D];
  z[i] = activate(s.act, h * s.scale + h_bias[i]);
}

template <int kNT, int kVec, int kWS>
__global__ void __launch_bounds__(kThreads)
decode_kernel(Step s, const int8_t* __restrict__ rows,
              const float* __restrict__ w_user,
              const float* __restrict__ p_neg, const float* __restrict__ z,
              const float* __restrict__ W, const float* __restrict__ bp,
              float* __restrict__ part_hg, float* __restrict__ part_dbp,
              float* __restrict__ part_tch, int per_split) {
  cdae::grid_dependency_wait();
  extern __shared__ __align__(16) float smem[];
  const int sa = stride_a(s.Dk);
  float* z_s = smem;                     // [kTileU][sa]
  float* w_s = z_s + kTileU * sa;        // [kWS][kChunkI][sa]
  float* g_s = w_s + kWS * kChunkI * sa; // [kTileU][kSk]
  float* cs_s = g_s + kTileU * kSk;      // [2][4][kChunkI] column sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kTileU;
  const int i_begin = blockIdx.y * per_split;
  const int i_end = min(s.I, i_begin + per_split);
  const int nt = s.Dk / 8;
  const int chunks = (i_end - i_begin + kChunkI - 1) / kChunkI;
  // this warp's score tiles: m-tile wm, n-tiles wn and wn + 1
  const int wm = warp >> 1, wn = (warp & 1) * 2;
  // W chunks through a ring of kWS buffers, kWS - 1 chunks ahead (a group
  // is committed for every chunk index, empty past the end)
  auto issue = [&](int c) {
    if (c < chunks) {
      copy_rows<kVec>(w_s + (c % kWS) * kChunkI * sa, sa, W,
                      i_begin + c * kChunkI, kChunkI, i_end, s);
    }
    cdae::cp_async_commit();
  };
  // w_user and p_neg of this lane's two rows
  float wu[2], pn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + wm * 16 + g + 8 * h;
    wu[h] = b < s.B ? w_user[b] : 0.0f;
    pn[h] = b < s.B ? p_neg[b] : 0.0f;
  }

  copy_rows<kVec>(z_s, sa, z, b0, kTileU, s.B, s);  // with the first chunk
  for (int c = 0; c < kWS - 1; ++c) issue(c);
  float acc[kNT][4][4];  // the hidden gradient
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) zero(acc[j][m]);
  }

  for (int c = 0; c < chunks; ++c) {
    const int i0 = i_begin + c * kChunkI;
    issue(c + kWS - 1);
    cdae::cp_async_wait<kWS - 1>();
    __syncthreads();
    const float* wc = w_s + (c % kWS) * kChunkI * sa;
    // the cells' row values and b', loaded while the scores are computed
    float rv[2][4], bv[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rv[n][q] = row_value(s, rows, b0 + wm * 16 + g + 8 * (q >> 1), s.B,
                             i0 + (wn + n) * 8 + 2 * t + (q & 1), i_end);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = i0 + (wn + n) * 8 + 2 * t + e;
        bv[n][e] = col < i_end ? __ldg(bp + col) : 0.0f;
      }
    }
    float pred[2][4];
    zero(pred[0]);
    zero(pred[1]);
    scores<2>(pred, z_s + wm * 16 * sa, sa, wc + wn * 8 * sa, sa, s.Dk, g, t);
    // g and w_mat; the columns' sums over the m-tile's 16 rows, in a fixed
    // shuffle tree
    float gsum[2][2], msum[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) gsum[n][e] = msum[n][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 16 + g + 8 * (q >> 1);
        const int cc = (wn + n) * 8 + 2 * t + (q & 1);
        const int b = b0 + r, col = i0 + cc;
        float gr = 0.0f, wmat = 0.0f;
        if (b < s.B && col < i_end) {
          float kept01;
          cell(s, rv[n][q], wu[q >> 1], pn[q >> 1], b, col, &kept01, &wmat);
          gr = loss_grad(s.loss, pred[n][q] + bv[n][q & 1], rv[n][q]) * wmat;
        }
        g_s[r * kSk + cc] = gr;
        gsum[n][q & 1] += gr;
        msum[n][q & 1] += wmat;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          gsum[n][e] += __shfl_xor_sync(0xffffffffu, gsum[n][e], off);
          msum[n][e] += __shfl_xor_sync(0xffffffffu, msum[n][e], off);
        }
        if (g == 0) {
          const int cc = (wn + n) * 8 + 2 * t + e;
          cs_s[wm * kChunkI + cc] = gsum[n][e];
          cs_s[(4 + wm) * kChunkI + cc] = msum[n][e];
        }
      }
    }
    __syncthreads();
    // hidden gradient: acc[b][d] += sum_c g[b][c] * W[c][d]
    rows_by_items<false, kNT>(acc, g_s, kSk, wc, sa, nt, warp, g, t);
    // this user tile's column sums of g (d_b') and w_mat (touches), its
    // four m-tiles in order
    if (threadIdx.x < kChunkI) {
      const int col = i0 + threadIdx.x;
      if (col < i_end) {
        const float* cg = cs_s + threadIdx.x;
        const float* cm = cs_s + 4 * kChunkI + threadIdx.x;
        part_dbp[static_cast<size_t>(blockIdx.x) * s.I + col] =
            ((cg[0] + cg[kChunkI]) + cg[2 * kChunkI]) + cg[3 * kChunkI];
        part_tch[static_cast<size_t>(blockIdx.x) * s.I + col] =
            ((cm[0] + cm[kChunkI]) + cm[2 * kChunkI]) + cm[3 * kChunkI];
      }
    }
    __syncthreads();
  }
  float* out = part_hg + static_cast<size_t>(blockIdx.y) * s.B * s.D;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = warp + kWarps * j;
    if (n >= nt) break;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = b0 + m * 16 + g + 8 * (q >> 1);
        const int d = n * 8 + 2 * t + (q & 1);
        if (b < s.B && d < s.D) out[static_cast<size_t>(b) * s.D + d] =
            acc[j][m][q];
      }
    }
  }
}

// hg = (sum_splits part_hg) * act'(z), and hs = scale * w_user * hg, the
// operand of d_W's second product
__global__ void decode_finalize(Step s, const float* __restrict__ part_hg,
                                int splits, const float* __restrict__ z,
                                const float* __restrict__ w_user,
                                float* __restrict__ hg,
                                float* __restrict__ hs) {
  cdae::grid_dependency_wait();
  const size_t n = static_cast<size_t>(s.B) * s.D;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float h = 0.0f;
  for (int k = 0; k < splits; ++k) h += part_hg[k * n + i];
  const float v = h * act_grad(s.act, z[i]);
  hg[i] = v;
  hs[i] = v * s.scale * w_user[i / s.D];
}

template <int kNT, int kVec, int kCU, int kGS>
__global__ void __launch_bounds__(kThreads)
grads_kernel(Step s, const int8_t* __restrict__ rows,
             const float* __restrict__ w_user,
             const float* __restrict__ p_neg, const float* __restrict__ z,
             const float* __restrict__ hs, float* __restrict__ W,
             float* __restrict__ W_ag, float* __restrict__ bp,
             float* __restrict__ bp_ag, const float* __restrict__ part_dbp,
             const float* __restrict__ part_tch, int user_tiles,
             float* __restrict__ part_dw, int* __restrict__ done, int usplits,
             int per_usplit) {
  cdae::grid_dependency_wait();
  extern __shared__ __align__(16) float smem[];
  const int sa = stride_a(s.Dk), sb = stride_b(s.Dk);
  float* w_s = smem;                    // [kChunkI][sa]  this block's W rows
  float* z_s = w_s + kChunkI * sa;      // [kGS][kCU][sb]
  float* h_s = z_s + kGS * kCU * sb;    // [kGS][kCU][sb]  scale*w_user*hg
  float* g_s = h_s + kGS * kCU * sb;    // [kCU][kSt]
  float* k_s = g_s + kCU * kSt;     // [kCU][kSt] kept01
  float* tch_s = k_s + kCU * kSt;   // [kChunkI]
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kChunkI;
  const int u_begin = blockIdx.y * per_usplit;
  const int u_end = min(s.B, u_begin + per_usplit);
  const int nt = s.Dk / 8;
  const int chunks = (u_end - u_begin + kCU - 1) / kCU;
  // this warp's score tiles: m-tile (users) wm, n-tiles (items) wn ..
  // wn + kTW - 1 (kCU / 16 m-tiles x 4 n-tiles over the 8 warps)
  constexpr int kTW = kCU / 32;
  const int wm = warp / (4 / kTW), wn = (warp % (4 / kTW)) * kTW;
  auto issue = [&](int c) {
    const int u0 = u_begin + c * kCU;
    copy_rows<kVec>(z_s + (c % kGS) * kCU * sb, sb, z, u0, kCU, u_end,
                    s);
    copy_rows<kVec>(h_s + (c % kGS) * kCU * sb, sb, hs, u0, kCU, u_end,
                    s);
    cdae::cp_async_commit();
  };
  // b' of this lane's columns
  float bv[kTW][2];
#pragma unroll
  for (int n = 0; n < kTW; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = i0 + (wn + n) * 8 + 2 * t + e;
      bv[n][e] = col < s.I ? bp[col] : 0.0f;
    }
  }

  copy_rows<kVec>(w_s, sa, W, i0, kChunkI, s.I, s);  // with the first chunk
  issue(0);
  float acc[kNT][2][4];  // d_W: items (2 m-tiles) x the warp's d tiles
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    zero(acc[j][0]);
    zero(acc[j][1]);
  }

  for (int c = 0; c < chunks; ++c) {
    const int u0 = u_begin + c * kCU;
    if (kGS == 2 && c + 1 < chunks) {
      issue(c + 1);  // into the other buffer, overlapping this chunk
      cdae::cp_async_wait<1>();
    } else {
      cdae::cp_async_wait<0>();
    }
    __syncthreads();
    const float* zc = z_s + (c % kGS) * kCU * sb;
    const float* hc = h_s + (c % kGS) * kCU * sb;
    // the cells' row values, w_user and p_neg, loaded while the scores are
    // computed
    float rv[kTW][4], wu[2], pn[2];
#pragma unroll
    for (int n = 0; n < kTW; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rv[n][q] = row_value(s, rows, u0 + wm * 16 + g + 8 * (q >> 1), u_end,
                             i0 + (wn + n) * 8 + 2 * t + (q & 1), s.I);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = u0 + wm * 16 + g + 8 * h;
      wu[h] = b < u_end ? __ldg(w_user + b) : 0.0f;
      pn[h] = b < u_end ? __ldg(p_neg + b) : 0.0f;
    }
    float pred[kTW][4];
#pragma unroll
    for (int n = 0; n < kTW; ++n) zero(pred[n]);
    scores<kTW>(pred, zc + wm * 16 * sb, sb, w_s + wn * 8 * sa, sa, s.Dk, g,
                t);
#pragma unroll
    for (int n = 0; n < kTW; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 16 + g + 8 * (q >> 1);
        const int cc = (wn + n) * 8 + 2 * t + (q & 1);
        const int b = u0 + r, col = i0 + cc;
        float gr = 0.0f, kept01 = 0.0f;
        if (b < u_end && col < s.I) {
          float wmat;
          cell(s, rv[n][q], wu[q >> 1], pn[q >> 1], b, col, &kept01, &wmat);
          gr = loss_grad(s.loss, pred[n][q] + bv[n][q & 1], rv[n][q]) * wmat;
        }
        g_s[r * kSt + cc] = gr;
        k_s[r * kSt + cc] = kept01;
      }
    }
    __syncthreads();
    // d_W[i][d] += sum_b g[b][i] z[b][d] + kept01[b][i] h[b][d], the
    // chunk's products in fresh accumulators (see rows_by_items)
    float part[kNT][2][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      zero(part[j][0]);
      zero(part[j][1]);
    }
#pragma unroll
    for (int kk = 0; kk < kCU / 8; ++kk) {
      const int kc = kk * 8;
      uint32_t gh[2][4], gl[2][4], ka[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // A element (item, user) at g_s[user * kSt + item]
        cdae::load_a(gh[m], gl[m], g_s + kc * kSt + m * 16, 1, kSt, g, t);
        cdae::load_a_exact(ka[m], k_s + kc * kSt + m * 16, 1, kSt, g, t);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = warp + kWarps * j;
        if (n >= nt) break;  // warp-uniform
        uint32_t zh[2], zl[2], hh[2], hl[2];
        cdae::load_b(zh, zl, zc + kc * sb + n * 8, sb, 1, g, t);
        cdae::load_b(hh, hl, hc + kc * sb + n * 8, sb, 1, g, t);
#pragma unroll
        for (int m = 0; m < 2; ++m) cdae::mma_tf32(part[j][m], gl[m], zh);
#pragma unroll
        for (int m = 0; m < 2; ++m) cdae::mma_tf32(part[j][m], gh[m], zl);
#pragma unroll
        for (int m = 0; m < 2; ++m) cdae::mma_tf32(part[j][m], ka[m], hl);
#pragma unroll
        for (int m = 0; m < 2; ++m) cdae::mma_tf32(part[j][m], gh[m], zh);
#pragma unroll
        for (int m = 0; m < 2; ++m) cdae::mma_tf32(part[j][m], ka[m], hh);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][m][q] += part[j][m][q];
      }
    }
    __syncthreads();
    if (kGS == 1 && c + 1 < chunks) issue(c + 1);  // the buffer is free
  }

  // this split's partial of the tile's d_W rows
  float* out = part_dw + static_cast<size_t>(blockIdx.y) * s.I * s.D;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = warp + kWarps * j;
    if (n >= nt) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + m * 16 + g + 8 * (q >> 1);
        const int d = n * 8 + 2 * t + (q & 1);
        if (i < s.I && d < s.D) out[static_cast<size_t>(i) * s.D + d] =
            acc[j][m][q];
      }
    }
  }
  // the item tile's last block sums the splits in order and updates
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = usplits == 1 || atomicAdd(done + blockIdx.x, 1) == usplits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // d_b' and touches: the decode's user tiles, in order
  if (threadIdx.x < kChunkI) {
    const int col = i0 + threadIdx.x;
    float dbp = 0.0f, tch = 0.0f;
    if (col < s.I) {
      for (int k = 0; k < user_tiles; ++k) {
        dbp += part_dbp[static_cast<size_t>(k) * s.I + col];
        tch += part_tch[static_cast<size_t>(k) * s.I + col];
      }
      const float d_bp = dbp + s.lam * tch * bp[col];
      if (s.use_ada) {
        const float a = bp_ag[col] + d_bp * d_bp;
        bp_ag[col] = a;
        bp[col] = bp[col] - s.lr * d_bp / (s.beta + sqrtf(a));
      } else {
        bp[col] = bp[col] - s.lr * d_bp;
      }
    }
    tch_s[threadIdx.x] = tch;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kChunkI * s.D; e += kThreads) {
    const int ci = e / s.D, d = e - ci * s.D;
    const int col = i0 + ci;
    if (col >= s.I) break;
    const size_t at = static_cast<size_t>(col) * s.D + d;
    float dw = 0.0f;
    for (int k = 0; k < usplits; ++k) {
      dw += __ldcg(part_dw + static_cast<size_t>(k) * s.I * s.D + at);
    }
    const float w = w_s[ci * sa + d];
    dw += s.lam * tch_s[ci] * w;
    if (s.use_ada) {
      const float a = W_ag[at] + dw * dw;
      W_ag[at] = a;
      W[at] = w - s.lr * dw / (s.beta + sqrtf(a));
    } else {
      W[at] = w - s.lr * dw;
    }
  }
}

inline size_t encode_smem(int Dk, int stages) {
  return sizeof(float) * (kTileU * kSk + stages * kChunkI * stride_b(Dk));
}
inline size_t decode_smem(int Dk, int stages) {
  return sizeof(float) * ((kTileU + stages * kChunkI) * stride_a(Dk) +
                          kTileU * kSk + 8 * kChunkI);
}
inline size_t grads_smem(int Dk, int cu, int stages) {
  return sizeof(float) * (kChunkI * stride_a(Dk) +
                          2 * stages * cu * stride_b(Dk) + 2 * cu * kSt +
                          kChunkI);
}

// launch `kernel` with programmatic dependent launch (Hopper): its blocks
// may be scheduled while the grid before it on the stream finishes, which
// hides the launch gap between dependent kernels; the kernel's first
// statement waits for that grid (cdae::grid_dependency_wait)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the five launches, with kNT d n-tiles a warp and kVec-float copies. At
// D <= 64 (one d n-tile a warp) a chunk's latency, not its products,
// bounds a step: the encode and decode stream W through three buffers and
// the grads take 64 users a chunk in two; above, W goes through two and the
// grads take 32 users in one buffer, so that two blocks share an SM and
// overlap each other's copies
template <int kNT, int kVec, int kCU = kNT == 1 ? 64 : 32,
          int kGS = kNT == 1 ? 2 : 1, int kWS = kNT == 1 ? 3 : 2>
cudaError_t launch_step(const Step& s, const int8_t* rows,
                        const float* w_user, const float* p_neg,
                        const float* h_bias, float* W, float* W_ag, float* bp,
                        float* bp_ag, float* hg, float* hs, float* z,
                        float* part_h, float* part_hg, float* part_dbp,
                        float* part_tch, float* part_dw, int* done,
                        int splits, int per_split, int usplits,
                        int per_usplit, cudaStream_t st) {
  const int user_tiles = (s.B + kTileU - 1) / kTileU;
  const int item_tiles = (s.I + kChunkI - 1) / kChunkI;
  const unsigned fin_blocks =
      static_cast<unsigned>((static_cast<size_t>(s.B) * s.D + kThreads - 1) /
                            kThreads);
  const size_t es = encode_smem(s.Dk, kWS), ds = decode_smem(s.Dk, kWS),
               gs = grads_smem(s.Dk, kCU, kGS);
  cudaError_t err;
  static cdae::SmemLimit enc_limit, dec_limit, grads_limit;
  if ((err = enc_limit.raise(encode_kernel<kNT, kVec, kWS>, es)) !=
          cudaSuccess ||
      (err = dec_limit.raise(decode_kernel<kNT, kVec, kWS>, ds)) !=
          cudaSuccess ||
      (err = grads_limit.raise(grads_kernel<kNT, kVec, kCU, kGS>, gs)) !=
          cudaSuccess)
    return err;
  // every launch may start while the one before it on the stream drains,
  // and waits for it in its first statement
  if ((err = launch_dependent(encode_kernel<kNT, kVec, kWS>,
                              dim3(user_tiles, splits), es, st, s, rows, W,
                              part_h, per_split)) != cudaSuccess ||
      (err = launch_dependent(encode_finalize, dim3(fin_blocks), 0, st, s,
                              part_h, splits, w_user, h_bias, z, done,
                              item_tiles)) != cudaSuccess ||
      (err = launch_dependent(decode_kernel<kNT, kVec, kWS>,
                              dim3(user_tiles, splits), ds, st, s, rows,
                              w_user, p_neg, z, W, bp, part_hg, part_dbp,
                              part_tch, per_split)) != cudaSuccess ||
      (err = launch_dependent(decode_finalize, dim3(fin_blocks), 0, st, s,
                              part_hg, splits, z, w_user, hg, hs)) !=
          cudaSuccess ||
      (err = launch_dependent(grads_kernel<kNT, kVec, kCU, kGS>,
                              dim3(item_tiles, usplits), gs, st, s, rows,
                              w_user, p_neg, z, hs, W, W_ag, bp, bp_ag,
                              part_dbp, part_tch, user_tiles, part_dw, done,
                              usplits, per_usplit)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

}  // namespace

// One fused step. rows (B, I) int8; w_user, p_neg (B,); h_bias (B, D);
// W, W_ag (I, D) and b', bp_ag (I,) updated in place; hg (B, D) out.
// Scratch from the caller: hs and z (B, D), part_h and part_hg (splits, B,
// D), part_dbp and part_tch (ceil(B/64), I), part_dw (usplits, I, D) and
// done (ceil(I/32) ints, zeroed by the step). 1 <= D <= 256; per_split a
// multiple of 32, per_usplit of 64; ``vec`` 4 when D % 4 == 0 and W is 16-byte
// aligned (z and hs must be too), else 1. Five launches on ``stream``;
// returns the first cudaError_t (0 = all launched).
extern "C" int cdae_fused_step(
    const int8_t* rows, const float* w_user, const float* p_neg,
    const float* h_bias, float* W, float* W_ag, float* bp, float* bp_ag,
    float* hg, float* hs, float* z, float* part_h, float* part_hg,
    float* part_dbp, float* part_tch, float* part_dw, int* done, int B, int I,
    int D, int seed, float q, float scale, float lam, float lr, float beta,
    int use_ada, int act, int loss, int splits, int per_split, int usplits,
    int per_usplit, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxD || per_split % kChunkI || per_usplit % kUsplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Dk = (D + 7) / 8 * 8;
  const Step s{static_cast<uint32_t>(seed), B, I, D, Dk, q, scale, lam, lr,
               beta, use_ada, act, loss};
  // D <= 64: one d n-tile a warp (fewer registers, more blocks an SM)
#define CDAE_STEP(NT, VEC)                                                   \
  launch_step<NT, VEC>(s, rows, w_user, p_neg, h_bias, W, W_ag, bp, bp_ag,  \
                       hg, hs, z, part_h, part_hg, part_dbp, part_tch,      \
                       part_dw, done, splits, per_split, usplits,           \
                       per_usplit, st)
  const bool narrow = Dk <= 8 * kWarps;
  const cudaError_t err =
      vec == 4 ? (narrow ? CDAE_STEP(1, 4) : CDAE_STEP(kMaxNt, 4))
               : (narrow ? CDAE_STEP(1, 1) : CDAE_STEP(kMaxNt, 1));
#undef CDAE_STEP
  return static_cast<int>(err);
}
