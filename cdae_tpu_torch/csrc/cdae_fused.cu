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
// What bounds it on an H100: about 5 * 2*B*I*D flops of f32 FMA (encode,
// two decodes, the hidden gradient, d_W's two products) -- 4e10 at B = 1024,
// I = 20000, D = 200 -- against B*I bytes of int8 rows read three times.
// Without tensor cores this version is bound by FMA issue and by shared
// memory loads feeding it.
//
// Design. On the TPU the phase boundaries are free because the grid runs in
// order. Here each boundary is a grid-wide dependency, so each phase is its
// own launch; the two catalog-wide reductions over items (h and the hidden
// gradient) use ORDERED partial buffers -- every block writes its split's
// partial and a small finalize kernel sums the splits in a fixed order --
// and the reductions over users (d_b', touches) write one partial row per
// user tile that the grads kernel sums in order. No atomics, so a step is
// deterministic run to run.
//   1. encode   grid (user tiles of 32, catalog splits): partial h.
//      finalize z = act(s*sum_splits h + h_bias).
//   2. decode   grid (user tiles, catalog splits): per 32-item chunk, pred,
//      g and w_mat in shared memory; partial hidden gradient g @ W, and the
//      tile's column sums of g and w_mat.
//      finalize hg = sum_splits(hidden gradient) * act'(z).
//   3. grads    one block per 32-item tile walks every user tile: it
//      recomputes pred, g and kept, accumulates its d_W rows in registers,
//      sums the d_b' / touches partials, and applies the update to its own
//      W and b' rows. A block reads only its own rows of W and b' in this
//      launch, so the in-place update is safe.
// Each thread keeps up to 32 accumulators along D (D <= 256, 8 threads per
// row); shared-memory rows have an odd stride so the transposed reads do not
// conflict on banks. At D = 200 a W tile alone is 25.7 KB and the grads
// kernel needs ~86 KB, so the launches raise the dynamic shared memory
// limit with cudaFuncSetAttribute.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash_uniform.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileU = 32;   // users per tile
constexpr int kChunkI = 32;  // items per chunk / per grads block
constexpr int kMaxD = 256;
constexpr int kDPer = kMaxD / 8;  // accumulators per thread along D
constexpr int kGS = kChunkI + 1;  // stride of the (user, item) tiles

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

struct Step {
  uint32_t seed;
  int B, I, D, Dp;
  float q, scale, lam, lr, beta;
  int use_ada, act, loss;
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

// kept (the corrupted input, times w_user) of batch row b at column col;
// rows hold 0/1, and u_c is drawn only on rated cells.
__device__ __forceinline__ float kept_value(const Step& s, const int8_t* rows,
                                            const float* w_user, int b,
                                            int col) {
  const float r = static_cast<float>(rows[static_cast<size_t>(b) * s.I + col]);
  if (r == 0.0f) return 0.0f;
  if (s.q > 0.0f && !(cdae::hash_uniform(s.seed, b, col, 0) > s.q))
    return 0.0f;
  return r * w_user[b];
}

// rows01 of batch row b at column col, and its masks: kept (as above) and
// w_mat (the touch weight: the row plus the negatives). Only the draw that
// can matter is made: u_c only on rated cells, u_n only on unrated ones.
__device__ __forceinline__ void cell(const Step& s, const int8_t* rows,
                                     const float* w_user, const float* p_neg,
                                     int b, int col, float* r01, float* kept,
                                     float* wmat) {
  const float r = static_cast<float>(rows[static_cast<size_t>(b) * s.I + col]);
  const float wu = w_user[b];
  float k = r;
  float neg = 0.0f;
  if (r != 0.0f) {
    if (s.q > 0.0f && !(cdae::hash_uniform(s.seed, b, col, 0) > s.q)) k = 0.0f;
  } else if (cdae::hash_uniform(s.seed, b, col, 1) < p_neg[b]) {
    neg = wu;
  }
  *r01 = r;
  *kept = k * wu;
  *wmat = r * wu + neg;
}

// pred for one user row (z_row, stride 1) and 4 item rows of a W tile
__device__ __forceinline__ void dot4(const float* z_row, const float* w_s,
                                     int Dp, int D, int c0, float out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float zv = z_row[d];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = fmaf(zv, w_s[(c0 + 8 * k) * Dp + d], out[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
encode_kernel(Step s, const int8_t* __restrict__ rows,
              const float* __restrict__ w_user, const float* __restrict__ W,
              float* __restrict__ part_h, int per_split) {
  extern __shared__ float smem[];
  float* kept_s = smem;                // [kTileU][kGS]
  float* w_s = kept_s + kTileU * kGS;  // [kChunkI][Dp]
  const int b0 = blockIdx.x * kTileU;
  const int i_begin = blockIdx.y * per_split;
  const int i_end = min(s.I, i_begin + per_split);
  const int r = threadIdx.x / 8, dl = threadIdx.x % 8;
  const int jn = (s.D - dl + 7) / 8;  // live accumulators of this thread
  float acc[kDPer];
#pragma unroll
  for (int j = 0; j < kDPer; ++j) acc[j] = 0.0f;

  for (int i0 = i_begin; i0 < i_end; i0 += kChunkI) {
    for (int e = threadIdx.x; e < kTileU * kChunkI; e += kThreads) {
      const int rr = e / kChunkI, cc = e % kChunkI;
      const int b = b0 + rr, col = i0 + cc;
      kept_s[rr * kGS + cc] =
          b < s.B && col < i_end ? kept_value(s, rows, w_user, b, col) : 0.0f;
    }
    for (int e = threadIdx.x; e < kChunkI * s.D; e += kThreads) {
      const int cc = e / s.D, d = e % s.D;
      const int col = i0 + cc;
      w_s[cc * s.Dp + d] = col < i_end ? W[static_cast<size_t>(col) * s.D + d]
                                       : 0.0f;
    }
    __syncthreads();
    for (int cc = 0; cc < kChunkI; ++cc) {
      const float k = kept_s[r * kGS + cc];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        if (j >= jn) break;
        acc[j] = fmaf(k, w_s[cc * s.Dp + dl + 8 * j], acc[j]);
      }
    }
    __syncthreads();
  }
  const int b = b0 + r;
  if (b < s.B) {
    float* out = part_h + (static_cast<size_t>(blockIdx.y) * s.B + b) * s.D;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int d = dl + 8 * j;
      if (d < s.D) out[d] = acc[j];
    }
  }
}

// z = act(scale * sum_splits part_h + h_bias)
__global__ void encode_finalize(Step s, const float* __restrict__ part_h,
                                int splits, const float* __restrict__ h_bias,
                                float* __restrict__ z) {
  const size_t n = static_cast<size_t>(s.B) * s.D;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float h = 0.0f;
  for (int k = 0; k < splits; ++k) h += part_h[k * n + i];
  z[i] = activate(s.act, h * s.scale + h_bias[i]);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(Step s, const int8_t* __restrict__ rows,
              const float* __restrict__ w_user,
              const float* __restrict__ p_neg, const float* __restrict__ z,
              const float* __restrict__ W, const float* __restrict__ bp,
              float* __restrict__ part_hg, float* __restrict__ part_dbp,
              float* __restrict__ part_tch, int per_split) {
  extern __shared__ float smem[];
  float* z_s = smem;                    // [kTileU][Dp]
  float* w_s = z_s + kTileU * s.Dp;     // [kChunkI][Dp]
  float* g_s = w_s + kChunkI * s.Dp;    // [kTileU][kGS]
  float* m_s = g_s + kTileU * kGS;      // [kTileU][kGS]  w_mat
  const int b0 = blockIdx.x * kTileU;
  const int i_begin = blockIdx.y * per_split;
  const int i_end = min(s.I, i_begin + per_split);
  const int r = threadIdx.x / 8, dl = threadIdx.x % 8;
  const int jn = (s.D - dl + 7) / 8;  // live accumulators of this thread
  const int b = b0 + r;

  for (int e = threadIdx.x; e < kTileU * s.D; e += kThreads) {
    const int rr = e / s.D, d = e % s.D;
    z_s[rr * s.Dp + d] =
        b0 + rr < s.B ? z[static_cast<size_t>(b0 + rr) * s.D + d] : 0.0f;
  }
  float acc[kDPer];
#pragma unroll
  for (int j = 0; j < kDPer; ++j) acc[j] = 0.0f;

  for (int i0 = i_begin; i0 < i_end; i0 += kChunkI) {
    for (int e = threadIdx.x; e < kChunkI * s.D; e += kThreads) {
      const int cc = e / s.D, d = e % s.D;
      const int col = i0 + cc;
      w_s[cc * s.Dp + d] = col < i_end ? W[static_cast<size_t>(col) * s.D + d]
                                       : 0.0f;
    }
    __syncthreads();
    float pred[4];
    dot4(z_s + r * s.Dp, w_s, s.Dp, s.D, dl, pred);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = dl + 8 * k, col = i0 + c;
      float g = 0.0f, wmat = 0.0f;
      if (b < s.B && col < i_end) {
        float r01, kept;
        cell(s, rows, w_user, p_neg, b, col, &r01, &kept, &wmat);
        g = loss_grad(s.loss, pred[k] + bp[col], r01) * wmat;
      }
      g_s[r * kGS + c] = g;
      m_s[r * kGS + c] = wmat;
    }
    __syncthreads();
    // hidden gradient: acc[r][d] += sum_c g[r][c] * W[c][d]
    for (int cc = 0; cc < kChunkI; ++cc) {
      const float g = g_s[r * kGS + cc];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        if (j >= jn) break;
        acc[j] = fmaf(g, w_s[cc * s.Dp + dl + 8 * j], acc[j]);
      }
    }
    // this user tile's column sums of g and w_mat, users in order
    if (threadIdx.x < kChunkI) {
      const int col = i0 + threadIdx.x;
      if (col < i_end) {
        float sg = 0.0f, sm = 0.0f;
        for (int rr = 0; rr < kTileU; ++rr) {
          sg += g_s[rr * kGS + threadIdx.x];
          sm += m_s[rr * kGS + threadIdx.x];
        }
        part_dbp[static_cast<size_t>(blockIdx.x) * s.I + col] = sg;
        part_tch[static_cast<size_t>(blockIdx.x) * s.I + col] = sm;
      }
    }
    __syncthreads();
  }
  if (b < s.B) {
    float* out = part_hg + (static_cast<size_t>(blockIdx.y) * s.B + b) * s.D;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int d = dl + 8 * j;
      if (d < s.D) out[d] = acc[j];
    }
  }
}

// hg = (sum_splits part_hg) * act'(z)
__global__ void decode_finalize(Step s, const float* __restrict__ part_hg,
                                int splits, const float* __restrict__ z,
                                float* __restrict__ hg) {
  const size_t n = static_cast<size_t>(s.B) * s.D;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float h = 0.0f;
  for (int k = 0; k < splits; ++k) h += part_hg[k * n + i];
  hg[i] = h * act_grad(s.act, z[i]);
}

__global__ void __launch_bounds__(kThreads)
grads_kernel(Step s, const int8_t* __restrict__ rows,
             const float* __restrict__ w_user,
             const float* __restrict__ p_neg, const float* __restrict__ z,
             const float* __restrict__ hg, float* __restrict__ W,
             float* __restrict__ W_ag, float* __restrict__ bp,
             float* __restrict__ bp_ag, const float* __restrict__ part_dbp,
             const float* __restrict__ part_tch, int user_tiles) {
  extern __shared__ float smem[];
  float* w_s = smem;                  // [kChunkI][Dp]  this block's W rows
  float* z_s = w_s + kChunkI * s.Dp;  // [kTileU][Dp]
  float* h_s = z_s + kTileU * s.Dp;   // [kTileU][Dp]   scale * hg
  float* g_s = h_s + kTileU * s.Dp;   // [kTileU][kGS]
  float* k_s = g_s + kTileU * kGS;    // [kTileU][kGS]  kept
  float* tch_s = k_s + kTileU * kGS;  // [kChunkI]
  const int i0 = blockIdx.x * kChunkI;
  const int ci = threadIdx.x / 8, dl = threadIdx.x % 8;  // d_W layout
  const int r = threadIdx.x / 8;                         // pred layout
  const int jn = (s.D - dl + 7) / 8;  // live accumulators of this thread

  for (int e = threadIdx.x; e < kChunkI * s.D; e += kThreads) {
    const int cc = e / s.D, d = e % s.D;
    w_s[cc * s.Dp + d] =
        i0 + cc < s.I ? W[static_cast<size_t>(i0 + cc) * s.D + d] : 0.0f;
  }
  float acc[kDPer];
#pragma unroll
  for (int j = 0; j < kDPer; ++j) acc[j] = 0.0f;

  for (int b0 = 0; b0 < s.B; b0 += kTileU) {
    for (int e = threadIdx.x; e < kTileU * s.D; e += kThreads) {
      const int rr = e / s.D, d = e % s.D;
      const bool live = b0 + rr < s.B;
      const size_t src = static_cast<size_t>(b0 + rr) * s.D + d;
      z_s[rr * s.Dp + d] = live ? z[src] : 0.0f;
      h_s[rr * s.Dp + d] = live ? hg[src] * s.scale : 0.0f;
    }
    __syncthreads();
    float pred[4];
    dot4(z_s + r * s.Dp, w_s, s.Dp, s.D, dl, pred);
    const int b = b0 + r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = dl + 8 * k, col = i0 + c;
      float g = 0.0f, kept = 0.0f;
      if (b < s.B && col < s.I) {
        float r01, wmat;
        cell(s, rows, w_user, p_neg, b, col, &r01, &kept, &wmat);
        g = loss_grad(s.loss, pred[k] + bp[col], r01) * wmat;
      }
      g_s[r * kGS + c] = g;
      k_s[r * kGS + c] = kept;
    }
    __syncthreads();
    // d_W[ci][d] += sum_r g[r][ci] * z[r][d] + kept[r][ci] * (s*hg)[r][d]
    for (int rr = 0; rr < kTileU; ++rr) {
      const float g = g_s[rr * kGS + ci];
      const float k = k_s[rr * kGS + ci];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        if (j >= jn) break;
        const int d = dl + 8 * j;
        acc[j] = fmaf(g, z_s[rr * s.Dp + d], acc[j]);
        acc[j] = fmaf(k, h_s[rr * s.Dp + d], acc[j]);
      }
    }
    __syncthreads();
  }

  // d_b' and touches: the user tiles' partials, in order
  if (threadIdx.x < kChunkI) {
    const int col = i0 + threadIdx.x;
    float dbp = 0.0f, tch = 0.0f;
    if (col < s.I) {
      for (int t = 0; t < user_tiles; ++t) {
        dbp += part_dbp[static_cast<size_t>(t) * s.I + col];
        tch += part_tch[static_cast<size_t>(t) * s.I + col];
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

  const int col = i0 + ci;
  if (col < s.I) {
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int d = dl + 8 * j;
      if (d < s.D) {
        const size_t at = static_cast<size_t>(col) * s.D + d;
        const float w = w_s[ci * s.Dp + d];
        const float dw = acc[j] + s.lam * tch_s[ci] * w;
        if (s.use_ada) {
          const float a = W_ag[at] + dw * dw;
          W_ag[at] = a;
          W[at] = w - s.lr * dw / (s.beta + sqrtf(a));
        } else {
          W[at] = w - s.lr * dw;
        }
      }
    }
  }
}

inline size_t encode_smem(int Dp) {
  return sizeof(float) * (kTileU * kGS + kChunkI * Dp);
}
inline size_t decode_smem(int Dp) {
  return sizeof(float) * ((kTileU + kChunkI) * Dp + 2 * kTileU * kGS);
}
inline size_t grads_smem(int Dp) {
  return sizeof(float) *
         ((kChunkI + 2 * kTileU) * Dp + 2 * kTileU * kGS + kChunkI);
}

}  // namespace

// One fused step. rows (B, I) int8; w_user, p_neg (B,); h_bias (B, D);
// W, W_ag (I, D) and b', bp_ag (I,) updated in place; hg (B, D) out.
// Scratch from the caller: z (B, D), part_h and part_hg (splits, B, D),
// part_dbp and part_tch (ceil(B/32), I). 1 <= D <= 256. Launches on
// ``stream`` and returns the first cudaError_t (0 = all launched).
extern "C" int cdae_fused_step(
    const int8_t* rows, const float* w_user, const float* p_neg,
    const float* h_bias, float* W, float* W_ag, float* bp, float* bp_ag,
    float* hg, float* z, float* part_h, float* part_hg, float* part_dbp,
    float* part_tch, int B, int I, int D, int seed, float q, float scale,
    float lam, float lr, float beta, int use_ada, int act, int loss,
    int splits, int per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step s{static_cast<uint32_t>(seed), B, I, D, D | 1, q, scale, lam, lr, beta,
         use_ada, act, loss};
  const int user_tiles = (B + kTileU - 1) / kTileU;
  const unsigned fin_blocks =
      static_cast<unsigned>((static_cast<size_t>(B) * D + kThreads - 1) /
                            kThreads);
  const size_t es = encode_smem(s.Dp), ds = decode_smem(s.Dp),
               gs = grads_smem(s.Dp);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(es))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(ds))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(gs))) != cudaSuccess)
    return static_cast<int>(err);

  encode_kernel<<<dim3(user_tiles, splits), kThreads, es, st>>>(
      s, rows, w_user, W, part_h, per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  encode_finalize<<<fin_blocks, kThreads, 0, st>>>(s, part_h, splits, h_bias,
                                                   z);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  decode_kernel<<<dim3(user_tiles, splits), kThreads, ds, st>>>(
      s, rows, w_user, p_neg, z, W, bp, part_hg, part_dbp, part_tch,
      per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  decode_finalize<<<fin_blocks, kThreads, 0, st>>>(s, part_hg, splits, z, hg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  grads_kernel<<<(I + kChunkI - 1) / kChunkI, kThreads, gs, st>>>(
      s, rows, w_user, p_neg, z, hg, W, W_ag, bp, bp_ag, part_dbp, part_tch,
      user_tiles);
  return static_cast<int>(cudaGetLastError());
}
