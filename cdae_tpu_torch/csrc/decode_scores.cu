// Full-catalog decoder scores: out = z @ W^T + b'  (B, I), float32.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:decode_scores (the Pallas MXU
// kernel with a fused bias).
//
// What bounds it on an H100: the kernel runs on the tensor cores in 3xTF32
// (below), 3 * 2 * B * I * D operations at the published 495 TFLOP/s of
// TF32, against the bytes it must move (z, W, b' once, the (B, I) f32
// scores once) at 3.35 TB/s. At D = 50 the output write bounds it
// (1024 x 3706: 0.0048 ms); at D = 200 the operations do (1024 x 20000:
// 0.0497 ms).
//
// Arithmetic: 3xTF32. Each f32 operand x is split into a TF32 part
// hi = rna(x) and a TF32 remainder lo = rna(x - hi); the tensor cores add
// lo*hi + hi*lo + hi*hi into f32 accumulators (the small terms first), which
// keeps f32-level accuracy (the dropped lo*lo term is ~2^-22 of each
// product) at three tensor-core products per f32 one.
//
// Design: mma.sync.m16n8k8 (row.col: z and W are both row-major with D
// contiguous, i.e. K-major, as the instruction takes them), not wgmma. One
// 256-thread block per 128 x 128 output tile; 8 warps of 64 x 32, each
// with 4 x 4 m16n8 accumulator tiles, issuing the three products of a step
// one accumulator after another, so no product waits on the one before it.
// Operands are staged by cp.async (16-, 8- or 4-byte copies, as D and the
// pointers allow) into shared rows padded by 4 floats, so the fragment
// reads hit 32 distinct banks: all of D at once when D <= 64 and D is
// even (one wait on memory a block), else 16-wide chunks in two buffers,
// the copy of chunk c + 1 overlapping the products of chunk c. The
// zero-filled tail of the last chunk is only multiplied up to the MMA's
// k = 8 (D = 50 runs 56, not 64). The epilogue stages the score tile in
// shared memory and writes it row by row with b' added, 16-byte stores
// when I % 4 == 0 (8-byte when I is even), a warp's store covering 512
// (256) contiguous bytes; the ragged B and I edges are masked.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTileB = 128, kTileI = 128;
constexpr int kThreads = 256;
constexpr int kWarpB = 64, kWarpI = 32;  // 2 x 4 warps over the tile
constexpr int kMt = kWarpB / 16, kNt = kWarpI / 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 4 * kVec bytes global -> shared, zero-filling when !valid
template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const int bytes = valid ? 4 * kVec : 0;
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else if constexpr (kVec == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D staged kChunk at a time in kStages shared buffers of kChunk + 4
// floats a row (the padding puts the eight rows a fragment reads on
// distinct banks: the stride is 4 mod 32)
// The epilogue reuses the buffers for the (128, 128) score tile, rows
// padded by 8 floats so the accumulators' pairs land on distinct banks.
constexpr int kOutRow = kTileI + 8;
constexpr int kOutBytes = kTileB * kOutRow * 4;

template <int kChunk, int kStages>
struct Stages {
  static constexpr int kRow = kChunk + 4;
  static constexpr int kStage = (kTileB + kTileI) * kRow;  // floats
  static constexpr int kStageBytes = kStages * kStage * 4;
  static constexpr int kSmemBytes =
      kStageBytes > kOutBytes ? kStageBytes : kOutBytes;
};

// stage rows [r0, r0 + kRows) x [d0, d0 + kChunk) of a (rows, D) matrix
// into dst (kRows rows of kRow floats)
template <int kVec, int kRows, int kChunk>
__device__ __forceinline__ void load_chunk(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int rows, int d0, int D) {
  constexpr int kRow = kChunk + 4;
  constexpr int kPerRow = kChunk / kVec;
  constexpr int kTotal = kRows * kPerRow;
  constexpr int kCopies = (kTotal + kThreads - 1) / kThreads;
#pragma unroll 4
  for (int j = 0; j < kCopies; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (kTotal % kThreads != 0 && e >= kTotal) break;
    const int r = e / kPerRow, d = (e % kPerRow) * kVec;
    const int gr = r0 + r, gd = d0 + d;
    const bool valid = gr < rows && gd < D;  // D % kVec == 0
    copy_async<kVec>(dst + r * kRow + d,
                     valid ? src + static_cast<size_t>(gr) * D + gd : src,
                     valid);
  }
}

template <int kVec, int kChunk, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
decode_scores_kernel(const float* __restrict__ z, const float* __restrict__ W,
                     const float* __restrict__ bp, float* __restrict__ out,
                     int B, int I, int D) {
  using S = Stages<kChunk, kStages>;
  constexpr int kRow = S::kRow;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wb = (warp & 1) * kWarpB, wi = (warp >> 1) * kWarpI;
  const int b0 = blockIdx.y * kTileB, i0 = blockIdx.x * kTileI;
  // stage s: z rows at smem + s * kStage, W rows after them
  auto zs = [&](int s) { return smem + s * S::kStage; };
  auto ws = [&](int s) { return smem + s * S::kStage + kTileB * kRow; };
  auto stage_in = [&](int s, int c) {
    load_chunk<kVec, kTileB, kChunk>(zs(s), z, b0, B, c * kChunk, D);
    load_chunk<kVec, kTileI, kChunk>(ws(s), W, i0, I, c * kChunk, D);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kMt][kNt][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
    }
  }

  const int chunks = (D + kChunk - 1) / kChunk;
  if constexpr (kStages > 1) {
    if (chunks > 0) stage_in(0, 0);
  }
  for (int c = 0; c < chunks; ++c) {
    const int s = kStages > 1 ? c & 1 : 0;
    if constexpr (kStages == 1) {  // one chunk holds all of D: one copy
      stage_in(0, c);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else if (c + 1 < chunks) {  // the next chunk's copy overlaps this one
      stage_in(s ^ 1, c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* zc = zs(s);
    const float* wc = ws(s);
    const int ksteps = min(kChunk / 8, (D - c * kChunk + 7) / 8);
    for (int kk = 0; kk < ksteps; ++kk) {
      const int k = kk * 8 + t;
      uint32_t bh[kNt][2], bl[kNt][2];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const float* row = wc + (wi + n * 8 + g) * kRow;
        split_tf32(row[k], bh[n][0], bl[n][0]);
        split_tf32(row[k + 4], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
        const float* r_lo = zc + (wb + m * 16 + g) * kRow;
        const float* r_hi = r_lo + 8 * kRow;
        uint32_t ah[4], al[4];
        split_tf32(r_lo[k], ah[0], al[0]);
        split_tf32(r_hi[k], ah[1], al[1]);
        split_tf32(r_lo[k + 4], ah[2], al[2]);
        split_tf32(r_hi[k + 4], ah[3], al[3]);
        // the small terms first; one product of each of the kNt
        // accumulators between two that update the same one
#pragma unroll
        for (int n = 0; n < kNt; ++n) mma_tf32(acc[m][n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < kNt; ++n) mma_tf32(acc[m][n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < kNt; ++n) mma_tf32(acc[m][n], ah, bh[n]);
      }
    }
    __syncthreads();  // the next copy overwrites this stage
  }

  // epilogue: acc[m][n] holds rows (g, g + 8) x columns (2t, 2t + 1);
  // stage the tile in shared memory, then each warp writes whole rows:
  // 16-, 8- or 4-byte stores of neighbouring columns, as I allows
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wb + m * 16 + g + 8 * h;
        *reinterpret_cast<float2*>(smem + r * kOutRow + wi + n * 8 + 2 * t) =
            make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int vo = (I & 3) == 0 ? 4 : ((I & 1) == 0 ? 2 : 1);
  for (int r = warp; r < kTileB && b0 + r < B; r += kThreads / 32) {
    const float* src = smem + r * kOutRow;
    float* dst = out + static_cast<size_t>(b0 + r) * I + i0;
    for (int c = lane * vo; c < kTileI; c += 32 * vo) {
      const int col = i0 + c;
      if (vo == 4 && col + 3 < I) {
        float4 v = *reinterpret_cast<const float4*>(src + c);
        v.x += bp[col];
        v.y += bp[col + 1];
        v.z += bp[col + 2];
        v.w += bp[col + 3];
        *reinterpret_cast<float4*>(dst + c) = v;
      } else if (vo == 2 && col + 1 < I) {
        float2 v = *reinterpret_cast<const float2*>(src + c);
        v.x += bp[col];
        v.y += bp[col + 1];
        *reinterpret_cast<float2*>(dst + c) = v;
      } else {
        for (int q = 0; q < vo && col + q < I; ++q) {
          dst[c + q] = src[c + q] + bp[col + q];
        }
      }
    }
  }
}

template <int kVec, int kChunk, int kStages>
void launch(const float* z, const float* W, const float* bp, float* out,
            int B, int I, int D, cudaStream_t s) {
  constexpr int kSmem = Stages<kChunk, kStages>::kSmemBytes;
  auto* kernel = decode_scores_kernel<kVec, kChunk, kStages>;
  // above the default dynamic limit of 48 KB: raised once for each device
  // (a driver call on every launch would cost host time; setting it twice
  // from two threads is harmless)
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !raised[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 grid((I + kTileI - 1) / kTileI, (B + kTileB - 1) / kTileB);
  kernel<<<grid, kThreads, kSmem, s>>>(z, W, bp, out, B, I, D);
}

// D <= 64: all of D in one copy (one wait on memory a block, not one a
// 16-wide chunk); longer rows, and 4-byte copies (whose 64-wide chunk
// would take 32 copies a thread and spill), 16-wide chunks, double-buffered
template <int kVec>
void launch_d(const float* z, const float* W, const float* bp, float* out,
              int B, int I, int D, cudaStream_t s) {
  if constexpr (kVec > 1) {
    if (D <= 64) {
      launch<kVec, 64, 1>(z, W, bp, out, B, I, D, s);
      return;
    }
  }
  launch<kVec, 16, 2>(z, W, bp, out, B, I, D, s);
}

}  // namespace

// ``vec`` (4, 2 or 1): floats a copy moves -- D % vec == 0 and z, W
// 4 * vec-byte aligned. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cdae_decode_scores(const float* z, const float* W,
                                  const float* bp, float* out, int B, int I,
                                  int D, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    launch_d<4>(z, W, bp, out, B, I, D, s);
  } else if (vec == 2) {
    launch_d<2>(z, W, bp, out, B, I, D, s);
  } else {
    launch_d<1>(z, W, bp, out, B, I, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* cdae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
