// 3xTF32 products on the tensor cores with mma.sync.m16n8k8, and the
// cp.async copies that stage their operands: one copy for every kernel that
// multiplies in this way (decode_scores.cu, fused_topk.cu, cdae_fused.cu),
// and the wait of a kernel launched with programmatic dependent launch.
//
// 3xTF32: each f32 operand x is split into a TF32 part hi = rna(x) and a
// remainder lo = x - hi (read as TF32); the tensor cores add lo*hi + hi*lo +
// hi*hi into f32 accumulators (the small terms first), which keeps f32-level
// accuracy (the dropped lo*lo term is ~2^-22 of each product) at three
// tensor-core products per f32 one. An operand that is exact in TF32 (a 0/1
// mask) has lo = 0, and its products take two: hi*lo + hi*hi.
//
// Fragments of m16n8k8 (row.col), for lane = 4 g + t:
//   A (16 x 8, row m, column k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4);
//   B (8 x 8, row k, column n): b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// The loaders below read an operand element (r, c) at p[r * rs + c * cs] of
// a shared-memory array, so a kernel picks the layout (and the padding that
// keeps the eight rows a fragment reads on distinct banks).

#pragma once

#include <cstdint>

namespace cdae {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 4 * kVec bytes global -> shared, zero-filling when !valid
template <int kVec>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
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

// wait until the grid launched before this one on the stream has finished
// and its writes are visible: the first statement of a kernel launched
// with programmatic dependent launch (a no-op for any other launch)
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// hi = rna(x); lo = x - hi as f32 bits: the tensor cores read a TF32
// operand's top 19 bits and drop the rest, so lo goes in truncated, as
// CUTLASS's fast 3xTF32 passes it (a relative error of 2^-10 on lo, 2^-21
// on x), one instruction fewer than rounding it
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment at p (its element (0, 0)), split into hi and lo
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* p, int rs, int cs, int g,
                                       int t) {
  split_tf32(p[g * rs + t * cs], hi[0], lo[0]);
  split_tf32(p[(g + 8) * rs + t * cs], hi[1], lo[1]);
  split_tf32(p[g * rs + (t + 4) * cs], hi[2], lo[2]);
  split_tf32(p[(g + 8) * rs + (t + 4) * cs], hi[3], lo[3]);
}

// A fragment of values exact in TF32 (0/1): the bits as they are
__device__ __forceinline__ void load_a_exact(uint32_t (&a)[4], const float* p,
                                             int rs, int cs, int g, int t) {
  a[0] = __float_as_uint(p[g * rs + t * cs]);
  a[1] = __float_as_uint(p[(g + 8) * rs + t * cs]);
  a[2] = __float_as_uint(p[g * rs + (t + 4) * cs]);
  a[3] = __float_as_uint(p[(g + 8) * rs + (t + 4) * cs]);
}

// B fragment at p (its element (k = 0, n = 0)), split into hi and lo
__device__ __forceinline__ void load_b(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       const float* p, int rs, int cs, int g,
                                       int t) {
  split_tf32(p[t * rs + g * cs], hi[0], lo[0]);
  split_tf32(p[(t + 4) * rs + g * cs], hi[1], lo[1]);
}

}  // namespace cdae
