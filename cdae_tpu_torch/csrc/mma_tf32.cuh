// 3xTF32 products on the tensor cores with mma.sync.m16n8k8, and the
// cp.async copies that stage their operands: one copy for every kernel that
// multiplies in this way (decode_scores.cu, fused_topk.cu, cdae_fused.cu),
// and the wait of a kernel launched with programmatic dependent launch;
// then Hopper's own pieces (fused_topk.cu): mbarriers, 1-D bulk copies and
// wgmma.mma_async in TF32.
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

// ---- Hopper (sm_90a): mbarriers, 1-D bulk copies and wgmma ---------------
//
// A wgmma B operand lies in shared memory in the K-major layout without
// swizzle: "core matrices" of 8 rows x 16 bytes (8 x 4 TF32), each 128
// contiguous bytes, row r of a core matrix at byte 16 r. A descriptor
// gives the start, LBO (the byte distance between the two core matrices
// that make up the instruction's k = 8) and SBO (between two groups of 8
// rows along N). The A operand in registers has the m16n8k8 layout above,
// warp w of the warpgroup holding rows 16 w .. 16 w + 15; the accumulator
// of m64nNk8 holds, in d[4 j + q], C's element (16 w + g + 8 (q >> 1),
// 8 j + 2 t + (q & 1)).

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more of bulk copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's shared-memory writes before later reads by the async
// proxy (wgmma's operands)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barriers (0 is __syncthreads): wait for `threads` arrivals, or
// arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// move registers between warpgroups (every warp of the warpgroup calls it)
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving accesses of r across a wgmma fence or wait
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// descriptor of a K-major, unswizzled B operand starting at p
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 128, f32) = a (64 x 8, TF32 in registers) * b (8 x 128, TF32 at
// descriptor b) + (scale_d ? d : 0), issued asynchronously by a warpgroup
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace cdae
