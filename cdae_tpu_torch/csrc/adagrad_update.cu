// One AdaGrad step in place over a list of tables, in one launch:
// a += g*g; p -= lr*g / (beta + sqrt(a)) for every element of every table.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:adagrad_update (the Pallas kernel
// with donated buffers, one call per table). In the port it is the sweep
// over every dense table a training step updates (solver/optimizer.py
// dense_adagrad_steps on CUDA): CDAE's W, b', b (and V), WARP's uv and iv,
// FISM's bu, Q, bi and P -- one launch a step.
//
// What bounds it on an H100: 3 reads and 2 writes per element (20 bytes
// with an f32 param, 16 with a bf16 one) and 7 operations, so device memory
// bandwidth: config-4's (20000, 200) table is 80 MB, 24 us at 3.35 TB/s.
// A step's tables at ML-1M move 3.8 MB (1.1 us), less than a launch's
// fixed cost, which one launch per step pays once instead of once a table.
//
// Design: the tables' descriptors travel by value in the kernel's
// parameter space (__grid_constant__: no copy to the device, no second
// launch). The host gives each table a run of blocks, the prefix of the
// per-table counts, and a block finds its table by comparing its index
// with every table's first block. A block covers kThreads * vecs quads of 4 elements. Each thread
// loads all its quads (16-byte float4 accesses of acc and grad; 16 bytes
// of an f32 param, 8 of a bf16 one) before it computes, so on a large step
// several loads a thread are in flight. The last quad of an n that 4 does
// not divide takes scalar accesses in the same batch (a separate tail
// step would add a second round trip to the launch's critical path). A
// table whose pointers are not aligned for quads covers the same elements
// with coalesced scalar accesses.
//
// Arithmetic: the accumulator and the arithmetic are f32; a bf16 param is
// converted, updated in f32 and rounded back to nearest. Every operation
// uses an _rn intrinsic, which nvcc never contracts into an FMA, in the
// plain version's order, so the result equals PyTorch's op-by-op plain
// version (ops/pallas_kernels.py adagrad_update_plain, table by table) bit
// for bit. The library is built without --use_fast_math, so sqrt and the
// division are IEEE round-to-nearest too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVecs = 4;       // quads a thread keeps in flight
constexpr int kMaxTables = 16;    // descriptors in one launch
constexpr int kDescWords = 5;     // int64 words of a host descriptor
constexpr long long kWideGrid = 1024;  // blocks before vecs grows past 1

constexpr int kBf16 = 1;    // flags: the param is __nv_bfloat16
constexpr int kVector = 2;  // flags: pointers aligned for quad accesses

struct Table {
  void* param;
  float* acc;
  const float* grad;
  long long n;
  int flags;
};

struct Tables {
  int first_block[kMaxTables];  // INT_MAX past the last table
  Table t[kMaxTables];
  int vecs;
  float lr;
  float beta;
};

// The update of one element: acc in place, the new param returned.
__device__ __forceinline__ float step(float& a, float g, float p, float lr,
                                      float beta) {
  a = __fadd_rn(a, __fmul_rn(g, g));
  return __fsub_rn(
      p, __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(beta, __fsqrt_rn(a))));
}

__device__ __forceinline__ float4 step4(float4& a, float4 g, float4 p,
                                        float lr, float beta) {
  return make_float4(step(a.x, g.x, p.x, lr, beta),
                     step(a.y, g.y, p.y, lr, beta),
                     step(a.z, g.z, p.z, lr, beta),
                     step(a.w, g.w, p.w, lr, beta));
}

template <bool kBf>
__device__ __forceinline__ float4 load_param4(const void* p, long long q) {
  if constexpr (kBf) {
    const uint2 raw = static_cast<const uint2*>(p)[q];
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return static_cast<const float4*>(p)[q];
  }
}

template <bool kBf>
__device__ __forceinline__ void store_param4(void* p, long long q, float4 v) {
  if constexpr (kBf) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    static_cast<uint2*>(p)[q] = raw;
  } else {
    static_cast<float4*>(p)[q] = v;
  }
}

__device__ __forceinline__ float load_param(const Table& t, long long i) {
  return (t.flags & kBf16)
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(t.param)[i])
             : static_cast<const float*>(t.param)[i];
}

__device__ __forceinline__ void store_param(const Table& t, long long i,
                                            float v) {
  if (t.flags & kBf16) {
    static_cast<__nv_bfloat16*>(t.param)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(t.param)[i] = v;
  }
}

// Quad q of a table with aligned pointers into registers: 16-byte loads, or
// for the last quad of an n that 4 does not divide, scalar loads of its
// elements (the missing lanes get values whose update is finite).
template <bool kBf>
__device__ __forceinline__ void load_quad(const Table& t, long long q,
                                          float4& g, float4& a, float4& p) {
  if (4 * q + 4 <= t.n) {
    g = reinterpret_cast<const float4*>(t.grad)[q];
    a = reinterpret_cast<const float4*>(t.acc)[q];
    p = load_param4<kBf>(t.param, q);
    return;
  }
  float gv[4] = {0.f, 0.f, 0.f, 0.f}, av[4] = {1.f, 1.f, 1.f, 1.f},
        pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const long long i = 4 * q + e;
    if (i < t.n) {
      gv[e] = t.grad[i];
      av[e] = t.acc[i];
      pv[e] = load_param(t, i);
    }
  }
  g = make_float4(gv[0], gv[1], gv[2], gv[3]);
  a = make_float4(av[0], av[1], av[2], av[3]);
  p = make_float4(pv[0], pv[1], pv[2], pv[3]);
}

template <bool kBf>
__device__ __forceinline__ void store_quad(const Table& t, long long q,
                                           float4 a, float4 p) {
  if (4 * q + 4 <= t.n) {
    reinterpret_cast<float4*>(t.acc)[q] = a;
    store_param4<kBf>(t.param, q, p);
    return;
  }
  const float av[4] = {a.x, a.y, a.z, a.w}, pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const long long i = 4 * q + e;
    if (i < t.n) {
      t.acc[i] = av[e];
      store_param(t, i, pv[e]);
    }
  }
}

// Quads q0 + v * kThreads (v < vecs, q < ceil(n / 4)) of a table whose
// pointers are aligned for them: every load first, then the updates and
// the stores.
template <bool kBf>
__device__ __forceinline__ void sweep_quads(const Table& t, long long q0,
                                            int vecs, float lr, float beta) {
  const long long nq = (t.n + 3) >> 2;
  float4 g[kMaxVecs], a[kMaxVecs], p[kMaxVecs];
#pragma unroll
  for (int v = 0; v < kMaxVecs; ++v) {
    const long long q = q0 + static_cast<long long>(v) * kThreads;
    if (v < vecs && q < nq) load_quad<kBf>(t, q, g[v], a[v], p[v]);
  }
#pragma unroll
  for (int v = 0; v < kMaxVecs; ++v) {
    const long long q = q0 + static_cast<long long>(v) * kThreads;
    if (v < vecs && q < nq) {
      const float4 out = step4(a[v], g[v], p[v], lr, beta);
      store_quad<kBf>(t, q, a[v], out);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adagrad_tables_kernel(const __grid_constant__ Tables tabs) {
  // the block's table, read with constant indices only: each read is an
  // operand of the parameter bank, where a dynamic index would be a chain
  // of dependent loads at the start of every block
  const int block = static_cast<int>(blockIdx.x);
  Table t = tabs.t[0];
  int first = 0;
#pragma unroll
  for (int k = 1; k < kMaxTables; ++k) {
    if (block >= tabs.first_block[k]) {
      t = tabs.t[k];
      first = tabs.first_block[k];
    }
  }
  const long long local = block - first;
  const int vecs = tabs.vecs;
  const float lr = tabs.lr, beta = tabs.beta;
  if (t.flags & kVector) {
    const long long q0 = local * kThreads * vecs + threadIdx.x;
    if (t.flags & kBf16) {
      sweep_quads<true>(t, q0, vecs, lr, beta);
    } else {
      sweep_quads<false>(t, q0, vecs, lr, beta);
    }
    return;
  }
  // the same 4 * kThreads * vecs elements, one a thread per turn
  const long long base = local * kThreads * vecs * 4 + threadIdx.x;
  for (int k = 0; k < 4 * vecs; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    if (i >= t.n) break;
    float a = t.acc[i];
    const float p = step(a, t.grad[i], load_param(t, i), lr, beta);
    t.acc[i] = a;
    store_param(t, i, p);
  }
}

bool aligned(std::uintptr_t p, std::uintptr_t bytes) { return p % bytes == 0; }

}  // namespace

// ``desc``: ``count`` (<= 16) host descriptors of kDescWords int64 words,
// (param, acc, grad, n, bf16), every n in [1, 2**31) and no two tables'
// param or acc memory overlapping. bf16 != 0: param is __nv_bfloat16,
// else float; acc and grad are float. One launch on ``stream``; returns
// cudaGetLastError() (0 = launched).
extern "C" int cdae_adagrad_update_tables(const long long* desc, int count,
                                          float lr, float beta,
                                          void* stream) {
  if (count < 1 || count > kMaxTables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables tabs{};
  long long quads = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + kDescWords * i;
    Table& t = tabs.t[i];
    t.param = reinterpret_cast<void*>(d[0]);
    t.acc = reinterpret_cast<float*>(d[1]);
    t.grad = reinterpret_cast<const float*>(d[2]);
    t.n = d[3];
    const bool bf16 = d[4] != 0;
    if (t.n < 1 || t.n >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool vec =
        aligned(reinterpret_cast<std::uintptr_t>(t.param), bf16 ? 8 : 16) &&
        aligned(reinterpret_cast<std::uintptr_t>(t.acc), 16) &&
        aligned(reinterpret_cast<std::uintptr_t>(t.grad), 16);
    t.flags = (bf16 ? kBf16 : 0) | (vec ? kVector : 0);
    quads += (t.n + 3) / 4;
  }
  // more quads a thread only while the grid keeps about 8 blocks an SM
  long long vecs = quads / (kThreads * kWideGrid);
  vecs = vecs < 1 ? 1 : (vecs > kMaxVecs ? kMaxVecs : vecs);
  long long blocks = 0;
  const long long per_block = static_cast<long long>(kThreads) * vecs;
  for (int i = 0; i < kMaxTables; ++i) {
    tabs.first_block[i] = i < count ? static_cast<int>(blocks) : INT_MAX;
    if (i < count) {
      blocks += ((tabs.t[i].n + 3) / 4 + per_block - 1) / per_block;
    }
  }
  tabs.vecs = static_cast<int>(vecs);
  tabs.lr = lr;
  tabs.beta = beta;
  adagrad_tables_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(tabs);
  return static_cast<int>(cudaGetLastError());
}
