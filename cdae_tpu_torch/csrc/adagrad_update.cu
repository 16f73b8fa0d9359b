// One AdaGrad step in place: a += g*g; p -= lr*g / (beta + sqrt(a)).
//
// Replaces cdae_tpu/ops/pallas_kernels.py:adagrad_update (the Pallas kernel
// with donated buffers). In the port it is the dense step's sweep over W,
// b' and b (solver/optimizer.py dense_adagrad_step on CUDA).
//
// What bounds it on an H100: 3 reads and 2 writes per element and a few
// flops, so device memory bandwidth (an (I, D) = (20000, 200) f32 table is
// 16 MB per stream, 80 MB in all, about 24 us at 3.35 TB/s).
//
// Design: a grid-stride elementwise loop over the flat arrays, one element
// per thread per turn (coalesced). The accumulator and the arithmetic are
// f32; the parameter is f32 or bf16 (converted, updated in f32, rounded
// back). Every operation uses an _rn intrinsic, which nvcc never contracts
// into an FMA, so the result equals PyTorch's op-by-op plain version bit
// for bit. The library is built without --use_fast_math, so sqrt and the
// division are IEEE round-to-nearest too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename P>
__device__ __forceinline__ float load_param(const P* p, long long i);
template <>
__device__ __forceinline__ float load_param<float>(const float* p,
                                                   long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_param<__nv_bfloat16>(
    const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_param(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_param(__nv_bfloat16* p, long long i,
                                            float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
adagrad_kernel(P* __restrict__ param, float* __restrict__ acc,
               const float* __restrict__ grad, long long n, float lr,
               float beta) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float g = grad[i];
    const float a = __fadd_rn(acc[i], __fmul_rn(g, g));
    acc[i] = a;
    const float step =
        __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(beta, __fsqrt_rn(a)));
    store_param(param, i, __fsub_rn(load_param(param, i), step));
  }
}

}  // namespace

// ``bf16`` != 0: param is __nv_bfloat16, else float. Launches on ``stream``
// and returns cudaGetLastError() (0 = launched).
extern "C" int cdae_adagrad_update(void* param, float* acc, const float* grad,
                                   int n, float lr, float beta, int bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  const unsigned grid = static_cast<unsigned>(blocks);
  if (bf16) {
    adagrad_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(param), acc, grad, n, lr, beta);
  } else {
    adagrad_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(param), acc, grad, n, lr, beta);
  }
  return static_cast<int>(cudaGetLastError());
}
