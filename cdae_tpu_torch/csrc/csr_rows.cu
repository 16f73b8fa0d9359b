// A request's padded rated rows, built from a device-resident user CSR:
// items[b, c] = indices[indptr[u] + c] and mask[b, c] = 1 for c < len(u),
// items[b, c] = pad and mask[b, c] = 0 past it, for u = uids[b].
//
// Replaces no TPU kernel: cdae_tpu builds these rows on the host with numpy
// (cdae_tpu/data/dataset.py rows_from_csr) and copies them to the device.
// Serving calls it once a request, so the port keeps the CSR on the card
// (uploaded once) and builds the rows there instead of copying B*L*5 bytes
// from pageable host memory every request.
//
// What bounds it on an H100: nothing is computed; it reads each row's CSR
// slice once and writes B*L*5 bytes. At a serving request of 1,024 users and
// L = 1,268 that is 6.5 MB written, about 2 us at the published 3.35 TB/s of
// an NVIDIA H100 80GB HBM3 at 700 W, so the launch sets its time.
//
// Design: one block a row. The block's threads walk the row's L columns in
// strides of the block, so a warp reads 32 consecutive CSR entries and
// writes 32 consecutive items and mask bytes. The row's start and length
// are read once by every thread (one broadcast load). A pure copy: the
// rows are those of rows_from_csr, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
csr_rows_kernel(const long long* __restrict__ indptr,
                const int* __restrict__ indices,
                const long long* __restrict__ uids, int* __restrict__ items,
                bool* __restrict__ mask, int L, int pad) {
  const long long u = __ldg(uids + blockIdx.x);
  const long long start = __ldg(indptr + u);
  const long long len = __ldg(indptr + u + 1) - start;
  const size_t row = static_cast<size_t>(blockIdx.x) * L;
  for (int c = threadIdx.x; c < L; c += kThreads) {
    const bool in = c < len;
    items[row + c] = in ? __ldg(indices + start + c) : pad;
    mask[row + c] = in;
  }
}

}  // namespace

// indptr (U+1,) int64, indices (nnz,) int32, uids (B,) int64 in [0, U),
// items (B, L) int32, mask (B, L) bool; every row of the request no longer
// than L. Launches on ``stream`` and returns cudaGetLastError() (0 =
// launched).
extern "C" int cdae_csr_rows(const void* indptr, const int* indices,
                             const void* uids, int* items, bool* mask, int B,
                             int L, int pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  csr_rows_kernel<<<static_cast<unsigned>(B), kThreads, 0, s>>>(
      static_cast<const long long*>(indptr), indices,
      static_cast<const long long*>(uids), items, mask, L, pad);
  return static_cast<int>(cudaGetLastError());
}
