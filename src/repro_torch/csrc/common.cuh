// Shared device helpers for the cell-local kernels.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int kMaxWarps = 32;
// Dynamic shared memory one block may ask for on sm_90 (227 KB) less
// the few hundred bytes of static scratch the kernels declare.
constexpr size_t kMaxDynamicSmem = 232448 - 2048;

constexpr int kHinge = 0;
constexpr int kSquared = 1;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Start the copy of columns [0, m) of one global row into a shared
// buffer.  Thread `tid` copies elements tid, tid + nthreads, ...: the
// same elements it later reads, so the copy needs no block barrier,
// only the issuing thread's own wait.  4-byte copies, because neither
// the row stride nor a sub-block window is 16-byte aligned in general
// (m_q = 3003, window offsets that are multiples of 429).
__device__ __forceinline__ void prefetch_row(float* dst, const float* src,
                                             int m, int tid, int nthreads) {
  for (int k = tid; k < m; k += nthreads)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(float));
}

// Where the cell of flat index c = (p*Q + q)*T + t of a launch over a
// P x Q grid with T tenants (T = 1: the grid alone) reads its operands:
// `row` = p*T + t indexes the (P, T, n_p) row vectors and the window
// offsets `lo`, `col` = q*T + t the primal blocks w0 (Q, T, m_q); every
// per-cell array (blocks, outputs, SVRG orders, `cell_params`) is
// indexed by c itself.
struct Cell {
  long long row, col;
};

__device__ __forceinline__ Cell decode_cell(long long c, int Q, int T) {
  const long long t = c % T, pq = c / T;
  return {(pq / Q) * T + t, (pq % Q) * T + t};
}

template <int LOSS>
__device__ __forceinline__ float loss_grad(float z, float y) {
  if (LOSS == kHinge) return (y * z < 1.0f) ? -y : 0.0f;
  return 2.0f * (z - y);
}

}  // namespace rt
