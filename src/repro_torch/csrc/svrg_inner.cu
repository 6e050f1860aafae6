// RADiSA inner loop (paper Algorithm 3 steps 7-10): L variance-reduced
// SGD steps on one feature sub-block, for all cells of a P x Q grid in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/svrg/svrg.py::svrg_inner_pallas.
// There the grid was the step counter of one cell and the caller cut the
// (n_p, m_sub) column slice out of the block before every call.  Here the
// cell index is the CUDA grid, the step loop runs inside one thread
// block, and the kernel reads its window x[p, q, j, lo[p] : lo[p] + m_sub]
// straight out of the full block (row stride m_x), so no slice is ever
// materialised.
//
// What bounds it: like the SDCA epoch, the L dependent steps, each with a
// block-wide reduction, on P*Q of the card's 132 SMs; the bytes (the
// sampled rows' window columns) are a small fraction of the time.  With
// m_sub = 429 a step is a handful of FMAs per thread, so the per-step
// latency -- barrier, shuffles, scalar loads -- is the whole cost.
//
// What the design does about it: the iterate w, the anchor w~ and mu stay
// in shared memory for all L steps, each element owned by one thread
// (t, t + T, ...), which leaves one __syncthreads per step; row idx[h+1]
// is copied with cp.async while step h reduces, and thread 0 loads the
// next step's scalars early.  Nothing here is 16-byte aligned (m_x = 3003,
// lo a multiple of 429), hence the 4-byte copies; the ragged edge needs no
// mask because the window always lies inside the row.
//
// Two routes, chosen by shape alone (kernels/svrg/ops.py::svrg_route):
//   * `ring` (svrg_inner_ring.cu) -- every window that fits the registers
//     of one CTA (up to 2048 columns) and whose order and ring of rows fit
//     its shared memory; the main path's 429-column windows take it, on
//     one warp a cell, the rows by bulk copies 7 steps ahead;
//   * `block` (this file, the design above) -- the rest.

#include "common.cuh"

namespace {

template <int LOSS>
__global__ void svrg_inner_kernel(
    const float* __restrict__ x,         // (P, Q, T, n_p, m_x)
    const float* __restrict__ y,         // (P, T, n_p)
    const float* __restrict__ mask,      // (P, T, n_p)
    const float* __restrict__ z_anchor,  // (P, T, n_p)
    const float* __restrict__ w_anchor,  // (P, Q, T, m_sub)
    const float* __restrict__ mu,        // (P, Q, T, m_sub)
    const int* __restrict__ idx,         // (P, Q, T, L)
    const int* __restrict__ lo,          // (P, T) window offsets, or null = 0
    float* __restrict__ w_out,           // (P, Q, T, m_sub)
    int Q, int Tn, int n_p, int m_x, int m_sub, int L,
    float lam, float eta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 2) [lam, eta] or null
  extern __shared__ float smem[];
  __shared__ float red[2][rt::kMaxWarps + 4];

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const long long c = blockIdx.x;
  const long long row = rt::decode_cell(c, Q, Tn).row;

  if (cell_params != nullptr) {
    lam = cell_params[2 * c];
    eta = cell_params[2 * c + 1];
  }

  float* w = smem;
  float* wa = smem + m_sub;
  float* mus = smem + 2 * static_cast<size_t>(m_sub);
  float* rows = smem + 3 * static_cast<size_t>(m_sub);  // two row buffers

  const float* xc = x + c * n_p * m_x + (lo != nullptr ? lo[row] : 0);
  const float* yp = y + row * n_p;
  const float* mp = mask + row * n_p;
  const float* zp = z_anchor + row * n_p;
  const int* ip = idx + c * L;

  for (int k = tid; k < m_sub; k += T) {
    const float a = w_anchor[c * m_sub + k];
    w[k] = a;
    wa[k] = a;
    mus[k] = mu[c * m_sub + k];
  }

  int j_next = 0, j_next2 = 0;
  float cy = 0.f, cm = 0.f, cz = 0.f, ny = 0.f, nm = 0.f, nz = 0.f;
  if (L > 0) {
    const int j = ip[0];
    j_next = L > 1 ? ip[1] : 0;
    rt::prefetch_row(rows, xc + static_cast<long long>(j) * m_x, m_sub, tid, T);
    if (tid == 0) { cy = yp[j]; cm = mp[j]; cz = zp[j]; }
  }
  __pipeline_commit();

  for (int h = 0; h < L; ++h) {
    const float* cur = rows + (h & 1) * m_sub;
    if (h + 1 < L) {
      rt::prefetch_row(rows + ((h + 1) & 1) * m_sub,
                       xc + static_cast<long long>(j_next) * m_x, m_sub, tid, T);
      if (tid == 0) { ny = yp[j_next]; nm = mp[j_next]; nz = zp[j_next]; }
      j_next2 = h + 2 < L ? ip[h + 2] : 0;
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // everything but the newest copy has landed

    float dot = 0.f;
    for (int k = tid; k < m_sub; k += T) dot = fmaf(cur[k], w[k] - wa[k], dot);
    dot = rt::warp_sum(dot);
    float* r = red[h & 1];
    if (lane == 0) r[warp] = dot;
    if (tid == 0) {
      r[rt::kMaxWarps + 0] = cy;
      r[rt::kMaxWarps + 1] = cm;
      r[rt::kMaxWarps + 2] = cz;
    }
    __syncthreads();
    dot = 0.f;
    for (int wi = 0; wi < nwarps; ++wi) dot += r[wi];
    const float yj = r[rt::kMaxWarps + 0];
    const float mj = r[rt::kMaxWarps + 1];
    const float zj = r[rt::kMaxWarps + 2];

    const float z = zj + dot;
    const float gd = (rt::loss_grad<LOSS>(z, yj) - rt::loss_grad<LOSS>(zj, yj)) * mj;
    for (int k = tid; k < m_sub; k += T) {
      const float wk = w[k];
      const float g = gd * cur[k] + mus[k] + lam * (wk - wa[k]);
      w[k] = wk - eta * g;
    }

    if (tid == 0) { cy = ny; cm = nm; cz = nz; }
    j_next = j_next2;
  }
  __pipeline_wait_prior(0);

  for (int k = tid; k < m_sub; k += T) w_out[c * m_sub + k] = w[k];
}

}  // namespace

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  `T` is the tenant axis's extent (cell c =
// (p*Q + q)*T + t; T = 1 without tenants); `lo` may be null (window
// starts at column 0); `cell_params` may be null (the scalars apply to
// every cell) or point to (P*Q*T, 2) floats [lam, eta] per cell.
extern "C" int svrg_inner_launch(
    const float* x, const float* y, const float* mask, const float* z_anchor,
    const float* w_anchor, const float* mu, const int* idx, const int* lo,
    float* w_out, int P, int Q, int T, int n_p, int m_x, int m_sub, int L,
    float lam, float eta, const float* cell_params,
    int loss, int threads, void* stream) {
  if (T < 1 || threads < 32 || threads > 32 * rt::kMaxWarps || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 5 * static_cast<size_t>(m_sub) * sizeof(float);
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = loss == rt::kHinge ? svrg_inner_kernel<rt::kHinge>
                                 : svrg_inner_kernel<rt::kSquared>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<P * Q * T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, mask, z_anchor, w_anchor, mu, idx, lo, w_out, Q, T, n_p, m_x, m_sub, L,
      lam, eta, cell_params);
  return static_cast<int>(cudaGetLastError());
}
