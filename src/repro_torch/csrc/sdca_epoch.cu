// Local SDCA epoch (paper Algorithm 2) for all cells of a P x Q grid in
// one launch.
//
// Replaces the TPU kernel src/repro/kernels/sdca/sdca.py::sdca_epoch_pallas
// (body `_kernel`).  There the grid was the step counter of ONE cell, run
// in order on one core, with w and the dual deltas in VMEM scratch and the
// next row fetched by scalar-prefetch DMA.  Here blocks run in parallel
// and in no order, so the cell index is the CUDA grid (blockIdx.x ->
// (p, q, tenant)) and the sequential step loop runs inside one thread block.
//
// What bounds it: the bytes it must move are one pass over the sampled
// rows, which the card streams in a fraction of a millisecond; the time
// goes to the chain of `steps` dependent updates -- each step needs a
// block-wide reduction before the next may start -- on only P*Q of the
// card's 132 SMs.  It is latency-bound, not bandwidth- or FLOP-bound.
//
// What the design does about it:
//   * w lives in shared memory for the whole epoch; thread t owns
//     elements t, t + T, ... of w and of the row buffers, so neither w
//     nor a row needs a barrier -- one __syncthreads per step (for the
//     reduction scratch, which is double-buffered) is all there is;
//   * the coordinate order is known for the whole epoch, so row
//     idx[h+1] is copied into the second row buffer with cp.async while
//     step h reduces, and thread 0 loads the next step's scalars early;
//   * dalpha accumulates in the pre-zeroed global output; only thread 0
//     of the one block that owns the row touches it, in program order,
//     which keeps the read-after-write on a repeated index exact.
// Offsets are 64-bit: a weak-scaling grid exceeds 2^31 elements.
//
// This is the `block` route of kernels/sdca/ops.py::sdca_epoch.  The main
// path no longer takes it: the `cluster` route (sdca_epoch_cluster.cu)
// takes every shape whose slice of w fits the registers of a CTA (rows up
// to 65 536 columns) and whose dual deltas, order and ring of rows fit its
// shared memory; this kernel keeps the rest -- wider rows, or more rows
// and steps than a CTA's shared memory holds (n_p + steps above 32 896
// at 3003 columns).

#include "common.cuh"

namespace {

template <int LOSS>
__global__ void sdca_epoch_kernel(
    const float* __restrict__ x,       // (P, Q, T, n_p, m_q)
    const float* __restrict__ y,       // (P, T, n_p)
    const float* __restrict__ mask,    // (P, T, n_p)
    const float* __restrict__ alpha0,  // (P, T, n_p)
    const float* __restrict__ w0,      // (Q, T, m_q)
    const int* __restrict__ idx,       // (P, T, steps)
    float* dalpha,                     // (P, Q, T, n_p), zeroed by the caller
    float* __restrict__ w_out,         // (P, Q, T, m_q)
    int Q, int Tn, int n_p, int m_q, int steps,
    float lam, float n, float Qf, float beta, int use_beta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 3) [lam, n, beta] or null
  extern __shared__ float smem[];
  __shared__ float red[2][2 * rt::kMaxWarps + 4];

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const long long c = blockIdx.x;
  const rt::Cell cell = rt::decode_cell(c, Q, Tn);

  if (cell_params != nullptr) {
    lam = cell_params[3 * c];
    n = cell_params[3 * c + 1];
    beta = cell_params[3 * c + 2];
  }
  const float lam_n = lam * n;

  float* w = smem;
  float* rows = smem + m_q;  // two row buffers of m_q floats each

  const float* xc = x + c * n_p * m_q;
  const float* yp = y + cell.row * n_p;
  const float* mp = mask + cell.row * n_p;
  const float* ap = alpha0 + cell.row * n_p;
  const int* ip = idx + cell.row * steps;
  float* dal = dalpha + c * n_p;

  for (int k = tid; k < m_q; k += T) w[k] = w0[cell.col * m_q + k];

  // i: this step's row, i_next: the next one (being prefetched),
  // i_next2: loaded one step early so the prefetch never waits on it.
  int i = 0, i_next = 0, i_next2 = 0;
  // scalars of this step and the next, held by thread 0 only
  float cy = 0.f, cm = 0.f, ca = 0.f, cd = 0.f;
  float ny = 0.f, nm = 0.f, na = 0.f, nd = 0.f;
  if (steps > 0) {
    i = ip[0];
    i_next = steps > 1 ? ip[1] : 0;
    rt::prefetch_row(rows, xc + static_cast<long long>(i) * m_q, m_q, tid, T);
    if (tid == 0) { cy = yp[i]; cm = mp[i]; ca = ap[i]; cd = dal[i]; }
  }
  __pipeline_commit();

  for (int h = 0; h < steps; ++h) {
    const float* cur = rows + (h & 1) * m_q;
    const bool has_next = h + 1 < steps;
    if (has_next) {
      rt::prefetch_row(rows + ((h + 1) & 1) * m_q,
                       xc + static_cast<long long>(i_next) * m_q, m_q, tid, T);
      if (tid == 0) {
        ny = yp[i_next]; nm = mp[i_next]; na = ap[i_next];
        nd = dal[i_next];  // stale only if i_next == i; repaired below
      }
      i_next2 = h + 2 < steps ? ip[h + 2] : 0;
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // everything but the newest copy has landed

    float dot = 0.f, sq = 0.f;
    for (int k = tid; k < m_q; k += T) {
      const float xv = cur[k];
      dot = fmaf(xv, w[k], dot);
      sq = fmaf(xv, xv, sq);
    }
    dot = rt::warp_sum(dot);
    sq = rt::warp_sum(sq);
    float* r = red[h & 1];
    if (lane == 0) { r[warp] = dot; r[rt::kMaxWarps + warp] = sq; }
    if (tid == 0) {
      r[2 * rt::kMaxWarps + 0] = cy;
      r[2 * rt::kMaxWarps + 1] = cm;
      r[2 * rt::kMaxWarps + 2] = ca + cd;
    }
    __syncthreads();
    dot = 0.f; sq = 0.f;
    for (int wi = 0; wi < nwarps; ++wi) {
      dot += r[wi];
      sq += r[rt::kMaxWarps + wi];
    }
    const float yi = r[2 * rt::kMaxWarps + 0];
    const float mi = r[2 * rt::kMaxWarps + 1];
    const float a_i = r[2 * rt::kMaxWarps + 2];

    const float denom = fmaxf(use_beta ? beta : sq, 1e-12f);
    float d;
    if (LOSS == rt::kHinge) {
      d = (yi / Qf - dot) * lam * n / denom;
      const float lo = yi > 0.f ? 0.f : -1.f;
      const float hi = yi > 0.f ? 1.f : 0.f;
      d = fminf(fmaxf(a_i + d, lo), hi) - a_i;
    } else {
      const float num = yi / Qf - a_i / (2.0f * Qf) - dot;
      const float den = 1.0f / (2.0f * Qf) + denom / lam_n;
      d = num / fmaxf(den, 1e-12f);
    }
    d *= mi;  // padded rows never move

    const float coef = d / lam_n;
    for (int k = tid; k < m_q; k += T) w[k] = fmaf(coef, cur[k], w[k]);

    if (tid == 0) {
      const float upd = cd + d;
      dal[i] = upd;
      if (has_next && i_next == i) nd = upd;
      cy = ny; cm = nm; ca = na; cd = nd;
    }
    i = i_next;
    i_next = i_next2;
  }
  __pipeline_wait_prior(0);

  for (int k = tid; k < m_q; k += T) w_out[c * m_q + k] = w[k];
}

}  // namespace

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  `Q` and `T` are the grid's and the tenant axis's
// extents (cell c = (p*Q + q)*T + t; T = 1 without tenants); `q_scale` is
// the number of feature partitions that scales the conjugate term (they
// differ when one cell of a larger grid is run alone).  `cell_params` may
// be null (the scalars apply to every cell) or point to (P*Q*T, 3) floats
// [lam, n, beta] per cell.
extern "C" int sdca_epoch_launch(
    const float* x, const float* y, const float* mask, const float* alpha0,
    const float* w0, const int* idx, float* dalpha, float* w_out,
    int P, int Q, int T, int n_p, int m_q, int steps,
    float lam, float n, float q_scale, float beta, int use_beta,
    const float* cell_params,
    int loss, int threads, void* stream) {
  if (T < 1 || threads < 32 || threads > 32 * rt::kMaxWarps || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(m_q) * sizeof(float);
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = loss == rt::kHinge ? sdca_epoch_kernel<rt::kHinge>
                                 : sdca_epoch_kernel<rt::kSquared>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<P * Q * T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, mask, alpha0, w0, idx, dalpha, w_out, Q, T, n_p, m_q, steps,
      lam, n, q_scale, beta, use_beta, cell_params);
  return static_cast<int>(cudaGetLastError());
}
