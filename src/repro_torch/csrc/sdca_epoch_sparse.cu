// Local SDCA epoch (paper Algorithm 2) on padded-ELL sparse blocks, for
// all cells of a P x Q grid in one launch.
//
// Replaces the TPU kernel src/repro/kernels/sdca/sparse.py::
// sdca_epoch_sparse_pallas (body `_kernel`).  There the grid was the step
// counter of ONE cell, run in order on one core, with w and the dual
// deltas in VMEM scratch and the (1, k) ELL row fetched by
// scalar-prefetch DMA.  Here the cell index is
// the CUDA grid (blockIdx.x -> (p, q)) and the sequential step loop runs
// inside one thread block; thread s owns ELL slots s, s + T, ... .
//
// What bounds it: the bytes it must move are the sampled rows' nonzeros,
// w0 once and w_final once -- a few tens of microseconds of the card's
// memory rate.  The time goes to the chain of `steps` dependent updates:
// each step gathers k entries of w from L2, reduces them over the block,
// and scatters k updates back before the next step may gather, on only
// P*Q of the card's 132 SMs.  It is latency-bound.
//
// What the design does about it:
//   * w cannot live in shared memory: at news20 width one block of w is
//     m_q = 338 800 floats (1.36 MB), far above the 227 KB a block may
//     use.  Each cell's working w is its slice of the w_final output in
//     device memory (w0 is copied in first); the P*Q slices (38 MB at
//     7 x 4) stay in the 50 MB L2, so gathers and atomics hit L2;
//   * the scatter is an atomicAdd: a LIBSVM row may hold a column twice
//     (the reference's scatter-add sums both, and so does this), and the
//     padding slots (col 0, val 0) are skipped rather than added;
//   * two __syncthreads a step: one for the block reduction (its
//     scratch is double-buffered), one between the scatter of step h and
//     the gather of step h+1 -- __syncthreads also orders the block's
//     device-memory writes;
//   * the coordinate order is known for the whole epoch, so the cols /
//     vals of row idx[h+1] are copied into a second shared buffer with
//     cp.async while step h runs, and thread 0 loads the next step's
//     scalars early;
//   * dalpha accumulates in the pre-zeroed global output; only thread 0
//     of the one block that owns the row touches it, in program order,
//     which keeps the read-after-write on a repeated index exact.
// The caller guarantees 0 <= idx < n_p and 0 <= cols < m_q.  Offsets are
// 64-bit.
//
// Two routes, chosen by shape alone (kernels/sdca/sparse.py::
// sdca_sparse_route):
//   * `lookahead` (sdca_epoch_sparse_ahead.cu) -- every block whose ELL
//     rows are a whole number of 16-byte words and whose order, dual
//     deltas, ring of rows and row tables fit a CTA's shared memory;
//     the main path's news20 cells take it: a cluster of 4 CTAs a cell
//     sharing its columns, one warp of each stepping the chain while the
//     others prepare the rows, the rows by bulk copies, the duals in
//     shared memory, and the gather D steps ahead of the dual step, the
//     scatters it missed added back through the rows' overlaps;
//   * `block` (this file, the design above) -- the rest (k not a multiple
//     of 4, or too many rows or steps for the shared memory).

#include "common.cuh"

namespace {

// Start the copy of one ELL row (k column ids and k values) into shared
// buffers; thread `tid` copies the slots it later reads itself.
__device__ __forceinline__ void prefetch_ell_row(
    int* dc, float* dv, const int* sc, const float* sv, int k, int tid,
    int nthreads) {
  for (int s = tid; s < k; s += nthreads) {
    __pipeline_memcpy_async(dc + s, sc + s, sizeof(int));
    __pipeline_memcpy_async(dv + s, sv + s, sizeof(float));
  }
}

template <int LOSS>
__global__ void sdca_epoch_sparse_kernel(
    const int* __restrict__ cols,      // (P, Q, T, n_p, k)
    const float* __restrict__ vals,    // (P, Q, T, n_p, k)
    const float* __restrict__ y,       // (P, T, n_p)
    const float* __restrict__ mask,    // (P, T, n_p)
    const float* __restrict__ alpha0,  // (P, T, n_p)
    const float* __restrict__ w0,      // (Q, T, m_q)
    const int* __restrict__ idx,       // (P, T, steps)
    float* dalpha,                     // (P, Q, T, n_p), zeroed by the caller
    float* w_out,                      // (P, Q, T, m_q): the working w
    int Q, int Tn, int n_p, int k, int m_q, int steps,
    float lam, float n, float Qf, float beta, int use_beta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 3) [lam, n, beta] or null
  extern __shared__ unsigned char smem_raw[];
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

  // two row buffers: column ids, then values
  int* rc = reinterpret_cast<int*>(smem_raw);
  float* rv = reinterpret_cast<float*>(smem_raw + 2 * sizeof(int) * k);

  const int* cc = cols + c * n_p * k;
  const float* vc = vals + c * n_p * k;
  const float* yp = y + cell.row * n_p;
  const float* mp = mask + cell.row * n_p;
  const float* ap = alpha0 + cell.row * n_p;
  const int* ip = idx + cell.row * steps;
  float* dal = dalpha + c * n_p;
  float* w = w_out + c * m_q;

  const float* w0q = w0 + cell.col * m_q;
  for (int e = tid; e < m_q; e += T) w[e] = w0q[e];

  int i = 0, i_next = 0, i_next2 = 0;
  float cy = 0.f, cm = 0.f, ca = 0.f, cd = 0.f;
  float ny = 0.f, nm = 0.f, na = 0.f, nd = 0.f;
  if (steps > 0) {
    i = ip[0];
    i_next = steps > 1 ? ip[1] : 0;
    prefetch_ell_row(rc, rv, cc + static_cast<long long>(i) * k,
                     vc + static_cast<long long>(i) * k, k, tid, T);
    if (tid == 0) { cy = yp[i]; cm = mp[i]; ca = ap[i]; cd = dal[i]; }
  }
  __pipeline_commit();
  __syncthreads();  // w is filled before the first gather

  for (int h = 0; h < steps; ++h) {
    const int* ccur = rc + (h & 1) * k;
    const float* vcur = rv + (h & 1) * k;
    const bool has_next = h + 1 < steps;
    if (has_next) {
      const int b = (h + 1) & 1;
      prefetch_ell_row(rc + b * k, rv + b * k,
                       cc + static_cast<long long>(i_next) * k,
                       vc + static_cast<long long>(i_next) * k, k, tid, T);
      if (tid == 0) {
        ny = yp[i_next]; nm = mp[i_next]; na = ap[i_next];
        nd = dal[i_next];  // stale only if i_next == i; repaired below
      }
      i_next2 = h + 2 < steps ? ip[h + 2] : 0;
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // everything but the newest copy has landed

    float dot = 0.f, sq = 0.f;
    for (int s = tid; s < k; s += T) {
      const float v = vcur[s];
      dot = fmaf(v, w[ccur[s]], dot);
      sq = fmaf(v, v, sq);
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
    if (coef != 0.f) {
      for (int s = tid; s < k; s += T) {
        const float v = vcur[s];
        if (v != 0.f) atomicAdd(w + ccur[s], coef * v);
      }
    }

    if (tid == 0) {
      const float upd = cd + d;
      dal[i] = upd;
      if (has_next && i_next == i) nd = upd;
      cy = ny; cm = nm; ca = na; cd = nd;
    }
    i = i_next;
    i_next = i_next2;
    __syncthreads();  // this step's scatter lands before the next gather
  }
  __pipeline_wait_prior(0);
}

}  // namespace

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  `Q` and `T` are the grid's and the tenant axis's
// extents (cell c = (p*Q + q)*T + t; T = 1 without tenants); `q_scale` is
// the number of feature partitions that scales the conjugate term.
// `cell_params` may be null (the scalars apply to every cell) or point to
// (P*Q*T, 3) floats [lam, n, beta] per cell.
extern "C" int sdca_epoch_sparse_launch(
    const int* cols, const float* vals, const float* y, const float* mask,
    const float* alpha0, const float* w0, const int* idx, float* dalpha,
    float* w_out, int P, int Q, int T, int n_p, int k, int m_q, int steps,
    float lam, float n, float q_scale, float beta, int use_beta,
    const float* cell_params,
    int loss, int threads, void* stream) {
  if (T < 1 || threads < 32 || threads > 32 * rt::kMaxWarps || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(k) * (sizeof(int) + sizeof(float));
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = loss == rt::kHinge ? sdca_epoch_sparse_kernel<rt::kHinge>
                                 : sdca_epoch_sparse_kernel<rt::kSquared>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<P * Q * T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, vals, y, mask, alpha0, w0, idx, dalpha, w_out, Q, T, n_p, k, m_q,
      steps, lam, n, q_scale, beta, use_beta, cell_params);
  return static_cast<int>(cudaGetLastError());
}
