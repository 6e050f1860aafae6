// RADiSA / SFK inner loop (paper Algorithm 3 steps 7-10) on padded-ELL
// sparse blocks: L variance-reduced SGD steps on one feature sub-block
// window, for all cells of a P x Q grid in one launch.
//
// Replaces the TPU kernel src/repro/kernels/svrg/sparse.py::
// svrg_inner_sparse_pallas (body `_kernel`).  There the grid was the step
// counter of one cell; the (1, k) ELL row of the FULL feature block was
// fetched by scalar-prefetch DMA and the window [lo, lo + m_sub) selected
// by masking rel = cols - lo.
// Here the cell index is the CUDA grid, the step loop runs inside one
// thread block, and the window is selected the same way, per slot.
//
// Per step j = idx[h]:
//   1. corr = sum over in-window slots of vals * (w[rel] - w~[rel]);
//      z = z_anchor[j] + corr                 (block reduction)
//   2. gscale = (l'(z) - l'(z_anchor[j])) * mask[j]
//   3. g[rel] += gscale * vals at the in-window slots   (atomicAdd)
//   4. __syncthreads
//   5. for every window element e:
//        w[e] = w[e] - eta * (g[e] + mu[e] + lam * (w[e] - w~[e])),
//      g[e] = 0, in the same pass
//   6. __syncthreads
// Step 5 is written as exactly that expression, with round-to-nearest
// intrinsics so that no operation is fused: its rounding is the plain
// version's (`w - eta * (g_sparse + mu + lam * diff)`).
//
// What bounds it: the bytes it must move are the sampled rows' nonzeros
// plus the window vectors once -- tens of microseconds.  The operations
// are dominated by the dense pass of step 5, m_sub elements a step (the
// SVRG direction's mu + lam (w - w~) is dense), which is the algorithm
// as the reference states it; at news20 width (m_sub = 48 400 for the
// `block` variant, 338 800 for `avg`) that pass reads w, w~, mu, g and
// writes w, g in device memory (L2) every step, on P*Q of 132 SMs.
// It is bound by that per-step traffic and the step chain's latency.
//
// What the design does about it:
//   * w, w~, mu and the scatter scratch g live in device memory (the
//     output buffer, the inputs, a scratch the wrapper zeroes): the
//     window is up to 1.36 MB, over the 227 KB of shared memory, and one
//     code path serves both variants;
//   * the dense pass is spread over up to 1024 threads, with 16-byte
//     accesses when the window width is a multiple of 4, each element
//     owned by one thread, and it resets g as it goes, so g needs no
//     second pass;
//   * g is scattered with atomicAdd (a row may hold a column twice);
//     padding and out-of-window slots add nothing, and a step whose
//     gscale is 0 (the hinge loss on both sides of its kink) scatters
//     nothing;
//   * the next row's cols / vals are copied into shared memory with
//     cp.async while the current step runs; thread 0 loads the next
//     step's scalars early.
// A lazy (closed-form) update of the dense part would remove the per-step
// pass but changes rounding; it is left to later work.

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ void prefetch_ell_row(
    int* dc, float* dv, const int* sc, const float* sv, int k, int tid,
    int nthreads) {
  for (int s = tid; s < k; s += nthreads) {
    __pipeline_memcpy_async(dc + s, sc + s, sizeof(int));
    __pipeline_memcpy_async(dv + s, sv + s, sizeof(float));
  }
}

// w - eta * ((g + mu) + lam * (w - wa)), every operation rounded alone
__device__ __forceinline__ float svrg_update(float w, float wa, float mu,
                                             float g, float lam, float eta) {
  const float diff = __fsub_rn(w, wa);
  const float dir = __fadd_rn(__fadd_rn(g, mu), __fmul_rn(lam, diff));
  return __fsub_rn(w, __fmul_rn(eta, dir));
}

template <int LOSS>
__global__ void __launch_bounds__(1024) svrg_inner_sparse_kernel(
    const int* __restrict__ cols,        // (P, Q, n_p, k), FULL block
    const float* __restrict__ vals,      // (P, Q, n_p, k)
    const float* __restrict__ y,         // (P, n_p)
    const float* __restrict__ mask,      // (P, n_p)
    const float* __restrict__ z_anchor,  // (P, n_p)
    const float* __restrict__ w_anchor,  // (P, Q, m_sub)
    const float* __restrict__ mu,        // (P, Q, m_sub)
    const int* __restrict__ idx,         // (P, Q, L)
    const int* __restrict__ lo,          // (P,) window offsets, or null = 0
    float* w_out,                        // (P, Q, m_sub): the working w
    float* g_scratch,                    // (P, Q, m_sub), zeroed by the caller
    int Q, int n_p, int k, int m_sub, int L,
    float lam, float eta,
    const float* __restrict__ cell_params) {  // (P*Q, 2) [lam, eta] or null
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[2][rt::kMaxWarps + 4];

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const long long c = blockIdx.x;
  const long long p = c / Q;

  if (cell_params != nullptr) {
    lam = cell_params[2 * c];
    eta = cell_params[2 * c + 1];
  }

  int* rc = reinterpret_cast<int*>(smem_raw);
  float* rv = reinterpret_cast<float*>(smem_raw + 2 * sizeof(int) * k);

  const int* cc = cols + c * n_p * k;
  const float* vc = vals + c * n_p * k;
  const float* yp = y + p * n_p;
  const float* mp = mask + p * n_p;
  const float* zp = z_anchor + p * n_p;
  const int* ip = idx + c * L;
  const float* wa = w_anchor + c * m_sub;
  const float* mus = mu + c * m_sub;
  float* w = w_out + c * m_sub;
  float* g = g_scratch + c * m_sub;
  const int off = lo != nullptr ? lo[p] : 0;
  // 16-byte accesses in the dense pass when every cell's window is
  // 16-byte aligned
  const bool vec4 =
      (m_sub & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(w_anchor) | reinterpret_cast<uintptr_t>(mu) |
        reinterpret_cast<uintptr_t>(w_out) |
        reinterpret_cast<uintptr_t>(g_scratch)) & 15) == 0;

  for (int e = tid; e < m_sub; e += T) w[e] = wa[e];

  int j_next = 0, j_next2 = 0;
  float cy = 0.f, cm = 0.f, cz = 0.f, ny = 0.f, nm = 0.f, nz = 0.f;
  if (L > 0) {
    const int j = ip[0];
    j_next = L > 1 ? ip[1] : 0;
    prefetch_ell_row(rc, rv, cc + static_cast<long long>(j) * k,
                     vc + static_cast<long long>(j) * k, k, tid, T);
    if (tid == 0) { cy = yp[j]; cm = mp[j]; cz = zp[j]; }
  }
  __pipeline_commit();
  __syncthreads();  // w is filled before the first gather

  for (int h = 0; h < L; ++h) {
    const int* ccur = rc + (h & 1) * k;
    const float* vcur = rv + (h & 1) * k;
    if (h + 1 < L) {
      const int b = (h + 1) & 1;
      prefetch_ell_row(rc + b * k, rv + b * k,
                       cc + static_cast<long long>(j_next) * k,
                       vc + static_cast<long long>(j_next) * k, k, tid, T);
      if (tid == 0) { ny = yp[j_next]; nm = mp[j_next]; nz = zp[j_next]; }
      j_next2 = h + 2 < L ? ip[h + 2] : 0;
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // everything but the newest copy has landed

    // 1. correction from the in-window entries of the row
    float corr = 0.f;
    for (int s = tid; s < k; s += T) {
      const int rel = ccur[s] - off;
      if (rel >= 0 && rel < m_sub)
        corr = fmaf(vcur[s], w[rel] - wa[rel], corr);
    }
    corr = rt::warp_sum(corr);
    float* r = red[h & 1];
    if (lane == 0) r[warp] = corr;
    if (tid == 0) {
      r[rt::kMaxWarps + 0] = cy;
      r[rt::kMaxWarps + 1] = cm;
      r[rt::kMaxWarps + 2] = cz;
    }
    __syncthreads();
    corr = 0.f;
    for (int wi = 0; wi < nwarps; ++wi) corr += r[wi];
    const float yj = r[rt::kMaxWarps + 0];
    const float mj = r[rt::kMaxWarps + 1];
    const float zj = r[rt::kMaxWarps + 2];

    // 2.-3. sparse part of the direction, scattered into g
    const float z = zj + corr;
    const float gscale =
        (rt::loss_grad<LOSS>(z, yj) - rt::loss_grad<LOSS>(zj, yj)) * mj;
    if (gscale != 0.f) {
      for (int s = tid; s < k; s += T) {
        const int rel = ccur[s] - off;
        const float v = vcur[s];
        if (rel >= 0 && rel < m_sub && v != 0.f)
          atomicAdd(g + rel, gscale * v);
      }
    }
    __syncthreads();

    // 5. dense pass over the window; g is reset as it is consumed
    if (vec4) {
      float4* w4 = reinterpret_cast<float4*>(w);
      float4* g4 = reinterpret_cast<float4*>(g);
      const float4* wa4 = reinterpret_cast<const float4*>(wa);
      const float4* mu4 = reinterpret_cast<const float4*>(mus);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int e = tid; e < (m_sub >> 2); e += T) {
        float4 wv = w4[e];
        const float4 av = wa4[e], mv = mu4[e], gv = g4[e];
        wv.x = svrg_update(wv.x, av.x, mv.x, gv.x, lam, eta);
        wv.y = svrg_update(wv.y, av.y, mv.y, gv.y, lam, eta);
        wv.z = svrg_update(wv.z, av.z, mv.z, gv.z, lam, eta);
        wv.w = svrg_update(wv.w, av.w, mv.w, gv.w, lam, eta);
        w4[e] = wv;
        g4[e] = zero;
      }
    } else {
      for (int e = tid; e < m_sub; e += T) {
        w[e] = svrg_update(w[e], wa[e], mus[e], g[e], lam, eta);
        g[e] = 0.f;
      }
    }

    if (tid == 0) { cy = ny; cm = nm; cz = nz; }
    j_next = j_next2;
    __syncthreads();  // the updated window lands before the next gather
  }
  __pipeline_wait_prior(0);
}

}  // namespace

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  `lo` may be null (window starts at column 0);
// `g_scratch` must hold P*Q*m_sub zeros (it is left zeroed);
// `cell_params` may be null (the scalars apply to every cell) or point
// to (P*Q, 2) floats [lam, eta] per cell.
extern "C" int svrg_inner_sparse_launch(
    const int* cols, const float* vals, const float* y, const float* mask,
    const float* z_anchor, const float* w_anchor, const float* mu,
    const int* idx, const int* lo, float* w_out, float* g_scratch,
    int P, int Q, int n_p, int k, int m_sub, int L,
    float lam, float eta, const float* cell_params,
    int loss, int threads, void* stream) {
  if (threads < 32 || threads > 32 * rt::kMaxWarps || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(k) * (sizeof(int) + sizeof(float));
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = loss == rt::kHinge ? svrg_inner_sparse_kernel<rt::kHinge>
                                 : svrg_inner_sparse_kernel<rt::kSquared>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<P * Q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, vals, y, mask, z_anchor, w_anchor, mu, idx, lo, w_out, g_scratch,
      Q, n_p, k, m_sub, L, lam, eta, cell_params);
  return static_cast<int>(cudaGetLastError());
}
