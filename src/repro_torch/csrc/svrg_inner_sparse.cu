// RADiSA / SFK inner loop (paper Algorithm 3 steps 7-10) on padded-ELL
// sparse blocks: L variance-reduced SGD steps on one feature sub-block
// window, for all cells of a P x Q grid in one launch.
//
// Replaces the TPU kernel src/repro/kernels/svrg/sparse.py::
// svrg_inner_sparse_pallas (body `_kernel`).  There the grid was the step
// counter of one cell; the (1, k) ELL row of the FULL feature block was
// fetched by scalar-prefetch DMA and the window [lo, lo + m_sub) selected
// by masking rel = cols - lo.
// Here (the `block` route) the cell index is the CUDA grid, the step loop
// runs inside one thread block, and the window is selected the same way,
// per slot.
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
//
// Two routes, chosen by shape alone (kernels/svrg/sparse.py::
// svrg_sparse_route):
//   * `cluster` (svrg_inner_sparse_cluster_kernel, below) -- every window
//     whose slice of ceil(m_sub / 8) columns fits one CTA's registers and
//     shared memory; the main path's 48 400-column windows take it;
//   * `block` (svrg_inner_sparse_kernel, the design above) -- wider
//     windows, such as RADiSA's `avg` variant at news20 width (338 800).
//
// ---------------------------------------------------------------------------
// The cluster route: one thread-block cluster of kClusterSize CTAs per cell.
//
// Replaces the same TPU kernel.  What bounds the block route on this card
// is the dense pass: 24 B per window element per step through the one SM
// of a cell, 28 of 132 SMs busy (12.6 us a step at news20 width).  The
// cluster route cuts the window into kClusterSize contiguous slices, one
// per CTA (224 CTAs on the main path, two per SM, all resident at once),
// and keeps the slice on chip for the whole launch:
//   * the thread that owns a column of the slice holds w, w~ and mu of it
//     in registers (E columns a thread, a template parameter, in runs of
//     4 adjacent columns);
//   * shared memory holds d = w - w~, rounded as the block route rounds
//     it, for the gather of step 1, and the scatter scratch g;
//   * the dense pass reads g and writes d in shared memory -- 8 B a
//     column, 16-byte accesses -- and g is reset only at the slots the
//     step scattered to;
//   * w is written to w_out once, at the end; no global scratch.
// What bounds it then is the step chain itself: the per-step exchange of
// partial sums between the CTAs of a cluster and the block barriers.
// Per step j = idx[h]:
//   1. each CTA sums vals * d[rel] over the in-window slots of the row that
//      fall in its own slice, and reduces that over its block;
//   2. thread 0 sends the partial to slot [h & 1][rank] of every CTA of
//      the cluster with st.async, each store completing 4 bytes of the
//      transaction count of that CTA's mbarrier [h & 1] -- no cluster-wide
//      barrier in the step;
//   3. each CTA waits on its own mbarrier for the kClusterSize partials and
//      sums them in rank order, so z and gscale are bitwise the same in
//      every CTA;
//   4. gscale * vals is scattered into the CTA's own g slice with shared
//      atomics (zero slots and slots outside the slice skipped);
//   5. __syncthreads; the dense pass over the slice with the same
//      svrg_update expression and _rn intrinsics as the block route, so
//      each column is rounded as before; __syncthreads; g reset at the
//      row's slots.
// The double-buffered slots and mbarriers are safe to reuse: a CTA sends
// the partial of step h + 2 only after it has received every peer's
// partial of step h + 1, which each peer sends after it has read its
// slots of step h.  The next row's cols / vals are prefetched with
// cp.async as before.

#include <cooperative_groups.h>
#include <cstdint>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

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
    const int* __restrict__ cols,        // (P, Q, T, n_p, k), FULL block
    const float* __restrict__ vals,      // (P, Q, T, n_p, k)
    const float* __restrict__ y,         // (P, T, n_p)
    const float* __restrict__ mask,      // (P, T, n_p)
    const float* __restrict__ z_anchor,  // (P, T, n_p)
    const float* __restrict__ w_anchor,  // (P, Q, T, m_sub)
    const float* __restrict__ mu,        // (P, Q, T, m_sub)
    const int* __restrict__ idx,         // (P, Q, T, L)
    const int* __restrict__ lo,          // (P, T) window offsets, or null = 0
    float* w_out,                        // (P, Q, T, m_sub): the working w
    float* g_scratch,                    // (P, Q, T, m_sub), zeroed by the caller
    int Q, int Tn, int n_p, int k, int m_sub, int L,
    float lam, float eta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 2) [lam, eta] or null
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[2][rt::kMaxWarps + 4];

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const long long c = blockIdx.x;
  const long long row = rt::decode_cell(c, Q, Tn).row;

  if (cell_params != nullptr) {
    lam = cell_params[2 * c];
    eta = cell_params[2 * c + 1];
  }

  int* rc = reinterpret_cast<int*>(smem_raw);
  float* rv = reinterpret_cast<float*>(smem_raw + 2 * sizeof(int) * k);

  const int* cc = cols + c * n_p * k;
  const float* vc = vals + c * n_p * k;
  const float* yp = y + row * n_p;
  const float* mp = mask + row * n_p;
  const float* zp = z_anchor + row * n_p;
  const int* ip = idx + c * L;
  const float* wa = w_anchor + c * m_sub;
  const float* mus = mu + c * m_sub;
  float* w = w_out + c * m_sub;
  float* g = g_scratch + c * m_sub;
  const int off = lo != nullptr ? lo[row] : 0;
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


// ---------------------------------------------------------------------------
// cluster route
// ---------------------------------------------------------------------------

constexpr int kClusterSize = 8;        // CTAs per cell (portable)
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;

using rt::cl_mbar_wait;
using rt::peer_addr;
using rt::smem_addr;
using rt::st_async_peer;

template <int LOSS, int E>
__global__ void __launch_bounds__(kClusterThreads, E <= 24 ? 2 : 1)
svrg_inner_sparse_cluster_kernel(
    const int* __restrict__ cols,        // (P, Q, T, n_p, k), FULL block
    const float* __restrict__ vals,      // (P, Q, T, n_p, k)
    const float* __restrict__ y,         // (P, T, n_p)
    const float* __restrict__ mask,      // (P, T, n_p)
    const float* __restrict__ z_anchor,  // (P, T, n_p)
    const float* __restrict__ w_anchor,  // (P, Q, T, m_sub)
    const float* __restrict__ mu,        // (P, Q, T, m_sub)
    const int* __restrict__ idx,         // (P, Q, T, L)
    const int* __restrict__ lo,          // (P, T) window offsets, or null = 0
    float* __restrict__ w_out,           // (P, Q, T, m_sub)
    int Q, int Tn, int n_p, int k, int m_sub, int L, int slice,
    float lam, float eta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 2) [lam, eta] or null
  static_assert(E % 4 == 0, "a thread owns runs of 4 columns");
  extern __shared__ __align__(16) unsigned char smem_cl[];
  __shared__ float part[2][kClusterSize];       // partials of step h: [h & 1]
  __shared__ __align__(8) unsigned long long pbar[2];   // their mbarriers
  __shared__ float red[2][kClusterWarps + 4];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long c = blockIdx.x / kClusterSize;
  const long long row = rt::decode_cell(c, Q, Tn).row;

  if (cell_params != nullptr) {
    lam = cell_params[2 * c];
    eta = cell_params[2 * c + 1];
  }

  // slice padded to whole runs of 4; the padding columns are inert
  const int spad = (slice + 3) & ~3;
  float* d_s = reinterpret_cast<float*>(smem_cl);   // [spad] w - w~
  float* g_s = d_s + spad;                           // [spad] scatter
  int* rc = reinterpret_cast<int*>(g_s + spad);      // [2][k]
  float* rv = reinterpret_cast<float*>(rc + 2 * k);  // [2][k]

  const int* cc = cols + c * n_p * k;
  const float* vc = vals + c * n_p * k;
  const float* yp = y + row * n_p;
  const float* mp = mask + row * n_p;
  const float* zp = z_anchor + row * n_p;
  const int* ip = idx + c * L;
  const int s0 = rank * slice;                       // slice start in the window
  const int s_len = max(0, min(slice, m_sub - s0));
  const int off = (lo != nullptr ? lo[row] : 0) + s0;  // block column of slice[0]
  const float* wa = w_anchor + c * m_sub + s0;
  const float* mus = mu + c * m_sub + s0;

  // run r = tid + kClusterThreads * (i / 4) of the slice: columns 4 r ..
  // 4 r + 3 belong to this thread, as w_r[i .. i + 3]
  float w_r[E], wa_r[E], mu_r[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = 4 * (tid + kClusterThreads * (i / 4)) + (i % 4);
    wa_r[i] = e < s_len ? wa[e] : 0.f;
    mu_r[i] = e < s_len ? mus[e] : 0.f;
    w_r[i] = wa_r[i];
    if (e < spad) {
      d_s[e] = __fsub_rn(w_r[i], wa_r[i]);
      g_s[e] = 0.f;
    }
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&pbar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  int j_next = 0, j_next2 = 0;
  float cy = 0.f, cm = 0.f, cz = 0.f, ny = 0.f, nm = 0.f, nz = 0.f;
  if (L > 0) {
    const int j = ip[0];
    j_next = L > 1 ? ip[1] : 0;
    prefetch_ell_row(rc, rv, cc + static_cast<long long>(j) * k,
                     vc + static_cast<long long>(j) * k, k, tid,
                     kClusterThreads);
    if (tid == 0) { cy = yp[j]; cm = mp[j]; cz = zp[j]; }
  }
  __pipeline_commit();
  // every CTA of the cluster runs, its mbarriers are initialised and its
  // slice is filled before the first partial arrives from a peer
  cluster.sync();

  for (int h = 0; h < L; ++h) {
    const int* ccur = rc + (h & 1) * k;
    const float* vcur = rv + (h & 1) * k;
    if (h + 1 < L) {
      const int b = (h + 1) & 1;
      prefetch_ell_row(rc + b * k, rv + b * k,
                       cc + static_cast<long long>(j_next) * k,
                       vc + static_cast<long long>(j_next) * k, k, tid,
                       kClusterThreads);
      if (tid == 0) { ny = yp[j_next]; nm = mp[j_next]; nz = zp[j_next]; }
      j_next2 = h + 2 < L ? ip[h + 2] : 0;
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // everything but the newest copy has landed

    // 1. this slice's part of the correction
    float corr = 0.f;
    for (int s = tid; s < k; s += kClusterThreads) {
      const int rel = ccur[s] - off;
      if (rel >= 0 && rel < s_len) corr = fmaf(vcur[s], d_s[rel], corr);
    }
    corr = rt::warp_sum(corr);
    float* r = red[h & 1];
    if (lane == 0) r[warp] = corr;
    if (tid == 0) {
      r[kClusterWarps + 0] = cy;
      r[kClusterWarps + 1] = cm;
      r[kClusterWarps + 2] = cz;
    }
    __syncthreads();
    // 2. the partial into slot [h & 1][rank] of every CTA of the cluster,
    // each store completing 4 bytes on that CTA's mbarrier of the step
    const uint32_t bar = smem_addr(&pbar[h & 1]);
    if (tid == 0) {
      float ps = 0.f;
      for (int wi = 0; wi < kClusterWarps; ++wi) ps += r[wi];
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(4 * kClusterSize) : "memory");
      const uint32_t slot = smem_addr(&part[h & 1][rank]);
      for (int q = 0; q < kClusterSize; ++q)
        st_async_peer(peer_addr(slot, q), ps, peer_addr(bar, q));
    }
    // 3. wait for the kClusterSize partials; sum them in rank order
    cl_mbar_wait(bar, (h >> 1) & 1);
    corr = 0.f;
#pragma unroll
    for (int q = 0; q < kClusterSize; ++q) corr += part[h & 1][q];
    const float yj = r[kClusterWarps + 0];
    const float mj = r[kClusterWarps + 1];
    const float zj = r[kClusterWarps + 2];
    const float z = zj + corr;
    const float gscale =
        (rt::loss_grad<LOSS>(z, yj) - rt::loss_grad<LOSS>(zj, yj)) * mj;

    // 4. sparse part of the direction, scattered into this slice of g
    if (gscale != 0.f) {
      for (int s = tid; s < k; s += kClusterThreads) {
        const int rel = ccur[s] - off;
        const float v = vcur[s];
        if (rel >= 0 && rel < s_len && v != 0.f)
          atomicAdd(g_s + rel, gscale * v);
      }
    }
    __syncthreads();

    // 5. dense pass over the slice, rounded as the block route rounds it
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const int e = 4 * (tid + kClusterThreads * (i / 4));
      if (e < s_len) {
        const float4 g4 = *reinterpret_cast<const float4*>(g_s + e);
        float4 d4;
        w_r[i + 0] = svrg_update(w_r[i + 0], wa_r[i + 0], mu_r[i + 0], g4.x, lam, eta);
        w_r[i + 1] = svrg_update(w_r[i + 1], wa_r[i + 1], mu_r[i + 1], g4.y, lam, eta);
        w_r[i + 2] = svrg_update(w_r[i + 2], wa_r[i + 2], mu_r[i + 2], g4.z, lam, eta);
        w_r[i + 3] = svrg_update(w_r[i + 3], wa_r[i + 3], mu_r[i + 3], g4.w, lam, eta);
        d4.x = __fsub_rn(w_r[i + 0], wa_r[i + 0]);
        d4.y = __fsub_rn(w_r[i + 1], wa_r[i + 1]);
        d4.z = __fsub_rn(w_r[i + 2], wa_r[i + 2]);
        d4.w = __fsub_rn(w_r[i + 3], wa_r[i + 3]);
        *reinterpret_cast<float4*>(d_s + e) = d4;
      }
    }
    __syncthreads();  // d and g are read before g is reset
    if (gscale != 0.f) {
      for (int s = tid; s < k; s += kClusterThreads) {
        const int rel = ccur[s] - off;
        if (rel >= 0 && rel < s_len) g_s[rel] = 0.f;
      }
    }

    if (tid == 0) { cy = ny; cm = nm; cz = nz; }
    j_next = j_next2;
  }
  __pipeline_wait_prior(0);

  float* wo = w_out + c * m_sub + s0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = 4 * (tid + kClusterThreads * (i / 4)) + (i % 4);
    if (e < s_len) wo[e] = w_r[i];
  }
  cluster.sync();  // no CTA leaves while a peer may still address it
}

template <int LOSS, int E>
int cluster_launch_e(const int* cols, const float* vals, const float* y,
                     const float* mask, const float* z_anchor,
                     const float* w_anchor, const float* mu, const int* idx,
                     const int* lo, float* w_out, int P, int Q, int T,
                     int n_p, int k, int m_sub, int L, int slice, float lam,
                     float eta,
                     const float* cell_params, size_t smem,
                     cudaStream_t stream) {
  auto kern = svrg_inner_sparse_cluster_kernel<LOSS, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * Q * T * kClusterSize);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, cols, vals, y, mask, z_anchor,
                           w_anchor, mu, idx, lo, w_out, Q, T, n_p, k, m_sub,
                           L, slice, lam, eta, cell_params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the smallest E the kernel is compiled for that holds the slice
template <int LOSS>
int cluster_launch(const int* cols, const float* vals, const float* y,
                   const float* mask, const float* z_anchor,
                   const float* w_anchor, const float* mu, const int* idx,
                   const int* lo, float* w_out, int P, int Q, int T, int n_p,
                   int k, int m_sub, int L, int slice, float lam, float eta,
                   const float* cell_params, size_t smem,
                   cudaStream_t stream) {
#define RT_CLUSTER_E(EV)                                                      \
  if (slice <= kClusterThreads * (EV))                                        \
    return cluster_launch_e<LOSS, EV>(cols, vals, y, mask, z_anchor,          \
                                      w_anchor, mu, idx, lo, w_out, P, Q, T,  \
                                      n_p, k, m_sub, L, slice, lam, eta,      \
                                      cell_params, smem, stream);
  RT_CLUSTER_E(8)
  RT_CLUSTER_E(16)
  RT_CLUSTER_E(24)
  RT_CLUSTER_E(32)
  RT_CLUSTER_E(48)
  RT_CLUSTER_E(64)
#undef RT_CLUSTER_E
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The block route.  Launch on `stream`; allocates nothing, does not
// synchronise, returns cudaGetLastError().  `T` is the tenant axis's
// extent (cell c = (p*Q + q)*T + t; T = 1 without tenants); `lo` may be
// null (window starts at column 0); `g_scratch` must hold P*Q*T*m_sub
// zeros (it is left zeroed); `cell_params` may be null (the scalars apply
// to every cell) or point to (P*Q*T, 2) floats [lam, eta] per cell.
extern "C" int svrg_inner_sparse_launch(
    const int* cols, const float* vals, const float* y, const float* mask,
    const float* z_anchor, const float* w_anchor, const float* mu,
    const int* idx, const int* lo, float* w_out, float* g_scratch,
    int P, int Q, int T, int n_p, int k, int m_sub, int L,
    float lam, float eta, const float* cell_params,
    int loss, int threads, void* stream) {
  if (T < 1 || threads < 32 || threads > 32 * rt::kMaxWarps || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(k) * (sizeof(int) + sizeof(float));
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = loss == rt::kHinge ? svrg_inner_sparse_kernel<rt::kHinge>
                                 : svrg_inner_sparse_kernel<rt::kSquared>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<P * Q * T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, vals, y, mask, z_anchor, w_anchor, mu, idx, lo, w_out, g_scratch,
      Q, T, n_p, k, m_sub, L, lam, eta, cell_params);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route.  Launch on `stream`; allocates nothing, does not
// synchronise, returns cudaGetLastError().  Arguments as above, without
// g_scratch and threads.  The caller (kernels/svrg/sparse.py) owns the
// geometry: `cluster` CTAs of `threads` threads per cell -- refused unless
// they are the 8 and 256 compiled here --, `slice` window columns a CTA
// (at least ceil(m_sub / cluster), at most 256 * 64) and `smem` bytes of
// dynamic shared memory a CTA, which must hold the kernel's layout: two
// float vectors of the slice rounded up to a multiple of 4, then two ELL
// rows of k int ids and k float values.
extern "C" int svrg_inner_sparse_cluster_launch(
    const int* cols, const float* vals, const float* y, const float* mask,
    const float* z_anchor, const float* w_anchor, const float* mu,
    const int* idx, const int* lo, float* w_out,
    int P, int Q, int T, int n_p, int k, int m_sub, int L,
    float lam, float eta, const float* cell_params, int loss,
    int cluster, int threads, int slice, int smem, void* stream) {
  if (P < 1 || Q < 1 || T < 1 || m_sub < 0 || k < 0 || L < 0 ||
      cluster != kClusterSize || threads != kClusterThreads ||
      static_cast<long long>(slice) * kClusterSize < m_sub || smem < 0 ||
      static_cast<size_t>(smem) > rt::kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto nbytes = static_cast<size_t>(smem);
  if (loss == rt::kHinge)
    return cluster_launch<rt::kHinge>(cols, vals, y, mask, z_anchor, w_anchor,
                                      mu, idx, lo, w_out, P, Q, T, n_p, k,
                                      m_sub, L, slice, lam, eta, cell_params,
                                      nbytes, st);
  return cluster_launch<rt::kSquared>(cols, vals, y, mask, z_anchor, w_anchor,
                                      mu, idx, lo, w_out, P, Q, T, n_p, k,
                                      m_sub, L, slice, lam, eta, cell_params,
                                      nbytes, st);
}
