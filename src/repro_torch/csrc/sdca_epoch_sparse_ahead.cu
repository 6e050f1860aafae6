// Local SDCA epoch (paper Algorithm 2) on padded-ELL sparse blocks, for all
// cells of a P x Q grid (and T tenants) in one launch -- the `lookahead`
// route of kernels/sdca/sparse.py::sdca_epoch_sparse.
//
// Replaces the TPU kernel src/repro/kernels/sdca/sparse.py::
// sdca_epoch_sparse_pallas on every shape whose ELL rows are a whole number
// of 16-byte words (k a multiple of 4; the partitioner pads k to a
// multiple of 8) and whose order, dual deltas, ring of rows and row records
// fit a CTA's shared memory (kernels/sdca/sparse.py::sdca_sparse_route):
// the main path's news20 cells (2857 x 168 ELL slots, m_q = 338 800, 2857
// steps, at T = 1 and in the T = 2 sparse fleet).  It computes what the
// `block` route (sdca_epoch_sparse.cu) computes -- hinge / squared loss,
// the exact denominator ||x_i||^2 or the runtime beta, the row mask, the
// 1e-12 clamps, per-cell scalars, a tenant axis, padding slots (col 0,
// val 0) inert, a column twice in a row summed, a repeated index reading
// its own updated dual -- but forms each step's margin another way
// (below), so it agrees with the plain version to rounding, not bitwise.
//
// What bounds it on this card: the bytes are the sampled rows' nonzeros,
// w0 once and the outputs once (0.027 ms at the main shape).  The time is
// the chain of `steps` dependent steps.  w cannot move on chip: a cell's
// w is 1.36 MB, and the 28 cells need 38 MB against the card's 30 MB of
// shared memory in all, so it stays in device memory (each cell's slice
// of the w_out output).  The block route runs, every step and across its
// whole block: wait for the row (prefetched one step ahead from 107.5 MB
// of ELL data), gather w[cols] (an L2 or device-memory round trip),
// reduce, barrier, the dual step, scatter by atomicAdd, barrier.
//
// What the design does about it -- one warp a CTA runs the chain, the rest
// of the CTA prepares the rows it will need, and nothing on the chain
// waits for a block barrier or for device memory:
//   * a cluster of G = 4 CTAs a cell (measured faster than one CTA a
//     cell, PERF.md) shares the columns: column c belongs to CTA o_r(c) and to lane o_l(c) of its
//     stepper warp (two fields of a multiplicative hash of c), which alone
//     gathers w[c] and scatters into it.  So program order orders every
//     gather of a column against every scatter into it (the gathers are
//     relaxed gpu-scope loads, morally strong like the atomicAdd of the
//     scatter: a weak load may pass the thread's own atomic to the same
//     address), and a CTA issues 1/G of a step's scattered requests;
//   * the gather runs D = 2 steps ahead (measured faster than 1 or 4,
//     PERF.md): step h scatters, then issues the loads of row
//     g = h + D, which therefore see every scatter up to step g - D.  At
//     step g, with c_j = d_j / (lam n),
//         z = S + sum_{j = g-D+1}^{g-1} c_j (x_g . x_j),
//     D - 1 FMAs on sums prepared ahead.  A row's loads are consumed C =
//     D - 1 steps before its dual step, and each CTA's share of
//     S and of the overlaps goes to every CTA of the cluster by st.async
//     on the row's `xbar` mbarrier (csrc/cluster.cuh), summed in rank
//     order, so every CTA takes bitwise the same dual step;
//   * six helper warps take the rows in turn as they land: each builds a
//     row's record -- this CTA's columns of the row as each owner lane's
//     (column, value) pairs (a list of up to 6, the rest in an overflow
//     list; padding and zero values left out), ||x||^2, the
//     label, mask and alpha0, and this CTA's share of the overlaps x_g .
//     x_j with the D - 1 rows before (owner by owner over the lists, so
//     unsorted rows, a column twice in a row and a row repeated within D
//     steps need nothing special).  The lists are published on the row's
//     `built` mbarrier, the record on `ready`; the overlaps wait only for
//     the lists of the rows before, so no helper waits on another's
//     overlaps.  A helper takes row r only once row r - 16, the slot's
//     last, has been stepped (`done`), and then waits for the row itself
//     (`full`): `done` is arrived in step order, so its wait cannot
//     mistake an older phase for the awaited one, while a wait on `full`
//     alone could -- bulk copies complete out of order, and a parity wait
//     on a slot whose previous row has not landed yet returns at once.
//     The wait on `done` polls (test_wait) with a 200 ns sleep: as a
//     suspending try_wait, like the others, it made the whole epoch 9 %
//     slower on the card (PERF.md; why is not measured);
//   * a producer lane streams the ELL rows (k column ids, k values)
//     through a ring of 16 slots, two bulk copies (TMA) a row plus three
//     16-byte copies for the row's label, mask and alpha0, all completing
//     the slot's `full` mbarrier; the stepper frees a slot (and its
//     record) on its `done` mbarrier after the row's step;
//   * the order and the dual deltas live in shared memory (the stepper's
//     lane 0 writes a step's new dual, so a repeated index reads its own
//     update); rank 0 writes dalpha once, at the end.  A CTA holds short
//     lists and two CTAs share an SM, so the T = 2 fleet's 224 CTAs run
//     in one wave.
// The scatter stays an atomicAdd into the cell's slice of w_out.  The dual
// step divides once, by __fdividef, with 1 / Q and 1 / (lam n) taken once,
// as the dense cluster route does.  Offsets are 64-bit.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRing = 16;     // ELL rows in flight, and their records
constexpr int kDepth = 2;     // D: the gather runs D steps ahead
constexpr int kCluster = 4;   // G: CTAs a cell
// warps: 0 the stepper, 4 the producer (both on the SM's first scheduler,
// the producer mostly asleep in its waits), the other six build records
constexpr int kThreads = 256;
constexpr int kProducer = 4;
constexpr int kHelpers = 6;
// an owner lane's (column, value) pairs of a row in its list (a row of
// 168 slots leaves a lane of one CTA of four about 1.3 on average)
constexpr int kCap = 6;
static_assert(kDepth >= 2 && kDepth - 1 <= 3, "a record holds 1..3 overlaps");
static_assert(kRing > 2 * kDepth, "the ring holds the rows in flight");

// the owner of column c: CTA rank (of G) and lane, from a multiplicative
// hash of c
__device__ __forceinline__ int owner_lane(int col) {
  return static_cast<int>((static_cast<uint32_t>(col) * 2654435761u) >> 27);
}
__device__ __forceinline__ int owner_rank(int col) {
  return static_cast<int>(((static_cast<uint32_t>(col) * 2654435761u) >> 25) &
                          (kCluster - 1));
}

// a gpu-scope relaxed load: ordered after this thread's earlier atomics to
// the same address
__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// a row's record, in shared memory beside its ring slot: this CTA's
// columns of the row
struct Record {
  int* cnt;    // [32] each owner lane's pairs (may pass the list's cap)
  float* sc;   // [8]: overflow count (int), ||x||^2, y, mask, alpha0,
               // O_1 .. O_{D-1}
  int* ec;     // [cap][32] the owners' columns (entry e of lane l at e*32+l)
  float* ev;   // [cap][32] and values
  int* oc;     // [k] overflow columns
  float* ov;   // [k] and values
};

template <int LOSS>
__global__ void __launch_bounds__(kThreads, 2) sdca_sparse_ahead_kernel(
    const int* __restrict__ cols,      // (P, Q, T, n_p, k)
    const float* __restrict__ vals,    // (P, Q, T, n_p, k)
    const float* __restrict__ y,       // (P, T, n_p)
    const float* __restrict__ mask,    // (P, T, n_p)
    const float* __restrict__ alpha0,  // (P, T, n_p)
    const float* __restrict__ w0,      // (Q, T, m_q)
    const int* __restrict__ idx,       // (P, T, steps)
    float* __restrict__ dalpha,        // (P, Q, T, n_p)
    float* w_out,                      // (P, Q, T, m_q): the working w
    int Q, int Tn, int n_p, int k, int m_q, int steps,
    float lam, float n, float Qf, float beta, int use_beta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 3) [lam, n, beta] or null
  constexpr int D = kDepth, G = kCluster;
  // the consumer of a gather runs C steps ahead of the row's dual step, so
  // that the exchange of the partial sums between the cluster's CTAs has
  // C steps to land; the loads have D - 1 - C steps
  constexpr int C = D - 1;
  extern __shared__ __align__(16) unsigned char sm[];
  const int slot_bytes = 8 * k + 48;   // k ids, k values, 3 scalar chunks
  const int k8 = (k + 7) & ~7;
  const int rec_bytes = 4 * 32 + 4 * 8 + 8 * 32 * kCap + 8 * k8;
  int* idx_s = reinterpret_cast<int*>(sm);                        // [steps]
  float* dal_s = reinterpret_cast<float*>(idx_s + ((steps + 3) & ~3));  // [n_p]
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      dal_s + ((n_p + 3) & ~3));                                  // [kRing]
  unsigned char* recs = ring + kRing * slot_bytes;                // [kRing]
  __shared__ __align__(8) unsigned long long full[kRing];   // row landed
  __shared__ __align__(8) unsigned long long built[kRing];  // lists built
  __shared__ __align__(8) unsigned long long ready[kRing];  // record built
  __shared__ __align__(8) unsigned long long done[kRing];   // row stepped
  __shared__ __align__(8) unsigned long long xbar[kRing];   // sums arrived
  // a row's partial sums from every CTA of the cluster, by rank: this CTA's
  // columns' share of S = x . w and of the D - 1 overlaps
  __shared__ __align__(16) float xbuf[kRing][G][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long c = blockIdx.x / G;
  const rt::Cell cell = rt::decode_cell(c, Q, Tn);

  if (cell_params != nullptr) {
    lam = cell_params[3 * c];
    n = cell_params[3 * c + 1];
    beta = cell_params[3 * c + 2];
  }
  const int* cc = cols + c * n_p * k;
  const float* vc = vals + c * n_p * k;
  const float* yp = y + cell.row * n_p;
  const float* mp = mask + cell.row * n_p;
  const float* ap = alpha0 + cell.row * n_p;
  const int* ip = idx + cell.row * steps;
  float* w = w_out + c * m_q;

  auto record = [&](int r) {
    unsigned char* t = recs + (r % kRing) * rec_bytes;
    Record rc;
    rc.cnt = reinterpret_cast<int*>(t);
    rc.sc = reinterpret_cast<float*>(t + 4 * 32);
    rc.ec = reinterpret_cast<int*>(t + 4 * 32 + 4 * 8);
    rc.ev = reinterpret_cast<float*>(rc.ec + 32 * kCap);
    rc.oc = reinterpret_cast<int*>(rc.ev + 32 * kCap);
    rc.ov = reinterpret_cast<float*>(rc.oc + k8);
    return rc;
  };
  auto wait = [](unsigned long long* bars, int r) {
    rt::mbar_wait(rt::smem_addr(&bars[r % kRing]), (r / kRing) & 1);
  };
  // every (column, value) of record rc that owner lane l holds: fn(c, v)
  auto for_owner = [](const Record& rc, int l, auto&& fn) {
    const int cnt = rc.cnt[l];
    const int m = min(cnt, kCap);
    for (int e = 0; e < m; ++e) fn(rc.ec[e * 32 + l], rc.ev[e * 32 + l]);
    if (cnt > kCap) {
      const int no = __float_as_int(rc.sc[0]);
      for (int e = 0; e < no; ++e)
        if (owner_lane(rc.oc[e]) == l) fn(rc.oc[e], rc.ov[e]);
    }
  };

  const float* w0q = w0 + cell.col * m_q;
  for (int e = rank * kThreads + tid; e < m_q; e += G * kThreads)
    w[e] = w0q[e];
  for (int h = tid; h < steps; h += kThreads) idx_s[h] = ip[h];
  for (int i = tid; i < n_p; i += kThreads) dal_s[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      rt::cl_mbar_init(rt::smem_addr(&full[s]));
      rt::cl_mbar_init(rt::smem_addr(&built[s]));
      rt::cl_mbar_init(rt::smem_addr(&ready[s]));
      rt::cl_mbar_init(rt::smem_addr(&done[s]));
      rt::cl_mbar_init(rt::smem_addr(&xbar[s]));
    }
    rt::cl_mbar_fence_init();
  }
  // w filled (by every CTA of the cluster), the order in shared memory,
  // the mbarriers ready before a peer may address them
  cg::this_cluster().sync();

  if (warp == kProducer) {
    // ---- the producer: row q into slot q mod kRing once row q - kRing
    // has been stepped
    if (lane == 0) {
      auto chunk_of = [](const float* p) {
        return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                             ~static_cast<uintptr_t>(15));
      };
      const uint32_t row_bytes = 4u * static_cast<uint32_t>(k);
      for (int q = 0; q < steps; ++q) {
        if (q >= kRing) wait(done, q - kRing);
        const int i = idx_s[q];
        unsigned char* s = ring + (q % kRing) * slot_bytes;
        const uint32_t bar = rt::smem_addr(&full[q % kRing]);
        rt::cl_mbar_expect(bar, 2u * row_bytes + 48u);
        rt::bulk_copy(rt::smem_addr(s), cc + static_cast<long long>(i) * k,
                      row_bytes, bar);
        rt::bulk_copy(rt::smem_addr(s + row_bytes),
                      vc + static_cast<long long>(i) * k, row_bytes, bar);
        rt::bulk_copy(rt::smem_addr(s + 2 * row_bytes), chunk_of(yp + i), 16u,
                      bar);
        rt::bulk_copy(rt::smem_addr(s + 2 * row_bytes + 16), chunk_of(mp + i),
                      16u, bar);
        rt::bulk_copy(rt::smem_addr(s + 2 * row_bytes + 32), chunk_of(ap + i),
                      16u, bar);
      }
    }
  } else if (warp >= 1) {
    // ---- a helper: the records of rows hi, hi + kHelpers, ...
    const int hi = warp < kProducer ? warp - 1 : warp - 2;
    for (int r = hi; r < steps; r += kHelpers) {
      // the slot's last row stepped, then this row landed (see the
      // header); the first wait polls with a short sleep
      if (r >= kRing)
        rt::mbar_wait_sleep(rt::smem_addr(&done[r % kRing]),
                            ((r - kRing) / kRing) & 1, 200);
      wait(full, r);
      const Record rc = record(r);
      const unsigned char* slot = ring + (r % kRing) * slot_bytes;
      const int* rcol = reinterpret_cast<const int*>(slot);
      const float* rval = reinterpret_cast<const float*>(slot + 4 * k);
      rc.cnt[lane] = 0;
      if (lane == 0) rc.sc[0] = __int_as_float(0);
      __syncwarp();
      float sq = 0.f;  // over the whole row, alike in every CTA
      for (int s = lane; s < k; s += 32) {
        const float v = rval[s];
        if (v == 0.f) continue;  // padding: nothing to gather or add
        sq = fmaf(v, v, sq);
        const int col = rcol[s];
        if (owner_rank(col) != rank) continue;  // another CTA's column
        const int o = owner_lane(col);
        const int p = atomicAdd(rc.cnt + o, 1);
        if (p < kCap) {
          rc.ec[p * 32 + o] = col;
          rc.ev[p * 32 + o] = v;
        } else {
          const int q = atomicAdd(reinterpret_cast<int*>(rc.sc), 1);
          rc.oc[q] = col;
          rc.ov[q] = v;
        }
      }
      sq = rt::warp_sum(sq);
      __syncwarp();  // the lists are complete: other helpers may read them
      if (lane == 0) rt::mbar_arrive(rt::smem_addr(&built[r % kRing]));
      float ovl[D - 1];
#pragma unroll
      for (int j = 1; j < D; ++j) {
        // this CTA's share of x_r . x_{r-j}, owner by owner: this lane's
        // list of row r - j in registers, its pairs of row r against it
        float o = 0.f;
        if (r - j >= 0) {
          wait(built, r - j);  // its lists, not its overlaps: no chain
          const Record pr = record(r - j);
          const int pn = min(pr.cnt[lane], kCap);
          int pc[kCap];
          float pv[kCap];
#pragma unroll
          for (int e = 0; e < kCap; ++e) {
            pc[e] = e < pn ? pr.ec[e * 32 + lane] : -1;
            pv[e] = e < pn ? pr.ev[e * 32 + lane] : 0.f;
          }
          const bool pover = pr.cnt[lane] > kCap;
          for_owner(rc, lane, [&](int c1, float v1) {
#pragma unroll
            for (int e = 0; e < kCap; ++e)
              if (pc[e] == c1) o = fmaf(v1, pv[e], o);
            if (pover) {  // rare: row r - j's overflow pairs of this lane
              const int no = __float_as_int(pr.sc[0]);
              for (int e = 0; e < no; ++e)
                if (pr.oc[e] == c1) o = fmaf(v1, pr.ov[e], o);
            }
          });
        }
        ovl[j - 1] = rt::warp_sum(o);
      }
      if (lane == 0) {
        auto scalar = [&](int t, const float* base) {
          const float* chunk =
              reinterpret_cast<const float*>(slot + 8 * k + 16 * t);
          return chunk[(reinterpret_cast<uintptr_t>(base + idx_s[r]) & 15) >>
                       2];
        };
        rc.sc[1] = sq;
        rc.sc[2] = scalar(0, yp);
        rc.sc[3] = scalar(1, mp);
        rc.sc[4] = scalar(2, ap);
#pragma unroll
        for (int j = 1; j < D; ++j) rc.sc[4 + j] = ovl[j - 1];
      }
      __syncwarp();
      if (lane == 0) rt::mbar_arrive(rt::smem_addr(&ready[r % kRing]));
    }
  } else {
    // ---- the stepper
    const float lam_n = lam * n;
    const float inv_lam_n = 1.0f / lam_n;
    const float inv_q = 1.0f / Qf;
    const float half_inv_q = 1.0f / (2.0f * Qf);
    // gathers in flight, row g in stage g mod D: this lane's loads of w at
    // its columns of the row (consumed D - 1 - C steps after they are
    // issued; no register of a stage is copied meanwhile, which would wait
    // for the load), its count, and its overflow pairs' sum v w (gathered
    // at once)
    float gst[D][kCap];
    int nst[D];
    float xst[D];
    // c_{h-1}, ..., c_{h-D+1}: the last D - 1 scatters' coefficients (0
    // before step 0), alike in every lane and every CTA of the cluster
    float cs[D - 1];
#pragma unroll
    for (int j = 0; j < D - 1; ++j) cs[j] = 0.f;

    // step h: row h + C's partial sums out to the cluster (stage gc), the
    // dual step and scatter of step h, the loads of row h + D (stage g).
    // `full` (a constant at every call) marks a step in the steady state
    // (0 <= h and h + D < steps): inlined there, its range checks fold
    // away and its body is one block the compiler may schedule across;
    // the waits come first.
    auto step = [&](int h, bool full, float (&g)[kCap], int& ng, float& xg,
                    const float (&gc)[kCap], const int& nc, const float& xc) {
      const int rcn = h + C;
      const int r = h + D;
      const bool stepping = full || h >= 0;
      const bool loading = full || r < steps;
      // row h's sums from the cluster (sent C steps ago)
      if (stepping)
        rt::cl_mbar_wait(rt::smem_addr(&xbar[h % kRing]), (h / kRing) & 1);
      if (loading) wait(ready, r);
      if (full || (rcn >= 0 && rcn < steps)) {
        const Record rc = record(rcn);
        float part = xc;
#pragma unroll
        for (int e = 0; e < kCap; ++e)
          if (e < nc) part = fmaf(rc.ev[e * 32 + lane], gc[e], part);
        part = rt::warp_sum(part);
        const int xs = rcn % kRing;
        if (lane == 0) rt::cl_mbar_expect(rt::smem_addr(&xbar[xs]), 4 * G * D);
        if (lane < G) {
          const uint32_t pb = rt::peer_addr(rt::smem_addr(&xbar[xs]), lane);
          const uint32_t dst =
              rt::peer_addr(rt::smem_addr(&xbuf[xs][rank][0]), lane);
          rt::st_async_peer(dst, part, pb);
#pragma unroll
          for (int j = 1; j < D; ++j)
            rt::st_async_peer(dst + 4 * j, rc.sc[4 + j], pb);
        }
      }
      if (stepping) {
        const Record rc = record(h);
        const int i = idx_s[h];
        const int xs = h % kRing;
        float sums[D];
#pragma unroll
        for (int t = 0; t < D; ++t) {
          sums[t] = 0.f;
#pragma unroll
          for (int q = 0; q < G; ++q) sums[t] += xbuf[xs][q][t];
        }
        float z = sums[0];
#pragma unroll
        for (int j = 1; j < D; ++j) z = fmaf(cs[j - 1], sums[j], z);
        const float yq = rc.sc[2] * inv_q;
        const float mi = rc.sc[3];
        const float dal_i = dal_s[i];  // its own last write, if the row came before
        const float a_i = rc.sc[4] + dal_i;
        const float denom = fmaxf(use_beta ? beta : rc.sc[1], 1e-12f);
        float d;
        if (LOSS == rt::kHinge) {
          d = __fdividef((yq - z) * lam_n, denom);
          const float lo = yq > 0.f ? 0.f : -1.f;
          const float hi = yq > 0.f ? 1.f : 0.f;
          d = fminf(fmaxf(a_i + d, lo), hi) - a_i;
        } else {
          const float num = yq - a_i * half_inv_q - z;
          const float den = fmaf(denom, inv_lam_n, half_inv_q);
          d = __fdividef(num, fmaxf(den, 1e-12f));
        }
        d *= mi;  // padded rows never move
        const float coef = d * inv_lam_n;
        const int cnt = rc.cnt[lane];
#pragma unroll
        for (int e = 0; e < kCap; ++e)
          if (e < cnt && coef != 0.f)
            atomicAdd(w + rc.ec[e * 32 + lane], coef * rc.ev[e * 32 + lane]);
        if (cnt > kCap && coef != 0.f) {  // rare
          const int no = __float_as_int(rc.sc[0]);
          for (int e = 0; e < no; ++e)
            if (owner_lane(rc.oc[e]) == lane)
              atomicAdd(w + rc.oc[e], coef * rc.ov[e]);
        }
        if (lane == 0) dal_s[i] = dal_i + d;
        __syncwarp();  // the new dual, and every read of row h, are done
        if (lane == 0) rt::mbar_arrive(rt::smem_addr(&done[h % kRing]));
#pragma unroll
        for (int j = D - 2; j > 0; --j) cs[j] = cs[j - 1];
        cs[0] = coef;
      }
      // the loads of row h + D, after step h's scatter
      ng = 0;
      xg = 0.f;
      if (loading) {
        const Record rc = record(r);
        const int cnt = rc.cnt[lane];
        ng = min(cnt, kCap);
#pragma unroll
        for (int e = 0; e < kCap; ++e)
          if (e < ng) g[e] = ld_relaxed(w + rc.ec[e * 32 + lane]);
        if (cnt > kCap) {  // rare: gathered at once
          const int no = __float_as_int(rc.sc[0]);
          for (int e = 0; e < no; ++e)
            if (owner_lane(rc.oc[e]) == lane)
              xg = fmaf(rc.ov[e], ld_relaxed(w + rc.oc[e]), xg);
        }
      }
    };
    // h runs in groups of D from a multiple of D, so that each unrolled
    // copy of the step names its stages statically; groups wholly in the
    // steady state take the copy without range checks
    for (int h0 = -D; h0 < steps; h0 += D) {
      if (h0 >= 0 && h0 + 2 * D <= steps) {
#pragma unroll
        for (int u = 0; u < D; ++u)
          step(h0 + u, true, gst[u], nst[u], xst[u],
               gst[(u + C) % D], nst[(u + C) % D], xst[(u + C) % D]);
      } else {
#pragma unroll
        for (int u = 0; u < D; ++u)
          if (h0 + u < steps)
            step(h0 + u, false, gst[u], nst[u], xst[u],
                 gst[(u + C) % D], nst[(u + C) % D], xst[(u + C) % D]);
      }
    }
  }
  // the stepper's last dual is in shared memory; no CTA leaves while a
  // peer may still address it
  cg::this_cluster().sync();

  if (rank == 0) {
    float* dal = dalpha + c * n_p;
    for (int i = tid; i < n_p; i += kThreads) dal[i] = dal_s[i];
  }
}

template <int LOSS>
int launch_loss(const int* cols, const float* vals, const float* y,
                const float* mask, const float* alpha0, const float* w0,
                const int* idx, float* dalpha, float* w_out, int P, int Q,
                int T, int n_p, int k, int m_q, int steps, float lam,
                float n, float q_scale, float beta, int use_beta,
                const float* cell_params, size_t smem, cudaStream_t stream) {
  const size_t k8 = (static_cast<size_t>(k) + 7) & ~static_cast<size_t>(7);
  const size_t need =
      4 * (((static_cast<size_t>(steps) + 3) & ~static_cast<size_t>(3)) +
           ((static_cast<size_t>(n_p) + 3) & ~static_cast<size_t>(3))) +
      static_cast<size_t>(kRing) *
          (8 * static_cast<size_t>(k) + 48 + 160 + 8 * 32 * kCap + 8 * k8);
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = sdca_sparse_ahead_kernel<LOSS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * Q * T * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, cols, vals, y, mask, alpha0, w0, idx,
                           dalpha, w_out, Q, T, n_p, k, m_q, steps, lam, n,
                           q_scale, beta, use_beta, cell_params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lookahead route.  Launch on `stream`; allocates nothing, does not
// synchronise, returns cudaGetLastError().  Arguments as
// sdca_epoch_sparse_launch's (csrc/sdca_epoch_sparse.cu), but dalpha need
// not be zeroed, and cols and vals must start on 16-byte boundaries with
// k a multiple of 4 (every ELL row is then one bulk copy).  The caller
// (kernels/sdca/sparse.py) owns the geometry, which the launch refuses
// unless the kernel is compiled for it: `depth` (2) steps of lookahead,
// `cluster` (4) CTAs a cell, `threads` (a stepper warp, 6 helper warps and
// a producer warp) and `smem` bytes of dynamic shared memory, at least the
// kernel's layout: the steps indices and the n_p dual deltas (each rounded
// up to 4), then 16 slots of 8k + 48 bytes and 16 records of 160 + 8 * 32
// * 6 + 8 * ceil8(k) bytes.
extern "C" int sdca_epoch_sparse_ahead_launch(
    const int* cols, const float* vals, const float* y, const float* mask,
    const float* alpha0, const float* w0, const int* idx, float* dalpha,
    float* w_out, int P, int Q, int T, int n_p, int k, int m_q, int steps,
    float lam, float n, float q_scale, float beta, int use_beta,
    const float* cell_params, int loss, int depth, int cluster, int threads,
    int smem, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(cols) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  if (P < 1 || Q < 1 || T < 1 || n_p < 1 || m_q < 1 || steps < 0 || k < 4 ||
      k % 4 != 0 || !aligned || threads != kThreads || smem < 0 ||
      static_cast<size_t>(smem) > rt::kMaxDynamicSmem ||
      depth != kDepth || cluster != kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto nbytes = static_cast<size_t>(smem);
  if (loss == rt::kHinge)
    return launch_loss<rt::kHinge>(cols, vals, y, mask, alpha0, w0, idx,
                                   dalpha, w_out, P, Q, T, n_p, k, m_q, steps,
                                   lam, n, q_scale, beta, use_beta,
                                   cell_params, nbytes, st);
  return launch_loss<rt::kSquared>(cols, vals, y, mask, alpha0, w0, idx,
                                   dalpha, w_out, P, Q, T, n_p, k, m_q, steps,
                                   lam, n, q_scale, beta, use_beta,
                                   cell_params, nbytes, st);
}
