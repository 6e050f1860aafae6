// Local SDCA epoch (paper Algorithm 2) for all cells of a P x Q grid in
// one launch: the `cluster` route of kernels/sdca/ops.py::sdca_epoch.
//
// Replaces the TPU kernel src/repro/kernels/sdca/sdca.py::sdca_epoch_pallas
// (body `_kernel`) on every shape whose row slice fits the registers of a
// CTA and whose dual deltas, order and ring of rows fit its shared memory
// (kernels/sdca/ops.py::sdca_route): the D3CA cells of the Part 1
// instance (2000 x 3003) and the serial-SDCA epochs for f* (one cell of
// 14 000 x 12 000).  It computes exactly what the `block` route
// (sdca_epoch.cu) computes: hinge / squared loss, the exact denominator
// ||x_i||^2 or the runtime beta, the row mask, the q_scale of the
// conjugate, the 1e-12 clamps, per-cell scalars from `cell_params`, a
// tenant axis (T problems of one shape, rt::decode_cell), and a repeated
// index reads its own updated dual.
//
// What bounds it on this card: the bytes are one pass over the sampled
// rows (0.13 ms at the D3CA shape, 0.20 ms -- 672 MB -- at the serial
// one), far below the time of the chain of `steps` dependent updates:
// each step reduces a dot product and a squared norm over the whole row
// before the next step may start.  So the latency of one step bounds it,
// and, at the serial shape, the rate at which one SM can pull its rows.
//
// What the design does about it:
//   * one cluster of G CTAs per cell (G = 1 or 16, chosen by the wrapper
//     from m_q alone; on the card G = 1 beat 2 and 4 at the D3CA cells, and
//     16 beat 8 at the serial shape): CTA `rank` owns a slice of
//     ceil(m_q / G) columns, so a serial epoch's rows stream through G SMs;
//   * w lives in registers for the whole epoch: thread t of 128 owns
//     columns t, t + 128, ... of the slice (E of them, a template
//     parameter), and writes them to w_out once, at the end;
//   * the epoch's whole `idx` is known at launch and copied into shared
//     memory first; the rows of the next 7 steps are in flight in a ring
//     of 8 shared-memory slots, one bulk copy (TMA) a row, issued by one
//     thread and completing the slot's mbarrier.  At m_q = 3003 rows start
//     on 4-byte boundaries only, and a bulk copy needs 16: the copy starts
//     at the 16-byte boundary at or before the slice and is rounded up to
//     16 bytes, so it carries up to 12 bytes of the neighbouring data of
//     the same tensor on either side, which no thread reads.  (Per-thread
//     4-byte copies -- 24 a thread a step at the D3CA shape -- took most
//     of the step; loads into a ring of registers kept the step waiting on
//     the loads' scoreboards.)
//   * one step: the dot product and the squared norm from registers, warp
//     shuffles, one exchange of the warp partials in shared memory and ONE
//     __syncthreads; every thread then computes d itself (label, mask and
//     alpha0 of the row come with it, loaded a step ahead by three threads
//     of the last warp, which also issues the row copies, so that warp 0
//     carries only the dual and the exchange) and updates its columns of w;
//   * for G > 1, lane g of warp 0 sends the CTA's sums to rank g by
//     st.async on that CTA's mbarrier transaction count (csrc/cluster.cuh)
//     and every CTA adds the G of them in rank order, so d is bitwise the
//     same in every CTA.  The exchange is pipelined one step deep: as
//     x_k . w_k = x_k . w_{k-1} + c_{k-1} (x_k . x_{k-1}), the sums of step
//     k + 1 (x_{k+1} . w_k, x_{k+1} . x_k, ||x_{k+1}||^2) are sent during
//     step k, before the CTA waits for those of step k, so a round trip
//     overlaps a step's work (four rounds rotate through four slots);
//   * the epoch's dual deltas live in shared memory (n_p floats, a copy
//     in every CTA, identical because d is); thread 0 reads the current
//     value of the step's row before the barrier and writes the new one
//     after the step, so a repeated index -- the next step or any later
//     one -- always reads its own update; rank 0 writes dalpha at the end.
// What is left is the step's own latency (shuffles, the barrier, the dual
// step) and, for G > 1, the round trip of the exchange between CTAs.
// Offsets are 64-bit: a weak-scaling grid exceeds 2^31 elements.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 8;             // row slots: step h + 7 requested at h
constexpr int kMaxCluster = 16;
constexpr int kPeerSlots = 4;     // rounds of the exchange in flight

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

using rt::bulk_copy;
using rt::mbar_wait;

template <int LOSS, int E>
__global__ void __launch_bounds__(kThreads, 1) sdca_epoch_cluster_kernel(
    const float* __restrict__ x,       // (P, Q, T, n_p, m_q)
    const float* __restrict__ y,       // (P, T, n_p)
    const float* __restrict__ mask,    // (P, T, n_p)
    const float* __restrict__ alpha0,  // (P, T, n_p)
    const float* __restrict__ w0,      // (Q, T, m_q)
    const int* __restrict__ idx,       // (P, T, steps)
    float* __restrict__ dalpha,        // (P, Q, T, n_p)
    float* __restrict__ w_out,         // (P, Q, T, m_q)
    int Q, int Tn, int n_p, int m_q, int steps, int G, int slice,
    float lam, float n, float Qf, float beta, int use_beta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 3) [lam, n, beta] or null
  // a slot holds the slice's row from the 16-byte boundary at or before
  // its first column, rounded up to 16 bytes: at most slice + 3 (+ 3) floats
  constexpr int kSlot = E * kThreads + 8;
  extern __shared__ __align__(16) float sm[];
  float* dal_s = sm;                               // [n_p] dual deltas
  int* idx_s = reinterpret_cast<int*>(dal_s + n_p);  // [steps] the order
  float* ring = dal_s + ((n_p + steps + 3) & ~3);  // [kRing][kSlot] rows
  float* scal = ring + kRing * kSlot;              // [2 kRing][4] y, mask, alpha0
  __shared__ __align__(8) unsigned long long rbar[kRing];  // slot landed
  __shared__ float red[2][3 * kWarps + 1];         // step parity: partials, dual
  // rounds of the exchange: every peer's sums, by rank
  __shared__ __align__(16) float part[kPeerSlots][kMaxCluster][4];
  __shared__ __align__(8) unsigned long long pbar[kPeerSlots];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rank = G > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                         : 0;
  const long long c = blockIdx.x / G;
  const rt::Cell cell = rt::decode_cell(c, Q, Tn);

  if (cell_params != nullptr) {
    lam = cell_params[3 * c];
    n = cell_params[3 * c + 1];
    beta = cell_params[3 * c + 2];
  }
  const float lam_n = lam * n;
  const float inv_lam_n = 1.0f / lam_n;
  const float inv_q = 1.0f / Qf;
  const float half_inv_q = 1.0f / (2.0f * Qf);

  const int s0 = rank * slice;
  const int s_len = max(0, min(slice, m_q - s0));
  // this thread's columns tid + kThreads * j, j < nvalid, lie in the slice
  const int nvalid = s_len > tid ? (s_len - tid + kThreads - 1) / kThreads : 0;
  const float* xc = x + c * n_p * m_q + s0;      // the slice of row 0
  // the threads of the last warp: lane 0 issues the row copies, lanes 0-2
  // fetch the row's label, mask and alpha0 -- off warp 0, which carries
  // the dual and the exchange between CTAs
  const int io_lane = tid - (kThreads - 32);
  const bool io_scalar = io_lane >= 0 && io_lane < 3;
  const float* sc_src =
      (io_lane == 0 ? y : io_lane == 1 ? mask : alpha0) + cell.row * n_p;
  const int* ip = idx + cell.row * steps;

  float w[E];
#pragma unroll
  for (int j = 0; j < E; ++j)
    w[j] = j < nvalid ? w0[cell.col * m_q + s0 + tid + kThreads * j] : 0.f;
  for (int i = tid; i < n_p; i += kThreads) dal_s[i] = 0.f;
  for (int h = tid; h < steps; h += kThreads) cp_async4(idx_s + h, ip + h);
  __pipeline_commit();
  if (tid == 0) {
    for (int sl = 0; sl < kRing; ++sl) rt::cl_mbar_init(rt::smem_addr(&rbar[sl]));
    if (G > 1)
      for (int r = 0; r < kPeerSlots; ++r)
        rt::cl_mbar_init(rt::smem_addr(&pbar[r]));
    rt::cl_mbar_fence_init();
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the order is in shared memory, the mbarriers ready

  // the slice of the row of step k, and where it starts in its slot: the
  // copy begins at the 16-byte boundary at or before it (the bytes before
  // and after belong to the neighbouring row or column block of the same
  // tensor, or to the 512-byte-rounded allocation past its end)
  auto row_of = [&](int k) {
    return xc + static_cast<long long>(idx_s[k]) * m_q;
  };
  // request the row of step k into its slot: one bulk copy, whose bytes
  // complete the slot's mbarrier
  auto request = [&](int k) {
    if (k < steps && io_lane == 0) {
      const uintptr_t src = reinterpret_cast<uintptr_t>(row_of(k));
      const uintptr_t start = src & ~static_cast<uintptr_t>(15);
      const uint32_t bytes =
          s_len > 0 ? ((static_cast<uint32_t>(src - start) + 4u * s_len + 15u)
                       & ~15u) : 0u;
      const uint32_t bar = rt::smem_addr(&rbar[k % kRing]);
      rt::cl_mbar_expect(bar, bytes);
      if (bytes > 0)
        bulk_copy(rt::smem_addr(ring + (k % kRing) * kSlot),
                  reinterpret_cast<const void*>(start), bytes, bar);
    }
  };
  for (int k = 0; k < kRing - 1; ++k) request(k);
  // the row scalars: lane t < 3 of the last warp loads those of step k + 2
  // into a register during step k and stores them into their slot during
  // step k + 1, before that step's barrier, which publishes them for step
  // k + 2 (a load has a whole step to land)
  float pending = 0.f;
  if (io_scalar) {
    if (steps > 0) scal[io_lane] = __ldg(sc_src + idx_s[0]);
    if (steps > 1) pending = __ldg(sc_src + idx_s[1]);
  }
  auto stage_scalars = [&](int h) {
    if (io_scalar) {
      scal[4 * ((h + 1) % (2 * kRing)) + io_lane] = pending;
      pending = h + 2 < steps ? __ldg(sc_src + idx_s[h + 2]) : 0.f;
    }
  };
  // (G > 1) every CTA of the cluster runs with its mbarriers initialised
  // before the first partial arrives from a peer
  if (G > 1) cg::this_cluster().sync();

  // this thread's columns of the row of step k, from its slot
  auto load_row = [&](int k, float (&xv)[E]) {
    const int lead =
        static_cast<int>(reinterpret_cast<uintptr_t>(row_of(k)) & 15) >> 2;
    mbar_wait(rt::smem_addr(&rbar[k % kRing]), (k / kRing) & 1);
    const float* cur = ring + (k % kRing) * kSlot + lead + tid;
#pragma unroll
    for (int j = 0; j < E; ++j) xv[j] = j < nvalid ? cur[kThreads * j] : 0.f;
  };
  // the dual step of step k from its dot product, squared norm and the
  // current dual delta of its row (its label, mask and alpha0 are in
  // shared memory since the last barrier); 1 / Q, 1 / (lam n) and
  // 1 / (2 Q) are taken once, the one data-dependent division is
  // __fdividef
  auto dual_step = [&](int k, float dot, float sq, float dal_i) {
    const float* sr = scal + 4 * (k % (2 * kRing));
    const float yq = sr[0] * inv_q, mi = sr[1];
    const float a_i = sr[2] + dal_i;
    const float denom = fmaxf(use_beta ? beta : sq, 1e-12f);
    float d;
    if (LOSS == rt::kHinge) {
      d = __fdividef((yq - dot) * lam_n, denom);
      const float lo = yq > 0.f ? 0.f : -1.f;
      const float hi = yq > 0.f ? 1.f : 0.f;
      d = fminf(fmaxf(a_i + d, lo), hi) - a_i;
    } else {
      const float num = yq - a_i * half_inv_q - dot;
      const float den = fmaf(denom, inv_lam_n, half_inv_q);
      d = __fdividef(num, fmaxf(den, 1e-12f));
    }
    return d * mi;  // padded rows never move
  };

  if (G == 1) {
    for (int h = 0; h < steps; ++h) {
      // the row of step h was requested kRing - 1 steps ago
      float xv[E];
      load_row(h, xv);
      // the slot of step h - 1 is free (every thread read it before the
      // last barrier): request step h + kRing - 1 into it
      request(h + kRing - 1);
      stage_scalars(h);
      float d0 = 0.f, d1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < E; j += 2) {
        d0 = fmaf(xv[j], w[j], d0);
        q0 = fmaf(xv[j], xv[j], q0);
        if (j + 1 < E) {
          d1 = fmaf(xv[j + 1], w[j + 1], d1);
          q1 = fmaf(xv[j + 1], xv[j + 1], q1);
        }
      }
      float dot = rt::warp_sum(d0 + d1);
      float sq = rt::warp_sum(q0 + q1);
      float* rd = red[h & 1];
      const int i = idx_s[h];
      if (lane == 0) { rd[warp] = dot; rd[kWarps + warp] = sq; }
      if (tid == 0) rd[3 * kWarps] = dal_s[i];  // its own last write
      __syncthreads();  // partials, and the row's scalars
      dot = 0.f;
      sq = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        dot += rd[wi];
        sq += rd[kWarps + wi];
      }
      const float dal_i = rd[3 * kWarps];
      const float d = dual_step(h, dot, sq, dal_i);
      const float coef = d * inv_lam_n;
#pragma unroll
      for (int j = 0; j < E; ++j) w[j] = fmaf(coef, xv[j], w[j]);
      if (tid == 0) dal_s[i] = dal_i + d;
    }
  } else {
    // G > 1: the exchange between CTAs is pipelined one step deep.  With
    // w_k the iterate before step k and c_k = d_k / (lam n),
    //   x_k . w_k = x_k . w_{k-1} + c_{k-1} (x_k . x_{k-1}),
    // so round k of the exchange carries, for step k, the slice sums of
    // x_k . w_{k-1}, x_k . x_{k-1} and ||x_k||^2, which need only w_{k-1}:
    // each CTA sends round k + 1 during step k, before it waits for round
    // k (sent a step earlier), and the round trip overlaps a step's work.
    // Rounds rotate through kPeerSlots = 4 slots and mbarriers per CTA.  A
    // CTA sends round r + 4 (into the slot of round r) during step r + 3,
    // after it has received every peer's round r + 1 during step r; a peer
    // sends round r + 1 during step r only after it has read round r
    // (step r - 1 ended), so no peer's round r is overwritten before it is
    // read.  (With three slots a CTA would wait for round r + 1 only when
    // it sends round r + 3, which a peer may send before reading round r.)
    auto send = [&](int r, float a, float b, float q) {
      if (warp == 0 && lane < G) {
        const uint32_t bar = rt::smem_addr(&pbar[r % kPeerSlots]);
        if (lane == 0) rt::cl_mbar_expect(bar, 12 * G);
        const uint32_t pb = rt::peer_addr(bar, lane);
        const uint32_t slot = rt::peer_addr(
            rt::smem_addr(part[r % kPeerSlots][rank]), lane);
        rt::st_async_peer(slot, a, pb);
        rt::st_async_peer(slot + 4, b, pb);
        rt::st_async_peer(slot + 8, q, pb);
      }
    };
    // (a, b, q) summed over the CTA: shuffles, the warp partials through
    // red[par], one barrier; thread 0 also passes its `extra` along
    auto cta_sum = [&](int par, float& a, float& b, float& q, float& extra) {
      a = rt::warp_sum(a);
      b = rt::warp_sum(b);
      q = rt::warp_sum(q);
      float* rd = red[par];
      if (lane == 0) {
        rd[warp] = a;
        rd[kWarps + warp] = b;
        rd[2 * kWarps + warp] = q;
      }
      if (tid == 0) rd[3 * kWarps] = extra;
      __syncthreads();
      a = b = q = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        a += rd[wi];
        b += rd[kWarps + wi];
        q += rd[2 * kWarps + wi];
      }
      extra = rd[3 * kWarps];
    };

    float xk[E];  // the row of the current step
    float c_prev = 0.f;
    if (steps > 0) {
      load_row(0, xk);
      float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f, b = 0.f, unused = 0.f;
#pragma unroll
      for (int j = 0; j < E; j += 2) {
        a0 = fmaf(xk[j], w[j], a0);
        q0 = fmaf(xk[j], xk[j], q0);
        if (j + 1 < E) {
          a1 = fmaf(xk[j + 1], w[j + 1], a1);
          q1 = fmaf(xk[j + 1], xk[j + 1], q1);
        }
      }
      float a = a0 + a1, q = q0 + q1;
      cta_sum(1, a, b, q, unused);
      send(0, a, b, q);
    }
    for (int h = 0; h < steps; ++h) {
      const bool ahead = h + 1 < steps;
      float xn[E];
      float a = 0.f, b = 0.f, q = 0.f;
      if (ahead) {
        load_row(h + 1, xn);
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int j = 0; j < E; j += 2) {
          a0 = fmaf(xn[j], w[j], a0);
          b0 = fmaf(xn[j], xk[j], b0);
          q0 = fmaf(xn[j], xn[j], q0);
          if (j + 1 < E) {
            a1 = fmaf(xn[j + 1], w[j + 1], a1);
            b1 = fmaf(xn[j + 1], xk[j + 1], b1);
            q1 = fmaf(xn[j + 1], xn[j + 1], q1);
          }
        }
        a = a0 + a1;
        b = b0 + b1;
        q = q0 + q1;
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) xn[j] = 0.f;
      }
      // the slot of step h - 1 is free: request step h + kRing - 1 into it
      request(h + kRing - 1);
      stage_scalars(h);
      const int i = idx_s[h];
      float dal_i = tid == 0 ? dal_s[i] : 0.f;  // its own last write
      cta_sum(h & 1, a, b, q, dal_i);   // round h + 1 over this CTA
      if (ahead) send(h + 1, a, b, q);
      // round h: the G slice sums, in rank order
      rt::cl_mbar_wait(rt::smem_addr(&pbar[h % kPeerSlots]),
                       (h / kPeerSlots) & 1);
      float sa = 0.f, sb = 0.f, sq = 0.f;
      for (int g = 0; g < G; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(part[h % kPeerSlots][g]);
        sa += v.x;
        sb += v.y;
        sq += v.z;
      }
      const float d = dual_step(h, fmaf(c_prev, sb, sa), sq, dal_i);
      const float coef = d * inv_lam_n;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        w[j] = fmaf(coef, xk[j], w[j]);
        xk[j] = xn[j];
      }
      if (tid == 0) dal_s[i] = dal_i + d;
      c_prev = coef;
    }
  }
  __pipeline_wait_prior(0);

  float* wo = w_out + c * m_q + s0 + tid;
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (j < nvalid) wo[kThreads * j] = w[j];
  __syncthreads();  // thread 0's last dual write lands
  if (rank == 0) {
    float* dal = dalpha + c * n_p;
    for (int i = tid; i < n_p; i += kThreads) dal[i] = dal_s[i];
  }
  if (G > 1) cg::this_cluster().sync();  // no CTA leaves while a peer may address it
}

template <int LOSS, int E>
int launch_e(const float* x, const float* y, const float* mask,
             const float* alpha0, const float* w0, const int* idx,
             float* dalpha, float* w_out, int P, int Q, int T, int n_p,
             int m_q, int steps, int G, int slice, float lam, float n,
             float q_scale,
             float beta, int use_beta, const float* cell_params, size_t smem,
             cudaStream_t stream) {
  // the kernel's layout: dual deltas, the order, the ring, the scalars
  const size_t need =
      4 * (((static_cast<size_t>(n_p) + steps + 3) & ~static_cast<size_t>(3)) +
           static_cast<size_t>(kRing) * (E * kThreads + 8) + 8 * kRing);
  if (smem < need || slice > E * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = sdca_epoch_cluster_kernel<LOSS, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * Q * T * G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, x, y, mask, alpha0, w0, idx, dalpha,
                           w_out, Q, T, n_p, m_q, steps, G, slice, lam, n,
                           q_scale, beta, use_beta, cell_params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int LOSS>
int launch_loss(const float* x, const float* y, const float* mask,
                const float* alpha0, const float* w0, const int* idx,
                float* dalpha, float* w_out, int P, int Q, int T, int n_p,
                int m_q, int steps, int G, int slice, int E, float lam, float n,
                float q_scale, float beta, int use_beta,
                const float* cell_params, size_t smem, cudaStream_t stream) {
#define RT_SDCA_E(EV)                                                         \
  if (E == (EV))                                                              \
    return launch_e<LOSS, EV>(x, y, mask, alpha0, w0, idx, dalpha, w_out, P,  \
                              Q, T, n_p, m_q, steps, G, slice, lam, n,        \
                              q_scale, beta, use_beta, cell_params, smem,     \
                              stream);
  RT_SDCA_E(4)
  RT_SDCA_E(6)
  RT_SDCA_E(8)
  RT_SDCA_E(12)
  RT_SDCA_E(16)
  RT_SDCA_E(24)
  RT_SDCA_E(32)
#undef RT_SDCA_E
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The cluster route.  Launch on `stream`; allocates nothing, does not
// synchronise, returns cudaGetLastError().  Arguments as
// sdca_epoch_launch's (csrc/sdca_epoch.cu), but dalpha need not be
// zeroed.  The caller (kernels/sdca/ops.py) owns the geometry, which the
// launch refuses unless the kernel is compiled for it: `cluster` CTAs of
// `threads` threads per cell (1 or 16; 128), `per_thread`
// columns a thread (4, 6, 8, 12, 16, 24 or 32), `slice` columns a CTA (at
// least ceil(m_q / cluster), at most threads * per_thread) and `smem`
// bytes of dynamic shared memory a CTA, at least the kernel's layout:
// n_p dual deltas and the `steps` indices (together rounded up to 4), 8
// row slots of threads * per_thread + 8 floats and 16 x 4 floats of row
// scalars.
extern "C" int sdca_epoch_cluster_launch(
    const float* x, const float* y, const float* mask, const float* alpha0,
    const float* w0, const int* idx, float* dalpha, float* w_out,
    int P, int Q, int T, int n_p, int m_q, int steps,
    float lam, float n, float q_scale, float beta, int use_beta,
    const float* cell_params, int loss,
    int cluster, int threads, int per_thread, int slice, int smem,
    void* stream) {
  const bool g_ok = cluster == 1 || cluster == kMaxCluster;
  if (P < 1 || Q < 1 || T < 1 || n_p < 1 || m_q < 1 || steps < 0 || !g_ok ||
      threads != kThreads || slice < 1 ||
      static_cast<long long>(slice) * cluster < m_q || smem < 0 ||
      static_cast<size_t>(smem) > rt::kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto nbytes = static_cast<size_t>(smem);
  if (loss == rt::kHinge)
    return launch_loss<rt::kHinge>(x, y, mask, alpha0, w0, idx, dalpha,
                                   w_out, P, Q, T, n_p, m_q, steps, cluster,
                                   slice, per_thread, lam, n, q_scale, beta,
                                   use_beta, cell_params, nbytes, st);
  return launch_loss<rt::kSquared>(x, y, mask, alpha0, w0, idx, dalpha,
                                   w_out, P, Q, T, n_p, m_q, steps, cluster,
                                   slice, per_thread, lam, n, q_scale, beta,
                                   use_beta, cell_params, nbytes, st);
}
