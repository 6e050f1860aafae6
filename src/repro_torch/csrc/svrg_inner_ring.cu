// RADiSA inner loop (paper Algorithm 3 steps 7-10): L variance-reduced SGD
// steps on one feature sub-block window, for all cells of a P x Q grid
// (and T tenants) in one launch -- the `ring` route of
// kernels/svrg/ops.py::svrg_inner.
//
// Replaces the TPU kernel src/repro/kernels/svrg/svrg.py::svrg_inner_pallas
// on every window whose columns fit the registers of one CTA and whose
// order and ring of rows fit its shared memory (kernels/svrg/ops.py::
// svrg_route): the main path's RADiSA cells (windows of 429 of 3003
// columns, 2000 steps, at T = 1 and in the T = 4 dense fleet).  It
// computes what the `block` route (svrg_inner.cu) computes, with the same
// per-column update expression, so each column of w rounds as there; only
// the window's inner product is formed another way (below).
//
// What bounds it on this card: the bytes are the sampled rows' windows
// read once (0.018 ms at the main shape), far below the time of the chain
// of L dependent steps: each step reduces x_j . (w - w~) over the window
// before its update may start.  The block route spent each step waiting
// on its row -- requested one step ahead as 4-byte cp.async copies, drawn
// at random from 672 MB of blocks, so about one device-memory round trip
// a step -- and on a 128-thread barrier.
//
// What the design does about it:
//   * w, w~ and mu of the window live in registers for all L steps:
//     thread t of the 32 W consumer threads owns columns t, t + 32 W, ...
//     (E of them, a template parameter); w goes to w_out once, at the end;
//   * the cell's whole order `idx` is copied into shared memory first;
//   * one producer warp (lane 0) streams the rows through a ring of 8
//     shared-memory slots (16 were no faster, PERF.md): one bulk copy
//     (TMA) a row, completing the slot's "full" mbarrier, issued as soon
//     as the consumers have released the slot on its "empty" mbarrier --
//     so no request sits on a step's path.  A window starts at lo[p] * 4 bytes into a row of 3003 floats, so it is
//     not 16-byte aligned: the copy starts at the 16-byte boundary at or
//     before it and is rounded up to 16 bytes, carrying up to 12 bytes of
//     the same tensor on either side, which no thread reads (the tensor's
//     allocation is 512-byte rounded).  The row's label, mask and anchor
//     margin come as three more 16-byte copies into the same slot;
//   * the step's dot is pipelined one step deep.  With w_h the iterate
//     before step h and gd_h its gradient scale (mask included),
//         w_{h+1} - w~ = (1 - eta lam)(w_h - w~) - eta gd_h x_h - eta mu,
//     so x_{h+1} . (w_{h+1} - w~) = (1 - eta lam) A - eta gd_h B - eta C
//     with A = x_{h+1} . (w_h - w~), B = x_{h+1} . x_h, C = x_{h+1} . mu,
//     none of which needs gd_h.  During step h every consumer thread forms
//     its columns' parts of A, B and C (the next row is loaded into
//     registers while the step runs), warp shuffles reduce them (with four
//     warps, the warp partials meet in shared memory behind one named
//     barrier of the consumers), and the next dot is two FMAs once gd_h is
//     known.  dot_0 = 0 exactly (w_0 = w~).  (Pipelining two steps deep
//     gains nothing: the step is bound by its instruction count, not by
//     the reduction's latency, PERF.md.)  Each column is still updated
//     with the block route's expression, so w rounds as there; the dot is
//     summed in another order and through the identity, so the result
//     agrees with the plain version to rounding, not bitwise;
//   * one warp a cell (W = 1, 14 columns a lane at the main shape) needs no
//     barrier at all: after the xor-shuffle reduction every lane holds the
//     same sums.  It was measured faster than four warps at the main shape
//     (PERF.md); windows of 513 to 2048 columns, which one warp's
//     registers do not hold, take four (W = 4).
// Offsets are 64-bit: a weak-scaling grid exceeds 2^31 elements.

#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kRing = 8;  // rows in flight: the slots of the ring

template <int LOSS, int W, int E>
__global__ void __launch_bounds__(32 * (W + 1), 1) svrg_inner_ring_kernel(
    const float* __restrict__ x,         // (P, Q, T, n_p, m_x)
    const float* __restrict__ y,         // (P, T, n_p)
    const float* __restrict__ mask,      // (P, T, n_p)
    const float* __restrict__ z_anchor,  // (P, T, n_p)
    const float* __restrict__ w_anchor,  // (P, Q, T, m_sub)
    const float* __restrict__ mu,        // (P, Q, T, m_sub)
    const int* __restrict__ idx,         // (P, Q, T, L)
    const int* __restrict__ lo,          // (P, T) window offsets, or null = 0
    float* __restrict__ w_out,           // (P, Q, T, m_sub)
    int Q, int Tn, int n_p, int m_x, int m_sub, int L, float lam, float eta,
    const float* __restrict__ cell_params) {  // (P*Q*T, 2) [lam, eta] or null
  constexpr int kThreads = 32 * W;   // consumers; warp W is the producer
  // a slot: the window's row from the 16-byte boundary at or before its
  // first column, rounded up to 16 bytes (at most kThreads * E + 6
  // floats), then three 16-byte chunks holding the row's label, mask and
  // anchor margin
  constexpr int kRow = kThreads * E + 8;
  constexpr int kSlot = kRow + 12;
  extern __shared__ __align__(16) float sm[];
  int* idx_s = reinterpret_cast<int*>(sm);       // [L] the order
  float* slots = sm + ((L + 3) & ~3);            // [kRing][kSlot]
  __shared__ __align__(8) unsigned long long full[kRing];   // row landed
  __shared__ __align__(8) unsigned long long empty[kRing];  // row read
  __shared__ float red[2][W][3];                 // step parity: A, B, C

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long c = blockIdx.x;
  const long long row = rt::decode_cell(c, Q, Tn).row;

  if (cell_params != nullptr) {
    lam = cell_params[2 * c];
    eta = cell_params[2 * c + 1];
  }

  const float* xc = x + c * n_p * m_x + (lo != nullptr ? lo[row] : 0);
  const float* yp = y + row * n_p;
  const float* mp = mask + row * n_p;
  const float* zp = z_anchor + row * n_p;
  const int* ip = idx + c * L;

  for (int h = tid; h < L; h += blockDim.x) idx_s[h] = ip[h];
  if (tid == 0) {
    for (int sl = 0; sl < kRing; ++sl) {
      rt::mbar_init(rt::smem_addr(&full[sl]), 1);
      rt::mbar_init(rt::smem_addr(&empty[sl]), W);
    }
    rt::cl_mbar_fence_init();
  }
  __syncthreads();  // the order is in shared memory, the mbarriers ready

  // the 16-byte chunk that holds *p, and where *p lies in it
  auto chunk_of = [](const float* p) {
    return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                         ~static_cast<uintptr_t>(15));
  };
  auto lane_of = [](const float* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) >> 2;
  };

  if (warp == W) {
    // the producer: row q into slot q mod kRing once the consumers have
    // released the slot's previous row (q - kRing)
    if (lane == 0) {
      int sl = 0, wraps = 0;
      for (int q = 0; q < L; ++q) {
        if (wraps > 0)
          rt::mbar_wait(rt::smem_addr(&empty[sl]), (wraps - 1) & 1);
        const int j = idx_s[q];
        const uintptr_t src =
            reinterpret_cast<uintptr_t>(xc + static_cast<long long>(j) * m_x);
        const uintptr_t start = src & ~static_cast<uintptr_t>(15);
        const uint32_t bytes =
            (static_cast<uint32_t>(src - start) + 4u * m_sub + 15u) & ~15u;
        const uint32_t bar = rt::smem_addr(&full[sl]);
        const float* slot = slots + sl * kSlot;
        rt::cl_mbar_expect(bar, bytes + 48u);
        rt::bulk_copy(rt::smem_addr(slot),
                      reinterpret_cast<const void*>(start), bytes, bar);
        rt::bulk_copy(rt::smem_addr(slot + kRow), chunk_of(yp + j), 16u, bar);
        rt::bulk_copy(rt::smem_addr(slot + kRow + 4), chunk_of(mp + j), 16u,
                      bar);
        rt::bulk_copy(rt::smem_addr(slot + kRow + 8), chunk_of(zp + j), 16u,
                      bar);
        if (++sl == kRing) {
          sl = 0;
          ++wraps;
        }
      }
    }
    return;  // the consumers synchronise among themselves only
  }

  // this thread's columns tid + kThreads * j, j < nvalid, lie in the window
  const int nvalid = m_sub > tid ? (m_sub - tid + kThreads - 1) / kThreads : 0;
  float w[E], wa[E], mv[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const long long e = c * m_sub + tid + kThreads * j;
    wa[j] = j < nvalid ? w_anchor[e] : 0.f;
    mv[j] = j < nvalid ? mu[e] : 0.f;
    w[j] = wa[j];
  }

  // wait for row q in its slot (sl, wraps: q = sl + wraps * kRing); this
  // thread's columns of it into xv, its label, mask and anchor margin into s
  auto load = [&](int q, int sl, int wraps, float (&xv)[E], float (&s)[3]) {
    const int j = idx_s[q];
    rt::mbar_wait(rt::smem_addr(&full[sl]), wraps & 1);
    const float* slot = slots + sl * kSlot;
    const float* cur =
        slot + lane_of(xc + static_cast<long long>(j) * m_x) + tid;
#pragma unroll
    for (int e = 0; e < E; ++e) xv[e] = e < nvalid ? cur[kThreads * e] : 0.f;
    s[0] = slot[kRow + lane_of(yp + j)];
    s[1] = slot[kRow + 4 + lane_of(mp + j)];
    s[2] = slot[kRow + 8 + lane_of(zp + j)];
  };
  // this warp has read the slot: one arrival of the W the producer awaits
  auto release = [&](int sl) {
    __syncwarp();
    if (lane == 0) rt::mbar_arrive(rt::smem_addr(&empty[sl]));
  };

  float xk[E], sk[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < E; ++e) xk[e] = 0.f;
  int sl = 0, wraps = 0;  // the slot of the next row to load
  auto advance = [&] {
    if (++sl == kRing) {
      sl = 0;
      ++wraps;
    }
  };
  if (L > 0) {
    load(0, sl, wraps, xk, sk);
    release(sl);
    advance();
  }
  const float decay = 1.0f - eta * lam;
  float dot = 0.f;  // x_h . (w_h - w~): 0 at h = 0, where w = w~

  for (int h = 0; h < L; ++h) {
    const float yj = sk[0], mj = sk[1], zj = sk[2];
    const float gd =
        (rt::loss_grad<LOSS>(zj + dot, yj) - rt::loss_grad<LOSS>(zj, yj)) * mj;
    // the next row, and this thread's parts of A, B and C from it and the
    // iterate before this step's update
    float xn[E], sn[3] = {0.f, 0.f, 0.f};
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f, m0 = 0.f, m1 = 0.f;
    const bool ahead = h + 1 < L;
    if (ahead) {
      load(h + 1, sl, wraps, xn, sn);
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        a0 = fmaf(xn[e], w[e] - wa[e], a0);
        b0 = fmaf(xn[e], xk[e], b0);
        m0 = fmaf(xn[e], mv[e], m0);
        if (e + 1 < E) {
          a1 = fmaf(xn[e + 1], w[e + 1] - wa[e + 1], a1);
          b1 = fmaf(xn[e + 1], xk[e + 1], b1);
          m1 = fmaf(xn[e + 1], mv[e + 1], m1);
        }
      }
      release(sl);
      advance();
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) xn[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      // the block route's expression, so each column rounds as there
      const float wk = w[e];
      const float g = gd * xk[e] + mv[e] + lam * (wk - wa[e]);
      w[e] = wk - eta * g;
    }
    if (ahead) {
      float A = rt::warp_sum(a0 + a1);
      float B = rt::warp_sum(b0 + b1);
      float C = rt::warp_sum(m0 + m1);
      if (W > 1) {
        float* rd = red[h & 1][0];
        if (lane == 0) {
          rd[3 * warp] = A;
          rd[3 * warp + 1] = B;
          rd[3 * warp + 2] = C;
        }
        asm volatile("bar.sync 1, %0;\n" ::"r"(kThreads) : "memory");
        A = B = C = 0.f;
#pragma unroll
        for (int wi = 0; wi < W; ++wi) {
          A += rd[3 * wi];
          B += rd[3 * wi + 1];
          C += rd[3 * wi + 2];
        }
      }
      dot = decay * A - eta * gd * B - eta * C;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) xk[e] = xn[e];
    sk[0] = sn[0];
    sk[1] = sn[1];
    sk[2] = sn[2];
  }

  float* wo = w_out + c * m_sub + tid;
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (j < nvalid) wo[kThreads * j] = w[j];
}

template <int LOSS, int W, int E>
int launch_we(const float* x, const float* y, const float* mask,
              const float* z_anchor, const float* w_anchor, const float* mu,
              const int* idx, const int* lo, float* w_out, int P, int Q,
              int T, int n_p, int m_x, int m_sub, int L, float lam, float eta,
              const float* cell_params, size_t smem, cudaStream_t stream) {
  // the kernel's layout: the order (rounded up to 4), then the ring
  const size_t need =
      4 * (((static_cast<size_t>(L) + 3) & ~static_cast<size_t>(3)) +
           static_cast<size_t>(kRing) * (32 * W * E + 20));
  if (smem < need || m_sub > 32 * W * E)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = svrg_inner_ring_kernel<LOSS, W, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<P * Q * T, 32 * (W + 1), smem, stream>>>(
      x, y, mask, z_anchor, w_anchor, mu, idx, lo, w_out, Q, T, n_p, m_x,
      m_sub, L, lam, eta, cell_params);
  return static_cast<int>(cudaGetLastError());
}

template <int LOSS>
int launch_loss(const float* x, const float* y, const float* mask,
                const float* z_anchor, const float* w_anchor, const float* mu,
                const int* idx, const int* lo, float* w_out, int P, int Q,
                int T, int n_p, int m_x, int m_sub, int L, float lam,
                float eta, const float* cell_params, int warps, int E,
                size_t smem, cudaStream_t stream) {
#define RT_SVRG_WE(WV, EV)                                                    \
  if (warps == (WV) && E == (EV))                                             \
    return launch_we<LOSS, WV, EV>(x, y, mask, z_anchor, w_anchor, mu, idx,  \
                                   lo, w_out, P, Q, T, n_p, m_x, m_sub, L,    \
                                   lam, eta, cell_params, smem, stream);
  RT_SVRG_WE(1, 4)
  RT_SVRG_WE(1, 8)
  RT_SVRG_WE(1, 16)
  RT_SVRG_WE(4, 8)
  RT_SVRG_WE(4, 16)
#undef RT_SVRG_WE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The ring route.  Launch on `stream`; allocates nothing, does not
// synchronise, returns cudaGetLastError().  Arguments as
// svrg_inner_launch's (csrc/svrg_inner.cu).  The caller (kernels/svrg/
// ops.py) owns the geometry, which the launch refuses unless the kernel
// is compiled for it: `warps` warps a cell and `per_thread` columns a
// thread (1 warp with 4, 8 or 16, 4 warps with 8 or 16; the window at most
// 32 * warps * per_thread columns), `ring` row slots (8) and `smem` bytes
// of dynamic shared memory, at least the kernel's layout: the L indices
// rounded up to 4, then 8 slots of 32 * warps * per_thread + 20 floats.
extern "C" int svrg_inner_ring_launch(
    const float* x, const float* y, const float* mask, const float* z_anchor,
    const float* w_anchor, const float* mu, const int* idx, const int* lo,
    float* w_out, int P, int Q, int T, int n_p, int m_x, int m_sub, int L,
    float lam, float eta, const float* cell_params, int loss, int warps,
    int per_thread, int ring, int smem, void* stream) {
  if (P < 1 || Q < 1 || T < 1 || n_p < 1 || m_sub < 1 || m_sub > m_x ||
      L < 0 || ring != kRing || smem < 0 ||
      static_cast<size_t>(smem) > rt::kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto nbytes = static_cast<size_t>(smem);
  if (loss == rt::kHinge)
    return launch_loss<rt::kHinge>(x, y, mask, z_anchor, w_anchor, mu, idx,
                                   lo, w_out, P, Q, T, n_p, m_x, m_sub, L,
                                   lam, eta, cell_params, warps, per_thread,
                                   nbytes, st);
  return launch_loss<rt::kSquared>(x, y, mask, z_anchor, w_anchor, mu, idx,
                                   lo, w_out, P, Q, T, n_p, m_x, m_sub, L,
                                   lam, eta, cell_params, warps, per_thread,
                                   nbytes, st);
}
