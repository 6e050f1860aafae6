// Chunked RWKV-6 linear attention with per-channel data-dependent decay on
// the tensor cores: the `tc` route of kernels/linattn/ops.py::rwkv_linattn
// (head dim 64, chunks of 64 tokens -- every RWKV6 prefill).
//
// Replaces the TPU kernel src/repro/kernels/linattn/linattn.py::
// rwkv_linattn_pallas on that path.  It computes the function the CUDA-
// core kernel (rwkv_linattn.cu, the `simt` route) computes: u per head
// ((H, D), row bh reads u[bh % H]), any S with the short last chunk zero-
// padded (r = k = v = 0, logw = 0: the state is left unchanged and the
// padded outputs are not stored), the final state returned, and every
// exponent <= 0 however strong the decay.  One thread block (8 warps)
// per (batch, head) row walks the chunks; one launch per call.
//
// Per chunk of C = 64 tokens, with la the in-chunk inclusive cumulative
// log decay and lp = la shifted by one token (lp[t] = la[t-1], lp[0] = 0):
//   o_t = (r_t e^{lp_t}) S0 + sum_{i<t} A[t,i] v_i + (r_t . (u k_t)) v_t
//   A[t,i] = sum_d r_td k_id e^{lp_td - la_id}
//   S     = diag(e^{la_63}) S0 + sum_i (k_i e^{la_63 - la_i})^T v_i
//
// What bounds it on this card: at B 8, H 40, S 512 it reads 168 MB and
// writes 47 MB, 0.064 ms at the memory rate.  Done as below, its 3.8
// GFLOP of matrix products take 0.023 ms at the 3xTF32 rate (a third of
// the TF32 peak) and its 0.4 GFLOP on the CUDA cores 0.006 ms, so the
// bytes bound it.  The CUDA-core kernel did all 4.8 GFLOP of its form as
// FMAs whose both operands came from shared memory (0.07 ms at the
// float32 rate alone), with a full expf for each of the C^2 D / 2
// pairwise score terms, one 117 KB CTA an SM (three waves of 320 rows on
// 132 SMs).
//
// What the design does about it:
//   * the three matrix terms run on the tensor cores as mma.sync m16n8k8
//     TF32 products with float32 accumulators in registers: the inter-
//     chunk term (C x D)(D x D), scores times v (C x C)(C x D) over the
//     lower triangle only, and the state update (D x C)(C x D).  Each
//     warp owns 8 columns of v, of the output and of the state: the
//     state S0 stays in that warp's accumulator registers across chunks
//     and reaches the inter-chunk product as its B operand by warp
//     shuffles, never through shared memory;
//   * precision: one TF32 product keeps 10 mantissa bits (~1e-3 relative
//     over a 64-term sum), over LINATTN_TOL = 2e-4.  Every operand is split
//     into hi = tf32(a) and lo = tf32(a - hi), and three products are
//     summed, lo*hi + hi*lo + hi*hi ("3xTF32"), which is float32-accurate
//     to ~1e-6;
//   * the scores by 16-token sub-chunks: for t in sub-chunk b (first
//     token s_b) and i in an earlier sub-chunk a (last token e_a),
//       e^{lp_t - la_i} = e^{lp_t - lp_{s_b}} e^{lp_{s_b} - la_{e_a}}
//                         e^{la_{e_a} - la_i},
//     and all three exponents are <= 0 (la is non-increasing because
//     logw <= 0, and lp_{s_b} = la_{s_b - 1} with e_a <= s_b - 1).  So r is
//     decayed to its sub-chunk's start and k to its sub-chunk's end once
//     per chunk, and the six off-diagonal 16 x 16 score blocks are
//     tensor-core products of those, with the middle factor (a per-
//     channel scale of one pair of sub-chunks) applied to the A fragment.
//     The inter-chunk and state terms reuse the same decayed r and k with
//     a per-channel scale (e^{lp_{s_b}} <= 1, e^{la_63 - la_{e_a}} <= 1).
//     Only the four diagonal 16 x 16 blocks keep per-pair, per-channel
//     exponentials on the CUDA cores: 30 720 a chunk, 4x fewer than
//     before, as ex2.approx of log2 decays; the current-token bonus fills
//     the diagonal of the score matrix;
//   * every exponent is a sum of the log decays it spans, never the
//     difference of two cumulative sums that share a long prefix.  In
//     float32 such a difference loses the prefix's rounding: with decays
//     down to e^-8 a token, cumulative sums reach -700 in log2 units,
//     whose ulp (6e-5) became the relative error of a term, and the
//     output of the main shape was 15x farther from the exact recurrence
//     than the float32 recurrence itself (PERF.md).  So each sub-chunk
//     keeps its own exclusive prefix sums P_t as a compensated pair hi +
//     lo (TwoSum), and its total; a decay within a sub-chunk is a
//     difference of two such pairs, (hi_t - hi_i) + (lo_t - lo_i), whose
//     hi part is exact where it cancels (Sterbenz), and a decay across
//     sub-chunks is a sum of the totals in between;
//   * occupancy: r~, k~, v, the log decays and the scores of one chunk in
//     110 KB of shared memory (odd-by-4 row strides, conflict-free for the
//     fragments), so two CTAs fit an SM and the 320 rows run as two
//     waves of 264 slots instead of three of 132.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;               // tokens a chunk
constexpr int kD = 64;               // head dim
constexpr int kLD = kD + 4;          // row stride of r, k, P, scores
constexpr int kLDV = kD + 8;         // row stride of v (B-operand reads)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as three TF32 products (small terms first)
__device__ __forceinline__ void mma3(float (&c)[4], const float (&a)[4],
                                     const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ah[e] = to_tf32(a[e]);
    al[e] = to_tf32(a[e] - __uint_as_float(ah[e]));
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    bh[e] = to_tf32(b[e]);
    bl[e] = to_tf32(b[e] - __uint_as_float(bh[e]));
  }
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// shared-memory layout, in floats
constexpr int kOffR = 0;                       // [C][kLD] r, then r~
constexpr int kOffK = kOffR + kC * kLD;        // [C][kLD] k, then k~
// P_t: token t's exclusive prefix sum of log2 decays within its sub-chunk
constexpr int kOffLA = kOffK + kC * kLD;       // [C][kLD] P_t, lo part
constexpr int kOffLP = kOffLA + kC * kLD;      // [C][kLD] logw, then P_t, hi
constexpr int kOffA = kOffLP + kC * kLD;       // [C][kLD] scores (t, i)
constexpr int kOffV = kOffA + kC * kLD;        // [C][kLDV] v
constexpr int kOffP = kOffV + kC * kLDV;       // [4][D] sub-chunk totals, hi
constexpr int kOffL = kOffP + 4 * kD;          // [4][D] and lo
constexpr int kOffE = kOffL + 4 * kD;          // [4][D] e^{lp_{s_b}}
constexpr int kOffF = kOffE + 4 * kD;          // [4][D] e^{la_63 - la_{e_a}}
constexpr int kOffDp = kOffF + 4 * kD;         // [6][D] e^{lp_{s_b} - la_{e_a}}
constexpr int kOffDec = kOffDp + 6 * kD;       // [D] e^{la_63}
constexpr int kOffU = kOffDec + kD;            // [D] u of this head
constexpr int kSmemFloats = kOffU + kD;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2) rwkv_linattn_tc_kernel(
    const float* __restrict__ r,      // (BH, S, D)
    const float* __restrict__ k,      // (BH, S, D)
    const float* __restrict__ v,      // (BH, S, D)
    const float* __restrict__ logw,   // (BH, S, D), <= 0
    const float* __restrict__ u,      // (H, D)
    float* __restrict__ out,          // (BH, S, D)
    float* __restrict__ state_out,    // (BH, D, D)
    int S, int H) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm + kOffR;
  float* ks = sm + kOffK;
  float* plo = sm + kOffLA;
  float* phi = sm + kOffLP;
  float* as = sm + kOffA;
  float* vs = sm + kOffV;
  float* Th = sm + kOffP;
  float* Tl = sm + kOffL;
  float* Eb = sm + kOffE;
  float* Fa = sm + kOffF;
  float* Dp = sm + kOffDp;
  float* dec = sm + kOffDec;
  float* us = sm + kOffU;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const long long base = bh * S * kD;
  const int j0 = 8 * warp;           // this warp's 8 columns of v, o, S

  if (tid < kD) us[tid] = u[h * kD + tid];
  // S0 (d = 16 md + g (+8), j = j0 + 2 tig (+1)) in accumulator layout
  float st[4][4];
#pragma unroll
  for (int md = 0; md < 4; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[md][e] = 0.f;

  const int nc = (S + kC - 1) / kC;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kC;
    const int ce = min(kC, S - t0);
    __syncthreads();  // the last chunk's readers of shared memory are done

    // 1. the chunk into shared memory, zero-padded past S
#pragma unroll 4
    for (int e = tid; e < kC * kD; e += kThreads) {
      const int t = e >> 6, d = e & 63;
      const bool ok = t < ce;
      const long long gi = base + static_cast<long long>(t0 + t) * kD + d;
      rs[t * kLD + d] = ok ? r[gi] : 0.f;
      ks[t * kLD + d] = ok ? k[gi] : 0.f;
      vs[t * kLDV + d] = ok ? v[gi] : 0.f;
      phi[t * kLD + d] = ok ? logw[gi] : 0.f;
    }
    __syncthreads();

    // 2. log2 decays summed per channel within each sub-chunk: thread
    // (d, b) keeps P_t = hi + lo, the exclusive prefix sum of its 16
    // tokens (TwoSum carries each addition's rounding into lo), and the
    // sub-chunk's total T_b = Th + Tl
    {
      const int d = tid & 63, b = tid >> 6;
      float hi = 0.f, lo = 0.f;
      for (int tt = 0; tt < 16; ++tt) {
        const int t = 16 * b + tt;
        const float x = phi[t * kLD + d] * kLog2e;
        phi[t * kLD + d] = hi;
        plo[t * kLD + d] = lo;
        const float sum = hi + x;
        const float xb = sum - hi;
        lo += (hi - (sum - xb)) + (x - xb);
        hi = sum;
      }
      Th[b * kD + d] = hi;
      Tl[b * kD + d] = lo;
    }
    __syncthreads();

    // 3. the four diagonal 16 x 16 score blocks (per-pair exponentials)
    // and the current-token bonus on the diagonal; zeros above it
    for (int item = tid; item < 4 * 120 + kC; item += kThreads) {
      float s = 0.f;
      int t, i;
      if (item < 4 * 120) {
        const int b = item / 120, p = item % 120;
        int tl = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
        if (tl * (tl - 1) / 2 > p) --tl;
        if ((tl + 1) * tl / 2 <= p) ++tl;
        t = 16 * b + tl;
        i = 16 * b + (p - tl * (tl - 1) / 2);
        // the decay from token i + 1 to t - 1: P_t - P_{i+1}, both in
        // sub-chunk b
        const float4* rr = reinterpret_cast<const float4*>(rs + t * kLD);
        const float4* kk = reinterpret_cast<const float4*>(ks + i * kLD);
        const float4* tph = reinterpret_cast<const float4*>(phi + t * kLD);
        const float4* tpl = reinterpret_cast<const float4*>(plo + t * kLD);
        const float4* iph =
            reinterpret_cast<const float4*>(phi + (i + 1) * kLD);
        const float4* ipl =
            reinterpret_cast<const float4*>(plo + (i + 1) * kLD);
        float s1 = 0.f;
#pragma unroll 4
        for (int q = 0; q < kD / 4; ++q) {
          const float4 r4 = rr[q], k4 = kk[q], h1 = tph[q], l1 = tpl[q],
                       h0 = iph[q], l0 = ipl[q];
          s = fmaf(r4.x * k4.x, ex2((h1.x - h0.x) + (l1.x - l0.x)), s);
          s1 = fmaf(r4.y * k4.y, ex2((h1.y - h0.y) + (l1.y - l0.y)), s1);
          s = fmaf(r4.z * k4.z, ex2((h1.z - h0.z) + (l1.z - l0.z)), s);
          s1 = fmaf(r4.w * k4.w, ex2((h1.w - h0.w) + (l1.w - l0.w)), s1);
        }
        s += s1;
      } else {
        t = i = item - 4 * 120;
        for (int d = 0; d < kD; ++d)
          s = fmaf(rs[t * kLD + d] * us[d], ks[t * kLD + d], s);
      }
      as[t * kLD + i] = s;
    }
    for (int e = tid; e < 4 * 256; e += kThreads) {
      const int b = e >> 8, tl = (e >> 4) & 15, il = e & 15;
      if (il > tl) as[(16 * b + tl) * kLD + 16 * b + il] = 0.f;
    }
    __syncthreads();

    // 4. r decayed to its sub-chunk's start (by P_t), k to its sub-chunk's
    // end (by T_b - P_{t+1}), and the per-channel scales from the totals
    // of the sub-chunks they span
    for (int e = tid; e < kC * kD; e += kThreads) {
      const int t = e >> 6, d = e & 63, b = t >> 4;
      rs[t * kLD + d] *= ex2(phi[t * kLD + d] + plo[t * kLD + d]);
      if ((t & 15) != 15)
        ks[t * kLD + d] *= ex2((Th[b * kD + d] - phi[(t + 1) * kLD + d]) +
                               (Tl[b * kD + d] - plo[(t + 1) * kLD + d]));
    }
    // sum_{b0 <= c < b1} T_c for channel d
    auto span = [&](int b0, int b1, int d) {
      float h = 0.f, l = 0.f;
      for (int cc = b0; cc < b1; ++cc) {
        h += Th[cc * kD + d];
        l += Tl[cc * kD + d];
      }
      return h + l;
    };
    for (int e = tid; e < 15 * kD; e += kThreads) {
      const int row = e >> 6, d = e & 63;
      if (row < 4) {
        Eb[row * kD + d] = ex2(span(0, row, d));
      } else if (row < 8) {
        Fa[(row - 4) * kD + d] = ex2(span(row - 3, 4, d));
      } else if (row < 14) {
        // pair (b, a), b > a, numbered b (b - 1) / 2 + a
        const int pr = row - 8;
        const int b = pr < 1 ? 1 : (pr < 3 ? 2 : 3);
        const int a = pr - b * (b - 1) / 2;
        Dp[pr * kD + d] = ex2(span(a + 1, b, d));
      } else {
        dec[d] = ex2(span(0, 4, d));
      }
    }
    __syncthreads();

    // 5. the six off-diagonal score blocks, two 16 x 8 tiles each, on the
    // tensor cores: A[t, i] = sum_d (r~_td Dp_ba,d) k~_id
    for (int tile = warp; tile < 12; tile += 8) {
      const int pr = tile >> 1, nt = tile & 1;
      const int b = pr < 1 ? 1 : (pr < 3 ? 2 : 3);
      const int a = pr - b * (b - 1) / 2;
      const float* ra = rs + (16 * b + g) * kLD;
      const float* kb = ks + (16 * a + 8 * nt + g) * kLD;
      const float* sc = Dp + pr * kD;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < kD / 8; ++kq) {
        const int d0 = 8 * kq + tig, d1 = d0 + 4;
        const float s0 = sc[d0], s1 = sc[d1];
        const float af[4] = {ra[d0] * s0, ra[8 * kLD + d0] * s0,
                             ra[d1] * s1, ra[8 * kLD + d1] * s1};
        const float bf[2] = {kb[d0], kb[d1]};
        mma3(acc, af, bf);
      }
      float* dst = as + (16 * b + g) * kLD + 16 * a + 8 * nt + 2 * tig;
      dst[0] = acc[0];
      dst[1] = acc[1];
      dst[8 * kLD] = acc[2];
      dst[8 * kLD + 1] = acc[3];
    }
    __syncthreads();

    // 6. this warp's 8 output columns: o = (r~ E) S0 + A v, then the state
    float o[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < kD / 8; ++kq) {
      // S0 rows d = 8 kq + tig (+4), column j0 + g, from the accumulators:
      // row 8 kq + x lives in st[kq >> 1][2 (kq & 1) + (j & 1)] of lane
      // 4 x + (j >> 1)
      const int md = kq >> 1, hf = kq & 1;
      const int src0 = 4 * tig + (g >> 1), src1 = 4 * (tig + 4) + (g >> 1);
      const float e0 = __shfl_sync(0xffffffffu, st[md][2 * hf], src0);
      const float o0 = __shfl_sync(0xffffffffu, st[md][2 * hf + 1], src0);
      const float e1 = __shfl_sync(0xffffffffu, st[md][2 * hf], src1);
      const float o1 = __shfl_sync(0xffffffffu, st[md][2 * hf + 1], src1);
      const float bf[2] = {(g & 1) ? o0 : e0, (g & 1) ? o1 : e1};
      const int d0 = 8 * kq + tig, d1 = d0 + 4;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ra = rs + (16 * mt + g) * kLD;
        const float s0 = Eb[mt * kD + d0], s1 = Eb[mt * kD + d1];
        const float af[4] = {ra[d0] * s0, ra[8 * kLD + d0] * s0,
                             ra[d1] * s1, ra[8 * kLD + d1] * s1};
        mma3(o[mt], af, bf);
      }
    }
    // scores times v over the lower triangle, and the state update, which
    // shares its B fragments (v rows i = 8 kq + tig (+4), column j0 + g)
    float sn[4][4];
#pragma unroll
    for (int md = 0; md < 4; ++md) {
      const float d_lo = dec[16 * md + g], d_hi = dec[16 * md + g + 8];
      sn[md][0] = st[md][0] * d_lo;
      sn[md][1] = st[md][1] * d_lo;
      sn[md][2] = st[md][2] * d_hi;
      sn[md][3] = st[md][3] * d_hi;
    }
#pragma unroll
    for (int kq = 0; kq < kC / 8; ++kq) {
      const int i0 = 8 * kq + tig, i1 = i0 + 4;
      const float bf[2] = {vs[i0 * kLDV + j0 + g], vs[i1 * kLDV + j0 + g]};
#pragma unroll
      for (int mt = kq >> 1; mt < 4; ++mt) {
        const float* ar = as + (16 * mt + g) * kLD;
        const float af[4] = {ar[i0], ar[8 * kLD + i0], ar[i1],
                             ar[8 * kLD + i1]};
        mma3(o[mt], af, bf);
      }
      const int a = kq >> 1;  // sub-chunk of rows i0, i1
      const float* k0 = ks + i0 * kLD;
      const float* k1 = ks + i1 * kLD;
#pragma unroll
      for (int md = 0; md < 4; ++md) {
        const int dl = 16 * md + g, dh = dl + 8;
        const float f_lo = Fa[a * kD + dl], f_hi = Fa[a * kD + dh];
        const float af[4] = {k0[dl] * f_lo, k0[dh] * f_hi, k1[dl] * f_lo,
                             k1[dh] * f_hi};
        mma3(sn[md], af, bf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int t = 16 * mt + g;
      const int j = j0 + 2 * tig;
      if (t < ce)
        *reinterpret_cast<float2*>(out + base + (t0 + t) * kD + j) =
            make_float2(o[mt][0], o[mt][1]);
      if (t + 8 < ce)
        *reinterpret_cast<float2*>(out + base + (t0 + t + 8) * kD + j) =
            make_float2(o[mt][2], o[mt][3]);
    }
#pragma unroll
    for (int md = 0; md < 4; ++md)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[md][e] = sn[md][e];
  }

  float* so = state_out + bh * kD * kD;
#pragma unroll
  for (int md = 0; md < 4; ++md) {
    const int d = 16 * md + g, j = j0 + 2 * tig;
    *reinterpret_cast<float2*>(so + d * kD + j) = make_float2(st[md][0], st[md][1]);
    *reinterpret_cast<float2*>(so + (d + 8) * kD + j) =
        make_float2(st[md][2], st[md][3]);
  }
}

}  // namespace

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  r, k, v, logw, out: (BH, S, D) float32, contiguous;
// u: (H, D) with BH a multiple of H (row bh reads u[bh % H]); state:
// (BH, D, D) float32, the state after the last token, from a zero state.
// Refused unless D and C are the 64 compiled here (kernels/linattn/ops.py
// ::linattn_route); out and state must be 8-byte aligned.
extern "C" int rwkv_linattn_tc_launch(
    const float* r, const float* k, const float* v, const float* logw,
    const float* u, float* out, float* state, int BH, int S, int D, int H,
    int C, void* stream) {
  if (BH < 1 || S < 1 || H < 1 || BH % H != 0 || D != kD || C != kC ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(state) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rwkv_linattn_tc_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<BH, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, logw, u, out, state, S, H);
  return static_cast<int>(cudaGetLastError());
}
