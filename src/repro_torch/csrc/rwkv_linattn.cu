// Chunked RWKV-6 linear attention with per-channel data-dependent decay:
// one thread block per (batch, head) row walks the sequence chunk by
// chunk, with the (D, D) float32 recurrent state in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/linattn/linattn.py::rwkv_linattn_pallas.
// There the grid was (BH, S / C) with the chunk axis run in order on one
// core and the state kept in VMEM scratch between grid steps; here the
// chunk loop runs inside the block and the state never leaves shared
// memory until the last chunk.  The same chunked form:
//
//   o_t = (r_t * e^{logA_prev[t]}) S0                     (inter-chunk)
//       + sum_{i<t} [sum_d r_td k_id e^{logA_prev[t,d] - logA[i,d]}] v_i
//       + (r_t . (u * k_t)) v_t                            (bonus)
//   S   = diag(e^{logA[C-1]}) S0 + sum_i (k_i * e^{logA[C-1] - logA[i]})^T v_i
//
// with logA the in-chunk cumulative log decay and logA_prev = logA - logw.
// Every exponent is <= 0 (logw <= 0), so nothing overflows however strong
// the decay; the pairwise (C, C, D) decay tensor is never built -- each
// score is a D-long loop over channels.  Differences from the Pallas
// kernel: u is per head ((H, D), row bh % H; a (D,) u is H = 1), and S
// need not be a multiple of C: the short last chunk is zero-padded in
// shared memory (r = k = v = 0, logw = 0), which leaves the state exactly
// unchanged, and its padded outputs are not stored.
//
// What bounds it: the operations -- per chunk and head C^2 D / 2
// exponentials and FMAs for the scores, 2 C D^2 FMAs for the inter-chunk
// product and the state update, C^2 D / 2 for scores times v -- against
// ~16 bytes read and 4 written per element; at C = D = 64 that is ~200
// flops a byte, so the float32 rate of the CUDA cores bounds it.
//
// What the design does about it: the chunk's r, k, v and log decays sit
// in shared memory with an odd row stride (conflict-free column walks);
// the exponentials of the inter-chunk and state terms are folded into r
// and k once per chunk (C D of them instead of C D^2); each output and
// state entry is one thread's register sum.
//
// This is the `simt` route of kernels/linattn/ops.py::rwkv_linattn: head
// dims 16 and 32, and chunks shorter than 64 tokens.  Head dim 64 with
// 64-token chunks -- every RWKV6 prefill -- takes the `tc` route
// (rwkv_linattn_tc.cu, the three matrix terms on the tensor cores).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int D>
__global__ void __launch_bounds__(kThreads) rwkv_linattn_kernel(
    const float* __restrict__ r,      // (BH, S, D)
    const float* __restrict__ k,      // (BH, S, D)
    const float* __restrict__ v,      // (BH, S, D)
    const float* __restrict__ logw,   // (BH, S, D), <= 0
    const float* __restrict__ u,      // (H, D)
    float* __restrict__ out,          // (BH, S, D)
    float* __restrict__ state_out,    // (BH, D, D)
    int S, int H, int C) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* rs = smem;                 // r, then r * e^{logA_prev}
  float* ks = rs + C * LD;          // k, then k * e^{logA[C-1] - logA}
  float* vs = ks + C * LD;
  float* la = vs + C * LD;          // logA (inclusive cumulative sum)
  float* lp = la + C * LD;          // logw, then logA_prev
  float* st = lp + C * LD;          // state (D, D)
  float* att = st + D * D;          // scores (C, C + 1)
  float* coeff = att + C * (C + 1); // bonus coefficients (C)
  float* us = coeff + C;            // u of this head (D)

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const long long base = bh * S * D;

  for (int e = tid; e < D * D; e += kThreads) st[e] = 0.f;
  for (int d = tid; d < D; d += kThreads) us[d] = u[h * D + d];

  const int nc = (S + C - 1) / C;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C;
    const int ce = min(C, S - t0);
    __syncthreads();                // last chunk's state update is done
    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, d = e % D;
      const bool ok = t < ce;
      const long long g = base + static_cast<long long>(t0 + t) * D + d;
      rs[t * LD + d] = ok ? r[g] : 0.f;
      ks[t * LD + d] = ok ? k[g] : 0.f;
      vs[t * LD + d] = ok ? v[g] : 0.f;
      lp[t * LD + d] = ok ? logw[g] : 0.f;
    }
    __syncthreads();

    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
      for (int t = 0; t < C; ++t) {
        const float w = lp[t * LD + d];
        a += w;
        la[t * LD + d] = a;
        lp[t * LD + d] = a - w;
      }
    }
    __syncthreads();

    // intra-chunk scores, strictly lower triangle; exponents <= 0
    for (int e = tid; e < C * C; e += kThreads) {
      const int t = e / C, i = e % C;
      float a = 0.f;
      if (i < t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          a = fmaf(rs[t * LD + d] * ks[i * LD + d],
                   expf(lp[t * LD + d] - la[i * LD + d]), a);
      }
      att[t * (C + 1) + i] = a;
    }
    for (int t = tid; t < C; t += kThreads) {
      float b = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        b = fmaf(rs[t * LD + d] * us[d], ks[t * LD + d], b);
      coeff[t] = b;
    }
    __syncthreads();

    const float* la_last = la + (C - 1) * LD;
    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, d = e % D;
      rs[t * LD + d] *= expf(lp[t * LD + d]);
      ks[t * LD + d] *= expf(la_last[d] - la[t * LD + d]);
    }
    __syncthreads();

    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, j = e % D;
      if (t >= ce) continue;
      float o = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) o = fmaf(rs[t * LD + d], st[d * D + j], o);
      for (int i = 0; i < t; ++i) o = fmaf(att[t * (C + 1) + i], vs[i * LD + j], o);
      o = fmaf(coeff[t], vs[t * LD + j], o);
      out[base + static_cast<long long>(t0 + t) * D + j] = o;
    }
    __syncthreads();                // every output has read the old state

    for (int e = tid; e < D * D; e += kThreads) {
      const int d = e / D, j = e % D;
      float s = expf(la_last[d]) * st[e];
      for (int i = 0; i < C; ++i) s = fmaf(ks[i * LD + d], vs[i * LD + j], s);
      st[e] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < D * D; e += kThreads) state_out[bh * D * D + e] = st[e];
}

template <int D>
int launch_dim(const float* r, const float* k, const float* v,
               const float* logw, const float* u, float* out, float* state,
               int BH, int S, int H, int C, cudaStream_t stream) {
  const size_t smem =
      (5 * static_cast<size_t>(C) * (D + 1) + D * D + C * (C + 1) + C + D) *
      sizeof(float);
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rwkv_linattn_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<BH, kThreads, smem, stream>>>(r, k, v, logw, u, out, state, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  r, k, v, logw, out: (BH, S, D) float32, contiguous;
// u: (H, D) with BH a multiple of H (row bh reads u[bh % H]); state:
// (BH, D, D) float32, the state after the last token, from a zero state.
// D one of 16, 32, 64; 1 <= C <= 64 tokens per chunk.
extern "C" int rwkv_linattn_launch(
    const float* r, const float* k, const float* v, const float* logw,
    const float* u, float* out, float* state, int BH, int S, int D, int H,
    int C, void* stream) {
  if (BH < 1 || S < 1 || H < 1 || BH % H != 0 || C < 1 || C > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dim<16>(r, k, v, logw, u, out, state, BH, S, H, C, st);
    case 32: return launch_dim<32>(r, k, v, logw, u, out, state, BH, S, H, C, st);
    case 64: return launch_dim<64>(r, k, v, logw, u, out, state, BH, S, H, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
