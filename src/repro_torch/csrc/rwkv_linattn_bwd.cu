// Backward of the RWKV6 linear attention from a zero state: the gradient
// of the exact recurrence
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),     w = exp(logw),
//
// for r, k, v, logw and u, given the gradients of the outputs (dout) and
// of the final state (dstate), either of which may be absent (zero).  With
// G_t the gradient reaching S_t (G_{S-1} = dstate):
//
//   G_{t-1}   = diag(w_t) G_t + r_t^T do_t,
//   dr_t      = (S_{t-1} + diag(u) k_t^T v_t) do_t^T,
//   dk_t[d]   = sum_e G_t[d][e] v_t[e] + u[d] r_t[d] (v_t . do_t),
//   dv_t[e]   = sum_d k_t[d] (G_t[d][e] + u[d] r_t[d] do_t[e]),
//   dlogw_t   = w_t * sum_e S_{t-1} * G_t,
//   du[d]     = sum_t r_t[d] k_t[d] (v_t . do_t), summed over the rows of
//               each head (u (H, D): row bh reads u[bh % H]) or over every
//               row (u (D,)).
//
// Replaces no TPU kernel: the reference differentiates rwkv_scan
// (src/repro/models/rwkv.py) with jax.grad and has no Pallas backward.  It
// takes the plain backward -- autograd through the token loop of
// kernels/linattn/ref.py::rwkv_linattn_ref -- off the card's training
// paths.
//
// The reverse sweep needs S_{t-1} in reverse order.  A state a token would
// be B H S D^2 floats, and S_{t-1} = (S_t - k_t^T v_t) / w_t is not
// computable where w underflows.  So kernel 1 (rwkv_bwd_forward_kernel)
// sweeps forward, writing the state at every chunk boundary to a
// checkpoint scratch (ceil(S / C) states a row) and, since dr and du need
// only forward-order states, those gradients as well; kernel 2
// (rwkv_bwd_reverse_kernel) walks the chunks backwards, recomputes each
// chunk's C states from its checkpoint into a second scratch (C states a
// row) and sweeps the chunk's tokens backwards carrying G.  The wrapper
// takes C ~ sqrt(S), so both scratches are O(sqrt(S) D^2) floats a row.
//
// One block a row (b, h), 4 D threads: thread (d, part) owns row d,
// columns [part D/4, (part + 1) D/4) of S and of G in registers -- each
// column of the state evolves on its own and each row is scaled by its
// own w_t[d], so the updates need nothing from other threads.  The sums
// over e (dr, dk, dlogw) are a thread's own columns and two shuffles
// among the 4 lanes of its row; the sum over d (dv) goes through a
// double-buffered shared tile, one barrier a token, summed in a fixed
// order.  A chunk's token vectors are staged in shared memory once.  No
// atomics: reruns are bitwise equal.
//
// What bounds it: 18 flops a token and state entry (kernel 1: the state
// update and dr; kernel 2: the recompute, dk, dlogw, dv and the G update)
// against r, k, v, logw, dout and four gradients moved once -- at the
// training shape (40 rows of 128 tokens, D 64) the operations, on the CUDA
// cores in float32.  At that shape only 40 of the 132 SMs hold a block and
// each token is a sequential step: the latency of a step, not the rate,
// is what this first version is limited by.

#include "common.cuh"

namespace {

constexpr int kParts = 4;           // threads a state row

// the 4 lanes of a row (consecutive lanes) summed
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// a chunk's n tokens of the (BH, S, D) rows r, k, v, w = exp(logw), dout
// (0 where dout is null) into shared memory [n][D] each
template <int D>
__device__ __forceinline__ void stage_chunk(
    float* rs, float* ks, float* vs, float* ws, float* dos, const float* r,
    const float* k, const float* v, const float* logw, const float* dout,
    long long base, int n) {
  for (int e = threadIdx.x; e < n * D; e += kParts * D) {
    const long long g = base + e;
    rs[e] = r[g];
    ks[e] = k[g];
    vs[e] = v[g];
    ws[e] = expf(logw[g]);
    dos[e] = dout ? dout[g] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kParts * D) rwkv_bwd_forward_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u,       // (H, D)
    const float* __restrict__ dout,    // (BH, S, D) or null
    float* __restrict__ dr,            // (BH, S, D)
    float* __restrict__ du_rows,       // (BH, D)
    float* __restrict__ ck,            // (BH, ceil(S / C), D, D)
    int S, int H, int C) {
  constexpr int EP = D / kParts;
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + C * D;
  float* vs = ks + C * D;
  float* ws = vs + C * D;
  float* dos = ws + C * D;

  const int bh = blockIdx.x;
  const int d = threadIdx.x / kParts, part = threadIdx.x % kParts;
  const int e0 = part * EP;
  const int nck = (S + C - 1) / C;
  const float ud = u[(bh % H) * D + d];
  const long long row = static_cast<long long>(bh) * S * D;

  float st[EP];
#pragma unroll
  for (int i = 0; i < EP; ++i) st[i] = 0.f;
  float du_acc = 0.f;
  for (int c = 0; c < nck; ++c) {
    const int c0 = c * C, n = min(C, S - c0);
    float* ckp = ck + ((static_cast<long long>(bh) * nck + c) * D + d) * D +
                 e0;
#pragma unroll
    for (int i = 0; i < EP; ++i) ckp[i] = st[i];
    __syncthreads();              // the last chunk's readers are done
    stage_chunk<D>(rs, ks, vs, ws, dos, r, k, v, logw, dout,
                   row + static_cast<long long>(c0) * D, n);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* vt = vs + t * D;
      const float* dot = dos + t * D;
      float sdo = 0.f, vdo = 0.f;
#pragma unroll
      for (int i = 0; i < EP; ++i) {
        sdo = fmaf(st[i], dot[e0 + i], sdo);
        vdo = fmaf(vt[e0 + i], dot[e0 + i], vdo);
      }
      sdo = row_sum(sdo);
      vdo = row_sum(vdo);
      const float kd = ks[t * D + d], rd = rs[t * D + d];
      const float wd = ws[t * D + d];
      if (part == 0) {
        dr[row + static_cast<long long>(c0 + t) * D + d] =
            fmaf(ud * kd, vdo, sdo);
        du_acc = fmaf(rd * kd, vdo, du_acc);
      }
#pragma unroll
      for (int i = 0; i < EP; ++i) st[i] = fmaf(wd, st[i], kd * vt[e0 + i]);
    }
  }
  if (part == 0) du_rows[static_cast<long long>(bh) * D + d] = du_acc;
}

template <int D>
__global__ void __launch_bounds__(kParts * D) rwkv_bwd_reverse_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u,        // (H, D)
    const float* __restrict__ dout,     // (BH, S, D) or null
    const float* __restrict__ dstate,   // (BH, D, D) or null
    const float* __restrict__ ck,       // (BH, ceil(S / C), D, D)
    const float* __restrict__ du_rows,  // (BH, D), from kernel 1
    float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dlogw,          // (BH, S, D) each
    float* __restrict__ du,             // (H, D)
    float* __restrict__ states,         // (BH, C, D, D) scratch
    int BH, int S, int H, int C) {
  constexpr int EP = D / kParts;
  constexpr int RS = D + 1;             // row stride of the dv tile
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + C * D;
  float* vs = ks + C * D;
  float* ws = vs + C * D;
  float* dos = ws + C * D;
  float* red = dos + C * D;             // [2][D][D + 1]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int d = tid / kParts, part = tid % kParts;
  const int e0 = part * EP;
  const int nck = (S + C - 1) / C;
  const float ud = u[(bh % H) * D + d];
  const long long row = static_cast<long long>(bh) * S * D;
  float* mine = states + (static_cast<long long>(bh) * C * D + d) * D + e0;

  float g[EP];
#pragma unroll
  for (int i = 0; i < EP; ++i)
    g[i] = dstate ? dstate[(static_cast<long long>(bh) * D + d) * D + e0 + i]
                  : 0.f;
  int buf = 0;
  for (int c = nck - 1; c >= 0; --c) {
    const int c0 = c * C, n = min(C, S - c0);
    __syncthreads();              // the last chunk's readers are done
    stage_chunk<D>(rs, ks, vs, ws, dos, r, k, v, logw, dout,
                   row + static_cast<long long>(c0) * D, n);
    __syncthreads();
    // the chunk's states S_{t-1}, recomputed from its checkpoint
    float st[EP];
    const float* ckp =
        ck + ((static_cast<long long>(bh) * nck + c) * D + d) * D + e0;
#pragma unroll
    for (int i = 0; i < EP; ++i) st[i] = ckp[i];
    for (int t = 0; t < n; ++t) {
      float* at = mine + static_cast<long long>(t) * D * D;
#pragma unroll
      for (int i = 0; i < EP; ++i) at[i] = st[i];
      if (t + 1 < n) {
        const float kd = ks[t * D + d], wd = ws[t * D + d];
#pragma unroll
        for (int i = 0; i < EP; ++i)
          st[i] = fmaf(wd, st[i], kd * vs[t * D + e0 + i]);
      }
    }
    // the chunk's tokens backwards, G = G_t on entry to step t
    for (int t = n - 1; t >= 0; --t) {
      const float* at = mine + static_cast<long long>(t) * D * D;
#pragma unroll
      for (int i = 0; i < EP; ++i) st[i] = at[i];
      const float* vt = vs + t * D;
      const float* dot = dos + t * D;
      const float kd = ks[t * D + d], rd = rs[t * D + d];
      const float wd = ws[t * D + d];
      float gv = 0.f, sg = 0.f, vdo = 0.f;
#pragma unroll
      for (int i = 0; i < EP; ++i) {
        gv = fmaf(g[i], vt[e0 + i], gv);
        sg = fmaf(st[i], g[i], sg);
        vdo = fmaf(vt[e0 + i], dot[e0 + i], vdo);
      }
      gv = row_sum(gv);
      sg = row_sum(sg);
      vdo = row_sum(vdo);
      const long long out_at = row + static_cast<long long>(c0 + t) * D;
      if (part == 0) {
        dk[out_at + d] = fmaf(ud * rd, vdo, gv);
        dlogw[out_at + d] = wd * sg;
      }
      const float urd = ud * rd;
      float* tile = red + buf * D * RS;
#pragma unroll
      for (int i = 0; i < EP; ++i)
        tile[d * RS + e0 + i] = kd * fmaf(urd, dot[e0 + i], g[i]);
      __syncthreads();
      if (tid < D) {
        float s = 0.f;
        for (int dd = 0; dd < D; ++dd) s += tile[dd * RS + tid];
        dv[out_at + tid] = s;
      }
      buf ^= 1;
#pragma unroll
      for (int i = 0; i < EP; ++i) g[i] = fmaf(wd, g[i], rd * dot[e0 + i]);
    }
  }
  // du: the rows of head bh (of every row when H = 1), in order
  if (bh < H && part == 0) {
    float s = 0.f;
    for (int rr = bh; rr < BH; rr += H)
      s += du_rows[static_cast<long long>(rr) * D + d];
    du[static_cast<long long>(bh) * D + d] = s;
  }
}

size_t forward_smem(int D, int C) { return 5ull * C * D * sizeof(float); }
size_t reverse_smem(int D, int C) {
  return (5ull * C * D + 2ull * D * (D + 1)) * sizeof(float);
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem > rt::kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D>
int forward_typed(const float* r, const float* k, const float* v,
                  const float* logw, const float* u, const float* dout,
                  float* dr, float* du_rows, float* ck, int BH, int S, int H,
                  int C, cudaStream_t stream) {
  const size_t smem = forward_smem(D, C);
  auto kern = rwkv_bwd_forward_kernel<D>;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<BH, kParts * D, smem, stream>>>(r, k, v, logw, u, dout, dr,
                                         du_rows, ck, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int reverse_typed(const float* r, const float* k, const float* v,
                  const float* logw, const float* u, const float* dout,
                  const float* dstate, const float* ck,
                  const float* du_rows, float* dk, float* dv, float* dlogw,
                  float* du, float* states, int BH, int S, int H, int C,
                  cudaStream_t stream) {
  const size_t smem = reverse_smem(D, C);
  auto kern = rwkv_bwd_reverse_kernel<D>;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<BH, kParts * D, smem, stream>>>(r, k, v, logw, u, dout, dstate, ck,
                                         du_rows, dk, dv, dlogw, du, states,
                                         BH, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int BH, int S, int D, int H, int C) {
  return BH < 1 || S < 1 || H < 1 || BH % H != 0 || C < 1 || C > 64 ||
         (D != 16 && D != 32 && D != 64);
}

}  // namespace

// Kernel 1.  Launch on `stream`; allocates nothing, does not synchronise,
// returns cudaGetLastError().  r, k, v, logw: (BH, S, D) float32,
// contiguous, rows ordered b * H + h; u: (H, D); dout: (BH, S, D) or null
// (zero); writes dr (BH, S, D), du_rows (BH, D) and the checkpoints ck
// (BH, ceil(S / C), D, D).  D one of 16, 32, 64; 1 <= C <= 64.
extern "C" int rwkv_linattn_bwd_forward_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* dout, void* dr, void* du_rows, void* ck,
    int BH, int S, int D, int H, int C, void* stream) {
  if (bad_args(BH, S, D, H, C)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (D) {
    case 16: return forward_typed<16>(f(r), f(k), f(v), f(logw), f(u), f(dout), m(dr), m(du_rows), m(ck), BH, S, H, C, st);
    case 32: return forward_typed<32>(f(r), f(k), f(v), f(logw), f(u), f(dout), m(dr), m(du_rows), m(ck), BH, S, H, C, st);
    default: return forward_typed<64>(f(r), f(k), f(v), f(logw), f(u), f(dout), m(dr), m(du_rows), m(ck), BH, S, H, C, st);
  }
}

// Kernel 2, after kernel 1 on the same stream (reads its ck and du_rows).
// dstate: (BH, D, D) or null (zero); writes dk, dv, dlogw (BH, S, D), du
// (H, D) and the scratch states (BH, C, D, D).
extern "C" int rwkv_linattn_bwd_reverse_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* dout, const void* dstate, const void* ck,
    const void* du_rows, void* dk, void* dv, void* dlogw, void* du,
    void* states, int BH, int S, int D, int H, int C, void* stream) {
  if (bad_args(BH, S, D, H, C)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (D) {
    case 16: return reverse_typed<16>(f(r), f(k), f(v), f(logw), f(u), f(dout), f(dstate), f(ck), f(du_rows), m(dk), m(dv), m(dlogw), m(du), m(states), BH, S, H, C, st);
    case 32: return reverse_typed<32>(f(r), f(k), f(v), f(logw), f(u), f(dout), f(dstate), f(ck), f(du_rows), m(dk), m(dv), m(dlogw), m(du), m(states), BH, S, H, C, st);
    default: return reverse_typed<64>(f(r), f(k), f(v), f(logw), f(u), f(dout), f(dstate), f(ck), f(du_rows), m(dk), m(dv), m(dlogw), m(du), m(states), BH, S, H, C, st);
  }
}
