// Backward of causal / sliding-window softmax attention with grouped-query
// heads: dq, dk, dv from q, k, v and the output's gradient dout, in two
// kernels and without atomics.
//
// Replaces no TPU kernel: the reference differentiates its pure-JAX
// chunked_attention (src/repro/models/attention.py) with jax.grad and has
// no Pallas backward.  It takes the plain backward -- autograd through
// kernels/flash/ref.py::mha_ref, which holds the whole (B H, S, Skv)
// float32 score and probability matrices -- off the card's training
// paths.  Like the reference's rematerialised chunks, only tiles of the
// scores are ever live.
//
// The semantics are mha_ref's: float32 inside whatever the input type, q
// scaled by `scale` before the product, masked scores at -1e30 (they get
// no gradient), and a query row with no unmasked key has output 0 and
// gets zero gradients.  With p = softmax(s) and ds = p (dp - delta),
// dp = dout v^T, delta = rowsum(p dp):
//   dq = scale ds k,   dk = scale ds^T q,   dv = p^T dout.
//
// Kernel 1 (flash_bwd_dq_kernel), one block per 64-row query tile of one
// (batch, head): a first pass over the tile's keys keeps each row's
// running maximum m, sum l = sum exp(s - m) and u = sum exp(s - m) dp,
// rescaled as the maximum moves (the forward kernels write no
// log-sum-exp), so that lse = m + log l and delta = u / l -- in float32
// from the scores themselves, not from the saved output, whose bf16
// rounding (and, on the tensor-core route, that of p) put half the
// elementwise bound into the gradients at head dim 256 -- go to a float32
// scratch; a second pass forms dq.  Kernel 2 (flash_bwd_dkv_kernel), one block per key tile of one
// (batch, KV head): dk and dv summed over the G = H / KV query heads that
// read the tile and over the query tiles that see it, in registers, and
// rounded to the output type once, after that sum.  Every sum runs in a
// fixed order, so reruns are bitwise equal.
//
// What bounds it: at the training shapes (S = 128, D = 128, bf16) the
// backward does 5 (two passes) + 4 products of 2 D flops per unmasked
// pair -- 18 D flops a pair -- against q, k, v, dout and the three
// gradients moved once: ~200 flops a byte, above the card's balance
// point for the CUDA cores, so the bound is the operations.  This first
// version is float32 FMAs on the CUDA cores (no tensor cores): each thread
// owns a 4 x 4 block of a 64 x 64 score tile (2 x 2 of a 32 x 32 tile at
// head dim 256, whose four 32 x 256 float32 tiles fill the shared memory)
// and a slice of its accumulators; every tile is stored with an odd row
// stride, so the row-wise and column-wise reads are free of bank
// conflicts.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// query rows and keys per tile at head dim D
template <int D>
__host__ __device__ constexpr int tile() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t dq_smem_floats() {
  // q, dout, k, v [T][D + 1]; ds [T][T + 1]; lse, delta [T]
  return 4 * tile<D>() * (D + 1) + tile<D>() * (tile<D>() + 1) +
         2 * tile<D>();
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // k, v, q, dout [T][D + 1]; p, ds [T][T + 1]; lse, delta [T]
  return 4 * tile<D>() * (D + 1) + 2 * tile<D>() * (tile<D>() + 1) +
         2 * tile<D>();
}

__device__ __forceinline__ bool kept(int qr, int kc, int S, int Skv,
                                     int causal, int window) {
  bool ok = qr < S && kc < Skv;
  if (causal) ok = ok && qr >= kc;
  if (window >= 0) ok = ok && qr - kc < window;
  return ok;
}

// rows [0, T) of a (rows, D) tile starting at row `s0` of a tensor whose
// row stride is `pos`, times `mul`, into shared memory of row stride D + 1;
// rows at or past `n` are 0
template <typename T, int D, int TILE>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int s0,
                                          int n, long long pos, float mul) {
  for (int e = threadIdx.x; e < TILE * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = s0 + r;
    dst[r * (D + 1) + d] = s < n ? to_f32(src[s * pos + d]) * mul : 0.f;
  }
}

// sc[i][j] = sum_d a[row i] b[col j], thread (ty, tx) owning rows
// ty * R + i and columns tx + 16 j of two tiles of row stride D + 1
template <int D, int R, int C>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&sc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) sc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty * R + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q,      // (B, S, H, D)
    const T* __restrict__ k,      // (B, Skv, KV, D)
    const T* __restrict__ v,      // (B, Skv, KV, D)
    const T* __restrict__ dout,   // (B, S, H, D)
    T* __restrict__ dq,           // (B, S, H, D)
    float* __restrict__ lse,      // (B H, S)
    float* __restrict__ delta,    // (B H, S)
    int S, int Skv, int H, int KV, float scale, int causal, int window) {
  constexpr int TQ = tile<D>(), TK = tile<D>();
  constexpr int DS = D + 1, PS = TK + 1;
  constexpr int R = TQ / 16, C = TK / 16, CC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                 // scaled q tile
  float* dos = qs + TQ * DS;        // dout tile
  float* ks = dos + TQ * DS;        // k tile
  float* vs = ks + TK * DS;         // v tile
  float* dss = vs + TK * DS;        // ds of the tile
  float* lse_s = dss + TQ * PS;     // the tile's rows' lse and delta
  float* delta_s = lse_s + TQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;

  const long long q_pos = static_cast<long long>(H) * D;
  const long long kv_pos = static_cast<long long>(KV) * D;
  const long long q_off = (static_cast<long long>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * D;

  load_tile<T, D, TQ>(qs, q + q_off, q0, S, q_pos, scale);
  load_tile<T, D, TQ>(dos, dout + q_off, q0, S, q_pos, 1.f);

  const int nk = (Skv + TK - 1) / TK;
  const int kj_end = causal ? min(nk, (q0 + TQ - 1) / TK + 1) : nk;

  // pass 1: each row's running maximum m, l = sum exp(s - m) and
  // u = sum exp(s - m) dp over its unmasked keys
  float m[R], l[R], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    u[i] = 0.f;
  }
  for (int kj = 0; kj < kj_end; ++kj) {
    const int k0 = kj * TK;
    if (window >= 0 && !(k0 + TK - 1 > q0 - window)) continue;
    __syncthreads();
    load_tile<T, D, TK>(ks, kb, k0, Skv, kv_pos, 1.f);
    load_tile<T, D, TK>(vs, vb, k0, Skv, kv_pos, 1.f);
    __syncthreads();
    float sc[R][C], dp[R][C];
    tile_dot<D, R, C>(qs, ks, ty, tx, sc);
    tile_dot<D, R, C>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = q0 + ty * R + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (!kept(qr, k0 + tx + 16 * j, S, Skv, causal, window))
          sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f, ru = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float e = sc[i][j] == kNegInf ? 0.f : expf(sc[i][j] - m_new);
        rs += e;
        ru = fmaf(e, dp[i][j], ru);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
        ru += __shfl_xor_sync(0xffffffffu, ru, off);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      u[i] = u[i] * corr + ru;
      m[i] = m_new;
    }
  }
  // lse and delta of each row (a row without a key keeps l = 0: its p is
  // 0 wherever it is read, since every one of its scores is masked, and
  // its delta 0)
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      const float row_lse = m[i] + logf(fmaxf(l[i], 1e-30f));
      const float row_delta = l[i] > 0.f ? u[i] / l[i] : 0.f;
      lse_s[r] = row_lse;
      delta_s[r] = row_delta;
      if (q0 + r < S) {
        lse[static_cast<long long>(bh) * S + q0 + r] = row_lse;
        delta[static_cast<long long>(bh) * S + q0 + r] = row_delta;
      }
    }
  }

  // pass 2: dq = sum over keys of ds k
  float acc[R][CC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[i][c] = 0.f;
  for (int kj = 0; kj < kj_end; ++kj) {
    const int k0 = kj * TK;
    if (window >= 0 && !(k0 + TK - 1 > q0 - window)) continue;
    __syncthreads();              // the last tile's readers are done
    load_tile<T, D, TK>(ks, kb, k0, Skv, kv_pos, 1.f);
    load_tile<T, D, TK>(vs, vb, k0, Skv, kv_pos, 1.f);
    __syncthreads();
    float sc[R][C], dp[R][C];
    tile_dot<D, R, C>(qs, ks, ty, tx, sc);
    tile_dot<D, R, C>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      const float row_lse = lse_s[r], row_delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const bool ok = kept(q0 + r, k0 + tx + 16 * j, S, Skv, causal,
                             window);
        const float p = ok ? expf(sc[i][j] - row_lse) : 0.f;
        dss[r * PS + tx + 16 * j] = p * (dp[i][j] - row_delta);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
      float dv_[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dv_[i] = dss[(ty * R + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float kv = ks[c * DS + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][cc] = fmaf(dv_[i], kv, acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty * R + i;
    if (qr >= S) continue;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
      store(dq + q_off + qr * q_pos + tx + 16 * cc, acc[i][cc] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q,            // (B, S, H, D)
    const T* __restrict__ k,            // (B, Skv, KV, D)
    const T* __restrict__ v,            // (B, Skv, KV, D)
    const T* __restrict__ dout,         // (B, S, H, D)
    const float* __restrict__ lse,      // (B H, S)
    const float* __restrict__ delta,    // (B H, S)
    T* __restrict__ dk,                 // (B, Skv, KV, D)
    T* __restrict__ dv,                 // (B, Skv, KV, D)
    int S, int Skv, int H, int KV, float scale, int causal, int window) {
  constexpr int TQ = tile<D>(), TK = tile<D>();
  constexpr int DS = D + 1, PS = TK + 1;
  constexpr int R = TQ / 16, C = TK / 16, RK = TK / 16, CC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                 // k tile
  float* vs = ks + TK * DS;         // v tile
  float* qs = vs + TK * DS;         // scaled q tile
  float* dos = qs + TQ * DS;        // dout tile
  float* ps = dos + TQ * DS;        // p of the (query, key) tile
  float* dss = ps + TQ * PS;        // ds of the tile
  float* lse_s = dss + TQ * PS;
  float* delta_s = lse_s + TQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * TK;

  const long long q_pos = static_cast<long long>(H) * D;
  const long long kv_pos = static_cast<long long>(KV) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;

  load_tile<T, D, TK>(ks, k + kv_off, k0, Skv, kv_pos, 1.f);
  load_tile<T, D, TK>(vs, v + kv_off, k0, Skv, kv_pos, 1.f);

  // thread (ty, tx) accumulates keys ty * RK + j, columns tx + 16 cc
  float adk[RK][CC], adv[RK][CC];
#pragma unroll
  for (int j = 0; j < RK; ++j)
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      adk[j][c] = 0.f;
      adv[j][c] = 0.f;
    }

  const int nq = (S + TQ - 1) / TQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = static_cast<long long>(b) * H + h;
    const long long q_off = (static_cast<long long>(b) * S * H + h) * D;
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * TQ;
      // every row of the query tile is before the key tile's first key,
      // or past the window of its last key
      if (causal && q0 + TQ - 1 < k0) continue;
      if (window >= 0 && q0 - (k0 + TK - 1) >= window) continue;
      __syncthreads();            // the last tile's readers are done
      load_tile<T, D, TQ>(qs, q + q_off, q0, S, q_pos, scale);
      load_tile<T, D, TQ>(dos, dout + q_off, q0, S, q_pos, 1.f);
      for (int r = tid; r < TQ; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[bh * S + q0 + r] : 0.f;
        delta_s[r] = in ? delta[bh * S + q0 + r] : 0.f;
      }
      __syncthreads();
      float sc[R][C], dp[R][C];
      tile_dot<D, R, C>(qs, ks, ty, tx, sc);
      tile_dot<D, R, C>(dos, vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty * R + i;
        const float row_lse = lse_s[r], row_delta = delta_s[r];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const bool ok = kept(q0 + r, k0 + tx + 16 * j, S, Skv, causal,
                               window);
          const float p = ok ? expf(sc[i][j] - row_lse) : 0.f;
          ps[r * PS + tx + 16 * j] = p;
          dss[r * PS + tx + 16 * j] = p * (dp[i][j] - row_delta);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < TQ; ++i) {
        float pv[RK], dsv[RK];
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          pv[j] = ps[i * PS + ty * RK + j];
          dsv[j] = dss[i * PS + ty * RK + j];
        }
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float dov = dos[i * DS + tx + 16 * cc];
          const float qv = qs[i * DS + tx + 16 * cc];
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            adv[j][cc] = fmaf(pv[j], dov, adv[j][cc]);
            adk[j][cc] = fmaf(dsv[j], qv, adk[j][cc]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RK; ++j) {
    const int kc = k0 + ty * RK + j;
    if (kc >= Skv) continue;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const long long at = kv_off + kc * kv_pos + tx + 16 * cc;
      store(dk + at, adk[j][cc]);
      store(dv + at, adv[j][cc]);
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem > rt::kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             void* dq, float* lse, float* delta, int B,
             int S, int Skv, int H, int KV, float scale, int causal,
             int window, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, D>;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  const dim3 grid(B * H, (S + tile<D>() - 1) / tile<D>());
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), lse, delta, S, Skv, H, KV, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              int B, int S, int Skv, int H, int KV, float scale, int causal,
              int window, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  const dim3 grid(B * KV, (Skv + tile<D>() - 1) / tile<D>());
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, Skv, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int B, int S, int Skv, int H, int KV, int D, int dtype) {
  return B < 1 || S < 1 || Skv < 1 || KV < 1 || H % KV != 0 ||
         (S + 31) / 32 > 65535 || (Skv + 31) / 32 > 65535 ||
         (dtype != 0 && dtype != 1) ||
         (D != 16 && D != 32 && D != 64 && D != 128 && D != 256);
}

#define FLASH_BWD_DISPATCH(FN, T, ...)                      \
  switch (D) {                                              \
    case 16: return FN<T, 16>(__VA_ARGS__);                 \
    case 32: return FN<T, 32>(__VA_ARGS__);                 \
    case 64: return FN<T, 64>(__VA_ARGS__);                 \
    case 128: return FN<T, 128>(__VA_ARGS__);               \
    default: return FN<T, 256>(__VA_ARGS__);                \
  }

}  // namespace

// Kernel 1.  Launch on `stream`; allocates nothing, does not synchronise,
// returns cudaGetLastError().  q, dout, dq: (B, S, H, D) and k, v:
// (B, Skv, KV, D), contiguous, all of `dtype` (0 float32, 1 bfloat16);
// lse, delta: (B H, S) float32 scratch it writes; H a multiple of KV; D
// one of 16, 32, 64, 128, 256; window < 0 means no window.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* lse, void* delta, int B, int S,
    int Skv, int H, int KV, int D, float scale, int causal, int window,
    int dtype, void* stream) {
  if (bad_args(B, S, Skv, H, KV, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    FLASH_BWD_DISPATCH(dq_typed, float, q, k, v, dout, dq, l, dl, B, S, Skv,
                       H, KV, scale, causal, window, st)
  }
  FLASH_BWD_DISPATCH(dq_typed, __nv_bfloat16, q, k, v, dout, dq, l, dl, B,
                     S, Skv, H, KV, scale, causal, window, st)
}

// Kernel 2, after kernel 1 on the same stream: reads its lse and delta.
// dk, dv: (B, Skv, KV, D) of `dtype`, written whole.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int Skv, int H, int KV, int D, float scale, int causal, int window,
    int dtype, void* stream) {
  if (bad_args(B, S, Skv, H, KV, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    FLASH_BWD_DISPATCH(dkv_typed, float, q, k, v, dout, l, dl, dk, dv, B, S,
                       Skv, H, KV, scale, causal, window, st)
  }
  FLASH_BWD_DISPATCH(dkv_typed, __nv_bfloat16, q, k, v, dout, l, dl, dk, dv,
                     B, S, Skv, H, KV, scale, causal, window, st)
}
