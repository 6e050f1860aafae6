// Causal / sliding-window softmax attention with grouped-query heads:
// flash attention (online softmax over KV tiles), one thread block per
// 64-row query tile of one (batch, head).
//
// Replaces the TPU kernel src/repro/kernels/flash/flash.py::flash_attention_pallas.
// There the grid was (BH, q blocks, kv blocks) with the kv axis run in
// order on one core, the running (m, l, acc) kept in VMEM scratch between
// grid steps, and the caller expanded the KV heads to H with a repeat.
// Here the kv sweep is a loop inside the block, (m, l, acc) live in
// registers for the whole sweep, and query head h reads KV head
// h / (H / KV) straight out of the model's (B, Skv, KV, D) tensor -- no
// expanded copy.  The same semantics: float32 inside whatever the input
// type, q scaled by `scale` before the product, masked scores at -1e30,
// the row sum clamped at 1e-30, KV tiles that are masked for every row of
// the query tile (above the diagonal, left of the window) never loaded.
// Unlike the Pallas kernel, S and Skv need not be multiples of the tile:
// rows past S are not stored and keys past Skv are masked.  A query row
// with no unmasked key at all (a window with S > Skv + window - 1) comes
// out 0, on both routes; mha_ref gives it the uniform average of v
// (ROADMAP.md queue C).
//
// What bounds it: at the serving shapes (S = 1024, D = 128, bf16) the
// operations -- 2 S^2 D flops per head under causality -- over the bytes
// (q, k, v read once, out written once) give ~400 flops a byte, far above
// the card's balance point, so the bound is the tensor-core rate.  This
// first version does not use the tensor cores: every product is a
// float32 FMA on the CUDA cores, fed from shared memory.
//
// What the design does about it: each thread owns a 4 x 4 block of the
// 64 x 64 score tile (4 rows x every 16th key) and a 4 x (D/16) block of
// the output accumulator, so a shared-memory load feeds four FMAs; the q
// and k tiles are stored transposed with an odd row stride (no bank
// conflicts on the transposing store or the strided reads); the row max
// and row sum of the online softmax are 16-lane shuffles.  The query
// tiles furthest down the diagonal, which have the most KV tiles, are
// launched first.
//
// This is the `simt` route: float32 (whose 2e-5 tolerance TF32 products
// would not hold), and head dims 16 / 32 in either type.  At head dim 256
// (RecurrentGemma's LOCAL layers in float32) the tiles take 215 296 bytes
// of shared memory, one block an SM.  bfloat16 at head dims 64 / 128 /
// 256 -- every prefill of the serving path -- takes the
// tensor-core kernel of flash_attention_tc.cu (the `tc` route); the
// wrapper picks the route from (dtype, D) alone
// (kernels/flash/ops.py::flash_route).

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kThreads = 256;       // 16 row groups x 16 column lanes
constexpr int kStride = kTile + 1;  // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_floats() {
  // qT [D][kStride], kT [D][kStride], v [kTile][D], p [kTile][kStride]
  return 2 * D * kStride + kTile * D + kTile * kStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,   // (B, S, H, D)
    const T* __restrict__ k,   // (B, Skv, KV, D)
    const T* __restrict__ v,   // (B, Skv, KV, D)
    T* __restrict__ out,       // (B, S, H, D)
    int S, int Skv, int H, int KV, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qT = smem;                   // scaled q tile, transposed
  float* kT = qT + D * kStride;       // k tile, transposed
  float* vs = kT + D * kStride;       // v tile, row-major
  float* ps = vs + kTile * D;         // probabilities of the tile

  constexpr int kCols = D / 16;       // accumulator columns per thread
  const int tid = threadIdx.x;
  const int ty = tid >> 4;            // rows ty*4 .. ty*4+3
  const int tx = tid & 15;            // keys / columns tx, tx+16, ...
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;

  const long long q_pos = static_cast<long long>(H) * D;   // position stride
  const long long kv_pos = static_cast<long long>(KV) * D;
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  T* ob = out + (static_cast<long long>(b) * S * H + h) * D;

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = q0 + r;
    qT[d * kStride + r] = s < S ? to_f32(qb[s * q_pos + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Skv + kTile - 1) / kTile;
  const int kj_end = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  for (int kj = 0; kj < kj_end; ++kj) {
    const int k0 = kj * kTile;
    // every row of the tile is past this KV tile's window
    if (window >= 0 && !(k0 + kTile - 1 > q0 - window)) continue;
    __syncthreads();                  // the last tile's readers are done
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int s = k0 + c;
      const bool ok = s < Skv;
      kT[d * kStride + c] = ok ? to_f32(kb[s * kv_pos + d]) : 0.f;
      vs[c * D + d] = ok ? to_f32(vb[s * kv_pos + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qT[d * kStride + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kT[d * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        bool ok = kc < Skv;
        if (causal) ok = ok && qr >= kc;
        if (window >= 0) ok = ok && qr - kc < window;
        sc[i][j] = ok ? sc[i][j] : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty * 4 + i) * kStride + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kStride + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float vv = vs[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= S) continue;
    // a row with no unmasked key comes out 0, as on the tc route (its
    // p stays 0 where the -1e30 scores minus the -1e30 max give p = 1)
    const bool none = m[i] == kNegInf;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      store(ob + qr * q_pos + tx + 16 * cc, none ? 0.f : acc[i][cc] / denom);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Skv, int H, int KV, float scale,
                 int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > rt::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Skv, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out,
               int B, int S, int Skv, int H, int KV, int D, float scale,
               int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, stream);
    case 32: return launch_typed<T, 32>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, stream);
    case 64: return launch_typed<T, 64>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, stream);
    case 128: return launch_typed<T, 128>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, stream);
    case 256: return launch_typed<T, 256>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  q, out: (B, S, H, D) and k, v: (B, Skv, KV, D),
// contiguous, all of `dtype` (0 float32, 1 bfloat16); H a multiple of KV;
// D one of 16, 32, 64, 128, 256; window < 0 means no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Skv, int H, int KV, int D, float scale, int causal, int window,
    int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || (S + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, out, B, S, Skv, H, KV, D, scale, causal, window, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, out, B, S, Skv, H, KV, D, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
