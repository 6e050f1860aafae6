// Causal / sliding-window softmax attention with grouped-query heads on
// Hopper's tensor cores: the `tc` route of flash attention, bfloat16 at
// head dims 64, 128 (every dense prefill of the serving path) and 256
// (RecurrentGemma's LOCAL layers).  float32, and head dims 16 / 32, take
// the `simt` route (flash_attention.cu); the wrapper picks the route from
// (dtype, D) alone (kernels/flash/ops.py::flash_route).
//
// Replaces the TPU kernel src/repro/kernels/flash/flash.py::
// flash_attention_pallas, with its semantics: causal and sliding-window
// masking, masked scores at -1e30, the row sum clamped at 1e-30, KV tiles
// masked for every row of the query tile never loaded, any S and Skv
// (rows past S not stored, keys past Skv masked), and query head h
// reading KV head h / (H / KV) in place out of the (B, Skv, KV, D) tensor.
//
// What bounds it: at the serving shapes (S = 1024, D = 128) the products
// -- 4 D flops per unmasked (query, key) pair -- are ~400 flops per byte
// of q, k, v and out, far above the card's balance point, so the bound is
// the bf16 tensor-core rate.  Next to the products, the softmax's one
// exp2 per score runs on the special-function units at 1/256 of that
// rate; and at B = 1, H = 16, S = 1024 the longest query tile's chain of
// 16 KV tiles sets the time.
//
// What the design does about it:
//   * one CTA = one warpgroup (128 threads, 64 query rows), ~97 KB of
//     shared memory at D = 128: two CTAs share an SM, so one's softmax
//     overlaps the other's products;
//   * Q K^T with wgmma m64n64k16 (bf16 -> f32): Q is the A operand from
//     registers (loaded once per CTA), K the B operand read from shared
//     memory through matrix descriptors over 128-byte-swizzled tiles;
//   * O += P V with wgmma m64n{D}k16: P converted to bf16 in registers is
//     the A operand (the S accumulator's fragment is the A fragment's
//     layout), V is read from shared memory as an MN-major B operand; the
//     O accumulator stays in registers for the whole KV sweep;
//   * software pipeline: Q K^T of tile j and P V of tile j - 1 are issued
//     together, and the softmax of tile j runs while P V of tile j - 1 is
//     on the tensor cores (two P buffers alternate, so no instruction
//     writes a register that a product in flight reads);
//   * the online softmax (m, l, rescale of O) runs in float32 on the
//     accumulator fragments: scale log2 e is applied to the f32 scores in
//     the FMA that feeds ex2.approx, row max and row sum are trees over a
//     thread's 16 values and shuffles across the 4 lanes that share a
//     row, and a warp whose maxima stood still skips the rescale;
//   * K and V come by TMA (cp.async.bulk.tensor, 4-D maps (D, KV, Skv, B)
//     with boxes of 64 x 1 x 64 x 1: keys past Skv are zero-filled by the
//     hardware, never read from the next batch row) into rings of three
//     stages with an mbarrier each; one thread issues them, a tile ahead
//     of need and right after the step's products are issued;
//   * masks are evaluated only on tiles that need them (the diagonal, the
//     window's edge, the ragged last key tile); the KV range skips tiles
//     right of the diagonal and left of the window; the longest causal
//     query tiles are launched first and the shortest fill the SMs' second
//     slots, so the longest sweeps share their SM least.
//
// Head dim 256: the O accumulator of 64 x 256 float32 would be 128
// registers a thread of one warpgroup, beside Q's 64 and the S / P
// fragments -- past the 255 a thread may hold.  So at D = 256 a CTA is
// two warpgroups: each owns 128 columns of O (an m64n128 P V, 64
// registers), and both form the same S = Q K^T over the whole head dim
// (the product is formed twice: 1.5 x the tensor-core work of one pass,
// which a later redesign may split); Q is read by TMA into shared memory
// once per CTA and is the A operand of Q K^T from there (wgmma with both
// operands in shared memory), so no thread holds Q's fragments.  The K
// and V rings have two stages (Q 32 KB + 2 x 2 x 32 KB of 227 KB).
//
// Rounding: Q K^T is formed from the bf16 operands and P is rounded to
// bf16 before P V (the Pallas kernel keeps both in float32): one bf16
// rounding, inside the bf16 tolerance 3e-2 of tests/test_kernels.py that
// chip_smoke.py holds this route to.  A row with no unmasked key at all
// (possible only with a window and S > Skv + window - 1) comes out 0, as
// on the simt route; mha_ref gives it the uniform average of v
// (ROADMAP.md queue C).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockM = 64;               // query rows per CTA
constexpr int kBlockN = 64;               // keys per KV tile
constexpr int kBox = 64;                  // head-dim columns per TMA box (128 B)
constexpr int kBoxBytes = kBox * kBlockN * 2;   // 8 KB: a 64 x 64 bf16 box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the shape of a CTA at head dim D: warpgroups (each owning kOD columns
// of O), depth of the K and V rings, and where Q's A operand lives
template <int D>
struct Cfg {
  static constexpr int kWG = D == 256 ? 2 : 1;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kOD = D / kWG;
  static constexpr bool kQSmem = D == 256;   // else Q in registers
};

// shared memory of one CTA: [q] | k[kStages] | v[kStages] | mbarriers
// (kfull[kStages], vfull[kStages], qfull)
template <int D>
struct Layout {
  static constexpr int kTile = (D / kBox) * kBoxBytes;  // 64 rows of q, k or v
  static constexpr int kStages = Cfg<D>::kStages;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + (Cfg<D>::kQSmem ? kTile : 0);
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 16 * kStages + 8 + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts ~2^26 polls (seconds) is a fault, and traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned atoms): leading / stride byte offsets in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across a wait
// (and the registers of an operand from being reused while a product
// still reads them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[t][i])::"memory");
}

// 2^x on the special-function unit, subnormals flushed (2^-1e30 = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_rs_m64n64_kmajor(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same, overwriting S (scale-d false): S is an output only
__device__ __forceinline__ void wgmma_rs_m64n64_kmajor_first(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// S (64 x 64, f32) += A (64 x 16, K-major smem) B (16 x 64, K-major
// smem): Q K^T with Q in shared memory (head dim 256)
__device__ __forceinline__ void wgmma_ss_m64n64_kmajor(float (&d)[32],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the same, overwriting S (scale-d false)
__device__ __forceinline__ void wgmma_ss_m64n64_kmajor_first(float (&d)[32],
                                                             uint64_t da,
                                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// O (64 x 64) += P (64 x 16, registers) V (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += P (64 x 16, registers) V (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs_o(float (&o)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_o<64>(float (&o)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  wgmma_rs_m64n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs_o<128>(float (&o)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  wgmma_rs_m64n128(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tk,   // k (B, Skv, KV, D)
    const __grid_constant__ CUtensorMap tv,   // v (B, Skv, KV, D)
    const __grid_constant__ CUtensorMap tq,   // q (B, S, H, D), if kQSmem
    const __nv_bfloat16* __restrict__ q,      // (B, S, H, D)
    __nv_bfloat16* __restrict__ out,          // (B, S, H, D)
    int S, int Skv, int H, int KV, float scale_log2, int causal,
    int window) {
  using L = Layout<D>;
  constexpr int kNB = D / kBox;
  constexpr int kStages = Cfg<D>::kStages;
  constexpr int kOD = Cfg<D>::kOD;                   // O columns of a warpgroup
  constexpr bool kQSmem = Cfg<D>::kQSmem;
  extern __shared__ unsigned char smem_tc[];
  const uint32_t base = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t kfull0 = base + L::kBar;            // kfull[s] = kfull0 + 8 s
  const uint32_t vfull0 = kfull0 + 8 * kStages;      // vfull[s]
  const uint32_t qfull = vfull0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  // query tile order: the longest causal sweeps first (the first half of
  // the grid's rows, longest first), then the shortest first -- so that
  // when a second CTA joins an SM it is a short one, and the long sweep
  // that sets the kernel's time shares its SM as little as possible
  const int ny = gridDim.y, half = (ny + 1) / 2, y = blockIdx.y;
  const int qt = causal && y >= half ? y - half : ny - 1 - y;
  const int q0 = qt * kBlockM;

  // the KV tiles [kj0, kj1) this query tile reads: none right of the
  // diagonal, none wholly left of the window
  const int nk = (Skv + kBlockN - 1) / kBlockN;
  const int kj1 = causal ? min(nk, (q0 + kBlockM - 1) / kBlockN + 1) : nk;
  int kj0 = 0;
  if (window >= 0) {
    const int lim = q0 - window - (kBlockN - 1);   // a tile needs k0 > lim
    kj0 = min(lim < 0 ? 0 : lim / kBlockN + 1, kj1);
  }
  const int ntiles = kj1 - kj0;

  // thread 0 issues every TMA load: K (or V) of tile j into stage
  // j % kStages of its ring, each stage on its own mbarrier
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t bar0,
                  int j) {
    const int s = j % kStages;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, L::kTile);
    for (int nb = 0; nb < kNB; ++nb)
      tma_load_4d(ring + s * L::kTile + nb * kBoxBytes, map, bar, nb * kBox,
                  kvh, (kj0 + j) * kBlockN, b);
  };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tv)) : "memory");
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kQSmem) {
      // the query tile, rows past S zero-filled by the hardware
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tq)) : "memory");
      mbar_expect_tx(qfull, L::kTile);
      for (int nb = 0; nb < kNB; ++nb)
        tma_load_4d(sq + nb * kBoxBytes, &tq, qfull, nb * kBox, h, q0, b);
    }
    for (int j = 0; j < min(kStages, ntiles); ++j) {
      load(&tk, sk, kfull0, j);
      load(&tv, sv, vfull0, j);
    }
  }

  const int wg = tid >> 7;                       // O columns wg kOD ..
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int qa = q0 + warp * 16 + (lane >> 2);   // rows qa and qa + 8
  const int qb = qa + 8;
  const int cq = 2 * (lane & 3);                 // columns cq, cq + 1 of each n8
  float o[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // raw-score max

  // q as the A operand of Q K^T, held in registers for the whole sweep
  // (D 64 / 128): k-step t covers columns 16 t .. 16 t + 15 (rows past S
  // are zeros); at D 256 it is read from shared memory instead
  uint32_t qf[kQSmem ? 1 : D / 16][4];
  if constexpr (!kQSmem) {
    const long long row = static_cast<long long>(H) * D;
    const __nv_bfloat16* qra =
        q + (static_cast<long long>(b) * S * H + h) * D + qa * row;
    const __nv_bfloat16* qrb = qra + 8 * row;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const int c = 16 * t + cq;
      qf[t][0] = qa < S ? *reinterpret_cast<const uint32_t*>(qra + c) : 0u;
      qf[t][1] = qb < S ? *reinterpret_cast<const uint32_t*>(qrb + c) : 0u;
      qf[t][2] = qa < S ? *reinterpret_cast<const uint32_t*>(qra + c + 8) : 0u;
      qf[t][3] = qb < S ? *reinterpret_cast<const uint32_t*>(qrb + c + 8) : 0u;
    }
  }
  __syncthreads();                               // the mbarriers are set up
  if constexpr (kQSmem) mbar_wait(qfull, 0);

  // S = Q K^T of tile j (issued and committed, not waited for): D / 16
  // k-steps of 32 bytes inside 128-byte swizzled K rows; the first
  // overwrites S, so no other instruction defines its registers
  auto issue_qk = [&](float (&sc)[32], int j) {
    const uint32_t kt = sk + (j % kStages) * L::kTile;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const uint32_t off = (t / 4) * kBoxBytes + (t % 4) * 32;
      const uint64_t db = make_desc(kt + off, 16, 1024);
      if constexpr (kQSmem) {
        const uint64_t da = make_desc(sq + off, 16, 1024);
        if (t == 0) wgmma_ss_m64n64_kmajor_first(sc, da, db);
        else wgmma_ss_m64n64_kmajor(sc, da, db);
      } else {
        if (t == 0) wgmma_rs_m64n64_kmajor_first(sc, qf[0], db);
        else wgmma_rs_m64n64_kmajor(sc, qf[t], db);
      }
    }
    wgmma_commit();
  };
  // O += P V of tile j (issued and committed, not waited for): V rows are
  // keys (K), its head-dim columns N, MN-major; 8-key groups 1024 B apart,
  // 64-column boxes kBoxBytes apart; warpgroup wg reads the boxes of its
  // kOD columns
  auto issue_pv = [&](const uint32_t (&pa)[4][4], int j) {
    const uint32_t vt = sv + (j % kStages) * L::kTile +
                        wg * (kOD / kBox) * kBoxBytes;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wgmma_rs_o<kOD>(o, pa[t], make_desc(vt + t * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
  };
  // online softmax of the tile at key k0, on the S fragments (read only):
  // n8 block j holds columns 8 j + cq + {0, 1} of row qa (sc[4j],
  // sc[4j+1]) and of row qb (sc[4j+2], sc[4j+3]).  Masked scores are
  // -1e30; m is the running max of the raw scores, p = 2^(s sl - m sl)
  // with sl = scale log2 e applied to the f32 scores in one FMA.  Updates
  // m and l, returns P as bf16 A fragments (k-step t covers keys
  // 16 t .. 16 t + 15) and the factors c0, c1 that rescale O.
  auto softmax = [&](const float (&sc)[32], int k0, uint32_t (&pa)[4][4],
                     float& c0, float& c1) {
    const bool need_mask = k0 + kBlockN > Skv ||
                           (causal && k0 + kBlockN - 1 > q0) ||
                           (window >= 0 && q0 + kBlockM - 1 - k0 >= window);
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = sc[i];
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + 8 * j + cq + e;
          bool ok0 = kc < Skv, ok1 = kc < Skv;
          if (causal) { ok0 = ok0 && qa >= kc; ok1 = ok1 && qb >= kc; }
          if (window >= 0) {
            ok0 = ok0 && qa - kc < window;
            ok1 = ok1 && qb - kc < window;
          }
          if (!ok0) x[4 * j + e] = kNegInf;
          if (!ok1) x[4 * j + 2 + e] = kNegInf;
        }
      }
    }
    // row max: a tree over the thread's 16 values, then the 4 lanes
    float a[8], bb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = fmaxf(x[4 * j], x[4 * j + 1]);
      bb[j] = fmaxf(x[4 * j + 2], x[4 * j + 3]);
    }
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        a[j] = fmaxf(a[j], a[j + w]);
        bb[j] = fmaxf(bb[j], bb[j + w]);
      }
    float mx0 = fmaxf(m0, a[0]), mx1 = fmaxf(m1, bb[0]);
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    c0 = ex2((m0 - mx0) * scale_log2);
    c1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    // a row with no unmasked score yet keeps p = 0 (2^ of the -1e30
    // sentinel); subtracting its max would leave the FMA's rounding
    // residue of -1e30 sl, not 0
    const float n0 = mx0 == kNegInf ? 0.f : -mx0 * scale_log2;
    const float n1 = mx1 == kNegInf ? 0.f : -mx1 * scale_log2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[4 * j + e] = ex2(fmaf(x[4 * j + e], scale_log2, n0));
        x[4 * j + 2 + e] = ex2(fmaf(x[4 * j + 2 + e], scale_log2, n1));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = x[4 * j] + x[4 * j + 1];
      bb[j] = x[4 * j + 2] + x[4 * j + 3];
    }
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        a[j] += a[j + w];
        bb[j] += bb[j + w];
      }
    l0 = l0 * c0 + a[0];          // this thread's share of the row sums
    l1 = l1 * c1 + bb[0];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pa[t][0] = pack_bf16(x[8 * t + 0], x[8 * t + 1]);
      pa[t][1] = pack_bf16(x[8 * t + 2], x[8 * t + 3]);
      pa[t][2] = pack_bf16(x[8 * t + 4], x[8 * t + 5]);
      pa[t][3] = pack_bf16(x[8 * t + 6], x[8 * t + 7]);
    }
  };
  // O *= c, skipped by a warp whose rows' maxima all stood still
  auto rescale = [&](float c0, float c1) {
    if (__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) return;
#pragma unroll
    for (int j = 0; j < kOD / 8; ++j) {
      o[4 * j + 0] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
  };
  auto kwait = [&](int j) {
    mbar_wait(kfull0 + 8 * (j % kStages), (j / kStages) & 1);
  };
  auto vwait = [&](int j) {
    mbar_wait(vfull0 + 8 * (j % kStages), (j / kStages) & 1);
  };
  // K of tile jk and V of tile jv are consumed by the whole warpgroup
  // (after a __syncthreads); their stages are refilled with the tiles
  // kStages further on by `refill`, which runs right after the next
  // products are issued, so that the loads' issue overlaps them
  int pend_k = -1, pend_v = -1;
  auto refill = [&]() {
    if (tid == 0) {
      if (pend_k >= 0 && pend_k + kStages < ntiles)
        load(&tk, sk, kfull0, pend_k + kStages);
      if (pend_v >= 0 && pend_v + kStages < ntiles)
        load(&tv, sv, vfull0, pend_v + kStages);
    }
    pend_k = pend_v = -1;
  };

  if (ntiles > 0) {
    // Q K^T of tile j and P V of tile j - 1 are in flight together, and
    // the softmax of tile j runs while P V of tile j - 1 is still on the
    // tensor cores.  Two P buffers alternate (the loop is unrolled by two),
    // so the softmax never writes a register a product in flight reads.
    uint32_t pa[2][4][4];
    float c0, c1;
    {
      float sc[32];
      kwait(0);
      wgmma_fence();
      issue_qk(sc, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      __syncthreads();
      pend_k = 0;
      softmax(sc, kj0 * kBlockN, pa[0], c0, c1);
    }
    auto step = [&](int j, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
      float sc[32];
      kwait(j);
      vwait(j - 1);
      fence_regs(o);
      fence_regs(cur);
      wgmma_fence();
      issue_qk(sc, j);
      issue_pv(cur, j - 1);
      refill();
      wgmma_wait<1>();               // Q K^T of tile j has landed
      fence_regs(sc);
      softmax(sc, (kj0 + j) * kBlockN, nxt, c0, c1);
      wgmma_wait<0>();               // P V of tile j - 1 has landed
      fence_regs(o);
      fence_regs(cur);
      __syncthreads();
      pend_k = j;
      pend_v = j - 1;
      rescale(c0, c1);
    };
    int j = 1;
    for (; j + 1 < ntiles; j += 2) {
      step(j, pa[0], pa[1]);
      step(j + 1, pa[1], pa[0]);
    }
    if (j < ntiles) step(j, pa[0], pa[1]);
    // P V of the last tile, whose P is in pa[(ntiles - 1) % 2]
    auto finish = [&](uint32_t (&last)[4][4]) {
      vwait(ntiles - 1);
      fence_regs(o);
      fence_regs(last);
      wgmma_fence();
      issue_pv(last, ntiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(last);
    };
    if (ntiles % 2 == 1) finish(pa[0]);
    else finish(pa[1]);
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long row = static_cast<long long>(H) * D;
  __nv_bfloat16* ob = out + (static_cast<long long>(b) * S * H + h) * D;
#pragma unroll
  for (int jj = 0; jj < kOD / 8; ++jj) {
    const int col = wg * kOD + 8 * jj + cq;
    if (qa < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qa * row + col) =
          __floats2bfloat162_rn(o[4 * jj + 0] / den0, o[4 * jj + 1] / den0);
    if (qb < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qb * row + col) =
          __floats2bfloat162_rn(o[4 * jj + 2] / den1, o[4 * jj + 3] / den1);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// 4-D map of a contiguous (batch, seq, heads, D) bf16 tensor, innermost
// first, boxes of (64, 1, 64, 1), 128-byte swizzle, zeros out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int seq,
              int batch) {
  auto encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(seq) * heads * D * 2};
  const cuuint32_t box[4] = {kBox, 1, kBlockN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Skv, int H, int KV, float scale, int causal,
              int window, cudaStream_t stream) {
  CUtensorMap tk, tv, tq;
  if (!make_map(&tk, k, D, KV, Skv, B) || !make_map(&tv, v, D, KV, Skv, B) ||
      !make_map(&tq, q, D, H, S, B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_attention_tc_kernel<D>;
  const int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBlockM - 1) / kBlockM);
  kern<<<grid, Cfg<D>::kThreads, smem, stream>>>(
      tk, tv, tq, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), S, Skv, H, KV, scale * kLog2e, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route.  Launch on `stream`; allocates nothing, does not
// synchronise, returns cudaGetLastError().  q, out: (B, S, H, D) and k, v:
// (B, Skv, KV, D), contiguous bfloat16 with 16-byte aligned bases; H a
// multiple of KV; D 64, 128 or 256; window < 0 means no window.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Skv, int H, int KV, int D, float scale, int causal, int window,
    void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || KV < 1 || H % KV != 0 ||
      (S + kBlockM - 1) / kBlockM > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_tc<64>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, st);
  if (D == 128)
    return launch_tc<128>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, st);
  if (D == 256)
    return launch_tc<256>(q, k, v, out, B, S, Skv, H, KV, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
