// Distributed-shared-memory helpers of the thread-block-cluster kernels
// (svrg_inner_sparse.cu's and sdca_epoch_cluster.cu's `cluster` routes):
// a CTA sends 4-byte partial sums into every peer's shared memory with
// st.async, each store completing 4 bytes of the transaction count of the
// peer's mbarrier, and waits on its own mbarrier for its peers' partials.
// Also the bulk copy (TMA) into a ring of shared-memory slots and its
// CTA-scope wait, which the ring kernels share (sdca_epoch_cluster.cu,
// svrg_inner_ring.cu, sdca_epoch_sparse_ahead.cu).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `local` in the CTA of cluster rank `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// 4 bytes into a peer's shared memory, completing 4 bytes of the
// transaction count of the peer's mbarrier
__device__ __forceinline__ void st_async_peer(uint32_t addr, float v,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// wait until the phase of parity `parity` has completed, seeing the
// peers' stores; a wait that outlasts ~2^26 polls (seconds) is a fault,
// and traps instead of hanging
__device__ __forceinline__ void cl_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// an mbarrier of one expected arrival, made visible to the cluster
// (the caller syncs the cluster before a peer may address it)
__device__ __forceinline__ void cl_mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void cl_mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this CTA's one arrival of a phase, expecting `bytes` from the peers
__device__ __forceinline__ void cl_mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// an mbarrier of `count` expected arrivals (CTA scope)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival on `bar` (CTA scope, release: the caller's earlier reads and
// writes of shared memory come before it)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one bulk copy (TMA) of `bytes` (a multiple of 16) from 16-byte aligned
// global memory into 16-byte aligned shared memory, completing `bytes` of
// the transaction count of the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait (CTA scope) until the phase of parity `parity` of `bar` completed;
// like cl_mbar_wait, a wait that outlasts ~2^26 polls traps
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

// like mbar_wait, but polls without suspending the warp (test_wait),
// sleeping `ns` nanoseconds between polls; a wait that outlasts ~2^26
// polls traps
__device__ __forceinline__ void mbar_wait_sleep(uint32_t bar, uint32_t parity,
                                                unsigned ns) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
    __nanosleep(ns);
  }
}

}  // namespace rt
