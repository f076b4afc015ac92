// The shared-memory ring of the streaming kernels K4 (cgs_block.cu) and
// E2a (bcgs_ring.cu): one producer warp copies row segments from global
// into `stages` shared-memory buffers with 1-D bulk copies (cp.async.bulk,
// no tensor map, so no libcuda), or with element cp.async where a segment
// is not 16-byte aligned, and mbarriers hand each buffer between the
// producer and the consumer warps.  PTX helpers only; each kernel keeps its
// own loop.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lt {
namespace {  // internal linkage, as in common.cuh

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 1-D bulk copy global -> shared; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One element copy global -> shared; src_bytes = 0 writes zeros.
template <int BYTES>
__device__ __forceinline__ void elem_copy(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(smem_u32(dst)), "l"(src), "n"(BYTES),
               "r"(src_bytes)
               : "memory");
}

// Arrive on `bar` once this thread's earlier element copies have landed.
__device__ __forceinline__ void elem_copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Orders this thread's shared-memory accesses (generic proxy) with the
// bulk and element copies (async proxy).  A stage is refilled right after
// its release; without the fence a 2-stage ring handed stale rows to K4's
// projection on the H100.
__device__ __forceinline__ void proxy_fence() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// Named barrier `ID` of the first COUNT threads (0 is __syncthreads).
template <int ID, int COUNT>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}

// The ring's mbarriers: full[s] completes when segment s has landed (one
// arrival with its byte count, or 32 element-copy arrivals), empty[s] when
// each of the `readers` consumer warps has released it.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages, bool bulk, int readers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], bulk ? 1u : 32u);
      mbar_init(&empty[s], uint32_t(readers));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    proxy_fence();
  }
  __syncthreads();
}

// The producer warp's share of one segment: `cols` values of T from `src`
// into the stage `dst`, completing `full` (one bulk copy by lane 0 when
// `bulk`, else element copies by the whole warp, zero-filled up to `padded`
// values).
template <typename T>
__device__ __forceinline__ void issue_segment(T* dst, const T* src, int cols, int padded, bool bulk, uint64_t* full) {
  const int lane = threadIdx.x & 31;
  if (bulk) {
    if (lane == 0) {
      const uint32_t bytes = uint32_t(cols) * uint32_t(sizeof(T));
      mbar_arrive_expect_tx(full, bytes);
      bulk_copy(dst, src, bytes, full);
    }
  } else {
    for (int i = lane; i < padded; i += 32) {
      const bool in = i < cols;
      elem_copy<sizeof(T)>(dst + i, in ? src + i : src, in ? uint32_t(sizeof(T)) : 0u);
    }
    elem_copies_arrive(full);
  }
}

}  // namespace
}  // namespace lt
