// ring.cuh: a ring of shared-memory stages filled by 1-D bulk copies
// (Hopper's cp.async.bulk through the TMA unit), with mbarrier completion.
//
// One elected thread of a CTA announces the bytes of a stage on its "full"
// barrier and issues the copy; the consumers wait on that barrier's phase
// parity, compute, and arrive on the stage's "empty" barrier (or pass a
// __syncthreads) before the producer refills it.  Use u of stage s (tile i
// of the CTA's run, s = i % stages, u = i / stages) waits for parity u & 1.
//
// Bulk copies need 16-byte-aligned addresses and a multiple of 16 bytes,
// while the kernels' inputs are only 4-byte aligned (views such as x[2:],
// blocks of any length).  So each tile is copied as the 16-byte-aligned
// superset of its bytes and consumed from an offset inside the stage.  The
// superset never leaves the 16-byte granules that hold the tile's own
// bytes, so it touches no page the tile does not.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy (the copy engine); call once after the inits, then sync
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait longer
// than 2^33 clocks (seconds) traps, so a fault surfaces as a launch error
// instead of a card that never finishes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1LL << 33)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The 16-byte-aligned superset of [p, p + n): where to copy from, how
// many bytes, and the offset of p inside the copy.
struct Span {
  const void* src;
  uint32_t bytes;
  uint32_t lead;
};

__device__ __forceinline__ Span superset16(const void* p, size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (a + n + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo),
          static_cast<uint32_t>(a - lo)};
}

// Copy the superset of [p, p + n) into the stage at dst (16-byte aligned,
// at least superset bytes long) and let the copy complete `full`'s phase.
// Called by one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* p, size_t n,
                                          uint64_t* full) {
  const Span s = superset16(p, n);
  const uint32_t bar = smem_u32(full);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(s.bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(s.src), "r"(s.bytes), "r"(bar)
      : "memory");
}

// Tiles [begin, end) of this CTA: contiguous runs whose lengths differ by
// at most one (kernels/plan.py run()).
__device__ __forceinline__ void cta_run(long long n_tiles, long long* begin,
                                        long long* end) {
  *begin = (long long)blockIdx.x * n_tiles / gridDim.x;
  *end = ((long long)blockIdx.x + 1) * n_tiles / gridDim.x;
}

}  // namespace rx
