// capture_head: the rx_fm capture head on Hopper (sm_90a).
//
// Replaces the TPU kernels rx_tools_tpu/ops/frontend_mxu.py
// capture_frontend_mm_pallas (K1, body _mm_kernel), capture_frontend_mm_pallas2
// (K4, body _mm_kernel2) and rx_tools_tpu/ops/pallas_frontend.py
// capture_frontend_pallas (K3, body _kernel): CS16 rescale x128/32767
// (rtl_fm.c:845-848), fs/4 derotation (rtl_fm.c:309-327) and boxcar decimation
// by D (rtl_fm.c:351-371), one output sample per D input samples.
//
// What bounds it on the H100: bytes.  Each output sample reads 4*D bytes and
// writes 8, with about 2*D integer adds in between, far below the card's
// operation rate, so the least time is (4N + 8K) bytes / 3.35 TB/s.
//
// What the design does about it:
// - the TPU kernels fed a matrix unit with a {+1, 0, -1} matrix in f32; here
//   the same masked sums are int32 adds by fs/4 phase class (head.cuh), so
//   the result is integer-exact and equals the plain PyTorch version bit for
//   bit after the one f32 multiply by the scale;
// - persistent CTAs (one resident wave) each walk a contiguous run of tiles
//   of `rows` output samples; one thread keeps a ring of `stages` shared-
//   memory stages filled with 1-D bulk copies (ring.cuh), so every CTA has
//   its next tiles' loads in flight while it sums the current one, and all
//   of the card's loads start at the first instant rather than after a
//   serial chain of 4-byte loads;
// - the fs/4 phase is taken from the chunk-global flat index n = D*k + j, so
//   any K works and blocks of a chunk keep a continuous phase;
// - each thread owns one output sample of the tile: planar outputs Re[K] +
//   Im[K] (K1, K4) are written as coalesced floats, the interleaved (K, 2)
//   layout (K3) as coalesced float2.
//
// The tile plan (rows, stages, stage bytes, grid) comes from
// rx_tools_tpu_torch/kernels/plan.py and depends on D alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "head.cuh"
#include "ring.cuh"

namespace {

constexpr int kMaxStages = 4;
constexpr int kMaxThreads = 256;  // one output sample a thread

// at most 32 registers a thread, so that eight CTAs of 256 threads (or
// sixteen of 128) are resident on an SM and a config #1 chunk's tiles are
// all in flight in one wave
__global__ void __launch_bounds__(kMaxThreads, 8)
capture_head_kernel(const unsigned char* __restrict__ x,
                    float* __restrict__ out_a, float* __restrict__ out_b,
                    long long k_total, int d, int rotate, int interleaved,
                    float scale, int rows, int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];

  const int tid = threadIdx.x;
  const long long row_bytes = 4LL * d;
  const long long tile_bytes = rows * row_bytes;
  long long t0, t1;
  rx::cta_run((k_total + rows - 1) / rows, &t0, &t1);
  const int n = (int)(t1 - t0);

  auto tile_rows = [&](int i) {
    return (int)min((long long)rows, k_total - (t0 + i) * rows);
  };
  auto issue = [&](int i) {
    const int s = i % stages;
    rx::bulk_load(ring + (size_t)s * stage_bytes, x + (t0 + i) * tile_bytes,
                  (size_t)tile_rows(i) * row_bytes, &full[s]);
  };

  // the first copies fly while the other threads reach the barrier
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      rx::mbar_init(&full[s], 1);
      rx::mbar_init(&empty[s], blockDim.x / 32);
    }
    rx::mbar_fence_init();
    for (int i = 0; i < min(n, stages); ++i) issue(i);
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    const uint32_t parity = (uint32_t)(i / stages) & 1u;
    const long long k0 = (t0 + i) * rows;
    const unsigned char* src = x + (t0 + i) * tile_bytes;
    const unsigned char* tile =
        ring + (size_t)s * stage_bytes + (reinterpret_cast<uintptr_t>(src) & 15);
    rx::mbar_wait(&full[s], parity);
    if (tid < tile_rows(i)) {
      const long long k = k0 + tid;
      int re, im;
      rx::head_sum(reinterpret_cast<const uint32_t*>(tile + tid * row_bytes),
                   k, d, rotate, &re, &im);
      const float fr = (float)re * scale;
      const float fi = (float)im * scale;
      if (interleaved) {
        reinterpret_cast<float2*>(out_a)[k] = make_float2(fr, fi);
      } else {
        out_a[k] = fr;
        out_b[k] = fi;
      }
    }
    // release the stage: one arrival per warp, then the producer refills it
    __syncwarp();
    if ((tid & 31) == 0) rx::mbar_arrive(&empty[s]);
    if (tid == 0 && i + stages < n) {
      rx::mbar_wait(&empty[s], parity);
      issue(i + stages);
    }
  }
}

}  // namespace

// CTAs of a plan (rows, threads, smem bytes of ring) that fit on one SM at
// once (registers included); 0 on error.
extern "C" int rx_capture_head_ctas_per_sm(int rows, int threads, int smem) {
  (void)rows;  // one row a thread
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(capture_head_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, capture_head_kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

// rows, stages, stage_bytes and grid come from kernels/plan.py; the grid is
// cut to the number of tiles.  Returns cudaGetLastError() after the launch.
extern "C" int rx_capture_head(const void* x, void* out_a, void* out_b,
                               long long k_total, int d, int rotate,
                               int interleaved, float scale, int rows,
                               int stages, int stage_bytes, int grid,
                               void* stream) {
  if (k_total <= 0) return (int)cudaSuccess;
  const long long need = (rows * 4LL * d + 15) / 16 * 16 + 16;
  if (d < 1 || rows < 1 || rows > kMaxThreads || stages < 1 ||
      stages > kMaxStages || stage_bytes % 16 || stage_bytes < need ||
      grid < 1 || ((uintptr_t)x & 3))
    return (int)cudaErrorInvalidValue;
  const int threads = (rows + 31) / 32 * 32;
  const int smem = stages * stage_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        capture_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (k_total + rows - 1) / rows;
  const unsigned blocks = (unsigned)min((long long)grid, tiles);
  capture_head_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)x, (float*)out_a, (float*)out_b, k_total, d,
      rotate, interleaved, scale, rows, stages, stage_bytes);
  return (int)cudaGetLastError();
}
