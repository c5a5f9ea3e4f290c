// fused_capture_fm: capture head + fast-atan FM discriminator + squelch levels
// in one launch, on Hopper (sm_90a).
//
// Replaces the TPU kernel rx_tools_tpu/ops/fused_frontend.py fused_capture_fm
// (K2, body _fused_kernel): CS16 rescale, fs/4 derotation and boxcar decimate
// by D (the capture head, head.cuh), then c = z * conj(prev) and the
// fast-atan octant blend with one divide (rtl_fm.c:485-513), then each
// block's RMS level from the sums sum(zi + zq) and sum(zi^2 + zq^2)
// (rtl_fm.c:739-757).  Sample 0 of every block keeps the std atan2 quirk of
// fm_demod (rtl_fm.c:588-590), computed here in the kernel.
//
// What bounds it on the H100: bytes, (4N + 4K) of them: the int16 input once
// and the float discriminator stream once; the level partials are 8 bytes
// per tile.  About 20 float operations per output sample stay far below the
// card's rate.
//
// What the design does about it:
// - persistent CTAs (one resident wave) each walk a contiguous run of tiles
//   of `rows` output samples (one a thread), fed by a ring of shared-memory
//   stages that one thread fills with 1-D bulk copies (ring.cuh): the next
//   tiles' loads are in flight while a tile computes;
// - the decimated stream z never leaves the SM: a tile's z sits in shared
//   memory for the discriminator, which writes only its output;
// - the TPU kernel carried the previous tile's last sample in SMEM scratch
//   across a grid that runs in order; here the carry comes back inside a
//   CTA's run: the sample before tile t+1 is the last sample of tile t, which
//   the same CTA just computed.  Only the first tile of a run recomputes
//   z[k0 - 1] from its 2*D int16 values, or takes prev_iq at k = 0;
// - tiles never straddle a block; each tile writes its two level partials
//   (a fixed-order sum over its threads), and the last CTA to finish, found
//   by an integer ticket (an acquire-release atomicAdd on a counter the
//   wrapper zeroes once), sums each block's partials in tile order and writes the
//   RMS levels, then resets the counter.  No float atomics; the tile size
//   depends on D alone, so the levels are the same on every run and at every
//   grid size;
// - every product and sum is written with the _rn intrinsics (and the file is
//   built with --fmad=false), so no multiply-add is contracted and the output
//   equals the plain PyTorch version's elementwise arithmetic.
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// the reference's DC-corrected RMS (rtl_fm.c:739-757) of a block from its
// sums t = sum(zi + zq) and s = sum(zi^2 + zq^2) over n = 2 * k_per_block
__device__ __forceinline__ float rms_level(float t, float s, float n) {
  const float dc = __fdiv_rn(t, n);
  const float err = __fsub_rn(__fmul_rn(__fmul_rn(t, 2.0f), dc),
                              __fmul_rn(__fmul_rn(dc, dc), n));
  return __fsqrt_rn(__fdiv_rn(fmaxf(__fsub_rn(s, err), 0.0f), n));
}

__device__ __forceinline__ void head_z(const unsigned char* row, long long k,
                                       int d, int rotate, float scale,
                                       float* zr, float* zj) {
  int re, im;
  rx::head_sum(reinterpret_cast<const uint32_t*>(row), k, d, rotate, &re,
               &im);
  *zr = __fmul_rn((float)re, scale);
  *zj = __fmul_rn((float)im, scale);
}

// the fast-atan discriminator of z against prev (rtl_fm.c:485-513), or the
// std atan2 of fm_demod at a block seam (rtl_fm.c:588-590)
__device__ __forceinline__ float discriminate(float zi, float zq, float pi,
                                              float pq, bool seam) {
  const float cr = __fadd_rn(__fmul_rn(zi, pi), __fmul_rn(zq, pq));
  const float cj = __fsub_rn(__fmul_rn(zq, pi), __fmul_rn(zi, pq));
  if (seam) {  // pi == 1 << 14 with the reference's 3.14159
    const float a = (float)atan2((double)cj, (double)cr);
    return __fmul_rn(__fdiv_rn(a, 3.14159f), 16384.0f);
  }
  const float yabs = fabsf(cj);
  const bool pos = cr >= 0.f;
  const float num = pos ? __fsub_rn(cr, yabs) : __fadd_rn(cr, yabs);
  const float den = pos ? __fadd_rn(cr, yabs) : __fsub_rn(yabs, cr);
  const float base = pos ? 4096.0f : 12288.0f;
  float ang = __fsub_rn(base, __fmul_rn(4096.0f, __fdiv_rn(num, den)));
  if (cr == 0.f && cj == 0.f) ang = 0.f;  // 0/0 by a select
  return cj < 0.f ? -ang : ang;
}

// a tile of the CTA's run as (block, tile within the block): advanced by
// one tile at a time, so no division runs per tile
struct Cursor {
  long long blk;
  int loc;
};

__global__ void __launch_bounds__(kMaxThreads)
fused_capture_fm_kernel(const unsigned char* __restrict__ x,
                        const float* __restrict__ prev_iq,
                        float* __restrict__ d_out, float* __restrict__ partials,
                        float* __restrict__ levels, float* __restrict__ last,
                        unsigned int* __restrict__ counter,
                        long long n_blocks, long long k_per_block, int d,
                        int rotate, float scale, int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ float zi_s[kMaxThreads], zq_s[kMaxThreads];
  __shared__ float red[2][kMaxThreads / 32];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int rows = threads;                // one thread per output sample
  const int warps = threads / 32;
  const int row_bytes = 4 * d;
  const int tpb = (int)((k_per_block + rows - 1) / rows);
  const long long k_total = n_blocks * k_per_block;
  long long t0, t1;
  rx::cta_run(n_blocks * tpb, &t0, &t1);
  const int n = (int)(t1 - t0);
  const Cursor first = {t0 / tpb, (int)(t0 % tpb)};
  auto advance = [&](Cursor& c) {
    if (++c.loc == tpb) {
      c.loc = 0;
      ++c.blk;
    }
  };
  auto tile_k0 = [&](const Cursor& c) {
    return c.blk * k_per_block + (long long)c.loc * rows;
  };
  auto tile_rows = [&](const Cursor& c) {
    return (int)min((long long)rows, k_per_block - (long long)c.loc * rows);
  };
  // the run's first tile also brings the row of z[k0 - 1] (the halo)
  const int first_halo = tile_k0(first) > 0 ? 1 : 0;
  Cursor pc = first;  // the producer's next tile
  auto issue = [&](int i) {
    const int h = i == 0 ? first_halo : 0;
    rx::bulk_load(ring + (size_t)(i % stages) * stage_bytes,
                  x + (tile_k0(pc) - h) * row_bytes,
                  (size_t)(tile_rows(pc) + h) * row_bytes,
                  &full[i % stages]);
    advance(pc);
  };

  // thread 0 carries z of the sample before the current tile: prev_iq
  // before the chunk's first sample, else the halo row, then each tile's
  // last sample.  The first copies fly while the others reach the barrier.
  float pi = 0.f, pq = 0.f;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) rx::mbar_init(&full[s], 1);
    rx::mbar_fence_init();
    for (int i = 0; i < min(n, stages); ++i) issue(i);
    pi = prev_iq[0];
    pq = prev_iq[1];
  }
  __syncthreads();

  Cursor cc = first;  // the consumers' tile
  for (int i = 0; i < n; ++i, advance(cc)) {
    const int s = i % stages;
    const long long k0 = tile_k0(cc);
    const int r = tile_rows(cc);
    const int h = i == 0 ? first_halo : 0;
    const unsigned char* src = x + (k0 - h) * row_bytes;
    const unsigned char* tile = ring + (size_t)s * stage_bytes +
                                (reinterpret_cast<uintptr_t>(src) & 15) +
                                h * row_bytes;
    rx::mbar_wait(&full[s], (uint32_t)(i / stages) & 1u);

    if (tid == 0 && h)
      head_z(tile - row_bytes, k0 - 1, d, rotate, scale, &pi, &pq);
    float zi = 0.f, zq = 0.f;
    if (tid < r) {
      head_z(tile + tid * row_bytes, k0 + tid, d, rotate, scale, &zi, &zq);
      zi_s[tid] = zi;
      zq_s[tid] = zq;
    }
    __syncthreads();  // z tile complete; every thread is done with stage s
    if (tid == 0 && i + stages < n) issue(i + stages);

    // the discriminator, and this sample's level terms
    float v1 = 0.f, v2 = 0.f;
    if (tid < r) {
      float ppi, ppq;
      if (tid == 0) {
        ppi = pi;
        ppq = pq;
        pi = zi_s[r - 1];  // the carry into the next tile
        pq = zq_s[r - 1];
      } else {
        ppi = zi_s[tid - 1];
        ppq = zq_s[tid - 1];
      }
      d_out[k0 + tid] =
          discriminate(zi, zq, ppi, ppq, cc.loc == 0 && tid == 0);
      v1 = __fadd_rn(zi, zq);
      v2 = __fadd_rn(__fmul_rn(zi, zi), __fmul_rn(zq, zq));
      if (k0 + tid == k_total - 1) {
        last[0] = zi;
        last[1] = zq;
      }
    }

    // the tile's level partials, in a fixed order
    v1 = warp_sum(v1);
    v2 = warp_sum(v2);
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = v1;
      red[1][tid >> 5] = v2;
    }
    __syncthreads();
    if (tid < 32) {  // warp 0: a fixed tree over the warps' sums
      float s1 = tid < warps ? red[0][tid] : 0.f;
      float s2 = tid < warps ? red[1][tid] : 0.f;
      for (int off = kMaxThreads / 64; off > 0; off >>= 1) {
        s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, off));
        s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, off));
      }
      if (tid == 0) {
        const long long t = cc.blk * tpb + cc.loc;
        partials[2 * t] = s1;
        partials[2 * t + 1] = s2;
      }
    }
  }

  // the last CTA to finish forms the levels: the ticket's release orders
  // this CTA's partials before it, its acquire orders every partial before
  // the last CTA's reads
  if (tid == 0) {
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counter)
                 : "memory");
    is_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  const float nf = (float)(2 * k_per_block);
  // each block's tile partials in tile order, staged through the (now
  // idle) ring in groups of blocks, tile-major so that the threads that
  // sum one block each read distinct banks
  float* ps = reinterpret_cast<float*>(ring);
  const int fit = (int)min(n_blocks, (long long)stages * stage_bytes /
                                         (8LL * tpb));
  if (fit == 0) {  // blocks of very many tiles: sum straight from memory
    for (long long b = tid; b < n_blocks; b += threads) {
      const float* p = partials + 2 * b * tpb;
      float ts = 0.f, ss = 0.f;
      for (int j = 0; j < tpb; ++j) {
        ts = __fadd_rn(ts, __ldcg(p + 2 * j));
        ss = __fadd_rn(ss, __ldcg(p + 2 * j + 1));
      }
      levels[b] = rms_level(ts, ss, nf);
    }
  }
  for (long long b0 = 0; fit > 0 && b0 < n_blocks; b0 += fit) {
    const int nb = (int)min((long long)fit, n_blocks - b0);
    const int cnt = 2 * nb * tpb;
    const float* src = partials + 2 * b0 * tpb;
    for (int q0 = tid; q0 < cnt; q0 += 8 * threads) {
      float v[8];  // eight loads in flight before any store
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u * threads;
        v[u] = q < cnt ? __ldcg(src + q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u * threads;
        const int b = q / (2 * tpb);  // q = 2 (b tpb + j) + c
        if (q < cnt) ps[(q - b * 2 * tpb) * nb + b] = v[u];
      }
    }
    __syncthreads();
    for (int b = tid; b < nb; b += threads) {
      float ts = 0.f, ss = 0.f;
#pragma unroll 4
      for (int j = 0; j < tpb; ++j) {
        ts = __fadd_rn(ts, ps[2 * j * nb + b]);
        ss = __fadd_rn(ss, ps[(2 * j + 1) * nb + b]);
      }
      levels[b0 + b] = rms_level(ts, ss, nf);
    }
    __syncthreads();
  }
  if (tid == 0) *counter = 0u;
}

}  // namespace

// CTAs of a plan (rows, threads, smem bytes of ring) that fit on one SM at
// once (registers included); 0 on error.
extern "C" int rx_fused_capture_fm_ctas_per_sm(int rows, int threads,
                                               int smem) {
  (void)rows;  // one row a thread
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(fused_capture_fm_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_capture_fm_kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

// rows (= threads), stages, stage_bytes and grid come from kernels/plan.py;
// the grid is cut to the number of tiles.  partials holds 2 floats per tile
// (n_blocks * ceil(k_per_block / rows) tiles); counter is a zeroed uint32
// that the kernel leaves at zero.  One launch.  Returns cudaGetLastError()
// after it.
extern "C" int rx_fused_capture_fm(const void* x, const void* prev_iq,
                                   void* d_out, void* partials, void* levels,
                                   void* last, void* counter,
                                   long long n_blocks, long long k_per_block,
                                   int d, int rotate, float scale, int rows,
                                   int threads, int stages, int stage_bytes,
                                   int grid, void* stream) {
  if (n_blocks <= 0 || k_per_block <= 0) return (int)cudaSuccess;
  const long long need = ((rows + 1) * 4LL * d + 15) / 16 * 16 + 16;
  if (d < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      rows != threads || stages < 1 || stages > kMaxStages ||
      stage_bytes % 16 || stage_bytes < need || grid < 1 ||
      ((uintptr_t)x & 3))
    return (int)cudaErrorInvalidValue;
  const int smem = stages * stage_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_capture_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = n_blocks * ((k_per_block + rows - 1) / rows);
  const unsigned blocks = (unsigned)min((long long)grid, tiles);
  fused_capture_fm_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)x, (const float*)prev_iq, (float*)d_out,
      (float*)partials, (float*)levels, (float*)last, (unsigned int*)counter,
      n_blocks, k_per_block, d, rotate, scale, stages, stage_bytes);
  return (int)cudaGetLastError();
}
