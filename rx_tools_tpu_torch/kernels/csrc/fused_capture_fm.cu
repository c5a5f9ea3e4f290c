// fused_capture_fm: capture head + fast-atan FM discriminator + squelch-level
// partials in one pass, on Hopper (sm_90a).
//
// Replaces the TPU kernel rx_tools_tpu/ops/fused_frontend.py fused_capture_fm
// (K2, body _fused_kernel): CS16 rescale, fs/4 derotation and boxcar decimate
// by D (the capture head, as in capture_head.cu), then c = z * conj(prev) and
// the fast-atan octant blend with one divide (rtl_fm.c:485-513), then the
// per-tile sums sum(zi + zq) and sum(zi^2 + zq^2) of the RMS level
// (rtl_fm.c:739-757).  Sample 0 of every block keeps the std atan2 quirk of
// fm_demod (rtl_fm.c:588-590), computed here in the kernel.
//
// What bounds it on the H100: bytes, (4N + 4K) of them: the int16 input once
// and the float discriminator stream once; the level partials are a few bytes
// per CTA.  About 20 float operations per output sample stay far below the
// card's rate.
//
// What the design does about it:
// - the decimated stream z never leaves the SM: each CTA keeps its tile of z
//   in shared memory and writes only the discriminator output;
// - the TPU kernel carried the previous tile's last sample in SMEM scratch
//   across a grid that runs in order; Hopper runs CTAs in no order, so each
//   CTA recomputes z[k0 - 1] from its own 2*D int16 values (a one-sample halo)
//   and sample 0 of the chunk takes the carried prev_iq;
// - CTAs never straddle a block (grid = tiles per block x blocks), so every
//   block's level comes from its own CTAs' partials; the partials are written
//   out and a second, one-thread-per-block kernel sums them in a fixed order
//   and forms the RMS level: no float atomics, reruns give identical levels;
// - every product and sum is written with the _rn intrinsics (and the file is
//   built with --fmad=false), so no multiply-add is contracted and the output
//   equals the plain PyTorch version's elementwise arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;

__device__ __forceinline__ void head(const short2* s, long long k, int d,
                                     int rotate, float scale, float* zr,
                                     float* zj) {
  int re = 0, im = 0;
  for (int j = 0; j < d; ++j) {
    const int i_v = s[j].x;
    const int q_v = s[j].y;
    const int m = rotate ? (int)((k * d + j) & 3) : 0;
    switch (m) {
      case 0: re += i_v; im += q_v; break;
      case 1: re -= q_v; im += i_v; break;
      case 2: re -= i_v; im -= q_v; break;
      default: re += q_v; im -= i_v; break;
    }
  }
  *zr = __fmul_rn((float)re, scale);
  *zj = __fmul_rn((float)im, scale);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kTile)
fused_capture_fm_kernel(const short2* __restrict__ x,
                        const float* __restrict__ prev_iq,
                        float* __restrict__ d_out,
                        float* __restrict__ partials,
                        float* __restrict__ last, long long k_per_block,
                        long long k_total, int d, int rotate, float scale) {
  extern __shared__ short2 tile[];            // (kTile + 1) * d pairs
  __shared__ float zi_s[kTile + 1], zq_s[kTile + 1];
  __shared__ float red[2][kTile / 32];

  const int tid = threadIdx.x;
  const long long blk = blockIdx.y;
  const long long local0 = (long long)blockIdx.x * kTile;
  const int rows = (int)min((long long)kTile, k_per_block - local0);
  const long long k0 = blk * k_per_block + local0;
  const int halo = k0 > 0 ? 1 : 0;

  // stage the int16 pairs of samples k0 - halo .. k0 + rows - 1
  const short2* src = x + (k0 - halo) * d;
  const int count = (rows + halo) * d;
  for (int i = tid; i < count; i += kTile) tile[i] = src[i];
  __syncthreads();

  if (tid < rows)
    head(tile + (tid + halo) * d, k0 + tid, d, rotate, scale, &zi_s[tid + 1],
         &zq_s[tid + 1]);
  if (tid == 0) {
    if (halo) {
      head(tile, k0 - 1, d, rotate, scale, &zi_s[0], &zq_s[0]);
    } else {
      zi_s[0] = prev_iq[0];
      zq_s[0] = prev_iq[1];
    }
  }
  __syncthreads();

  float v1 = 0.f, v2 = 0.f;
  if (tid < rows) {
    const float zi = zi_s[tid + 1], zq = zq_s[tid + 1];
    const float pi = zi_s[tid], pq = zq_s[tid];
    const float cr = __fadd_rn(__fmul_rn(zi, pi), __fmul_rn(zq, pq));
    const float cj = __fsub_rn(__fmul_rn(zq, pi), __fmul_rn(zi, pq));
    float out;
    if (local0 + tid == 0) {
      // block seam: std atan2, pi == 1 << 14 with the reference's 3.14159
      const float a = (float)atan2((double)cj, (double)cr);
      out = __fmul_rn(__fdiv_rn(a, 3.14159f), 16384.0f);
    } else {
      const float yabs = fabsf(cj);
      const bool pos = cr >= 0.f;
      const float num = pos ? __fsub_rn(cr, yabs) : __fadd_rn(cr, yabs);
      const float den = pos ? __fadd_rn(cr, yabs) : __fsub_rn(yabs, cr);
      const float base = pos ? 4096.0f : 12288.0f;
      float ang = __fsub_rn(base, __fmul_rn(4096.0f, __fdiv_rn(num, den)));
      if (cr == 0.f && cj == 0.f) ang = 0.f;   // 0/0 by a select, not a multiply
      out = cj < 0.f ? -ang : ang;
    }
    d_out[k0 + tid] = out;
    v1 = __fadd_rn(zi, zq);
    v2 = __fadd_rn(__fmul_rn(zi, zi), __fmul_rn(zq, zq));
    if (k0 + tid == k_total - 1) {
      last[0] = zi;
      last[1] = zq;
    }
  }

  // fixed-order CTA reduction of the level partials
  v1 = warp_sum(v1);
  v2 = warp_sum(v2);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red[0][warp] = v1;
    red[1][warp] = v2;
  }
  __syncthreads();
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < kTile / 32; ++w) {
      s1 = __fadd_rn(s1, red[0][w]);
      s2 = __fadd_rn(s2, red[1][w]);
    }
    const long long g = blk * gridDim.x + blockIdx.x;
    partials[2 * g] = s1;
    partials[2 * g + 1] = s2;
  }
}

// one thread per block: the block's CTA partials in order, then the
// reference's DC-corrected RMS (rtl_fm.c:739-757) over n = 2 * k_per_block
__global__ void fused_levels_kernel(const float* __restrict__ partials,
                                    float* __restrict__ levels,
                                    long long n_blocks, int tiles, float n) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const float* p = partials + 2 * b * tiles;
  float t = 0.f, s = 0.f;
  for (int i = 0; i < tiles; ++i) {
    t = __fadd_rn(t, p[2 * i]);
    s = __fadd_rn(s, p[2 * i + 1]);
  }
  const float dc = __fdiv_rn(t, n);
  const float err = __fsub_rn(__fmul_rn(__fmul_rn(t, 2.0f), dc),
                              __fmul_rn(__fmul_rn(dc, dc), n));
  levels[b] = __fsqrt_rn(__fdiv_rn(fmaxf(__fsub_rn(s, err), 0.0f), n));
}

}  // namespace

extern "C" int rx_fused_tile() { return kTile; }

extern "C" int rx_fused_capture_fm(const void* x, const void* prev_iq,
                                   void* d_out, void* partials, void* levels,
                                   void* last, long long n_blocks,
                                   long long k_per_block, int d, int rotate,
                                   float scale, void* stream) {
  if (n_blocks <= 0 || k_per_block <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(kTile + 1) * d * sizeof(short2);
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_capture_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (k_per_block + kTile - 1) / kTile;
  dim3 grid((unsigned)tiles, (unsigned)n_blocks);
  fused_capture_fm_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const short2*)x, (const float*)prev_iq, (float*)d_out,
      (float*)partials, (float*)last, k_per_block, n_blocks * k_per_block, d,
      rotate, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_levels_kernel<<<(unsigned)((n_blocks + 127) / 128), 128, 0,
                        (cudaStream_t)stream>>>(
      (const float*)partials, (float*)levels, n_blocks, (int)tiles,
      (float)(2 * k_per_block));
  return (int)cudaGetLastError();
}
