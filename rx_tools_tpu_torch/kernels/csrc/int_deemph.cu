// The integer de-emphasis of --int-audio: a port-only kernel.
//
// There is no Pallas kernel behind it: the reference package runs
// ops/intaudio.py::deemph_int as one compiled lax.scan.  Eager PyTorch
// would issue several launches a sample, so the recurrence runs here.
//
// What it computes (rtl_fm.c:667-682), over one block of int64 samples:
//     d = x[i] - c;  c += (d > 0 ? d + a/2 : d - a/2) / a   (C division)
//     y[i] = (int16) c   (two's complement wrap, kept as int64)
// The recurrence is sequential and nonlinear (truncating division gives it
// a dead zone of fixpoints), so it has no exact scan.  What bounds it on
// this card is the latency of the dependent chain of one walk, not bytes
// or operations, plus the ~2 us launch floor.  Two things shorten it:
//
// - Division by a reciprocal.  a is the same for every sample of a call,
//   so the host computes m and s with floor(n / a) == umulhi(2n, m) >> s
//   for every n < 2^31 (kernels/plan.py::div_magic, Granlund-Montgomery).
//   The sign of the numerator is the sign of d, so a step divides the
//   magnitude and applies the sign: seven dependent integer operations
//   (subtract, abs, multiply-add, multiply-high, shift, negate, add), no
//   emulated division.  Every walk loads its next sample one step ahead,
//   so the shared-memory load stays off the chain.
// - A segmented walk.  As a function of the carry, one step is monotone
//   with slope 0 or 1, and it never overshoots its input, so every carry
//   lies in [lo, hi], the range of {avg} and the block, and walks started
//   from lo and from hi keep the true carry between them; where they meet,
//   the carry is known from then on.  Each tile is cut into segments
//   (plan.deemph_plan: L samples, a halo of W before each).  Phase A: one
//   thread a segment walks its halo from lo and from hi, the two chains
//   interleaved, then its segment, writing outputs and counting the
//   leading samples at which the walks had not met (a halo that reaches
//   the tile's start walks from the exact carry and meets at once).
//   Phase B: warp 0 finds the segments with such samples in order and
//   lane 0 walks them from the exact carry before the segment (the exit of
//   the one before it).  So a segment costs about W + L steps when its
//   walks meet in the halo, the whole block is exact whatever the data,
//   and only constant stretches (silence with avg away from it) fall back
//   to the ordered walk.  Where W + L is not much shorter than the tile
//   the plan is one segment: the serial walk, with the fast division.
//
// The walks run on the low 32 bits of every value: while hi - lo + a/2 <
// 2^31, every difference and numerator fits 32 bits exactly.  A wider
// range (a state far outside int16) takes one serial 64-bit walk, exact
// for every int64 pair, which divides by the constants below 2^31 and
// with C's 64-bit division above.  Blocks longer than a tile walk tile by
// tile from the exact carry at the tile's end.  The new average stays on
// the card.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;        // stagers; at most this many segments
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;          // samples staged per round

struct Div {                     // floor(n / a) = umulhi(2n, magic) >> shift
    unsigned magic, shift, h2;   // h2 = 2 * (a / 2)
};

// One step on low words, exact while |d| + a/2 < 2^31 (so d is never
// INT_MIN): 2 * |numerator| = 2|d| + 2(a/2), divided, then d's sign.
__device__ __forceinline__ unsigned step32(unsigned c, unsigned v, Div k) {
    const int d = static_cast<int>(v - c);
    const unsigned n2 = 2u * static_cast<unsigned>(abs(d)) + k.h2;
    const unsigned q = __umulhi(n2, k.magic) >> k.shift;
    return d > 0 ? c + q : c - q;
}

// One step in 64 bits, exact for every int64 carry and sample: the
// magnitude |d| is exact in unsigned arithmetic, and floor((|d| + h) / a)
// never overflows when split as |d| / a + (|d| % a + h) / a.
__device__ long long step64(long long c, long long v, unsigned long long a,
                            Div k) {
    const bool up = v > c;
    const unsigned long long uc = static_cast<unsigned long long>(c);
    const unsigned long long uv = static_cast<unsigned long long>(v);
    const unsigned long long m = up ? uv - uc : uc - uv;
    const unsigned long long h = k.h2 / 2;
    const unsigned long long q = m < (1ull << 31) - h
        ? __umulhi(2u * static_cast<unsigned>(m + h), k.magic) >> k.shift
        : m / a + (m % a + h) / a;
    return static_cast<long long>(up ? uc + q : uc - q);
}

__device__ __forceinline__ long long lmin(long long p, long long q) {
    return p < q ? p : q;
}
__device__ __forceinline__ long long lmax(long long p, long long q) {
    return p > q ? p : q;
}

__global__ void __launch_bounds__(kThreads)
int_deemph_kernel(const long long* __restrict__ x, long long* __restrict__ y,
                  long long* __restrict__ avg_io, int* __restrict__ fallback,
                  long long n, long long a, Div k, int seg_len, int halo) {
    __shared__ long long buf[kTile + 1];   // + 1: walks load a step ahead
    __shared__ short out[kTile];
    __shared__ unsigned exits[kThreads];   // each segment's exit carry
    __shared__ int unmet[kThreads];        // its leading unmet samples
    __shared__ long long range[2][kWarps];
    __shared__ unsigned carry_s;           // exact carry before the tile
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long avg = *avg_io;

    // the range [lo, hi] of {avg} and the block; the first tile is staged
    long long lo = avg, hi = avg;
    for (long long i = tid; i < n; i += kThreads) {
        const long long v = x[i];
        if (i < kTile) buf[i] = v;
        lo = lmin(lo, v);
        hi = lmax(hi, v);
    }
    for (int o = 16; o; o >>= 1) {
        lo = lmin(lo, __shfl_xor_sync(~0u, lo, o));
        hi = lmax(hi, __shfl_xor_sync(~0u, hi, o));
    }
    if (lane == 0) {
        range[0][warp] = lo;
        range[1][warp] = hi;
    }
    if (tid == 0) carry_s = static_cast<unsigned>(avg);
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
        lo = lmin(lo, range[0][w]);
        hi = lmax(hi, range[1][w]);
    }
    const bool narrow = static_cast<unsigned long long>(hi)
        - static_cast<unsigned long long>(lo) < (1ull << 31) - k.h2 / 2;
    const unsigned lo32 = static_cast<unsigned>(lo);
    const unsigned hi32 = static_cast<unsigned>(hi);
    long long wide_c = avg;                // the 64-bit walk's carry
    int fb_segments = 0, fb_samples = 0;   // phase B's work (thread 0)

    for (long long base = 0; base < n; base += kTile) {
        const int len = static_cast<int>(lmin(n - base, kTile));
        if (base > 0) {
            for (int i = tid; i < len; i += kThreads) buf[i] = x[base + i];
            __syncthreads();
        }
        if (narrow) {
            const int segs = (len + seg_len - 1) / seg_len;
            if (tid < segs) {                                  // phase A
                const int s0 = tid * seg_len;
                const int s1 = s0 + seg_len < len ? s0 + seg_len : len;
                const int h0 = s0 > halo ? s0 - halo : 0;
                unsigned cl = h0 == 0 ? carry_s : lo32;
                unsigned ch = h0 == 0 ? carry_s : hi32;
                unsigned v = static_cast<unsigned>(buf[h0]);
#pragma unroll 8
                for (int i = h0; i < s0; ++i) {
                    const unsigned next = static_cast<unsigned>(buf[i + 1]);
                    cl = step32(cl, v, k);
                    ch = step32(ch, v, k);
                    v = next;
                }
                int open = 0;
#pragma unroll 8
                for (int i = s0; i < s1; ++i) {
                    const unsigned next = static_cast<unsigned>(buf[i + 1]);
                    cl = step32(cl, v, k);
                    ch = step32(ch, v, k);
                    v = next;
                    out[i] = static_cast<short>(cl);
                    open += cl != ch;
                }
                exits[tid] = cl;
                unmet[tid] = open;
            }
            __syncthreads();
            if (warp == 0) {                                   // phase B
                for (int b = 0; b < segs; b += 32) {
                    const int s = b + lane;
                    unsigned mask = __ballot_sync(~0u, s < segs
                                                  && unmet[s] > 0);
                    while (mask) {
                        const int t = b + __ffs(mask) - 1;
                        mask &= mask - 1;
                        if (lane == 0) {
                            const int s0 = t * seg_len, m = unmet[t];
                            const int s1 = s0 + seg_len < len ? s0 + seg_len
                                                              : len;
                            unsigned c = t == 0 ? carry_s : exits[t - 1];
                            unsigned v = static_cast<unsigned>(buf[s0]);
#pragma unroll 8
                            for (int i = s0; i < s0 + m; ++i) {
                                const unsigned next =
                                    static_cast<unsigned>(buf[i + 1]);
                                c = step32(c, v, k);
                                v = next;
                                out[i] = static_cast<short>(c);
                            }
                            if (s0 + m == s1) exits[t] = c;   // no meeting
                            fb_segments += 1;
                            fb_samples += m;
                        }
                    }
                }
                if (lane == 0) carry_s = exits[segs - 1];
            }
        } else if (tid == 0) {
            long long v = buf[0];
            for (int i = 0; i < len; ++i) {
                const long long next = buf[i + 1];
                wide_c = step64(wide_c, v,
                                static_cast<unsigned long long>(a), k);
                v = next;
                out[i] = static_cast<short>(wide_c);
            }
        }
        __syncthreads();
        for (int i = tid; i < len; i += kThreads) y[base + i] = out[i];
        __syncthreads();
    }
    if (tid == 0) {
        *avg_io = narrow ? lo + static_cast<long long>(carry_s - lo32)
                         : wide_c;
        if (fallback != nullptr) {
            fallback[0] = fb_segments;
            fallback[1] = fb_samples;
        }
    }
}

}  // namespace

// x, y: n int64 samples on the card; avg: one int64, read and rewritten;
// fallback: null, or two ints that receive the segments and samples the
// ordered fallback walked; a: the de-emphasis constant (positive, below
// 2**31); magic, shift: plan.div_magic(a); seg_len, halo: the segments
// of plan.deemph_plan (a tile may hold at most kThreads segments).
extern "C" int rx_int_deemph(const long long* x, long long* y, long long* avg,
                             int* fallback, long long n, long long a,
                             unsigned magic, int shift, int seg_len, int halo,
                             cudaStream_t stream) {
    const long long tile = n < kTile ? n : kTile;
    if (a < 1 || a > INT_MAX || shift < 0 || shift > 31 || seg_len < 1
            || halo < 0 || (tile + seg_len - 1) / seg_len > kThreads) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Div k{magic, static_cast<unsigned>(shift),
                static_cast<unsigned>(2 * (a / 2))};
    int_deemph_kernel<<<1, kThreads, 0, stream>>>(x, y, avg, fallback, n, a,
                                                  k, seg_len, halo);
    return static_cast<int>(cudaGetLastError());
}
