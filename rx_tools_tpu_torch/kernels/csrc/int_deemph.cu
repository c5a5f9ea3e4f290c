// The integer de-emphasis of --int-audio: a port-only kernel.
//
// There is no Pallas kernel behind it: the reference package runs
// ops/intaudio.py::deemph_int as one compiled lax.scan.  Eager PyTorch
// would issue several launches a sample, so the recurrence runs here.
//
// What it computes (rtl_fm.c:667-682), over one block of int64 samples:
//     d = x[i] - avg;  avg += (d > 0 ? d + a/2 : d - a/2) / a   (C division)
//     y[i] = (int16) avg   (two's complement wrap, kept as int64)
// The recurrence is sequential and nonlinear (truncating division gives it
// several fixpoints), so one thread walks the carry.  What bounds it on
// this card is the latency of that dependent chain, not bytes or
// operations: the block is staged through shared memory by all threads in
// tiles, so the walking thread never waits on device memory, and each
// step divides in 32 bits whenever the numerator fits (always, for the
// int16-range audio the chain feeds it), which is exact and several times
// shorter than a 64-bit division.  The new average stays on the card.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;          // int64 samples staged per round

__global__ void __launch_bounds__(kThreads)
int_deemph_kernel(const long long* __restrict__ x, long long* __restrict__ y,
                  long long* __restrict__ avg, long long n, long long a) {
    __shared__ long long buf[kTile];
    long long carry = 0;
    if (threadIdx.x == 0) carry = *avg;
    const long long half = a / 2;
    const int a32 = static_cast<int>(a);
    for (long long base = 0; base < n; base += kTile) {
        const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
        for (int i = threadIdx.x; i < len; i += kThreads) buf[i] = x[base + i];
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int i = 0; i < len; ++i) {
                const long long d = buf[i] - carry;
                const long long num = d > 0 ? d + half : d - half;
                carry += (num >= INT_MIN && num <= INT_MAX)
                    ? static_cast<long long>(static_cast<int>(num) / a32)
                    : num / a;
                buf[i] = ((carry & 0xFFFF) ^ 0x8000) - 0x8000;
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < len; i += kThreads) y[base + i] = buf[i];
        __syncthreads();
    }
    if (threadIdx.x == 0) *avg = carry;
}

}  // namespace

// x, y: n int64 samples on the card; avg: one int64, read and rewritten;
// a: the de-emphasis constant (positive, below 2**31).
extern "C" int rx_int_deemph(const long long* x, long long* y, long long* avg,
                             long long n, long long a, cudaStream_t stream) {
    int_deemph_kernel<<<1, kThreads, 0, stream>>>(x, y, avg, n, a);
    return static_cast<int>(cudaGetLastError());
}
