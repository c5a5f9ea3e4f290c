// head.cuh: the rx_fm capture head of one output sample, integer-exact.
//
// CS16 rescale x128/32767 (rtl_fm.c:845-848), fs/4 derotation
// (rtl_fm.c:309-327) and boxcar decimation by D (rtl_fm.c:351-371):
//
//   z[k] = SCALE * sum_j (I + jQ)[Dk + j] * i^(Dk + j),  j = 0 .. D-1
//        = SCALE * i^g * sum_c i^c * S_c,   g = Dk mod 4,
//
// with S_c the sum of the pairs whose row position j has j mod 4 == c.
// Each pair's share of i^c * S_c goes into the int32 Re and Im sums with
// one __dp2a_lo each (int16 I and Q against int8 coefficients in {-1, 0,
// 1}), with no per-pair select: unrolling fixes each load's class.  The
// sum is rotated once by the group phase g.  Integer sums are exact in any
// order, so the result equals the plain PyTorch version bit for bit after
// the one float32 multiply by the scale.
//
// Rows are read as 8-byte units where D is even: a row of D pairs is D/2
// units, so a warp whose threads read rows at a stride of D/2 units hits
// 16 distinct bank pairs per half-warp when D/2 is odd (D = 6, 14, ...),
// where 4-byte reads at a stride of D words would collide two ways.  Odd
// D reads 4-byte words, a stride coprime to the 32 banks.

#pragma once

#include <stdint.h>

namespace rx {

// Coefficient words of __dp2a_lo for each phase class c: byte 0 multiplies
// I, byte 1 multiplies Q, so one instruction adds a pair's share of
// (I + jQ) * i^c to Re or Im:  c = 0: (I, Q); 1: (-Q, I); 2: (-I, -Q);
// 3: (Q, -I).  Without the fs/4 rotation every class is (I, Q).
struct Coefs {
  int re[4], im[4];
};

__device__ __forceinline__ Coefs class_coefs(int rotate) {
  if (rotate)
    return {{0x0001, 0xff00, 0x00ff, 0x0100}, {0x0100, 0x0001, 0xff00, 0x00ff}};
  return {{0x0001, 0x0001, 0x0001, 0x0001}, {0x0100, 0x0100, 0x0100, 0x0100}};
}

// one short2 word (I low, Q high) of class C
template <int C>
__device__ __forceinline__ void add_pair(uint32_t w, const Coefs& k, int& re,
                                         int& im) {
  re = __dp2a_lo((int)w, k.re[C & 3], re);
  im = __dp2a_lo((int)w, k.im[C & 3], im);
}

// n 8-byte units (two pairs each) whose first pair has class C0
template <int C0>
__device__ __forceinline__ void add_units(const uint2* p, int n,
                                          const Coefs& k, int& re, int& im) {
  int u = 0;
#pragma unroll 2
  for (; u + 2 <= n; u += 2) {
    const uint2 a = p[u], b = p[u + 1];
    add_pair<C0>(a.x, k, re, im);
    add_pair<C0 + 1>(a.y, k, re, im);
    add_pair<C0 + 2>(b.x, k, re, im);
    add_pair<C0 + 3>(b.y, k, re, im);
  }
  if (u < n) {
    const uint2 a = p[u];
    add_pair<C0>(a.x, k, re, im);
    add_pair<C0 + 1>(a.y, k, re, im);
  }
}

// The head's integer sum of output sample k (before the scale) from the d
// pairs at row (4-byte aligned; shared or global memory): each pair added
// by its phase class, then the sum rotated once by i^g, g = (k * d) mod 4.
__device__ __forceinline__ void head_sum(const uint32_t* row, long long k,
                                         int d, int rotate, int* re,
                                         int* im) {
  const Coefs c = class_coefs(rotate);
  int r = 0, m = 0;
  if (d & 1) {
    int j = 0;
#pragma unroll 2
    for (; j + 4 <= d; j += 4) {
      add_pair<0>(row[j], c, r, m);
      add_pair<1>(row[j + 1], c, r, m);
      add_pair<2>(row[j + 2], c, r, m);
      add_pair<3>(row[j + 3], c, r, m);
    }
    if (j < d) add_pair<0>(row[j], c, r, m);
    if (j + 1 < d) add_pair<1>(row[j + 1], c, r, m);
    if (j + 2 < d) add_pair<2>(row[j + 2], c, r, m);
  } else if ((reinterpret_cast<uintptr_t>(row) & 7) == 0) {
    add_units<0>(reinterpret_cast<const uint2*>(row), d >> 1, c, r, m);
  } else {
    // row 4 bytes off an 8-byte boundary: pair 0 alone, pairs 1 .. d-2 as
    // units, pair d-1 (class 1 or 3, as d is even) alone
    add_pair<0>(row[0], c, r, m);
    add_units<1>(reinterpret_cast<const uint2*>(row + 1), (d - 2) >> 1, c, r,
                 m);
    if (d & 2)
      add_pair<1>(row[d - 1], c, r, m);
    else
      add_pair<3>(row[d - 1], c, r, m);
  }
  if (rotate) {
    const int g = static_cast<int>((k * d) & 3);
    if (g & 1) {  // * i: (r, m) -> (-m, r)
      const int t = r;
      r = -m;
      m = t;
    }
    if (g & 2) {  // * -1
      r = -r;
      m = -m;
    }
  }
  *re = r;
  *im = m;
}

}  // namespace rx
