// I/Q wire-format codecs - the native hot path of rx_sdr's convert loop.
//
// Semantics are the reference's exactly (src/rtl_sdr.c:348-391 and the
// capture rescale src/rtl_fm.c:845-848): C double->int truncation toward
// zero, the +0.4 / +127.4 rounding biases, CS12 little-endian nibble
// packing.  The Python layer (rx_tools_tpu_torch/iq/formats.py) uses these
// for host numpy arrays when the library is built; the tests hold them
// against its NumPy implementations and the C oracle.
//
// Plain C ABI for ctypes; buffers are caller-allocated.  All loops are
// branch-free per element so the compiler auto-vectorizes.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// CS16 -> CS8: (int8_t)(x / 32767.0 * 128.0 + 0.4)   (rtl_sdr.c:367-374)
void rx_cs16_to_cs8(const int16_t* in, int8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (int8_t)(int)(in[i] / 32767.0 * 128.0 + 0.4);
    }
}

// CS16 -> CU8: (uint8_t)(x / 32767.0 * 128.0 + 127.4)  (rtl_sdr.c:375-382)
void rx_cs16_to_cu8(const int16_t* in, uint8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (uint8_t)(int)(in[i] / 32767.0 * 128.0 + 127.4);
    }
}

// CS16 -> CF32: x / 32767.0   (rtl_sdr.c:383-391, SHRT_MAX)
void rx_cs16_to_cf32(const int16_t* in, float* out, int64_t n) {
    // divide (not reciprocal-multiply) for bit parity with the float32
    // division in iq/formats.py
    for (int64_t i = 0; i < n; ++i) out[i] = (float)in[i] / 32767.0f;
}

// capture rescale kept in int16: (int16_t)(x / 32767.0 * 128.0 + 0.4)
// (rtl_fm.c:845-848 - preserves rtl_fm's 8-bit numerics)
void rx_cs16_rescale8(const int16_t* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (int16_t)(int)(in[i] / 32767.0 * 128.0 + 0.4);
    }
}

// Widening conversions: framework-defined, matching iq/formats.py exactly.
// CU8 -> CS16: (v - 128) << 8 (rtl-sdr driver idiom)
void rx_cu8_to_cs16(const uint8_t* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (int16_t)(((int16_t)in[i] - 128) << 8);
    }
}

void rx_cs8_to_cs16(const int8_t* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (int16_t)((int16_t)in[i] << 8);
    }
}

// round-half-even + clip, matching numpy's np.round
void rx_cf32_to_cs16(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = nearbyintf(in[i] * 32767.0f);
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        out[i] = (int16_t)v;
    }
}

// CS12 -> CS16: 3 bytes -> 2 samples (rtl_sdr.c:354-366)
//   s0 = (b1 << 12) | (b0 << 4);  s1 = (b2 << 8) | (b1 & 0xf0)
void rx_cs12_to_cs16(const uint8_t* in, int16_t* out, int64_t n_triples) {
    for (int64_t i = 0; i < n_triples; ++i) {
        const uint8_t b0 = in[3 * i], b1 = in[3 * i + 1], b2 = in[3 * i + 2];
        out[2 * i]     = (int16_t)(uint16_t)(((uint16_t)b1 << 12) | ((uint16_t)b0 << 4));
        out[2 * i + 1] = (int16_t)(uint16_t)(((uint16_t)b2 << 8)  | (uint16_t)(b1 & 0xf0));
    }
}

// CS16 -> CS12 (inverse packing; low nibbles dropped)
void rx_cs16_to_cs12(const int16_t* in, uint8_t* out, int64_t n_pairs) {
    for (int64_t i = 0; i < n_pairs; ++i) {
        const uint16_t s0 = (uint16_t)in[2 * i], s1 = (uint16_t)in[2 * i + 1];
        out[3 * i]     = (uint8_t)((s0 >> 4) & 0xff);
        out[3 * i + 1] = (uint8_t)(((s0 >> 12) & 0x0f) | (s1 & 0xf0));
        out[3 * i + 2] = (uint8_t)((s1 >> 8) & 0xff);
    }
}

}  // extern "C"
