// Host-side dense bit packing/unpacking (C++ core of the engine layer).
//
// Native host-side counterpart of the dense tpack/tunpack: checkpoint IO and
// weight preprocessing pack and unpack large tensors without the bit-plane
// overhead of the plain torch version. The bit layout matches
// quantize_tpu_torch/quant/pack.py exactly (element bits LSB-first, stream in
// element order, bytes LSB-first), so both paths round-trip each other's
// buffers. A copy of the JAX package's engine/native/tpack.cpp.
//
// Exposed via ctypes; built with g++ at first use by
// quantize_tpu_torch/engine/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack n int32 values (already offset to unsigned range) of b bits each into
// out (ceil(n*b/8) bytes, caller-allocated, zero-initialized).
void tpack_u32(const int32_t* vals, int64_t n, int32_t bits, uint8_t* out) {
    int64_t bitpos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = static_cast<uint32_t>(vals[i]) & ((1u << bits) - 1u);
        int64_t byte = bitpos >> 3;
        int off = static_cast<int>(bitpos & 7);
        // value may straddle up to 2 bytes for bits <= 8
        uint32_t cur = static_cast<uint32_t>(out[byte]) | (v << off);
        out[byte] = static_cast<uint8_t>(cur & 0xFF);
        if (off + bits > 8) {
            out[byte + 1] = static_cast<uint8_t>((cur >> 8) & 0xFF);
        }
        bitpos += bits;
    }
}

// Unpack n b-bit values from packed stream into vals (int32, still in the
// unsigned domain; caller applies the signed offset).
void tunpack_u32(const uint8_t* packed, int64_t n, int32_t bits, int32_t* vals) {
    int64_t bitpos = 0;
    uint32_t mask = (1u << bits) - 1u;
    for (int64_t i = 0; i < n; ++i) {
        int64_t byte = bitpos >> 3;
        int off = static_cast<int>(bitpos & 7);
        uint32_t lo = packed[byte];
        uint32_t hi = (off + bits > 8) ? packed[byte + 1] : 0u;
        vals[i] = static_cast<int32_t>(((lo | (hi << 8)) >> off) & mask);
        bitpos += bits;
    }
}

// Quantize float -> int grid (round(x/scale - zero), clamp) per channel.
// channel_stride semantics: channel index = (i / inner) % n_channels.
void quantize_channel_f32(
    const float* x, int64_t n, const float* scale, const float* zero,
    int64_t n_channels, int64_t inner, int32_t qmin, int32_t qmax,
    int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = (i / inner) % n_channels;
        float v = x[i] / scale[c] - zero[c];
        float r = v >= 0.0f ? static_cast<float>(static_cast<int64_t>(v + 0.5f))
                            : static_cast<float>(static_cast<int64_t>(v - 0.5f));
        // round-half-to-even correction for exact .5 cases
        float diff = v - static_cast<int64_t>(v);
        if (diff == 0.5f || diff == -0.5f) {
            int64_t fl = static_cast<int64_t>(v > 0 ? v : v - 1);
            r = static_cast<float>((fl % 2 == 0) ? fl : fl + 1);
        }
        int32_t q = static_cast<int32_t>(r);
        if (q < qmin) q = qmin;
        if (q > qmax) q = qmax;
        out[i] = q;
    }
}

}  // extern "C"
