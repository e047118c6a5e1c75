// KQ: the activation quantize, float -> int8 on the activation grid:
//   q = clamp(rint(x / scale - zero), qmin, qmax)   (- 128 when qmin >= 0)
// over any contiguous float32 or bf16 tensor, computed in float32 with a
// true division (__fdiv_rn), then one subtraction (__fsub_rn), rounding
// half to even (rintf), exactly as quantize_tpu/ops/pallas/qmatmul.py:
// quantize_act_int8 and its plain version in ops/qmatmul.py; scale and zero
// are read from device memory, so the launch needs no host sync.
//
// Replaces no pallas_call: in JAX this is an XLA elementwise fusion (inside
// quant_conv2d, ops/qconv.py:90, and the W8A8/W4A8 dense inputs), which the
// port had run as five torch passes over the whole activation. On the H100
// it is bound by bytes: (itemsize + 1) bytes a value, read once and written
// once. Each thread takes 16 values at a time (four 16-byte loads of f32 or
// two of bf16, one 16-byte store of int8) in a grid-stride loop; the tail
// past the last 16 values, or a tensor not 16-byte aligned, takes one value
// at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks of 256 threads for each SM of an H100

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// one value: clamp(rint(x / s - z), lo, hi) - shift, as an int8
__device__ __forceinline__ uint32_t quant1(float x, float s, float z, float lo, float hi,
                                           int shift) {
  const float q = fminf(fmaxf(rintf(__fsub_rn(__fdiv_rn(x, s), z)), lo), hi);
  return (uint32_t)(uint8_t)(int8_t)((int)q - shift);
}

// 16 values from 16-byte aligned memory
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the bits move up 16 places
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        const float* __restrict__ scale_p, const float* __restrict__ zero_p,
                        int64_t n, int qmin, int qmax, bool vec) {
  const float s = *scale_p, z = *zero_p;
  const float lo = (float)qmin, hi = (float)qmax;
  const int shift = qmin >= 0 ? 128 : 0;
  const int64_t stride = (int64_t)gridDim.x * NTHREADS;
  const int64_t first = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  const int64_t nvec = vec ? n / 16 : 0;
  for (int64_t i = first; i < nvec; i += stride) {
    float v[16];
    load16(x + i * 16, v);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e >> 2] |= quant1(v[e], s, z, lo, hi, shift) << (8 * (e & 3));
    reinterpret_cast<uint4*>(q)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // the tail past the last 16 values (or all of an unaligned tensor)
  for (int64_t i = nvec * 16 + first; i < n; i += stride)
    q[i] = (int8_t)quant1(to_f(x[i]), s, z, lo, hi, shift);
}

template <typename T>
int launch(const void* x, void* q, const void* scale, const void* zero, int64_t n, int qmin,
           int qmax, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15u) == 0;
  const int64_t units = vec ? (n / 16 > 0 ? n / 16 : n) : n;
  int64_t blocks = (units + NTHREADS - 1) / NTHREADS;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  quantize_act_kernel<T><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      (const T*)x, (int8_t*)q, (const float*)scale, (const float*)zero, n, qmin, qmax, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16. scale and zero point to one float32
// each on the device; q receives n int8 values.
extern "C" int qtt_quantize_act(const void* x, void* q, const void* scale, const void* zero,
                                long long n, int qmin, int qmax, int in_dtype, void* stream) {
  if (n < 0 || qmin > qmax || qmin < -128 || qmax > 255) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0) return launch<float>(x, q, scale, zero, (int64_t)n, qmin, qmax, s);
  if (in_dtype == 1) return launch<__nv_bfloat16>(x, q, scale, zero, (int64_t)n, qmin, qmax, s);
  return (int)cudaErrorInvalidValue;
}
