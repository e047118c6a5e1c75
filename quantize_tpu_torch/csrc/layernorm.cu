// K6 and K7: row LayerNorm with float32 statistics over (R, d) rows.
//
//   mu  = sum(x) / d                   (sum taken in float64, rounded once)
//   xc  = x - mu
//   var = sum(xc * xc) / d             (products in float32, sum in float64)
//   y   = (xc * (1 / sqrt(var + eps))) * g + b
//
// K6 (qtt_layernorm) writes y in the carry dtype. K7 (qtt_layernorm_q)
// quantizes it for the consumer's int8 matmul instead and writes int8:
//   q = clamp(rint(y / s_a - z_a), qmin, qmax)  [- 128 for unsigned grids]
//
// Replaces the Pallas kernels quantize_tpu/ops/pallas/layernorm.py:
// _ln_kernel (K6) and _ln_q_kernel (K7). The two sums are taken in float64
// and rounded to float32 once, and 1/sqrt is IEEE sqrt then IEEE division
// (no rsqrt approximation, no FMA contraction): every step is then
// independent of the summation order, so the kernel and its plain PyTorch
// version (ops/layernorm.py) agree bit for bit, and K7's round() decisions
// with them. The JAX package sums in float32 in XLA's order; the port
// differs from it only by that reassociation.
//
// On the H100 both are bound by bytes: one read of the (R, d) input and one
// write of the output (int8 for K7, so the normalized tensor never reaches
// device memory). One warp owns a row: lanes read neighbouring elements
// (coalesced), and the second and third passes over the row hit L1. Any d
// is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per row: the statistics (mu, 1/sqrt(var + eps)) of x[row, :d].
template <typename TI>
__device__ __forceinline__ void row_stats(const TI* __restrict__ xr, int d, float eps, int lane,
                                          float& mu, float& rstd) {
  double s = 0.0;
  for (int i = lane; i < d; i += 32) s += (double)to_f(xr[i]);
  s = warp_sum(s);
  mu = __fdiv_rn((float)s, (float)d);
  double s2 = 0.0;
  for (int i = lane; i < d; i += 32) {
    const float xc = __fsub_rn(to_f(xr[i]), mu);
    s2 += (double)__fmul_rn(xc, xc);
  }
  s2 = warp_sum(s2);
  const float var = __fdiv_rn((float)s2, (float)d);
  rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

template <typename TI>
__device__ __forceinline__ float ln_value(const TI* __restrict__ xr, int i, float mu, float rstd,
                                          const float* __restrict__ g,
                                          const float* __restrict__ b) {
  const float xc = __fsub_rn(to_f(xr[i]), mu);
  return __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), g[i]), b[i]);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(NTHREADS)
    ln_kernel(const TI* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, TO* __restrict__ out, int R, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const TI* xr = x + (int64_t)row * d;
  float mu, rstd;
  row_stats(xr, d, eps, lane, mu, rstd);
  TO* orow = out + (int64_t)row * d;
  for (int i = lane; i < d; i += 32) put(orow + i, ln_value(xr, i, mu, rstd, g, b));
}

template <typename TI>
__global__ void __launch_bounds__(NTHREADS)
    ln_q_kernel(const TI* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, const float* __restrict__ a_scale_p,
                const float* __restrict__ a_zero_p, int8_t* __restrict__ q, int R, int d,
                float eps, int qmin, int qmax) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const TI* xr = x + (int64_t)row * d;
  float mu, rstd;
  row_stats(xr, d, eps, lane, mu, rstd);
  const float sa = *a_scale_p;
  const float za = *a_zero_p;
  const float lo = (float)qmin, hi = (float)qmax;
  int8_t* qrow = q + (int64_t)row * d;
  for (int i = lane; i < d; i += 32) {
    const float y = ln_value(xr, i, mu, rstd, g, b);
    float v = rintf(__fsub_rn(__fdiv_rn(y, sa), za));
    v = fminf(fmaxf(v, lo), hi);
    if (qmin >= 0) v = __fsub_rn(v, 128.0f);
    qrow[i] = (int8_t)(int)v;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int qtt_layernorm(const void* x, const void* g, const void* b, void* out, int R,
                             int d, float eps, int in_dtype, int out_dtype, void* stream) {
  const dim3 grid((R + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
#define QTT_LN(TI, TO)                                                                    \
  ln_kernel<TI, TO><<<grid, NTHREADS, 0, s>>>((const TI*)x, (const float*)g, (const float*)b, \
                                              (TO*)out, R, d, eps)
  if (in_dtype == 0 && out_dtype == 0) QTT_LN(float, float);
  else if (in_dtype == 0 && out_dtype == 1) QTT_LN(float, __nv_bfloat16);
  else if (in_dtype == 1 && out_dtype == 0) QTT_LN(__nv_bfloat16, float);
  else if (in_dtype == 1 && out_dtype == 1) QTT_LN(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef QTT_LN
  return (int)cudaGetLastError();
}

extern "C" int qtt_layernorm_q(const void* x, const void* g, const void* b, const void* a_scale,
                               const void* a_zero, void* q, int R, int d, float eps, int qmin,
                               int qmax, int in_dtype, void* stream) {
  const dim3 grid((R + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
#define QTT_LNQ(TI)                                                                          \
  ln_q_kernel<TI><<<grid, NTHREADS, 0, s>>>((const TI*)x, (const float*)g, (const float*)b,  \
                                            (const float*)a_scale, (const float*)a_zero,     \
                                            (int8_t*)q, R, d, eps, qmin, qmax)
  if (in_dtype == 0) QTT_LNQ(float);
  else if (in_dtype == 1) QTT_LNQ(__nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef QTT_LNQ
  return (int)cudaGetLastError();
}
