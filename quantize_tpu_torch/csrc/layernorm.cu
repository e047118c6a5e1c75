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
// device memory). One warp owns a row. K7 has two routes, chosen by the
// caller from the shape before launch (ops/layernorm.py: _ln_q_route):
//
// * vector (d a multiple of 128 up to 2,048; x 16-byte aligned in float32,
//   8-byte in bf16): the row lives in registers. Each lane issues all of
//   its d / 128 loads of four elements at once (float4, or four bf16 in 8
//   bytes), so the row is read from device memory once with every load in
//   flight together, and the two sums and the quantize run on registers.
//   g and b come in as float4 through the read-only path, and each lane
//   packs its four int8 results into one 32-bit store (a warp writes 128
//   contiguous bytes a store).
// * scalar (every other d, and K6 always): lanes read neighbouring
//   elements one at a time (coalesced); the second and third passes over
//   the row hit L1. Any d is taken.
//
// Both routes do the same float32 operations in the same order, so both
// are bit-equal to the plain version.
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

// The int8 grid index of y, as the plain activation quantize rounds it
__device__ __forceinline__ int quant8(float y, float sa, float za, float lo, float hi,
                                      bool unsigned_grid) {
  float v = rintf(__fsub_rn(__fdiv_rn(y, sa), za));
  v = fminf(fmaxf(v, lo), hi);
  if (unsigned_grid) v = __fsub_rn(v, 128.0f);
  return (int)v;
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
  for (int i = lane; i < d; i += 32)
    qrow[i] = (int8_t)quant8(ln_value(xr, i, mu, rstd, g, b), sa, za, lo, hi, qmin >= 0);
}

// K7's vector route: rows of D = 128 * NV elements, lane l holding elements
// 128 j + 4 l .. + 3 of its row for j < NV
constexpr int VEC_MAX_CHUNKS = 16;  // d up to 2,048

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float ln_y(float x, float mu, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), g), b);
}

template <typename TI, int NV>
__global__ void __launch_bounds__(NTHREADS)
    ln_q_vec_kernel(const TI* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ b, const float* __restrict__ a_scale_p,
                    const float* __restrict__ a_zero_p, int8_t* __restrict__ q, int R, float eps,
                    int qmin, int qmax) {
  constexpr int D = NV * 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const TI* xr = x + (int64_t)row * D + 4 * lane;
  float4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = load4(xr + 128 * j);
  // the two row sums in float64 (exact for float32 terms), as row_stats
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    s += ((double)v[j].x + (double)v[j].y) + ((double)v[j].z + (double)v[j].w);
  s = warp_sum(s);
  const float mu = __fdiv_rn((float)s, (float)D);
  double s2 = 0.0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float c0 = __fsub_rn(v[j].x, mu), c1 = __fsub_rn(v[j].y, mu);
    const float c2 = __fsub_rn(v[j].z, mu), c3 = __fsub_rn(v[j].w, mu);
    s2 += ((double)__fmul_rn(c0, c0) + (double)__fmul_rn(c1, c1)) +
          ((double)__fmul_rn(c2, c2) + (double)__fmul_rn(c3, c3));
  }
  s2 = warp_sum(s2);
  const float var = __fdiv_rn((float)s2, (float)D);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float sa = *a_scale_p, za = *a_zero_p;
  const float lo = (float)qmin, hi = (float)qmax;
  const bool ug = qmin >= 0;
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (int64_t)row * D + 4 * lane);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + 128 * j + 4 * lane));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + 128 * j + 4 * lane));
    const uint32_t q0 = (uint8_t)quant8(ln_y(v[j].x, mu, rstd, gg.x, bb.x), sa, za, lo, hi, ug);
    const uint32_t q1 = (uint8_t)quant8(ln_y(v[j].y, mu, rstd, gg.y, bb.y), sa, za, lo, hi, ug);
    const uint32_t q2 = (uint8_t)quant8(ln_y(v[j].z, mu, rstd, gg.z, bb.z), sa, za, lo, hi, ug);
    const uint32_t q3 = (uint8_t)quant8(ln_y(v[j].w, mu, rstd, gg.w, bb.w), sa, za, lo, hi, ug);
    qr[32 * j] = q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
  }
}

// ln_q_vec_kernel<TI, nv> for nv in NV .. VEC_MAX_CHUNKS
template <typename TI, int NV = 1>
void launch_vec(int nv, dim3 grid, cudaStream_t s, const TI* x, const float* g, const float* b,
                const float* a_scale, const float* a_zero, int8_t* q, int R, float eps, int qmin,
                int qmax) {
  if (nv == NV) {
    ln_q_vec_kernel<TI, NV><<<grid, NTHREADS, 0, s>>>(x, g, b, a_scale, a_zero, q, R, eps, qmin,
                                                      qmax);
    return;
  }
  if constexpr (NV < VEC_MAX_CHUNKS)
    launch_vec<TI, NV + 1>(nv, grid, s, x, g, b, a_scale, a_zero, q, R, eps, qmin, qmax);
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

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

// route 0: the scalar kernel (any d); route 1: the vector kernel (d a
// multiple of 128 up to 2,048, x aligned to its four-element loads, g, b
// and q to theirs). The caller picks the route from the shape.
extern "C" int qtt_layernorm_q(const void* x, const void* g, const void* b, const void* a_scale,
                               const void* a_zero, void* q, int R, int d, float eps, int qmin,
                               int qmax, int in_dtype, int route, void* stream) {
  const dim3 grid((R + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const int nv = d / 128;
    if (d % 128 != 0 || nv < 1 || nv > VEC_MAX_CHUNKS || in_dtype < 0 || in_dtype > 1 ||
        !aligned_to(x, in_dtype == 0 ? 16 : 8) || !aligned_to(g, 16) || !aligned_to(b, 16) ||
        !aligned_to(q, 4))
      return (int)cudaErrorInvalidValue;
#define QTT_LNQV(TI)                                                                       \
  launch_vec<TI>(nv, grid, s, (const TI*)x, (const float*)g, (const float*)b,              \
                 (const float*)a_scale, (const float*)a_zero, (int8_t*)q, R, eps, qmin, qmax)
    if (in_dtype == 0) QTT_LNQV(float);
    else QTT_LNQV(__nv_bfloat16);
#undef QTT_LNQV
    return (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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
