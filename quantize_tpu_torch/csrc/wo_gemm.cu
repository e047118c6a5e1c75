// K5: the weight-only product, out(M, N) f32 =
//   bf16(A) . bf16((W + z[n]) * s[n]) + bias[n]
// with A (M, K) float32 or bf16 activations and W (K, N) int8 weights with
// per-out-channel scale s and zero z. The weight is dequantized in float32
// ((w + z) * s, __fadd_rn / __fmul_rn) and rounded to bf16 in the loader,
// so the float weight never reaches device memory; A is rounded to bf16
// (__float2bfloat16_rn) in its loader. The bf16 products are exact in
// float32 and summed in float32 on the tensor cores (mma.sync.m16n8k16,
// f32 accumulation); the epilogue adds the bias in float32.
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/qmatmul.py:_wo_kernel
// for a bf16 operand (its body dequantizes the int8 tile in f32, casts it to
// the activation dtype and runs one f32-accumulated dot per K block). The
// Pallas grid carried the accumulator across K blocks in VMEM scratch; here
// K is a loop inside the block, as in the int8 kernels.
//
// Tiling is that of int8_mma.cuh: a 128 x 64 output tile per block of four
// warps (2 x 2, 64 x 32 each, as 4 x 4 m16n8 fragments), the K loop in steps
// of 32 bf16 (64 bytes, the int8 mainloop's row length), staged in shared
// memory two buffers deep through registers. Rows of the staged tiles are
// 40 bf16 (80 bytes) apart, which keeps the 32-bit fragment reads free of
// bank conflicts; W is stored transposed (n-major, k contiguous), the "col"
// layout mma wants for B. Ragged M, N and K edges are masked in the
// loaders (zeros).
//
// On the H100 the ViT-B/32 projections at batch 256 (M = 14,336; K x N =
// 768 x 768, 768 x 3072, 3072 x 768) are bound by operations: 2*M*N*K bf16
// flops (~2.4 TFLOP per forward over 73 launches, ~2.5 ms at 989 TFLOP/s)
// against a few tens of MB moved. This first kernel uses mma.sync, not
// wgmma/TMA, and stays well below that bound.
#include "int8_mma.cuh"

using namespace qtt;

namespace {

constexpr int WK = 32;                              // bf16 K per step
constexpr int LDS = WK + 8;                         // staged row stride, in bf16
constexpr int A_UNITS = BM * WK / 8 / NTHREADS;     // 8-element A units per thread
static_assert(WK * BN / 16 == NTHREADS, "one 16-byte W chunk per thread and step");

struct __align__(16) WoSmem {
  __nv_bfloat16 a[2][BM * LDS];
  __nv_bfloat16 b[2][BN * LDS];
  float z[BN];
  float s[BN];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16, the first in the low half (the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Eight consecutive A values of one row, as loaded (the global loads of the
// next K step stay in flight while the warps multiply the current one) and
// as bf16 for the shared tile (rounded there, in store()).
template <typename T>
struct AUnit;

template <>
struct AUnit<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = *reinterpret_cast<const float4*>(p);
    hi = *reinterpret_cast<const float4*>(p + 4);
  }
  // the first n (<= 8) values from p, zeros after them
  __device__ __forceinline__ void load_masked(const float* p, int n) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? p[j] : 0.0f;
    lo = make_float4(v[0], v[1], v[2], v[3]);
    hi = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ uint4 bf16() const {
    return make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                      pack_bf16(hi.z, hi.w));
  }
};

template <>
struct AUnit<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void load_masked(const __nv_bfloat16* p, int n) {
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = j < n ? (uint32_t)__bfloat16_as_ushort(p[j]) : 0u;
    raw = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                     h[6] | (h[7] << 16));
  }
  __device__ __forceinline__ uint4 bf16() const { return raw; }
};

// A (M, K) row-major -> shared a[m * LDS + k] in bf16. Unit c of a step is
// row c / 4, columns (c % 4) * 8 .. + 8.
template <typename T>
struct ALoader {
  const T* a;
  int M, K, m0;
  bool vec;
  AUnit<T> u[A_UNITS];

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int i = 0; i < A_UNITS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      const int m = m0 + (c >> 2);
      const int k = k0 + (c & 3) * 8;
      const T* p = a + (int64_t)m * K + k;
      if (vec && m < M && k + 8 <= K) {
        u[i].load(p);
      } else {
        u[i].load_masked(p, m < M ? max(0, min(8, K - k)) : 0);
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* as) const {
#pragma unroll
    for (int i = 0; i < A_UNITS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      *reinterpret_cast<uint4*>(as + (c >> 2) * LDS + (c & 3) * 8) = u[i].bf16();
    }
  }
};

// W (K, N) int8 row-major -> shared b[n * LDS + k] = bf16((w + z[n]) * s[n]):
// thread c holds row k0 + c / 4, columns (c % 4) * 16 .. + 16.
struct WLoader {
  const int8_t* w;
  int K, N, n0;
  bool vec;
  int4 r;
  bool row_ok;

  __device__ __forceinline__ void load(int k0) {
    const int c = threadIdx.x;
    const int k = k0 + (c >> 2);
    const int n = n0 + (c & 3) * 16;
    row_ok = k < K;
    if (vec && row_ok && n + 16 <= N) {
      r = *reinterpret_cast<const int4*>(w + (int64_t)k * N + n);
    } else {
      r = make_int4(0, 0, 0, 0);
      if (row_ok) {
        for (int j = 0; j < 16; ++j)
          if (n + j < N) set_byte(r, j, w[(int64_t)k * N + n + j]);
      }
    }
  }

  // zs / ss: the block's 64 zeros and scales (0 past N)
  __device__ __forceinline__ void store(__nv_bfloat16* bs, const float* zs, const float* ss) const {
    const int c = threadIdx.x;
    const int kr = c >> 2;
    const int nc = (c & 3) * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v = row_ok ? __fmul_rn(__fadd_rn((float)byte_of(r, j), zs[nc + j]), ss[nc + j])
                             : 0.0f;
      bs[(nc + j) * LDS + kr] = __float2bfloat16_rn(v);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    wo_gemm_kernel(const T* __restrict__ a, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ w_zero,
                   const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
                   bool a_vec, bool w_vec) {
  __shared__ WoSmem sm;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (threadIdx.x < BN) {
    const int n = n0 + threadIdx.x;
    sm.z[threadIdx.x] = n < N ? w_zero[n] : 0.0f;
    sm.s[threadIdx.x] = n < N ? w_scale[n] : 0.0f;
  }
  __syncthreads();

  ALoader<T> la{a, M, K, m0, a_vec};
  WLoader lb{w, K, N, n0, w_vec};
  const Frag f;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int nk = (K + WK - 1) / WK;
  la.load(0);
  lb.load(0);
  la.store(sm.a[0]);
  lb.store(sm.b[0], sm.z, sm.s);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      la.load((kt + 1) * WK);
      lb.load((kt + 1) * WK);
    }
    const __nv_bfloat16* as = sm.a[cur];
    const __nv_bfloat16* bs = sm.b[cur];
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = as + (f.wm * 64 + i * 16 + f.g) * LDS + kk + f.t * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = bs + (f.wn * 32 + j * 8 + f.g) * LDS + kk + f.t * 2;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (more) {
      la.store(sm.a[cur ^ 1]);
      lb.store(sm.b[cur ^ 1], sm.z, sm.s);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + f.row(i, r);
        const int n = n0 + f.col(j, r);
        if (m >= M || n >= N) continue;
        float v = acc[i][j][r];
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        out[(int64_t)m * N + n] = v;
      }
}

template <typename T>
int launch(const void* a, const void* w, const void* w_scale, const void* w_zero,
           const void* bias, void* out, int M, int N, int K, bool a_vec, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const bool w_vec = (N % 16 == 0) && aligned16(w);
  wo_gemm_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      (const T*)a, (const int8_t*)w, (const float*)w_scale, (const float*)w_zero,
      (const float*)bias, (float*)out, M, N, K, a_vec, w_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 activations. bias may be NULL.
extern "C" int qtt_wo_gemm(const void* a, const void* w, const void* w_scale, const void* w_zero,
                           const void* bias, void* out, int M, int N, int K, int in_dtype,
                           void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte A loads of 8 elements need every row start aligned
  if (in_dtype == 0)
    return launch<float>(a, w, w_scale, w_zero, bias, out, M, N, K,
                         (K % 4 == 0) && aligned16(a), s);
  if (in_dtype == 1)
    return launch<__nv_bfloat16>(a, w, w_scale, w_zero, bias, out, M, N, K,
                                 (K % 8 == 0) && aligned16(a), s);
  return (int)cudaErrorInvalidValue;
}
