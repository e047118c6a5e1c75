// K3: W8A8 convolution over NHWC int8 activations and an HWIO int8 kernel,
// as an implicit GEMM: row m = (image, oh, ow), column = output channel,
// K = kh*kw*Ci in (kh, kw, ci) order. The loader gathers each patch from
// the image and writes int8 zero at padding, as the XLA conv pads. Epilogue:
//   acc + z_a * corr_a[oh, ow, co]                 (border-exact z_a term)
//       + z_w[co] * rowsum + z_a * z_w[co] * count  (only when z_w != 0)
//   out = s_a * s_w[co] * that + bias[co], cast to the carry dtype,
// where rowsum sums the patch's int8 values and count is the number of
// valid taps times Ci.
//
// Replaces the XLA op behind quantize_tpu/ops/qconv.py:quant_conv2d
// (conv_general_dilated(int8, int8) -> int32 plus its fused epilogue); stock
// PyTorch has no CUDA int8 convolution. Grouped convs are not handled (the
// wrapper raises).
//
// On the H100 the 3x3 convs of ResNet-50 at batch >= 32 are bound by
// operations (2*M*Co*K int8 ops against the image read once), the 1x1
// downsample and early-stage convs by bytes. The design keeps the patch
// matrix out of device memory entirely (it exists only tile by tile in
// shared memory) and reads 16 bytes at a time when Ci is a multiple of 16
// (every ResNet conv but the stem), 4 bytes when Ci is a multiple of 4 (the
// space-to-depth stem, Ci = 12), else single bytes.
#include "int8_mma.cuh"

using namespace qtt;

namespace {

constexpr int kInvalidRow = -(1 << 30);

struct ConvA {
  const int8_t* x;
  int M, K, m0;
  int H, W, C, KW;
  int mode;  // 2: 16-byte chunks (C % 16 == 0), 1: 4-byte words (C % 4 == 0), 0: bytes
  const int64_t* rbase;
  const int* rih;
  const int* riw;
  int4 r[A_CHUNKS];

  // address of element k of tile row `row`, or nullptr at padding / past the edge
  __device__ __forceinline__ const int8_t* addr(int row, int k) const {
    const int ih0 = rih[row];
    if (k >= K || ih0 == kInvalidRow) return nullptr;
    const int tap = k / C;
    const int ci = k - tap * C;
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
    const int ih = ih0 + kh;
    const int iw = riw[row] + kw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return x + rbase[row] + ((int64_t)ih * W + iw) * C + ci;
  }

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      const int row = c >> 2;
      const int k = k0 + (c & 3) * 16;
      r[i] = make_int4(0, 0, 0, 0);
      if (mode == 2) {
        const int8_t* p = addr(row, k);
        if (p != nullptr) r[i] = *reinterpret_cast<const int4*>(p);
      } else if (mode == 1) {
        for (int q = 0; q < 4; ++q) {
          const int8_t* p = addr(row, k + 4 * q);
          if (p != nullptr) set_word(r[i], q, *reinterpret_cast<const int*>(p));
        }
      } else {
        for (int j = 0; j < 16; ++j) {
          const int8_t* p = addr(row, k + j);
          if (p != nullptr) set_byte(r[i], j, *p);
        }
      }
    }
  }

  __device__ __forceinline__ void store(int8_t* as) const {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      *reinterpret_cast<int4*>(as + (c >> 2) * SK + (c & 3) * 16) = r[i];
    }
  }
};

__device__ __forceinline__ int valid_taps(int i0, int k, int size) {
  // number of kk in [0, k) with 0 <= i0 + kk < size
  const int lo = i0 < 0 ? -i0 : 0;
  const int hi = size - i0 < k ? size - i0 : k;
  return hi > lo ? hi - lo : 0;
}

}  // namespace

template <typename TOut>
__global__ void __launch_bounds__(NTHREADS)
    qconv2d_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ corr_a, const float* __restrict__ w_scale,
                   const float* __restrict__ w_zero, const float* __restrict__ bias,
                   const float* __restrict__ a_scale_p, const float* __restrict__ z_eff_p,
                   TOut* __restrict__ out, int H, int W, int C, int OH, int OW, int Co, int KH,
                   int KW, int sh, int sw, int pt, int pl, int M, bool wz0, int mode,
                   bool w_vec) {
  __shared__ Smem sm;
  __shared__ int64_t rbase[BM];
  __shared__ int rih[BM];
  __shared__ int riw[BM];
  __shared__ int rs[BM];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int K = KH * KW * C;
  {
    const int m = m0 + threadIdx.x;
    if (m < M) {
      const int img = m / (OH * OW);
      const int rem = m - img * (OH * OW);
      const int oh = rem / OW;
      const int ow = rem - oh * OW;
      rbase[threadIdx.x] = (int64_t)img * H * W * C;
      rih[threadIdx.x] = oh * sh - pt;
      riw[threadIdx.x] = ow * sw - pl;
    } else {
      rbase[threadIdx.x] = 0;
      rih[threadIdx.x] = kInvalidRow;
      riw[threadIdx.x] = 0;
    }
  }
  __syncthreads();

  ConvA la{x, M, K, m0, H, W, C, KW, mode, rbase, rih, riw};
  int acc[4][4][4];
  int rowsum;
  mainloop(la, w, K, Co, n0, w_vec, sm, acc, !wz0, rowsum);
  if (!wz0) {
    rs[threadIdx.x] = rowsum;
    __syncthreads();
  }
  const float a_scale = *a_scale_p;
  const float z = *z_eff_p;
  const Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lm = f.row(i, r);
        const int m = m0 + lm;
        const int co = n0 + f.col(j, r);
        if (m >= M || co >= Co) continue;
        const int pix = m % (OH * OW);  // oh * OW + ow
        float corrected =
            __fadd_rn((float)acc[i][j][r], __fmul_rn(z, corr_a[(int64_t)pix * Co + co]));
        if (!wz0) {
          const int oh = pix / OW;
          const int ow = pix - oh * OW;
          const float count =
              (float)(valid_taps(oh * sh - pt, KH, H) * valid_taps(ow * sw - pl, KW, W) * C);
          const float wz = w_zero[co];
          corrected = __fadd_rn(__fadd_rn(corrected, __fmul_rn(wz, (float)rs[lm])),
                                __fmul_rn(__fmul_rn(z, wz), count));
        }
        float v = __fmul_rn(__fmul_rn(a_scale, w_scale[co]), corrected);
        if (bias != nullptr) v = __fadd_rn(v, bias[co]);
        store_f(out, (int64_t)m * Co + co, v);
      }
}

// out_dtype: 0 = float32, 1 = bfloat16
extern "C" int qtt_qconv2d(const void* x, const void* w, const void* corr_a, const void* w_scale,
                           const void* w_zero, const void* bias, const void* a_scale,
                           const void* z_eff, void* out, int N, int H, int W, int C, int OH,
                           int OW, int Co, int KH, int KW, int sh, int sw, int pt, int pl,
                           int w_zero_is_zero, int out_dtype, void* stream) {
  const long long M = (long long)N * OH * OW;
  const dim3 grid((Co + BN - 1) / BN, (unsigned)((M + BM - 1) / BM));
  if ((M + BM - 1) / BM > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  int mode = 0;
  if (C % 16 == 0 && aligned16(x)) mode = 2;
  else if (C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 3u) == 0) mode = 1;
  const bool w_vec = (Co % 16 == 0) && aligned16(w);
  cudaStream_t s = (cudaStream_t)stream;
#define QTT_LAUNCH(TO)                                                                       \
  qconv2d_kernel<TO><<<grid, NTHREADS, 0, s>>>(                                              \
      (const int8_t*)x, (const int8_t*)w, (const float*)corr_a, (const float*)w_scale,       \
      (const float*)w_zero, (const float*)bias, (const float*)a_scale, (const float*)z_eff,  \
      (TO*)out, H, W, C, OH, OW, Co, KH, KW, sh, sw, pt, pl, (int)M, w_zero_is_zero != 0,    \
      mode, w_vec)
  if (out_dtype == 0) QTT_LAUNCH(float);
  else if (out_dtype == 1) QTT_LAUNCH(__nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef QTT_LAUNCH
  return (int)cudaGetLastError();
}
