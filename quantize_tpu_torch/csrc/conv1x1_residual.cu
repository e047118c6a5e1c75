// K2: fused 1x1 conv + residual add + ReLU, as a GEMM over M = N*H*W rows:
//   out = relu(s_a * s_w[c] * (A.W + z_a * colsum[c]) + bias[c] + residual)
// in the carry dtype (f32 or bf16), with the residual read in its own dtype
// and added in f32 before the one rounding to the output dtype. Weight zero
// points must be exactly zero (the caller checks).
//
// Replaces the Pallas kernel
// quantize_tpu/ops/pallas/qconv1x1.py:_conv1x1_res_kernel. The Pallas
// version keeps K whole per tile; here K (64..512 on ResNet-50) is a loop of
// 64-deep steps inside the block, which needs no carry across blocks.
//
// On the H100 the bottleneck tails are bound by bytes: for K = 64..512 and
// N = 4K the int8 operations per byte moved (A once, the residual once, the
// output once) sit far below the card's ~590 int8 ops/byte balance point.
// The design therefore touches the fat (M, N) residual and output exactly
// once each, in the epilogue, and never writes the int32 accumulator out.
#include "int8_mma.cuh"

using namespace qtt;

template <typename TRes, typename TOut>
__global__ void __launch_bounds__(NTHREADS)
    conv1x1_res_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                       const int* __restrict__ col_sum, const float* __restrict__ w_scale,
                       const float* __restrict__ bias, const float* __restrict__ a_scale_p,
                       const float* __restrict__ z_eff_p, const TRes* __restrict__ res,
                       TOut* __restrict__ out, int M, int N, int K, bool relu, bool a_vec,
                       bool w_vec) {
  __shared__ Smem sm;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  GemmA la{a, M, K, m0, a_vec};
  int acc[4][4][4];
  int rowsum;
  mainloop(la, w, K, N, n0, w_vec, sm, acc, false, rowsum);
  const float a_scale = *a_scale_p;
  const float z = *z_eff_p;
  const Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + f.row(i, r);
        const int n = n0 + f.col(j, r);
        if (m >= M || n >= N) continue;
        const int64_t idx = (int64_t)m * N + n;
        const float corrected = __fadd_rn((float)acc[i][j][r], __fmul_rn(z, (float)col_sum[n]));
        float v = __fmul_rn(__fmul_rn(a_scale, w_scale[n]), corrected);
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        v = __fadd_rn(v, load_f(res, idx));
        if (relu) v = fmaxf(v, 0.0f);
        store_f(out, idx, v);
      }
}

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int qtt_conv1x1_residual(const void* a, const void* w, const void* col_sum,
                                    const void* w_scale, const void* bias, const void* a_scale,
                                    const void* z_eff, const void* res, void* out, int M, int N,
                                    int K, int relu, int res_dtype, int out_dtype,
                                    void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const bool a_vec = (K % 16 == 0) && aligned16(a);
  const bool w_vec = (N % 16 == 0) && aligned16(w);
  cudaStream_t s = (cudaStream_t)stream;
#define QTT_LAUNCH(TR, TO)                                                                  \
  conv1x1_res_kernel<TR, TO><<<grid, NTHREADS, 0, s>>>(                                     \
      (const int8_t*)a, (const int8_t*)w, (const int*)col_sum, (const float*)w_scale,       \
      (const float*)bias, (const float*)a_scale, (const float*)z_eff, (const TR*)res,       \
      (TO*)out, M, N, K, relu != 0, a_vec, w_vec)
  if (res_dtype == 0 && out_dtype == 0) QTT_LAUNCH(float, float);
  else if (res_dtype == 0 && out_dtype == 1) QTT_LAUNCH(float, __nv_bfloat16);
  else if (res_dtype == 1 && out_dtype == 0) QTT_LAUNCH(__nv_bfloat16, float);
  else if (res_dtype == 1 && out_dtype == 1) QTT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef QTT_LAUNCH
  return (int)cudaGetLastError();
}
