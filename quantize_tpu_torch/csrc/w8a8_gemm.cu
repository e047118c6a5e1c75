// K1: fused W8A8 matmul, out(M, N) f32 =
//   s_a * s_w[n] * (A.W + z_a * colsum[n] + z_w[n] * rowsum(A)[m] + K * z_a * z_w[n]) + bias[n]
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/qmatmul.py:_w8a8_kernel
// (and its XLA twin quant_matmul_w8a8_xla, which computes the same math).
// The rowsum(A) terms are computed only when the weight zero points are not
// all zero (w_zero_is_zero false); symmetric signed weights drop them.
//
// On the H100 the main path's call (the ResNet fc: M = batch, K = 2048,
// N = 1000) is bound by bytes: 2 MB of weights and M x 4 KB of output
// against 2*M*N*K int8 operations. The design reads each weight tile once
// per 128-row block through 16-byte loads where N allows it; with M = 256
// only 2 x 16 blocks exist, so the card is far from full -- the call is
// small enough that launch overhead dominates, and a later split-K would be
// the fix.
#include "int8_mma.cuh"

using namespace qtt;

__global__ void __launch_bounds__(NTHREADS)
    w8a8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                     const int* __restrict__ col_sum, const float* __restrict__ w_scale,
                     const float* __restrict__ w_zero, const float* __restrict__ bias,
                     const float* __restrict__ a_scale_p, const float* __restrict__ z_eff_p,
                     float* __restrict__ out, int M, int N, int K, bool wz0, bool a_vec,
                     bool w_vec) {
  __shared__ Smem sm;
  __shared__ int rs[BM];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  GemmA la{a, M, K, m0, a_vec};
  int acc[4][4][4];
  int rowsum;
  mainloop(la, w, K, N, n0, w_vec, sm, acc, !wz0, rowsum);
  if (!wz0) {
    rs[threadIdx.x] = rowsum;
    __syncthreads();
  }
  w8a8_epilogue(acc, rs, m0, n0, M, N, K, col_sum, w_scale, w_zero, bias, *a_scale_p, *z_eff_p,
                wz0, out);
}

extern "C" int qtt_w8a8_gemm(const void* a, const void* w, const void* col_sum,
                             const void* w_scale, const void* w_zero, const void* bias,
                             const void* a_scale, const void* z_eff, void* out, int M, int N,
                             int K, int w_zero_is_zero, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const bool a_vec = (K % 16 == 0) && aligned16(a);
  const bool w_vec = (N % 16 == 0) && aligned16(w);
  w8a8_gemm_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, (const int*)col_sum, (const float*)w_scale,
      (const float*)w_zero, (const float*)bias, (const float*)a_scale, (const float*)z_eff,
      (float*)out, M, N, K, w_zero_is_zero != 0, a_vec, w_vec);
  return (int)cudaGetLastError();
}
