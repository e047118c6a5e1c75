// K4: fused W4A8 matmul over split-half int4 weights, out(M, N) f32 =
//   s_a * s_w[n] * (A.W + z_a * colsum[n] + z_w[n] * rowsum(A)[m] + K * z_a * z_w[n]) + bias[n]
// with W (K, N) stored packed as Wp (K/2, N) int8: the low nibble of Wp[r, n]
// is W[r, n] and the high nibble is W[r + K/2, n] (signed int4 each).
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/qmatmul.py:_w4a8_kernel
// (and its XLA twin, which unpacks and runs the W8A8 product). colsum is the
// pack-time column sum of the unpacked weight, an integer vector, so it is
// the same number the Pallas kernel sums in-kernel.
//
// Each K step of the shared int8 mainloop (int8_mma.cuh) covers BK = 64
// logical columns as two halves that share one packed tile: 32 packed rows
// [p0, p0 + 32) are read once (16 bytes a thread), and the loader
// sign-extends each byte into two int8 shared tiles, lo = (v << 4) >> 4 at
// tile columns [0, 32) and hi = v >> 4 at [32, 64). The A loader pairs them
// with A columns [p0, p0 + 32) and [K/2 + p0, K/2 + p0 + 32). A K/2 that is
// not a multiple of 32 leaves a tail that both loaders zero-fill.
//
// On the H100 the ViT-B/16 projections at batch 128 (M = 25,600, K x N =
// 768 x 2304, 768 x 3072, 3072 x 768) are bound by operations: 2*M*N*K int8
// ops against a few tens of MB moved. The packed weight halves the weight
// bytes against int8; the tensor-core product is the same mma.sync
// m16n8k32 mainloop as K1's.
#include "int8_mma.cuh"

using namespace qtt;

namespace {

constexpr int HK = BK / 2;  // packed rows per K step

// A (M, K) row-major: tile columns [0, HK) from A[:, p0 + c], [HK, BK) from
// A[:, K/2 + p0 + c - HK], where p0 = k0 / 2.
struct SplitA {
  const int8_t* a;
  int M, K, Kh, m0;
  bool vec;
  int4 r[A_CHUNKS];

  __device__ __forceinline__ void load(int k0) {
    const int p0 = k0 / 2;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      const int m = m0 + (c >> 2);
      const int tc = (c & 3) * 16;
      const int p = p0 + (tc & (HK - 1));               // packed row of the chunk's first column
      const int col = p + (tc >= HK ? Kh : 0);          // its column of A
      if (vec && m < M && p + 16 <= Kh) {
        r[i] = *reinterpret_cast<const int4*>(a + (int64_t)m * K + col);
      } else {
        r[i] = make_int4(0, 0, 0, 0);
        if (m < M) {
          for (int j = 0; j < 16; ++j)
            if (p + j < Kh) set_byte(r[i], j, a[(int64_t)m * K + col + j]);
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

// Wp (K/2, N) row-major -> shared b[n * SK + k]: packed row p0 + pr gives
// b[n * SK + pr] (low nibble) and b[n * SK + HK + pr] (high nibble).
constexpr int P_CHUNKS = HK * BN / 16 / NTHREADS;
static_assert(P_CHUNKS == 1, "one 16-byte packed chunk per thread and step");

struct SplitB {
  const int8_t* wp;
  int Kh, N, n0;
  bool vec;
  int4 r;

  __device__ __forceinline__ void load(int k0) {
    const int c = threadIdx.x;
    const int p = k0 / 2 + (c >> 2);
    const int n = n0 + (c & 3) * 16;
    if (vec && p < Kh && n + 16 <= N) {
      r = *reinterpret_cast<const int4*>(wp + (int64_t)p * N + n);
    } else {
      r = make_int4(0, 0, 0, 0);
      if (p < Kh) {
        for (int j = 0; j < 16; ++j)
          if (n + j < N) set_byte(r, j, wp[(int64_t)p * N + n + j]);
      }
    }
  }

  __device__ __forceinline__ void store(int8_t* bs) const {
    const int c = threadIdx.x;
    const int pr = c >> 2;
    const int nc = (c & 3) * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint8_t v = (uint8_t)byte_of(r, j);
      bs[(nc + j) * SK + pr] = (int8_t)((int8_t)(uint8_t)(v << 4) >> 4);
      bs[(nc + j) * SK + HK + pr] = (int8_t)((int8_t)v >> 4);
    }
  }
};

}  // namespace

__global__ void __launch_bounds__(NTHREADS)
    w4a8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wp,
                     const int* __restrict__ col_sum, const float* __restrict__ w_scale,
                     const float* __restrict__ w_zero, const float* __restrict__ bias,
                     const float* __restrict__ a_scale_p, const float* __restrict__ z_eff_p,
                     float* __restrict__ out, int M, int N, int K, bool wz0, bool a_vec,
                     bool w_vec) {
  __shared__ Smem sm;
  __shared__ int rs[BM];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int Kh = K / 2;
  SplitA la{a, M, K, Kh, m0, a_vec};
  SplitB lb{wp, Kh, N, n0, w_vec};
  int acc[4][4][4];
  int rowsum;
  mainloop(la, lb, (Kh + HK - 1) / HK, sm, acc, !wz0, rowsum);
  if (!wz0) {
    rs[threadIdx.x] = rowsum;
    __syncthreads();
  }
  w8a8_epilogue(acc, rs, m0, n0, M, N, K, col_sum, w_scale, w_zero, bias, *a_scale_p, *z_eff_p,
                wz0, out);
}

extern "C" int qtt_w4a8_gemm(const void* a, const void* wp, const void* col_sum,
                             const void* w_scale, const void* w_zero, const void* bias,
                             const void* a_scale, const void* z_eff, void* out, int M, int N,
                             int K, int w_zero_is_zero, void* stream) {
  if (K % 2 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  // 16-byte A loads need both halves' starts aligned: K/2 a multiple of 16
  const bool a_vec = ((K / 2) % 16 == 0) && aligned16(a);
  const bool w_vec = (N % 16 == 0) && aligned16(wp);
  w4a8_gemm_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)wp, (const int*)col_sum, (const float*)w_scale,
      (const float*)w_zero, (const float*)bias, (const float*)a_scale, (const float*)z_eff,
      (float*)out, M, N, K, w_zero_is_zero != 0, a_vec, w_vec);
  return (int)cudaGetLastError();
}
