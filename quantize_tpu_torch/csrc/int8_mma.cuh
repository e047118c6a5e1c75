// Shared int8 tensor-core mainloop for the port's mma.sync int8 kernels
// (w8a8_gemm.cu, conv1x1_residual.cu, w4a8_gemm.cu).
//
// One block computes a BM x BN tile of C = A . W with int32 accumulation,
// A (M, K) int8 row-major (or gathered on the fly from an NHWC image by
// the implicit-GEMM loader) and W (K, N) int8 row-major (an HWIO kernel
// flattened to (kh*kw*Ci, Co) is exactly this). K is a loop inside the
// block: blocks run in parallel and in no order, so nothing carries across
// them the way the Pallas grid carried its accumulator across k steps.
//
// Four warps, 2 (M) x 2 (N), each own a 64 x 32 sub-tile held as 4 x 4
// fragments of mma.sync.m16n8k32 (s8 . s8 -> s32). Tiles are staged in
// shared memory, two buffers deep: while the warps multiply one buffer,
// every thread holds the next tile's global loads in registers and stores
// them to the other buffer afterwards (one __syncthreads per K step).
// Rows of the staged tiles are SK = BK + 16 bytes apart, which makes the
// 32-bit fragment reads free of bank conflicts. W is stored transposed in
// shared memory (n-major, k contiguous), the "col" layout mma wants for B.
//
// Edges are masked in the loaders (zero fill), so M, N and K need not be
// multiples of the tile. Loads are 16 bytes wide where the row length and
// the base pointer allow it, else byte by byte.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtt {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int SK = BK + 16;
constexpr int NTHREADS = 128;
constexpr int A_CHUNKS = BM * BK / 16 / NTHREADS;  // 16-byte chunks per thread
constexpr int B_CHUNKS = BK * BN / 16 / NTHREADS;
constexpr int MAX_GRID_Y = 65535;

struct __align__(16) Smem {
  int8_t a[2][BM * SK];
  int8_t b[2][BN * SK];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t byte_of(const int4& v, int j) {
  const int w = j < 8 ? (j < 4 ? v.x : v.y) : (j < 12 ? v.z : v.w);
  return (int8_t)((w >> (8 * (j & 3))) & 0xff);
}

__device__ __forceinline__ void set_byte(int4& v, int j, int8_t b) {
  const uint32_t sh = 8u * (j & 3);
  const uint32_t mask = ~(0xffu << sh);
  const uint32_t val = ((uint32_t)(uint8_t)b) << sh;
  if (j < 4) v.x = (int)(((uint32_t)v.x & mask) | val);
  else if (j < 8) v.y = (int)(((uint32_t)v.y & mask) | val);
  else if (j < 12) v.z = (int)(((uint32_t)v.z & mask) | val);
  else v.w = (int)(((uint32_t)v.w & mask) | val);
}

__device__ __forceinline__ void set_word(int4& v, int q, int w) {
  if (q == 0) v.x = w;
  else if (q == 1) v.y = w;
  else if (q == 2) v.z = w;
  else v.w = w;
}

// W (K, N) row-major -> shared b[n * SK + k].
struct BTile {
  const int8_t* w;
  int K, N, n0;
  bool vec;
  int4 r[B_CHUNKS];

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      const int k = k0 + (c >> 2);
      const int n = n0 + (c & 3) * 16;
      if (vec && k < K && n + 16 <= N) {
        r[i] = *reinterpret_cast<const int4*>(w + (int64_t)k * N + n);
      } else {
        r[i] = make_int4(0, 0, 0, 0);
        if (k < K) {
          for (int j = 0; j < 16; ++j)
            if (n + j < N) set_byte(r[i], j, w[(int64_t)k * N + n + j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(int8_t* bs) const {
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      const int kr = c >> 2;
      const int nc = (c & 3) * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) bs[(nc + j) * SK + kr] = byte_of(r[i], j);
    }
  }
};

// A (M, K) row-major -> shared a[m * SK + k].
struct GemmA {
  const int8_t* a;
  int M, K, m0;
  bool vec;
  int4 r[A_CHUNKS];

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = threadIdx.x + i * NTHREADS;
      const int m = m0 + (c >> 2);
      const int k = k0 + (c & 3) * 16;
      if (vec && m < M && k + 16 <= K) {
        r[i] = *reinterpret_cast<const int4*>(a + (int64_t)m * K + k);
      } else {
        r[i] = make_int4(0, 0, 0, 0);
        if (m < M) {
          for (int j = 0; j < 16; ++j)
            if (k + j < K) set_byte(r[i], j, a[(int64_t)m * K + k + j]);
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

// The accumulator tile of one thread: acc[i][j] is the m16n8 fragment at
// rows wm*64 + i*16 (+ g, + g + 8) and columns wn*32 + j*8 (+ 2t, + 2t + 1).
struct Frag {
  int wm, wn, g, t;
  __device__ __forceinline__ Frag() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wm = warp >> 1;
    wn = warp & 1;
    g = lane >> 2;
    t = lane & 3;
  }
  // local row / column of element r (0..3) of fragment (i, j)
  __device__ __forceinline__ int row(int i, int r) const { return wm * 64 + i * 16 + g + (r >= 2 ? 8 : 0); }
  __device__ __forceinline__ int col(int j, int r) const { return wn * 32 + j * 8 + t * 2 + (r & 1); }
};

// Runs the whole K loop: nk steps of BK columns. Each loader's load(k0)
// reads the registers for the step at column k0 = kt * BK and store()
// writes them to a shared buffer. When want_rowsum is set, thread tid also
// sums the int8 values of A-tile row tid (BM == NTHREADS) over all steps.
template <class ALoader, class BLoader>
__device__ __forceinline__ void mainloop(ALoader& la, BLoader& lb, int nk, Smem& sm,
                                         int (&acc)[4][4][4], bool want_rowsum, int& rowsum) {
  const Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  rowsum = 0;

  la.load(0);
  lb.load(0);
  la.store(sm.a[0]);
  lb.store(sm.b[0]);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      la.load((kt + 1) * BK);
      lb.load((kt + 1) * BK);
    }
    const int8_t* as = sm.a[cur];
    const int8_t* bs = sm.b[cur];
    if (want_rowsum) {
      const int* rowp = reinterpret_cast<const int*>(as + threadIdx.x * SK);
#pragma unroll
      for (int q = 0; q < BK / 4; ++q) rowsum = __dp4a(rowp[q], 0x01010101, rowsum);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (f.wm * 64 + i * 16 + f.g) * SK + kk + f.t * 4;
        af[i][0] = *reinterpret_cast<const int*>(p);
        af[i][1] = *reinterpret_cast<const int*>(p + 8 * SK);
        af[i][2] = *reinterpret_cast<const int*>(p + 16);
        af[i][3] = *reinterpret_cast<const int*>(p + 8 * SK + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (f.wn * 32 + j * 8 + f.g) * SK + kk + f.t * 4;
        bf[j][0] = *reinterpret_cast<const int*>(p);
        bf[j][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (more) {
      la.store(sm.a[cur ^ 1]);
      lb.store(sm.b[cur ^ 1]);
    }
    __syncthreads();
  }
}

// The K loop over a row-major int8 W (K, N).
template <class ALoader>
__device__ __forceinline__ void mainloop(ALoader& la, const int8_t* __restrict__ w, int K, int N,
                                         int n0, bool w_vec, Smem& sm, int (&acc)[4][4][4],
                                         bool want_rowsum, int& rowsum) {
  BTile lb{w, K, N, n0, w_vec};
  mainloop(la, lb, (K + BK - 1) / BK, sm, acc, want_rowsum, rowsum);
}

// The W8A8 epilogue of a BM x BN tile (K1 and K4), in the operand order of
// the JAX expression: out(M, N) f32 =
//   s_a * s_w[n] * (acc + z_a * colsum[n] [+ z_w[n] * rowsum[m] + (K * z_a) * z_w[n]]) + bias[n]
// rs holds the tile's row sums when wz0 is false.
__device__ __forceinline__ void w8a8_epilogue(const int (&acc)[4][4][4], const int* rs, int m0,
                                              int n0, int M, int N, int K,
                                              const int* __restrict__ col_sum,
                                              const float* __restrict__ w_scale,
                                              const float* __restrict__ w_zero,
                                              const float* __restrict__ bias, float a_scale,
                                              float z, bool wz0, float* __restrict__ out) {
  const Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lm = f.row(i, r);
        const int m = m0 + lm;
        const int n = n0 + f.col(j, r);
        if (m >= M || n >= N) continue;
        float corrected = __fadd_rn((float)acc[i][j][r], __fmul_rn(z, (float)col_sum[n]));
        if (!wz0) {
          const float wz = w_zero[n];
          corrected = __fadd_rn(__fadd_rn(corrected, __fmul_rn(wz, (float)rs[lm])),
                                __fmul_rn(__fmul_rn((float)K, z), wz));
        }
        float v = __fmul_rn(__fmul_rn(a_scale, w_scale[n]), corrected);
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        out[(int64_t)m * N + n] = v;
      }
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p, int64_t i);
template <>
__device__ __forceinline__ float load_f<float>(const float* p, int64_t i) { return p[i]; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, int64_t i, float v);
template <>
__device__ __forceinline__ void store_f<float>(float* p, int64_t i, float v) { p[i] = v; }
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace qtt
