// K4: fused W4A8 matmul over split-half int4 weights, out(M, N) f32 =
//   s_a * s_w[n] * (A.W + z_a * colsum[n] + z_w[n] * rowsum(A)[m] + K * z_a * z_w[n]) + bias[n]
// with W (K, N) stored packed as Wp (K/2, N) int8: the low nibble of Wp[r, n]
// is W[r, n] and the high nibble is W[r + K/2, n] (signed int4 each).
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/qmatmul.py:_w4a8_kernel
// (and its XLA twin, which unpacks and runs the W8A8 product). colsum is the
// pack-time column sum of the unpacked weight, an integer vector, so it is
// the same number the Pallas kernel sums in-kernel. The integer sums are
// exact and the epilogue rounds in the plain version's order, so both
// routes are bit-equal to it.
//
// On the H100 the ViT-B/16 projections at batch 128 (M = 25,600, K x N =
// 768 x 2304, 768 x 3072, 3072 x 768) are bound by bytes on the first two
// (the f32 output: 236-315 MB) and by operations on fc2 (2*M*N*K int8 ops).
// Two routes, chosen by the caller from the shape before launch
// (ops/qmatmul.py: _w4a8_route):
//
// * wgmma (K a multiple of 32 below 2^17; A and the K-major copy 16-byte
//   aligned), a
//   warp-specialized kernel on K3's stage format (qconv2d.cu). A block
//   computes a 128 x BN tile (BN = 256, 128 or 64 by N) with 384 threads.
//   A stage covers 64 packed rows p0 .. p0 + 63, i.e. 128 logical K columns,
//   as two K-major halves of 64-byte rows in the 64-byte swizzle: A
//   [:, p0:p0+64] with the low nibbles of the packed rows, and A [:, K/2+p0:
//   K/2+p0+64] with the high nibbles. A arrives by TMA, two boxes of a 3-D
//   view (M, 2, K/2) with strides (K, K/2, 1), so each half is zero-filled
//   past K/2 on its own (the z_w != 0 row sums need it; a 2-D view would
//   read the high half's first columns into the low half's tail). The
//   64-byte swizzle keeps each box's inner size equal to the swizzle span.
//   A producer warpgroup, which issues no wgmma, reads the K-major packed
//   copy Wk (N, K/2) (made once at pack time) with 16-byte loads straight
//   from L2, one stage ahead, and moves every nibble to the top of its
//   byte (low: (v << 4) & 0xF0F0F0F0, high: v & 0xF0F0F0F0; three integer
//   ops a word, where the Pallas kernel's sign extension ((v & 15) ^ 8) - 8
//   needs a per-byte subtraction, which the card emulates with several ops
//   a word): each int8 is 16 times the signed nibble, so the int32 sums are 16 A.W exactly (below 2^31 for K below
//   2^17) and the epilogue divides them by 16 with a shift. It writes both
//   halves with 16-byte swizzled stores, then fence.proxy.async
//   and an mbarrier arrival; its thread 0 issues A's TMA. A 4-stage ring
//   feeds two consumer warpgroups of 64 rows, which issue
//   wgmma.mma_async.m64nBNk32.s32.s8.s8 four times a stage (and, when
//   z_w != 0, sum their A rows by __dp4a). Every thread keeps the 168
//   registers of one 384-thread block an SM: the consumers need them for
//   BN / 2 accumulators and the producer for two stages of packed words,
//   so no setmaxnreg. The epilogue stages the int32 tile in shared memory
//   (over the ring) and writes each output row in 16-byte stores, with
//   colsum, s_w, z_w and the bias read once per tile column.
// * mma.sync (every other even K): the shared int8 mainloop of
//   int8_mma.cuh, 128 x 64 tiles. Each K step covers BK = 64 logical
//   columns as two halves that share one packed tile: 32 packed rows
//   [p0, p0 + 32) are read once (16 bytes a thread), and the loader
//   sign-extends each byte into two int8 shared tiles, lo = (v << 4) >> 4
//   at tile columns [0, 32) and hi = v >> 4 at [32, 64). The A loader pairs
//   them with A columns [p0, p0 + 32) and [K/2 + p0, K/2 + p0 + 32). A K/2
//   that is not a multiple of 32 leaves a tail that both loaders zero-fill.
#include "int8_mma.cuh"
#include "sm90.cuh"

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


namespace wg4 {

constexpr int BM = 128;           // rows per block (two consumer warpgroups)
constexpr int HALF = 64;          // packed rows per stage: 64 bytes of each half
constexpr int STAGES = 4;         // ring depth
constexpr int CONSUMERS = 256;    // warpgroups 0 and 1
constexpr int PRODUCERS = 128;    // warpgroup 2: the unpack and A's TMA
constexpr int NTHREADS = CONSUMERS + PRODUCERS;
constexpr int A_HALF = BM * HALF;  // one half of a stage's A, 8 KB
constexpr int A_BYTES = 2 * A_HALF;
constexpr int MAX_GRID_Y = 65535;

template <int BN>
struct Tile {
  static constexpr int W_HALF = BN * HALF;            // one half of a stage's W
  static constexpr int STAGE = A_BYTES + 2 * W_HALF;  // a multiple of 1,024
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LDO = BN * 4 + 16;  // row stride of the staged int32 tile
  static constexpr int STAGED = BM * LDO;
  static constexpr int BODY = RING > STAGED ? RING : STAGED;
  static constexpr int CHUNKS = BN * (HALF / 16) / PRODUCERS;  // packed 16 B a thread a stage
  // the ring (then the staged tile), full and empty barriers, colsum / s_w /
  // z_w / bias of the tile's columns, the row sums, alignment slack
  static constexpr size_t SMEM = BODY + 2 * STAGES * 8 + 4 * BN * 4 + BM * 4 + 1024;
};

// the 4 low (high) nibbles of a word as 4 int8, each 16 times its signed
// value: a nibble moved to the top of its byte keeps its sign
__device__ __forceinline__ uint32_t lo16(uint32_t w) { return (w << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

// One output in the plain version's order (int8_mma.cuh: w8a8_epilogue),
// kz = K * z_a rounded as there.
__device__ __forceinline__ float out_value(int acc, float cs, float z, float a_scale, float ws,
                                           bool wz0, float wz, float rs, float kz,
                                           bool has_bias, float b) {
  float corrected = __fadd_rn((float)acc, __fmul_rn(z, cs));
  if (!wz0) corrected = __fadd_rn(__fadd_rn(corrected, __fmul_rn(wz, rs)), __fmul_rn(kz, wz));
  const float v = __fmul_rn(__fmul_rn(a_scale, ws), corrected);
  return has_bias ? __fadd_rn(v, b) : v;
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    w4a8_wgmma_kernel(const int8_t* __restrict__ w_km, const int* __restrict__ col_sum,
                      const float* __restrict__ w_scale, const float* __restrict__ w_zero,
                      const float* __restrict__ bias, const float* __restrict__ a_scale_p,
                      const float* __restrict__ z_eff_p, float* __restrict__ out, int M, int N,
                      int K, bool wz0, bool vec_out, const __grid_constant__ CUtensorMap a_map) {
  using TT = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the ring first, on a 1,024-byte boundary
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TT::BODY);  // a stage's A and W are in
  uint64_t* empty = full + STAGES;                              // its wgmmas are retired
  float* col_c = reinterpret_cast<float*>(empty + STAGES);
  float* col_s = col_c + BN;
  float* col_z = col_s + BN;
  float* col_b = col_z + BN;
  int* rs = reinterpret_cast<int*>(col_b + BN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Kh = K / 2;
  const int nk = (Kh + HALF - 1) / HALF;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);    // the producers' stores and A's TMA
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += NTHREADS) {
    const int n = n0 + i;
    const bool in = n < N;
    col_c[i] = in ? (float)col_sum[n] : 0.0f;
    col_s[i] = in ? w_scale[n] : 0.0f;
    col_z[i] = in ? w_zero[n] : 0.0f;
    col_b[i] = in && bias != nullptr ? bias[n] : 0.0f;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warpgroup: thread lt unpacks 16-byte chunk j of the
    // packed rows r0, r0 + 32, ... of the tile's columns (rows of Wk)
    constexpr int CH = TT::CHUNKS;
    const int lt = tid - CONSUMERS;
    const int j = lt & 3, r0 = lt >> 2;
    // rows r0 + 32 i below N; all share the swizzle of row r0 ((r >> 1) & 3)
    const int rows = N - n0 - r0 > 0 ? (N - n0 - r0 + 31) / 32 : 0;
    const int8_t* src = w_km + (int64_t)(n0 + r0) * Kh + 16 * j;
    const int64_t row_step = (int64_t)32 * Kh;
    const int off = r0 * HALF + ((j ^ ((r0 >> 1) & 3)) << 4);
    auto load = [&](int kt, int4 (&r)[CH]) {
      const bool in_k = kt * HALF + 16 * j < Kh;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        r[i] = in_k && i < rows
                   ? __ldg(reinterpret_cast<const int4*>(src + i * row_step + kt * HALF))
                   : make_int4(0, 0, 0, 0);
    };
    // stage kt of the ring from the packed words r, and A's TMA
    auto produce = [&](int kt, const int4 (&r)[CH]) {
      const int st = kt % STAGES;
      mbar_wait_bounded(&empty[st], ((kt / STAGES) & 1) ^ 1);
      uint8_t* stage = sm + st * TT::STAGE;
      if (lt == 0) {
        mbar_arrive_expect_tx(&full[st], A_BYTES);
        tma_load_3d(stage, &a_map, kt * HALF, 0, m0, &full[st]);
        tma_load_3d(stage + A_HALF, &a_map, kt * HALF, 1, m0, &full[st]);
      }
      uint8_t* w_lo = stage + A_BYTES;
      uint8_t* w_hi = w_lo + TT::W_HALF;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int o = off + i * 32 * HALF;
        const uint32_t p0 = r[i].x, p1 = r[i].y, p2 = r[i].z, p3 = r[i].w;
        *reinterpret_cast<uint4*>(w_lo + o) = make_uint4(lo16(p0), lo16(p1), lo16(p2), lo16(p3));
        *reinterpret_cast<uint4*>(w_hi + o) = make_uint4(hi16(p0), hi16(p1), hi16(p2), hi16(p3));
      }
      // the stores are visible to the tensor cores' (async proxy) reads,
      // then handed over
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[st]);
    };
    // two register sets in turn, so that a stage's loads are in flight
    // while the stage before it is unpacked (a copy from one set to the
    // other would wait for them)
    int4 even[CH], odd[CH];
    load(0, even);
    for (int kt = 0; kt < nk; kt += 2) {
      if (kt + 1 < nk) load(kt + 1, odd);
      produce(kt, even);
      if (kt + 1 == nk) break;
      if (kt + 2 < nk) load(kt + 2, even);
      produce(kt + 1, odd);
    }
    return;
  }

  // the consumer warpgroups: rows 64 * wg .. + 63 of the tile
  const int wg = tid >> 7, wl = tid & 127;
  const int rrow = wg * 64 + (wl >> 1);  // the A row whose half wl & 1 this thread sums (z_w != 0)
  int acc[BN / 2];  // written only by the wgmmas (the first one clears them)
  int rsum = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait_bounded(&full[st], (kt / STAGES) & 1);
    const uint8_t* stage = sm + st * TT::STAGE;
    if (!wz0) {
      // the row's four chunks in any order; starting at (rrow >> 1) & 3
      // spreads a warp's reads over all banks
      const uint8_t* row = stage + (wl & 1) * A_HALF + rrow * HALF;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = *reinterpret_cast<const int4*>(row + (((q + (rrow >> 1)) & 3) << 4));
        rsum = __dp4a(v.x, 0x01010101, rsum);
        rsum = __dp4a(v.y, 0x01010101, rsum);
        rsum = __dp4a(v.z, 0x01010101, rsum);
        rsum = __dp4a(v.w, 0x01010101, rsum);
      }
    }
    const uint64_t da_lo = sw64_desc(stage + wg * 64 * HALF);
    const uint64_t da_hi = sw64_desc(stage + A_HALF + wg * 64 * HALF);
    const uint64_t db_lo = sw64_desc(stage + A_BYTES);
    const uint64_t db_hi = sw64_desc(stage + A_BYTES + TT::W_HALF);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    Wgmma<BN>::mma(acc, da_lo, db_lo, kt > 0 ? 1 : 0);
    Wgmma<BN>::mma(acc, da_lo + 2, db_lo + 2, 1);
    Wgmma<BN>::mma(acc, da_hi, db_hi, 1);
    Wgmma<BN>::mma(acc, da_hi + 2, db_hi + 2, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if ((tid & 31) == 0) mbar_arrive(&empty[st]);
  }
  fence_acc(acc);

  // epilogue: every consumer is past the ring, which now holds the int32
  // tile, 16 A.W exactly, divided by 16 here (acc[4j + r] is row
  // 16 * warp + g (+ 8 for r >= 2), column 8j + 2t (+ 1 for odd r) of the
  // warpgroup's 64 rows)
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r_lo = wg * 64 + (wl >> 5) * 16 + g;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = 8 * jj + 2 * t;
      *reinterpret_cast<int2*>(sm + r_lo * TT::LDO + col * 4) =
          make_int2(acc[4 * jj] >> 4, acc[4 * jj + 1] >> 4);
      *reinterpret_cast<int2*>(sm + (r_lo + 8) * TT::LDO + col * 4) =
          make_int2(acc[4 * jj + 2] >> 4, acc[4 * jj + 3] >> 4);
    }
    if (!wz0) {
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      if ((wl & 1) == 0) rs[rrow] = rsum;
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
  const float a_scale = *a_scale_p, z = *z_eff_p;
  const float kz = __fmul_rn((float)K, z);
  const bool has_bias = bias != nullptr;
  constexpr int CPR = BN / 4;  // four-column pieces per row
  for (int i = wl; i < 64 * CPR; i += 128) {
    const int row = wg * 64 + i / CPR, cl = (i % CPR) * 4;
    const int m = m0 + row, n = n0 + cl;
    if (m >= M || n >= N) continue;
    const int4 a4 = *reinterpret_cast<const int4*>(sm + row * TT::LDO + cl * 4);
    const int av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float rsv = wz0 ? 0.0f : (float)rs[row];
    const float4 c4 = *reinterpret_cast<const float4*>(col_c + cl);
    const float4 s4 = *reinterpret_cast<const float4*>(col_s + cl);
    const float4 z4 = *reinterpret_cast<const float4*>(col_z + cl);
    const float4 b4 = *reinterpret_cast<const float4*>(col_b + cl);
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float zv[4] = {z4.x, z4.y, z4.z, z4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = out_value(av[e], cv[e], z, a_scale, sv[e], wz0, zv[e], rsv, kz, has_bias, bv[e]);
    float* o = out + (int64_t)m * N + n;
    if (vec_out && n + 4 <= N) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4 && n + e < N; ++e) o[e] = v[e];
    }
  }
}

// The TMA map of A (M, K) as (M, 2, K/2) with strides (K, K/2, 1): boxes of
// 64 bytes x 1 half x BM rows in the 64-byte swizzle, zeros past K/2 in
// each half and past M
bool a_map_3d(CUtensorMap* map, const void* a, int M, int K) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)(K / 2), 2, (cuuint64_t)M};
  const cuuint64_t strides[2] = {(cuuint64_t)(K / 2), (cuuint64_t)K};
  const cuuint32_t box[3] = {(cuuint32_t)HALF, 1, (cuuint32_t)BM};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(a), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BN>
int launch(const void* a, const void* w_km, const void* col_sum, const void* w_scale,
           const void* w_zero, const void* bias, const void* a_scale, const void* z_eff,
           void* out, int M, int N, int K, bool wz0, cudaStream_t stream) {
  CUtensorMap a_map = {};
  if (!a_map_3d(&a_map, a, M, K)) return (int)cudaErrorNotSupported;
  const size_t smem = Tile<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(w4a8_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_out = N % 4 == 0 && aligned16(out);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4a8_wgmma_kernel<BN><<<grid, NTHREADS, smem, stream>>>(
      (const int8_t*)w_km, (const int*)col_sum, (const float*)w_scale, (const float*)w_zero,
      (const float*)bias, (const float*)a_scale, (const float*)z_eff, (float*)out, M, N, K, wz0,
      vec_out, a_map);
  return (int)cudaGetLastError();
}

}  // namespace wg4

// route 0: the mma.sync kernel over wp (K/2, N); route 1: the wgmma kernel
// over w_km, the K-major copy (N, K/2) of wp (K a multiple of 32, a and
// w_km 16-byte aligned). The caller picks the route from the shape.
extern "C" int qtt_w4a8_gemm(const void* a, const void* wp, const void* w_km, const void* col_sum,
                             const void* w_scale, const void* w_zero, const void* bias,
                             const void* a_scale, const void* z_eff, void* out, int M, int N,
                             int K, int w_zero_is_zero, int route, void* stream) {
  if (K % 2 != 0 || M < 1 || N < 1 || K < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wz0 = w_zero_is_zero != 0;
  if (route == 1) {
    if (K % 32 != 0 || K >= (1 << 17) || w_km == nullptr || !aligned16(a) || !aligned16(w_km))
      return (int)cudaErrorInvalidValue;
    if ((M + wg4::BM - 1) / wg4::BM > wg4::MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
    if (N > 128)
      return wg4::launch<256>(a, w_km, col_sum, w_scale, w_zero, bias, a_scale, z_eff, out, M, N,
                              K, wz0, s);
    if (N > 64)
      return wg4::launch<128>(a, w_km, col_sum, w_scale, w_zero, bias, a_scale, z_eff, out, M, N,
                              K, wz0, s);
    return wg4::launch<64>(a, w_km, col_sum, w_scale, w_zero, bias, a_scale, z_eff, out, M, N, K,
                           wz0, s);
  }
  if (route != 0 || wp == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  // 16-byte A loads need both halves' starts aligned: K/2 a multiple of 16
  const bool a_vec = ((K / 2) % 16 == 0) && aligned16(a);
  const bool w_vec = (N % 16 == 0) && aligned16(wp);
  w4a8_gemm_kernel<<<grid, NTHREADS, 0, s>>>(
      (const int8_t*)a, (const int8_t*)wp, (const int*)col_sum, (const float*)w_scale,
      (const float*)w_zero, (const float*)bias, (const float*)a_scale, (const float*)z_eff,
      (float*)out, M, N, K, wz0, a_vec, w_vec);
  return (int)cudaGetLastError();
}
