// K1: fused W8A8 matmul, out(M, N) f32 =
//   s_a * s_w[n] * (A.W + z_a * colsum[n] + z_w[n] * rowsum(A)[m] + K * z_a * z_w[n]) + bias[n]
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/qmatmul.py:_w8a8_kernel
// (and its XLA twin quant_matmul_w8a8_xla, which computes the same math).
// The rowsum(A) terms are computed only when the weight zero points are not
// all zero (w_zero_is_zero false); symmetric signed weights drop them. The
// integer sums are exact and the epilogue rounds in the plain version's
// order, so both routes are bit-equal to it.
//
// On the H100 the main path's call (the ResNet fc: M = batch, K = 2048,
// N = 1000) is bound by bytes (2 MB of weights and M x 4 KB of output
// against 2*M*N*K int8 operations), and so are the W8A8 projections of a
// ViT at large M, where the f32 output dominates. Two routes, chosen by the
// caller from the shape before launch (ops/qmatmul.py: _w8a8_route):
//
// * wgmma (K a positive multiple of 16 below 2^17; A and the K-major weight
//   copy w_km (N, K) 16-byte aligned): warp-specialized kernels on K2's
//   stage format (conv1x1_residual.cu), 288 threads: one producer thread
//   issues A and w_km stages of 128 K bytes by TMA in the 128-byte swizzle
//   (zeros past K, M and N) into a ring, and two consumer warpgroups of 64
//   rows issue wgmma.mma_async.m64nBNk32.s32.s8.s8 four times a stage, one
//   stage's wgmmas in flight while the next is awaited (and, when z_w != 0,
//   sum their A rows by __dp4a). Where the output has enough tiles to fill
//   the card (S = 1) the kernel is persistent, one block an SM walking
//   128 x 256 tiles through a 4-stage ring, and stores the epilogue from
//   the accumulators, so the producer runs ahead
//   into the next tile while it is written. For small M the K loop is split
//   across a thread-block cluster of S CTAs (S in 2, 4, 8, chosen by the
//   caller: ops/qmatmul.py: _w8a8_split; 128 x 128 tiles, a 3-stage ring,
//   two blocks an SM) that share one output tile: each
//   stages its int32 partial tile in its shared memory, and after a cluster
//   barrier CTA r sums its 128 / S rows of every partial through
//   distributed shared memory (int32 sums are exact in any order: no
//   workspace, atomic or second launch) and runs the epilogue for them.
// * mma_sync (every other K, or unaligned operands): the shared int8
//   mainloop of int8_mma.cuh, 128 x 64 tiles over the (K, N) weight.
#include <cooperative_groups.h>

#include "int8_mma.cuh"
#include "sm90.cuh"

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

namespace wg1 {

namespace cg = cooperative_groups;

constexpr int BM = 128;            // rows per tile (two consumer warpgroups)
constexpr int BK = 128;            // K bytes per stage: one 128-byte swizzled row
constexpr int CONSUMERS = 256;     // warpgroups 0 and 1
constexpr int NTHREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK;   // one A stage, 16 KB
constexpr int MAX_SPLIT = 8;
constexpr int MAX_GRID_Y = 65535;

// A tile width and ring depth. The shared memory: the ring (the split
// kernel's partial tile goes over it), the full and empty barriers, the row
// sums, per consumer warpgroup colsum / s_w / z_w / bias of the tile's
// columns, alignment slack.
template <int BN_, int STAGES_>
struct Tile {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr int STAGE = A_BYTES + BN * BK;  // a multiple of 1,024
  static constexpr int RING = STAGES * STAGE;
  static constexpr size_t SMEM = RING + 2 * STAGES * 8 + BM * 4 + 2 * 4 * BN * 4 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};
// the persistent kernel's 128 x 256 tiles (one block an SM) and the split
// kernel's 128 x 128 tiles (two blocks an SM)
using Wide = Tile<256, 4>;
using Split = Tile<128, 3>;
constexpr int LDP = Split::BN + 4;  // row stride (int32) of the staged partial tile
static_assert(BM * LDP * 4 <= Split::RING, "the partial tile fits over the ring");
static_assert(2 * (Split::SMEM + 1024) <= 233472, "two split blocks an SM");

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

template <class T>
struct Smem {
  uint8_t* ring;
  uint64_t* full;   // a stage's A and W landed
  uint64_t* empty;  // its wgmmas are retired
  int* rs;          // the split kernel's partial row sums
  float* cols;      // [2][4][T::BN]: colsum, s_w, z_w, bias for each consumer warpgroup
  __device__ __forceinline__ Smem(uint8_t* raw) {
    // the ring first, on a 1,024-byte boundary (the 128-byte swizzle's atom)
    ring = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(ring + T::RING);
    empty = full + T::STAGES;
    rs = reinterpret_cast<int*>(empty + T::STAGES);
    cols = reinterpret_cast<float*>(rs + BM);
  }
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(&full[i], 1);                // the producer's arrival with the TMA bytes
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer thread: stages kt0 .. kt1 - 1 of the tile at (m0, n0) into
// the ring; g counts the stages this block has produced (it carries the
// ring's slot and parity across tiles)
template <class T>
__device__ __forceinline__ void produce(const Smem<T>& sm, const CUtensorMap* a_map,
                                        const CUtensorMap* w_map, int m0, int n0, int kt0,
                                        int kt1, int& g) {
  for (int kt = kt0; kt < kt1; ++kt, ++g) {
    const int st = g % T::STAGES;
    mbar_wait_bounded(&sm.empty[st], ((g / T::STAGES) & 1) ^ 1);
    uint8_t* stage = sm.ring + st * T::STAGE;
    mbar_arrive_expect_tx(&sm.full[st], T::STAGE);
    tma_load_2d(stage, a_map, kt * BK, m0, &sm.full[st]);
    tma_load_2d(stage + A_BYTES, w_map, kt * BK, n0, &sm.full[st]);
  }
}

// A consumer warpgroup's K loop over stages kt0 .. kt1 - 1 (at least one):
// acc[4j + r] is row 16 * warp + gq (+ 8 for r >= 2), column 8j + 2t (+ 1
// for odd r) of the warpgroup's 64 rows (gq = lane / 4, t = lane % 4). One
// stage's wgmmas stay in flight while the next stage is awaited; a stage
// goes back to the producer once its wgmmas are retired. When z_w != 0, the
// four threads of a row pair (same gq) each sum two of the eight 16-byte
// chunks of rows r0 and r0 + 8 of the stage (in any order: the swizzle
// permutes a row's chunks within the row; the chunk rotated by gq so that a
// warp's reads spread over all banks) into rs0 and rs1.
template <class T>
__device__ __forceinline__ void consume(const Smem<T>& sm, int wg, int lane, int kt0, int kt1,
                                        int& g, int (&acc)[T::BN / 2], bool wz0, int& rs0,
                                        int& rs1) {
  constexpr int STAGES = T::STAGES;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + gq;
  rs0 = rs1 = 0;
  for (int kt = kt0; kt < kt1; ++kt, ++g) {
    const int st = g % STAGES;
    mbar_wait_bounded(&sm.full[st], (g / STAGES) & 1);
    const uint8_t* stage = sm.ring + st * T::STAGE;
    const uint64_t da = sw128_desc(stage + wg * 64 * 128), db = sw128_desc(stage + A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      Wgmma<T::BN>::mma(acc, da + 2 * kk, db + 2 * kk, (kt > kt0 || kk > 0) ? 1 : 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (!wz0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int chunk = ((2 * t + q + gq) & 7) << 4;
        const int4 a = *reinterpret_cast<const int4*>(stage + r0 * 128 + chunk);
        const int4 b = *reinterpret_cast<const int4*>(stage + (r0 + 8) * 128 + chunk);
        rs0 = __dp4a(a.x, 0x01010101, rs0);
        rs0 = __dp4a(a.y, 0x01010101, rs0);
        rs0 = __dp4a(a.z, 0x01010101, rs0);
        rs0 = __dp4a(a.w, 0x01010101, rs0);
        rs1 = __dp4a(b.x, 0x01010101, rs1);
        rs1 = __dp4a(b.y, 0x01010101, rs1);
        rs1 = __dp4a(b.z, 0x01010101, rs1);
        rs1 = __dp4a(b.w, 0x01010101, rs1);
      }
    }
    // the previous stage's wgmmas are retired: it goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > kt0 && lane == 0) mbar_arrive(&sm.empty[(g + STAGES - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (lane == 0) mbar_arrive(&sm.empty[(g + STAGES - 1) % STAGES]);
  fence_acc(acc);
  if (!wz0) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
  }
}

// K1 for S = 1 (large M): persistent, one block an SM walking the 128 x 256
// tiles tile = blockIdx.x + i * gridDim.x (the N-tiles of an M block in a
// row, so that A comes from L2). The epilogue stores from the accumulators
// straight to the output (a warp's float2 stores fill whole 32-byte
// sectors), so the ring is free during it and the producer runs ahead into
// the next tile's stages.
__global__ void __launch_bounds__(NTHREADS, 1)
    w8a8_wgmma_kernel(const int* __restrict__ col_sum, const float* __restrict__ w_scale,
                      const float* __restrict__ w_zero, const float* __restrict__ bias,
                      const float* __restrict__ a_scale_p, const float* __restrict__ z_eff_p,
                      float* __restrict__ out, int M, int N, int K, bool wz0, bool vec_out,
                      const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap w_map) {
  using T = Wide;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  const Smem<T> sm(smem_raw);
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) sm.init();
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        produce(sm, &a_map, &w_map, tile / tiles_n * BM, tile % tiles_n * BN, 0, nk, g);
    }
    return;
  }
  const int wg = tid >> 7, wl = tid & 127, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + (wl >> 5) * 16 + gq;
  const float a_scale = *a_scale_p, z = *z_eff_p;
  const float kz = __fmul_rn((float)K, z);
  const bool has_bias = bias != nullptr;
  float* c_cs = sm.cols + wg * 4 * BN;  // this warpgroup's copy of the tile's columns
  float* c_ws = c_cs + BN;
  float* c_wz = c_ws + BN;
  float* c_b = c_wz + BN;
  int acc[BN / 2];  // written only by the wgmmas (the first of each tile clears them)
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    // columns wl + 128 c of the tile's vectors, in flight during the K loop
    constexpr int PER = BN / 128;
    float v_cs[PER], v_ws[PER], v_wz[PER], v_b[PER];
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int n = n0 + wl + 128 * c;
      v_cs[c] = n < N ? (float)__ldg(col_sum + n) : 0.0f;
      v_ws[c] = n < N ? __ldg(w_scale + n) : 0.0f;
      v_wz[c] = n < N ? __ldg(w_zero + n) : 0.0f;
      v_b[c] = n < N && has_bias ? __ldg(bias + n) : 0.0f;
    }
    int rs0, rs1;
    consume(sm, wg, lane, 0, nk, g, acc, wz0, rs0, rs1);
    // the warpgroup's previous epilogue has read the columns; then the new ones are in
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      c_cs[wl + 128 * c] = v_cs[c];
      c_ws[wl + 128 * c] = v_ws[c];
      c_wz[wl + 128 * c] = v_wz[c];
      c_b[wl + 128 * c] = v_b[c];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
    const float rsf[2] = {(float)rs0, (float)rs1};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 cs = *reinterpret_cast<const float2*>(c_cs + col);
      const float2 ws = *reinterpret_cast<const float2*>(c_ws + col);
      const float2 wz = *reinterpret_cast<const float2*>(c_wz + col);
      const float2 bb = *reinterpret_cast<const float2*>(c_b + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h, nn = n0 + col;
        if (m >= M || nn >= N) continue;
        const float v0 = out_value(acc[4 * j + 2 * h], cs.x, z, a_scale, ws.x, wz0, wz.x, rsf[h],
                                   kz, has_bias, bb.x);
        const float v1 = out_value(acc[4 * j + 2 * h + 1], cs.y, z, a_scale, ws.y, wz0, wz.y,
                                   rsf[h], kz, has_bias, bb.y);
        float* o = out + (int64_t)m * N + nn;
        if (vec_out && nn + 2 <= N) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (nn + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

// K1 for S > 1 (small M): a cluster of `split` CTAs shares one output tile,
// CTA r summing K stages [r nk / S, (r + 1) nk / S). Each stages its int32
// partial tile (and its partial row sums) in its shared memory over the
// ring; after a cluster barrier CTA r sums rows [r 128 / S, (r + 1) 128 / S)
// of every CTA's partials through distributed shared memory (int32 sums are
// exact in any order) and runs the epilogue for those rows in 16-byte
// stores along each output row.
__global__ void __launch_bounds__(NTHREADS, 2)
    w8a8_wgmma_split_kernel(const int* __restrict__ col_sum, const float* __restrict__ w_scale,
                            const float* __restrict__ w_zero, const float* __restrict__ bias,
                            const float* __restrict__ a_scale_p,
                            const float* __restrict__ z_eff_p, float* __restrict__ out, int M,
                            int N, int K, int split, bool wz0, bool vec_out,
                            const __grid_constant__ CUtensorMap a_map,
                            const __grid_constant__ CUtensorMap w_map) {
  using T = Split;
  constexpr int BN = T::BN;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  const Smem<T> sm(smem_raw);
  const int rank = (int)cluster.block_rank();  // this CTA's K slice
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x / split * BN;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = rank * nk / split, kt1 = (rank + 1) * nk / split;
  const int tid = threadIdx.x;
  float* col_c = sm.cols;
  float* col_s = col_c + BN;
  float* col_z = col_s + BN;
  float* col_b = col_z + BN;
  if (tid == 0) sm.init();
  for (int i = tid; i < BN; i += NTHREADS) {
    const int n = n0 + i;
    const bool in = n < N;
    col_c[i] = in ? (float)col_sum[n] : 0.0f;
    col_s[i] = in ? w_scale[n] : 0.0f;
    col_z[i] = in ? w_zero[n] : 0.0f;
    col_b[i] = in && bias != nullptr ? bias[n] : 0.0f;
  }
  __syncthreads();

  int* part = reinterpret_cast<int*>(sm.ring);
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      int g = 0;
      produce(sm, &a_map, &w_map, m0, n0, kt0, kt1, g);
    }
    __syncwarp();
  } else {
    const int wg = tid >> 7, wl = tid & 127, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int row0 = wg * 64 + (wl >> 5) * 16 + gq;
    int acc[BN / 2];
    int g = 0, rs0, rs1;
    consume(sm, wg, lane, kt0, kt1, g, acc, wz0, rs0, rs1);
    // every consumer is past the ring, which now takes the partial tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<int2*>(part + row0 * LDP + col) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(part + (row0 + 8) * LDP + col) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (!wz0 && t == 0) {
      sm.rs[row0] = rs0;
      sm.rs[row0 + 8] = rs1;
    }
  }
  // every CTA's partial tile and row sums are in its shared memory
  cluster.sync();

  const int r_begin = rank * BM / split, r_end = (rank + 1) * BM / split;
  const float a_scale = *a_scale_p, z = *z_eff_p;
  const float kz = __fmul_rn((float)K, z);
  const bool has_bias = bias != nullptr;
  constexpr int CPR = BN / 4;  // four-column pieces a row
  for (int i = tid; i < (r_end - r_begin) * CPR; i += NTHREADS) {
    const int row = r_begin + i / CPR, cl = (i % CPR) * 4;
    const int m = m0 + row, n = n0 + cl;
    if (m >= M || n >= N) continue;
    int4 a4 = make_int4(0, 0, 0, 0);
    int rsi = 0;
    for (int q = 0; q < split; ++q) {
      const int4 p = *reinterpret_cast<const int4*>(cluster.map_shared_rank(part, q) + row * LDP + cl);
      a4.x += p.x;
      a4.y += p.y;
      a4.z += p.z;
      a4.w += p.w;
      if (!wz0) rsi += cluster.map_shared_rank(sm.rs, q)[row];
    }
    const int av[4] = {a4.x, a4.y, a4.z, a4.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = out_value(av[e], col_c[cl + e], z, a_scale, col_s[cl + e], wz0, col_z[cl + e],
                       (float)rsi, kz, has_bias, col_b[cl + e]);
    float* o = out + (int64_t)m * N + n;
    if (vec_out && n + 4 <= N) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4 && n + e < N; ++e) o[e] = v[e];
    }
  }
  // no CTA leaves while another still reads its shared memory
  cluster.sync();
}

// A 2-D TMA map of a row-major int8 (rows, cols) tensor: boxes of 128
// bytes x box_rows rows in the 128-byte swizzle; zeros past the tensor
bool map_2d(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int launch(const void* a, const void* w_km, const void* col_sum, const void* w_scale,
           const void* w_zero, const void* bias, const void* a_scale, const void* z_eff,
           void* out, int M, int N, int K, bool wz0, int split, cudaStream_t stream) {
  const int bn = split == 1 ? Wide::BN : Split::BN;
  const size_t smem = split == 1 ? Wide::SMEM : Split::SMEM;
  CUtensorMap a_map = {}, w_map = {};
  if (!map_2d(&a_map, a, M, K, BM) || !map_2d(&w_map, w_km, N, K, bn))
    return (int)cudaErrorNotSupported;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + bn - 1) / bn;
  cudaError_t err;
  if (split == 1) {
    if ((err = cudaFuncSetAttribute(w8a8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w8a8_wgmma_kernel, NTHREADS,
                                                             smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long tiles = (long long)tiles_m * tiles_n;
    const int grid = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
    const bool vec2 = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
    w8a8_wgmma_kernel<<<grid, NTHREADS, smem, stream>>>(
        (const int*)col_sum, (const float*)w_scale, (const float*)w_zero, (const float*)bias,
        (const float*)a_scale, (const float*)z_eff, (float*)out, M, N, K, wz0, vec2, a_map, w_map);
    return (int)cudaGetLastError();
  }
  if (tiles_m > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaFuncSetAttribute(w8a8_wgmma_split_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n * split, tiles_m);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec4 = N % 4 == 0 && aligned16(out);
  err = cudaLaunchKernelEx(&cfg, w8a8_wgmma_split_kernel, (const int*)col_sum,
                           (const float*)w_scale, (const float*)w_zero, (const float*)bias,
                           (const float*)a_scale, (const float*)z_eff, (float*)out, M, N, K, split,
                           wz0, vec4, a_map, w_map);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace wg1

// route 0: the mma.sync kernel over w (K, N); route 1: the wgmma kernel over
// w_km, the K-major copy (N, K) of w (K a multiple of 16 below 2^17, a and
// w_km 16-byte aligned), its K loop split across a cluster of `split` CTAs
// (1, 2, 4 or 8, at most the number of K stages). The caller picks both.
extern "C" int qtt_w8a8_gemm(const void* a, const void* w, const void* w_km, const void* col_sum,
                             const void* w_scale, const void* w_zero, const void* bias,
                             const void* a_scale, const void* z_eff, void* out, int M, int N,
                             int K, int w_zero_is_zero, int route, int split, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wz0 = w_zero_is_zero != 0;
  if (route == 1) {
    const int nk = (K + wg1::BK - 1) / wg1::BK;
    if (K % 16 != 0 || K >= (1 << 17) || w_km == nullptr || !aligned16(a) || !aligned16(w_km) ||
        (split & (split - 1)) != 0 || split < 1 || split > wg1::MAX_SPLIT || split > nk)
      return (int)cudaErrorInvalidValue;
    return wg1::launch(a, w_km, col_sum, w_scale, w_zero, bias, a_scale, z_eff, out, M, N, K, wz0,
                       split, s);
  }
  if (route != 0 || w == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const bool a_vec = (K % 16 == 0) && aligned16(a);
  const bool w_vec = (N % 16 == 0) && aligned16(w);
  w8a8_gemm_kernel<<<grid, NTHREADS, 0, s>>>(
      (const int8_t*)a, (const int8_t*)w, (const int*)col_sum, (const float*)w_scale,
      (const float*)w_zero, (const float*)bias, (const float*)a_scale, (const float*)z_eff,
      (float*)out, M, N, K, wz0, a_vec, w_vec);
  return (int)cudaGetLastError();
}
