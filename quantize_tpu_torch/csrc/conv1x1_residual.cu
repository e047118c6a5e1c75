// K2: fused 1x1 conv + residual add + ReLU, as a GEMM over M = N*H*W rows:
//   out = relu(s_a * s_w[c] * (A.W + z_a * colsum[c]) + bias[c] + residual)
// in the carry dtype (f32 or bf16), with the residual read in its own dtype
// and added in f32 before the one rounding to the output dtype. Weight zero
// points must be exactly zero (the caller checks).
//
// Replaces the Pallas kernel
// quantize_tpu/ops/pallas/qconv1x1.py:_conv1x1_res_kernel. The Pallas
// version keeps K whole per tile; here K (64..512 on ResNet-50, up to 1,024
// on WideResNet-50-2) is a loop inside the block, which needs no carry
// across blocks.
//
// On the H100 the bottleneck tails are bound by bytes: for K = 64..512 and
// N = 4K the int8 operations per byte moved sit far below the card's ~590
// int8 ops/byte balance point, and almost all of the bytes are the (M, N)
// residual, read once, and the output, written once (8 bytes an output in
// f32 against K bytes of A a row). The kernel is therefore a stream of
// residual in / output out with a small int8 GEMM inside. Two routes,
// chosen by the caller from the shape before launch
// (ops/qconv1x1.py: _conv1x1_route):
//
// * wgmma (K a positive multiple of 16 below 2^17, N * itemsize of the
//   residual and the output a multiple of 16 bytes, A, the K-major weight,
//   the residual and the output 16-byte aligned): a persistent,
//   warp-specialized kernel, one block an SM (as many as the occupancy
//   query allows), each walking the 128 x 128 output tiles tile = blockIdx.x
//   + i * gridDim.x, the N-tiles of one M block in a row so that A comes
//   from L2. One producer thread issues every copy by TMA: at the start of
//   each tile the tile's residual (bands of 128 rows x 128 bytes in the
//   128-byte swizzle, loaded a few rows at a time across the bands) into
//   one of two residual/output buffers, then the
//   tile's A (M, K) and K-major W (N, K) stages of 128 K bytes (zeros past
//   K, M and N) into a ring of 2-4 stages. It runs ahead into the next tile
//   while the consumers finish this one, so the residual arrives during the
//   K loop and the next tile's loads fly during this tile's epilogue and
//   store. Two consumer warpgroups of 64 rows issue
//   wgmma.mma_async.m64n128k32.s32.s8.s8 with both operands in shared
//   memory. The epilogue reads each accumulator's residual from the
//   swizzled buffer (a warp's float2 reads touch every bank twice: no
//   conflict beyond the two wavefronts 256 bytes need), computes the output
//   in the plain version's rounding order with s_w, colsum and the bias
//   read once per tile column (staged in shared memory), writes it back in
//   place (through registers when the output dtype differs), and each
//   warpgroup stores its 64 rows by TMA (clipped at M and N) from the same
//   buffer; the buffer goes back to the producer once the store has read
//   it. Shared memory does not depend on M or K: two buffers of 128 x 128
//   outputs (64 KB each in f32) and the ring (32 KB a stage), <= 227 KB.
// * mma_sync (every other shape): the shared int8 mainloop of
//   int8_mma.cuh, 128 x 64 tiles, the epilogue one scalar a thread.
#include "int8_mma.cuh"
#include "sm90.cuh"

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

namespace wg2 {

constexpr int BM = 128;            // rows per tile (two consumer warpgroups)
constexpr int BN = 128;            // columns per tile
constexpr int BK = 128;            // K bytes per stage: one 128-byte swizzled row
constexpr int CONSUMERS = 256;     // warpgroups 0 and 1
constexpr int NTHREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK;   // one A stage, 16 KB
constexpr int B_BYTES = BN * BK;   // one W stage, 16 KB
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int BOX = BM * 128;      // a residual/output column band: 128 rows of 128 bytes
// rows a residual/output TMA box, by element size: the boxes of a tile are
// issued a few rows at a time across all its bands. Measured on an H100
// at ResNet-50's tails (scripts/bench_conv1x1.py; PERF.md): f32 boxes of 8
// rows ran 8% faster than bands of 128, bf16 boxes of 8 rows 15% slower,
// of 32-128 rows alike.
constexpr int rows_a_box(int sz) { return sz == 4 ? 8 : 64; }
constexpr int SMEM_LIMIT = 232448;  // 227 KB, what a block may use
// the barriers (at most 12) and, per consumer warpgroup, colsum / s_w / bias
// of the tile's columns
constexpr int TAIL = 128 + 2 * 3 * BN * 4;

template <typename TRes, typename TOut>
struct Tile {
  static constexpr int RES_SZ = sizeof(TRes), OUT_SZ = sizeof(TOut);
  static constexpr int RC = 128 / RES_SZ;  // residual columns a box row
  static constexpr int OC = 128 / OUT_SZ;  // output columns a box row
  static constexpr int RRB = rows_a_box(RES_SZ), ORB = rows_a_box(OUT_SZ);
  // one residual/output buffer: the wider of the two tiles, in bands
  static constexpr int BUF = BN * (RES_SZ > OUT_SZ ? RES_SZ : OUT_SZ) / 128 * BOX;
  static constexpr int FREE = SMEM_LIMIT - 1024 - 2 * BUF - TAIL;
  static constexpr int STAGES = FREE / STAGE > 4 ? 4 : FREE / STAGE;  // the ring's depth
  // the ring, two buffers, the tail and 1,024 bytes of alignment slack
  static constexpr size_t SMEM = STAGES * STAGE + 2 * BUF + TAIL + 1024;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(ORB <= 64 && 64 % ORB == 0, "a store box stays within a warpgroup's rows");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

// the byte offset of element (row, col) of a tile held as boxes of 128 rows
// x 128 bytes in the 128-byte swizzle (16-byte chunk j of row r at chunk
// j ^ (r & 7)), for elements of `sz` bytes
__device__ __forceinline__ int swz(int row, int col, int sz) {
  const int per = 128 / sz;
  const int byte = (col % per) * sz;
  return (col / per) * BOX + row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One output in the plain version's order (every step rounded as there).
__device__ __forceinline__ float out_value(int acc, float cs, float z, float a_scale, float ws,
                                           bool has_bias, float b, float r, bool relu) {
  const float corrected = __fadd_rn((float)acc, __fmul_rn(z, cs));
  float v = __fmul_rn(__fmul_rn(a_scale, ws), corrected);
  if (has_bias) v = __fadd_rn(v, b);
  v = __fadd_rn(v, r);
  return relu ? fmaxf(v, 0.0f) : v;
}

template <typename TRes, typename TOut>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv1x1_res_wgmma_kernel(const int* __restrict__ col_sum, const float* __restrict__ w_scale,
                             const float* __restrict__ bias, const float* __restrict__ a_scale_p,
                             const float* __restrict__ z_eff_p, int M, int N, int K, bool relu,
                             const __grid_constant__ CUtensorMap a_map,
                             const __grid_constant__ CUtensorMap w_map,
                             const __grid_constant__ CUtensorMap res_map,
                             const __grid_constant__ CUtensorMap out_map) {
  using TT = Tile<TRes, TOut>;
  constexpr int STAGES = TT::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the ring first, on a 1,024-byte boundary (the 128-byte swizzle's atom),
  // then the two buffers
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* bufs = ring + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(bufs + 2 * TT::BUF);  // a stage's A and W landed
  uint64_t* empty = full + STAGES;                                    // its wgmmas are retired
  uint64_t* rfull = empty + STAGES;   // a buffer's residual landed
  uint64_t* rempty = rfull + 2;       // a buffer's output store has read it
  float* cols = reinterpret_cast<float*>(ring + STAGES * STAGE + 2 * TT::BUF + 128);
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);                // the producer's arrival with the TMA bytes
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&rfull[b], 1);
      mbar_init(&rempty[b], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer: one thread issues every copy; the stage counter g and
    // the tile counter it run on across tiles, and with them the parities
    if (tid != CONSUMERS) return;
    int g = 0;
    for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      const int b = it & 1;
      uint8_t* buf = bufs + b * TT::BUF;
      // the buffer's previous output (tile it - 2) has been read by its store
      mbar_wait_bounded(&rempty[b], ((it >> 1) & 1) ^ 1);
      // RRB rows at a time across the tile's bands that reach into the
      // tensor, down to the last box that reaches into it
      const int bands = min(BN / TT::RC, (N - n0 + TT::RC - 1) / TT::RC);
      const int rows = min(BM, (M - m0 + TT::RRB - 1) / TT::RRB * TT::RRB);
      mbar_arrive_expect_tx(&rfull[b], bands * rows * 128);
      for (int r = 0; r < rows; r += TT::RRB)
        for (int c = 0; c < bands; ++c)
          tma_load_2d(buf + c * BOX + r * 128, &res_map, n0 + c * TT::RC, m0 + r, &rfull[b]);
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int st = g % STAGES;
        mbar_wait_bounded(&empty[st], ((g / STAGES) & 1) ^ 1);
        uint8_t* stage = ring + st * STAGE;
        mbar_arrive_expect_tx(&full[st], STAGE);
        tma_load_2d(stage, &a_map, kt * BK, m0, &full[st]);
        tma_load_2d(stage + A_BYTES, &w_map, kt * BK, n0, &full[st]);
      }
    }
    return;
  }

  // the consumer warpgroups: rows 64 * wg .. + 63 of each tile; acc[4j + r]
  // is row 16 * warp + g8 (+ 8 for r >= 2), column 8j + 2 t4 (+ 1 for odd r)
  // of the warpgroup's 64 rows
  const int wg = tid >> 7, wl = tid & 127, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row0 = wg * 64 + (wl >> 5) * 16 + g8;
  const float a_scale = *a_scale_p, z = *z_eff_p;
  const bool has_bias = bias != nullptr;
  float* c_cs = cols + wg * 3 * BN;  // this warpgroup's copy of the tile's columns
  float* c_ws = c_cs + BN;
  float* c_b = c_ws + BN;
  int acc[BN / 2];  // written only by the wgmmas (the first of each tile clears them)
  int g = 0;
  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    const int b = it & 1;
    uint8_t* buf = bufs + b * TT::BUF;
    // column wl of the tile's vectors, in flight during the K loop
    const int n = n0 + wl;
    const float v_cs = n < N ? (float)__ldg(col_sum + n) : 0.0f;
    const float v_ws = n < N ? __ldg(w_scale + n) : 0.0f;
    const float v_b = n < N && has_bias ? __ldg(bias + n) : 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int st = g % STAGES;
      mbar_wait_bounded(&full[st], (g / STAGES) & 1);
      const uint8_t* stage = ring + st * STAGE;
      const uint64_t da = sw128_desc(stage + wg * 64 * 128), db = sw128_desc(stage + A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, (kt > 0 || kk > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    fence_acc(acc);
    c_cs[wl] = v_cs;
    c_ws[wl] = v_ws;
    c_b[wl] = v_b;
    mbar_wait_bounded(&rfull[b], (it >> 1) & 1);
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");  // the columns are in

    // the epilogue, in place: the output of each residual element goes
    // where the element was; an output of another width is held in
    // registers until the warpgroup has read all of its residual
    constexpr bool SAME = sizeof(TRes) == sizeof(TOut);
    float held[SAME ? 1 : BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 cs = *reinterpret_cast<const float2*>(c_cs + col);
      const float2 ws = *reinterpret_cast<const float2*>(c_ws + col);
      const float2 bb = *reinterpret_cast<const float2*>(c_b + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const float2 r = load2(reinterpret_cast<const TRes*>(buf + swz(row, col, sizeof(TRes))));
        const float v0 = out_value(acc[4 * j + 2 * h], cs.x, z, a_scale, ws.x, has_bias, bb.x, r.x, relu);
        const float v1 = out_value(acc[4 * j + 2 * h + 1], cs.y, z, a_scale, ws.y, has_bias, bb.y, r.y, relu);
        if constexpr (SAME) {
          store2(reinterpret_cast<TOut*>(buf + swz(row, col, sizeof(TOut))), v0, v1);
        } else {
          held[4 * j + 2 * h] = v0;
          held[4 * j + 2 * h + 1] = v1;
        }
      }
    }
    if constexpr (!SAME) {
      asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(reinterpret_cast<TOut*>(buf + swz(row0 + 8 * h, 8 * j + 2 * t4, sizeof(TOut))),
                 held[4 * j + 2 * h], held[4 * j + 2 * h + 1]);
    }
    // the writes are visible to the TMA store (the async proxy), then one
    // thread stores the warpgroup's 64 rows and hands the buffer back once
    // the store has read it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
    if (wl == 0) {
      const int r0 = m0 + 64 * wg;
      if (r0 < M) {
        for (int r = 0; r < 64 && r0 + r < M; r += TT::ORB)
          for (int o = 0; o < BN / TT::OC && n0 + o * TT::OC < N; ++o)
            tma_store_2d(&out_map, buf + o * BOX + (wg * 64 + r) * 128, n0 + o * TT::OC, r0 + r);
        bulk_commit();
        bulk_wait_read<0>();
      }
      mbar_arrive(&rempty[b]);
    }
  }
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A 2-D TMA map of a row-major (rows, cols) tensor: boxes of box_c
// columns (128 bytes) x box_r rows in the 128-byte swizzle; loads
// zero-fill and stores clip past the tensor
bool map_2d(CUtensorMap* map, const void* p, CUtensorMapDataType type, int elem, int rows,
            int cols, int box_c, int box_r) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename TRes, typename TOut>
int launch(const void* a, const void* w_km, const void* col_sum, const void* w_scale,
           const void* bias, const void* a_scale, const void* z_eff, const void* res, void* out,
           int M, int N, int K, bool relu, cudaStream_t stream) {
  using TT = Tile<TRes, TOut>;
  CUtensorMap a_map = {}, w_map = {}, res_map = {}, out_map = {};
  if (!map_2d(&a_map, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, BK, BM) ||
      !map_2d(&w_map, w_km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, BK, BN) ||
      !map_2d(&res_map, res, tma_type<TRes>(), sizeof(TRes), M, N, TT::RC, TT::RRB) ||
      !map_2d(&out_map, out, tma_type<TOut>(), sizeof(TOut), M, N, TT::OC, TT::ORB))
    return (int)cudaErrorNotSupported;
  auto kernel = conv1x1_res_wgmma_kernel<TRes, TOut>;
  const size_t smem = TT::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem)) !=
          cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  kernel<<<grid, NTHREADS, smem, stream>>>((const int*)col_sum, (const float*)w_scale,
                                           (const float*)bias, (const float*)a_scale,
                                           (const float*)z_eff, M, N, K, relu, a_map, w_map,
                                           res_map, out_map);
  return (int)cudaGetLastError();
}

}  // namespace wg2

// dtype codes: 0 = float32, 1 = bfloat16. route 0: the mma_sync kernel over
// w (K, N); route 1: the wgmma kernel over w_km, the K-major copy (N, K) of
// w (the shape and alignment conditions above). The caller picks the route.
extern "C" int qtt_conv1x1_residual(const void* a, const void* w, const void* w_km,
                                    const void* col_sum, const void* w_scale, const void* bias,
                                    const void* a_scale, const void* z_eff, const void* res,
                                    void* out, int M, int N, int K, int relu, int res_dtype,
                                    int out_dtype, int route, void* stream) {
  if (M < 1 || N < 1 || K < 1 || res_dtype < 0 || res_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const int narrow = res_dtype == 1 || out_dtype == 1 ? 2 : 4;
    if (K % 16 != 0 || K >= (1 << 17) || (long long)N * narrow % 16 != 0 || w_km == nullptr ||
        !aligned16(a) || !aligned16(w_km) || !aligned16(res) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
#define QTT_LAUNCH(TR, TO) \
  wg2::launch<TR, TO>(a, w_km, col_sum, w_scale, bias, a_scale, z_eff, res, out, M, N, K, relu != 0, s)
    if (res_dtype == 0 && out_dtype == 0) return QTT_LAUNCH(float, float);
    if (res_dtype == 0) return QTT_LAUNCH(float, __nv_bfloat16);
    if (out_dtype == 0) return QTT_LAUNCH(__nv_bfloat16, float);
    return QTT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef QTT_LAUNCH
  }
  if (route != 0 || w == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const bool a_vec = (K % 16 == 0) && aligned16(a);
  const bool w_vec = (N % 16 == 0) && aligned16(w);
#define QTT_LAUNCH(TR, TO)                                                                  \
  conv1x1_res_kernel<TR, TO><<<grid, NTHREADS, 0, s>>>(                                     \
      (const int8_t*)a, (const int8_t*)w, (const int*)col_sum, (const float*)w_scale,       \
      (const float*)bias, (const float*)a_scale, (const float*)z_eff, (const TR*)res,       \
      (TO*)out, M, N, K, relu != 0, a_vec, w_vec)
  if (res_dtype == 0 && out_dtype == 0) QTT_LAUNCH(float, float);
  else if (res_dtype == 0) QTT_LAUNCH(float, __nv_bfloat16);
  else if (out_dtype == 0) QTT_LAUNCH(__nv_bfloat16, float);
  else QTT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef QTT_LAUNCH
  return (int)cudaGetLastError();
}
