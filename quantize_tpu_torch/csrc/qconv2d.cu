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
// downsample and early-stage convs by bytes, the f32 output being the
// largest stream. The patch matrix never reaches device memory: it exists
// only tile by tile in shared memory. A warp-specialized wgmma kernel: a
// block computes a 128 x BN output tile (BN = 256, 128 or 64 by Co) with 384
// threads. A producer warpgroup gathers the patch rows by 16-byte cp.async
// (src-size 0 at padding and edges: the int8 zero the XLA conv pads with),
// taps in the outer loop and channels in the inner one from per-row bases
// computed once per tile, so no division per chunk, into the 128-byte
// swizzle; its thread 0 loads the weight by TMA from a K-major (Co, K) copy
// (8-bit wgmma reads both operands K-major), zero-filled past K and Co. A
// 4-stage mbarrier ring hands the stages to two consumer warpgroups of 64
// rows, which issue wgmma.mma_async.m64nBNk32.s32.s8.s8 with both operands
// in shared memory (and, when z_w != 0, sum their A rows by __dp4a). The
// epilogue stages the int32 tile in shared memory so that each output row
// leaves in 16-byte stores, with corr_a read in 16-byte pieces and s_w, the
// bias and z_w read once per tile column. Ci must be a multiple of 16 (a
// 16-byte chunk never straddles two taps): the wrapper zero-pads the
// channels of the space-to-depth stem (Ci = 12) and of ViT's patch
// embedding (Ci = 3), which adds nothing to the sums; count uses the real
// Ci (c_valid).
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace qtt;

namespace {

constexpr int kInvalidRow = -(1 << 30);
constexpr int MAX_GRID_Y = 65535;

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__device__ __forceinline__ void store1(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int valid_taps(int i0, int k, int size) {
  // number of kk in [0, k) with 0 <= i0 + kk < size
  const int lo = i0 < 0 ? -i0 : 0;
  const int hi = size - i0 < k ? size - i0 : k;
  return hi > lo ? hi - lo : 0;
}

// One output in quant_conv2d's order (every step rounded as the plain
// version rounds it).
__device__ __forceinline__ float conv_value(int acc, float corr, float z, float a_scale, float ws,
                                            bool wz0, float wz, int rowsum, float count,
                                            const float* bias, float b) {
  float corrected = __fadd_rn((float)acc, __fmul_rn(z, corr));
  if (!wz0)
    corrected = __fadd_rn(__fadd_rn(corrected, __fmul_rn(wz, (float)rowsum)),
                          __fmul_rn(__fmul_rn(z, wz), count));
  const float v = __fmul_rn(__fmul_rn(a_scale, ws), corrected);
  return bias != nullptr ? __fadd_rn(v, b) : v;
}

constexpr int BM = 128;         // rows per block (two consumer warpgroups)
constexpr int BK = 128;         // K bytes per stage: one 128-byte swizzled row
constexpr int STAGES = 4;       // ring depth
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int PRODUCERS = 128;  // warpgroup 2: the gather and the weight's TMA
constexpr int NTHREADS = CONSUMERS + PRODUCERS;
constexpr int A_BYTES = BM * BK;                     // one A stage, 16 KB
constexpr int PROWS = BM * (BK / 16) / PRODUCERS;    // rows a producer thread gathers
static_assert(PROWS == 8, "a producer thread takes one chunk column of 8 rows, 16 apart");

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK;         // one weight stage: BN rows of 128 bytes
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1,024
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LDO = BN * 4 + 16;  // row stride of the staged int32 tile
  static constexpr int STAGED = BM * LDO;
  static constexpr int BODY = RING > STAGED ? RING : STAGED;
  // the ring (then the staged tile), full and empty barriers, s_w / bias /
  // z_w of the tile's columns, the row sums, alignment slack
  static constexpr size_t SMEM = BODY + 2 * STAGES * 8 + 3 * BN * 4 + BM * 4 + 1024;
};

// four outputs of one row, 16 (f32) or 8 (bf16) bytes
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <typename TOut, int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    qconv2d_wgmma_kernel(const int8_t* __restrict__ x, const float* __restrict__ corr_a,
                         const float* __restrict__ w_scale, const float* __restrict__ w_zero,
                         const float* __restrict__ bias, const float* __restrict__ a_scale_p,
                         const float* __restrict__ z_eff_p, TOut* __restrict__ out, int H, int W,
                         int C, int OH, int OW, int Co, int KH, int KW, int sh, int sw, int pt,
                         int pl, int c_valid, int M, bool wz0, bool vec_out,
                         const __grid_constant__ CUtensorMap w_map) {
  using TT = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the ring first, on a 1,024-byte boundary (the 128-byte swizzle's atom)
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TT::BODY);  // a stage's A and W landed
  uint64_t* empty = full + STAGES;                              // its wgmmas are retired
  float* col_s = reinterpret_cast<float*>(empty + STAGES);
  float* col_b = col_s + BN;
  float* col_z = col_b + BN;
  int* rs = reinterpret_cast<int*>(col_z + BN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (KH * KW * C + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);     // the producers' gathers and the weight's TMA
      mbar_init(&empty[i], CONSUMERS / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += NTHREADS) {
    const int co = n0 + i;
    const bool in = co < Co;
    col_s[i] = in ? w_scale[co] : 0.0f;
    col_b[i] = in && bias != nullptr ? bias[co] : 0.0f;
    col_z[i] = in ? w_zero[co] : 0.0f;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warpgroup: thread lt gathers 16-byte chunk c of rows
    // rb, rb + 16, ..., rb + 112 of each stage
    const int lt = tid - CONSUMERS;
    const int c = lt & 7, rb = lt >> 3;
    int64_t rbase[PROWS];
    int ih0[PROWS], iw0[PROWS];
#pragma unroll
    for (int i = 0; i < PROWS; ++i) {
      const int m = m0 + rb + 16 * i;
      rbase[i] = 0;
      ih0[i] = kInvalidRow;
      iw0[i] = 0;
      if (m < M) {
        const int img = m / (OH * OW);
        const int rem = m - img * (OH * OW);
        const int oh = rem / OW;
        rbase[i] = (int64_t)img * H * W * C;
        ih0[i] = oh * sh - pt;
        iw0[i] = (rem - oh * OW) * sw - pl;
      }
    }
    // the chunk's (kh, kw, ci) at k = 16c, then advanced by BK a stage
    const int tap = 16 * c / C;
    int ci = 16 * c - tap * C;
    int kh = tap / KW;
    int kw = tap - kh * KW;
    const int swz = (c ^ (rb & 7)) * 16;  // 128-byte swizzle: rows rb + 16i share rb & 7
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % STAGES;
      mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
      uint8_t* as = sm + st * TT::STAGE;
      if (lt == 0) {
        mbar_arrive_expect_tx(&full[st], TT::B_BYTES);
        tma_load_2d(as + A_BYTES, &w_map, kt * BK, n0, &full[st]);
      }
#pragma unroll
      for (int i = 0; i < PROWS; ++i) {
        const int ih = ih0[i] + kh, iw = iw0[i] + kw;
        const bool ok = kh < KH && ih >= 0 && ih < H && iw >= 0 && iw < W;
        const int8_t* src = ok ? x + rbase[i] + ((int64_t)ih * W + iw) * C + ci : x;
        cp_async16(as + (rb + 16 * i) * 128 + swz, src, ok ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (kt > 0) {
        // the previous stage's gathers are in: visible to the tensor cores'
        // (async proxy) reads, then handed over
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[(kt - 1) % STAGES]);
      }
      ci += BK;
      while (ci >= C) {
        ci -= C;
        if (++kw == KW) {
          kw = 0;
          ++kh;
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&full[(nk - 1) % STAGES]);
    return;
  }

  // the consumer warpgroups: rows 64 * wg .. + 63 of the tile
  const int wg = tid >> 7, wl = tid & 127;
  const int rrow = wg * 64 + (wl >> 1);  // the A row whose half this thread sums (z_w != 0)
  int acc[BN / 2];  // written only by the wgmmas (the first one clears them)
  int rsum = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint8_t* as = sm + st * TT::STAGE;
    if (!wz0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = (wl & 1) * 4 + q;
        const int4 v = *reinterpret_cast<const int4*>(as + rrow * 128 + ((j ^ (rrow & 7)) * 16));
        rsum = __dp4a(v.x, 0x01010101, rsum);
        rsum = __dp4a(v.y, 0x01010101, rsum);
        rsum = __dp4a(v.z, 0x01010101, rsum);
        rsum = __dp4a(v.w, 0x01010101, rsum);
      }
    }
    const uint64_t da = sw128_desc(as + wg * 64 * 128), db = sw128_desc(as + A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, (kt > 0 || kk > 0) ? 1 : 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if ((tid & 31) == 0) mbar_arrive(&empty[st]);
  }
  fence_acc(acc);

  // epilogue: every consumer is past the ring, which now holds the int32
  // tile (acc[4j + r] is row 16 * warp + g (+ 8 for r >= 2), column
  // 8j + 2t (+ 1 for odd r) of the warpgroup's 64 rows)
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r_lo = wg * 64 + (wl >> 5) * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<int2*>(sm + r_lo * TT::LDO + col * 4) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(sm + (r_lo + 8) * TT::LDO + col * 4) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (!wz0) {
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      if ((wl & 1) == 0) rs[rrow] = rsum;
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
  const float a_scale = *a_scale_p, z = *z_eff_p;
  constexpr int CPR = BN / 4;  // four-column pieces per row
  for (int i = wl; i < 64 * CPR; i += 128) {
    const int row = wg * 64 + i / CPR, cl = (i % CPR) * 4;
    const int m = m0 + row, co = n0 + cl;
    if (m >= M || co >= Co) continue;
    const int4 a4 = *reinterpret_cast<const int4*>(sm + row * TT::LDO + cl * 4);
    const int av[4] = {a4.x, a4.y, a4.z, a4.w};
    const int pix = m % (OH * OW);  // oh * OW + ow
    float count = 0.0f;
    int rsv = 0;
    if (!wz0) {
      const int oh = pix / OW;
      const int ow = pix - oh * OW;
      count = (float)(valid_taps(oh * sh - pt, KH, H) * valid_taps(ow * sw - pl, KW, W) *
                      c_valid);
      rsv = rs[row];
    }
    const float* cp = corr_a + (int64_t)pix * Co + co;
    TOut* o = out + (int64_t)m * Co + co;
    if (vec_out && co + 4 <= Co) {
      const float4 c4 = *reinterpret_cast<const float4*>(cp);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = conv_value(av[e], cv[e], z, a_scale, col_s[cl + e], wz0, col_z[cl + e], rsv, count,
                          bias, col_b[cl + e]);
      store4(o, v);
    } else {
      for (int e = 0; e < 4 && co + e < Co; ++e)
        store1(o, e, conv_value(av[e], cp[e], z, a_scale, col_s[cl + e], wz0, col_z[cl + e], rsv,
                                 count, bias, col_b[cl + e]));
    }
  }
}

// The TMA map of the K-major weight (Co rows of K bytes): boxes of BK
// bytes x BN rows in the 128-byte swizzle, zeros past K and Co
template <int BN>
bool weight_map(CUtensorMap* map, const void* w_km, int K, int Co) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)Co};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w_km), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename TOut, int BN>
int launch_wgmma(const void* x, const void* w_km, const void* corr_a, const void* w_scale,
                 const void* w_zero, const void* bias, const void* a_scale, const void* z_eff,
                 void* out, int H, int W, int C, int OH, int OW, int Co, int KH, int KW, int sh,
                 int sw, int pt, int pl, int c_valid, int M, bool wz0, cudaStream_t stream) {
  CUtensorMap w_map = {};
  if (!weight_map<BN>(&w_map, w_km, KH * KW * C, Co)) return (int)cudaErrorNotSupported;
  const bool vec_out = Co % 4 == 0 && aligned16(out) && aligned16(corr_a);
  const size_t smem = Tile<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(qconv2d_wgmma_kernel<TOut, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Co + BN - 1) / BN, (M + BM - 1) / BM);
  qconv2d_wgmma_kernel<TOut, BN><<<grid, NTHREADS, smem, stream>>>(
      (const int8_t*)x, (const float*)corr_a, (const float*)w_scale, (const float*)w_zero,
      (const float*)bias, (const float*)a_scale, (const float*)z_eff, (TOut*)out, H, W, C, OH, OW,
      Co, KH, KW, sh, sw, pt, pl, c_valid, M, wz0, vec_out, w_map);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_wgmma(const void* x, const void* w_km, const void* corr_a, const void* w_scale,
                 const void* w_zero, const void* bias, const void* a_scale, const void* z_eff,
                 void* out, int H, int W, int C, int OH, int OW, int Co, int KH, int KW, int sh,
                 int sw, int pt, int pl, int c_valid, int M, bool wz0, cudaStream_t stream) {
  if (Co >= 256)
    return launch_wgmma<TOut, 256>(x, w_km, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out,
                                   H, W, C, OH, OW, Co, KH, KW, sh, sw, pt, pl, c_valid, M, wz0, stream);
  if (Co > 64)
    return launch_wgmma<TOut, 128>(x, w_km, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out,
                                   H, W, C, OH, OW, Co, KH, KW, sh, sw, pt, pl, c_valid, M, wz0, stream);
  return launch_wgmma<TOut, 64>(x, w_km, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, H,
                                W, C, OH, OW, Co, KH, KW, sh, sw, pt, pl, c_valid, M, wz0, stream);
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. w_km is the K-major (Co, KH*KW*C)
// weight; C a multiple of 16 (c_valid <= C the channels that count for the
// z_w terms); x and w_km 16-byte aligned.
extern "C" int qtt_qconv2d(const void* x, const void* w_km, const void* corr_a,
                           const void* w_scale, const void* w_zero, const void* bias,
                           const void* a_scale, const void* z_eff, void* out, int N, int H, int W,
                           int C, int OH, int OW, int Co, int KH, int KW, int sh, int sw, int pt,
                           int pl, int c_valid, int w_zero_is_zero, int out_dtype, void* stream) {
  const long long M = (long long)N * OH * OW;
  if ((M + BM - 1) / BM > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  if (C % 16 != 0 || c_valid < 1 || c_valid > C || !aligned16(x) || !aligned16(w_km) ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wz0 = w_zero_is_zero != 0;
  if (out_dtype == 0)
    return launch_wgmma<float>(x, w_km, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, H, W,
                               C, OH, OW, Co, KH, KW, sh, sw, pt, pl, c_valid, (int)M, wz0, s);
  return launch_wgmma<__nv_bfloat16>(x, w_km, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out,
                                     H, W, C, OH, OW, Co, KH, KW, sh, sw, pt, pl, c_valid, (int)M,
                                     wz0, s);
}
