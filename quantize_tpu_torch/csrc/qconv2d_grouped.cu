// K3g: grouped W8A8 convolution over NHWC int8 activations (N, H, W, C) and
// an HWIO int8 kernel (KH, KW, C/G, Co) in G groups: int32 sums over each
// group's own C/G input channels, zero (int8 0) at padding, then the W8A8
// epilogue in the order of the plain version:
//   acc + z_a * corr_a[oh, ow, co]                 (border-exact z_a term)
//       + z_w[co] * rowsum + z_a * z_w[co] * count  (only when z_w != 0)
//   out = s_a * s_w[co] * that + bias[co], cast to the carry dtype,
// where rowsum sums the patch's int8 values over the group's channels and
// count is the number of valid taps times C/G.
//
// Replaces the XLA op behind quantize_tpu/ops/qconv.py:quant_conv2d with
// groups > 1 (conv_general_dilated(int8, int8) -> int32 with
// feature_group_count, and the per-group row sums of :107-119); stock
// PyTorch has no CUDA int8 convolution.
//
// Two routes, chosen by the wrapper from the shape before launch
// (quantize_tpu_torch/ops/qconv.py: _grouped_route) and counted there.
//
// The wgmma route (namespace wgg): Ci/G == Co/G in {4, 8, 16, 32,
// 64}, C a multiple of 64, x and the weight copy 16-byte aligned: every
// grouped conv of the model zoo's ResNeXts. At ResNeXt-50 batch 256 a
// launch does the same 3.7 G int8 products at every stage (M * Co * Ci/G
// is constant), about 0.06 ms on the CUDA cores and as much as the launch's
// byte bound at the later stages, so the sums go to the tensor cores even
// though that multiplies zeros. A slice is a run of NS = 32 input channels
// (32 / (Ci/G) whole groups) or, at Ci/G = 64, one group of 64, and its own
// NS output channels; against a block-diagonal NS x NS weight a tap, the
// grouped conv of a slice is a dense conv over that run of channels, with
// at most Ci/G-fold zeros (8x at Ci/G 4, none at 32 and 64). No image byte
// is fetched for two slices. A block computes 128 output pixels by 64
// output channels (64 / NS slices) as K3 computes its tiles
// (csrc/qconv2d.cu): a producer warpgroup gathers the patch rows by 16-byte
// cp.async (src-size 0 at padding, per-row bases computed once a tile; the
// channel stride is C and the channel base the slice's, so a (pixel, tap)
// run of a 32-channel slice is two 16-byte pieces) into the 128-byte
// swizzle, 128 K bytes a stage (four taps of a 32-channel slice, two of a
// 64-channel one; a slice's K = taps * NS is zero-padded to the next 128),
// and its thread 0 loads the slice's NS weight rows by TMA from the
// block-diagonal K-major copy ((Co, taps * NS) int8, ops/qconv.py:
// blockdiag_weight), zero past K. A 4-stage mbarrier ring hands the stages
// to two consumer warpgroups of 64 rows that issue wgmma m64nNSk32 into one
// accumulator set a slice. Where z_w != 0 they also sum their A rows by
// __dp4a into 8 bins of NS / 8 channels a slice (a group is 1-8 whole bins,
// so each group's row sum is a sum of bins). The epilogue stages the int32
// tile in the ring so that each output row leaves in 16-byte stores, with
// corr_a read in 16-byte pieces. 384 threads, ~90-103 KB of shared memory:
// two blocks an SM. What bounds it on an H100 (scripts/ablate_grouped.py,
// PERF.md): not the products (~0.03 ms a launch at the int8 peak at Ci/G
// 4) but the nine im2col reads of the image through L2 (32-byte sectors at
// scattered addresses; a third of a launch at ResNeXt-50's widths) and the
// fixed cost of short blocks (one tile, 3-5 stages a slice): with no memory
// traffic at all a launch keeps 58-60% of its time. A persistent grid with
// the epilogue from registers, a deeper ring, cheaper gather addresses,
// corr_a rebuilt in-kernel from per-tap column sums, and a warpgroup of its
// own for the epilogue were each timed on the card, and each was slower
// than this design.
//
// The dp4a route (every other shape: group widths 1-3, Co/G !=
// Ci/G, more than 64 output channels a group, C not a multiple of 64)
// sums on the CUDA cores with __dp4a (four int8 products a 4-byte word). A
// block of 256 threads covers bp output pixels (64 where shared memory
// allows) and up to 64 output channels: whole groups where a group has at
// most 64, else 64 channels of one group. It stages the block's weights,
// from a copy made once at pack time ((G, taps, C/G / 4, Co/G) words,
// quantize_tpu_torch/ops/qconv.py: grouped_weight), and its im2col patch
// rows, every tap of every pixel over the block's groups' channels, in
// shared memory as 4-byte words (16-byte loads where C/G is a multiple of
// 16; a group width that is not a multiple of 4 is zero-padded there), with
// pixels innermost so that a thread reads four pixels' words in one 16-byte
// load. A thread then sums 4 pixels x CR channels (CR = 4, 2 or 1, a
// divisor of Co/G) with 16-byte loads of both operands, and the row sums
// (z_w != 0) by a dp4a against ones on the words it already holds. Its
// staging of one 4-byte word at a time at Ci/G 4-8 and dp4a's rate bound
// it (PERF.md). Shapes whose smallest tile (4 pixels) needs more shared
// memory than a block has are refused; the wrapper mirrors that
// (ops/qconv.py: _grouped_tile).
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace qtt;

namespace {

constexpr int NTHREADS = 256;
constexpr int CHANNELS = 64;  // output channels a block at most
constexpr int SMEM_MAX = 232448;
constexpr int MAX_GRID_Y = 65535;
constexpr int kInvalidRow = -(1 << 30);

inline bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// four outputs of one pixel, 16 (f32) or 8 (bf16) bytes
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// CR words of the weight tile (CR output channels of one input word)
template <int CR>
__device__ __forceinline__ void load_w(const int* p, int (&w)[CR]) {
  if constexpr (CR == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (CR == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

struct Shape {
  int H, W, C, OH, OW, Co, KH, KW, sh, sw, pt, pl, G, cig, cog, gb, cb, bp, M;
};

// shared memory of one block: patch rows, weights (channels padded to 4),
// per-pixel image bases and origins, s_w / bias / z_w of the channels
inline size_t smem_bytes(int taps, int cw, int gb, int cb, int bp) {
  const int cbp = (cb + 3) / 4 * 4;
  return (size_t)4 * taps * gb * cw * bp + (size_t)4 * taps * cw * cbp + (size_t)16 * bp +
         (size_t)12 * cb;
}

// LOAD: bytes a patch load takes from the image (16 where C/G % 16 == 0, 4
// where C/G % 4 == 0, else 1: bytes packed into words, zero-padded)
template <typename TOut, int CR, int LOAD>
__global__ void __launch_bounds__(NTHREADS)
    qconv2d_grouped_kernel(const int8_t* __restrict__ x, const int* __restrict__ w_g,
                           const float* __restrict__ corr_a, const float* __restrict__ w_scale,
                           const float* __restrict__ w_zero, const float* __restrict__ bias,
                           const float* __restrict__ a_scale_p, const float* __restrict__ z_eff_p,
                           TOut* __restrict__ out, const Shape s, bool wz0, bool vec_out) {
  extern __shared__ __align__(16) int smem[];
  const int taps = s.KH * s.KW;
  const int cw = (s.cig + 3) / 4;  // words of a group's channels
  const int cbp = (s.cb + 3) / 4 * 4;
  const int bp = s.bp;
  int* sx = smem;                          // [tap][gl][w][p]
  int* swt = sx + taps * s.gb * cw * bp;   // [tap][w][c]
  long long* pix_base = reinterpret_cast<long long*>(swt + taps * cw * cbp);
  int* pix_ih = reinterpret_cast<int*>(pix_base + bp);
  int* pix_iw = pix_ih + bp;
  float* col_s = reinterpret_cast<float*>(pix_iw + bp);
  float* col_b = col_s + s.cb;
  float* col_z = col_b + s.cb;

  // the block's output pixels m0 .. m0 + bp - 1 and channels co0 .. co0 + nch - 1
  const int m0 = blockIdx.x * bp;
  int g0, j0, nch, ngr;
  if (s.cog <= CHANNELS) {
    g0 = blockIdx.y * s.gb;
    j0 = 0;
    ngr = min(s.gb, s.G - g0);
    nch = ngr * s.cog;
  } else {
    const int nsub = (s.cog + CHANNELS - 1) / CHANNELS;
    g0 = blockIdx.y / nsub;
    j0 = (blockIdx.y - g0 * nsub) * CHANNELS;
    ngr = 1;
    nch = min(CHANNELS, s.cog - j0);
  }
  const int co0 = g0 * s.cog + j0;
  const int tid = threadIdx.x;

  for (int p = tid; p < bp; p += NTHREADS) {
    const int m = m0 + p;
    pix_base[p] = 0;
    pix_ih[p] = kInvalidRow;
    pix_iw[p] = 0;
    if (m < s.M) {
      const int img = m / (s.OH * s.OW);
      const int rem = m - img * (s.OH * s.OW);
      const int oh = rem / s.OW;
      pix_base[p] = (long long)img * s.H * s.W * s.C;
      pix_ih[p] = oh * s.sh - s.pt;
      pix_iw[p] = (rem - oh * s.OW) * s.sw - s.pl;
    }
  }
  for (int c = tid; c < s.cb; c += NTHREADS) {
    const bool in = c < nch;
    col_s[c] = in ? w_scale[co0 + c] : 0.0f;
    col_b[c] = in && bias != nullptr ? bias[co0 + c] : 0.0f;
    col_z[c] = in ? w_zero[co0 + c] : 0.0f;
  }
  // the weights: word (tap, w) of channel c from the copy's (g, tap, w, j)
  for (int i = tid; i < taps * cw * cbp; i += NTHREADS) {
    const int c = i % cbp, tw = i / cbp;
    int v = 0;
    if (c < nch) {
      const int co = co0 + c;
      const int g = co / s.cog;
      v = w_g[((long long)g * taps * cw + tw) * s.cog + (co - g * s.cog)];
    }
    swt[i] = v;
  }
  __syncthreads();

  // the patch rows: pixels innermost, so that neighbouring threads store to
  // neighbouring banks. bp divides the block, so a thread keeps one pixel
  // and walks (tap, group, word) in steps of NTHREADS / bp
  constexpr int VW = LOAD == 16 ? 4 : 1;  // words a load
  const int nwc = cw / VW;
  {
    const int p = tid % bp, step = NTHREADS / bp;
    const long long base = pix_base[p];
    const int ih0 = pix_ih[p], iw0 = pix_iw[p];
    const int r = tid / bp;
    int wc = r % nwc, gl = (r / nwc) % s.gb, tap = r / nwc / s.gb;
    int kh = tap / s.KW, kw = tap - kh * s.KW;
    while (tap < taps) {
      const int ih = ih0 + kh, iw = iw0 + kw;
      const bool ok = gl < ngr && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      int* dst = sx + ((tap * s.gb + gl) * cw + wc * VW) * bp + p;
      const int8_t* src =
          x + base + ((long long)ih * s.W + iw) * s.C + (g0 + gl) * s.cig + wc * VW * 4;
      if constexpr (LOAD == 16) {
        const int4 v = ok ? __ldg(reinterpret_cast<const int4*>(src)) : make_int4(0, 0, 0, 0);
        dst[0] = v.x;
        dst[bp] = v.y;
        dst[2 * bp] = v.z;
        dst[3 * bp] = v.w;
      } else if constexpr (LOAD == 4) {
        dst[0] = ok ? __ldg(reinterpret_cast<const int*>(src)) : 0;
      } else {
        uint32_t v = 0;
        if (ok) {
          for (int b = 0; b < 4 && wc * 4 + b < s.cig; ++b)
            v |= (uint32_t)(uint8_t)src[b] << (8 * b);
        }
        dst[0] = (int)v;
      }
      wc += step;
      while (wc >= nwc) {
        wc -= nwc;
        if (++gl == s.gb) {
          gl = 0;
          ++tap;
          if (++kw == s.KW) {
            kw = 0;
            ++kh;
          }
        }
      }
    }
  }
  __syncthreads();

  // a thread sums 4 pixels x CR channels of one group
  const float a_scale = *a_scale_p, z = *z_eff_p;
  const int npq = bp / 4, nchunk = nch / CR;
  for (int item = tid; item < npq * nchunk; item += NTHREADS) {
    const int pq = item % npq, c0 = (item / npq) * CR;
    const int co = co0 + c0;
    const int gl = co / s.cog - g0;
    int acc[4][CR];
    int rs[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CR; ++j) acc[i][j] = 0;
    const int* xp = sx + gl * cw * bp + pq * 4;
    const int* wp = swt + c0;
    for (int tap = 0; tap < taps; ++tap) {
      for (int w = 0; w < cw; ++w) {
        const int4 xv = *reinterpret_cast<const int4*>(xp + ((tap * s.gb) * cw + w) * bp);
        int wv[CR];
        load_w<CR>(wp + (tap * cw + w) * cbp, wv);
        const int xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < CR; ++j) acc[i][j] = __dp4a(xs[i], wv[j], acc[i][j]);
          if (!wz0) rs[i] = __dp4a(xs[i], 0x01010101, rs[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pq * 4 + i;
      const int m = m0 + p;
      if (m >= s.M) continue;
      const int pix = m % (s.OH * s.OW);  // oh * OW + ow
      const float count =
          wz0 ? 0.0f
              : (float)(valid_taps(pix_ih[p], s.KH, s.H) * valid_taps(pix_iw[p], s.KW, s.W) * s.cig);
      const float* cp = corr_a + (long long)pix * s.Co + co;
      TOut* o = out + (long long)m * s.Co + co;
      float v[CR];
#pragma unroll
      for (int j = 0; j < CR; ++j)
        v[j] = conv_value(acc[i][j], cp[j], z, a_scale, col_s[c0 + j], wz0, col_z[c0 + j], rs[i],
                          count, bias, col_b[c0 + j]);
      if constexpr (CR == 4) {
        if (vec_out) {
          store4(o, v);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < CR; ++j) store1(o + j, v[j]);
    }
  }
}

template <typename TOut, int CR, int LOAD>
int launch(const void* x, const void* w_g, const void* corr_a, const void* w_scale,
           const void* w_zero, const void* bias, const void* a_scale, const void* z_eff, void* out,
           const Shape& s, bool wz0, size_t smem, dim3 grid, cudaStream_t stream) {
  auto kernel = qconv2d_grouped_kernel<TOut, CR, LOAD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_out = CR == 4 && aligned(out, 16);
  kernel<<<grid, NTHREADS, smem, stream>>>((const int8_t*)x, (const int*)w_g, (const float*)corr_a,
                                          (const float*)w_scale, (const float*)w_zero,
                                          (const float*)bias, (const float*)a_scale,
                                          (const float*)z_eff, (TOut*)out, s, wz0, vec_out);
  return (int)cudaGetLastError();
}

template <typename TOut, int CR>
int launch_cr(int load, const void* x, const void* w_g, const void* corr_a, const void* w_scale,
              const void* w_zero, const void* bias, const void* a_scale, const void* z_eff,
              void* out, const Shape& s, bool wz0, size_t smem, dim3 grid, cudaStream_t stream) {
  if (load == 16)
    return launch<TOut, CR, 16>(x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, s, wz0,
                                smem, grid, stream);
  if (load == 4)
    return launch<TOut, CR, 4>(x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, s, wz0,
                               smem, grid, stream);
  return launch<TOut, CR, 1>(x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, s, wz0,
                             smem, grid, stream);
}

template <typename TOut>
int launch_out(int cr, int load, const void* x, const void* w_g, const void* corr_a,
               const void* w_scale, const void* w_zero, const void* bias, const void* a_scale,
               const void* z_eff, void* out, const Shape& s, bool wz0, size_t smem, dim3 grid,
               cudaStream_t stream) {
  if (cr == 4)
    return launch_cr<TOut, 4>(load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, s,
                              wz0, smem, grid, stream);
  if (cr == 2)
    return launch_cr<TOut, 2>(load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, s,
                              wz0, smem, grid, stream);
  return launch_cr<TOut, 1>(load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, s,
                            wz0, smem, grid, stream);
}

// -- the wgmma route ------------------------------------------------------------

namespace wgg {

constexpr int BM = 128;         // output pixels a block (two consumer warpgroups of 64)
constexpr int BN = 64;          // output channels a block: BN / NS slices
constexpr int BK = 128;         // K bytes a stage: one 128-byte swizzled row
constexpr int STAGES = 4;       // ring depth
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int PRODUCERS = 128;  // warpgroup 2: the gather and the weight's TMA
constexpr int NTHREADS = CONSUMERS + PRODUCERS;
constexpr int A_BYTES = BM * BK;                   // one A stage, 16 KB
constexpr int PROWS = BM * (BK / 16) / PRODUCERS;  // rows a producer thread gathers
constexpr int BINS = 8;  // z_w row-sum bins of a slice's row, NS / 8 channels each
static_assert(PROWS == 8, "a producer thread takes one chunk column of 8 rows, 16 apart");

template <int NS>
struct Tile {
  static constexpr int SPB = BN / NS;              // slices a block
  static constexpr int B_BYTES = NS * BK;          // one weight stage: the slice's NS rows
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1,024
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LDO = BN * 4 + 16;  // row stride of the staged int32 tile
  static constexpr int STAGED = BM * LDO;
  static constexpr int BODY = RING > STAGED ? RING : STAGED;
  // the ring (then the staged tile), full and empty barriers, s_w / bias /
  // z_w of the block's channels, the row-sum bins, alignment slack
  static constexpr size_t SMEM =
      BODY + 2 * STAGES * 8 + 3 * BN * 4 + (size_t)BM * SPB * BINS * 4 + 1024;
};

template <typename TOut, int NS>
__global__ void __launch_bounds__(NTHREADS, 2)
    grouped_wgmma_kernel(const int8_t* __restrict__ x, const float* __restrict__ corr_a,
                         const float* __restrict__ w_scale, const float* __restrict__ w_zero,
                         const float* __restrict__ bias, const float* __restrict__ a_scale_p,
                         const float* __restrict__ z_eff_p, TOut* __restrict__ out, int H, int W,
                         int C, int OH, int OW, int KH, int KW, int sh, int sw, int pt, int pl,
                         int cig, int M, bool wz0, bool vec_out,
                         const __grid_constant__ CUtensorMap w_map) {
  using TT = Tile<NS>;
  constexpr int SPB = TT::SPB;
  extern __shared__ uint8_t smem_raw[];
  // the ring first, on a 1,024-byte boundary (the 128-byte swizzle's atom)
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TT::BODY);  // a stage's A and W landed
  uint64_t* empty = full + STAGES;                              // its wgmmas are retired
  float* col_s = reinterpret_cast<float*>(empty + STAGES);
  float* col_b = col_s + BN;
  float* col_z = col_b + BN;
  int* rs = reinterpret_cast<int*>(col_z + BN);  // [row][slice][bin]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int taps = KH * KW;
  const int nks = (taps * NS + BK - 1) / BK;  // stages a slice
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);    // the producers' gathers and the weight's TMA
      mbar_init(&empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += NTHREADS) {
    col_s[i] = w_scale[n0 + i];
    col_b[i] = bias != nullptr ? bias[n0 + i] : 0.0f;
    col_z[i] = w_zero[n0 + i];
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
        rbase[i] = (int64_t)img * H * W * C + n0;  // the block's first input channel
        ih0[i] = oh * sh - pt;
        iw0[i] = (rem - oh * OW) * sw - pl;
      }
    }
    const int swz = (c ^ (rb & 7)) * 16;  // 128-byte swizzle: rows rb + 16i share rb & 7
    for (int kt = 0; kt < SPB * nks; ++kt) {
      const int st = kt % STAGES;
      const int s = kt / nks, kk = kt - s * nks;  // slice s of the block, its stage kk
      mbar_wait_bounded(&empty[st], ((kt / STAGES) & 1) ^ 1);
      uint8_t* as = sm + st * TT::STAGE;
      if (lt == 0) {
        mbar_arrive_expect_tx(&full[st], TT::B_BYTES);
        tma_load_2d(as + A_BYTES, &w_map, kk * BK, n0 + s * NS, &full[st]);
      }
      // the chunk's (tap, channel) at k = kk * BK + 16c of the slice's K
      const int k = kk * BK + 16 * c;
      const int tap = k / NS;
      const int ci = s * NS + (k - tap * NS);
      const int kh = tap / KW;
      const int kw = tap - kh * KW;
#pragma unroll
      for (int i = 0; i < PROWS; ++i) {
        const int ih = ih0[i] + kh, iw = iw0[i] + kw;
        const bool ok = tap < taps && ih >= 0 && ih < H && iw >= 0 && iw < W;
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
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&full[(SPB * nks - 1) % STAGES]);
    return;
  }

  // the consumer warpgroups: rows 64 * wg .. + 63 of the tile, one
  // accumulator set a slice
  const int wg = tid >> 7, wl = tid & 127;
  const int rrow = wg * 64 + (wl >> 1);  // the A row whose half this thread sums (z_w != 0)
  const int half = wl & 1;
  int acc[SPB][NS / 2];  // written only by the wgmmas (the first of a slice clears them)
  int kt = 0;
#pragma unroll
  for (int s = 0; s < SPB; ++s) {
    int bins[BINS];
#pragma unroll
    for (int b = 0; b < BINS; ++b) bins[b] = 0;
    for (int kk = 0; kk < nks; ++kk, ++kt) {
      const int st = kt % STAGES;
      mbar_wait_bounded(&full[st], (kt / STAGES) & 1);
      const uint8_t* as = sm + st * TT::STAGE;
      if (!wz0) {
        // chunk j = 4 * half + q of the row holds channels c0 .. c0 + 15 of
        // one tap of the slice: BK and 4 * 16 are multiples of NS, so c0
        // depends on q alone, and so does each word's bin
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = half * 4 + q;
          const int c0 = 16 * (q % (NS / 16));
          const int4 v = *reinterpret_cast<const int4*>(as + rrow * 128 + ((j ^ (rrow & 7)) * 16));
          bins[c0 / (NS / 8)] = __dp4a(v.x, 0x01010101, bins[c0 / (NS / 8)]);
          bins[(c0 + 4) / (NS / 8)] = __dp4a(v.y, 0x01010101, bins[(c0 + 4) / (NS / 8)]);
          bins[(c0 + 8) / (NS / 8)] = __dp4a(v.z, 0x01010101, bins[(c0 + 8) / (NS / 8)]);
          bins[(c0 + 12) / (NS / 8)] = __dp4a(v.w, 0x01010101, bins[(c0 + 12) / (NS / 8)]);
        }
      }
      const uint64_t da = sw128_desc(as + wg * 64 * 128), db = sw128_desc(as + A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kq = 0; kq < BK / 32; ++kq)
        Wgmma<NS>::mma(acc[s], da + 2 * kq, db + 2 * kq, (kk > 0 || kq > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if ((tid & 31) == 0) mbar_arrive(&empty[st]);
    }
    if (!wz0) {
      // the row's two halves, then its bins for the epilogue
#pragma unroll
      for (int b = 0; b < BINS; ++b) bins[b] += __shfl_xor_sync(0xffffffffu, bins[b], 1);
      if (half == 0) {
#pragma unroll
        for (int b = 0; b < BINS; ++b) rs[(rrow * SPB + s) * BINS + b] = bins[b];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SPB; ++s) fence_acc(acc[s]);

  // epilogue: every consumer is past the ring, which now holds the int32
  // tile (acc[s][4j + r] is row 16 * warp + g (+ 8 for r >= 2), column
  // s * NS + 8j + 2t (+ 1 for odd r) of the warpgroup's 64 rows)
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r_lo = wg * 64 + (wl >> 5) * 16 + g;
#pragma unroll
    for (int s = 0; s < SPB; ++s) {
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int col = s * NS + 8 * j + 2 * t;
        *reinterpret_cast<int2*>(sm + r_lo * TT::LDO + col * 4) =
            make_int2(acc[s][4 * j], acc[s][4 * j + 1]);
        *reinterpret_cast<int2*>(sm + (r_lo + 8) * TT::LDO + col * 4) =
            make_int2(acc[s][4 * j + 2], acc[s][4 * j + 3]);
      }
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128) : "memory");
  const float a_scale = *a_scale_p, z = *z_eff_p;
  const int gbins = cig / (NS / 8);  // bins a group: 1, 2, 4 or 8
  constexpr int CPR = BN / 4;        // four-column pieces per row, each within one group
  for (int i = wl; i < 64 * CPR; i += 128) {
    const int row = wg * 64 + i / CPR, cl = (i % CPR) * 4;
    const int m = m0 + row, co = n0 + cl;
    if (m >= M) continue;
    const int4 a4 = *reinterpret_cast<const int4*>(sm + row * TT::LDO + cl * 4);
    const int av[4] = {a4.x, a4.y, a4.z, a4.w};
    const int pix = m % (OH * OW);  // oh * OW + ow
    float count = 0.0f;
    int rsv = 0;
    if (!wz0) {
      const int oh = pix / OW;
      const int ow = pix - oh * OW;
      count = (float)(valid_taps(oh * sh - pt, KH, H) * valid_taps(ow * sw - pl, KW, W) * cig);
      const int s = cl / NS;
      const int* rp = rs + (row * SPB + s) * BINS + ((cl - s * NS) / cig) * gbins;
      for (int b = 0; b < gbins; ++b) rsv += rp[b];
    }
    const float* cp = corr_a + (int64_t)pix * C + co;
    TOut* o = out + (int64_t)m * C + co;
    if (vec_out) {
      const float4 c4 = *reinterpret_cast<const float4*>(cp);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = conv_value(av[e], cv[e], z, a_scale, col_s[cl + e], wz0, col_z[cl + e], rsv, count,
                          bias, col_b[cl + e]);
      store4(o, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(o + e, conv_value(av[e], cp[e], z, a_scale, col_s[cl + e], wz0, col_z[cl + e], rsv,
                                 count, bias, col_b[cl + e]));
    }
  }
}

// The TMA map of the block-diagonal K-major weight (C rows of K = taps * NS
// bytes): boxes of BK bytes x NS rows in the 128-byte swizzle, zeros past K
template <int NS>
bool weight_map(CUtensorMap* map, const void* w_bd, int K, int C) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)C};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)NS};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w_bd), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename TOut, int NS>
int launch(const void* x, const void* w_bd, const void* corr_a, const void* w_scale,
           const void* w_zero, const void* bias, const void* a_scale, const void* z_eff, void* out,
           int H, int W, int C, int OH, int OW, int KH, int KW, int sh, int sw, int pt, int pl,
           int cig, int M, bool wz0, cudaStream_t stream) {
  CUtensorMap w_map = {};
  if (!weight_map<NS>(&w_map, w_bd, KH * KW * NS, C)) return (int)cudaErrorNotSupported;
  const bool vec_out = aligned(out, 16) && aligned(corr_a, 16);
  const size_t smem = Tile<NS>::SMEM;
  static_assert(2 * (Tile<NS>::SMEM + 1024) <= 233472, "two blocks an SM");
  auto kernel = grouped_wgmma_kernel<TOut, NS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((long long)M + BM - 1) / BM), (unsigned)(C / BN));
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const int8_t*)x, (const float*)corr_a, (const float*)w_scale, (const float*)w_zero,
      (const float*)bias, (const float*)a_scale, (const float*)z_eff, (TOut*)out, H, W, C, OH, OW,
      KH, KW, sh, sw, pt, pl, cig, M, wz0, vec_out, w_map);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_ns(const void* x, const void* w_bd, const void* corr_a, const void* w_scale,
              const void* w_zero, const void* bias, const void* a_scale, const void* z_eff,
              void* out, int H, int W, int C, int OH, int OW, int KH, int KW, int sh, int sw,
              int pt, int pl, int cig, int M, bool wz0, cudaStream_t stream) {
  if (cig <= 32)
    return launch<TOut, 32>(x, w_bd, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, H, W, C,
                            OH, OW, KH, KW, sh, sw, pt, pl, cig, M, wz0, stream);
  return launch<TOut, 64>(x, w_bd, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, H, W, C, OH,
                          OW, KH, KW, sh, sw, pt, pl, cig, M, wz0, stream);
}

}  // namespace wgg

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. wgmma: 1 for the tensor-core route,
// whose w_g is the block-diagonal K-major (Co, KH*KW*NS) copy (NS = 32, or
// 64 at C/G = 64; ops/qconv.py: blockdiag_weight) and which takes C/G ==
// Co/G in {4, 8, 16, 32, 64}, Co == C a multiple of 64, a slice's K below
// 2^17, x and w_g 16-byte aligned (gb and bp unused); 0 for the dp4a route, whose
// w_g is the (G, KH*KW, ceil(C/G / 4), Co/G) word copy and gb the groups a
// block stages and bp its output pixels, as ops/qconv.py: _grouped_tile
// chooses them (checked here).
extern "C" int qtt_qconv2d_grouped(const void* x, const void* w_g, const void* corr_a,
                                   const void* w_scale, const void* w_zero, const void* bias,
                                   const void* a_scale, const void* z_eff, void* out, int N, int H,
                                   int W, int C, int OH, int OW, int Co, int KH, int KW, int sh,
                                   int sw, int pt, int pl, int G, int gb, int bp,
                                   int w_zero_is_zero, int out_dtype, int wgmma, void* stream) {
  if (G < 1 || C % G != 0 || Co % G != 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wz0 = w_zero_is_zero != 0;
  if (wgmma) {
    const long long M = (long long)N * OH * OW;
    const int cig = C / G;
    const int ns = cig < 32 ? 32 : cig;  // a slice's channels
    if (Co != C || Co / G != cig || (cig != 4 && cig != 8 && cig != 16 && cig != 32 && cig != 64) ||
        C % wgg::BN != 0 || KH < 1 || KW < 1 || (long long)KH * KW * ns >= (1 << 17) ||
        !aligned(x, 16) || !aligned(w_g, 16) || M < 1 || M > 0x7fffffffLL - wgg::BM)
      return (int)cudaErrorInvalidValue;
    if (out_dtype == 0)
      return wgg::launch_ns<float>(x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out, H,
                                   W, C, OH, OW, KH, KW, sh, sw, pt, pl, cig, (int)M, wz0, st);
    return wgg::launch_ns<__nv_bfloat16>(x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff,
                                         out, H, W, C, OH, OW, KH, KW, sh, sw, pt, pl, cig,
                                         (int)M, wz0, st);
  }
  Shape s;
  s.H = H; s.W = W; s.C = C; s.OH = OH; s.OW = OW; s.Co = Co; s.KH = KH; s.KW = KW;
  s.sh = sh; s.sw = sw; s.pt = pt; s.pl = pl; s.G = G;
  s.cig = C / G;
  s.cog = Co / G;
  s.gb = gb;
  s.bp = bp;
  s.cb = s.cog <= CHANNELS ? gb * s.cog : CHANNELS;
  const long long M = (long long)N * OH * OW;
  const int want_gb = s.cog <= CHANNELS ? (G < CHANNELS / s.cog ? G : CHANNELS / s.cog) : 1;
  if (gb != want_gb || bp < 4 || bp % 4 != 0 || M < 1 || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  s.M = (int)M;
  const int cw = (s.cig + 3) / 4;
  const size_t smem = smem_bytes(KH * KW, cw, gb, s.cb, bp);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int cr = s.cog % 4 == 0 ? 4 : s.cog % 2 == 0 ? 2 : 1;
  const int load = s.cig % 16 == 0 && aligned(x, 16) ? 16 : s.cig % 4 == 0 && aligned(x, 4) ? 4 : 1;
  const long long blocks_y =
      s.cog <= CHANNELS ? (G + gb - 1) / gb : (long long)G * ((s.cog + CHANNELS - 1) / CHANNELS);
  if (blocks_y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((M + bp - 1) / bp), (unsigned)blocks_y);
  if (out_dtype == 0)
    return launch_out<float>(cr, load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out,
                             s, wz0, smem, grid, st);
  return launch_out<__nv_bfloat16>(cr, load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff,
                                   out, s, wz0, smem, grid, st);
}
