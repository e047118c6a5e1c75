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
// On the H100 ResNeXt's grouped 3x3 convs are tiny GEMMs a group (K =
// 9 * C/G = 36-576, N = Co/G = 4-64), so a tensor-core tile run once a group
// would mostly multiply padding. This kernel sums on the CUDA cores with
// __dp4a (four int8 products a 4-byte word): at batch 256 the bound is
// about even between the bytes (the f32 output the largest stream) and
// dp4a's rate. A block of 256 threads covers bp output pixels (64 where
// shared memory allows) and up to 64 output channels: whole groups where a
// group has at most 64, else 64 channels of one group. It stages the
// block's weights, from a copy made once at pack time ((G, taps, C/G / 4,
// Co/G) words, quantize_tpu_torch/ops/qconv.py: grouped_weight), and its
// im2col patch rows, every tap of every pixel over the block's groups'
// channels, in shared memory as 4-byte words (16-byte loads where C/G is a
// multiple of 16; a group width that is not a multiple of 4 is zero-padded
// there), with pixels innermost so that a thread reads four pixels' words
// in one 16-byte load. A thread then sums 4 pixels x CR channels (CR = 4,
// 2 or 1, a divisor of Co/G) with 16-byte loads of both operands: 8 bytes
// of shared memory a dp4a at CR = 4, and the row sums (z_w != 0) by a dp4a
// against ones on the words it already holds. The patch matrix never
// reaches device memory. Shapes whose smallest tile (4 pixels) needs more
// shared memory than a block has are refused; the wrapper mirrors that
// (ops/qconv.py: _grouped_tile).
#include <cuda_bf16.h>
#include <stdint.h>

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

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. w_g is the (G, KH*KW, ceil(C/G / 4),
// Co/G) word copy of the weight; gb the groups a block stages and bp its
// output pixels, as ops/qconv.py: _grouped_tile chooses them (checked here).
extern "C" int qtt_qconv2d_grouped(const void* x, const void* w_g, const void* corr_a,
                                   const void* w_scale, const void* w_zero, const void* bias,
                                   const void* a_scale, const void* z_eff, void* out, int N, int H,
                                   int W, int C, int OH, int OW, int Co, int KH, int KW, int sh,
                                   int sw, int pt, int pl, int G, int gb, int bp,
                                   int w_zero_is_zero, int out_dtype, void* stream) {
  if (G < 1 || C % G != 0 || Co % G != 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = (cudaStream_t)stream;
  const bool wz0 = w_zero_is_zero != 0;
  if (out_dtype == 0)
    return launch_out<float>(cr, load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff, out,
                             s, wz0, smem, grid, st);
  return launch_out<__nv_bfloat16>(cr, load, x, w_g, corr_a, w_scale, w_zero, bias, a_scale, z_eff,
                                   out, s, wz0, smem, grid, st);
}
