// K8: multi-head self-attention over fused qkv rows.
//
// Input (B*S, 3E) rows: head h's q at lanes [h*D, (h+1)*D), k at E + h*D,
// v at 2E + h*D. Output (B*S, E) rows, head h at [h*D, (h+1)*D). Nothing is
// reshaped in device memory. Per (image, head), with mm = bf16 when the
// input is bf16 and float32 otherwise:
//   q   = mm(float(q) * scale)                      scale = 1/sqrt(D)
//   sc  = q . k^T                                   products summed in float32
//   sc  = min(sc, ok ? 3e38 : -1e30)                only when masking applies:
//         ok = col < valid_len, or with causal: col <= row and (valid_len == S
//         or (col < valid_len and row < valid_len))
//   m   = max(max_col sc, -80)
//   ex  = exp(sc - m);  norm = max(sum ex, 1e-37)   (float32 ex)
//   out = (mm(ex) . v) / norm                        1/norm on the (S, D) rows
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/attention.py:
// _mha_rows_kernel (the exact two-pass softmax with the -80 row-max floor
// and the 1e-37 normalizer floor), which runs one image per grid step and
// keeps every (S, S) score block in VMEM.
//
// On the H100 at ViT shapes the work, 4*S*S*D operations per (image, head)
// against 3*S*D values read and S*D written, is bound by operations, and
// the products run on the CUDA cores as one fmaf chain per sum, in the
// float32 product's own order (head dims for a score, keys for an output).
// Two tensor-core designs were tried on the H100 and failed the check
// against the plain version: a sum in another order differs by a few
// float32 ulps, which in bf16 flips the rounding of mm(ex) and, for an
// output that nearly cancels, moves it by far more than two bf16 ulps (with
// bf16 mma.sync scores, and still with fmaf scores and mma.sync AV), and
// split TF32 (three TF32 products) for float32 missed atol 1e-5. So the f32
// carry uses no TF32 and bf16 no mma.
//
// One block owns (image, head, query rows, output columns): 64 query rows
// (four warps) where S <= 64 or the head dim is above 64, else 128 (eight
// warps, so each K and V tile serves twice the rows); 64 output columns,
// or 128 where the head dim is above 64. A thread computes a 4 x 8 register
// tile: rows 16w + r + 4i (warp w, r = lane / 8) by keys c + 8j (c = lane
// % 8) of a 64-key chunk for the scores, and the same rows by columns 4c +
// j and 32 + 4c + j of each 64 for the output, every shared-memory read 16
// bytes wide and free of bank conflicts (a warp reads 4 rows of q and 8
// keys of K at a time). The softmax is the exact two-pass one: the first
// pass over the key chunks (the last first) takes the row max, the second
// takes ex (mm(ex) through a tile in shared memory), the normalizer and AV,
// recomputing the scores of every chunk but the first, which the first pass
// left in the registers. K and V stream through shared memory in tiles of
// 64 keys x 64 lanes, two deep by 16-byte cp.async (zero-filled past S and
// D); q is scaled and rounded into a float32 tile once (up to head dim 128;
// above, each head-dim chunk again with its K tile), and bf16 K and V are
// widened into a float32 tile: 69 KB (float32) or 70 KB (bf16) with 64 rows,
// 104 or 105 KB with 128, 85 or 86 KB with 128 output columns, whatever S
// and D. QK^T runs in head-dim chunks of 64 with one fmaf chain per score
// running through them, the order in which the float32 product sums each
// dot up to K = 4,096; above, that product splits the sum (tried on the
// H100 at S = 8 and 64: a chain agrees up to head dim 4,096 and misses atol
// 1e-5 from 8,192 on), so in float32 each chunk's chains then start from
// zero and are added with Kahan compensation, which agrees from 8,192 to the
// widest head, 49,144. Summing in any other order where the product chains
// flips bf16 roundings of mm(ex) (chunk sums broke the two-ulp check at head
// dim 128, S = 856). A head dim above 128 is split
// across blocks by output columns, each block recomputing its scores, so
// every (S, D) the dispatch admits fits, up to head dim 65,528. Keys past S
// score -inf (ex = 0): S = 56 computes 56 keys, not a padded 224. Pad query
// rows (row >= valid_len) come out finite: without causal they attend to
// the valid keys; with causal every key is masked, m = -80, ex = 0 and the
// output is 0 / 1e-37 = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int TILE = 64;        // keys, head dims and output columns of a tile
constexpr int LDF = TILE + 4;   // float32 q, K and V tile row stride
constexpr int LDE = TILE + 8;   // mm(ex) tile row stride
constexpr int MAX_GRID_YZ = 65535;
// float32 scores: one fmaf chain up to this head dim, Kahan-compensated
// chunk sums above (see the comment at the top)
constexpr int CHAIN_MAX = 4096;

// Row stride of a raw K or V tile in elements (16-byte rows)
template <typename T>
struct Ld;
template <>
struct Ld<float> {
  static constexpr int value = LDF;
};
template <>
struct Ld<__nv_bfloat16> {
  static constexpr int value = TILE + 8;
};

// Shared memory of a block of W warps and NS 64-column output slices: the
// float32 q tile, the mm(ex) tile, for bf16 input a float32 K or V tile
// (for float32 the raw slots serve), and two raw K or V slots. Mirrored by
// quantize_tpu_torch/ops/attention.py: _mha_rows_smem.
template <int W, int NS, typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * W * (NS * TILE + 4 + LDE) + (sizeof(T) == 4 ? 0 : TILE * LDF)) +
         sizeof(T) * 2 * TILE * Ld<T>::value;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float mm_round(float v);
template <>
__device__ __forceinline__ float mm_round<float>(float v) { return v; }
template <>
__device__ __forceinline__ float mm_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the eight lanes of a row group (lane % 8) share a partial result
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[i][j] += q row (r0 + 4i) . K row (c + 8j) over head dims [0, dk) (a
// multiple of 4) of the float32 tiles, for the key groups j below nj (all
// eight when FULL); one fmaf a product, in head-dim order
template <bool FULL, int LDQ>
__device__ __forceinline__ void qk_add(const float* qw, const float* kt, int r0, int c, int dk,
                                       int nj, float (&s)[4][8]) {
  for (int kk = 0; kk < dk; kk += 4) {
    float4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = ld4(qw + (r0 + 4 * i) * LDQ + kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!FULL && j >= nj) break;
      const float4 k = ld4(kt + (c + 8 * j) * LDF + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = fmaf(q[i].w, k.w,
                       fmaf(q[i].z, k.z, fmaf(q[i].y, k.y, fmaf(q[i].x, k.x, s[i][j]))));
    }
  }
}

// acc[i][.] += mm(ex) row (r0 + 4i) . V columns (4c + j, 32 + 4c + j) over
// keys [0, nk) (a multiple of 4): one fmaf a product, in key order
__device__ __forceinline__ void av_add(const float* ex, const float* vt, int r0, int c, int nk,
                                       float (&acc)[4][8]) {
  for (int k0 = 0; k0 < nk; k0 += 4) {
    float4 e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = ld4(ex + (r0 + 4 * i) * LDE + k0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 va = ld4(vt + (k0 + u) * LDF + 4 * c);
      const float4 vb = ld4(vt + (k0 + u) * LDF + 32 + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = u == 0 ? e[i].x : u == 1 ? e[i].y : u == 2 ? e[i].z : e[i].w;
        acc[i][0] = fmaf(p, va.x, acc[i][0]);
        acc[i][1] = fmaf(p, va.y, acc[i][1]);
        acc[i][2] = fmaf(p, va.z, acc[i][2]);
        acc[i][3] = fmaf(p, va.w, acc[i][3]);
        acc[i][4] = fmaf(p, vb.x, acc[i][4]);
        acc[i][5] = fmaf(p, vb.y, acc[i][5]);
        acc[i][6] = fmaf(p, vb.z, acc[i][6]);
        acc[i][7] = fmaf(p, vb.w, acc[i][7]);
      }
    }
  }
}

// -- tiles ------------------------------------------------------------------

// rows [r0, r0 + 64) x lanes [c0, c0 + 64) of one D-wide slice of the rows
// into a raw tile, by 16-byte cp.async; zeros past S and past D
template <int NTHREADS, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int64_t ld, int S, int D,
                                          int r0, int c0, T* dst) {
  constexpr int PER16 = 16 / sizeof(T);
  constexpr int CPR = TILE / PER16;  // 16-byte pieces of a tile row
  for (int i = threadIdx.x; i < TILE * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * PER16;
    const bool ok = r0 + r < S && c0 + c < D;
    const T* p = ok ? src + (int64_t)(r0 + r) * ld + c0 + c : src;
    qtt::cp_async16(dst + r * Ld<T>::value + c, p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// q rows [r0, r0 + 16W) x head dims [c0, c0 + width), scaled in float32 and
// rounded to the product dtype, into the float32 q tile of row stride LDQ
// (zeros past S and D)
template <int W, int LDQ, typename T>
__device__ __forceinline__ void load_q(const T* __restrict__ src, int64_t ld, int S, int D,
                                       int r0, int c0, int width, float scale, float* qw) {
  const int per_row = width / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < 16 * W * per_row; i += 32 * W) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < S && c0 + c < D) {
      const float4 x = load4(src + (int64_t)(r0 + r) * ld + c0 + c);
      v = make_float4(mm_round<T>(__fmul_rn(x.x, scale)), mm_round<T>(__fmul_rn(x.y, scale)),
                      mm_round<T>(__fmul_rn(x.z, scale)), mm_round<T>(__fmul_rn(x.w, scale)));
    }
    *reinterpret_cast<float4*>(qw + r * LDQ + c) = v;
  }
}

// a raw bf16 K or V tile widened into a float32 tile
template <int NTHREADS>
__device__ __forceinline__ void widen(const __nv_bfloat16* raw, float* xw) {
  constexpr int LD = Ld<__nv_bfloat16>::value;
  for (int i = threadIdx.x; i < TILE * TILE / 8; i += NTHREADS) {
    const int r = i / (TILE / 8);
    const int c = (i - r * (TILE / 8)) * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(raw + r * LD + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float f[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
    *reinterpret_cast<float4*>(xw + r * LDF + c) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(xw + r * LDF + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// -- the kernel -------------------------------------------------------------

template <int W, int NS, typename T, typename TO>
__global__ void __launch_bounds__(32 * W, 2)
    mha_rows_kernel(const T* __restrict__ qkv, TO* __restrict__ out, int S, int H, int D,
                    int valid, bool causal, float scale) {
  constexpr int NTHREADS = 32 * W;
  constexpr int QROWS = 16 * W;           // query rows of a block
  constexpr int LDQ = NS * TILE + 4;      // q tile row stride: NS head-dim chunks resident
  constexpr int LD = Ld<T>::value;
  constexpr bool WIDE = sizeof(T) != 4;  // bf16: K and V widened to float32
  const bool compensated = !WIDE && NS > 1 && D > CHAIN_MAX;  // NS > 1: D > 64
  extern __shared__ int4 smem4[];
  float* qw = reinterpret_cast<float*>(smem4);
  float* ex = qw + QROWS * LDQ;
  float* xw = ex + QROWS * LDE;                                   // bf16 only
  T* raw = reinterpret_cast<T*>(xw + (WIDE ? TILE * LDF : 0));  // [2][TILE][LD]

  const int nq = (S + QROWS - 1) / QROWS;
  const int g0 = (blockIdx.x % nq) * QROWS;      // the block's query rows
  const int c0 = (blockIdx.x / nq) * NS * TILE;  // and output columns
  const int h = blockIdx.y;
  const int E = H * D;
  const int64_t ld = 3 * (int64_t)E;
  const T* base = qkv + (int64_t)blockIdx.z * S * ld + (int64_t)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 3);  // tile rows r0 + 4i
  const int c = lane & 7;                  // keys c + 8j, columns 4c + j and 32 + 4c + j
  const bool active = g0 + 16 * warp < S;  // warp-uniform
  const bool masked = causal || valid < S;

  // The steps: pass 1 takes a K tile per (key chunk, head-dim chunk), the
  // last chunk first; pass 2 takes the chunks in order, each's K tiles then
  // its NS V tiles of 64 columns (dc >= nd), but chunk 0, whose scores pass
  // 1 left in the registers, only its V tiles. Tiles alternate between the
  // two raw slots, the next one in flight while this one is used. q stays
  // in its tile where the head dim fits it (D <= 64 NS), else each K tile's
  // head-dim chunk of q is loaded with it.
  const int nk = (S + TILE - 1) / TILE, nd = (D + TILE - 1) / TILE;
  const bool q_resident = nd <= NS;
  const int pass1 = nk * nd;
  const int nsteps = pass1 + NS + (nk - 1) * (nd + NS);
  auto chunk_of = [&](int i, int& kc, int& dc) {
    if (i < pass1) {
      kc = nk - 1 - i / nd;
      dc = i % nd;
    } else if (i < pass1 + NS) {
      kc = 0;
      dc = nd + i - pass1;
    } else {
      kc = 1 + (i - pass1 - NS) / (nd + NS);
      dc = (i - pass1 - NS) % (nd + NS);
    }
  };
  auto slot = [&](int i) { return raw + (i & 1) * TILE * LD; };
  auto issue = [&](int i) {
    int kc, dc;
    chunk_of(i, kc, dc);
    if (dc >= nd)
      load_tile<NTHREADS>(base + 2 * E, ld, S, D, kc * TILE, c0 + (dc - nd) * TILE, slot(i));
    else
      load_tile<NTHREADS>(base + E, ld, S, D, kc * TILE, dc * TILE, slot(i));
  };

  float s[4][8], acc[NS][4][8], m[4], n[4];
  float comp[4][8] = {};  // the Kahan compensation of s (compensated)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    n[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = 0.0f;
#pragma unroll
      for (int hh = 0; hh < NS; ++hh) acc[hh][i][j] = 0.0f;
    }
  }

  issue(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (q_resident) load_q<W, LDQ>(base, ld, S, D, g0, 0, nd * TILE, scale, qw);
  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) {
      issue(i + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    int kc, dc;
    chunk_of(i, kc, dc);
    const bool second = i >= pass1;
    if (!q_resident && dc < nd) load_q<W, LDQ>(base, ld, S, D, g0, dc * TILE, TILE, scale, qw);
    if (i + 1 < nsteps)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const float* tile = reinterpret_cast<const float*>(slot(i));
    if (WIDE) {
      widen<NTHREADS>(reinterpret_cast<const __nv_bfloat16*>(slot(i)), xw);
      tile = xw;
    }
    const int nkeys = min(TILE, S - kc * TILE);
    if (dc < nd) {  // a K tile: one head-dim chunk of the scores
      if (WIDE) __syncthreads();
      if (active) {
        const int dk = min(TILE, D - dc * TILE);
        const float* q = qw + (q_resident ? dc * TILE : 0);
        // one fmaf chain per score over all head dims, or, for float32
        // above CHAIN_MAX, each chunk's chains from zero added to the
        // scores with Kahan compensation
        float p[4][8];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int j = 0; j < 8; ++j) p[ii][j] = 0.0f;
        float(&sums)[4][8] = compensated ? p : s;
        if (nkeys == TILE)
          qk_add<true, LDQ>(q, tile, r0, c, dk, 8, sums);
        else
          qk_add<false, LDQ>(q, tile, r0, c, dk, (nkeys + 7) / 8, sums);
        if (compensated) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float y = __fsub_rn(p[ii][j], comp[ii][j]);
              const float t = __fadd_rn(s[ii][j], y);
              comp[ii][j] = __fsub_rn(__fsub_rn(t, s[ii][j]), y);
              s[ii][j] = t;
            }
        }
      }
    }
    if (dc == (second ? nd : nd - 1) && active) {
      // the chunk's scores are complete: the mask (keys past S score -inf),
      // then the row max (pass 1) or ex, the normalizer and mm(ex) into its
      // tile (pass 2); the scores are cleared for the next chunk
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = g0 + r0 + 4 * ii;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = kc * TILE + c + 8 * j;
          float sc = s[ii][j];
          if (col >= S) {
            sc = -INFINITY;
          } else if (masked) {
            bool ok = col < valid;
            if (causal) ok = col <= row && (valid >= S || (col < valid && row < valid));
            sc = fminf(sc, ok ? 3e38f : -1e30f);
          }
          if (second || kc > 0) comp[ii][j] = 0.0f;
          if (!second) {
            m[ii] = fmaxf(m[ii], sc);
            if (kc > 0) s[ii][j] = 0.0f;  // chunk 0's scores stay for pass 2
          } else {
            s[ii][j] = 0.0f;
            const float e = expf(__fsub_rn(sc, m[ii]));
            n[ii] = __fadd_rn(n[ii], e);
            ex[(r0 + 4 * ii) * LDE + c + 8 * j] = mm_round<T>(e);
          }
        }
      }
    }
    if (dc >= nd) {  // a V tile: AV for its 64 columns
      __syncthreads();
      if (active) {
        const int nk4 = (nkeys + 3) / 4 * 4;
        if (dc == nd)
          av_add(ex, tile, r0, c, nk4, acc[0]);
        else
          av_add(ex, tile, r0, c, nk4, acc[NS - 1]);
      }
    }
    if (i == pass1 - 1) {  // the row max is complete (every lane takes part)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) m[ii] = fmaxf(group_max(m[ii]), -80.0f);
    }
    __syncthreads();  // every thread is done with this slot (and q, ex) before they are refilled
  }

  TO* o = out + ((int64_t)blockIdx.z * S) * E + (int64_t)h * D + c0;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float nrm = fmaxf(group_sum(n[ii]), 1e-37f);
    const int row = g0 + r0 + 4 * ii;
    if (row >= S) continue;
#pragma unroll
    for (int hh = 0; hh < NS; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = hh * TILE + (j < 4 ? 4 * c + j : 32 + 4 * c + j - 4);
        if (c0 + col < D) put(o + (int64_t)row * E + col, __fdiv_rn(acc[hh][ii][j], nrm));
      }
  }
}

template <int W, int NS, typename T, typename TO>
int launch_rows(const void* qkv, void* out, int B, int S, int H, int D, int valid, bool causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<W, NS, T>();
  cudaError_t err = cudaFuncSetAttribute(mha_rows_kernel<W, NS, T, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((S + 16 * W - 1) / (16 * W)) * ((D + NS * TILE - 1) / (NS * TILE));
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  mha_rows_kernel<W, NS, T, TO><<<dim3((unsigned)blocks, H, B), 32 * W, smem, stream>>>(
      (const T*)qkv, (TO*)out, S, H, D, valid, causal, scale);
  return (int)cudaGetLastError();
}

// A head dim above 64: 64 query rows and 128 output columns a block, q
// resident up to head dim 128. Else 64 query rows (four warps) where S <=
// 64, 128 (eight) above.
template <typename T, typename TO>
int launch(const void* qkv, void* out, int B, int S, int H, int D, int valid, bool causal,
           float scale, cudaStream_t stream) {
  if (D > TILE)
    return launch_rows<4, 2, T, TO>(qkv, out, B, S, H, D, valid, causal, scale, stream);
  if (S <= TILE)
    return launch_rows<4, 1, T, TO>(qkv, out, B, S, H, D, valid, causal, scale, stream);
  return launch_rows<8, 1, T, TO>(qkv, out, B, S, H, D, valid, causal, scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. D must be a multiple of 8 and the
// rows 16-byte aligned.
extern "C" int qtt_mha_rows(const void* qkv, void* out, int B, int S, int H, int D, int valid,
                            int causal, float scale, int in_dtype, int out_dtype,
                            void* stream) {
  if (D % 8 != 0 || D < 8 || S < 1 || valid < 1 || valid > S || B < 1 || B > MAX_GRID_YZ ||
      H < 1 || H > MAX_GRID_YZ || (reinterpret_cast<uintptr_t>(qkv) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0;
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(qkv, out, B, S, H, D, valid, c, scale, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(qkv, out, B, S, H, D, valid, c, scale, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(qkv, out, B, S, H, D, valid, c, scale, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(qkv, out, B, S, H, D, valid, c, scale, s);
  return (int)cudaErrorInvalidValue;
}
