// K9: multi-head self-attention over fused qkv rows with int8 scores.
//
// Input (B*S, 3E) rows: head h's q at lanes [h*D, (h+1)*D), k at E + h*D,
// v at 2E + h*D. Output (B*S, E) rows, head h at [h*D, (h+1)*D). Per
// (image, head), exactly as the Pallas kernel:
//   sc_x = max(absmax over all S rows of x, 1e-12) / 127   x = q, k, v
//          (pad rows included: the Pallas block is the whole padded image)
//   x8   = clip(rint(x / sc_x), -127, 127)                 IEEE division
//   s    = float(q8 . k8^T) * ((sq * sk) * scale)           exact s32 sums
//   s    = ok ? s : -1e30      ok = col < valid_len (and col <= row if causal)
//   ex8  = rint(expf(s - rowmax(s)) * 127)                  in [0, 127]
//   norm = sum ex8                                          exact
//   out  = float(ex8 . v8) * (sv / max(norm, 1))            exact s32 sums
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/attention.py:
// _mha_rows_int8_kernel (the opt-in QTPU_ATTN_INT8=1 variant), which runs one
// image per grid step with all heads' (S, S) scores in VMEM.
//
// On the H100 the work is small for the tensor cores (4*S*S*D int8
// operations per (image, head), against 3*S*D input values read and S*D
// written): at ViT shapes it is bound by the bytes of the qkv rows, and the
// resident layout reads each of them once; the streamed one reads them in
// its absmax pre-pass, then q once and k and v once per 64-row query block
// (then mostly from L2). QK^T and
// AV run on the int8 tensor cores as mma.sync.m16n8k32 s8 x s8 -> s32; each
// warp owns 16 query rows and computes their scores twice (once for the row
// max, once for ex8): the recomputation is cheaper than an f32 score buffer.
// Two layouts, chosen by the wrapper (ops/attention.py:
// _mha_rows_int8_layout mirrors both):
// * resident, where two buffers of a head's raw q, k and v rows and their
//   int8 tiles fit in 113 KB (two blocks an SM; ViT-B/32's S = 56 takes 109
//   KB in float32, 67 KB in bf16): as many blocks of eight warps as the card
//   holds at once take (image, head) pairs in turn. A block copies the next
//   pair's rows into shared memory with 16-byte cp.async while it works on
//   this one: the three absmax values, the quantize into q8, k8 (row-major)
//   and vT (transposed, the col layout mma wants for B), then its warps
//   take the head's 16-row query tiles;
// * streamed, everywhere else: a pre-pass (absmax_kernel, one block per
//   (image, head), 16-byte loads) writes the (B, H, 3) scales; then one
//   block per (image, head, 64 query rows, 64 output columns) holds int8
//   tiles of 64 x 64 only: q8 and k8 head-dim chunks of 64 (quantized as
//   they are loaded; the s32 scores of a 64-key chunk add up over the
//   chunks), the vT chunk of 64 keys x the block's 64 output columns, and
//   the four warps' ex8 tiles: 20 KB whatever S and D. A head dim above 64
//   is split across blocks by output columns, each block recomputing its
//   scores, so every (S, D) the dispatch admits fits, up to head dim 65,528.
// Both take keys in chunks of 64: a warp's s32 scores of a chunk in
// registers, ex8 through the warp's ex8 tile straight into AV. The quantize
// divides by multiplying with the correctly rounded reciprocal and one fma
// correction (quant), which gives the IEEE quotient.
// Keys are padded to 32 with zeros and masked to -1e30 (ex8 = 0). Every sum
// is an exact integer sum, so neither the order of the steps nor the
// chunking changes the result: the kernel is bit-equal to its plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;  // a streamed block
constexpr int NTHREADS = WARPS * 32;
constexpr int RWARPS = 8;  // a resident block
constexpr int RTHREADS = RWARPS * 32;
constexpr int TILE = 64;                   // keys a chunk; streamed: rows, head dims, columns
constexpr int LDT = TILE + 16;             // streamed int8 tile row stride
constexpr int STREAMED_SMEM = 4 * TILE * LDT;  // q8, k8, vT and the ex8 tiles
constexpr size_t RESIDENT_LIMIT = 113 * 1024;  // two blocks an SM
constexpr int PRE_THREADS = 256;
constexpr int MAX_GRID_YZ = 65535;

__host__ __device__ __forceinline__ size_t round_up(size_t v, size_t m) {
  return (v + m - 1) / m * m;
}

// The resident layout, offsets in bytes: q8 and k8 [SP][ldq], vT
// [D][ldv], the warps' ex8 tiles [16][LDT], the block reduction, then two
// buffers of the raw q, k and v rows [3][S][D] of a pair. Row strides are 16
// bytes more than a multiple of 32, which keeps the 32-bit fragment reads of
// eight rows on distinct banks. Mirrored by
// quantize_tpu_torch/ops/attention.py: _mha_rows_int8_layout.
struct Resident {
  int SP, DP, ldq, ldv;
  size_t k8, vt, ex, red, raw, total;
  __host__ __device__ Resident(int S, int D, int itemsize) {
    SP = (int)round_up(S, 32);  // keys (and q rows) padded to the k32 step
    DP = (int)round_up(D, 32);  // head dim padded to the k32 step
    ldq = DP + 16;
    ldv = SP + 16;
    k8 = (size_t)SP * ldq;
    vt = k8 + (size_t)SP * ldq;
    ex = round_up(vt + (size_t)D * ldv, 16);
    red = round_up(ex + (size_t)RWARPS * 16 * LDT, 16);
    raw = round_up(red + sizeof(float) * 3 * RWARPS, 16);
    total = raw + (size_t)2 * 3 * S * D * itemsize;
  }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// four consecutive values (16 bytes of float32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

__device__ __forceinline__ float absmax4(float4 v, float m) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int ld32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

// rint(a / sc) clipped to [-127, 127], with a / sc the IEEE quotient: q =
// a * rc with rc = RN(1 / sc), then one correction q + (a - q * sc) * rc by
// fma, which rounds to RN(a / sc) (Markstein: rc within half an ulp of
// 1 / sc, q within one ulp of the quotient). Cheaper than a division per
// value; the kernel stays bit-equal to its plain version's true division.
struct Scale {
  float sc, rc;
};

__device__ __forceinline__ Scale make_scale(float sc) { return Scale{sc, __frcp_rn(sc)}; }

__device__ __forceinline__ int quant(float a, const Scale& s) {
  const float q0 = __fmul_rn(a, s.rc);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s.sc, a), s.rc, q0);
  return (int)fminf(fmaxf(rintf(q), -127.0f), 127.0f);
}

// four values quantized and packed into one 32-bit word, the first lowest
__device__ __forceinline__ int quant4(float4 v, const Scale& s) {
  return (int)((uint32_t)(quant(v.x, s) & 0xff) | ((uint32_t)(quant(v.y, s) & 0xff) << 8) |
               ((uint32_t)(quant(v.z, s) & 0xff) << 16) |
               ((uint32_t)(quant(v.w, s) & 0xff) << 24));
}

__device__ __forceinline__ float component(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// s[j] += the warp's 16 q8 rows [r0, r0 + 16) . k8 rows [8j, 8j + 8) over
// head dims [0, dp) (a multiple of 32), for the n keys of a chunk of at most
// 64 (a multiple of 32); the A fragments are read once per k32 step
__device__ __forceinline__ void scores64(const int8_t* q8, int ldq, const int8_t* k8, int ldk,
                                         int dp, int r0, int n, int g, int t, int (&s)[8][4]) {
  for (int kk = 0; kk < dp; kk += 32) {
    const int8_t* p = q8 + (r0 + g) * ldq + kk + t * 4;
    const int a[4] = {ld32(p), ld32(p + 8 * ldq), ld32(p + 16), ld32(p + 8 * ldq + 16)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 >= n) break;
      const int8_t* pb = k8 + (j * 8 + g) * ldk + kk + t * 4;
      const int b[2] = {ld32(pb), ld32(pb + 16)};
      mma_s8(s[j], a, b);
    }
  }
}

// score of fragment element r (row g or g + 8, column 2t or 2t + 1)
__device__ __forceinline__ float score(int acc, float ts, int row, int col, int valid,
                                       bool causal) {
  const bool ok = col < valid && (!causal || col <= row);
  return ok ? __fmul_rn((float)acc, ts) : -1e30f;
}

// the running row maxima of the warp's rows over the n keys of a chunk
// starting at key kc0
__device__ __forceinline__ void max_of(const int (&s)[8][4], float ts, int row_lo, int row_hi,
                                       int kc0, int n, int valid, bool causal, int t,
                                       float& m_lo, float& m_hi) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j * 8 >= n) break;
    const int col = kc0 + j * 8 + 2 * t;
    m_lo = fmaxf(m_lo, fmaxf(score(s[j][0], ts, row_lo, col, valid, causal),
                             score(s[j][1], ts, row_lo, col + 1, valid, causal)));
    m_hi = fmaxf(m_hi, fmaxf(score(s[j][2], ts, row_hi, col, valid, causal),
                             score(s[j][3], ts, row_hi, col + 1, valid, causal)));
  }
}

// ex8 of the chunk's scores into the warp's ex8 tile [16][LDT] and into the
// lane's integer row sums
__device__ __forceinline__ void put_ex8(const int (&s)[8][4], float ts, int row_lo, int row_hi,
                                        int kc0, int n, int valid, bool causal, float m_lo,
                                        float m_hi, int8_t* ex, int g, int t, int& n_lo,
                                        int& n_hi) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j * 8 >= n) break;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool hi = r >= 2;
      const int c = j * 8 + 2 * t + (r & 1);
      const float sc = score(s[j][r], ts, hi ? row_hi : row_lo, kc0 + c, valid, causal);
      const int e8 = (int)rintf(__fmul_rn(expf(__fsub_rn(sc, hi ? m_hi : m_lo)), 127.0f));
      ex[(g + (hi ? 8 : 0)) * LDT + c] = (int8_t)e8;
      if (hi) n_hi += e8; else n_lo += e8;
    }
  }
}

// acc[j] += the warp's ex8 rows . vT rows [d0 + 8j, d0 + 8j + 8) over the n
// keys (a multiple of 32) of a chunk: ex8 columns [0, n), vT columns
// [k0, k0 + n); vT rows from D on are skipped
__device__ __forceinline__ void av_add(const int8_t* ex, const int8_t* vt, int ldv, int k0, int n,
                                       int d0, int D, int g, int t, int (&acc)[8][4]) {
  for (int kk = 0; kk < n; kk += 32) {
    const int8_t* p = ex + g * LDT + kk + t * 4;
    const int a[4] = {ld32(p), ld32(p + 8 * LDT), ld32(p + 16), ld32(p + 8 * LDT + 16)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (d0 + j * 8 >= D) break;  // warp-uniform: D is a multiple of 8
      const int8_t* pb = vt + (d0 + j * 8 + g) * ldv + k0 + kk + t * 4;
      const int b[2] = {ld32(pb), ld32(pb + 16)};
      mma_s8(acc[j], a, b);
    }
  }
}

// the four lanes of a row share their partial results (max or add)
__device__ __forceinline__ void quad_max(float& a, float& b) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
}
__device__ __forceinline__ void quad_sum(int& a, int& b) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// out = (ex8 . v8) * (sv / max(norm, 1)) for columns d0 .. d0 + 63 below D;
// n_lo and n_hi are the rows' whole normalizers
template <typename TO>
__device__ __forceinline__ void write_out(TO* o, const int (&acc)[8][4], int n_lo, int n_hi,
                                          float sv, int row_lo, int row_hi, int d0, int D, int S,
                                          int E, int t) {
  const float f_lo = __fdiv_rn(sv, fmaxf((float)n_lo, 1.0f));
  const float f_hi = __fdiv_rn(sv, fmaxf((float)n_hi, 1.0f));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = d0 + j * 8 + 2 * t;
    if (col >= D) break;
    if (row_lo < S) {
      put(o + (int64_t)row_lo * E + col, __fmul_rn((float)acc[j][0], f_lo));
      put(o + (int64_t)row_lo * E + col + 1, __fmul_rn((float)acc[j][1], f_lo));
    }
    if (row_hi < S) {
      put(o + (int64_t)row_hi * E + col, __fmul_rn((float)acc[j][2], f_hi));
      put(o + (int64_t)row_hi * E + col + 1, __fmul_rn((float)acc[j][3], f_hi));
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
}

// ---------------------------------------------------------------------------
// resident: each block takes (image, head) pairs in turn, the raw rows of
// the next one in flight while it works on this one
// ---------------------------------------------------------------------------

template <typename TI, typename TO>
__global__ void __launch_bounds__(RTHREADS)
    mha_rows_int8_kernel(const TI* __restrict__ qkv, TO* __restrict__ out, int B, int S, int H,
                         int D, int valid, bool causal, float scale) {
  extern __shared__ int4 smem4[];
  int8_t* sm = reinterpret_cast<int8_t*>(smem4);
  const Resident L(S, D, sizeof(TI));
  int8_t* q8 = sm;
  int8_t* k8 = sm + L.k8;
  int8_t* vt = sm + L.vt;
  float* red = reinterpret_cast<float*>(sm + L.red);
  const int E = H * D;
  const int64_t ld = 3 * (int64_t)E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int8_t* ex = sm + L.ex + warp * 16 * LDT;

  // the raw q, k and v rows of pair p, [3][S][D], into buffer `buf`, read
  // once, 16 bytes a copy
  constexpr int PER16 = 16 / sizeof(TI);
  const int cpr = D / PER16;  // 16-byte pieces of a row
  auto issue = [&](int p, int buf) {
    const TI* base = qkv + (int64_t)(p / H) * S * ld + (int64_t)(p % H) * D;
    TI* raw = reinterpret_cast<TI*>(sm + L.raw) + (size_t)buf * 3 * S * D;
    for (int i = threadIdx.x; i < 3 * S * cpr; i += RTHREADS) {
      const int jr = i / cpr;  // j * S + r
      const int c = (i - jr * cpr) * PER16;
      const int j = jr / S;
      const int r = jr - j * S;
      qtt::cp_async16(raw + (size_t)jr * D + c, base + (int64_t)r * ld + j * E + c, 16);
    }
  };

  const int pairs = B * H;
  if (blockIdx.x < pairs) issue(blockIdx.x, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int buf = 0;
  for (int p = blockIdx.x; p < pairs; p += gridDim.x, buf ^= 1) {
    if (p + gridDim.x < pairs) issue(p + gridDim.x, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const TI* raw = reinterpret_cast<const TI*>(sm + L.raw) + (size_t)buf * 3 * S * D;

    // 1. the absmax of q, k and v over all S rows
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float m = 0.0f;
      for (int i = threadIdx.x; i < S * D / 4; i += RTHREADS)
        m = absmax4(load4(raw + (size_t)j * S * D + 4 * i), m);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) red[warp * 3 + j] = m;
    }
    __syncthreads();
    float scv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float m = red[j];
      for (int w = 1; w < RWARPS; ++w) m = fmaxf(m, red[w * 3 + j]);
      scv[j] = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    }
    const Scale sq = make_scale(scv[0]), sk = make_scale(scv[1]), sv = make_scale(scv[2]);

    // 2. q8 and k8 (zeros past S and past D), and vT in 4 x 4 blocks (zeros
    // past S)
    const int dp4 = L.DP / 4;
    for (int i = threadIdx.x; i < L.SP * dp4; i += RTHREADS) {
      const int r = i / dp4;
      const int c = (i - r * dp4) * 4;
      int qv = 0, kv = 0;
      if (r < S && c < D) {
        qv = quant4(load4(raw + (size_t)r * D + c), sq);
        kv = quant4(load4(raw + (size_t)(S + r) * D + c), sk);
      }
      *reinterpret_cast<int*>(q8 + r * L.ldq + c) = qv;
      *reinterpret_cast<int*>(k8 + r * L.ldq + c) = kv;
    }
    const int d4 = D / 4;
    for (int i = threadIdx.x; i < (L.SP / 4) * d4; i += RTHREADS) {
      const int kb = i / d4 * 4;
      const int cb = (i - (kb / 4) * d4) * 4;
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = kb + u < S ? load4(raw + (size_t)(2 * S + kb + u) * D + cb)
                          : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        *reinterpret_cast<int*>(vt + (cb + cc) * L.ldv + kb) = quant4(
            make_float4(component(v[0], cc), component(v[1], cc), component(v[2], cc),
                        component(v[3], cc)),
            sv);
    }
    __syncthreads();

    // 3. each warp takes 16-row query tiles, keys in chunks of 64
    const float ts = __fmul_rn(__fmul_rn(sq.sc, sk.sc), scale);
    TO* obase = out + (int64_t)(p / H) * S * E + (int64_t)(p % H) * D;
    for (int qt = warp; qt < (S + 15) / 16; qt += RWARPS) {
      const int qr0 = qt * 16;
      const int row_lo = qr0 + g, row_hi = row_lo + 8;
      float m_lo = -INFINITY, m_hi = -INFINITY;
      for (int kc0 = 0; kc0 < L.SP; kc0 += TILE) {
        const int n = min(TILE, L.SP - kc0);
        int s[8][4];
        zero(s);
        scores64(q8, L.ldq, k8 + kc0 * L.ldq, L.ldq, L.DP, qr0, n, g, t, s);
        max_of(s, ts, row_lo, row_hi, kc0, n, valid, causal, t, m_lo, m_hi);
      }
      quad_max(m_lo, m_hi);
      for (int d0 = 0; d0 < D; d0 += 64) {
        int acc[8][4];
        zero(acc);
        int n_lo = 0, n_hi = 0;
        for (int kc0 = 0; kc0 < L.SP; kc0 += TILE) {
          const int n = min(TILE, L.SP - kc0);
          int s[8][4];
          zero(s);
          scores64(q8, L.ldq, k8 + kc0 * L.ldq, L.ldq, L.DP, qr0, n, g, t, s);
          put_ex8(s, ts, row_lo, row_hi, kc0, n, valid, causal, m_lo, m_hi, ex, g, t, n_lo,
                  n_hi);
          __syncwarp();
          av_add(ex, vt, L.ldv, kc0, n, d0, D, g, t, acc);
          __syncwarp();  // the next chunk overwrites ex
        }
        quad_sum(n_lo, n_hi);
        write_out(obase, acc, n_lo, n_hi, sv.sc, row_lo, row_hi, d0, D, S, E, t);
      }
    }
    __syncthreads();  // the tiles and the reduction are refilled for the next pair
  }
}

// ---------------------------------------------------------------------------
// streamed: the absmax pre-pass, then one block per (image, head, 64 query
// rows, 64 output columns)
// ---------------------------------------------------------------------------

template <typename TI>
__global__ void __launch_bounds__(PRE_THREADS)
    absmax_kernel(const TI* __restrict__ qkv, float* __restrict__ scales, int S, int H, int D) {
  __shared__ float red[PRE_THREADS / 32][3];
  const int E = H * D;
  const int64_t ld = 3 * (int64_t)E;
  const TI* base = qkv + (int64_t)blockIdx.y * S * ld + (int64_t)blockIdx.x * D;
  const int d4 = D / 4;
  float m[3] = {0.0f, 0.0f, 0.0f};
  for (int64_t i = threadIdx.x; i < (int64_t)S * d4; i += PRE_THREADS) {
    const int r = (int)(i / d4);
    const TI* p = base + r * ld + (int)(i - (int64_t)r * d4) * 4;
#pragma unroll
    for (int j = 0; j < 3; ++j) m[j] = absmax4(load4(p + j * E), m[j]);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
    if (lane == 0) red[warp][j] = m[j];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < PRE_THREADS / 32; ++w) v = fmaxf(v, red[w][threadIdx.x]);
    scales[((int64_t)blockIdx.y * H + blockIdx.x) * 3 + threadIdx.x] =
        __fdiv_rn(fmaxf(v, 1e-12f), 127.0f);
  }
}

// rows [r0, r0 + 64) x head dims [c0, c0 + 64) of q or k, quantized, into a
// row-major int8 tile (zeros past S and past D)
template <typename TI>
__device__ __forceinline__ void load_rows(const TI* __restrict__ src, int64_t ld, int S, int D,
                                          int r0, int c0, const Scale& sc, int8_t* dst) {
  for (int i = threadIdx.x; i < TILE * TILE / 4; i += NTHREADS) {
    const int r = i / (TILE / 4);
    const int c = (i - r * (TILE / 4)) * 4;
    int v = 0;
    if (r0 + r < S && c0 + c < D) v = quant4(load4(src + (int64_t)(r0 + r) * ld + c0 + c), sc);
    *reinterpret_cast<int*>(dst + r * LDT + c) = v;
  }
}

// keys [k0, k0 + 64) x columns [c0, c0 + 64) of v, quantized and transposed
// into vT [column][key] in 4 x 4 blocks (zeros past S and past D)
template <typename TI>
__device__ __forceinline__ void load_vt(const TI* __restrict__ src, int64_t ld, int S, int D,
                                        int k0, int c0, const Scale& sc, int8_t* vt) {
  for (int i = threadIdx.x; i < (TILE / 4) * (TILE / 4); i += NTHREADS) {
    const int kb = i / (TILE / 4) * 4;
    const int cb = (i % (TILE / 4)) * 4;
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = k0 + kb + u < S && c0 + cb < D ? load4(src + (int64_t)(k0 + kb + u) * ld + c0 + cb)
                                            : make_float4(0, 0, 0, 0);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<int*>(vt + (cb + cc) * LDT + kb) = quant4(
          make_float4(component(v[0], cc), component(v[1], cc), component(v[2], cc),
                      component(v[3], cc)),
          sc);
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(NTHREADS)
    mha_rows_int8_streamed_kernel(const TI* __restrict__ qkv, const float* __restrict__ scales,
                                  TO* __restrict__ out, int S, int H, int D, int valid,
                                  bool causal, float scale) {
  __shared__ __align__(16) int8_t sm[STREAMED_SMEM];
  int8_t* q8 = sm;
  int8_t* k8 = sm + TILE * LDT;
  int8_t* vt = sm + 2 * TILE * LDT;
  const int nq = (S + TILE - 1) / TILE;
  const int g0 = (blockIdx.x % nq) * TILE;  // the block's query rows
  const int c0 = (blockIdx.x / nq) * TILE;  // and output columns
  const int h = blockIdx.y;
  const int E = H * D;
  const int64_t ld = 3 * (int64_t)E;
  const TI* base = qkv + (int64_t)blockIdx.z * S * ld + (int64_t)h * D;
  TO* obase = out + (int64_t)blockIdx.z * S * E + (int64_t)h * D + c0;
  const float* scl = scales + ((int64_t)blockIdx.z * H + h) * 3;
  const Scale sq = make_scale(scl[0]), sk = make_scale(scl[1]), sv = make_scale(scl[2]);
  const float ts = __fmul_rn(__fmul_rn(sq.sc, sk.sc), scale);
  const int SP = (int)round_up(S, 32);
  const bool one_chunk = D <= TILE;  // q8 loaded once

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = warp * 16;
  const int row_lo = g0 + qr0 + g, row_hi = row_lo + 8;
  const bool active = g0 + qr0 < S;  // warp-uniform
  int8_t* ex = sm + 3 * TILE * LDT + warp * 16 * LDT;

  if (one_chunk) load_rows(base, ld, S, D, g0, 0, sq, q8);

  // pass 1: the row max
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int kc0 = 0; kc0 < SP; kc0 += TILE) {
    const int n = min(TILE, SP - kc0);
    int s[8][4];
    zero(s);
    for (int dc = 0; dc < D; dc += TILE) {
      __syncthreads();  // every warp is done with the previous tiles
      if (!one_chunk) load_rows(base, ld, S, D, g0, dc, sq, q8);
      load_rows(base + E, ld, S, D, kc0, dc, sk, k8);
      __syncthreads();
      if (active) scores64(q8, LDT, k8, LDT, TILE, qr0, n, g, t, s);
    }
    if (active) max_of(s, ts, row_lo, row_hi, kc0, n, valid, causal, t, m_lo, m_hi);
  }
  quad_max(m_lo, m_hi);

  // pass 2: ex8, the normalizer and AV for the block's columns
  int acc[8][4];
  zero(acc);
  int n_lo = 0, n_hi = 0;
  const int dcols = min(TILE, D - c0);
  for (int kc0 = 0; kc0 < SP; kc0 += TILE) {
    const int n = min(TILE, SP - kc0);
    int s[8][4];
    zero(s);
    for (int dc = 0; dc < D; dc += TILE) {
      __syncthreads();
      if (!one_chunk) load_rows(base, ld, S, D, g0, dc, sq, q8);
      load_rows(base + E, ld, S, D, kc0, dc, sk, k8);
      if (dc + TILE >= D) load_vt(base + 2 * E, ld, S, D, kc0, c0, sv, vt);
      __syncthreads();
      if (active) scores64(q8, LDT, k8, LDT, TILE, qr0, n, g, t, s);
    }
    if (active) {
      put_ex8(s, ts, row_lo, row_hi, kc0, n, valid, causal, m_lo, m_hi, ex, g, t, n_lo, n_hi);
      __syncwarp();
      av_add(ex, vt, LDT, 0, n, 0, dcols, g, t, acc);
    }
  }
  quad_sum(n_lo, n_hi);
  write_out(obase, acc, n_lo, n_hi, sv.sc, row_lo, row_hi, 0, dcols, S, E, t);
}

template <typename TI, typename TO>
int launch(const void* qkv, void* out, float* scales, int B, int S, int H, int D, int valid,
           bool causal, float scale, bool resident, cudaStream_t stream) {
  if (resident) {
    const Resident L(S, D, sizeof(TI));
    if (L.total > RESIDENT_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = mha_rows_int8_kernel<TI, TO>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.total);
    if (err != cudaSuccess) return (int)err;
    // as many blocks as fit the card at once, each taking pairs in turn
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RTHREADS,
                                                             L.total)) != cudaSuccess)
      return (int)err;
    const int64_t pairs = (int64_t)B * H;
    const int blocks = (int)(pairs < (int64_t)sms * per_sm ? pairs : (int64_t)sms * per_sm);
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    kernel<<<blocks, RTHREADS, L.total, stream>>>((const TI*)qkv, (TO*)out, B, S, H, D, valid,
                                                  causal, scale);
    return (int)cudaGetLastError();
  }
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  absmax_kernel<TI><<<dim3(H, B), PRE_THREADS, 0, stream>>>((const TI*)qkv, scales, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((S + TILE - 1) / TILE) * ((D + TILE - 1) / TILE);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  mha_rows_int8_streamed_kernel<TI, TO><<<dim3((unsigned)blocks, H, B), NTHREADS, 0, stream>>>(
      (const TI*)qkv, scales, (TO*)out, S, H, D, valid, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. D must be a multiple of 8 and the
// rows 16-byte aligned. `resident` picks the layout (the wrapper's mirror
// decides; a resident layout above 113 KB is refused); the streamed one
// needs `scales`, (B, H, 3) float32 scratch for the absmax pre-pass.
extern "C" int qtt_mha_rows_int8(const void* qkv, void* out, float* scales, int B, int S, int H,
                                 int D, int valid, int causal, float scale, int in_dtype,
                                 int out_dtype, int resident, void* stream) {
  if (D % 8 != 0 || D < 8 || S < 1 || valid < 1 || valid > S || B < 1 || B > MAX_GRID_YZ ||
      H < 1 || H > MAX_GRID_YZ || (reinterpret_cast<uintptr_t>(qkv) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool c = causal != 0, r = resident != 0;
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(qkv, out, scales, B, S, H, D, valid, c, scale, r, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(qkv, out, scales, B, S, H, D, valid, c, scale, r, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(qkv, out, scales, B, S, H, D, valid, c, scale, r, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(qkv, out, scales, B, S, H, D, valid, c, scale, r,
                                                 s);
  return (int)cudaErrorInvalidValue;
}
