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
// image per grid step with all heads' (S, S) scores in VMEM. Here one block
// owns one (image, head), or 64 of its query rows: a first pass over that
// head's q, k and v in device memory takes the three absmax values (a block
// reduction); then q, k and v are quantized into int8 tiles in shared
// memory as they are loaded (q and k row-major, v transposed, the col
// layout mma wants for B). QK^T and AV run
// on the tensor cores as mma.sync.m16n8k32 s8 x s8 -> s32. Keys are padded
// to 32 and head dims to 32 with zeros (zero weights); pad keys are masked
// to -1e30, so they get ex8 = 0. Each warp takes 16 query rows at a time: it
// computes their scores twice from the int8 tiles (once for the row max,
// once for ex8: the recomputation is cheaper than an f32 score buffer in
// shared memory), and ex8 goes, up to 256 keys at a time, to the warp's ex8
// tile and straight into AV, so no score reaches device memory and no S-long
// row is kept. Shared memory is bounded whatever S (Layout, chosen by the
// launcher; the wrapper mirrors it):
// * resident: q8, k8 and vT of all S rows, where they fit (195 KB at
//   S = 776, D = 64);
// * chunked, elsewhere: a block per 64 query rows (each block takes the
//   absmax of the whole head again) holds their q8; k and v are quantized
//   chunk by chunk (256, 128, 64 or 32 keys, the largest that fits) on each
//   of the two passes over the keys, each warp's row max and normalizer in
//   registers across the chunks and the partial AV sums in shared memory
//   (int32, 64 rows x D); every D <= 256 at every S the dispatch admits.
// Every sum is an exact integer sum, so neither the order of the steps nor
// the chunking changes the result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int NTHREADS = WARPS * 32;
constexpr int MAX_GRID_Y = 65535;
constexpr int EXMAX = 256;              // keys per ex8 pass at most
constexpr int QGROUP = WARPS * 16;      // query rows of a group when chunked
constexpr size_t SMEM_LIMIT = 232448;   // shared memory a block may use (227 KB)

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared-memory layout of one (image, head) block for QG query rows and KC
// keys held at a time, offsets in bytes. Row strides are 16 bytes more than
// a multiple of 32, which keeps the 32-bit fragment reads of eight rows on
// distinct banks. Mirrored by quantize_tpu_torch/ops/attention.py:
// _mha_rows_int8_smem.
struct Layout {
  int SP, DP, QG, KC, ldq, ldv, exw, lde;
  bool chunked;  // keys in chunks, queries in groups of QGROUP rows
  size_t k8, vt, ex, acc, red, total;
  __host__ __device__ Layout(int S, int D, int qg, int kc) {
    SP = round_up(S, 32);        // keys (and q rows) padded to the k32 step
    DP = round_up(D, 32);        // head dim padded to the k32 step
    QG = qg;
    KC = kc;
    chunked = KC < SP;
    ldq = DP + 16;               // q8 / k8 row stride
    ldv = KC + 16;               // vT row stride (one row per head-dim column)
    exw = KC < EXMAX ? KC : EXMAX;  // keys per ex8 pass (a multiple of 32)
    lde = exw + 16;              // a warp's ex8 tile row stride
    k8 = (size_t)QG * ldq;       // q8 [QG][ldq] at 0, k8 [KC][ldq]
    vt = k8 + (size_t)KC * ldq;  // vT [D][ldv]
    ex = round_up((int)(vt + (size_t)D * ldv), 16);   // WARPS x ex8 [16][lde]
    acc = round_up((int)(ex + (size_t)WARPS * 16 * lde), 16);  // int32 [QG][D] when chunked
    red = round_up((int)(acc + (chunked ? (size_t)QG * D * 4 : 0)), 16);
    total = red + sizeof(float) * 3 * WARPS;
  }
  // resident where it fits, else chunked with the largest chunk that fits
  static Layout choose(int S, int D) {
    const int sp = round_up(S, 32);
    Layout L(S, D, sp, sp);
    if (L.total <= SMEM_LIMIT) return L;
    for (int kc = 256; kc >= 32; kc /= 2) {
      if (kc >= sp) continue;
      L = Layout(S, D, QGROUP, kc);
      if (L.total <= SMEM_LIMIT) return L;
    }
    return L;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int ld32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

__device__ __forceinline__ int8_t quant(float a, float sc) {
  const float q = rintf(__fdiv_rn(a, sc));
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

// The m16n8 s32 tile of q8 rows [r0, r0 + 16) x k8 rows [c0, c0 + 8).
__device__ __forceinline__ void qk_tile(const int8_t* q8, const int8_t* k8, const Layout& L,
                                        int r0, int c0, int g, int t, int (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0;
  for (int kk = 0; kk < L.DP; kk += 32) {
    const int8_t* p = q8 + (r0 + g) * L.ldq + kk + t * 4;
    const int a[4] = {ld32(p), ld32(p + 8 * L.ldq), ld32(p + 16), ld32(p + 8 * L.ldq + 16)};
    const int8_t* pb = k8 + (c0 + g) * L.ldq + kk + t * 4;
    const int b[2] = {ld32(pb), ld32(pb + 16)};
    mma_s8(acc, a, b);
  }
}

// score of fragment element r (row g or g + 8, column 2t or 2t + 1)
__device__ __forceinline__ float score(int acc, float ts, int row, int col, int valid,
                                       bool causal) {
  const bool ok = col < valid && (!causal || col <= row);
  return ok ? __fmul_rn((float)acc, ts) : -1e30f;
}

// q, k or v rows [r0, r0 + n) of one head into an int8 tile, row-major
// [n][ldq] over the padded head dim: zeros past S and past D
template <typename TI>
__device__ __forceinline__ void load_rows(const TI* __restrict__ src, int64_t ld, int S, int D,
                                          int r0, int n, int ldq, int DP, float sc, int8_t* dst) {
  for (int i = threadIdx.x; i < n * DP; i += NTHREADS) {
    const int r = i / DP;
    const int c = i - r * DP;
    const int row = r0 + r;
    dst[r * ldq + c] = row < S && c < D ? quant(to_f(src[(int64_t)row * ld + c]), sc) : (int8_t)0;
  }
}

// q and k rows [0, n) of one head in one pass (the resident layout)
template <typename TI>
__device__ __forceinline__ void load_qk(const TI* __restrict__ src, int64_t ld, int E, int S,
                                        int D, int n, int ldq, int DP, float sq, float sk,
                                        int8_t* q8, int8_t* k8) {
  for (int i = threadIdx.x; i < n * DP; i += NTHREADS) {
    const int r = i / DP;
    const int c = i - r * DP;
    int8_t qv = 0, kv = 0;
    if (r < S && c < D) {
      const TI* p = src + (int64_t)r * ld + c;
      qv = quant(to_f(p[0]), sq);
      kv = quant(to_f(p[E]), sk);
    }
    q8[r * ldq + c] = qv;
    k8[r * ldq + c] = kv;
  }
}

// v rows [r0, r0 + n) of one head, transposed: vT [D][ldv], zeros past S
template <typename TI>
__device__ __forceinline__ void load_vt(const TI* __restrict__ src, int64_t ld, int S, int D,
                                        int r0, int n, int ldv, float sc, int8_t* vt) {
  for (int i = threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = r0 + r;
    vt[c * ldv + r] = row < S ? quant(to_f(src[(int64_t)row * ld + c]), sc) : (int8_t)0;
  }
}

// The running row max of a warp's 16 query rows (q8 rows qr0 .. + 15,
// global rows row_lo = qr0' + g and row_hi = row_lo + 8) over the n keys in
// k8, which are keys kc0 .. kc0 + n - 1
__device__ __forceinline__ void row_max(const int8_t* q8, const int8_t* k8, const Layout& L,
                                        int qr0, int row_lo, int row_hi, int kc0, int n, float ts,
                                        int valid, bool causal, int g, int t, float& m_lo,
                                        float& m_hi) {
  for (int c0 = 0; c0 < n; c0 += 8) {
    int acc[4];
    qk_tile(q8, k8, L, qr0, c0, g, t, acc);
    const int col = kc0 + c0 + 2 * t;
    m_lo = fmaxf(m_lo, fmaxf(score(acc[0], ts, row_lo, col, valid, causal),
                             score(acc[1], ts, row_lo, col + 1, valid, causal)));
    m_hi = fmaxf(m_hi, fmaxf(score(acc[2], ts, row_hi, col, valid, causal),
                             score(acc[3], ts, row_hi, col + 1, valid, causal)));
  }
}

// AV += ex8 . v8 for head-dim columns d0 .. d0 + 63 of a warp's 16 rows
// over the n keys in k8 / vT (keys kc0 ..), up to exw keys at a time
// through the warp's ex8 tile; with `count`, the ex8 also go into the
// lane's integer row sums
__device__ __forceinline__ void ex_av(const int8_t* q8, const int8_t* k8, const int8_t* vt,
                                      int8_t* ex, const Layout& L, int qr0, int row_lo, int row_hi,
                                      int kc0, int n, int d0, int D, float m_lo, float m_hi,
                                      float ts, int valid, bool causal, bool count, int g, int t,
                                      int& n_lo, int& n_hi, int (&acc)[8][4]) {
  for (int k0 = 0; k0 < n; k0 += L.exw) {
    const int kw = min(L.exw, n - k0);  // keys in this pass, a multiple of 32
    for (int c8 = 0; c8 < kw; c8 += 8) {
      int sacc[4];
      qk_tile(q8, k8, L, qr0, k0 + c8, g, t, sacc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool hi = r >= 2;
        const int col = c8 + 2 * t + (r & 1);
        const float s = score(sacc[r], ts, hi ? row_hi : row_lo, kc0 + k0 + col, valid, causal);
        const int e8 = (int)rintf(__fmul_rn(expf(__fsub_rn(s, hi ? m_hi : m_lo)), 127.0f));
        ex[(g + (hi ? 8 : 0)) * L.lde + col] = (int8_t)e8;
        if (count) {
          if (hi) n_hi += e8; else n_lo += e8;
        }
      }
    }
    __syncwarp();
    for (int kk = 0; kk < kw; kk += 32) {
      const int8_t* p = ex + g * L.lde + kk + t * 4;
      const int a[4] = {ld32(p), ld32(p + 8 * L.lde), ld32(p + 16), ld32(p + 8 * L.lde + 16)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (d0 + j * 8 >= D) break;  // warp-uniform: D is a multiple of 8
        const int8_t* pb = vt + (d0 + j * 8 + g) * L.ldv + k0 + kk + t * 4;
        const int b[2] = {ld32(pb), ld32(pb + 16)};
        mma_s8(acc[j], a, b);
      }
    }
    __syncwarp();  // the next pass overwrites ex
  }
}

// the four lanes of a row share their partial sums (max or add)
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

// out = (ex8 . v8) * (sv / max(norm, 1)) for columns d0 .. d0 + 63
template <typename TO>
__device__ __forceinline__ void write_out(TO* o, const int (&acc)[8][4], float f_lo, float f_hi,
                                          int row_lo, int row_hi, int d0, int D, int S, int E,
                                          int t) {
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

template <typename TI, typename TO>
__global__ void __launch_bounds__(NTHREADS)
    mha_rows_int8_kernel(const TI* __restrict__ qkv, TO* __restrict__ out, int S, int H, int D,
                         int valid, bool causal, float scale, int qg, int kc) {
  extern __shared__ int4 smem4[];
  int8_t* sm = reinterpret_cast<int8_t*>(smem4);
  const Layout L(S, D, qg, kc);
  int8_t* q8 = sm;
  int8_t* k8 = sm + L.k8;
  int8_t* vt = sm + L.vt;
  int* accs = reinterpret_cast<int*>(sm + L.acc);
  float* red = reinterpret_cast<float*>(sm + L.red);

  const int h = blockIdx.x;
  const int E = H * D;
  const int64_t ld = 3 * (int64_t)E;
  const TI* base = qkv + (int64_t)blockIdx.y * S * ld + (int64_t)h * D;
  TO* obase = out + (int64_t)blockIdx.y * S * E + (int64_t)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. the absmax of q, k and v over all S rows
  float mx[3] = {0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < S * D; i += NTHREADS) {
    const int r = i / D;
    const TI* p = base + (int64_t)r * ld + (i - r * D);
    mx[0] = fmaxf(mx[0], fabsf(to_f(p[0])));
    mx[1] = fmaxf(mx[1], fabsf(to_f(p[E])));
    mx[2] = fmaxf(mx[2], fabsf(to_f(p[2 * E])));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    if (lane == 0) red[warp * 3 + j] = mx[j];
  }
  __syncthreads();
  float sc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float m = red[j];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w * 3 + j]);
    sc[j] = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
  }

  const float ts = __fmul_rn(__fmul_rn(sc[0], sc[1]), scale);
  const float sv = sc[2];
  const int g = lane >> 2, t = lane & 3;
  int8_t* ex = sm + L.ex + (size_t)warp * 16 * L.lde;

  if (!L.chunked) {
    // 2. resident: q8, k8 and vT of all rows; each warp takes 16-row tiles
    load_qk(base, ld, E, S, D, L.SP, L.ldq, L.DP, sc[0], sc[1], q8, k8);
    load_vt(base + 2 * E, ld, S, D, 0, L.SP, L.ldv, sc[2], vt);
    __syncthreads();
    for (int qt = warp; qt < (S + 15) / 16; qt += WARPS) {
      const int qr0 = qt * 16;
      const int row_lo = qr0 + g, row_hi = row_lo + 8;
      float m_lo = -INFINITY, m_hi = -INFINITY;
      row_max(q8, k8, L, qr0, row_lo, row_hi, 0, L.SP, ts, valid, causal, g, t, m_lo, m_hi);
      quad_max(m_lo, m_hi);
      int n_lo = 0, n_hi = 0;
      float f_lo = 0.0f, f_hi = 0.0f;
      for (int d0 = 0; d0 < D; d0 += 64) {
        int acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
        ex_av(q8, k8, vt, ex, L, qr0, row_lo, row_hi, 0, L.SP, d0, D, m_lo, m_hi, ts, valid,
              causal, d0 == 0, g, t, n_lo, n_hi, acc);
        if (d0 == 0) {  // the first pass has seen every key: the norms are complete
          quad_sum(n_lo, n_hi);
          f_lo = __fdiv_rn(sv, fmaxf((float)n_lo, 1.0f));
          f_hi = __fdiv_rn(sv, fmaxf((float)n_hi, 1.0f));
        }
        write_out(obase, acc, f_lo, f_hi, row_lo, row_hi, d0, D, S, E, t);
      }
    }
    return;
  }

  // 2. chunked: query groups of QG rows, one a block (blockIdx.z)
  for (int g0 = blockIdx.z * L.QG; g0 < S; g0 += gridDim.z * L.QG) {
    __syncthreads();  // every warp is done with the previous group's q8
    load_rows(base, ld, S, D, g0, L.QG, L.ldq, L.DP, sc[0], q8);
    // warp w owns rows 16w .. 16w + 15 of the group; keys in chunks
    // of KC, quantized as they are loaded, once per pass
    const int qr0 = warp * 16;
    const int row_lo = g0 + qr0 + g, row_hi = row_lo + 8;
    const bool active = g0 + qr0 < S;  // warp-uniform
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int kc0 = 0; kc0 < L.SP; kc0 += L.KC) {
      const int n = min(L.KC, L.SP - kc0);
      __syncthreads();  // every warp is done with the previous chunk
      load_rows(base + E, ld, S, D, kc0, n, L.ldq, L.DP, sc[1], k8);
      __syncthreads();
      if (active)
        row_max(q8, k8, L, qr0, row_lo, row_hi, kc0, n, ts, valid, causal, g, t, m_lo, m_hi);
    }
    quad_max(m_lo, m_hi);
    int n_lo = 0, n_hi = 0;
    float f_lo = 0.0f, f_hi = 0.0f;
    int* arow_lo = accs + (qr0 + g) * D;
    int* arow_hi = arow_lo + 8 * D;
    for (int kc0 = 0; kc0 < L.SP; kc0 += L.KC) {
      const int n = min(L.KC, L.SP - kc0);
      const bool last = kc0 + n >= L.SP;
      __syncthreads();
      load_rows(base + E, ld, S, D, kc0, n, L.ldq, L.DP, sc[1], k8);
      load_vt(base + 2 * E, ld, S, D, kc0, n, L.ldv, sc[2], vt);
      __syncthreads();
      if (!active) continue;
      for (int d0 = 0; d0 < D; d0 += 64) {
        // the partial sums of the earlier chunks (this thread's own elements)
        int acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = d0 + j * 8 + 2 * t;
          const bool in = kc0 > 0 && col < D;
          acc[j][0] = in ? arow_lo[col] : 0;
          acc[j][1] = in ? arow_lo[col + 1] : 0;
          acc[j][2] = in ? arow_hi[col] : 0;
          acc[j][3] = in ? arow_hi[col + 1] : 0;
        }
        ex_av(q8, k8, vt, ex, L, qr0, row_lo, row_hi, kc0, n, d0, D, m_lo, m_hi, ts, valid,
              causal, d0 == 0, g, t, n_lo, n_hi, acc);
        if (!last) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = d0 + j * 8 + 2 * t;
            if (col >= D) break;
            arow_lo[col] = acc[j][0];
            arow_lo[col + 1] = acc[j][1];
            arow_hi[col] = acc[j][2];
            arow_hi[col + 1] = acc[j][3];
          }
          continue;
        }
        if (d0 == 0) {  // the last chunk's first pass completes the norms
          quad_sum(n_lo, n_hi);
          f_lo = __fdiv_rn(sv, fmaxf((float)n_lo, 1.0f));
          f_hi = __fdiv_rn(sv, fmaxf((float)n_hi, 1.0f));
        }
        write_out(obase, acc, f_lo, f_hi, row_lo, row_hi, d0, D, S, E, t);
      }
    }
  }
}

template <typename TI, typename TO>
int launch(const void* qkv, void* out, int B, int S, int H, int D, int valid, bool causal,
           float scale, cudaStream_t stream) {
  const Layout L = Layout::choose(S, D);
  cudaError_t err = cudaFuncSetAttribute(mha_rows_int8_kernel<TI, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, L.chunked ? (S + L.QG - 1) / L.QG : 1);
  mha_rows_int8_kernel<TI, TO><<<grid, NTHREADS, L.total, stream>>>(
      (const TI*)qkv, (TO*)out, S, H, D, valid, causal, scale, L.QG, L.KC);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. D must be a multiple of 8 and at
// most 256. A shape whose smallest layout exceeds the shared memory of a
// block is refused by cudaFuncSetAttribute, and the error is returned; the
// wrapper refuses it before the call.
extern "C" int qtt_mha_rows_int8(const void* qkv, void* out, int B, int S, int H, int D,
                                 int valid, int causal, float scale, int in_dtype, int out_dtype,
                                 void* stream) {
  if (D % 8 != 0 || D > 256 || valid < 1 || valid > S || B > MAX_GRID_Y || H < 1)
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
