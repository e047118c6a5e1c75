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
// keeps every (S, S) score block in VMEM. Here one block owns
// (image, head, QT query rows): the QT x S score tile lives in shared
// memory, so the scores never reach device memory either, and that head's
// K (then V) streams through shared memory in chunks of KCHUNK keys. Shared
// memory is KCHUNK x D for the chunk, QT x D for q and QT x S for the
// scores. Two tilings, chosen per shape by the launcher (Tiling):
// * wide: QT = 32 rows, KCHUNK = 224 keys (4 rows x 7 keys a thread), 184 KB
//   at S = 776, D = 64; it takes every S up to 1,120 at D <= 80;
// * narrow, for every shape the wide one does not fit: QT = 16 rows,
//   KCHUNK = 64 keys (2 rows x 2 keys a thread), 165 KB at S = 1,280,
//   D = 256, so every head dim up to 256 at every S the JAX dispatch
//   admits fits (the wrapper refuses larger head dims).
// Each score and each output sums its products in the same order whatever
// the tiling. Pad query rows (row >= valid_len) come out
// finite: without causal they attend to the valid keys; with causal every
// key is masked, m = -80, ex = 0 and the output is 0 / 1e-37 = 0.
//
// On the H100 at ViT-B/16 shapes (S = 200, D = 64, B = 128, 12 heads) the
// work is 4*B*H*S*S*D flops against a read of (B*S, 3E) and a write of
// (B*S, E): bound by operations. The products run on the float32 CUDA cores
// (both carries: bf16 operands are exact in float32, and the f32 carry must
// not use TF32), register-blocked as RPW query rows x KPL keys per thread
// for q.k and RPW rows x 2 columns for ex.v, fed by 16-byte shared-memory
// reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;
constexpr int DPAD = 4;                // shared row padding (16-byte reads, no bank conflicts)
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block may use (227 KB)

// A tiling: RPW query rows per warp (QT = 8 * RPW per block) and KPL keys
// per lane of a score chunk (KCHUNK = 32 * KPL keys)
template <int RPW, int KPL>
struct Tiling {
  static constexpr int QT = WARPS * RPW;
  static constexpr int KCHUNK = 32 * KPL;
  static __host__ __device__ int keys_padded(int S) { return (S + KCHUNK - 1) / KCHUNK * KCHUNK; }
  // Mirrored by quantize_tpu_torch/ops/attention.py: _mha_rows_smem.
  static size_t smem_bytes(int S, int D) {
    return sizeof(float) * ((size_t)(KCHUNK + QT) * (D + DPAD) + (size_t)QT * keys_padded(S) + QT);
  }
};
using Wide = Tiling<4, 7>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copies rows [j0, j0 + KCHUNK) of one D-wide slice of the qkv rows into
// shared memory (row stride D + DPAD), zero-filling rows from S on.
template <int KCHUNK, typename TI>
__device__ __forceinline__ void load_chunk(const TI* __restrict__ src, int64_t ld, int S, int j0,
                                           int D, float* __restrict__ dst) {
  const int ds = D + DPAD;
  for (int i = threadIdx.x; i < KCHUNK * D; i += NTHREADS) {
    const int j = i / D;
    const int c = i - j * D;
    dst[j * ds + c] = j0 + j < S ? to_f(src[(int64_t)(j0 + j) * ld + c]) : 0.0f;
  }
}

template <typename TI, typename TO, int RPW, int KPL>
__global__ void __launch_bounds__(NTHREADS)
    mha_rows_kernel(const TI* __restrict__ qkv, TO* __restrict__ out, int S, int H, int D,
                    int valid, bool causal, float scale) {
  using TL = Tiling<RPW, KPL>;
  constexpr int QT = TL::QT;
  constexpr int KCHUNK = TL::KCHUNK;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ds = D + DPAD;
  const int sk = TL::keys_padded(S);
  float* kv = sm;                      // [KCHUNK][ds]: a chunk of K, then of V
  float* qs = kv + KCHUNK * ds;        // [QT][ds]
  float* ps = qs + QT * ds;            // [QT][sk]: scores, then mm(ex)
  float* nrm = ps + QT * sk;           // [QT]

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int E = H * D;
  const int64_t ld = 3 * (int64_t)E;
  const TI* base = qkv + (int64_t)blockIdx.z * S * ld + (int64_t)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RPW;

  // q tile, scaled in float32 and rounded to the product dtype
  for (int i = threadIdx.x; i < QT * D; i += NTHREADS) {
    const int r = i / D;
    const int c = i - r * D;
    float v = 0.0f;
    if (q0 + r < S) v = mm_round<TI>(__fmul_rn(to_f(base[(int64_t)(q0 + r) * ld + c]), scale));
    qs[r * ds + c] = v;
  }

  // scores: each thread RPW rows x KPL keys (key = chunk + lane + 32 * i)
  for (int j0 = 0; j0 < sk; j0 += KCHUNK) {
    __syncthreads();  // every warp is done with the previous chunk
    load_chunk<KCHUNK>(base + E, ld, S, j0, D, kv);
    __syncthreads();
    float acc[RPW][KPL];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
      for (int i = 0; i < KPL; ++i) acc[rr][i] = 0.0f;
    for (int k = 0; k < D; k += 4) {
      float4 qv[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr)
        qv[rr] = *reinterpret_cast<const float4*>(qs + (r0 + rr) * ds + k);
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kv + (lane + 32 * i) * ds + k);
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          acc[rr][i] = fmaf(qv[rr].x, kv4.x, acc[rr][i]);
          acc[rr][i] = fmaf(qv[rr].y, kv4.y, acc[rr][i]);
          acc[rr][i] = fmaf(qv[rr].z, kv4.z, acc[rr][i]);
          acc[rr][i] = fmaf(qv[rr].w, kv4.w, acc[rr][i]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
      for (int i = 0; i < KPL; ++i) ps[(r0 + rr) * sk + j0 + lane + 32 * i] = acc[rr][i];
  }
  __syncwarp();

  // softmax of the warp's own rows
  const bool masked = causal || valid < S;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r0 + rr;
    const int row = q0 + r;
    float* pr = ps + r * sk;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      float sc = pr[j];
      if (masked) {
        bool ok = j < valid;
        if (causal) ok = j <= row && (valid >= S || (j < valid && row < valid));
        sc = fminf(sc, ok ? 3e38f : -1e30f);
        pr[j] = sc;
      }
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(warp_max(mx), -80.0f);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(__fsub_rn(pr[j], mx));
      sum = __fadd_rn(sum, e);
      pr[j] = mm_round<TI>(e);
    }
    for (int j = S + lane; j < sk; j += 32) pr[j] = 0.0f;
    sum = warp_sum(sum);
    if (lane == 0) nrm[r] = fmaxf(sum, 1e-37f);
  }

  // out = (ex . v) / norm: each thread RPW rows x 2 neighbouring columns,
  // V streamed in chunks (every thread takes part in the loads, so lanes
  // past D skip only the products and the stores)
  const int s4 = (S + 3) & ~3;  // ex is zero past S (and V rows too)
  for (int c0 = 0; c0 < D; c0 += 64) {
    const int c = c0 + 2 * lane;
    const bool active = c < D;
    float acc[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) acc[rr][0] = acc[rr][1] = 0.0f;
    for (int j0 = 0; j0 < s4; j0 += KCHUNK) {
      __syncthreads();  // every warp is done with K or the previous V chunk
      load_chunk<KCHUNK>(base + 2 * E, ld, S, j0, D, kv);
      __syncthreads();
      if (!active) continue;
      const int j1 = min(s4, j0 + KCHUNK);
      for (int j = j0; j < j1; j += 4) {
        float4 pv[RPW];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          pv[rr] = *reinterpret_cast<const float4*>(ps + (r0 + rr) * sk + j);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 vv = *reinterpret_cast<const float2*>(kv + (j - j0 + t) * ds + c);
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr) {
            const float p = t == 0 ? pv[rr].x : t == 1 ? pv[rr].y : t == 2 ? pv[rr].z : pv[rr].w;
            acc[rr][0] = fmaf(p, vv.x, acc[rr][0]);
            acc[rr][1] = fmaf(p, vv.y, acc[rr][1]);
          }
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int row = q0 + r0 + rr;
      if (row >= S) continue;
      const float n = nrm[r0 + rr];
      TO* o = out + ((int64_t)blockIdx.z * S + row) * E + (int64_t)h * D + c;
      put(o, __fdiv_rn(acc[rr][0], n));
      put(o + 1, __fdiv_rn(acc[rr][1], n));
    }
  }
}

template <typename TI, typename TO, int RPW, int KPL>
int launch_tiled(const void* qkv, void* out, int B, int S, int H, int D, int valid, bool causal,
                 float scale, cudaStream_t stream) {
  using TL = Tiling<RPW, KPL>;
  const size_t smem = TL::smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(mha_rows_kernel<TI, TO, RPW, KPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + TL::QT - 1) / TL::QT, H, B);
  mha_rows_kernel<TI, TO, RPW, KPL><<<grid, NTHREADS, smem, stream>>>(
      (const TI*)qkv, (TO*)out, S, H, D, valid, causal, scale);
  return (int)cudaGetLastError();
}

// the wide tiling where it fits, else the narrow one
template <typename TI, typename TO>
int launch(const void* qkv, void* out, int B, int S, int H, int D, int valid, bool causal,
           float scale, cudaStream_t stream) {
  if (Wide::smem_bytes(S, D) <= SMEM_LIMIT)
    return launch_tiled<TI, TO, 4, 7>(qkv, out, B, S, H, D, valid, causal, scale, stream);
  return launch_tiled<TI, TO, 2, 2>(qkv, out, B, S, H, D, valid, causal, scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. D must be a multiple of 4. A
// shape whose narrow tiles exceed the shared memory of a block (S above
// 2,400 at D = 256) is refused by cudaFuncSetAttribute, and the error is
// returned; the wrapper refuses it, and every D above 256, before the call.
extern "C" int qtt_mha_rows(const void* qkv, void* out, int B, int S, int H, int D, int valid,
                            int causal, float scale, int in_dtype, int out_dtype,
                            void* stream) {
  if (D % 4 != 0 || D > 256 || valid < 1 || valid > S || B > 65535 || H > 65535)
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
