// K5: the weight-only product, out(M, N) f32 =
//   bf16(A) . bf16((W + z[n]) * s[n]) + bias[n]
// with A (M, K) float32 or bf16 activations and W (K, N) int8 weights with
// per-out-channel scale s and zero z. The weight is dequantized in float32
// ((w + z) * s, __fadd_rn / __fmul_rn) and rounded to bf16 in shared memory,
// so the float weight never reaches device memory; A is rounded to bf16
// (__floats2bfloat162_rn) as its register fragments are formed, so no bf16
// copy of A is stored either. The bf16 products are exact in float32 and
// summed in float32 on the tensor cores; the epilogue adds the bias in
// float32.
//
// Replaces the Pallas kernel quantize_tpu/ops/pallas/qmatmul.py:_wo_kernel
// for a bf16 operand (its body dequantizes the int8 tile in f32, casts it to
// the activation dtype and runs one f32-accumulated dot per K block). The
// Pallas grid carried the accumulator across K blocks in VMEM scratch; here
// K is a loop inside the block.
//
// Design for Hopper. A block computes a 128 x 256 output tile with three
// warpgroups, handing off through mbarriers in shared memory. A ring of
// STAGES stages holds the A tile (128 x 64 as stored, by TMA in the
// 128-byte swizzle, zeros past the edges) and the int8 W tile (64 x 256, a
// quarter of a bf16 weight, by 16-byte cp.async zero-filled past the
// edges); rows that are not 16-byte aligned take plain loads and stores.
// * The dequantize warpgroup issues A's TMA and turns each int8 W stage,
//   once, into a bf16 B tile in the 128-byte swizzled K-major layout that
//   wgmma's shared-memory descriptor reads (two B tiles alternate).
// * Two consumer warpgroups, 64 rows each, refill the W stages, form their
//   A fragments from the A stage in registers (f32 -> bf16 there) and issue
//   wgmma.m64n256k16 with A from registers and B from shared memory.
// Issuing a wgmma holds its warpgroup for about the tensor cores' time, so
// the dequantize runs in a warpgroup of its own and overlaps them. Every
// role fits in the 168 registers a thread of a 384-thread block has.
// Shared memory at f32 A: 3 stages x 48 KB + 2 B tiles x 32 KB = 208 KB.
//
// On the H100 the ViT-B/32 projections at batch 256 (M = 14,336; K x N =
// 768 x 768, 768 x 3072, 3072 x 768) do 2*M*N*K bf16 flops (~2.4 TFLOP per
// forward over 73 launches, ~2.5 ms at 989 TFLOP/s) against ~0.2 GB moved
// (A read once, the f32 output written once): bound by operations, at
// 768 x 768 by the output's bytes.
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace qtt;

namespace {

constexpr int BM = 128;                 // rows per block (two consumer warpgroups)
constexpr int BN = 256;                 // columns per block
constexpr int BK = 64;                  // K per stage
constexpr int STAGES = 3;               // shared-memory ring depth
constexpr int NBUF = 2;                 // bf16 B tiles in rotation
constexpr int CONSUMERS = 256;          // warpgroups 0 and 1
constexpr int LOADERS = 128;            // warpgroup 2: A's TMA and the dequantize
constexpr int NTHREADS = CONSUMERS + LOADERS;
constexpr int W_BYTES = BK * BN;        // one int8 W stage: 64 rows of 256 bytes
constexpr int B_BYTES = BN * BK * 2;    // one bf16 B tile: 256 rows (n) of 128 bytes (k)
constexpr int NACC = BN / 2;            // accumulators per consumer thread (m64n256)
constexpr int MAX_GRID_Y = 65535;
static_assert(CONSUMERS == BN, "one consumer thread loads each column's bias");
static_assert(LOADERS * 16 == BK * BN / 8, "a loader dequantizes 8 k x 16 n");

// one A stage: BM rows of BK elements as stored, as 128-byte-wide boxes (one
// for bf16, two for f32: k = 0 .. 31 and 32 .. 63), each BM rows of 128
// bytes in the 128-byte swizzle that TMA writes
template <typename T>
struct ATile {
  static constexpr int CHUNKS = BK * (int)sizeof(T) / 16;  // 16-byte chunks per row
  static constexpr int EPC = 16 / (int)sizeof(T);          // elements per chunk
  static constexpr int BOX_K = 128 / (int)sizeof(T);       // elements per box row
  static constexpr int BOXES = BK / BOX_K;
  static constexpr int BYTES = BM * BK * (int)sizeof(T);
};

// shared memory: B tiles, A stages, W stages (all on 1,024-byte boundaries),
// then the barriers and the block's bias
struct Bars {
  uint64_t full[STAGES];    // A and W of a stage landed (consumers' W copies + A's TMA bytes)
  uint64_t aempty[STAGES];  // the consumers hold a stage's A fragments
  uint64_t bfull[NBUF];     // a B tile is written
  uint64_t bempty[NBUF];    // the wgmmas reading a B tile are retired
};

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)NBUF * B_BYTES + (size_t)STAGES * (ATile<T>::BYTES + W_BYTES) + sizeof(Bars) +
         BN * sizeof(float) + 1024;  // + alignment slack
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// -- layouts and conversions -----------------------------------------------------

// two floats rounded to bf16 (one cvt.rn.bf16x2.f32), the first in the low
// half (the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// signed byte j of w as a float, exactly, without the conversion unit: the
// byte (offset by 128) becomes the low mantissa bits of 2^23, and one exact
// subtraction removes 2^23 + 128
__device__ __forceinline__ float byte_to_float(uint32_t w_offset128, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w_offset128, 0x4B000000u, 0x7440u + j)),
                   8388736.0f);
}

// A stage: 16-byte chunk c of row r (c = 0 .. CHUNKS - 1) lies in box c / 8,
// row r, at chunk (c % 8) ^ (r & 7) of the box row (TMA's 128-byte
// swizzle), so the fragment reads of eight rows fall on distinct banks
__device__ __forceinline__ int a_offset(int r, int c) {
  return (c >> 3) * (BM * 128) + r * 128 + (((c & 7) ^ (r & 7)) * 16);
}

// the bf16 pair (row r, columns k, k + 1) of an A stage, k even
__device__ __forceinline__ uint32_t a_pair(const uint8_t* as, int r, int k, float) {
  const float2 v = *reinterpret_cast<const float2*>(as + a_offset(r, k >> 2) + (k & 3) * 4);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t a_pair(const uint8_t* as, int r, int k, __nv_bfloat16) {
  return *reinterpret_cast<const uint32_t*>(as + a_offset(r, k >> 3) + (k & 7) * 2);
}

// The A fragments of one warp for the stage's four k16 steps: rows
// row0 + g and row0 + g + 8, columns 16 * kk + 2t (+ 1) and + 8 (the
// wgmma m64k16 register layout).
template <typename T>
__device__ __forceinline__ void load_a(const uint8_t* as, int row0, int g, int t,
                                       uint32_t (&af)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int k = kk * 16 + 2 * t;
    af[kk][0] = a_pair(as, row0 + g, k, T());
    af[kk][1] = a_pair(as, row0 + g + 8, k, T());
    af[kk][2] = a_pair(as, row0 + g, k + 8, T());
    af[kk][3] = a_pair(as, row0 + g + 8, k + 8, T());
  }
}

// W stage: row k's 16-byte chunk c (columns 16c .. 16c + 15) sits at chunk
// c ^ ((k >> 3) & 7): the dequantize's 16-byte reads of a warp (eight k
// octets x four column chunks) fall on every bank equally.
__device__ __forceinline__ int w_offset(int k, int c) { return k * BN + ((c ^ ((k >> 3) & 7)) * 16); }

// B tile, 128-byte swizzled K-major: row n (128 bytes, k = 0 .. 63) with its
// 16-byte chunk j (k = 8j .. 8j + 7) at chunk j ^ (n & 7); 8-row atoms of
// 1,024 bytes, so the wgmma descriptor's stride byte offset is 1,024.
__device__ __forceinline__ int b_offset(int n, int j) { return n * 128 + ((j ^ (n & 7)) * 16); }

// Dequantizes a loader's 8 k x 16 n of the int8 stage into the bf16 B tile:
// rows ko*8 .. + 7 of W (the k octet ko), columns co*16 .. + 15 (the column
// chunk co); k rows at or past kvalid are zeros (the ragged K edge). Eight
// 16-byte loads, 128 dequantized values, sixteen 16-byte stores.
__device__ __forceinline__ void dequant(const uint8_t* ws, uint8_t* bt, int ko, int co, int kvalid,
                                        const float (&z)[16], const float (&s)[16]) {
  uint32_t wv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(ws + w_offset(ko * 8 + i, co));
    wv[i][0] = v.x ^ 0x80808080u;
    wv[i][1] = v.y ^ 0x80808080u;
    wv[i][2] = v.z ^ 0x80808080u;
    wv[i][3] = v.w ^ 0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t h[4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const float lo = __fmul_rn(__fadd_rn(byte_to_float(wv[i][j >> 2], j & 3), z[j]), s[j]);
      const float hi = __fmul_rn(__fadd_rn(byte_to_float(wv[i + 1][j >> 2], j & 3), z[j]), s[j]);
      h[i / 2] = pack_bf16(i < kvalid ? lo : 0.0f, i + 1 < kvalid ? hi : 0.0f);
    }
    *reinterpret_cast<uint4*>(bt + b_offset(co * 16 + j, ko)) = make_uint4(h[0], h[1], h[2], h[3]);
  }
}

// -- the tensor-core product -----------------------------------------------------

// D(64 x 256) = A(64 x 16, registers) . B(16 x 256, shared memory) (+ D if
// accumulate): the first product of a tile clears the accumulators, so no
// other instruction ever writes them
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[NACC], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- the ring ------------------------------------------------------------------

// the first n (<= EPC) elements of a chunk from p, zeros after them
__device__ __forceinline__ uint4 masked_chunk(const float* p, int n) {
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? __float_as_uint(p[e]) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint4 masked_chunk(const __nv_bfloat16* p, int n) {
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < n ? (uint32_t)__bfloat16_as_ushort(p[e]) : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                    h[6] | (h[7] << 16));
}
__device__ __forceinline__ uint4 masked_chunk(const int8_t* p, int n) {
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < n) b[e >> 2] |= (uint32_t)(uint8_t)p[e] << (8 * (e & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// Fills the A part of stage kt of the ring (loader lt of LOADERS): rows
// m0 .. + BM at k0 = kt * BK, by TMA (loader 0) where A's map exists,
// otherwise by plain loads and stores of all loaders. Loader 0 arrives on
// the stage's barrier once, after every A byte is in place or expected.
template <typename T>
__device__ __forceinline__ void fill_a(int kt, const T* __restrict__ a, const CUtensorMap* a_map,
                                       int M, int K, int m0, bool a_tma, uint8_t* sm, Bars& bars,
                                       int lt) {
  using AT = ATile<T>;
  const int st = kt % STAGES;
  uint8_t* as = sm + NBUF * B_BYTES + st * AT::BYTES;
  const int k0 = kt * BK;
  if (a_tma) {
    if (lt == 0) {
      mbar_arrive_expect_tx(&bars.full[st], AT::BYTES);
#pragma unroll
      for (int b = 0; b < AT::BOXES; ++b)
        tma_load_2d(as + b * (BM * 128), a_map, k0 + b * AT::BOX_K, m0, &bars.full[st]);
    }
    return;
  }
#pragma unroll 1
  for (int q = lt; q < BM * AT::CHUNKS; q += LOADERS) {
    const int r = q / AT::CHUNKS, c = q % AT::CHUNKS;
    const int m = m0 + r, k = k0 + c * AT::EPC;
    *reinterpret_cast<uint4*>(as + a_offset(r, c)) =
        masked_chunk(a + (int64_t)m * K + k, m < M ? max(0, min(AT::EPC, K - k)) : 0);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(LOADERS) : "memory");
  if (lt == 0) mbar_arrive(&bars.full[st]);
}

// Fills the W part of stage kt of the ring (consumer ct of CONSUMERS):
// columns n0 .. + BN of rows k0 .. + BK, by 16-byte cp.async where W's rows
// are aligned (four per consumer), otherwise by plain loads and stores.
// Every consumer arrives on the stage's barrier once.
template <typename T>
__device__ __forceinline__ void fill_w(int kt, const int8_t* __restrict__ w, int N, int K, int n0,
                                       bool w_async, uint8_t* sm, Bars& bars, int ct) {
  const int st = kt % STAGES;
  uint8_t* ws = sm + NBUF * B_BYTES + STAGES * ATile<T>::BYTES + st * W_BYTES;
  const int k0 = kt * BK;
#pragma unroll
  for (int q = ct; q < BK * BN / 16; q += CONSUMERS) {
    const int r = q / (BN / 16), c = q % (BN / 16);
    const int k = k0 + r, n = n0 + c * 16;
    const int8_t* src = w + (int64_t)k * N + n;
    if (w_async) {
      const bool ok = k < K && n < N;  // N is a multiple of 16 here
      cp_async16(ws + w_offset(r, c), ok ? src : w, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(ws + w_offset(r, c)) =
          masked_chunk(src, k < K ? max(0, min(16, N - n)) : 0);
    }
  }
  if (w_async) {
    cp_async_arrive(&bars.full[st]);
  } else {
    mbar_arrive(&bars.full[st]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    wo_gemm_kernel(const T* __restrict__ a, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ w_zero,
                   const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
                   const __grid_constant__ CUtensorMap a_map, bool a_tma, bool w_async,
                   bool out_vec2) {
  extern __shared__ uint8_t smem_raw[];
  // B tiles first, on a 1,024-byte boundary (the 128-byte swizzle's atom)
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  Bars& bars = *reinterpret_cast<Bars*>(sm + NBUF * B_BYTES + STAGES * (ATile<T>::BYTES + W_BYTES));
  float* bias_s = reinterpret_cast<float*>(&bars + 1);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bars.full[i], CONSUMERS + 1);  // the W copies and loader 0's A
      mbar_init(&bars.aempty[i], CONSUMERS);
    }
    for (int i = 0; i < NBUF; ++i) {
      mbar_init(&bars.bfull[i], LOADERS);
      mbar_init(&bars.bempty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CONSUMERS) {
    const int n = n0 + tid;
    bias_s[tid] = bias != nullptr && n < N ? bias[n] : 0.0f;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the dequantize warpgroup: A's refills, and each W stage into a B tile
    const int lt = tid - CONSUMERS;
    const int ko = lt & 7, co = lt >> 3;  // this loader's k octet and 16-column chunk
    float z[16], s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + co * 16 + j;
      z[j] = n < N ? w_zero[n] : 0.0f;
      s[j] = n < N ? w_scale[n] : 0.0f;
    }
    for (int kt = 0; kt < STAGES && kt < nk; ++kt)
      fill_a<T>(kt, a, &a_map, M, K, m0, a_tma, sm, bars, lt);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % STAGES, b = kt % NBUF;
      mbar_wait(&bars.full[st], (kt / STAGES) & 1);
      mbar_wait(&bars.bempty[b], ((kt / NBUF) & 1) ^ 1);
      dequant(sm + NBUF * B_BYTES + STAGES * ATile<T>::BYTES + st * W_BYTES,
              sm + b * B_BYTES, ko, co, K - (kt * BK + ko * 8), z, s);
      // these B writes, visible to the tensor cores' (async) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&bars.bfull[b]);
      // refill the A of the stage before once the consumers hold its
      // fragments (the consumers refill its W)
      const int kp = kt - 1;
      if (kp >= 0 && kp + STAGES < nk) {
        mbar_wait(&bars.aempty[kp % STAGES], (kp / STAGES) & 1);
        fill_a<T>(kp + STAGES, a, &a_map, M, K, m0, a_tma, sm, bars, lt);
      }
    }
    return;
  }

  // the consumer warpgroups: rows 64 * wg .. + 63 of the tile
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16;
  float acc[NACC];  // written only by the wgmmas (the first one clears them)
  uint32_t af[4][4];
  for (int kt = 0; kt < STAGES && kt < nk; ++kt) fill_w<T>(kt, w, N, K, n0, w_async, sm, bars, tid);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES, b = kt % NBUF;
    mbar_wait(&bars.full[st], (kt / STAGES) & 1);
    load_a<T>(sm + NBUF * B_BYTES + st * ATile<T>::BYTES, row0, g, t, af);
    mbar_arrive(&bars.aempty[st]);
    mbar_wait(&bars.bfull[b], (kt / NBUF) & 1);
    // the loaders are past this stage's W: refill it, STAGES steps ahead
    if (kt + STAGES < nk) fill_w<T>(kt + STAGES, w, N, K, n0, w_async, sm, bars, tid);
    // a k16 step is 32 bytes further into the swizzled rows (+2 in 16-byte units)
    const uint64_t d0 = sw128_desc(sm + b * B_BYTES), d1 = d0 + 2, d2 = d0 + 4, d3 = d0 + 6;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_m64n256k16(acc, af[0], d0, kt > 0);
    wgmma_m64n256k16(acc, af[1], d1, 1);
    wgmma_m64n256k16(acc, af[2], d2, 1);
    wgmma_m64n256k16(acc, af[3], d3, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    mbar_arrive(&bars.bempty[b]);
  }
  fence_acc(acc);

  // epilogue: acc[4j + r] is row row0 + g (+ 8 for r >= 2), column
  // n0 + 8j + 2t (+ 1 for odd r)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nl = j * 8 + 2 * t;
    const int n = n0 + nl;
    if (n >= N) continue;
    const float b0 = bias_s[nl], b1 = bias_s[nl + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row0 + g + 8 * h;
      if (m >= M) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      float* o = out + (int64_t)m * N + n;
      if (out_vec2) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (n + 1 < N) o[1] = v1;
      }
    }
  }
}

// The TMA map of A (M x K, row-major): 128-byte-wide boxes of BM rows, the
// 128-byte swizzle, zeros past the edges. False where TMA cannot take A
// (a row or base not 16-byte aligned) or the encoder is missing.
template <typename T>
bool a_tensor_map(CUtensorMap* map, const void* a, int M, int K) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr || !aligned16(a) || ((int64_t)K * sizeof(T)) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)ATile<T>::BOX_K, (cuuint32_t)BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(a), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T>
int launch(const void* a, const void* w, const void* w_scale, const void* w_zero, const void* bias,
           void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap a_map = {};
  const bool a_tma = a_tensor_map<T>(&a_map, a, M, K);
  // 16-byte copies of W need every row start aligned
  const bool w_async = N % 16 == 0 && aligned16(w);
  const bool out_vec2 = N % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7u) == 0;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(wo_gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wo_gemm_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      (const T*)a, (const int8_t*)w, (const float*)w_scale, (const float*)w_zero,
      (const float*)bias, (float*)out, M, N, K, a_map, a_tma, w_async, out_vec2);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 activations. bias may be NULL.
extern "C" int qtt_wo_gemm(const void* a, const void* w, const void* w_scale, const void* w_zero,
                           const void* bias, void* out, int M, int N, int K, int in_dtype,
                           void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0) return launch<float>(a, w, w_scale, w_zero, bias, out, M, N, K, s);
  if (in_dtype == 1) return launch<__nv_bfloat16>(a, w, w_scale, w_zero, bias, out, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
