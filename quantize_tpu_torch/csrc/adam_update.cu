// KA: the Adam update of every trainable leaf of an optimizer step in one
// launch (one a chunk of MAX_LEAVES leaves where a step has more).
//
// Replaces no pallas_call: the JAX package leaves optax's update to XLA. The
// port issued it leaf by leaf from Python (optim.py: ScaleByAdam, then
// AddDecayedWeights, ScaleByLearningRate and Scale, then p += u), 16 torch
// ops a leaf, each a launch: 7,552 launches a step over ViT-B/16's 472
// leaves, the card waiting for the host between them.
//
// Bound by bytes: g, p, mu and nu read and p, mu and nu written, 28 bytes an
// element. Each block takes SPAN elements of one leaf. The leaf table (the
// four pointers, the size and the first block of each leaf) travels in the
// launch's own parameters (__grid_constant__: up to 32,764 bytes on sm_90),
// so no table goes through device memory and the host copies nothing; a
// block finds its leaf by binary search over the first blocks. A thread
// loads four float4 of each operand before it computes (16 loads of 16
// bytes in flight); a leaf not 16-byte aligned, and the last n % 4 elements
// of a leaf, take one element at a time.
//
// Numerics: optax's float32 order as optim.py writes it, every operation
// rounded by an intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) so
// that nvcc contracts none into an FMA, bit-equal to the per-leaf torch ops:
//   mu = mu*b1 + g*(1-b1);  nu = nu*b2 + (g*g)*(1-b2)
//   u  = (mu/c1) / (sqrt(nu/c2) + eps)      c1, c2 = 1 - b**count (true divisions)
//   u  = u + wd*p (AdamW);  u = -lr*u;  u = qs*u (Scale);  p = p + u
// The scalars come by value, each rounded to float32 on the host as optim.py
// rounds it. A leaf without a gradient (g NULL) is updated with g = 0.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int UNROLL = 4;                    // float4 of each operand a thread holds at once
constexpr int SPAN = NTHREADS * UNROLL * 4;  // elements a block: 4,096
constexpr int MAX_LEAVES = 640;              // leaves a launch (ops/adam.py: ADAM_CHUNK)

struct Scalars {
  float b1, b2, omb1, omb2, eps, c1, c2, wd, neg_lr, qs;
  int has_wd, has_qs;
};

struct Table {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* mu[MAX_LEAVES];
  float* nu[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int first_block[MAX_LEAVES + 1];  // the leaves' first blocks, then the launch's block count
  int n_leaves;
  Scalars s;
};
static_assert(sizeof(Table) <= 32764, "the leaf table must fit a launch's parameters");

__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  float u = __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps));
  if (s.has_wd) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  u = __fmul_rn(s.neg_lr, u);
  if (s.has_qs) u = __fmul_rn(s.qs, u);
  p = __fadd_rn(p, u);
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      const Scalars& s) {
  adam1(p.x, g.x, m.x, v.x, s);
  adam1(p.y, g.y, m.y, v.y, s);
  adam1(p.z, g.z, m.z, v.z, s);
  adam1(p.w, g.w, m.w, v.w, s);
}

__global__ void __launch_bounds__(NTHREADS) adam_update_kernel(const __grid_constant__ Table t) {
  const Scalars s = t.s;
  // the block's leaf: the last whose first block is at or before this block
  // (a leaf of no elements shares its first block with the next and is passed)
  const int b = (int)blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const long long start = (long long)(b - t.first_block[lo]) * SPAN;
  const long long left = t.n[lo] - start;
  const int count = left < SPAN ? (int)left : SPAN;
  float* p = t.p[lo] + start;
  float* mu = t.mu[lo] + start;
  float* nu = t.nu[lo] + start;
  const float* g = t.g[lo];
  if (g != nullptr) g += start;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(mu) |
                         reinterpret_cast<uintptr_t>(nu) | reinterpret_cast<uintptr_t>(g);
  const int nvec = (addr & 15u) == 0 ? count >> 2 : 0;
  if (nvec > 0) {
    float4 P[UNROLL], G[UNROLL], M[UNROLL], V[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = (int)threadIdx.x + u * NTHREADS;
      if (i < nvec) {
        P[u] = reinterpret_cast<const float4*>(p)[i];
        G[u] = g != nullptr ? reinterpret_cast<const float4*>(g)[i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        M[u] = reinterpret_cast<const float4*>(mu)[i];
        V[u] = reinterpret_cast<const float4*>(nu)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = (int)threadIdx.x + u * NTHREADS;
      if (i < nvec) {
        adam4(P[u], G[u], M[u], V[u], s);
        reinterpret_cast<float4*>(p)[i] = P[u];
        reinterpret_cast<float4*>(mu)[i] = M[u];
        reinterpret_cast<float4*>(nu)[i] = V[u];
      }
    }
  }
  // the last count % 4 elements (or all of a leaf not 16-byte aligned)
  for (int i = 4 * nvec + (int)threadIdx.x; i < count; i += NTHREADS) {
    float pv = p[i], mv = mu[i], vv = nu[i];
    adam1(pv, g != nullptr ? g[i] : 0.f, mv, vv, s);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

}  // namespace

// table: n_leaves records of five 64-bit words each, {p, g, mu, nu, n}: the
// device pointers of a float32 leaf, its gradient (0: none), its two moments,
// and its element count. One launch a chunk of MAX_LEAVES records, on stream.
extern "C" int qtt_adam_update(const long long* table, int n_leaves, float b1, float b2,
                               float omb1, float omb2, float eps, float c1, float c2, float wd,
                               float neg_lr, float qs, int has_wd, int has_qs, void* stream) {
  if (n_leaves < 0 || (n_leaves > 0 && table == nullptr)) return (int)cudaErrorInvalidValue;
  Table t;
  t.s = Scalars{b1, b2, omb1, omb2, eps, c1, c2, wd, neg_lr, qs, has_wd != 0, has_qs != 0};
  for (int first = 0; first < n_leaves; first += MAX_LEAVES) {
    const int k = n_leaves - first < MAX_LEAVES ? n_leaves - first : MAX_LEAVES;
    long long blocks = 0;
    for (int i = 0; i < k; ++i) {
      const long long* r = table + 5LL * (first + i);
      if (r[4] < 0 || (r[4] > 0 && (r[0] == 0 || r[2] == 0 || r[3] == 0)))
        return (int)cudaErrorInvalidValue;
      t.p[i] = reinterpret_cast<float*>(r[0]);
      t.g[i] = reinterpret_cast<const float*>(r[1]);
      t.mu[i] = reinterpret_cast<float*>(r[2]);
      t.nu[i] = reinterpret_cast<float*>(r[3]);
      t.n[i] = r[4];
      t.first_block[i] = (int)blocks;
      blocks += (r[4] + SPAN - 1) / SPAN;
      if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    }
    t.first_block[k] = (int)blocks;
    t.n_leaves = k;
    if (blocks == 0) continue;
    adam_update_kernel<<<(unsigned)blocks, NTHREADS, 0, (cudaStream_t)stream>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
