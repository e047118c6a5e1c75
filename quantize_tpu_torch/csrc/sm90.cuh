// Hopper (sm_90a) building blocks shared by the port's warp-specialized
// kernels (wo_gemm.cu, qconv2d.cu): mbarriers, cp.async with a barrier
// arrival, TMA loads, the 128-byte-swizzled wgmma shared-memory descriptor
// and the tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap (types only; the encoder comes through the runtime)
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace qtt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrives, and the phase also waits for `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes from global to shared; bytes past src_bytes (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// the barrier sees this thread's arrival once its earlier cp.async are done
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one TMA box of a 2-D map (inner coordinate c0, outer c1) into shared
// memory; what lies past the tensor arrives as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The wgmma shared-memory descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle (row r's 16-byte chunk j at chunk j ^ (r & 7), 8-row
// atoms of 1,024 bytes): start address, leading byte offset 1 (unused by a
// swizzled K-major operand), stride byte offset 1,024, 128-byte swizzle.
// A step of 32 bytes along K adds 2 (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// cuTensorMapEncodeTiled through the runtime (no libcuda link), or nullptr
inline PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  return encode;
}

}  // namespace qtt
