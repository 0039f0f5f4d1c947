// TMA and mbarrier helpers shared by the tensor-core kernels (qmma.cu,
// qexpert_mma.cu) and the weight streams (layer_stream.cuh, gemv.cuh):
// shared-memory addresses, mbarrier init / expect / arrive / wait, tiled
// bulk-tensor copies and plain bulk copies into shared memory that
// complete on an mbarrier, the proxy fence, and the host-side map encoder
// fetched from the driver at run time.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is fetched from the driver
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a box of a 2-dimensional tensor into shared memory, completing on `bar`
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* m, int c0,
                                      int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
// the same for 3- and 4-dimensional maps
__device__ __forceinline__ void tma3d(void* dst, const CUtensorMap* m, int c0,
                                      int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma4d(void* dst, const CUtensorMap* m, int c0,
                                      int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into this block's shared memory, completing on `bar`: a bulk copy
// that needs no tensor map
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy accesses (st.shared, ld.shared) ordered against the async
// proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

Encode encoder() {  // cuTensorMapEncodeTiled, from the driver at run time
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<Encode>(f);
  }
  return fn;
}

// a tiled TMA map of a rank-r tensor: dims and box innermost first, byte
// strides of dims 1..r-1; boxes past the tensor's edge fill zeros
bool tmap(CUtensorMap* m, CUtensorMapDataType t, int r, const void* base,
          const cuuint64_t* dims, const cuuint64_t* strides,
          const cuuint32_t* box, bool swizzle) {
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const Encode fn = encoder();
  return fn != nullptr &&
         fn(m, t, r, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
