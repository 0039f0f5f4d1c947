// Reading KV-cache rows, shared by attention.cu and layer_fused.cu: a
// lane's ND contiguous elements of a row in one vector load, widened to
// f32 from an f32, bf16 or int8 cache.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename CT, int ND>
struct alignas(sizeof(CT) * ND) Slice {
  CT v[ND];
};

template <typename CT, int ND>
__device__ __forceinline__ void load_slice(const CT* row, int lane,
                                           float (&out)[ND]) {
  const Slice<CT, ND> s =
      *reinterpret_cast<const Slice<CT, ND>*>(row + lane * ND);
#pragma unroll
  for (int i = 0; i < ND; ++i) out[i] = to_f(s.v[i]);
}

}  // namespace
