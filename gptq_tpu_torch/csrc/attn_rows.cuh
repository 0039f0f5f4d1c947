// Device helpers of the slot-parallel decode attention, shared by
// attention_partial.cu (#2 / #3, #10 / #11) and layer_stream.cuh (the
// attention phase of #12): K / V rows staged in shared memory by 16-byte
// cp.async, read back as floats, and scored against q by lanes that each
// own whole 16-byte vectors of a row.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// a 32-bit word of a staged row as floats: 4 int8, 2 bf16 or 1 f32
__device__ __forceinline__ void widen(uint32_t w, float* f, int8_t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = (float)((int)(w << (24 - 8 * j)) >> 24);
}
__device__ __forceinline__ void widen(uint32_t w, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void widen(uint32_t w, float* f, float) {
  f[0] = __uint_as_float(w);
}

// part `part` of the dot of q (f32, shared memory) and a staged row of hd
// elements split over `parts` lanes: the row's 16-byte vectors part, part
// + parts, ... (interleaved, so the lanes of a slot read neighbouring
// vectors: no bank conflict)
template <typename CT>
__device__ __forceinline__ float row_dot(const float* q,
                                         const unsigned char* row, int hd,
                                         int part, int parts) {
  constexpr int PW = 4 / sizeof(CT);  // elements a word
  constexpr int PV = 4 * PW;          // elements a 16-byte vector
  float d0 = 0.f, d1 = 0.f;
  for (int i = part * PV; i < hd; i += parts * PV) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + i * sizeof(CT));
    float e[PV];
    widen(raw.x, e, CT());
    widen(raw.y, e + PW, CT());
    widen(raw.z, e + 2 * PW, CT());
    widen(raw.w, e + 3 * PW, CT());
#pragma unroll
    for (int j = 0; j < PV; j += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q + i + j);
      d0 += qv.x * e[j] + qv.y * e[j + 1];
      d1 += qv.z * e[j + 2] + qv.w * e[j + 3];
    }
  }
  return d0 + d1;
}

}  // namespace
