// Word-centric dot products over byteplane-packed codes, shared by
// qmatmul.cu and ffn.cu.
//
// In a field of width FB (ops/pack.py), the 4 bytes of one int32 word hold
// rows 4*j + b (b < 4) of each of the E = 8/FB sub-byte planes of a
// subblock, and those 4 rows are contiguous in x. So a lane that loads a
// word uses every code in it: for plane e, one masked shift yields 4 codes
// (one per byte), met by 4 contiguous activations at xrow + e * quarter
// (quarter = rows per plane in the subblock). An 8-bit field stores
// code - 128; the xor restores the unsigned code.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int dp4a_su(int a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// int8 activations: exact int32 dot, one dp4a per plane
template <int FB>
__device__ __forceinline__ int plane_dot(unsigned word, const int8_t* xs,
                                         int xrow, int quarter, int dot) {
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  if (FB == 8) word ^= 0x80808080u;  // stored code - 128 -> code
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const unsigned cb = (word >> (FB * e)) & BM;
    const int xa = *reinterpret_cast<const int*>(xs + xrow + e * quarter);
    dot = dp4a_su(xa, cb, dot);
  }
  return dot;
}

__device__ __forceinline__ float byte_dot(unsigned cb, float x0, float x1,
                                          float x2, float x3, float dot) {
  return dot + x0 * (float)(cb & 0xffu) + x1 * (float)((cb >> 8) & 0xffu) +
         x2 * (float)((cb >> 16) & 0xffu) + x3 * (float)(cb >> 24);
}

// f32 activations: one float4 of x per plane
template <int FB>
__device__ __forceinline__ float plane_dot(unsigned word, const float* xs,
                                           int xrow, int quarter, float dot) {
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  if (FB == 8) word ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const unsigned cb = (word >> (FB * e)) & BM;
    const float4 xv = *reinterpret_cast<const float4*>(xs + xrow + e * quarter);
    dot = byte_dot(cb, xv.x, xv.y, xv.z, xv.w, dot);
  }
  return dot;
}

// bf16 activations: 4 bf16 values (8 bytes) of x per plane, widened
// exactly to f32 by a shift of their bits
template <int FB>
__device__ __forceinline__ float plane_dot(unsigned word,
                                           const __nv_bfloat16* xs, int xrow,
                                           int quarter, float dot) {
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  if (FB == 8) word ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const unsigned cb = (word >> (FB * e)) & BM;
    const uint2 xv = *reinterpret_cast<const uint2*>(xs + xrow + e * quarter);
    dot = byte_dot(cb, __uint_as_float(xv.x << 16),
                   __uint_as_float(xv.x & 0xffff0000u),
                   __uint_as_float(xv.y << 16),
                   __uint_as_float(xv.y & 0xffff0000u), dot);
  }
  return dot;
}

}  // namespace
