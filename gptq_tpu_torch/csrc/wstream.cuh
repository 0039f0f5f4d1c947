// The consumer side of a packed-weight stream, shared by the whole-layer
// kernel (layer_stream.cuh, #12) and the single-row kernels of #1 and #13
// (gemv.cuh): a stage is RR word rows x CC columns of one byteplane field
// (ops/pack.py) in shared memory, and a lane takes a 16-byte row of it,
// four columns, using every code of each word against the staged x row
// (qdot.cuh's algebra: dp4a for int8 x; f32 products for bf16 / f32 x).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "qdot.cuh"  // dp4a_su

namespace {

constexpr int CC = 128;                   // columns of a chunk (4 a lane)
constexpr int RR = 32;                    // word rows of a stage
constexpr int STAGE_BYTES = RR * CC * 4;  // 16 KB

// the exact partials of a staged x type: int32 for int8 codes, else f32
template <typename ST>
struct DotAcc { using type = float; };
template <>
struct DotAcc<int8_t> { using type = int; };

// word row gr of a field of width fb: the staged row's element of its
// byte 0 in plane 0 (qdot.cuh: subblock s holds rows s SB + e quarter +
// 4 j + b at word row s Wsb + j), and the rows between two planes
struct RowMap {
  int sb_shift, wsb_shift, quarter;
  __device__ RowMap(int SB, int fb) {
    sb_shift = 31 - __clz(SB);
    wsb_shift = 31 - __clz(SB * fb / 32);
    quarter = SB * fb / 8;
  }
  __device__ __forceinline__ int xrow(int gr) const {
    const int s = gr >> wsb_shift;
    return (s << sb_shift) + 4 * (gr - (s << wsb_shift));
  }
};

// byte_dot (qdot.cuh) with each code widened exactly by the magic number
// 2^23: the code byte under its exponent (one byte permute), less 2^23,
// in place of an integer-to-float conversion, which issues at a quarter
// of the FMA rate; the same products in the same order
__device__ __forceinline__ float byte_dot_m(unsigned cb, float x0, float x1,
                                            float x2, float x3, float dot) {
  constexpr unsigned E23 = 0x4B000000u;  // 2^23
  constexpr float M = 8388608.f;
  const float c0 = __uint_as_float(__byte_perm(cb, E23, 0x7440)) - M;
  const float c1 = __uint_as_float(__byte_perm(cb, E23, 0x7441)) - M;
  const float c2 = __uint_as_float(__byte_perm(cb, E23, 0x7442)) - M;
  const float c3 = __uint_as_float(__byte_perm(cb, E23, 0x7443)) - M;
  return dot + x0 * c0 + x1 * c1 + x2 * c2 + x3 * c3;
}

template <int FB>
__device__ __forceinline__ void row_dot4(int4 w4, const int8_t* x, int quarter,
                                         int (&dot)[4]) {
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  const unsigned w[4] = {(unsigned)w4.x, (unsigned)w4.y, (unsigned)w4.z,
                         (unsigned)w4.w};
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const int xa = *reinterpret_cast<const int*>(x + e * quarter);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned ww = FB == 8 ? w[c] ^ 0x80808080u : w[c];
      dot[c] = dp4a_su(xa, (ww >> (FB * e)) & BM, dot[c]);
    }
  }
}

template <int FB>
__device__ __forceinline__ void row_dot4(int4 w4, const __nv_bfloat16* x,
                                         int quarter, float (&dot)[4]) {
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  const unsigned w[4] = {(unsigned)w4.x, (unsigned)w4.y, (unsigned)w4.z,
                         (unsigned)w4.w};
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const uint2 xv = *reinterpret_cast<const uint2*>(x + e * quarter);
    const float x0 = __uint_as_float(xv.x << 16);
    const float x1 = __uint_as_float(xv.x & 0xffff0000u);
    const float x2 = __uint_as_float(xv.y << 16);
    const float x3 = __uint_as_float(xv.y & 0xffff0000u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned ww = FB == 8 ? w[c] ^ 0x80808080u : w[c];
      dot[c] = byte_dot_m((ww >> (FB * e)) & BM, x0, x1, x2, x3, dot[c]);
    }
  }
}

template <int FB>
__device__ __forceinline__ void row_dot4(int4 w4, const float* x, int quarter,
                                         float (&dot)[4]) {
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  const unsigned w[4] = {(unsigned)w4.x, (unsigned)w4.y, (unsigned)w4.z,
                         (unsigned)w4.w};
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const float4 xv = *reinterpret_cast<const float4*>(x + e * quarter);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned ww = FB == 8 ? w[c] ^ 0x80808080u : w[c];
      dot[c] = byte_dot_m((ww >> (FB * e)) & BM, xv.x, xv.y, xv.z, xv.w,
                          dot[c]);
    }
  }
}

// word rows [gr, gr + nr) (nr <= N) of a stage, a lane's 16-byte row of
// each (rows: the stage's first of them, CC / 4 int4 a row), into the
// lane's four columns' exact partials: all N rows loaded, then taken
template <int FB, int N, typename ST, typename AT>
__device__ __forceinline__ void rows_dot(const int4* rows, int gr, int nr,
                                         const ST* xs, const RowMap& m,
                                         AT (&dot)[4]) {
  const int lane = threadIdx.x & 31;
  int4 w4[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < nr) w4[i] = rows[i * (CC / 4) + lane];
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < nr) row_dot4<FB>(w4[i], xs + m.xrow(gr + i), m.quarter, dot);
}

}  // namespace
