// The consumer side of a packed-weight stream, shared by the whole-layer
// kernel (layer_stream.cuh, #12) and the single-row kernels of #1 and #13
// (gemv.cuh): a stage is RR word rows x CC columns of one byteplane field
// (ops/pack.py) in shared memory, and a lane takes a 16-byte row of it,
// four columns, using every code of each word against the staged x row
// (qdot.cuh's algebra: dp4a for int8 x; f32 products for bf16 / f32 x).
// Both also stage a phase's input row the same way: row_norm below holds
// the row statistics, the norm and the int8 scale that #12's stage_row and
// the single-row ln1 + q|k|v kernel (#4, gemv.cuh) share.

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

// ---------------------------------------------------------------------------
// an input row's norm and int8 scale, by a block's NT consumer threads
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a staged element: the int8 code (IEEE division, round half to even) or
// the bf16 value
__device__ __forceinline__ int8_t to_stage(float v, float sx, int8_t*) {
  return (int8_t)fminf(fmaxf(rintf(v / sx), -127.f), 127.f);
}
__device__ __forceinline__ __nv_bfloat16 to_stage(float v, float,
                                                  __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// four elements of a staged row at vector vi (int8 codes or bf16)
__device__ __forceinline__ void store_staged(int8_t* xs, int vi, float4 x,
                                             float sx) {
  const int8_t q[4] = {to_stage(x.x, sx, (int8_t*)nullptr),
                       to_stage(x.y, sx, (int8_t*)nullptr),
                       to_stage(x.z, sx, (int8_t*)nullptr),
                       to_stage(x.w, sx, (int8_t*)nullptr)};
  reinterpret_cast<uint32_t*>(xs)[vi] =
      (uint32_t)(uint8_t)q[0] | (uint32_t)(uint8_t)q[1] << 8 |
      (uint32_t)(uint8_t)q[2] << 16 | (uint32_t)(uint8_t)q[3] << 24;
}
__device__ __forceinline__ void store_staged(__nv_bfloat16* xs, int vi,
                                             float4 x, float) {
  reinterpret_cast<uint2*>(xs)[vi] =
      make_uint2((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x.x)) |
                     (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x.y))
                         << 16,
                 (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x.z)) |
                     (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x.w))
                         << 16);
}

template <int NT>
__device__ __forceinline__ void consumer_bar() {  // named barrier 1
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

// the sum (or the max, of values >= 0) of v over the NT consumer threads,
// in warp order; red: NT / 32 floats of shared memory
template <int NT>
__device__ __forceinline__ float consumer_red(float v, bool is_max,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(FULL, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  consumer_bar<NT>();
  float r = 0.f;  // absmax >= 0
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  consumer_bar<NT>();
  return r;
}

// four elements of the norm, rounded to bf16: kind 0 rmsnorm (x rstd n),
// 1 rmsnorm1p (x rstd (1 + n)), 2 layernorm ((x - mu) rstd n + b)
__device__ __forceinline__ float4 norm4(float4 x, float4 n, float4 b, int kind,
                                        float mu, float rstd) {
  if (kind == 2)
    return make_float4(bf16r((x.x - mu) * rstd * n.x + b.x),
                       bf16r((x.y - mu) * rstd * n.y + b.y),
                       bf16r((x.z - mu) * rstd * n.z + b.z),
                       bf16r((x.w - mu) * rstd * n.w + b.w));
  const float4 m = kind == 1 ? make_float4(1.f + n.x, 1.f + n.y, 1.f + n.z,
                                           1.f + n.w)
                             : n;
  return make_float4(bf16r(x.x * rstd * m.x), bf16r(x.y * rstd * m.y),
                     bf16r(x.z * rstd * m.z), bf16r(x.w * rstd * m.w));
}

// The statistics, the norm and the int8 scale of one input row of NV float4
// vectors, by a block's NT consumer threads: a thread takes the vectors t,
// t + NT, ... (UNR of them in flight), so every block that runs it on the
// same row gets the same bits. Pass 1 sums the row's squares (and the row:
// layernorm takes its mean, then the centred row's squares); pass 2 forms
// the norm (nw null: the row as it is) and its absmax. The row comes
// through R:
//   R::load(v0, NT, v)  pass 1's vectors v0 + NT u (zeros past the row),
//                       which R may keep; R::passed() after pass 1
//   R::get(vi)          vector vi of the row, after pass 1
//   R::put(vi, x)       its norm, where R keeps the row
// nb: the layernorm bias. Returns the int8 scale (A8: absmax / 127 +
// 1e-12, as quantize_acts_int8; else 1), and the norm's mu and rstd.
template <int NT, int UNR, bool A8, typename R>
__device__ float row_norm(R& row, int NV, const float* nw, const float* nb,
                          int kind, float eps, float* red, float& mu,
                          float& rstd) {
  const int t = threadIdx.x;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float ss = 0.f, sm = 0.f;  // sm: the row's sum (layernorm)
  for (int v0 = t; v0 < NV; v0 += NT * UNR) {
    float4 v[UNR];
    row.load(v0, NT, v);
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      if (v0 + NT * u < NV) {
        ss += v[u].x * v[u].x + v[u].y * v[u].y + v[u].z * v[u].z +
              v[u].w * v[u].w;
        sm += v[u].x + v[u].y + v[u].z + v[u].w;
      }
    }
  }
  row.passed();
  const float K = (float)(4 * NV);
  const bool ln = nw != nullptr && kind == 2;
  mu = 0.f;
  rstd = 1.f;
  if (ln) {  // layernorm: the mean, then the centred row's sum of squares
    mu = consumer_red<NT>(sm, false, red) / K;
    ss = 0.f;
    for (int vi = t; vi < NV; vi += NT) {
      const float4 x = row.get(vi);
      const float dx = x.x - mu, dy = x.y - mu, dz = x.z - mu, dw = x.w - mu;
      ss += dx * dx + dy * dy + dz * dz + dw * dw;
    }
  }
  if (nw != nullptr)
    rstd = 1.f / sqrtf(consumer_red<NT>(ss, false, red) / K + eps);
  // pass 2: the norm (its weights UNR vectors at a time) and the absmax
  float amax = 0.f;
  for (int v0 = t; v0 < NV; v0 += NT * UNR) {
    float4 n4[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u)
      n4[u] = nw != nullptr && v0 + NT * u < NV
                  ? __ldg(reinterpret_cast<const float4*>(nw) + v0 + NT * u)
                  : z4;
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int vi = v0 + NT * u;
      if (vi >= NV) continue;
      float4 x = row.get(vi);
      if (nw != nullptr) {
        const float4 b =
            ln ? __ldg(reinterpret_cast<const float4*>(nb) + vi) : z4;
        x = norm4(x, n4[u], b, kind, mu, rstd);
        row.put(vi, x);
      }
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                               fmaxf(fabsf(x.z), fabsf(x.w))));
    }
  }
  return A8 ? consumer_red<NT>(amax, true, red) / 127.f + 1e-12f : 1.f;
}

}  // namespace
