// Streamed dequantize + matmul over single-field (2/4/8-bit) byteplane
// weights: kernel #1's function (qmatmul.cu) with the K walk inside the
// block.
//
// Replaces gptq_tpu/ops/qmatmul.py:_stream_kernel (_matmul_streamed), the
// Pallas TPU kernel behind GPTQ_TPU_MATMUL_IMPL=streamed. It computes
//
//     out[m, n] = sum_g [ (x_g . C_g)[m, n] * scale[g, n]
//                         - (sum_{k in g} x[m, k]) * zoff[g, n] ]
//
// over the stored dims: x (M, Kp) f32 / bf16 / int8, codes C (Kp, Np) in
// one field of FB bits, out (M, Np) f32. The caller applies the per-row
// int8 activation scale and the bias.
//
// Design, after the TPU kernel: the grid runs over N tiles only (32
// columns, one per lane, so a warp's word reads are one 128-byte line)
// and row tiles of x; each block walks K in chunks of tk rows, the
// wrapper's chunk as in the JAX package. The TPU kernel's two DMA slots
// become a double buffer in shared memory that cp.async fills with the
// next chunk's words while the block computes on the current one. x stays
// in device memory (L1 / L2 hold it: every block reads the same rows).
// Within a chunk the 8 warps take interleaved word rows of one group
// segment (min(group, tk) rows) at a time; every code of a loaded word
// is used (plane_dot, qdot.cuh: dp4a for int8 x), and the group grid
// applies per segment on the partial: acc += part * scale - xsum * zoff,
// where each warp sums the x rows its own words cover, so no
// cross-warp sum is needed until the end.
//
// Bound on an H100: the packed-word bytes over the memory rate at the
// decode shapes this route serves (M <= 8).
//
// At one row (decode) this kernel is not launched: the wrapper
// (ops/qmatmul._stream_cuda) sends the row to #1's single-row stream
// through csrc/qmatmul.cu's qmm_launch (csrc/gemv.cuh qgemv_kernel), which
// keeps more bytes in flight than the 32-column tiles here (on an H100, a
// llama-7B layer's four w4a8 linears: 0.082 ms against 0.182). There the
// ring of stages, not tk, shapes the walk over K: the wrapper still
// computes tk and seg (ops/qmatmul.stream_chunks), so the route refuses
// the weights the JAX package refuses, but at one row they only pick the
// route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot.cuh"

namespace {

constexpr int COLS = 32;
constexpr int WARPS = 8;

template <typename T>
struct Acc { using type = float; };
template <>
struct Acc<int8_t> { using type = int; };

// the sum of the 4 x rows per sub-byte plane that one word's codes meet
template <int FB>
__device__ __forceinline__ int plane_xsum(const int8_t* xs, int xrow,
                                          int quarter, int sum) {
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const int xa = *reinterpret_cast<const int*>(xs + xrow + e * quarter);
    sum = dp4a_su(xa, 0x01010101u, sum);
  }
  return sum;
}

template <int FB>
__device__ __forceinline__ float plane_xsum(const float* xs, int xrow,
                                            int quarter, float sum) {
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const float4 v = *reinterpret_cast<const float4*>(xs + xrow + e * quarter);
    sum += v.x + v.y + v.z + v.w;
  }
  return sum;
}

template <int FB>
__device__ __forceinline__ float plane_xsum(const __nv_bfloat16* xs, int xrow,
                                            int quarter, float sum) {
#pragma unroll
  for (int e = 0; e < 8 / FB; ++e) {
    const uint2 v = *reinterpret_cast<const uint2*>(xs + xrow + e * quarter);
    sum += __uint_as_float(v.x << 16) + __uint_as_float(v.x & 0xffff0000u) +
           __uint_as_float(v.y << 16) + __uint_as_float(v.y & 0xffff0000u);
  }
  return sum;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// chunk c's words of this block's 32 columns -> dst (rows_ck x 32)
__device__ __forceinline__ void stage_chunk(int32_t* dst,
                                            const int32_t* __restrict__ w,
                                            int c, int rows_ck, int n0,
                                            int Np) {
  const int32_t* src = w + (size_t)c * rows_ck * Np + n0;
  if (n0 + COLS <= Np && Np % 4 == 0) {  // whole 16-byte pieces
    for (int i = threadIdx.x; i < rows_ck * 8; i += blockDim.x) {
      const int r = i >> 3, q = i & 7;
      cp_async16(dst + r * COLS + q * 4, src + (size_t)r * Np + q * 4);
    }
  } else {  // the ragged last tile: one word at a time, zeros past Np
    for (int i = threadIdx.x; i < rows_ck * COLS; i += blockDim.x) {
      const int r = i >> 5, q = i & 31;
      if (n0 + q < Np)
        cp_async4(dst + r * COLS + q, src + (size_t)r * Np + q);
      else
        dst[r * COLS + q] = 0;
    }
  }
}

template <typename XT, int FB, int MR>
__global__ void __launch_bounds__(WARPS * 32)
qstream_kernel(const XT* __restrict__ x, int M, int Kp,
               const int32_t* __restrict__ w, int SB, int tk, int seg,
               const float* __restrict__ scale,
               const float* __restrict__ zoff, int ng,
               float* __restrict__ out, int Np) {
  using AT = typename Acc<XT>::type;
  extern __shared__ __align__(16) int32_t buf[];  // [2][rows_ck][COLS]
  __shared__ float red[WARPS][MR][COLS];
  constexpr int P = 32 / FB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS;
  const int n = n0 + lane;
  const bool col_ok = n < Np;
  const int m0 = blockIdx.y * MR;
  const int rows_ck = tk / P;
  const int rows_seg = seg / P;
  const int Wsb = SB / P;
  const int quarter = 4 * Wsb;
  const int n_ck = Kp / tk;
  const int G = Kp / ng;

  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;

  stage_chunk(buf, w, 0, rows_ck, n0, Np);
  cp_async_commit();
  for (int c = 0; c < n_ck; ++c) {
    if (c + 1 < n_ck)
      stage_chunk(buf + ((c + 1) & 1) * rows_ck * COLS, w, c + 1, rows_ck,
                  n0, Np);
    cp_async_commit();
    cp_async_wait_one();  // chunk c has landed (c + 1 may be in flight)
    __syncthreads();
    const int32_t* wb = buf + (c & 1) * rows_ck * COLS;
    for (int s0 = 0; s0 < tk; s0 += seg) {
      AT dot[MR], xsm[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) dot[m] = xsm[m] = 0;
      const int j0 = s0 / P;
      for (int j = j0 + warp; j < j0 + rows_seg; j += WARPS) {
        const unsigned word = (unsigned)wb[j * COLS + lane];
        const int s = j / Wsb;
        const int xrow = c * tk + s * SB + 4 * (j - s * Wsb);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m0 + m < M) {
            const XT* xm = x + (size_t)(m0 + m) * Kp;
            dot[m] = plane_dot<FB>(word, xm, xrow, quarter, dot[m]);
            xsm[m] = plane_xsum<FB>(xm, xrow, quarter, xsm[m]);
          }
        }
      }
      const int g = (c * tk + s0) / G;
      const float sc = col_ok ? __ldg(scale + (size_t)g * Np + n) : 0.f;
      const float z = col_ok ? __ldg(zoff + (size_t)g * Np + n) : 0.f;
#pragma unroll
      for (int m = 0; m < MR; ++m)
        acc[m] += (float)dot[m] * sc - (float)xsm[m] * z;
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int m = 0; m < MR; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < MR * COLS; i += blockDim.x) {
    const int m = i / COLS, l = i - m * COLS;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) v += red[q][m][l];
    if (n0 + l < Np && m0 + m < M) out[(size_t)(m0 + m) * Np + n0 + l] = v;
  }
}

template <typename XT, int FB, int MR>
int launch(const void* x, int M, int Kp, const void* w, int SB, int tk,
           int seg, const void* scale, const void* zoff, int ng, void* out,
           int Np, cudaStream_t st) {
  constexpr int P = 32 / FB;
  const size_t smem = (size_t)2 * (tk / P) * COLS * sizeof(int32_t);
  const size_t static_smem = sizeof(float) * WARPS * MR * COLS;
  if (smem + static_smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = qstream_kernel<XT, FB, MR>;
  if (smem + static_smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);  // a failure shows in cudaGetLastError
  const dim3 grid((Np + COLS - 1) / COLS, (M + MR - 1) / MR);
  kern<<<grid, WARPS * 32, smem, st>>>(
      (const XT*)x, M, Kp, (const int32_t*)w, SB, tk, seg,
      (const float*)scale, (const float*)zoff, ng, (float*)out, Np);
  return (int)cudaGetLastError();
}

template <typename XT, int FB>
int launch_m(const void* x, int M, int Kp, const void* w, int SB, int tk,
             int seg, const void* scale, const void* zoff, int ng, void* out,
             int Np, cudaStream_t st) {
  if (M == 1)
    return launch<XT, FB, 1>(x, M, Kp, w, SB, tk, seg, scale, zoff, ng, out,
                             Np, st);
  if (M <= 4)
    return launch<XT, FB, 4>(x, M, Kp, w, SB, tk, seg, scale, zoff, ng, out,
                             Np, st);
  return launch<XT, FB, 8>(x, M, Kp, w, SB, tk, seg, scale, zoff, ng, out,
                           Np, st);
}

template <typename XT>
int launch_fb(const void* x, int M, int Kp, const void* w, int fb, int SB,
              int tk, int seg, const void* scale, const void* zoff, int ng,
              void* out, int Np, cudaStream_t st) {
  switch (fb) {
    case 2:
      return launch_m<XT, 2>(x, M, Kp, w, SB, tk, seg, scale, zoff, ng, out,
                             Np, st);
    case 4:
      return launch_m<XT, 4>(x, M, Kp, w, SB, tk, seg, scale, zoff, ng, out,
                             Np, st);
    case 8:
      return launch_m<XT, 8>(x, M, Kp, w, SB, tk, seg, scale, zoff, ng, out,
                             Np, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x_kind: 0 = f32, 1 = bf16, 2 = int8; fb: the single field's width (2, 4
// or 8); tk: rows per K chunk; seg = min(group, tk), a multiple of SB that
// divides tk and the group. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments it cannot take).
extern "C" int qstream_launch(const void* x, int x_kind, int M, int Kp,
                              const void* w, int fb, int SB, int tk, int seg,
                              const void* scale, const void* zoff, int ng,
                              void* out, int Np, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || tk < 1 || Kp % tk || seg < 1 || tk % seg || SB < 32 ||
      seg % SB || ng < 1 || Kp % ng || (Kp / ng) % seg)
    return (int)cudaErrorInvalidValue;
  if (x_kind == 0)
    return launch_fb<float>(x, M, Kp, w, fb, SB, tk, seg, scale, zoff, ng,
                            out, Np, st);
  if (x_kind == 1)
    return launch_fb<__nv_bfloat16>(x, M, Kp, w, fb, SB, tk, seg, scale,
                                    zoff, ng, out, Np, st);
  if (x_kind == 2)
    return launch_fb<int8_t>(x, M, Kp, w, fb, SB, tk, seg, scale, zoff, ng,
                             out, Np, st);
  return (int)cudaErrorInvalidValue;
}
