// The word-centric single-row dequantize + matmul body of the expert-select
// kernel #9 (qexpert.cu's qsel_kernel, which reads its expert index from
// device memory and offsets the bank's pointers by it); qmatmul.cu takes
// its constants and loaders for the tiled loop (#1's decode kernel is
// gemv.cuh's qgemv_kernel).
//
// The whole activation row is staged once in shared memory (f32 for
// a16, int8 for a8) with one partial sum per subblock. Work items are
// (subblock, field, run of <= 16 word rows); a lane loads each word of
// its column once and uses every code in it: for sub-byte plane e, the
// word's 4 bytes hold rows 4*j + b (b < 4) of the plane, contiguous in
// x, so a8 takes them in one dp4a (signed x bytes times unsigned code
// bytes) and a16 in one float4 of x. Needs the group length to cover
// whole subblocks and the staged row to fit shared memory. Each row of x
// (blockIdx.y) is its own block row: rows re-read the weight from L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 32;   // output columns per block
constexpr int JC = 16;     // word rows per work item
constexpr int VWARPS = 32; // most warps per single-row block: a narrow
                           // weight gives few blocks, so each keeps many
                           // word loads in flight; a wide one uses 8

template <typename T>
struct Acc { using type = float; };
template <>
struct Acc<int8_t> { using type = int; };

template <typename XT>
struct Stage { using type = float; };
template <>
struct Stage<int8_t> { using type = int8_t; };

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ int load_x(const int8_t* p) { return (int)*p; }

// plane_dot (qdot.cuh): the dot of one word's codes with their x rows

// one field's contribution: items (subblock s, run c of word rows)
template <int FB, typename ST, typename AT>
__device__ __forceinline__ float field_items(
    const int32_t* __restrict__ w, int sh, const ST* xs, const AT* xsum,
    int SB, int nsub, int G, const float* __restrict__ scale,
    const float* __restrict__ zoff, int Np, int n, bool col_ok, int warp,
    bool first_field) {
  constexpr int P = 32 / FB;
  const int Wsb = SB / P;
  const int quarter = 4 * Wsb;
  const int jc = Wsb < JC ? Wsb : JC;
  const int nch = Wsb / jc;
  float acc = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int it = warp; it < nsub * nch; it += nwarps) {
    const int s = it / nch;
    const int c = it - s * nch;
    if (!col_ok) continue;
    const int32_t* wp = w + (size_t)(s * Wsb + c * jc) * Np + n;
    AT dot = 0;
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      if (jj < jc) {
        const unsigned word = (unsigned)__ldg(wp + (size_t)jj * Np);
        dot = plane_dot<FB>(word, xs, s * SB + 4 * (c * jc + jj), quarter, dot);
      }
    }
    const int g = (s * SB) / G;
    acc += (float)dot * (float)(1 << sh) * scale[(size_t)g * Np + n];
    if (first_field && c == 0) acc -= (float)xsum[s] * zoff[(size_t)g * Np + n];
  }
  return acc;
}

// eidx: null for a plain weight; else a device int32 expert index into a
// bank of E weights whose experts lie `Kp * fb / 32 * Np` words (per
// field) and `ng * Np` grid entries apart. An index outside [0, E) gives
// NaN outputs.
template <typename XT, int BITS>
__device__ __forceinline__ void qmv_row(
    const XT* __restrict__ x, int Kp, const int32_t* __restrict__ w0,
    const int32_t* __restrict__ w1, int SB, const float* __restrict__ scale,
    const float* __restrict__ zoff, int ng, float* __restrict__ out, int Np,
    const int* __restrict__ eidx, int E) {
  using ST = typename Stage<XT>::type;
  using AT = typename Acc<XT>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  ST* xs = reinterpret_cast<ST*>(smem);
  AT* xsum = reinterpret_cast<AT*>(smem + ((Kp * sizeof(ST) + 15) & ~15));
  __shared__ float red[VWARPS][COLS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * COLS + lane;
  const bool col_ok = n < Np;
  x += (size_t)blockIdx.y * Kp;
  out += (size_t)blockIdx.y * Np;
  if (eidx != nullptr) {
    const int e = __ldg(eidx);
    if (e < 0 || e >= E) {  // uniform in the block: no barrier is skipped
      if (warp == 0 && col_ok) out[n] = __int_as_float(0x7fc00000);
      return;
    }
    constexpr int FB0 = BITS == 3 ? 2 : BITS;
    w0 += (size_t)e * ((size_t)Kp * FB0 / 32) * Np;
    if (w1 != nullptr) w1 += (size_t)e * ((size_t)Kp / 32) * Np;
    scale += (size_t)e * ng * Np;
    zoff += (size_t)e * ng * Np;
  }
  const int nsub = Kp / SB;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < Kp; i += blockDim.x) xs[i] = (ST)load_x(x + i);
  __syncthreads();
  for (int s = warp; s < nsub; s += nwarps) {
    AT v = 0;
    for (int r = lane; r < SB; r += 32) v += (AT)xs[s * SB + r];
    v = warp_sum(v);
    if (lane == 0) xsum[s] = v;
  }
  __syncthreads();
  const int G = Kp / ng;
  float acc;
  if (BITS == 3) {
    acc = field_items<2>(w0, 0, xs, xsum, SB, nsub, G, scale, zoff, Np, n,
                         col_ok, warp, true) +
          field_items<1>(w1, 2, xs, xsum, SB, nsub, G, scale, zoff, Np, n,
                         col_ok, warp, false);
  } else {
    acc = field_items<BITS>(w0, 0, xs, xsum, SB, nsub, G, scale, zoff, Np,
                            n, col_ok, warp, true);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < nwarps; ++w) s += red[w][lane];
    if (col_ok) out[n] = s;
  }
}

// #9's select kernel
template <typename XT, int BITS>
__global__ void __launch_bounds__(VWARPS * 32) qsel_kernel(
    const XT* __restrict__ x, int Kp, const int32_t* __restrict__ w0,
    const int32_t* __restrict__ w1, int SB, const float* __restrict__ scale,
    const float* __restrict__ zoff, int ng, float* __restrict__ out, int Np,
    const int* __restrict__ eidx, int E) {
  qmv_row<XT, BITS>(x, Kp, w0, w1, SB, scale, zoff, ng, out, Np, eidx, E);
}

// the select kernel applies when groups cover whole subblocks and the
// staged row fits a block's 227 KB of shared memory (above 48 KB only as
// dynamic shared memory the kernel has opted into). M rows of x, each its
// own grid row. Returns false (launching nothing) where it does not apply.
template <typename XT>
bool qsel_launch(const void* x, int M, int Kp, int bits, const void* w0,
                 const void* w1, int SB, const void* scale, const void* zoff,
                 int ng, const int* eidx, int E, void* out, int Np,
                 cudaStream_t st) {
  using ST = typename Stage<XT>::type;
  using AT = typename Acc<XT>::type;
  void (*kern)(const XT*, int, const int32_t*, const int32_t*, int,
               const float*, const float*, int, float*, int, const int*, int);
  switch (bits) {
    case 2: kern = &qsel_kernel<XT, 2>; break;
    case 3: kern = &qsel_kernel<XT, 3>; break;
    case 4: kern = &qsel_kernel<XT, 4>; break;
    case 8: kern = &qsel_kernel<XT, 8>; break;
    default: return false;
  }
  const int G = Kp / ng;
  const size_t smem = ((Kp * sizeof(ST) + 15) & ~(size_t)15) +
                      (size_t)(Kp / SB) * sizeof(AT);
  const size_t static_smem = sizeof(float) * VWARPS * COLS;
  if (M < 1 || G % SB != 0 || smem + static_smem > 227 * 1024) return false;
  if (smem + static_smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);  // a failure shows in cudaGetLastError
  const dim3 grid((Np + COLS - 1) / COLS, M);
  // up to two blocks of 32 warps per SM cover 264 blocks; wider weights
  // (or more rows) have enough blocks for 8 warps each
  const int threads = (grid.x * grid.y <= 264 ? VWARPS : WARPS) * 32;
  kern<<<grid, threads, smem, st>>>(
      (const XT*)x, Kp, (const int32_t*)w0, (const int32_t*)w1, SB,
      (const float*)scale, (const float*)zoff, ng, (float*)out, Np, eidx, E);
  return true;
}

}  // namespace
