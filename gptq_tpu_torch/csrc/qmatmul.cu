// Fused dequantize + matmul over byteplane-packed 2/3/4/8-bit weights.
//
// Replaces gptq_tpu/ops/qmatmul.py:_qmm_kernel (+ _tile_update), the
// Pallas TPU kernel behind dequant_matmul. It computes
//
//     out[m, n] = sum_g [ (x_g @ C_g)[m, n] * scale[g, n]
//                         - (sum_k x[m, k]) * zoff[g, n] ]
//
// over the stored (padded) dims: x (M, Kp) f32 / bf16 / int8, codes C
// (Kp, Np) unpacked in registers from one or two int32 word fields
// (3-bit = a 2-bit and a 1-bit field), out (M, Np) f32. The caller applies
// the per-row int8 activation scale and the bias.
//
// Design (simple and right first; tensor cores, TMA and split-K later):
//   * a block owns 32 output columns (one per lane, so each word load of
//     a warp is one coalesced 128-byte line) and TM rows of x; its 8 warps
//     take interleaved 32-row K chunks and the block sums the 8 partials
//     in shared memory at the end. The TPU's sequential K grid axis and
//     its accumulator scratch become this in-block loop: no atomics.
//   * each lane computes where its chunk row lives in the packed layout
//     (word row and bit shift per field, ops/pack.py: row SB*s +
//     e*4*Wsb + 4*j + b sits in word s*Wsb + j at bit 8*b + fb*e) and the
//     warp broadcasts it with shuffles, so every lane extracts its code
//     for that row with one shift and one mask.
//   * a16 (f32/bf16 x): f32 products of raw codes, f32 partial per chunk.
//     a8 (int8 x): exact int32 partial per chunk. Either way the group
//     grid applies once per 32-row chunk on the partial:
//     acc += part * scale - xsum * zoff, xsum by a warp reduction. Groups
//     that do not cover whole chunks dequantize per element instead.
//   * decode (M == 1, groups covering whole subblocks, Np a multiple of
//     4) takes qgemv_kernel of gemv.cuh: the weight streamed through a
//     ring of shared-memory stages by a producer warp, every code of each
//     word used (a8: dp4a on 4 codes at a time), chunks cut in K into a
//     thread block cluster's pieces summed in piece order.
//
// Bound on an H100: at decode (M <= 64) the packed-weight bytes over the
// memory rate; at M = 2048 the multiply-adds over the tensor-core rate
// (this kernel uses CUDA cores, so it sits far from that bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv.cuh"  // the single-row kernel
#include "qmv.cuh"   // WARPS, COLS, Acc, load_x

namespace {

constexpr int KC = 32;  // K rows per chunk (WARPS, COLS: qmv.cuh)

// word row and bit shift of packed row k in a field of width fb
__device__ __forceinline__ void row_pos(int k, int SB, int fb, int& wrow,
                                        int& shift) {
  const int P = 32 / fb;
  const int Wsb = SB / P;
  const int quarter = 4 * Wsb;  // rows per sub-byte plane in a subblock
  const int s = k / SB;
  const int r = k - s * SB;
  const int e = r / quarter;
  const int rem = r - e * quarter;
  wrow = s * Wsb + (rem >> 2);
  shift = 8 * (rem & 3) + fb * e;
}

__device__ __forceinline__ int field_code(const int32_t* __restrict__ w,
                                          int wrow, int shift, int fb,
                                          int sh, int Np, int n) {
  const unsigned word = (unsigned)__ldg(w + (size_t)wrow * Np + n);
  int c = (int)((word >> shift) & ((1u << fb) - 1u));
  if (fb == 8) c ^= 0x80;  // the 8-bit field stores code - 128
  return c << sh;
}

template <typename XT, int TM>
__global__ void __launch_bounds__(WARPS * 32)
qmm_kernel(const XT* __restrict__ x, int M, int Kp,
           const int32_t* __restrict__ w0, int fb0, int sh0,
           const int32_t* __restrict__ w1, int fb1, int sh1, int SB,
           const float* __restrict__ scale, const float* __restrict__ zoff,
           int ng, float* __restrict__ out, int Np) {
  using AT = typename Acc<XT>::type;
  __shared__ AT xs[WARPS][KC][TM];
  __shared__ float red[WARPS][TM][COLS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * COLS + lane;
  const int m0 = blockIdx.y * TM;
  const bool col_ok = n < Np;
  const int G = Kp / ng;  // stored rows per group
  const bool chunk_groups = (G % KC) == 0;
  const int nchunks = Kp / KC;

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.f;

  for (int c = warp; c < nchunks; c += WARPS) {
    const int k0 = c * KC;
    int wr0, s0, wr1 = 0, s1 = 0;
    row_pos(k0 + lane, SB, fb0, wr0, s0);
    if (w1 != nullptr) row_pos(k0 + lane, SB, fb1, wr1, s1);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      AT v = 0;
      if (m0 + m < M) v = load_x(x + (size_t)(m0 + m) * Kp + k0 + lane);
      xs[warp][lane][m] = v;
    }
    __syncwarp();

    if (chunk_groups) {
      AT part[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) part[m] = 0;
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const int r0 = __shfl_sync(FULL, wr0, kk);
        const int q0 = __shfl_sync(FULL, s0, kk);
        const int r1 = __shfl_sync(FULL, wr1, kk);
        const int q1 = __shfl_sync(FULL, s1, kk);
        int code = 0;
        if (col_ok) {
          code = field_code(w0, r0, q0, fb0, sh0, Np, n);
          if (w1 != nullptr) code += field_code(w1, r1, q1, fb1, sh1, Np, n);
        }
        const AT cv = (AT)code;
#pragma unroll
        for (int m = 0; m < TM; ++m) part[m] += xs[warp][kk][m] * cv;
      }
      const int g = k0 / G;
      const float sc = col_ok ? scale[(size_t)g * Np + n] : 0.f;
      const float z = col_ok ? zoff[(size_t)g * Np + n] : 0.f;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const AT xsum = warp_sum(xs[warp][lane][m]);
        acc[m] += (float)part[m] * sc - (float)xsum * z;
      }
    } else {
      // groups smaller than a chunk (or not aligned to it): dequantize
      // each element with its own group's grid
      for (int kk = 0; kk < KC; ++kk) {
        const int r0 = __shfl_sync(FULL, wr0, kk);
        const int q0 = __shfl_sync(FULL, s0, kk);
        const int r1 = __shfl_sync(FULL, wr1, kk);
        const int q1 = __shfl_sync(FULL, s1, kk);
        if (!col_ok) continue;
        int code = field_code(w0, r0, q0, fb0, sh0, Np, n);
        if (w1 != nullptr) code += field_code(w1, r1, q1, fb1, sh1, Np, n);
        const int g = (k0 + kk) / G;
        const float wv = (float)code * scale[(size_t)g * Np + n] -
                         zoff[(size_t)g * Np + n];
#pragma unroll
        for (int m = 0; m < TM; ++m) acc[m] += (float)xs[warp][kk][m] * wv;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < TM * COLS; i += WARPS * 32) {
    const int m = i / COLS;
    const int l = i - m * COLS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][m][l];
    const int nn = blockIdx.x * COLS + l;
    if (nn < Np && m0 + m < M) out[(size_t)(m0 + m) * Np + nn] = s;
  }
}

template <typename XT, int TM>
void launch(const void* x, int M, int Kp, const void* w0, int fb0, int sh0,
            const void* w1, int fb1, int sh1, int SB, const void* scale,
            const void* zoff, int ng, void* out, int Np, cudaStream_t st) {
  dim3 grid((Np + COLS - 1) / COLS, (M + TM - 1) / TM);
  qmm_kernel<XT, TM><<<grid, WARPS * 32, 0, st>>>(
      (const XT*)x, M, Kp, (const int32_t*)w0, fb0, sh0,
      (const int32_t*)w1, fb1, sh1, SB, (const float*)scale,
      (const float*)zoff, ng, (float*)out, Np);
}

template <typename XT>
int launch_tm(const void* x, int M, int Kp, const void* w0, int fb0, int sh0,
              const void* w1, int fb1, int sh1, int SB, const void* scale,
              const void* zoff, int ng, void* out, int Np, int splits,
              int unit, cudaStream_t st) {
  const int bits = w1 != nullptr ? 3 : fb0;
  if (M == 1 && (Kp / ng) % SB == 0 && Np % 4 == 0 &&
      (bits == 2 || bits == 3 || bits == 4 || bits == 8)) {
    GemvArgs a{};
    a.x = x;
    a.w0 = (const int32_t*)w0;
    a.w1 = (const int32_t*)w1;
    a.grid = (const float*)scale;
    a.zoff = (const float*)zoff;
    a.out = (float*)out;
    a.Kp = Kp;
    a.Np = Np;
    a.SB = SB;
    a.ng = ng;
    a.bits = bits;
    a.splits = splits;
    a.unit = unit;
    return gemv_launch<XT, false>(a, st);
  }
  if (M <= 1)
    launch<XT, 1>(x, M, Kp, w0, fb0, sh0, w1, fb1, sh1, SB, scale, zoff, ng,
                  out, Np, st);
  else if (M <= 4)
    launch<XT, 4>(x, M, Kp, w0, fb0, sh0, w1, fb1, sh1, SB, scale, zoff, ng,
                  out, Np, st);
  else
    launch<XT, 16>(x, M, Kp, w0, fb0, sh0, w1, fb1, sh1, SB, scale, zoff,
                   ng, out, Np, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x_kind: 0 = f32, 1 = bf16, 2 = int8. w1 may be null (single field).
// splits / unit: the single-row kernel's cut of K (ops/qmatmul.
// gemv_splits, gemv_unit), read at M == 1 only. Returns the launch's
// cudaError_t.
extern "C" int qmm_launch(const void* x, int x_kind, int M, int Kp,
                          const void* w0, int fb0, int sh0, const void* w1,
                          int fb1, int sh1, int SB, const void* scale,
                          const void* zoff, int ng, void* out, int Np,
                          int splits, int unit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_kind == 0)
    return launch_tm<float>(x, M, Kp, w0, fb0, sh0, w1, fb1, sh1, SB, scale,
                            zoff, ng, out, Np, splits, unit, st);
  if (x_kind == 1)
    return launch_tm<__nv_bfloat16>(x, M, Kp, w0, fb0, sh0, w1, fb1, sh1, SB,
                                    scale, zoff, ng, out, Np, splits, unit,
                                    st);
  if (x_kind == 2)
    return launch_tm<int8_t>(x, M, Kp, w0, fb0, sh0, w1, fb1, sh1, SB, scale,
                             zoff, ng, out, Np, splits, unit, st);
  return (int)cudaErrorInvalidValue;
}
