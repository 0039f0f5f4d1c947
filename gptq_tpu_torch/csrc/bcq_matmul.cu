// BCQ bitplane matmul (the LUT-GEMM path) over byteplane-packed signs.
//
// Replaces gptq_tpu/ops/bcq_matmul.py:_bcq_kernel, the Pallas TPU kernel
// behind bcq_matmul. It computes
//
//     out[m, n] = sum_g sum_b alpha[g, b, n] * sum_{k in g} (2 B_b[k, n] - 1) x[m, k]
//
// over the stored (padded) dims: x (M, Kp) f32 / bf16 / int8, sign planes
// B_b (bits, Kp/32, Np) int32, each a 1-bit byteplane field of
// ops/pack.py (bit set = +1), alpha (ng, bits, Np) f32, out (M, Np) f32.
// The caller applies the per-row int8 activation scale and the bias.
//
// Bound on an H100: at decode (M = 1) the sign-plane and alpha bytes over
// the memory rate; at M = 512 (the PPL eval) the multiply-adds. What the
// kernels do about it:
//   * decode (M == 1, groups covering whole subblocks, Np a multiple of
//     4): bcq_gemv_kernel of gemv.cuh, the streamed single-row design it
//     shares with #1's qgemv_kernel. The signs never materialize: with B
//     in {0,1}, x . (2B - 1) = 2 (x . B) - sum(x), so 2 alpha applies to
//     each exact partial of a plane (int32 for a8) and alpha times the
//     group's x sum is subtracted once, after a chunk's pieces are summed.
//   * everything else (M > 1, small groups): bcq_mm_kernel, a plain
//     CUDA-core tiled product: each 32-row K tile of the weight is
//     dequantized into shared memory (sum_b alpha * sign per element, any
//     group length), the x tile beside it, and each thread accumulates a
//     4 x 4 block of outputs. The model's rows from 2 up take the tensor
//     cores (csrc/qmma.cu) where their groups allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv.cuh"  // the single-row kernel

namespace {

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ int load_x(const int8_t* p) { return (int)*p; }

// ---------------------------------------------------------------------------
// general path: tiled CUDA-core product over a dequantized weight tile
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int MM_THREADS = 256;  // 16 x 16, each thread 4 x 4 outputs

template <typename XT>
__global__ void __launch_bounds__(MM_THREADS)
bcq_mm_kernel(const XT* __restrict__ x, int M, int Kp,
              const int32_t* __restrict__ w, int bits, int SB,
              const float* __restrict__ alpha, int ng,
              float* __restrict__ out, int Np) {
  __shared__ float xs[BK][BM + 1];  // +1: column writes hit distinct banks
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = Kp / ng;
  const int Wsb = SB / 32;
  const int quarter = SB / 8;
  const size_t plane = (size_t)(Kp / 32) * Np;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    // x tile, k fastest so a warp reads one row's 32 contiguous values
#pragma unroll
    for (int i = 0; i < BM * BK / MM_THREADS; ++i) {
      const int idx = tid + i * MM_THREADS;
      const int m = idx / BK, k = idx - m * BK;
      xs[k][m] = m0 + m < M ? (float)load_x(x + (size_t)(m0 + m) * Kp + k0 + k)
                            : 0.f;
    }
    // weight tile: sum_b alpha[g, b, n] * (+1 or -1) per element
#pragma unroll
    for (int i = 0; i < BK * BN / MM_THREADS; ++i) {
      const int idx = tid + i * MM_THREADS;
      const int k = idx / BN, nn = idx - k * BN;
      const int n = n0 + nn;
      float v = 0.f;
      if (n < Np) {
        const int row = k0 + k;
        const int s = row / SB;
        const int r = row - s * SB;
        const int e = r / quarter;
        const int rem = r - e * quarter;
        const size_t widx = (size_t)(s * Wsb + (rem >> 2)) * Np + n;
        const int shift = 8 * (rem & 3) + e;
        const float* ap = alpha + (size_t)(row / G) * bits * Np + n;
        for (int b = 0; b < bits; ++b) {
          const unsigned word = (unsigned)__ldg(w + b * plane + widx);
          const float a = __ldg(ap + (size_t)b * Np);
          v += ((word >> shift) & 1u) ? a : -a;
        }
      }
      ws[k][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Np) out[(size_t)m * Np + n] = acc[i][j];
    }
  }
}

template <typename XT>
int launch(const void* x, int M, int Kp, const void* w, int bits, int SB,
           const void* alpha, int ng, void* out, int Np, int splits,
           int unit, cudaStream_t st) {
  if (M == 1 && (Kp / ng) % SB == 0 && Np % 4 == 0) {
    GemvArgs a{};
    a.x = x;
    a.w0 = (const int32_t*)w;
    a.grid = (const float*)alpha;
    a.out = (float*)out;
    a.Kp = Kp;
    a.Np = Np;
    a.SB = SB;
    a.ng = ng;
    a.bits = bits;
    a.splits = splits;
    a.unit = unit;
    return gemv_launch<XT, true>(a, st);
  }
  const dim3 grid((Np + BN - 1) / BN, (M + BM - 1) / BM);
  bcq_mm_kernel<XT><<<grid, MM_THREADS, 0, st>>>(
      (const XT*)x, M, Kp, (const int32_t*)w, bits, SB, (const float*)alpha,
      ng, (float*)out, Np);
  return (int)cudaGetLastError();
}

}  // namespace

// x_kind: 0 = f32, 1 = bf16, 2 = int8. Kp must be a multiple of 32 and of
// SB. splits / unit: the single-row kernel's cut of K (ops/qmatmul.
// gemv_splits, gemv_unit), read at M == 1 only. Returns the launch's
// cudaError_t.
extern "C" int bcq_launch(const void* x, int x_kind, int M, int Kp,
                          const void* w, int bits, int SB, const void* alpha,
                          int ng, void* out, int Np, int splits, int unit,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || Kp % 32 || SB < 32 || Kp % SB || ng < 1 || Kp % ng)
    return (int)cudaErrorInvalidValue;
  if (x_kind == 0)
    return launch<float>(x, M, Kp, w, bits, SB, alpha, ng, out, Np, splits,
                         unit, st);
  if (x_kind == 1)
    return launch<__nv_bfloat16>(x, M, Kp, w, bits, SB, alpha, ng, out, Np,
                                 splits, unit, st);
  if (x_kind == 2)
    return launch<int8_t>(x, M, Kp, w, bits, SB, alpha, ng, out, Np, splits,
                          unit, st);
  return (int)cudaErrorInvalidValue;
}
