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
// two kernels below do about it:
//   * decode (M == 1, groups covering whole subblocks): bcq_mv_kernel,
//     word-centric like qmatmul.cu's qmv_kernel. The activation row is
//     staged once in shared memory with one sum per subblock; one output
//     column per lane, so a warp's word loads are one 128-byte line; a
//     word of plane b holds the {0,1} bits of 32 rows of one subblock
//     (4 contiguous rows per sub-byte plane e), which plane_dot<1>
//     (qdot.cuh) takes 4 at a time (dp4a for int8 x). The signs never
//     materialize: with B in {0,1}, x . (2B - 1) = 2 (x . B) - sum(x), so
//     alpha applies once per (subblock, plane) on the partial, as the TPU
//     kernel applies it per group (exact int32 partials for a8).
//   * everything else (M > 1, small groups): bcq_mm_kernel, a plain
//     CUDA-core tiled product: each 32-row K tile of the weight is
//     dequantized into shared memory (sum_b alpha * sign per element, any
//     group length), the x tile beside it, and each thread accumulates a
//     4 x 4 block of outputs. Tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot.cuh"

namespace {

constexpr int COLS = 32;    // output columns per single-row block
constexpr int VWARPS = 32;  // most warps per single-row block
constexpr int WARPS = 8;

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

// ---------------------------------------------------------------------------
// single-row path (decode)
// ---------------------------------------------------------------------------

template <typename XT>
__global__ void __launch_bounds__(VWARPS * 32)
bcq_mv_kernel(const XT* __restrict__ x, int Kp,
              const int32_t* __restrict__ w, int bits, int SB,
              const float* __restrict__ alpha, int ng,
              float* __restrict__ out, int Np) {
  using ST = typename Stage<XT>::type;
  using AT = typename Acc<XT>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  ST* xs = reinterpret_cast<ST*>(smem);
  AT* xsum = reinterpret_cast<AT*>(smem + ((Kp * sizeof(ST) + 15) & ~15));
  __shared__ float red[VWARPS][COLS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = blockIdx.x * COLS + lane;
  const bool col_ok = n < Np;
  const int nsub = Kp / SB;
  for (int i = threadIdx.x; i < Kp; i += blockDim.x) xs[i] = (ST)load_x(x + i);
  __syncthreads();
  for (int s = warp; s < nsub; s += nwarps) {
    AT v = 0;
    for (int r = lane; r < SB; r += 32) v += (AT)xs[s * SB + r];
    v = warp_sum(v);
    if (lane == 0) xsum[s] = v;
  }
  __syncthreads();

  const int G = Kp / ng;          // stored rows per group
  const int Wsb = SB / 32;        // word rows per subblock (<= 16)
  const int quarter = SB / 8;     // rows per sub-byte plane of a subblock
  const size_t plane = (size_t)(Kp / 32) * Np;
  float acc = 0.f;
  for (int it = warp; it < nsub * bits; it += nwarps) {
    const int s = it / bits;
    const int b = it - s * bits;
    if (!col_ok) continue;
    const int32_t* wp = w + b * plane + (size_t)s * Wsb * Np + n;
    AT dot = 0;
#pragma unroll 4
    for (int j = 0; j < Wsb; ++j) {
      const unsigned word = (unsigned)__ldg(wp + (size_t)j * Np);
      dot = plane_dot<1>(word, xs, s * SB + 4 * j, quarter, dot);
    }
    const int g = (s * SB) / G;
    acc += __ldg(alpha + ((size_t)g * bits + b) * Np + n) *
           (2.f * (float)dot - (float)xsum[s]);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = 0.f;
    for (int i = 0; i < nwarps; ++i) v += red[i][lane];
    if (col_ok) out[n] = v;
  }
}

// the single-row path applies when groups cover whole subblocks and the
// staged row fits a block's 227 KB of shared memory
template <typename XT>
bool mv_launch(const void* x, int Kp, const void* w, int bits, int SB,
               const void* alpha, int ng, void* out, int Np,
               cudaStream_t st) {
  using ST = typename Stage<XT>::type;
  using AT = typename Acc<XT>::type;
  const int G = Kp / ng;
  const size_t smem = ((Kp * sizeof(ST) + 15) & ~(size_t)15) +
                      (size_t)(Kp / SB) * sizeof(AT);
  const size_t static_smem = sizeof(float) * VWARPS * COLS;
  if (G % SB != 0 || SB % 32 != 0 || SB > 512 ||
      smem + static_smem > 227 * 1024)
    return false;
  if (smem + static_smem > 48 * 1024)
    cudaFuncSetAttribute(bcq_mv_kernel<XT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);  // a failure shows in cudaGetLastError
  const dim3 grid((Np + COLS - 1) / COLS);
  const int threads = (grid.x <= 264 ? VWARPS : WARPS) * 32;
  bcq_mv_kernel<XT><<<grid, threads, smem, st>>>(
      (const XT*)x, Kp, (const int32_t*)w, bits, SB, (const float*)alpha, ng,
      (float*)out, Np);
  return true;
}

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
void launch(const void* x, int M, int Kp, const void* w, int bits, int SB,
            const void* alpha, int ng, void* out, int Np, cudaStream_t st) {
  if (M == 1 && mv_launch<XT>(x, Kp, w, bits, SB, alpha, ng, out, Np, st))
    return;
  const dim3 grid((Np + BN - 1) / BN, (M + BM - 1) / BM);
  bcq_mm_kernel<XT><<<grid, MM_THREADS, 0, st>>>(
      (const XT*)x, M, Kp, (const int32_t*)w, bits, SB, (const float*)alpha,
      ng, (float*)out, Np);
}

}  // namespace

// x_kind: 0 = f32, 1 = bf16, 2 = int8. Kp must be a multiple of 32 and of
// SB. Returns cudaGetLastError() after the launch.
extern "C" int bcq_launch(const void* x, int x_kind, int M, int Kp,
                          const void* w, int bits, int SB, const void* alpha,
                          int ng, void* out, int Np, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || Kp % 32 || SB < 32 || Kp % SB || ng < 1 || Kp % ng)
    return (int)cudaErrorInvalidValue;
  if (x_kind == 0)
    launch<float>(x, M, Kp, w, bits, SB, alpha, ng, out, Np, st);
  else if (x_kind == 1)
    launch<__nv_bfloat16>(x, M, Kp, w, bits, SB, alpha, ng, out, Np, st);
  else if (x_kind == 2)
    launch<int8_t>(x, M, Kp, w, bits, SB, alpha, ng, out, Np, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
