// Dequantize + matmul over a bank of E packed expert weights
// (ops/pack.py PackedExperts: words (E, Kp/P, Np) per field, grids
// (E, ng, Np) f32).
//
// Replaces two Pallas kernels of gptq_tpu/ops/qmatmul.py:
//   * qexpert_kernel <- _qmm_expert_kernel (expert_dequant_matmul), #8:
//       out[e, m, n] = sum_k X(e)[m, k] * dequant(bank[e])[k, n]
//     for every expert e in one launch; X is (M, Kp) shared by the experts
//     (gate / up) or (E, M, Kp), one per expert (down). M <= 32.
//   * qsel_gemv_kernel (gemv.cuh, M = 1) and qsel_kernel (the single-row
//     body of qmv.cuh, M > 1) <- the inner kernel of
//     expert_dequant_matmul_select, #9:
//       out[m, n] = sum_k x[m, k] * dequant(bank[e_idx])[k, n]
//     The index is read by the kernel from a device int32 (the Pallas
//     kernel's scalar prefetch), which offsets the bank's pointers: the
//     host never reads the routing, and only the selected expert's words
//     are read. At one row (the MoE decode, the only row count the model
//     selects at) the expert streams as #1's single-row kernel streams a
//     weight: 128-column chunks cut in K into a cluster's pieces, a
//     producer warp bulk-copying 512-byte word rows through a ring of
//     stages, the pieces summed in piece order by rank 0 (gemv.cuh's
//     header). More rows keep qsel_kernel.
// x is f32, bf16 or int8 (no row scale: the MoE path passes activations
// in their own dtype); fields 2/3/4/8 bits; groups of whole subblocks
// (groupsize -1 or a multiple of the subblock); f32 accumulation and
// output. Pad rows and columns carry zero grids.
//
// Bound on an H100: #9 streams one expert's packed weight once (29.4 MB
// at 4-bit, Mixtral's 4096 x 14336: 8.8 us at 3.35 TB/s), as #1's
// single-row kernel streams a weight. #8 streams the whole bank once (234.9 MB, 70 us), and at
// M = 16 its 15 GFLOP also bound a kernel on CUDA cores.
//
// Design of #8 (simple and right first; tensor cores and TMA later):
//   * grid (column tiles of 128, expert). A block's 8 warps are 4 column
//     groups (one column per lane: a warp's word loads are one 128-byte
//     line) times 2 K slices that take alternate (subblock, run of <= 16
//     word rows) items.
//   * the rows of X are staged in shared memory in chunks of whole
//     subblocks (32 f32 rows of 14336 are 1.8 MB, far above a block's
//     227 KB), a16 as f32, a8 as int8, with each row's subblock sums for
//     the zero offset. One staged chunk serves the block's 128 columns.
//   * a lane loads an item's words into registers once and applies each
//     to every row: a batch of words (32 codes) turns to floats once (a8:
//     masked bytes into dp4a) and serves the rows 4 at a time. The group
//     grid applies to each batch's partial; the zero offset once per
//     subblock.
//     Partials gather per (warp, row, lane) in shared memory, and the two
//     K slices are summed at the end: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv.cuh"  // qsel_gemv_kernel
#include "qmv.cuh"

namespace {

constexpr int XW = 8;              // warps per block
constexpr int XTHREADS = XW * 32;
constexpr int CG = 4;              // 32-column groups per block
constexpr int KSL = XW / CG;       // K slices
constexpr int BN = CG * 32;        // columns per block
constexpr int RG = 4;              // rows per pass (registers)
constexpr int MAXM = 32;           // most rows
constexpr int XSTAGE_BYTES = 65536; // staged rows of X
constexpr size_t XSUM_BYTES = 4 * (XSTAGE_BYTES / 32);
constexpr size_t ACC_BYTES = sizeof(float) * XW * MAXM * 32;
constexpr size_t SMEM_BYTES = XSTAGE_BYTES + XSUM_BYTES + ACC_BYTES;

__device__ __forceinline__ float stage_val(float v) { return v; }
__device__ __forceinline__ float stage_val(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int8_t stage_val(int8_t v) { return v; }

// byte b of cb (< 256) as an exact float: 2^23 + byte, less 2^23
__device__ __forceinline__ float byte_f(unsigned cb, int b) {
  return __uint_as_float(__byte_perm(cb, 0x4B00u, 0x5440u + b)) - 8388608.f;
}

// The rows' dot with a batch of WB words of one field (word w holds rows
// xrow0 + 4*w + b of each plane e, at + e * quarter). The batch's codes
// turn to floats once and serve all `rows` staged rows, RG at a time
// (WB = FB words: 32 codes per batch, whatever the field width).
template <int FB>
__device__ __forceinline__ void batch_rows(const unsigned* word,
                                           const float* xs, int kt,
                                           int xrow0, int quarter, int M,
                                           float sc, const float* xsum_z,
                                           int nsb, float z, float* accs) {
  constexpr int WB = FB;
  constexpr int PL = 8 / FB;
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  float cf[WB][PL][4];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    const unsigned wd = FB == 8 ? word[w] ^ 0x80808080u : word[w];
#pragma unroll
    for (int e = 0; e < PL; ++e) {
      const unsigned cb = (wd >> (FB * e)) & BM;
#pragma unroll
      for (int b = 0; b < 4; ++b) cf[w][e][b] = byte_f(cb, b);
    }
  }
  for (int m0 = 0; m0 < M; m0 += RG) {
    float d[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      d[r] = 0.f;
      if (m0 + r < M) {
        const float* xr = xs + (m0 + r) * kt + xrow0;
#pragma unroll
        for (int w = 0; w < WB; ++w)
#pragma unroll
          for (int e = 0; e < PL; ++e) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xr + 4 * w + e * quarter);
            d[r] += xv.x * cf[w][e][0] + xv.y * cf[w][e][1] +
                    xv.z * cf[w][e][2] + xv.w * cf[w][e][3];
          }
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      if (m0 + r < M) {
        float v = d[r] * sc;
        if (xsum_z != nullptr) v -= xsum_z[(m0 + r) * nsb] * z;
        accs[(m0 + r) * 32] += v;
      }
    }
  }
}

// the same for int8 staged rows: the masked code bytes go straight into
// dp4a (exact int32 per batch)
template <int FB>
__device__ __forceinline__ void batch_rows(const unsigned* word,
                                           const int8_t* xs, int kt,
                                           int xrow0, int quarter, int M,
                                           float sc, const int* xsum_z,
                                           int nsb, float z, float* accs) {
  constexpr int WB = FB;
  constexpr int PL = 8 / FB;
  constexpr unsigned BM = ((1u << FB) - 1u) * 0x01010101u;
  unsigned cb[WB][PL];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    const unsigned wd = FB == 8 ? word[w] ^ 0x80808080u : word[w];
#pragma unroll
    for (int e = 0; e < PL; ++e) cb[w][e] = (wd >> (FB * e)) & BM;
  }
  for (int m0 = 0; m0 < M; m0 += RG) {
    int d[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      d[r] = 0;
      if (m0 + r < M) {
        const int8_t* xr = xs + (m0 + r) * kt + xrow0;
#pragma unroll
        for (int w = 0; w < WB; ++w)
#pragma unroll
          for (int e = 0; e < PL; ++e)
            d[r] = dp4a_su(
                *reinterpret_cast<const int*>(xr + 4 * w + e * quarter),
                cb[w][e], d[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      if (m0 + r < M) {
        float v = (float)d[r] * sc;
        if (xsum_z != nullptr) v -= (float)xsum_z[(m0 + r) * nsb] * z;
        accs[(m0 + r) * 32] += v;
      }
    }
  }
}

// one field's items over the staged chunk (subblocks s0 .. s0 + nsb of
// the weight) for this warp's K slice; partials into accs[m * 32]. An
// item's words are all loaded first (JC loads in flight), then taken in
// batches of FB words.
template <typename ST, int FB>
__device__ __noinline__ void chunk_items(
    const int32_t* __restrict__ w, int sh, const ST* xs, int kt,
    const typename Acc<ST>::type* xsum, int nsb, int s0, int SB, int G,
    const float* __restrict__ scale, const float* __restrict__ zoff, int Np,
    int n, bool first, int M, int ks, float* accs) {
  constexpr int P = 32 / FB;
  const int Wsb = SB / P;
  const int quarter = 4 * Wsb;
  const int jc = Wsb < JC ? Wsb : JC;  // a power of two: whole batches
  const int nch = Wsb / jc;
  for (int it = ks; it < nsb * nch; it += KSL) {
    const int sl = it / nch;
    const int c = it - sl * nch;
    const int s = s0 + sl;
    const int32_t* wp = w + (size_t)(s * Wsb + c * jc) * Np + n;
    unsigned word[JC];
#pragma unroll
    for (int jj = 0; jj < JC; ++jj)
      word[jj] = jj < jc ? (unsigned)__ldg(wp + (size_t)jj * Np) : 0u;
    const int g = (s * SB) / G;
    const float sc = scale[(size_t)g * Np + n] * (float)(1 << sh);
    const bool zero_term = first && c == 0;
    const float z = zero_term ? zoff[(size_t)g * Np + n] : 0.f;
#pragma unroll
    for (int b0 = 0; b0 < JC; b0 += FB) {
      if (b0 < jc)
        batch_rows<FB>(word + b0, xs, kt, sl * SB + 4 * (c * jc + b0),
                       quarter, M, sc,
                       zero_term && b0 == 0 ? xsum + sl : nullptr, nsb, z,
                       accs);
    }
  }
}

template <typename XT>
__global__ void __launch_bounds__(XTHREADS, 2)
qexpert_kernel(const XT* __restrict__ x, int per_x, int M, int Kp,
               const int32_t* __restrict__ w0,
               const int32_t* __restrict__ w1, int bits, int SB,
               const float* __restrict__ scale,
               const float* __restrict__ zoff, int ng,
               float* __restrict__ out, int Np, int kt_max) {
  using ST = typename Stage<XT>::type;
  using AT = typename Acc<XT>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  ST* xs = reinterpret_cast<ST*>(smem);
  AT* xsum = reinterpret_cast<AT*>(smem + XSTAGE_BYTES);
  float* acc = reinterpret_cast<float*>(smem + XSTAGE_BYTES + XSUM_BYTES);

  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = warp % CG;
  const int ks = warp / CG;
  const int n = blockIdx.x * BN + cg * 32 + lane;
  const bool col_ok = n < Np;
  const int fb0 = bits == 3 ? 2 : bits;
  const int32_t* we0 = w0 + (size_t)e * ((size_t)Kp * fb0 / 32) * Np;
  const int32_t* we1 =
      w1 != nullptr ? w1 + (size_t)e * ((size_t)Kp / 32) * Np : nullptr;
  const float* se = scale + (size_t)e * ng * Np;
  const float* ze = zoff + (size_t)e * ng * Np;
  const XT* xe = x + (per_x ? (size_t)e * M * Kp : 0);
  const int G = Kp / ng;
  float* accs = acc + warp * MAXM * 32 + lane;
  for (int m = 0; m < M; ++m) accs[m * 32] = 0.f;

  for (int k0 = 0; k0 < Kp; k0 += kt_max) {
    const int kt = min(kt_max, Kp - k0);
    const int nsb = kt / SB;
    __syncthreads();  // every warp is done with the previous chunk
    if (sizeof(XT) == sizeof(ST)) {  // f32 / int8: 16-byte copies
      const int vec = 16 / (int)sizeof(ST);
      const int per_row = kt / vec;
      for (int i = threadIdx.x; i < M * per_row; i += XTHREADS) {
        const int m = i / per_row;
        const int v = i - m * per_row;
        reinterpret_cast<uint4*>(xs + m * kt)[v] = __ldg(
            reinterpret_cast<const uint4*>(xe + (size_t)m * Kp + k0) + v);
      }
    } else {  // bf16 widened to f32
      for (int i = threadIdx.x; i < M * kt; i += XTHREADS) {
        const int m = i / kt;
        const int k = i - m * kt;
        xs[i] = (ST)stage_val(xe[(size_t)m * Kp + k0 + k]);
      }
    }
    __syncthreads();
    for (int p = warp; p < M * nsb; p += XW) {
      const int m = p / nsb;
      const int sl = p - m * nsb;
      AT a = 0;
      for (int r = lane; r < SB; r += 32) a += (AT)xs[m * kt + sl * SB + r];
      a = warp_sum(a);
      if (lane == 0) xsum[p] = a;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int s0 = k0 / SB;
    switch (bits) {
      case 2:
        chunk_items<ST, 2>(we0, 0, xs, kt, xsum, nsb, s0, SB, G, se, ze, Np,
                           n, true, M, ks, accs);
        break;
      case 3:  // a 2-bit field and a 1-bit field shifted by 2
        chunk_items<ST, 2>(we0, 0, xs, kt, xsum, nsb, s0, SB, G, se, ze, Np,
                           n, true, M, ks, accs);
        chunk_items<ST, 1>(we1, 2, xs, kt, xsum, nsb, s0, SB, G, se, ze, Np,
                           n, false, M, ks, accs);
        break;
      case 4:
        chunk_items<ST, 4>(we0, 0, xs, kt, xsum, nsb, s0, SB, G, se, ze, Np,
                           n, true, M, ks, accs);
        break;
      default:
        chunk_items<ST, 8>(we0, 0, xs, kt, xsum, nsb, s0, SB, G, se, ze, Np,
                           n, true, M, ks, accs);
        break;
    }
  }
  __syncthreads();
  // sum the K slices' partials of each (column group, row, lane)
  for (int i = threadIdx.x; i < CG * M * 32; i += XTHREADS) {
    const int g = i / (M * 32);
    const int rem = i - g * M * 32;
    const int m = rem >> 5;
    const int l = rem & 31;
    const int nn = blockIdx.x * BN + g * 32 + l;
    if (nn >= Np) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KSL; ++k) s += acc[((k * CG + g) * MAXM + m) * 32 + l];
    out[((size_t)e * M + m) * Np + nn] = s;
  }
}

template <typename XT>
int expert_launch(const void* x, int per_x, int E, int M, int Kp,
                  const void* w0, const void* w1, int bits, int SB,
                  const void* scale, const void* zoff, int ng, void* out,
                  int Np, cudaStream_t st) {
  using ST = typename Stage<XT>::type;
  const int elems = XSTAGE_BYTES / (int)sizeof(ST);
  int kt = (elems / M) / SB * SB;
  if (kt > Kp) kt = Kp;
  if (M < 1 || M > MAXM || kt < SB || (Kp / ng) % SB != 0)
    return (int)cudaErrorInvalidValue;
  auto kern = qexpert_kernel<XT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);  // a failure shows at the launch
  const dim3 grid((Np + BN - 1) / BN, E);
  kern<<<grid, XTHREADS, SMEM_BYTES, st>>>(
      (const XT*)x, per_x, M, Kp, (const int32_t*)w0, (const int32_t*)w1,
      bits, SB, (const float*)scale, (const float*)zoff, ng, (float*)out, Np,
      kt);
  return (int)cudaGetLastError();
}

}  // namespace

// #8. x_kind: 0 = f32, 1 = bf16, 2 = int8; per_x: x is (E, M, Kp), else
// (M, Kp). w1: the 1-bit field of a 3-bit bank, else null. out (E, M, Np).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes the kernel does not take, launching nothing).
extern "C" int qexpert_launch(const void* x, int x_kind, int per_x, int E,
                              int M, int Kp, const void* w0, const void* w1,
                              int bits, int SB, const void* scale,
                              const void* zoff, int ng, void* out, int Np,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_kind == 0)
    return expert_launch<float>(x, per_x, E, M, Kp, w0, w1, bits, SB, scale,
                                zoff, ng, out, Np, st);
  if (x_kind == 1)
    return expert_launch<__nv_bfloat16>(x, per_x, E, M, Kp, w0, w1, bits, SB,
                                        scale, zoff, ng, out, Np, st);
  if (x_kind == 2)
    return expert_launch<int8_t>(x, per_x, E, M, Kp, w0, w1, bits, SB, scale,
                                 zoff, ng, out, Np, st);
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int select_gemv(const void* x, int Kp, int bits, const void* w0,
                const void* w1, int SB, const void* scale, const void* zoff,
                int ng, const int* eidx, int E, void* out, int Np, int splits,
                int unit, cudaStream_t st) {
  if (bits != 2 && bits != 3 && bits != 4 && bits != 8)
    return (int)cudaErrorInvalidValue;
  GemvArgs a{};
  a.x = x;
  a.w0 = (const int32_t*)w0;
  a.w1 = (const int32_t*)w1;
  a.grid = (const float*)scale;
  a.zoff = (const float*)zoff;
  a.out = (float*)out;
  a.eidx = eidx;
  a.E = E;
  a.Kp = Kp;
  a.Np = Np;
  a.SB = SB;
  a.ng = ng;
  a.bits = bits;
  a.splits = splits;
  a.unit = unit;
  return gemv_launch<XT, false, true>(a, st);
}

// #9. x (M, Kp); eidx: a device int32 expert index into the bank of E;
// out (M, Np). splits / unit: at M = 1, the cut of K of the single-row
// kernel (ops/qmatmul.gemv_splits, gemv_unit), which then takes the call
// (qsel_gemv_kernel); splits = 0 launches qsel_kernel (any M). Same return
// convention.
extern "C" int qselect_launch(const void* x, int x_kind, int M, int Kp,
                              const void* w0, const void* w1, int bits,
                              int SB, const void* scale, const void* zoff,
                              int ng, const void* eidx, int E, void* out,
                              int Np, int splits, int unit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* ei = (const int*)eidx;
  if (splits > 0) {
    if (M != 1 || x_kind < 0 || x_kind > 2) return (int)cudaErrorInvalidValue;
    if (x_kind == 0)
      return select_gemv<float>(x, Kp, bits, w0, w1, SB, scale, zoff, ng, ei,
                                E, out, Np, splits, unit, st);
    if (x_kind == 1)
      return select_gemv<__nv_bfloat16>(x, Kp, bits, w0, w1, SB, scale, zoff,
                                        ng, ei, E, out, Np, splits, unit, st);
    return select_gemv<int8_t>(x, Kp, bits, w0, w1, SB, scale, zoff, ng, ei,
                               E, out, Np, splits, unit, st);
  }
  bool ok;
  if (x_kind == 0)
    ok = qsel_launch<float>(x, M, Kp, bits, w0, w1, SB, scale, zoff, ng, ei,
                            E, out, Np, st);
  else if (x_kind == 1)
    ok = qsel_launch<__nv_bfloat16>(x, M, Kp, bits, w0, w1, SB, scale, zoff,
                                    ng, ei, E, out, Np, st);
  else if (x_kind == 2)
    ok = qsel_launch<int8_t>(x, M, Kp, bits, w0, w1, SB, scale, zoff, ng, ei,
                             E, out, Np, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
