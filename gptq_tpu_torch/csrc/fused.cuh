// Device code of the fused serving kernels, shared by ffn.cu (#4-#6) and
// layer_fused.cu (#12): the packed-weight descriptor, the shared-memory
// plan, row statistics and staging, the word-centric tile product over
// byteplane codes (qdot.cuh), the phases of the cooperative MLP kernel,
// and the occupancy and cooperative-launch helpers. ffn.cu's header
// comment gives the design.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdot.cuh"
#include "wstream.cuh"  // bf16r, to_stage

namespace cg = cooperative_groups;

// One packed weight (mirrored by ops/ffn.py:_WeightDesc). Uniform grids
// (fmt 0): w0 the first field, w1 the 1-bit field of a 3-bit weight, else
// null, scale / zoff the grids. BCQ (fmt FMT_BCQ, ffn.cu only): w0 the
// (bits, Kp/32, Np) sign planes, each a 1-bit field (bit set = +1), alpha
// their (ng, bits, Np) scales, w1 / scale / zoff null. bias (Np f32) may
// be null.
struct WeightDesc {
  const int32_t* w0;
  const int32_t* w1;
  const float* scale;  // (ng, Np)
  const float* zoff;   // (ng, Np)
  const float* bias;
  int bits, Kp, Np, ng, SB;  // bits: BCQ sign planes
  const float* alpha;        // (ng, bits, Np)
  int fmt;
};

constexpr int FMT_BCQ = 1;

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 32;  // output columns per tile
constexpr int JC = 16;    // word rows per work item
constexpr int RG = 4;     // most rows of one pass (registers per lane)
constexpr int MAX_ROWS = 32;

template <typename ST>
struct Acc { using type = float; };
template <>
struct Acc<int8_t> { using type = int; };

__device__ __forceinline__ float ld(int8_t v) { return (float)v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The shared-memory plan of a block (dynamic shared memory).
template <int TM, typename ST>
struct Plan {
  using AT = typename Acc<ST>::type;
  static constexpr int STAGE = TM == 1 ? 32768 : 65536;  // bytes of rows
  static constexpr int RT = TM == 1 ? 1 : RG;  // rows of one pass
  static constexpr int ELEMS = STAGE / (int)sizeof(ST);
  static constexpr int MAXSB = ELEMS / 32;  // subblock sums (SB >= 32)
  static constexpr size_t BYTES =
      STAGE + sizeof(AT) * MAXSB + sizeof(float) * RT * WARPS * COLS +
      sizeof(float) * (2 * TM * COLS + 3 * TM + WARPS);

  ST* xs;      // staged rows (TM x chunk)
  AT* xsum;    // per row and subblock sums of the staged values
  float* red;  // RT x WARPS x COLS warp partials
  float* res0;
  float* res1;  // TM x COLS tile results (res1: the up half)
  float* stat;  // mu[TM], rstd[TM], sx[TM]
  float* sred;  // WARPS block-reduction slots

  __device__ explicit Plan(unsigned char* p) {
    xs = reinterpret_cast<ST*>(p);
    p += STAGE;
    xsum = reinterpret_cast<AT*>(p);
    p += sizeof(AT) * MAXSB;
    red = reinterpret_cast<float*>(p);
    res0 = red + RT * WARPS * COLS;
    res1 = res0 + TM * COLS;
    stat = res1 + TM * COLS;
    sred = stat + 3 * TM;
  }
};

// rows of a chunk: whole subblocks, as many as the stage holds
__host__ __device__ inline int chunk_rows(int Kp, int SB, int TM, int elems) {
  const int kt = (elems / TM) / SB * SB;
  return kt < Kp ? kt : Kp;
}

// A phase's input: M rows of K f32 values (row stride K), optionally
// normalized: norm 0 rmsnorm, 1 rmsnorm1p, 2 layernorm (with nb), -1 none.
struct RowSrc {
  const float* x;
  const float* nw;
  const float* nb;
  int K, norm;
  float eps;
};

__device__ __forceinline__ float transform(const RowSrc& s, float v, int k,
                                           float mu, float rstd) {
  if (s.norm < 0) return v;
  if (s.norm == 2) return bf16r((v - mu) * rstd * s.nw[k] + s.nb[k]);
  const float w = s.norm == 1 ? 1.f + s.nw[k] : s.nw[k];
  return bf16r(v * rstd * w);
}

__device__ float block_sum(float v, float* sred) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r += sred[w];
  __syncthreads();
  return r;
}

__device__ float block_max(float v, float* sred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r = fmaxf(r, sred[w]);
  __syncthreads();
  return r;
}

// norm statistics and the int8 scale of each input row, into plan.stat
template <int TM, typename ST>
__device__ void row_stats(const RowSrc& s, int M, const Plan<TM, ST>& pl) {
  constexpr bool A8 = sizeof(ST) == 1;
  for (int m = 0; m < M; ++m) {
    const float* x = s.x + (size_t)m * s.K;
    float mu = 0.f, rstd = 1.f;
    if (s.norm == 2) {
      float a = 0.f;
      for (int k = threadIdx.x; k < s.K; k += THREADS) a += x[k];
      mu = block_sum(a, pl.sred) / (float)s.K;
      float v = 0.f;
      for (int k = threadIdx.x; k < s.K; k += THREADS) {
        const float d = x[k] - mu;
        v += d * d;
      }
      rstd = 1.f / sqrtf(block_sum(v, pl.sred) / (float)s.K + s.eps);
    } else if (s.norm >= 0) {
      float v = 0.f;
      for (int k = threadIdx.x; k < s.K; k += THREADS) v += x[k] * x[k];
      rstd = 1.f / sqrtf(block_sum(v, pl.sred) / (float)s.K + s.eps);
    }
    float sx = 1.f;
    if (A8) {
      float a = 0.f;
      for (int k = threadIdx.x; k < s.K; k += THREADS)
        a = fmaxf(a, fabsf(transform(s, x[k], k, mu, rstd)));
      sx = block_max(a, pl.sred) / 127.f + 1e-12f;
    }
    if (threadIdx.x == 0) {
      pl.stat[m] = mu;
      pl.stat[TM + m] = rstd;
      pl.stat[2 * TM + m] = sx;
    }
  }
  __syncthreads();
}

// stage rows [k0, k0 + kt) of the transformed input, and their subblock sums
template <int TM, typename ST>
__device__ void stage(const RowSrc& s, int M, int k0, int kt, int SB,
                      const Plan<TM, ST>& pl) {
  using AT = typename Acc<ST>::type;
  for (int i = threadIdx.x; i < M * kt; i += THREADS) {
    const int m = i / kt;
    const int k = k0 + (i - m * kt);
    pl.xs[i] = to_stage(transform(s, s.x[(size_t)m * s.K + k], k, pl.stat[m],
                                  pl.stat[TM + m]),
                        pl.stat[2 * TM + m], (ST*)nullptr);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int nsb = kt / SB;
  for (int p = threadIdx.x >> 5; p < M * nsb; p += WARPS) {
    const int m = p / nsb;
    const int sl = p - m * nsb;
    AT a = 0;
    for (int r = lane; r < SB; r += 32) a += (AT)ld(pl.xs[m * kt + sl * SB + r]);
    a = warp_sum(a);
    if (lane == 0) pl.xsum[p] = a;
  }
  __syncthreads();
}

// one field's contribution to the tile's column n over the staged chunk
// (subblocks s0 .. s0 + nsb of the weight), for RT staged rows at xs (row
// stride kt; `rows` of them real) with their subblock sums at xsum
template <int RT, typename ST, int FB>
__device__ __forceinline__ void field_tile(
    const int32_t* __restrict__ w, int sh, const ST* xs, int kt,
    const typename Acc<ST>::type* xsum, int nsb, int s0, int SB, int G,
    const float* __restrict__ scale, const float* __restrict__ zoff, int Np,
    int n, bool first, int rows, float (&acc)[RT]) {
  using AT = typename Acc<ST>::type;
  constexpr int P = 32 / FB;
  const int Wsb = SB / P;
  const int quarter = 4 * Wsb;
  const int jc = Wsb < JC ? Wsb : JC;
  const int nch = Wsb / jc;
  for (int it = threadIdx.x >> 5; it < nsb * nch; it += WARPS) {
    const int sl = it / nch;
    const int c = it - sl * nch;
    const int s = s0 + sl;
    const int32_t* wp = w + (size_t)(s * Wsb + c * jc) * Np + n;
    unsigned word[JC];
#pragma unroll
    for (int jj = 0; jj < JC; ++jj)
      word[jj] = jj < jc ? (unsigned)__ldg(wp + (size_t)jj * Np) : 0u;
    AT dot[RT];
#pragma unroll
    for (int m = 0; m < RT; ++m) dot[m] = 0;
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      if (jj < jc) {
        const int xrow = sl * SB + 4 * (c * jc + jj);
#pragma unroll
        for (int m = 0; m < RT; ++m)
          if (RT == 1 || m < rows)
            dot[m] = plane_dot<FB>(word[jj], xs + m * kt, xrow, quarter,
                                   dot[m]);
      }
    }
    const int g = (s * SB) / G;
    const float sc = scale[(size_t)g * Np + n] * (float)(1 << sh);
#pragma unroll
    for (int m = 0; m < RT; ++m) acc[m] += (float)dot[m] * sc;
    if (first && c == 0) {
      const float z = zoff[(size_t)g * Np + n];
#pragma unroll
      for (int m = 0; m < RT; ++m)
        if (RT == 1 || m < rows) acc[m] -= (float)xsum[m * nsb + sl] * z;
    }
  }
}

// The BCQ counterpart of field_tile: every sign plane's contribution to
// column n over the staged chunk. With B in {0,1}, x . (2B - 1) =
// 2 (x . B) - sum(x): plane_dot<1> gives x . B per (subblock, run of word
// rows, plane), the subblock sum comes from xsum once per subblock, and
// alpha[g, b, n] applies once to that partial (exact int32 for a8).
template <int RT, typename ST>
__device__ __forceinline__ void bcq_planes_tile(
    const WeightDesc& wd, const ST* xs, int kt,
    const typename Acc<ST>::type* xsum, int nsb, int s0, int G, int n,
    int rows, float (&acc)[RT]) {
  using AT = typename Acc<ST>::type;
  const int Wsb = wd.SB / 32;
  const int quarter = 4 * Wsb;
  const int jc = Wsb < JC ? Wsb : JC;
  const int nch = Wsb / jc;
  const size_t plane = (size_t)(wd.Kp / 32) * wd.Np;
  for (int it = threadIdx.x >> 5; it < nsb * nch * wd.bits; it += WARPS) {
    const int b = it % wd.bits;
    const int sc = it / wd.bits;
    const int sl = sc / nch;
    const int c = sc - sl * nch;
    const int s = s0 + sl;
    const int32_t* wp =
        wd.w0 + b * plane + (size_t)(s * Wsb + c * jc) * wd.Np + n;
    unsigned word[JC];
#pragma unroll
    for (int jj = 0; jj < JC; ++jj)
      word[jj] = jj < jc ? (unsigned)__ldg(wp + (size_t)jj * wd.Np) : 0u;
    AT dot[RT];
#pragma unroll
    for (int m = 0; m < RT; ++m) dot[m] = 0;
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      if (jj < jc) {
        const int xrow = sl * wd.SB + 4 * (c * jc + jj);
#pragma unroll
        for (int m = 0; m < RT; ++m)
          if (RT == 1 || m < rows)
            dot[m] = plane_dot<1>(word[jj], xs + m * kt, xrow, quarter,
                                  dot[m]);
      }
    }
    const int g = (s * wd.SB) / G;
    const float a = __ldg(wd.alpha + ((size_t)g * wd.bits + b) * wd.Np + n);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      const AT sx = (c == 0 && (RT == 1 || m < rows)) ? xsum[m * nsb + sl]
                                                      : (AT)0;
      acc[m] += a * (float)(2 * dot[m] - sx);
    }
  }
}

// res[m][l] = sum over k of the staged row m times dequant(W)[k, n0 + l],
// for m < M (in units of the staged values: times sx gives the product).
// Rows go in passes of RT (registers); a row longer than the stage is
// staged chunk by chunk. `staged` is the chunk the stage holds (-1: none),
// uniform in the block. Not inlined: one copy serves every call site.
// BCQ selects the sign-plane product; the uniform instantiation is the
// only one that layer_fused.cu references (see any_tile).
template <int TM, typename ST, bool BCQ>
__device__ __noinline__ void tile_impl(const WeightDesc& wd, const RowSrc& s,
                                       int M, int n0, int KT,
                                       const Plan<TM, ST>& pl, int& staged,
                                       float* res) {
  constexpr int RT = Plan<TM, ST>::RT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = n0 + lane;
  const int G = wd.Kp / wd.ng;
  const int nchunks = (wd.Kp + KT - 1) / KT;
  for (int r0 = 0; r0 < M; r0 += RT) {
    const int rows = min(RT, M - r0);
    float acc[RT];
#pragma unroll
    for (int m = 0; m < RT; ++m) acc[m] = 0.f;
    for (int ci = 0; ci < nchunks; ++ci) {
      const int k0 = ci * KT;
      const int kt = min(KT, wd.Kp - k0);
      if (staged != ci) {
        __syncthreads();  // every warp is done with the previous chunk
        stage<TM, ST>(s, M, k0, kt, wd.SB, pl);
        staged = ci;
      }
      const int nsb = kt / wd.SB;
      const int s0 = k0 / wd.SB;
      const ST* xs = pl.xs + r0 * kt;
      const auto* xsum = pl.xsum + r0 * nsb;
      if constexpr (BCQ) {
        bcq_planes_tile<RT, ST>(wd, xs, kt, xsum, nsb, s0, G, n, rows, acc);
      } else {
        switch (wd.bits) {
          case 1:
            field_tile<RT, ST, 1>(wd.w0, 0, xs, kt, xsum, nsb, s0, wd.SB, G,
                                  wd.scale, wd.zoff, wd.Np, n, true, rows,
                                  acc);
            break;
          case 2:
            field_tile<RT, ST, 2>(wd.w0, 0, xs, kt, xsum, nsb, s0, wd.SB, G,
                                  wd.scale, wd.zoff, wd.Np, n, true, rows,
                                  acc);
            break;
          case 3:  // a 2-bit field and a 1-bit field shifted by 2
            field_tile<RT, ST, 2>(wd.w0, 0, xs, kt, xsum, nsb, s0, wd.SB, G,
                                  wd.scale, wd.zoff, wd.Np, n, true, rows,
                                  acc);
            field_tile<RT, ST, 1>(wd.w1, 2, xs, kt, xsum, nsb, s0, wd.SB, G,
                                  wd.scale, wd.zoff, wd.Np, n, false, rows,
                                  acc);
            break;
          case 4:
            field_tile<RT, ST, 4>(wd.w0, 0, xs, kt, xsum, nsb, s0, wd.SB, G,
                                  wd.scale, wd.zoff, wd.Np, n, true, rows,
                                  acc);
            break;
          default:
            field_tile<RT, ST, 8>(wd.w0, 0, xs, kt, xsum, nsb, s0, wd.SB, G,
                                  wd.scale, wd.zoff, wd.Np, n, true, rows,
                                  acc);
            break;
        }
      }
    }
    // sum the warps' partials of this pass's rows
#pragma unroll
    for (int m = 0; m < RT; ++m) pl.red[(m * WARPS + warp) * COLS + lane] = acc[m];
    __syncthreads();
    for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
      const int m = i / COLS;
      const int l = i - m * COLS;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += pl.red[(m * WARPS + w) * COLS + l];
      res[(r0 + m) * COLS + l] = a;
    }
    __syncthreads();
  }
}

// the tile product of one weight: ANY (ffn.cu) also takes BCQ weights,
// the sign-plane tile being a separate function so that it adds nothing
// to the uniform one's registers; without ANY (layer_fused.cu) only the
// uniform tile is compiled
template <int TM, typename ST, bool ANY>
__device__ __forceinline__ void any_tile(const WeightDesc& wd,
                                         const RowSrc& s, int M, int n0,
                                         int KT, const Plan<TM, ST>& pl,
                                         int& staged, float* res) {
  if constexpr (ANY) {
    if (wd.fmt == FMT_BCQ) {
      tile_impl<TM, ST, true>(wd, s, M, n0, KT, pl, staged, res);
      return;
    }
  }
  tile_impl<TM, ST, false>(wd, s, M, n0, KT, pl, staged, res);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(p)));
}

// pull the word lines of the tile at column n0 into L2
__device__ void prefetch_tile(const WeightDesc& wd, int n0) {
  // BCQ: bits planes of Kp/32 word rows, one after another
  const int fb0 = wd.fmt != FMT_BCQ && wd.bits == 3 ? 2 : wd.bits;
  const int rows0 = wd.Kp * fb0 / 32;
  for (int r = threadIdx.x; r < rows0; r += THREADS)
    prefetch_l2(wd.w0 + (size_t)r * wd.Np + n0);
  if (wd.w1 != nullptr)
    for (int r = threadIdx.x; r < wd.Kp / 32; r += THREADS)
      prefetch_l2(wd.w1 + (size_t)r * wd.Np + n0);
}

__device__ __forceinline__ float act_fn(int act, float g) {
  switch (act) {
    case 0: return g * (1.f / (1.f + expf(-g)));  // silu
    case 1: return 0.5f * g * (1.f + erff(g * 0.7071067811865476f));  // gelu
    case 2: {  // gelu, tanh approximation
      const float c = 0.7978845608028654f;
      return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
    }
    default: return fmaxf(g, 0.f);  // relu
  }
}

// out = norm(x) @ dequant(W) (+ b) over the 32-column tiles that fall to
// this block (the body of the norm_qkv kernel); ANY: see any_tile
template <int TM, typename ST, bool ANY = false>
__device__ __forceinline__ void norm_rows(const RowSrc& src, int M,
                                          const WeightDesc& wd,
                                          float* __restrict__ out,
                                          const Plan<TM, ST>& pl) {
  row_stats<TM, ST>(src, M, pl);
  const int KT = chunk_rows(wd.Kp, wd.SB, TM, Plan<TM, ST>::ELEMS);
  int staged = -1;
  for (int t = blockIdx.x; t < wd.Np / COLS; t += gridDim.x) {
    any_tile<TM, ST, ANY>(wd, src, M, t * COLS, KT, pl, staged, pl.res0);
    for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
      const int m = i / COLS;
      const int n = t * COLS + (i - m * COLS);
      float y = pl.res0[i] * pl.stat[2 * TM + m];
      if (wd.bias != nullptr) y += wd.bias[n];
      out[(size_t)m * wd.Np + n] = y;
    }
    __syncthreads();
  }
}

struct MlpArgs {
  WeightDesc o, gu, dn;
  const float* x;     // attn (M, o.Kp), or m (M, gu.Kp) without o
  const float* xres;  // (M, o.Np), bf16 values (with o)
  const float* nw;    // ln2 weight (and bias, layernorm) over r2 (with o)
  const float* nb;
  float* r2;     // (M, o.Np) scratch (with o)
  float* inner;  // (M, gu.Np / 2 with glu, else gu.Np) scratch
  float* out;    // (M, dn.Np)
  int M, norm, act, glu, has_o;
  float eps;
};

// The MLP kernel's phases, run by every block of a cooperative grid:
// with a.has_o the o + residual phase, then gate|up + act, then down
// (+ r2), a grid barrier between each two. ANY: see any_tile.
template <int TM, typename ST, bool ANY = false>
__device__ __forceinline__ void mlp_phases(const MlpArgs& a,
                                           const Plan<TM, ST>& pl,
                                           cg::grid_group& grid) {
  const int M = a.M;
  RowSrc s2{a.x, nullptr, nullptr, a.gu.Kp, -1, 0.f};
  const int half = a.glu ? a.gu.Np / 2 : a.gu.Np;

  if (a.has_o) {  // phase 1: r2 = bf16(xres + o(attn) + b_o)
    const RowSrc s1{a.x, nullptr, nullptr, a.o.Kp, -1, 0.f};
    row_stats<TM, ST>(s1, M, pl);
    const int KT = chunk_rows(a.o.Kp, a.o.SB, TM, Plan<TM, ST>::ELEMS);
    int staged = -1;
    const int H = a.o.Np;
    for (int t = blockIdx.x; t < H / COLS; t += gridDim.x) {
      any_tile<TM, ST, ANY>(a.o, s1, M, t * COLS, KT, pl, staged, pl.res0);
      for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
        const int m = i / COLS;
        const int n = t * COLS + (i - m * COLS);
        float y = pl.res0[i] * pl.stat[2 * TM + m];
        if (a.o.bias != nullptr) y += a.o.bias[n];
        a.r2[(size_t)m * H + n] = bf16r(a.xres[(size_t)m * H + n] + y);
      }
      __syncthreads();
    }
    if (blockIdx.x < half / COLS) prefetch_tile(a.gu, blockIdx.x * COLS);
    __threadfence();
    grid.sync();
    s2 = RowSrc{a.r2, a.nw, a.nb, a.gu.Kp, a.norm, a.eps};
  }

  {  // phase 2: inner = bf16(act(gate n) * up n), or bf16(act(fc1 n))
    row_stats<TM, ST>(s2, M, pl);
    const int KT = chunk_rows(a.gu.Kp, a.gu.SB, TM, Plan<TM, ST>::ELEMS);
    int staged = -1;
    for (int t = blockIdx.x; t < half / COLS; t += gridDim.x) {
      any_tile<TM, ST, ANY>(a.gu, s2, M, t * COLS, KT, pl, staged, pl.res0);
      if (a.glu)
        any_tile<TM, ST, ANY>(a.gu, s2, M, half + t * COLS, KT, pl, staged,
                              pl.res1);
      for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
        const int m = i / COLS;
        const int n = t * COLS + (i - m * COLS);
        const float sx = pl.stat[2 * TM + m];
        float g = pl.res0[i] * sx;
        if (a.gu.bias != nullptr) g += a.gu.bias[n];
        float v = act_fn(a.act, g);
        if (a.glu) {
          float u = pl.res1[i] * sx;
          if (a.gu.bias != nullptr) u += a.gu.bias[half + n];
          v = v * u;
        }
        a.inner[(size_t)m * half + n] = bf16r(v);
      }
      __syncthreads();
    }
  }
  if (blockIdx.x < a.dn.Np / COLS) prefetch_tile(a.dn, blockIdx.x * COLS);
  __threadfence();
  grid.sync();

  {  // phase 3: out = down(inner) + b_d (+ r2)
    const RowSrc s3{a.inner, nullptr, nullptr, a.dn.Kp, -1, 0.f};
    row_stats<TM, ST>(s3, M, pl);
    const int KT = chunk_rows(a.dn.Kp, a.dn.SB, TM, Plan<TM, ST>::ELEMS);
    int staged = -1;
    const int N = a.dn.Np;
    for (int t = blockIdx.x; t < N / COLS; t += gridDim.x) {
      any_tile<TM, ST, ANY>(a.dn, s3, M, t * COLS, KT, pl, staged, pl.res0);
      for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
        const int m = i / COLS;
        const int n = t * COLS + (i - m * COLS);
        float y = pl.res0[i] * pl.stat[2 * TM + m];
        if (a.dn.bias != nullptr) y += a.dn.bias[n];
        if (a.has_o) y += a.r2[(size_t)m * N + n];
        a.out[(size_t)m * N + n] = y;
      }
      __syncthreads();
    }
  }
}

// a descriptor the kernels can take; BCQ sign planes only where the
// caller compiled the BCQ tile (bcq_ok: ffn.cu)
bool weight_ok(const WeightDesc* w, bool bcq_ok = false) {
  if (w == nullptr || w->w0 == nullptr) return false;
  if (w->SB < 32 || w->SB > 512 || w->Kp % w->SB || w->Np % COLS ||
      w->ng < 1 || w->Kp % w->ng || (w->Kp / w->ng) % w->SB)
    return false;
  if (w->fmt == FMT_BCQ)
    return bcq_ok && w->alpha != nullptr && w->w1 == nullptr &&
           w->bits >= 1 && w->bits <= 8;
  if (w->fmt != 0 || w->scale == nullptr || w->zoff == nullptr) return false;
  if (w->bits != 1 && w->bits != 2 && w->bits != 3 && w->bits != 4 &&
      w->bits != 8)
    return false;
  return (w->bits == 3) == (w->w1 != nullptr);
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the blocks of `kern` that fit on the card at once (occupancy API),
// computed once per kernel: it depends on the kernel and the card only
template <typename K>
cudaError_t resident_blocks(K kern, size_t smem, int& resident) {
  if (resident > 0) return cudaSuccess;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem)) != cudaSuccess)
    return err;
  resident = per_sm * sms;
  return resident > 0 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

// a cooperative launch of `kern` (grid-wide barriers need every block
// resident) in the form a stream capture records as a graph node:
// cudaLaunchKernelEx with the cooperative attribute
template <typename... Args>
cudaError_t coop_launch(void (*kern)(Args...), int grid, size_t smem,
                        cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
