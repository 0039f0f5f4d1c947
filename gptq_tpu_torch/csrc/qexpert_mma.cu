// Tensor-core kernel of #8, the batched expert matmul at 1..32 rows:
//
//   out[e, m, n] = sum_k X(e)[m, k] * dequant(bank[e])[k, n]
//
// for every expert e of a PackedExperts bank in one launch (the expert is
// a grid dimension); X is (M, Kp), shared by the experts (gate / up), or
// (E, M, Kp), one per expert (down: per_x).
//
// Replaces gptq_tpu/ops/qmatmul.py:_qmm_expert_kernel (#8) for the banks
// ops/qmatmul.py:expert_route sends here ("mma"); the rest ("shallow":
// subblocks too short for a stage window) stay on qexpert.cu's CUDA-core
// qexpert_kernel. A route is a pure function of shapes, never a fallback.
//
// Bound on an H100: the bank's bytes (one Mixtral-8x7B bank at 4 bits,
// 8 x 4096 x 14336, is 235 MB: 70 us at 3.35 TB/s). Its multiply-adds at
// M = 16 take a fifth of that at the bf16 tensor-core rate, but 3x it at
// the f32 CUDA-core rate: so tensor cores, with the bytes kept streaming.
//
// The algebra is qmma.cu's (see its header), so no dequantized weight is
// rounded:
//   * a sub-8-bit code enters the MMA as the bf16 number 2^bits + c, an
//     8-bit one as c; the offset comes back out through x's sums:
//       acc += P * scale[g,n] - xsum[m,g] * (zoff[g,n] + OFF * scale[g,n]);
//   * int8 x (a8): s8 x s8 MMA, exact int32 partials; the 8-bit field's
//     stored code - 128 enters as it is (OFF = -128);
//   * f32 x: two bf16 halves (ops/qmatmul.split_bf16), two MMAs a step;
//   * a 3-bit weight's 2-bit and 1-bit fields combine into one code;
//   * grouped weights fold each group's partial in registers.
//
// Design (why mma.sync and not wgmma): the weights go on the MMA's wide
// side, out^T = W^T . x^T, so the unpacked weight tile is the 16-row A
// operand taken straight from registers, unpacked from the loaded words
// and never written back to shared memory; x's <= 32 rows are the narrow
// N side (8-row B tiles). wgmma's register A operand needs 64 rows a
// warpgroup and its B tile in shared memory in the canonical layout; at
// M = 16 the MMA work is a fifth of the byte bound, so the simpler
// m16n8k16 (bf16) / m16n8k32 (s8) form costs nothing that shows.
//   * a block: 4 consumer warps (32 columns each, BN = 128) and one
//     loader warp whose one thread keeps a ring of stages full by TMA
//     (full / empty mbarrier pairs), so many stages' bytes are in flight.
//   * a stage is a window of J (8 or 16) word rows of one subblock in every
//     plane of the weight's finest field (a 3-bit weight's 2-bit field
//     takes two windows): the words in the 128-byte swizzle (boxes of 32
//     columns by J rows), and x's matching K runs as stored (bf16 or int8,
//     not widened; one box of 32 K by Mpad rows a run), and the stage's x
//     sums. Every code of every loaded word is used.
//   * lane (g, t) of a warp takes word rows 2t and 2t + 1 of each 8 (one
//     16-byte load of 4 columns each: conflict-free in the swizzle). Byte b
//     of a word is K row 4j + b of its plane, so an A register holds bytes
//     0-1 or 2-3 and the matching B fragment is 8 consecutive x values of
//     row g: one 16-byte load (bf16) or one 8-byte load (s8) per B tile.
//   * x's sums per stage (and an f32 x's two bf16 halves) come from one
//     pass over x before the main launch (xprep_kernel, once per call,
//     not per block); a fold unit is a group's stages inside the block's
//     K split.
//   * the down bank (8 x 14336 x 4096) has 256 tiles of 128 columns: the
//     wrapper splits K (ops/qmatmul.expert_splits) so the card fills; the
//     splits' partials meet in a workspace and the last block of a tile
//     (a ticket counter it resets) sums them in split order, so the result
//     does not depend on which block ends last.
// Np % 4 == 0, 16-byte aligned tensors, 1 <= M <= 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int CW = 4;                  // consumer warps, 32 columns each
constexpr int BN = CW * 32;            // columns a block
constexpr int THREADS = BN + 32;       // + the loader warp
constexpr int NBT = 4;                 // 8-row B tiles at most (M <= 32)
constexpr int MAX_STAGES = 8;
constexpr int BUDGET = 110 * 1024;     // two blocks an SM
constexpr int SMEM_LIMIT = 232448;

enum { X_BF16 = 0, X_SPLIT = 1, X_S8 = 2 };

struct Args {
  CUtensorMap tx[2];  // x (x_hi, x_lo): 4-D (32, Kp/32, M, Ex), runs of 32 K
  CUtensorMap tw[2];  // words by field: 3-D (Np, Kw, E), 128-byte swizzle
  CUtensorMap ts;     // stage x sums: 2-D (Mpad, Ex * nk)
  const float* scale;  // (E, ng, Np)
  const float* zoff;   // (E, ng, Np)
  float* out;          // (E, M, Np)
  float* ws;           // (ks, E, M, Np) the splits' partials (ks > 1)
  int* cnt;            // (E, tiles) tickets, zero between launches (ks > 1)
  int M, Mpad, Kp, Np, ng, E, per_x;
  int sb, wsb;         // subblock rows; the finest field's words a subblock
  int J;               // word rows a stage window
  int nk, spg, ks;     // stages, stages a group, K splits
  int stages;          // ring depth
  int x_off, xs_off, stage_bytes, tx_fixed;  // stage layout
};

template <int BITS>
struct Fields {
  static constexpr int FB0 = BITS == 3 ? 2 : BITS;
  static constexpr int FB1 = BITS == 3 ? 1 : 0;
  static constexpr int FBMIN = FB1 ? FB1 : FB0;
  static constexpr int NPL = 8 / FBMIN;            // planes: x runs a stage
  static constexpr int NW0 = FB0 / FBMIN;          // field 0's windows
  static constexpr int NW = NW0 + (FB1 ? 1 : 0);   // windows a stage
};

// field width FB's plane e of each byte moved to bit T, masked
__device__ __forceinline__ uint32_t place(uint32_t w, int fb, int t, int e) {
  const int sh = fb * e;
  const uint32_t v = sh > t ? w >> (sh - t) : w << (t - sh);
  return v & ((((1u << fb) - 1u) << t) * 0x01010101u);
}

// the codes of finest plane e1 in word column c of row parity par: one
// code a byte, at the bit the MMA operand wants (s8: bit 0; bf16: the top
// mantissa bits of 2^BITS + c; 8-bit: the stored byte)
template <int XK, int BITS>
__device__ __forceinline__ uint32_t plane_codes(uint32_t (*wd)[2][4],
                                                int e1, int par, int c) {
  constexpr int T0 = XK == X_S8 ? 0 : 7 - BITS;
  if constexpr (BITS == 3)
    return place(wd[e1 % 2][par][c], 2, T0, e1 / 2) |
           place(wd[2][par][c], 1, T0 + 2, e1);
  else if constexpr (BITS == 8)
    return wd[0][par][c];
  else
    return place(wd[0][par][c], BITS, T0, e1);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a plane word's four codes as two bf16 pairs: bytes 0-1 (lo), 2-3 (hi)
template <int BITS>
__device__ __forceinline__ void bf16_codes(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  if constexpr (BITS == 8) {
    w ^= 0x80808080u;  // the stored byte is code ^ 0x80
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(0x4B000000u | ((w >> (8 * b)) & 0xFFu)) -
             8388608.f;
    lo = bf16_pair(f[0], f[1]);
    hi = bf16_pair(f[2], f[3]);
  } else {
    // 2^BITS + c: the low byte c << (7 - BITS) | the base's low byte, the
    // high byte the base's
    constexpr uint32_t LO = BITS == 3 ? 0u : 0x80808080u;
    constexpr uint32_t HI = BITS == 2 ? 0x40404040u : 0x41414141u;
    w |= LO;
    lo = __byte_perm(w, HI, 0x4140);
    hi = __byte_perm(w, HI, 0x4342);
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// stage L's copies into slot `st` (the loader thread): each field window's
// words for the block's nch column chunks, x's runs of each finest plane
// (both halves of a split x), the stage's x sums
template <int XK, int BITS>
__device__ __forceinline__ void load_stage(const Args& p, unsigned char* st,
                                           uint64_t* bar, int L, int e,
                                           int n0, int nch) {
  using F = Fields<BITS>;
  constexpr int NA = XK == X_SPLIT ? 2 : 1;
  constexpr int ES = XK == X_S8 ? 1 : 2;
  const int spsb = p.wsb / p.J;  // stages a subblock
  const int s = L / spsb, j0 = (L - s * spsb) * p.J;
  const int ex = p.per_x ? e : 0;
  mbar_expect(bar, p.tx_fixed + F::NW * nch * p.J * 128);
#pragma unroll
  for (int w = 0; w < F::NW; ++w) {
    const bool f1 = w >= F::NW0;  // the 3-bit weight's 1-bit field
    const int fb = f1 ? F::FB1 : F::FB0;
    const int row = s * (p.sb * fb / 32) + (f1 ? 0 : w * p.wsb) + j0;
    for (int c = 0; c < nch; ++c)
      tma3d(st + (w * CW + c) * p.J * 128, &p.tw[f1 ? 1 : 0], n0 + 32 * c,
            row, e, bar);
  }
  const int runs = p.J / 8;
  const int run_bytes = p.Mpad * 32 * ES;
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e1 = 0; e1 < F::NPL; ++e1)
      for (int i = 0; i < runs; ++i) {
        const int k = s * p.sb + e1 * 4 * p.wsb + 4 * j0 + 32 * i;
        tma4d(st + p.x_off + ((a * F::NPL + e1) * runs + i) * run_bytes,
              &p.tx[a], 0, k / 32, 0, ex, bar);
      }
  tma2d(st + p.xs_off, &p.ts, 0, ex * p.nk + L, bar);
}

// RUNS = J / 8, the 32-row x runs of a plane a stage: a constant, so the
// loop over them unrolls and the compiler interleaves the runs' loads
template <int XK, int BITS, int RUNS>
__global__ void __launch_bounds__(THREADS, 2)
    qexpert_mma_kernel(const __grid_constant__ Args p) {
  using F = Fields<BITS>;
  using PT = typename std::conditional<XK == X_S8, int, float>::type;
  constexpr int ES = XK == X_S8 ? 1 : 2;
  constexpr float OFF = XK == X_S8 ? (BITS == 8 ? -128.f : 0.f)
                                   : (BITS == 8 ? 0.f : float(1 << BITS));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* empty = full + MAX_STAGES;
  int* ticket = reinterpret_cast<int*>(empty + MAX_STAGES);

  const int e = blockIdx.y, split = blockIdx.z, n0 = blockIdx.x * BN;
  const int ka = split * p.nk / p.ks, kb = (split + 1) * p.nk / p.ks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = min(CW, (p.Np - n0 + 31) / 32);  // chunks inside Np
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == CW) {  // the loader: one thread keeps the ring full
    if (lane == 0)
      for (int L = ka; L < kb; ++L) {
        const int u = L - ka, s = u % p.stages;
        if (u >= p.stages)  // every consumer warp done with use u - S
          mbar_wait(&empty[s], ((u / p.stages) & 1) ^ 1);
        fence_async_smem();
        load_stage<XK, BITS>(p, ring + s * p.stage_bytes, &full[s], L, e, n0,
                             nch);
      }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int nbt = p.Mpad >> 3;
  constexpr int runs = RUNS;
  const int run_bytes = p.Mpad * 32 * ES;
  // this warp's words of window w, row 8i + 2t + par: 4 columns 4g..4g+3
  // of its 32-column chunk, the 16-byte chunk swizzled by the row (mod 8)
  const int wofs = warp * p.J * 128 + 2 * t * 128;
  // this lane's x: row 8b + g of a run, values 8t .. 8t + 7
  const int xofs = p.x_off + g * 32 * ES + t * 8 * ES;
  // A tile a, row g -> column 4g + 2a, row g + 8 -> 4g + 2a + 1; D (row r,
  // x row 8b + 2t + h) lands in acc[a][b][2 * (r >= 8) + h]
  float acc[2][NBT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < NBT; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][b][i] = 0.f;

  int kt = ka;
  while (kt < kb) {  // fold units: a group's stages inside the split
    const int gi = kt / p.spg;
    const int kend = min(kb, (gi + 1) * p.spg);
    PT part[2][NBT][4];
    float xs[NBT][2];
#pragma unroll
    for (int b = 0; b < NBT; ++b) {
      xs[b][0] = xs[b][1] = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[a][b][i] = 0;
    }
    for (; kt < kend; ++kt) {
      const int u = kt - ka, s = u % p.stages;
      mbar_wait(&full[s], (u / p.stages) & 1);
      const unsigned char* st = ring + s * p.stage_bytes;
      const float* xsm = reinterpret_cast<const float*>(st + p.xs_off);
#pragma unroll
      for (int b = 0; b < NBT; ++b)
        if (b < nbt) {
          xs[b][0] += xsm[8 * b + 2 * t];
          xs[b][1] += xsm[8 * b + 2 * t + 1];
        }
#pragma unroll
      for (int i = 0; i < runs; ++i) {
        uint32_t wd[F::NW][2][4];
#pragma unroll
        for (int w = 0; w < F::NW; ++w)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                st + w * CW * p.J * 128 + wofs + (8 * i + par) * 128 +
                ((g ^ (2 * t + par)) << 4));
            wd[w][par][0] = v.x;
            wd[w][par][1] = v.y;
            wd[w][par][2] = v.z;
            wd[w][par][3] = v.w;
          }
#pragma unroll
        for (int e1 = 0; e1 < F::NPL; ++e1) {
          const unsigned char* xr = st + xofs + (e1 * runs + i) * run_bytes;
          uint32_t pr[2][4];
#pragma unroll
          for (int par = 0; par < 2; ++par)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              pr[par][c] = plane_codes<XK, BITS>(wd, e1, par, c);
          if constexpr (XK == X_S8) {
            // k32: slots 4t.. of row 2t, 16 + 4t.. of row 2t + 1
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const uint32_t A[4] = {pr[0][2 * a], pr[0][2 * a + 1],
                                     pr[1][2 * a], pr[1][2 * a + 1]};
#pragma unroll
              for (int b = 0; b < NBT; ++b)
                if (b < nbt) {
                  const uint2 xb =
                      *reinterpret_cast<const uint2*>(xr + b * 8 * 32);
                  mma(part[a][b], A, xb.x, xb.y);
                }
            }
          } else {
            // k16 a row parity: slots 2t, 2t+1 bytes 0-1, 2t+8, 2t+9 2-3
            uint32_t A[2][2][4];  // [par][a]
#pragma unroll
            for (int par = 0; par < 2; ++par)
#pragma unroll
              for (int a = 0; a < 2; ++a) {
                bf16_codes<BITS>(pr[par][2 * a], A[par][a][0],
                                 A[par][a][2]);
                bf16_codes<BITS>(pr[par][2 * a + 1], A[par][a][1],
                                 A[par][a][3]);
              }
#pragma unroll
            for (int h = 0; h < (XK == X_SPLIT ? 2 : 1); ++h)
#pragma unroll
              for (int b = 0; b < NBT; ++b)
                if (b < nbt) {
                  const uint4 xb = *reinterpret_cast<const uint4*>(
                      xr + h * F::NPL * runs * run_bytes + b * 8 * 64);
#pragma unroll
                  for (int a = 0; a < 2; ++a) {
                    mma(part[a][b], A[0][a], xb.x, xb.y);
                    mma(part[a][b], A[1][a], xb.z, xb.w);
                  }
                }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // fold the unit: its group's grid on this lane's 4 columns
    const int col = n0 + warp * 32 + 4 * g;
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f), z = sc;
    if (col < p.Np) {
      const size_t o = ((size_t)e * p.ng + gi) * p.Np + col;
      sc = __ldg(reinterpret_cast<const float4*>(p.scale + o));
      z = __ldg(reinterpret_cast<const float4*>(p.zoff + o));
    }
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
    const float zv[4] = {z.x + OFF * sc.x, z.y + OFF * sc.y,
                         z.z + OFF * sc.z, z.w + OFF * sc.w};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NBT; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 2 * a + (i >> 1);
          acc[a][b][i] += (float)part[a][b][i] * scv[c] - xs[b][i & 1] * zv[c];
        }
  }

  // this lane's rows 8b + 2t + h, columns 4g .. 4g + 3
  const int col = n0 + warp * 32 + 4 * g;
  const bool col_ok = col < p.Np;
  float* dst = p.ks > 1 ? p.ws + (size_t)split * p.E * p.M * p.Np : p.out;
#pragma unroll
  for (int b = 0; b < NBT; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * b + 2 * t + h;
      if (b < nbt && m < p.M && col_ok)
        *reinterpret_cast<float4*>(dst + ((size_t)e * p.M + m) * p.Np + col) =
            make_float4(acc[0][b][h], acc[0][b][2 + h], acc[1][b][h],
                        acc[1][b][2 + h]);
    }
  if (p.ks == 1) return;
  // the last split of this tile to end sums the partials in split order
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(BN) : "memory");
  int* cnt = p.cnt + e * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) *ticket = atomicAdd(cnt, 1);
  asm volatile("bar.sync 1, %0;\n" ::"n"(BN) : "memory");
  if (*ticket != p.ks - 1) return;
  __threadfence();
  const size_t slab = (size_t)p.E * p.M * p.Np;
#pragma unroll
  for (int b = 0; b < NBT; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * b + 2 * t + h;
      if (b < nbt && m < p.M && col_ok) {
        const size_t o = ((size_t)e * p.M + m) * p.Np + col;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < p.ks; ++k) {
          const float4 v =
              __ldcg(reinterpret_cast<const float4*>(p.ws + k * slab + o));
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        *reinterpret_cast<float4*>(p.out + o) = sum;
      }
    }
  if (threadIdx.x == 0) *cnt = 0;  // ready for the next launch
}

__device__ __forceinline__ float xval(float v) { return v; }
__device__ __forceinline__ float xval(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One pass over x (Ex, M, Kp) before the main launch: block (stage kt,
// x block ex) sums each row over the stage's K rows (every finest plane's
// run of 4J rows at e * 4 wsb + 4 j0 of subblock s) into xst[ex][kt][m]
// (rows M .. Mpad - 1 zero), and writes an f32 x's halves hi = bf16(x), lo
// = bf16(x - hi) for those rows (each K row lies in one stage).
template <typename XT>
__global__ void __launch_bounds__(256)
xprep_kernel(const XT* __restrict__ x, int M, int Mpad, int Kp, int sb,
             int wsb, int J, int npl, int nk, __nv_bfloat16* __restrict__ hi,
             __nv_bfloat16* __restrict__ lo, float* __restrict__ xst) {
  const int kt = blockIdx.x, ex = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int spsb = wsb / J;
  const int s = kt / spsb, j0 = (kt - s * spsb) * J;
  const int run = 4 * J;  // rows of a plane in the stage
  for (int m = warp; m < Mpad; m += 8) {
    float sum = 0.f;
    int isum = 0;  // int8 x: exact
    if (m < M) {
      const size_t row = ((size_t)ex * M + m) * Kp;
      for (int i = lane; i < npl * run; i += 32) {
        const int e = i / run;
        const size_t k = row + s * sb + e * 4 * wsb + 4 * j0 + (i - e * run);
        const XT v = x[k];
        if constexpr (sizeof(XT) == 1) {
          isum += (int)v;
        } else {
          sum += xval(v);
          if constexpr (sizeof(XT) == 4) {
            const __nv_bfloat16 h = __float2bfloat16_rn(v);
            hi[k] = h;
            lo[k] = __float2bfloat16_rn(v - __bfloat162float(h));
          }
        }
      }
    }
    if constexpr (sizeof(XT) == 1) sum = (float)isum;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) xst[((size_t)ex * nk + kt) * Mpad + m] = sum;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int XK, int BITS, int RUNS>
int launch(Args a, const void* xa, const void* xb, const void* w0,
           const void* w1, const void* xst, int Ex, cudaStream_t st) {
  using F = Fields<BITS>;
  constexpr int NA = XK == X_SPLIT ? 2 : 1;
  constexpr int ES = XK == X_S8 ? 1 : 2;
  // the stage: words (NW windows x CW chunks x J rows x 128 bytes), x's
  // runs, its sums; 1024-aligned for the swizzled boxes
  const int words = F::NW * CW * a.J * 128;
  const int xbytes = NA * F::NPL * (a.J / 8) * a.Mpad * 32 * ES;
  a.x_off = words;
  a.xs_off = words + xbytes;
  a.tx_fixed = xbytes + a.Mpad * 4;
  a.stage_bytes = (a.xs_off + a.Mpad * 4 + 1023) & ~1023;
  const int fixed = 1024 + 16 * MAX_STAGES + 16;  // + barriers, ticket
  // as many stages as two blocks an SM leave room for, else one block's
  a.stages = (BUDGET - fixed) / a.stage_bytes;
  if (a.stages < 3) a.stages = (SMEM_LIMIT - fixed) / a.stage_bytes;
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  if (a.stages < 3) return (int)cudaErrorInvalidValue;
  const int smem = fixed + a.stages * a.stage_bytes;

  const cuuint64_t M = a.M, Kp = a.Kp, Np = a.Np, E = a.E;
  const CUtensorMapDataType xt = XK == X_S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = true;
  for (int i = 0; i < NA; ++i) {
    const cuuint64_t d[4] = {32, Kp / 32, M, (cuuint64_t)Ex};
    const cuuint64_t s[3] = {32 * ES, Kp * ES, M * Kp * ES};
    const cuuint32_t b[4] = {32, 1, (cuuint32_t)a.Mpad, 1};
    ok = ok && tmap(&a.tx[i], xt, 4, i ? xb : xa, d, s, b, false);
  }
  const int fbs[2] = {F::FB0, F::FB1};
  const void* ws[2] = {w0, w1};
  for (int f = 0; f < (F::FB1 ? 2 : 1); ++f) {
    const cuuint64_t kw = Kp * fbs[f] / 32;
    const cuuint64_t d[3] = {Np, kw, E};
    const cuuint64_t s[2] = {Np * 4, kw * Np * 4};
    const cuuint32_t b[3] = {32, (cuuint32_t)a.J, 1};
    ok = ok && tmap(&a.tw[f], CU_TENSOR_MAP_DATA_TYPE_INT32, 3, ws[f], d, s,
                    b, true);
  }
  {
    const cuuint64_t d[2] = {(cuuint64_t)a.Mpad, (cuuint64_t)Ex * a.nk};
    const cuuint64_t s[1] = {(cuuint64_t)a.Mpad * 4};
    const cuuint32_t b[2] = {(cuuint32_t)a.Mpad, 1};
    ok = ok && tmap(&a.ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xst, d, s, b,
                    false);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = qexpert_mma_kernel<XK, BITS, RUNS>;
  static bool opted = false;  // one opt-in per instantiation
  if (!opted) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_LIMIT);  // a failure shows in cudaGetLastError
    // all of the SM's 256 KB as shared memory, so two blocks fit
    cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    opted = true;
  }
  const dim3 grid((a.Np + BN - 1) / BN, a.E, a.ks);
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int XK>
int by_bits(const Args& a, int bits, const void* xa, const void* xb,
            const void* w0, const void* w1, const void* xst, int Ex,
            cudaStream_t st) {
  const bool two = a.J == 16;  // a 3-bit bank's stages take J = 8
  switch (bits) {
    case 2:
      return two ? launch<XK, 2, 2>(a, xa, xb, w0, w1, xst, Ex, st)
                 : launch<XK, 2, 1>(a, xa, xb, w0, w1, xst, Ex, st);
    case 3:
      return two ? (int)cudaErrorInvalidValue
                 : launch<XK, 3, 1>(a, xa, xb, w0, w1, xst, Ex, st);
    case 4:
      return two ? launch<XK, 4, 2>(a, xa, xb, w0, w1, xst, Ex, st)
                 : launch<XK, 4, 1>(a, xa, xb, w0, w1, xst, Ex, st);
    case 8:
      return two ? launch<XK, 8, 2>(a, xa, xb, w0, w1, xst, Ex, st)
                 : launch<XK, 8, 1>(a, xa, xb, w0, w1, xst, Ex, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// #8 on the tensor cores. x (E, M, Kp) with per_x, else (M, Kp); x_kind
// 0 = f32 (split into xhi / xlo, (.., Kp) bf16 scratch), 1 = bf16, 2 =
// int8. xst (Ex, nk, Mpad) f32 scratch: the stage sums. w1: the 3-bit
// bank's 1-bit field, else null. J: word rows a stage window (8 or 16,
// dividing SB * finest bits / 32). ks > 1: ws (ks, E, M, Np) f32 scratch
// and cnt (E, ceil(Np / 128)) int32 zeros, which the launch leaves zero.
// out (E, M, Np) f32. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for what the kernel does not take (launching
// nothing).
extern "C" int qexpert_mma_launch(const void* x, int x_kind, void* xhi,
                                  void* xlo, void* xst, int per_x, int E,
                                  int M, int Kp, const void* w0,
                                  const void* w1, int bits, int SB,
                                  const void* scale, const void* zoff, int ng,
                                  int J, int ks, void* ws, void* cnt,
                                  void* out, int Np, void* stream) {
  const int fbmin = bits == 3 ? 1 : bits;
  const int wsb = SB * fbmin / 32;
  Args a{};
  a.scale = (const float*)scale;
  a.zoff = (const float*)zoff;
  a.out = (float*)out;
  a.ws = (float*)ws;
  a.cnt = (int*)cnt;
  a.M = M;
  a.Mpad = (M + 7) / 8 * 8;
  a.Kp = Kp;
  a.Np = Np;
  a.ng = ng;
  a.E = E;
  a.per_x = per_x;
  a.sb = SB;
  a.wsb = wsb;
  a.J = J;
  const int bk = 32 * J / fbmin;  // K rows a stage
  a.nk = bk > 0 ? Kp / bk : 0;
  a.spg = ng > 0 && bk > 0 ? Kp / ng / bk : 0;
  a.ks = ks;
  const bool split = x_kind == 0;
  if (M < 1 || M > 32 || E < 1 || Kp % 32 || SB < 32 || Kp % SB ||
      (J != 8 && J != 16) || wsb % J || ng < 1 || Kp % ng ||
      (Kp / ng) % SB || Np % 4 || ks < 1 || ks > a.nk || x_kind < 0 ||
      x_kind > 2 || (ks > 1 && (ws == nullptr || cnt == nullptr)) ||
      (bits == 3) != (w1 != nullptr) ||
      split != (xhi != nullptr && xlo != nullptr) || !aligned16(x) ||
      !aligned16(xhi) || !aligned16(xlo) || !aligned16(w0) ||
      !aligned16(w1) || !aligned16(scale) || !aligned16(zoff) ||
      !aligned16(xst) || !aligned16(out) || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  const int Ex = per_x ? E : 1;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 pg(a.nk, Ex);
  __nv_bfloat16 *h = (__nv_bfloat16*)xhi, *l = (__nv_bfloat16*)xlo;
  float* xs = (float*)xst;
  if (x_kind == 0)
    xprep_kernel<float><<<pg, 256, 0, st>>>((const float*)x, M, a.Mpad, Kp,
                                            SB, wsb, J, 8 / fbmin, a.nk, h,
                                            l, xs);
  else if (x_kind == 1)
    xprep_kernel<__nv_bfloat16><<<pg, 256, 0, st>>>(
        (const __nv_bfloat16*)x, M, a.Mpad, Kp, SB, wsb, J, 8 / fbmin, a.nk,
        h, l, xs);
  else
    xprep_kernel<int8_t><<<pg, 256, 0, st>>>((const int8_t*)x, M, a.Mpad, Kp,
                                             SB, wsb, J, 8 / fbmin, a.nk, h,
                                             l, xs);
  if (x_kind == 2)
    return by_bits<X_S8>(a, bits, x, nullptr, w0, w1, xst, Ex, st);
  if (split) return by_bits<X_SPLIT>(a, bits, xhi, xlo, w0, w1, xst, Ex, st);
  return by_bits<X_BF16>(a, bits, x, nullptr, w0, w1, xst, Ex, st);
}
