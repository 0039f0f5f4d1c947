// Tensor-core (wgmma) kernels for the packed matmuls at many rows: the
// M > 1 paths of #1 (uniform grids) and #13 (BCQ sign planes).
//
// Replaces, from M = 2 up (batched decode, prefill, PPL eval: the
// measured crossover is the first row count past one), the Pallas TPU
// kernels
//   gptq_tpu/ops/qmatmul.py:_qmm_kernel (+ _tile_update)  -> qmma_kernel
//   gptq_tpu/ops/bcq_matmul.py:_bcq_kernel                -> qmma_kernel<BCQ>
// Decode (M == 1) takes qgemv_kernel and bcq_gemv_kernel (gemv.cuh), and
// the weights this file does not take (below) on the CUDA-core loops of
// qmatmul.cu and bcq_matmul.cu: ops/qmatmul.py:qmm_route and
// ops/bcq_matmul.py:bcq_route decide, and a route is never a fallback.
//
// Bound on an H100: the multiply-adds over the tensor cores' rate (one
// llama-7B layer at M = 2048 is 0.84 TFLOP: 0.85 ms at 989 TFLOP/s bf16).
//
// What it computes, keeping the JAX kernels' algebra: the tensor cores
// multiply exact values, and no dequantized weight is rounded to bf16.
//   * uniform, bf16 x: a code c < 2^bits is exact in bf16. A sub-8-bit code
//     is written as the bf16 number 2^bits + c (the exponent of 2^bits
//     with c in the top mantissa bits: a shift, a mask and one byte
//     permute a pair of codes), an 8-bit code as c. Per group g the MMA
//     partial P = x_g . (c + OFF) is taken in f32 and folded in registers,
//        acc += P * scale[g,n] - xsum[m,g] * (zoff[g,n] + OFF * scale[g,n]),
//     OFF = 2^bits (8-bit: 0). The 3-bit weight's 2-bit and 1-bit fields
//     combine into one code before the MMA (the TPU needed two dots).
//   * uniform, int8 x (a8): s8 x s8 MMA, exact int32 partials, the codes as
//     s8; the 8-bit field's stored code - 128 is taken as it is (OFF = -128:
//     (P + 128 xsum) * scale - xsum * zoff).
//   * f32 x: split on the card into x_hi = bf16(x), x_lo = bf16(x - x_hi)
//     (ops/qmatmul.py:split_bf16); both x tiles meet the same B tile, two
//     MMAs a k-step; |x - x_hi - x_lo| <= 2^-17 |x|. No TF32.
//   * BCQ: w = sum_b alpha[g,b,n] (2 B_b - 1) in f32 in registers, split as
//     w_hi = bf16(w), w_lo = bf16(w - w_hi) (residual <= 2^-17 |w|), two B
//     tiles: x . w_hi + x . w_lo; f32 x: x_hi . w_hi + x_hi . w_lo + x_lo .
//     w_hi. int8 x (a8) is exact in bf16 (|x| <= 127) and takes the bf16
//     form, so its partials are f32, not int32 (at 3-4 planes two bf16 MMAs
//     do less work than one s8 MMA a plane). The grid sits inside w, so
//     groups of any multiple of 8 rows that divides or is divided by a
//     stage work.
//
// Design (one CTA of two warpgroups, a 128-row output tile):
//   * one thread (in qmma_split_kernel, of a ninth warp that does nothing
//     else) keeps a ring of 3-6 stages filled by TMA (one mbarrier a
//     stage): the x tile in the 128-byte swizzle wgmma reads, the stage's
//     packed words, its grid row (uniform, grouped) or its alphas (BCQ).
//     Boxes past M, Kp or Np fill zeros.
//   * a stage is 128 bytes of K per row: 64 bf16 or 128 int8 rows of K.
//     The words stay N-contiguous as they are stored. The CTA reads each
//     word once, uses every code in it, and writes the B tile K-major in
//     the same swizzle (the transpose s8 wgmma needs: it reads B K-major
//     only). Where a subblock is deeper than a stage, a stage is one word
//     window of the subblock in every sub-byte plane, so its K rows are E
//     runs of x columns: the wrapper gathers x's columns in that order
//     (ops/qmatmul.py:mma_row_order), and since a group covers whole
//     subblocks it is never split. Which word slot and bit shift holds
//     each 4 K rows of a stage is the same for every stage: in regime A
//     a constant after unrolling, in regime B a table built once.
//   * qmma_split_kernel, one accumulator (uniform groupsize -1, and BCQ
//     where its stages fit), 256 columns: warpgroup w owns columns
//     128 w .. 128 w + 127 over all 128 rows (two m64n128 wgmma a k-step)
//     and unpacks its own half of the B tile into its own two buffers, so
//     the warpgroups meet only at the ring's empty barriers (which the
//     loader warp waits on) and one's MMA runs while the other unpacks.
//   * qmma_kernel, grouped uniform weights (FOLD), and BCQ otherwise, 128
//     columns: each warpgroup multiplies its 64 rows by the B tile both
//     unpack, one __syncthreads a stage; stage k+1's unpack runs while
//     stage k's wgmma does, on two B buffers. Per-group partials: a
//     group's first k-step issues the MMA with scale-d = 0, and after the
//     group's last stage the partial folds into a second accumulator (128
//     accumulator registers). Groups must cover whole stages (a multiple
//     of 64 rows at a16, 128 at a8); shallower groups (2-bit g16, g32 /
//     g64 at a8) take the CUDA-core kernel: qmm_route's "shallow".
//   * Np % 4 == 0 and 16-byte aligned tensors are required (the wrapper
//     routes others to the CUDA-core kernel).
// Up to 227 KB of shared memory (cudaFuncSetAttribute before the launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int BM = 128;
constexpr int THREADS = 256;
constexpr int ROWB = 128;         // bytes of K in a tile row: one swizzle row
constexpr int ATILE = BM * ROWB;  // 16 KB: a stage's x tile
constexpr int SMEM_LIMIT = 232448;
constexpr int LOC_BYTES = 1024;   // the row-map table, then the barriers
constexpr int MAX_STAGES = 6;

enum { U_BF16 = 0, U_S8 = 1, BCQ = 2 };

struct Args {
  // TMA maps: x (or x_hi, x_lo); words (field 0 or the BCQ planes, field
  // 1); grid rows (scale, zoff; or the BCQ alphas)
  CUtensorMap tx[2], tw[2], tm[2];
  const void* xa;      // (M, Kp) bf16 (x or x_hi) or int8 (for the maps)
  const void* xb;      // (M, Kp) bf16 x_lo, or null
  int M, Kp, Np;
  const int32_t* w0;   // uniform: first field (Kp*fb/32, Np); BCQ: planes
  const int32_t* w1;   // uniform 3-bit: the 1-bit field
  int bits, lsb;       // lsb: log2 of the subblock's rows
  const float* scale;  // uniform (ng, Np)
  const float* zoff;   // uniform (ng, Np)
  const float* alpha;  // BCQ (ng, bits, Np)
  const float* xsum;   // uniform (M, ng): x summed over each group
  int ng;
  float* out;          // (M, Np) f32
  int stages;          // 3 .. MAX_STAGES
  // shared memory layout of a stage (bytes from its start), and the bytes
  // its TMA copies bring
  int words_off, meta_off, stage_bytes, tx_bytes;
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads and writes across the
// asynchronous MMA's issue and wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// descriptor of a K-major tile in the 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (stride byte offset), 1024-aligned base
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define WG_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define WG_D16(C, i) \
  WG_D4(C, i), WG_D4(C, i + 4), WG_D4(C, i + 8), WG_D4(C, i + 12)
#define WG_D64(C, i) \
  WG_D16(C, i), WG_D16(C, i + 16), WG_D16(C, i + 32), WG_D16(C, i + 48)
#define WG_R64                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R128                                      \
  WG_R64 ", "                                        \
  "%64, %65, %66, %67, %68, %69, %70, %71, "         \
  "%72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, "         \
  "%88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, "     \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// d (+)= A(64 x 16, bf16) . B(16 x N, bf16), f32 accumulators (N/2 a
// thread); or A(64 x 32, s8) . B(32 x N, s8) into exact s32 ones
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64("+f", 0)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_R128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_D64("+f", 0), WG_D64("+f", 64)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_R64
      "}, %64, %65, p;\n}\n"
      : WG_D64("+r", 0)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_R128
      "}, %128, %129, p;\n}\n"
      : WG_D64("+r", 0), WG_D64("+r", 64)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void st_shared_v4(unsigned char* p,
                                             const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int V>
struct Log2 {  // log2 of a power of two up to 128
  static constexpr int value = V >= 128 ? 7 : V >= 64 ? 6 : V >= 32 ? 5
                             : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2
                             : V >= 2 ? 1 : 0;
};

// Where a stage's rows and words live. Byteplane layout (ops/pack.py): in
// a field of width FB, subblock s (SB rows, Wsb = SB*FB/32 words a
// column), row SB*s + e*(4*Wsb) + 4*j + b sits in word s*Wsb + j at bit
// 8*b + FB*e. FBMIN is the weight's finest field (3-bit: 1).
//   regime A (SB > BK): stage kt is the word window [j0, j0 + J) of
//     subblock s in every plane of the finest field; its K-slot
//     p = e*4J + q is row s*SB + e*quarter + 4*j0 + q (E runs of 4J rows).
//     A coarser field (3-bit's 2-bit one) needs FB/FBMIN windows.
//   regime B (SB <= BK): stage kt is rows [kt*BK, kt*BK + BK), whole
//     subblocks, and the words of those subblocks.
// Either way a field's stage holds BK*FB/32 word rows ("slots"), every
// code of which the stage uses, and the slot and shift of K-slot p do not
// depend on the stage.
template <int BK, int FBMIN>
struct Geo {
  static constexpr int J = BK * FBMIN / 32;
  bool a;
  int s, j0, k0, lsb;
  __device__ __forceinline__ Geo(int kt, int lsb_) : lsb(lsb_) {
    a = lsb > Log2<BK>::value;
    if (a) {
      const int lper = lsb - Log2<BK>::value;  // stages a subblock: 2^lper
      s = kt >> lper;
      j0 = (kt - (s << lper)) * J;
      k0 = s << lsb;
    } else {
      s = 0;
      j0 = 0;
      k0 = kt * BK;
    }
  }
  // word row of a field's slot
  template <int FB>
  __device__ __forceinline__ int wrow(int slot) const {
    if (!a) return k0 * FB / 32 + slot;
    return ((s * FB) << lsb) / 32 + (slot / J) * ((FBMIN << lsb) / 32) + j0 +
           slot % J;
  }
  // slot and bit shift of K-slots 4*q4 .. 4*q4 + 3 (bytes 0..3 of a word)
  template <int FB>
  __device__ __forceinline__ void loc(int q4, int& slot, int& shift) const {
    const int p = 4 * q4;
    if (a) {
      constexpr int ratio = FB / FBMIN;
      const int e = p / (4 * J), q = p - e * 4 * J;
      slot = (e % ratio) * J + q / 4;
      shift = FB * (e / ratio);
    } else {
      const int k = k0 + p;
      const int lq = Log2<FB>::value + lsb - 3;  // log2 of a plane's rows
      const int r = k & ((1 << lsb) - 1);
      slot = ((k >> lsb) << (lsb + Log2<FB>::value - 5)) +
             ((r & ((1 << lq) - 1)) >> 2) - k0 * FB / 32;
      shift = FB * (r >> lq);
    }
  }
};

template <int KIND>
struct Cfg {
  static constexpr int BK = KIND == U_S8 ? 128 : 64;  // K rows a stage
  static constexpr int ES = KIND == U_S8 ? 1 : 2;     // bytes of an x value
};

template <int KIND, int BITS>
struct Fields {  // field widths (FB1 = 0: one field); BCQ: 1-bit planes
  static constexpr int FB0 = KIND == BCQ ? 1 : BITS == 3 ? 2 : BITS;
  static constexpr int FB1 = KIND != BCQ && BITS == 3 ? 1 : 0;
  static constexpr int FBMIN = FB1 ? FB1 : FB0;
  static constexpr int NF = FB1 ? 2 : 1;  // row-map tables
  // the bit a field's code lands on in its B byte (bf16: the top mantissa
  // bits of 2^BITS + c; s8: the code itself)
  static constexpr int T0 = KIND == U_BF16 && BITS < 8 ? 7 - BITS : 0;
  static constexpr int T1 = T0 + 2;
};

template <int KIND, bool FOLD>
struct AccT {  // the accumulator's type: the MMA's, or f32 beside a partial
  using type = float;
};
template <>
struct AccT<U_S8, false> {
  using type = int;
};

// one field's words of stage g into `dst` (slots x BN int32): regime A
// takes FB/FBMIN windows of J rows, regime B BK*FB/32 contiguous rows
template <int FB, int BN, int BK, int FBMIN>
__device__ __forceinline__ void load_words(const Geo<BK, FBMIN>& g,
                                           const CUtensorMap* m,
                                           unsigned char* dst, int n0,
                                           uint64_t* bar) {
  constexpr int J = Geo<BK, FBMIN>::J;
  if (g.a) {
#pragma unroll
    for (int t = 0; t < FB / FBMIN; ++t)
      tma2d(dst + t * J * BN * 4, m, n0,
            ((g.s * FB) << g.lsb) / 32 + t * ((FBMIN << g.lsb) / 32) + g.j0,
            bar);
  } else {
    tma2d(dst, m, n0, g.k0 * FB / 32, bar);
  }
}

// stage kt's copies (one thread issues them): x in the row map, the words,
// the grid row of group gi (FOLD) or the alphas of the stage's groups
template <int KIND, int NA, int BITS, int BN, bool FOLD>
__device__ __forceinline__ void load_stage(const Args& p, unsigned char* st,
                                           uint64_t* bar, int kt, int gi,
                                           int m0, int n0) {
  using F = Fields<KIND, BITS>;
  constexpr int BK = Cfg<KIND>::BK;
  const Geo<BK, F::FBMIN> g(kt, p.lsb);
  mbar_expect(bar, p.tx_bytes);
  // x comes in the stage row order (the wrapper gathers its columns so),
  // so a stage's x is one box of 128 rows by 128 bytes
#pragma unroll
  for (int a = 0; a < NA; ++a)
    tma2d(st + a * ATILE, &p.tx[a], kt * BK, m0, bar);
  unsigned char* wd = st + p.words_off;
  if constexpr (KIND == BCQ) {
    const int rows = p.Kp / 32;  // word rows a plane
    const int r = g.a ? (g.s << (p.lsb - 5)) + g.j0 : g.k0 / 32;
    for (int b = 0; b < p.bits; ++b)
      tma2d(wd + b * (BK / 32) * BN * 4, &p.tw[0], n0, b * rows + r, bar);
    tma2d(st + p.meta_off, &p.tm[0], n0, g.k0 / (p.Kp / p.ng) * p.bits, bar);
  } else {
    load_words<F::FB0, BN>(g, &p.tw[0], wd, n0, bar);
    if constexpr (F::FB1 != 0)
      load_words<F::FB1, BN>(g, &p.tw[1], wd + BK * F::FB0 / 32 * BN * 4,
                             n0, bar);
    if constexpr (FOLD) {
      tma2d(st + p.meta_off, &p.tm[0], n0, gi, bar);
      tma2d(st + p.meta_off + BN * 4, &p.tm[1], n0, gi, bar);
    }
  }
}

// the row-map table: for each field and each 4 K-slots of a stage, the
// byte offset of its word slot (bits 0-15) and the right (16-20) and left
// (21-25) shifts that bring its code to the field's bit of the B byte
template <int KIND, int BITS, int BN>
__device__ __forceinline__ void build_locs(int lsb, uint32_t* locs) {
  using C = Cfg<KIND>;
  using F = Fields<KIND, BITS>;
  const Geo<C::BK, F::FBMIN> g(0, lsb);
  constexpr int NQ = C::BK / 4;
  for (int i = threadIdx.x; i < F::NF * NQ; i += THREADS) {
    const int f = i / NQ, q4 = i % NQ;
    int slot, shift, t;
    if (f == 0) {
      g.template loc<F::FB0>(q4, slot, shift);
      t = F::T0;
    } else {
      g.template loc<F::FB1 ? F::FB1 : 1>(q4, slot, shift);
      t = F::T1;
    }
    const int rs = shift > t ? shift - t : 0, ls = shift < t ? t - shift : 0;
    locs[i] = (uint32_t)(slot * BN * 4) | ((uint32_t)rs << 16) |
              ((uint32_t)ls << 21);
  }
}

__device__ __forceinline__ uint32_t loc_word(const unsigned char* wd,
                                             uint32_t e, int nl) {
  const uint32_t w =
      *reinterpret_cast<const uint32_t*>(wd + (e & 0xFFFF) + 4 * nl);
  return (w >> ((e >> 16) & 31)) << ((e >> 21) & 31);
}

// the word of K-slots 4*q4 .. 4*q4 + 3 of a field of width FB for column
// nl, its code moved to bit T of each byte. Regime A (RA): slot and shift
// follow from q4 alone (Geo::loc), and q4 is a constant after unrolling,
// so this folds to one load and one or two immediate shifts; regime B
// reads them from the table.
template <bool RA, int FB, int FBMIN, int BK, int BN, int T>
__device__ __forceinline__ uint32_t code_word(const unsigned char* wd,
                                              const uint32_t* locs, int q4,
                                              int nl) {
  if constexpr (RA) {
    constexpr int J = BK * FBMIN / 32, ratio = FB / FBMIN;
    const int e = (4 * q4) / (4 * J), q = (4 * q4) % (4 * J);
    const int slot = (e % ratio) * J + q / 4, shift = FB * (e / ratio);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        wd + slot * BN * 4 + 4 * nl);
    return shift > T ? w >> (shift - T) : w << (T - shift);
  } else {
    return loc_word(wd, locs[q4], nl);
  }
}

// a B tile of a uniform weight's stage: the thread takes column nl of the
// stage's BN-wide words, writes row nw of the tile, and of that K-major
// row the 16-byte chunks C0, C0 + CSTEP, ... (NCH of the 8)
template <int KIND, int BITS, int BN, int C0, bool RA, int NCH, int CSTEP>
__device__ __forceinline__ void unpack_uniform(const uint32_t* locs,
                                               const unsigned char* wd,
                                               unsigned char* bt, int nl,
                                               int nw) {
  using C = Cfg<KIND>;
  using F = Fields<KIND, BITS>;
  constexpr int BK = C::BK, NQ = BK / 4;
  const unsigned char* wd1 = wd + BK * F::FB0 / 32 * BN * 4;
  constexpr uint32_t M0 = (((1u << F::FB0) - 1u) << F::T0) * 0x01010101u;
  constexpr uint32_t M1 = (1u << F::T1) * 0x01010101u;
#define WORD0(q4) \
  code_word<RA, F::FB0, F::FBMIN, BK, BN, F::T0>(wd, locs, q4, nl)
#define WORD1(q4)                                                      \
  code_word<RA, F::FB1 ? F::FB1 : 1, F::FBMIN, BK, BN, F::T1>(wd1,      \
                                                            locs + NQ, \
                                                            q4, nl)
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = C0 + j * CSTEP;
    uint32_t v[4];
    if constexpr (KIND == U_BF16 && BITS == 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the stored byte is code ^ 0x80; the code, exact in f32 by the
        // 2^23 trick, then in bf16
        const uint32_t w = WORD0(2 * c + h) ^ 0x80808080u;
        float f[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          f[b] = __uint_as_float(0x4B000000u | ((w >> (8 * b)) & 0xFFu)) -
                 8388608.f;
        v[2 * h] = bf16_pair(f[0], f[1]);
        v[2 * h + 1] = bf16_pair(f[2], f[3]);
      }
    } else if constexpr (KIND == U_BF16) {
      // bf16 2^BITS + c: the B byte pairs (low: c << T0 | the base's low
      // byte; high: the base's high byte)
      constexpr uint32_t LO = BITS == 3 ? 0u : 0x80808080u;
      constexpr uint32_t HI = BITS == 2 ? 0x40404040u : 0x41414141u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w = (WORD0(2 * c + h) & M0) | LO;
        if constexpr (F::FB1 != 0) w |= WORD1(2 * c + h) & M1;
        v[2 * h] = __byte_perm(w, HI, 0x4140);
        v[2 * h + 1] = __byte_perm(w, HI, 0x4342);
      }
    } else {  // s8: 16 K-slots a chunk, a word's four bytes its rows
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        uint32_t w = WORD0(4 * c + h);
        if constexpr (BITS != 8) w &= M0;  // 8-bit: code - 128 as s8
        if constexpr (F::FB1 != 0) w |= WORD1(4 * c + h) & M1;
        v[h] = w;
      }
    }
    st_shared_v4(bt + nw * ROWB + ((c ^ (nw & 7)) << 4), v);
  }
#undef WORD0
#undef WORD1
}

// the two B tiles (w_hi, w_lo) of a BCQ stage, chunks as unpack_uniform's
template <int BN, int C0, bool RA, int NCH, int CSTEP>
__device__ __forceinline__ void unpack_bcq(const Args& p,
                                           const uint32_t* locs,
                                           const unsigned char* wd,
                                           const float* al,
                                           unsigned char* bhi,
                                           unsigned char* blo, int nl,
                                           int nw) {
  constexpr int BK = 64;
  constexpr int SLOTB = (BK / 32) * BN * 4;  // a plane's bytes a stage
  const int G = p.Kp / p.ng;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = C0 + j * CSTEP;
    // the chunk's 8 rows are contiguous and lie in one group
    const int lg = G >= BK ? 0 : (8 * c) / G;
    const float* ap = al + lg * p.bits * BN + nl;
    float w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0.f;
    for (int b = 0; b < p.bits; ++b) {
      const float a = ap[b * BN];
      const uint32_t u0 =
          code_word<RA, 1, 1, BK, BN, 0>(wd + b * SLOTB, locs, 2 * c, nl);
      const uint32_t u1 =
          code_word<RA, 1, 1, BK, BN, 0>(wd + b * SLOTB, locs, 2 * c + 1, nl);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[r] += ((u0 >> (8 * r)) & 1u) ? a : -a;
        w[4 + r] += ((u1 >> (8 * r)) & 1u) ? a : -a;
      }
    }
    uint32_t vh[4], vl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vh[i] = bf16_pair(w[2 * i], w[2 * i + 1]);
      const float h0 = __uint_as_float(vh[i] << 16);
      const float h1 = __uint_as_float(vh[i] & 0xFFFF0000u);
      vl[i] = bf16_pair(w[2 * i] - h0, w[2 * i + 1] - h1);
    }
    const int off = nw * ROWB + ((c ^ (nw & 7)) << 4);
    st_shared_v4(bhi + off, vh);
    st_shared_v4(blo + off, vl);
  }
}

// the stage's B rows nw of the tile(s) at bt (BCQ: w_hi, then w_lo TR
// bytes on), from word column nl; chunks as unpack_uniform's
template <int KIND, int BITS, int BN, int C0, bool RA, int NCH, int CSTEP,
          int TR>
__device__ __forceinline__ void unpack_with(const Args& p,
                                            const uint32_t* locs,
                                            const unsigned char* st,
                                            unsigned char* bt, int nl,
                                            int nw) {
  if constexpr (KIND == BCQ)
    unpack_bcq<BN, C0, RA, NCH, CSTEP>(
        p, locs, st + p.words_off,
        reinterpret_cast<const float*>(st + p.meta_off), bt, bt + TR, nl,
        nw);
  else
    unpack_uniform<KIND, BITS, BN, C0, RA, NCH, CSTEP>(
        locs, st + p.words_off, bt, nl, nw);
}

// stage kt's B tile(s) into buffer kt % 2
template <int KIND, int BITS, int BN>
__device__ __forceinline__ void unpack_stage(const Args& p, int kt,
                                             const uint32_t* locs,
                                             const unsigned char* ring,
                                             unsigned char* bbuf) {
  constexpr int NB = KIND == BCQ ? 2 : 1;  // B tiles a buffer
  constexpr int BT = BN * ROWB;            // bytes of a B tile
  const unsigned char* st = ring + (kt % p.stages) * p.stage_bytes;
  unsigned char* bt = bbuf + (kt & 1) * NB * BT;
  // the chunk offset and the regime are uniform across a warp: each
  // combination is its own unrolled body
  const bool ra = p.lsb > Log2<Cfg<KIND>::BK>::value;
  constexpr int NCH = 8 * BN / THREADS, CS = THREADS / BN;
  const int nl = threadIdx.x % BN;
  if (BN == THREADS || threadIdx.x < BN) {
    if (ra)
      unpack_with<KIND, BITS, BN, 0, true, NCH, CS, BT>(p, locs, st, bt, nl,
                                                        nl);
    else
      unpack_with<KIND, BITS, BN, 0, false, NCH, CS, BT>(p, locs, st, bt,
                                                         nl, nl);
  } else {
    if (ra)
      unpack_with<KIND, BITS, BN, 1, true, NCH, CS, BT>(p, locs, st, bt, nl,
                                                        nl);
    else
      unpack_with<KIND, BITS, BN, 1, false, NCH, CS, BT>(p, locs, st, bt,
                                                         nl, nl);
  }
}

template <int KIND, int NA, int BITS, int BN, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
    qmma_kernel(const __grid_constant__ Args p) {
  constexpr int BK = Cfg<KIND>::BK;
  constexpr int NB = KIND == BCQ ? 2 : 1;  // B tiles a buffer (w_hi, w_lo)
  constexpr int BT = BN * ROWB;            // bytes of a B tile
  constexpr int NACC = BN / 2;             // accumulators a thread
  using AT = typename AccT<KIND, FOLD>::type;
  using PT = typename AccT<KIND, false>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bbuf = smem;
  unsigned char* ring = smem + 2 * NB * BT;
  uint32_t* locs =
      reinterpret_cast<uint32_t*>(ring + p.stages * p.stage_bytes);
  // full[s]: stage slot s's TMA copies have landed
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(locs) + LOC_BYTES - 8 * MAX_STAGES);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int nk = (p.Kp + BK - 1) / BK;
  const int G = p.Kp / p.ng;
  const int r0 = m0 + wg * 64 + wq * 16 + (lane >> 2);  // and r0 + 8
  // OFF of the fold (see the header)
  constexpr float OFF = KIND == U_S8 ? (BITS == 8 ? -128.f : 0.f)
                        : KIND == U_BF16 ? (BITS == 8 ? 0.f
                                                      : float(1 << BITS))
                                         : 0.f;
  const int spg = FOLD ? G / BK : nk;  // stages a group

  PT part[FOLD ? NACC : 1];  // a group's partial (FOLD only)
  AT acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (FOLD ? NACC : 1); ++i) part[i] = 0;

  build_locs<KIND, BITS, BN>(p.lsb, locs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < p.stages - 1 && s < nk; ++s)
      load_stage<KIND, NA, BITS, BN, FOLD>(p, ring + s * p.stage_bytes,
                                           &full[s], s, s / spg, m0, n0);
  mbar_wait(&full[0], 0);
  unpack_stage<KIND, BITS, BN>(p, 0, locs, ring, bbuf);
  fence_async_smem();

  // groups, then the stages of each: the fold closes the outer body, so
  // no branch guards a read of the MMA's registers (ptxas of CUDA 12.9
  // crashes on a conditional fold inside the stage loop)
  const int ngr = FOLD ? p.ng : 1;
  float xs0 = 0.f, xs1 = 0.f;  // the group's x sums of this thread's rows
  int kt = 0;
  for (int gi = 0; gi < ngr; ++gi) {
    const int kfirst = kt;
    const int kend = min(nk, kt + spg);
    if constexpr (KIND != BCQ) {
      if (r0 < p.M) xs0 = __ldg(p.xsum + (size_t)r0 * p.ng + gi);
      if (r0 + 8 < p.M) xs1 = __ldg(p.xsum + (size_t)(r0 + 8) * p.ng + gi);
    }
    for (; kt < kend; ++kt) {
      // B of stage kt complete (its x landed: waited before its unpack),
      // and every warpgroup done with stage kt-1's MMA
      __syncthreads();
      const unsigned char* st = ring + (kt % p.stages) * p.stage_bytes;
      const uint32_t xa = smem_u32(st) + wg * 64 * ROWB;
      const uint32_t bb = smem_u32(bbuf + (kt & 1) * NB * BT);
      const bool first = kt == kfirst;
      if constexpr (FOLD) reg_fence(part);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t ko = kk * 32;  // 32 bytes of K: k16 bf16 or k32 s8
        if constexpr (KIND == BCQ) {
          wgmma(acc, desc(xa + ko), desc(bb + ko), !(first && kk == 0));
          wgmma(acc, desc(xa + ko), desc(bb + BT + ko), 1);
          if (NA == 2) wgmma(acc, desc(xa + ATILE + ko), desc(bb + ko), 1);
        } else if constexpr (FOLD) {
#pragma unroll
          for (int a = 0; a < NA; ++a)
            wgmma(part, desc(xa + a * ATILE + ko), desc(bb + ko),
                  !(first && kk == 0 && a == 0));
        } else {
#pragma unroll
          for (int a = 0; a < NA; ++a)
            wgmma(acc, desc(xa + a * ATILE + ko), desc(bb + ko),
                  !(first && kk == 0 && a == 0));
        }
      }
      wgmma_commit();
      if (kt + 1 < nk) {  // overlaps the MMA
        mbar_wait(&full[(kt + 1) % p.stages], ((kt + 1) / p.stages) & 1);
        unpack_stage<KIND, BITS, BN>(p, kt + 1, locs, ring, bbuf);
      }
      fence_async_smem();
      // the stage S-1 ahead into the slot of stage kt-1, which everyone
      // is done with (its barrier's last phase waited on by all); issued
      // after the unpack, so warp 0's share of it is not held back
      const int ahead = kt + p.stages - 1;
      if (threadIdx.x == 0 && ahead < nk) {
        const int sa = ahead % p.stages;
        load_stage<KIND, NA, BITS, BN, FOLD>(
            p, ring + sa * p.stage_bytes, &full[sa], ahead,
            FOLD ? ahead / spg : 0, m0, n0);
      }
      wgmma_wait0();
      if constexpr (FOLD) reg_fence(part);
      reg_fence(acc);
    }
    if constexpr (FOLD) {
      // fold the group's partial; its grid rides in its last stage's slot,
      // which the next stage's loads overwrite only after a __syncthreads
      const float* msc = reinterpret_cast<const float*>(
          ring + ((kt - 1) % p.stages) * p.stage_bytes + p.meta_off);
      const float* mz = msc + BN;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        const float2 sc = *reinterpret_cast<const float2*>(msc + col);
        const float2 z = *reinterpret_cast<const float2*>(mz + col);
        const float zx = z.x + OFF * sc.x, zy = z.y + OFF * sc.y;
        acc[4 * j] += (float)part[4 * j] * sc.x - xs0 * zx;
        acc[4 * j + 1] += (float)part[4 * j + 1] * sc.y - xs0 * zy;
        acc[4 * j + 2] += (float)part[4 * j + 2] * sc.x - xs1 * zx;
        acc[4 * j + 3] += (float)part[4 * j + 3] * sc.y - xs1 * zy;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= p.Np) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < p.M)
        *reinterpret_cast<float2*>(p.out + (size_t)r * p.Np + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// one m64n128 accumulator's rows r0 and r0 + 8 at columns col0 + 8 j (+1)
// of the output; a uniform weight's one group grid applies here
template <int KIND, int BITS, typename AT>
__device__ __forceinline__ void store_rows(const Args& p, const AT (&acc)[64],
                                           int r0, int col0, float off) {
  float xs0 = 0.f, xs1 = 0.f;
  if constexpr (KIND != BCQ) {
    if (r0 < p.M) xs0 = __ldg(p.xsum + r0);  // one group: (M, 1)
    if (r0 + 8 < p.M) xs1 = __ldg(p.xsum + r0 + 8);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + j * 8;
    if (col >= p.Np) continue;
    float2 sc = make_float2(1.f, 1.f), z = make_float2(0.f, 0.f);
    if constexpr (KIND != BCQ) {
      sc = __ldg(reinterpret_cast<const float2*>(p.scale + col));
      z = __ldg(reinterpret_cast<const float2*>(p.zoff + col));
      z.x += off * sc.x;
      z.y += off * sc.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float xs = h ? xs1 : xs0;
      if (r < p.M)
        *reinterpret_cast<float2*>(p.out + (size_t)r * p.Np + col) =
            make_float2((float)acc[4 * j + 2 * h] * sc.x - xs * z.x,
                        (float)acc[4 * j + 2 * h + 1] * sc.y - xs * z.y);
    }
  }
}

// One group (uniform, groupsize -1) or BCQ, on 256 columns: warpgroup w
// owns columns 128 w .. 128 w + 127 over all 128 rows (two m64n128 wgmma
// a k-step) and unpacks its own half of the B tile into its own buffers;
// a ninth warp only refills the ring (one thread: wait for a slot's empty
// barrier, then its TMA), so the warpgroups meet nowhere but at those
// barriers and drift apart: one's MMA runs while the other unpacks.
template <int KIND, int NA, int BITS>
__global__ void __launch_bounds__(THREADS + 32, 1)
    qmma_split_kernel(const __grid_constant__ Args p) {
  constexpr int BN = 256, HN = 128;
  constexpr int BK = Cfg<KIND>::BK;
  constexpr int NB = KIND == BCQ ? 2 : 1;  // B tiles a buffer (w_hi, w_lo)
  constexpr int HT = HN * ROWB;            // a warpgroup's B tile
  using AT = typename AccT<KIND, false>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bbuf = smem;  // [buffer][warpgroup][NB] tiles
  unsigned char* ring = smem + 2 * NB * BN * ROWB;
  uint32_t* locs =
      reinterpret_cast<uint32_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(locs) + LOC_BYTES / 2);
  uint64_t* empty = full + MAX_STAGES;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x >> 7, tl = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int nk = (p.Kp + BK - 1) / BK;
  const bool ra = p.lsb > Log2<BK>::value;
  // OFF of the grid (see the header)
  constexpr float OFF = KIND == U_S8 ? (BITS == 8 ? -128.f : 0.f)
                        : KIND == U_BF16 ? (BITS == 8 ? 0.f
                                                      : float(1 << BITS))
                                         : 0.f;
  AT acc0[64], acc1[64];  // rows 0..63 and 64..127 of the tile
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;

  build_locs<KIND, BITS, BN>(p.lsb, locs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= THREADS) {  // the loader warp: one thread, the ring
    if (threadIdx.x == THREADS)
      for (int L = 0; L < nk; ++L) {
        const int s = L % p.stages;
        if (L >= p.stages)  // both warpgroups done with stage L - S
          mbar_wait(&empty[s], ((L / p.stages) & 1) ^ 1);
        fence_async_smem();
        load_stage<KIND, NA, BITS, BN, false>(p, ring + s * p.stage_bytes,
                                              &full[s], L, 0, m0, n0);
      }
    return;
  }

  // this warpgroup's half of stage kt's B tile(s), into its buffer kt % 2
#define UNPACK_HALF(kt)                                                     \
  {                                                                         \
    const unsigned char* st = ring + ((kt) % p.stages) * p.stage_bytes;    \
    unsigned char* bt = bbuf + (((kt) & 1) * 2 + wg) * NB * HT;             \
    if (ra)                                                                 \
      unpack_with<KIND, BITS, BN, 0, true, 8, 1, HT>(p, locs, st, bt,       \
                                                     wg * HN + tl, tl);     \
    else                                                                    \
      unpack_with<KIND, BITS, BN, 0, false, 8, 1, HT>(p, locs, st, bt,      \
                                                      wg * HN + tl, tl);    \
  }
  mbar_wait(&full[0], 0);
  UNPACK_HALF(0)
  fence_async_smem();

  for (int kt = 0; kt < nk; ++kt) {
    // this warpgroup's B of stage kt complete, its MMA of kt-1 done
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int s = kt % p.stages;
    const uint32_t xa = smem_u32(ring + s * p.stage_bytes);
    const uint32_t bb = smem_u32(bbuf + ((kt & 1) * 2 + wg) * NB * HT);
    reg_fence(acc0);
    reg_fence(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ko = kk * 32;  // 32 bytes of K: k16 bf16 or k32 s8
      const int d = !(kt == 0 && kk == 0);
      if constexpr (KIND == BCQ) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {  // x_hi . (w_hi + w_lo), x_lo . w_hi
          const uint32_t x0 = xa + a * ATILE + ko, x1 = x0 + 64 * ROWB;
          wgmma(acc0, desc(x0), desc(bb + ko), a ? 1 : d);
          wgmma(acc1, desc(x1), desc(bb + ko), a ? 1 : d);
          if (a == 0) {
            wgmma(acc0, desc(x0), desc(bb + HT + ko), 1);
            wgmma(acc1, desc(x1), desc(bb + HT + ko), 1);
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const uint32_t x0 = xa + a * ATILE + ko;
          wgmma(acc0, desc(x0), desc(bb + ko), a ? 1 : d);
          wgmma(acc1, desc(x0 + 64 * ROWB), desc(bb + ko), a ? 1 : d);
        }
      }
    }
    wgmma_commit();
    if (kt + 1 < nk) {  // overlaps the MMA
      mbar_wait(&full[(kt + 1) % p.stages], ((kt + 1) / p.stages) & 1);
      UNPACK_HALF(kt + 1)
    }
    fence_async_smem();
    wgmma_wait0();
    reg_fence(acc0);
    reg_fence(acc1);
    mbar_arrive(&empty[s]);
  }
#undef UNPACK_HALF

  store_rows<KIND, BITS>(p, acc0, m0 + wq * 16 + (lane >> 2),
                         n0 + wg * HN + (lane & 3) * 2, OFF);
  store_rows<KIND, BITS>(p, acc1, m0 + 64 + wq * 16 + (lane >> 2),
                         n0 + wg * HN + (lane & 3) * 2, OFF);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int round1k(int v) { return (v + 1023) & ~1023; }

// the shared memory a launch needs, its stage layout in `a` (0: no
// layout with 3 or more stages fits)
template <int KIND, int NA, int BITS, int BN, bool FOLD>
int plan(Args& a) {
  using F = Fields<KIND, BITS>;
  constexpr int BK = Cfg<KIND>::BK;
  constexpr int NB = KIND == BCQ ? 2 : 1;
  int words, meta;
  if constexpr (KIND == BCQ) {
    const int G = a.Kp / a.ng;
    words = a.bits * (BK / 32) * BN * 4;
    meta = (G >= BK ? 1 : BK / G) * a.bits * BN * 4;
  } else {
    words = (BK * F::FB0 / 32 + BK * F::FB1 / 32) * BN * 4;
    meta = FOLD ? 2 * BN * 4 : 0;
  }
  a.words_off = NA * ATILE;
  a.meta_off = a.words_off + words;
  a.stage_bytes = round1k(a.meta_off + meta);
  a.tx_bytes = a.meta_off + meta;
  const int fixed = 2 * NB * BN * ROWB + LOC_BYTES + 1024;
  for (a.stages = MAX_STAGES; a.stages >= 3; --a.stages)
    if (fixed + a.stages * a.stage_bytes <= SMEM_LIMIT)
      return fixed + a.stages * a.stage_bytes;
  return 0;
}

// the launch's TMA maps: x (its columns in the stage row order: boxes of
// BK columns, 128 bytes, by 128 rows), the words by field, the grid rows.
// (A 4-dimensional map of x in the natural order would need boxes whose
// inner rows are shorter than the 128-byte swizzle span, which TMA pads
// to the full span.)
template <int KIND, int NA, int BITS, int BN, bool FOLD>
bool make_maps(Args& a) {
  using F = Fields<KIND, BITS>;
  constexpr int BK = Cfg<KIND>::BK, ES = Cfg<KIND>::ES;
  constexpr int J = BK * F::FBMIN / 32;
  const cuuint64_t SB = 1u << a.lsb, Kp = a.Kp, M = a.M, Np = a.Np;
  const bool ra = (int)SB > BK;
  const CUtensorMapDataType xt = KIND == U_S8
                                     ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = true;
  for (int i = 0; i < NA; ++i) {
    const cuuint64_t d[2] = {Kp, M}, s[1] = {Kp * ES};
    const cuuint32_t b[2] = {BK, BM};
    ok = ok && tmap(&a.tx[i], xt, 2, i ? a.xb : a.xa, d, s, b, true);
  }
  const cuuint64_t s[1] = {Np * 4};
  if constexpr (KIND == BCQ) {
    const int G = a.Kp / a.ng;
    const cuuint64_t d[2] = {Np, a.bits * Kp / 32};
    const cuuint32_t b[2] = {BN, BK / 32};
    ok = ok && tmap(&a.tw[0], CU_TENSOR_MAP_DATA_TYPE_INT32, 2, a.w0, d, s,
                    b, false);
    const cuuint64_t da[2] = {Np, (cuuint64_t)a.ng * a.bits};
    const cuuint32_t ba[2] = {BN, (cuuint32_t)((G >= BK ? 1 : BK / G) *
                                               a.bits)};
    ok = ok && tmap(&a.tm[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.alpha,
                    da, s, ba, false);
  } else {
    const int fbs[2] = {F::FB0, F::FB1};
    const int32_t* ws[2] = {a.w0, a.w1};
    for (int f = 0; f < F::NF; ++f) {
      const cuuint64_t d[2] = {Np, Kp * fbs[f] / 32};
      const cuuint32_t b[2] = {BN, (cuuint32_t)(ra ? J : BK * fbs[f] / 32)};
      ok = ok && tmap(&a.tw[f], CU_TENSOR_MAP_DATA_TYPE_INT32, 2, ws[f], d,
                      s, b, false);
    }
    if (FOLD) {
      const cuuint64_t d[2] = {Np, (cuuint64_t)a.ng};
      const cuuint32_t b[2] = {BN, 1};
      ok = ok && tmap(&a.tm[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.scale,
                      d, s, b, false) &&
           tmap(&a.tm[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.zoff, d, s,
                b, false);
    }
  }
  return ok;
}

// SPLIT: qmma_split_kernel (BN = 256, one accumulator); else qmma_kernel
template <int KIND, int NA, int BITS, int BN, bool FOLD, bool SPLIT = false>
int launch(Args a, cudaStream_t st) {
  const int smem = plan<KIND, NA, BITS, BN, FOLD>(a);
  if (smem == 0 || !make_maps<KIND, NA, BITS, BN, FOLD>(a))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const Args);
  if constexpr (SPLIT)
    kern = qmma_split_kernel<KIND, NA, BITS>;
  else
    kern = qmma_kernel<KIND, NA, BITS, BN, FOLD>;
  static bool opted = false;  // one opt-in per instantiation
  if (!opted) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_LIMIT);  // a failure shows in cudaGetLastError
    opted = true;
  }
  const dim3 grid((a.Np + BN - 1) / BN, (a.M + BM - 1) / BM);
  kern<<<grid, SPLIT ? THREADS + 32 : THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// uniform: grouped weights fold per group on 128 columns, one group takes
// 256 columns and one accumulator
template <int KIND, int NA, int BITS>
int launch_uniform(const Args& a, cudaStream_t st) {
  return a.ng > 1 ? launch<KIND, NA, BITS, 128, true>(a, st)
                  : launch<KIND, NA, BITS, 256, false, true>(a, st);
}

// kind: U_BF16 / U_S8 / BCQ; na: x operands (2: a split f32 x)
int dispatch(const Args& a, int kind, int na, cudaStream_t st) {
  const int key = kind * 100 + na * 10 + (kind == BCQ ? 0 : a.bits);
  switch (key) {
    case 12: return launch_uniform<U_BF16, 1, 2>(a, st);
    case 13: return launch_uniform<U_BF16, 1, 3>(a, st);
    case 14: return launch_uniform<U_BF16, 1, 4>(a, st);
    case 18: return launch_uniform<U_BF16, 1, 8>(a, st);
    case 22: return launch_uniform<U_BF16, 2, 2>(a, st);
    case 23: return launch_uniform<U_BF16, 2, 3>(a, st);
    case 24: return launch_uniform<U_BF16, 2, 4>(a, st);
    case 28: return launch_uniform<U_BF16, 2, 8>(a, st);
    case 112: return launch_uniform<U_S8, 1, 2>(a, st);
    case 113: return launch_uniform<U_S8, 1, 3>(a, st);
    case 114: return launch_uniform<U_S8, 1, 4>(a, st);
    case 118: return launch_uniform<U_S8, 1, 8>(a, st);
    // BCQ: 128 columns (its unpack's work a product is twice the uniform
    // one's; at the PPL eval's M = 512, 256 columns leave 1.5 waves)
    case 210: {  // the split kernel's 256 columns where its stages fit
      Args b = a;
      return plan<BCQ, 1, 0, 256, false>(b)
                 ? launch<BCQ, 1, 0, 256, false, true>(a, st)
                 : launch<BCQ, 1, 0, 128, false>(a, st);
    }
    case 220: return launch<BCQ, 2, 0, 128, false>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// #1 at many rows. x_kind 1: bf16 xa (xb null), or a split f32 x (xa =
// x_hi, xb = x_lo); 2: int8 xa. w1: the 3-bit weight's 1-bit field, else
// null. xsum (M, ng) f32: x summed over each group of the padded Kp (the
// f32 x's own sums for a split x). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int qmma_launch(const void* xa, const void* xb, int x_kind, int M,
                           int Kp, const void* w0, const void* w1, int bits,
                           int SB, const void* scale, const void* zoff,
                           const void* xsum, int ng, void* out, int Np,
                           void* stream) {
  Args a{};
  a.xa = xa;
  a.xb = xb;
  a.M = M;
  a.Kp = Kp;
  a.Np = Np;
  a.w0 = (const int32_t*)w0;
  a.w1 = (const int32_t*)w1;
  a.bits = bits;
  a.lsb = log2_exact(SB);
  a.scale = (const float*)scale;
  a.zoff = (const float*)zoff;
  a.xsum = (const float*)xsum;
  a.ng = ng;
  a.out = (float*)out;
  const int BK = x_kind == 2 ? 128 : 64;
  const int G = ng > 0 ? Kp / ng : 0;
  if (M < 1 || Kp % 32 || a.lsb < 5 || a.lsb > 9 || Kp % SB || Np % 4 ||
      ng < 1 || Kp % ng || (ng > 1 && (G % BK || G % SB)) ||
      (bits == 3) != (w1 != nullptr) || (x_kind == 2 && xb != nullptr) ||
      !aligned16(xa) || !aligned16(xb) || !aligned16(w0) || !aligned16(w1) ||
      !aligned16(scale) || !aligned16(zoff) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (x_kind != 1 && x_kind != 2) return (int)cudaErrorInvalidValue;
  return dispatch(a, x_kind == 2 ? U_S8 : U_BF16, xb ? 2 : 1,
                  (cudaStream_t)stream);
}

// #13 at many rows: bf16 xa (xb null), or a split f32 x (x_hi, x_lo); the
// wrapper converts int8 x to bf16. w: (bits, Kp/32, Np) sign planes, alpha
// (ng, bits, Np) f32; groups of a multiple of 8 rows that divide or are
// divided by 64 (one group: any length).
extern "C" int bcq_mma_launch(const void* xa, const void* xb, int M, int Kp,
                              const void* w, int bits, int SB,
                              const void* alpha, int ng, void* out, int Np,
                              void* stream) {
  Args a{};
  a.xa = xa;
  a.xb = xb;
  a.M = M;
  a.Kp = Kp;
  a.Np = Np;
  a.w0 = (const int32_t*)w;
  a.bits = bits;
  a.lsb = log2_exact(SB);
  a.alpha = (const float*)alpha;
  a.ng = ng;
  a.out = (float*)out;
  const int G = ng > 0 ? Kp / ng : 0;
  if (M < 1 || Kp % 32 || a.lsb < 5 || a.lsb > 9 || Kp % SB || Np % 4 ||
      ng < 1 || Kp % ng || G % 8 || (ng > 1 && G % 64 && 64 % G) || bits < 1 ||
      bits > 8 || !aligned16(xa) || !aligned16(xb) || !aligned16(w) ||
      !aligned16(alpha) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  return dispatch(a, BCQ, xb ? 2 : 1, (cudaStream_t)stream);
}
