// The single-row (decode, M = 1) packed matmul of #1 (and #7's streamed
// route), #13 and #9, and #4's norm + matmul: one design, four kernels.
// qmatmul.cu and qstream.cu launch qgemv_kernel (uniform grids),
// bcq_matmul.cu bcq_gemv_kernel (BCQ sign planes), qexpert.cu
// qsel_gemv_kernel (one expert of a uniform bank, chosen by a device
// index) and ffn.cu norm_qkv_gemv_kernel (below):
//
//   #1:  out[n] = sum_g (x_g . C_g)[n] scale[g, n] - xsum_g zoff[g, n]
//   #13: out[n] = sum_g sum_b alpha[g, b, n] (2 (x_g . B_b)[n] - xsum_g)
//   #9:  #1 over bank[e], e = *eidx read by every block before its first
//        copy: the expert's fields lie e (Kp fb / 32) Np words, its grids
//        e ng Np entries into the bank's; an e outside [0, E) gives NaN
//        outputs (every block of a cluster reads the same e and leaves
//        before any arrival is due)
//
// over the stored dims: x (Kp,) f32 / bf16 / int8, out (Np,) f32. The
// caller applies the int8 row scale and the bias. #4 at one row (ln1 +
// q|k|v, or final_ln + the head) normalizes and scales in the kernel:
//
//   #4:  out = q8(bf16(norm(x) w_ln (+ b_ln))) @ dequant(W) sx (+ b)
//
// #1's stream with the norm in front, as gptq_tpu/ops/ffn.py's
// _norm_qkv_kernel starts its weight DMAs before the norm: the producer
// copies no x and fills the ring at once, while the consumer warps read
// the whole f32 row from L2 (wstream.cuh row_norm: the statistics, the
// norm and, a8, the absmax and sx) and stage only their piece's K range
// of it (int8 codes or bf16) with the range's group sums. Every block
// stages the same bits in the same order, so every rank holds the same
// sx, and rank 0 writes (D - Z) sx + b after the piece sum.
//
// Bound on an H100: the packed words and the grids over the memory rate
// (a llama-7B layer's four w4 g-1 linears: ~103 MB, 0.031 ms). The stream
// is the whole kernel, so it is built as the whole-layer kernel's is
// (layer_stream.cuh), with wstream.cuh's stage product:
//   * a chunk of CC = 128 columns is cut in K into `splits` pieces, one
//     block each, so that the chunks times the pieces fill the SMs two
//     blocks each, all resident at once (ops/qmatmul.gemv_splits bounds
//     them, gemv_launch keeps the clusters resident; gemv_pieces writes
//     out the cut: whole units of `unit` K rows, a unit holding whole
//     subblocks and whole runs of GRW word rows of every field). A
//     chunk's pieces are one thread block cluster; each writes its sums
//     into rank 0's shared memory and arrives on its mbarrier, and rank 0
//     sums them in piece order, so two launches give the same bits and no
//     device state outlives a launch.
//   * a producer warp streams the piece's word rows through a ring of
//     16 KB stages (32 word rows x 128 columns of one field or sign plane):
//     one bulk copy (cp.async.bulk, no tensor map) a 512-byte row, the
//     stages on mbarriers. Its first copy is the piece's x range (nothing
//     else of x), then the ring's depth of stages.
//   * 8 consumer warps take 4 word rows of each stage, a lane 16 bytes of
//     each (four columns), every code of each word used (wstream.cuh
//     rows_dot: dp4a for int8 x, exact int32 partials). A warp applies
//     its rows' group scale (uniform: scale, 4 x scale on the 3-bit
//     weight's 1-bit field; BCQ: 2 alpha) to its exact partial, the grid
//     row read as a float4 before the stage lands.
//   * the zero-point term (uniform: xsum_g zoff[g]; BCQ: xsum_g alpha[g, b]
//     on each plane) is summed apart from the products, by the warp that
//     takes a group's first row in the piece, from the group sums of the
//     staged x range; it is subtracted once, after the pieces are summed.
// Groups must cover whole subblocks (the caller sends other weights to
// the tiled kernels) and Np be a multiple of 4 (16-byte rows).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"      // mbarriers, bulk_copy
#include "wstream.cuh"  // CC, RR, STAGE_BYTES, DotAcc, RowMap, rows_dot

namespace {

constexpr int GW = 8;               // consumer warps
constexpr int GCT = 32 * GW;        // consumer threads
constexpr int GTHREADS = GCT + 32;  // and the producer warp
constexpr int GRW = RR / GW;        // a consumer warp's word rows a stage
constexpr int GMAXS = 8;            // pieces of a chunk: a portable cluster
constexpr int GMAXNS = 6;           // ring stages
constexpr int GROOM = 232448;       // shared memory one block may take
constexpr int GPAIR = 115712;       // ... and each of two on one SM

struct GemvArgs {
  const void* x;       // (Kp,) f32 / bf16 / int8
  const int32_t* w0;   // uniform: field 0; BCQ: the (bits, Kp/32, Np) planes
  const int32_t* w1;   // uniform 3-bit: the 1-bit field; else null
  const float* grid;   // uniform: scale (ng, Np); BCQ: alpha (ng, bits, Np)
  const float* zoff;   // uniform: (ng, Np); BCQ: null
  float* out;          // (Np,)
  const int* eidx;     // #9: the expert's index (device int32), else null
  int E;               // #9: experts in the bank
  // #4: x is the f32 row (bf16 values), normed by nw (and nb: layernorm;
  // norm 0 rmsnorm, 1 rmsnorm1p, 2 layernorm), the output biased by bias
  // (Np f32) or not (null)
  const float* nw;
  const float* nb;
  const float* bias;
  int norm;
  float eps;
  int Kp, Np, SB, ng, bits, splits, unit, ns;
  // dynamic shared memory: ring | staged x | run sums | group sums | warp
  // partials, then the pieces' sums (rank 0) | mbarriers
  int off_x, off_runs, off_xg, off_red, off_bar;
};

// field (uniform) or sign plane (BCQ) f of the weight (#9: of expert e),
// over the word rows [r0, r1) of the piece's K range [k0, k1)
template <bool BCQ>
struct GField : RowMap {
  const int32_t* w;     // (rows, Np) words
  const float* grid;    // the weight's grid (uniform: scale) and zero points
  const float* zoff;
  int fb, gw, r0, r1, srow, sstep;  // grid row of group g: g sstep + srow
  float mul;  // the exact partial's factor beside the grid
  bool zero;  // adds the zero-point term
  __device__ GField(const GemvArgs& a, int f, int k0, int k1, int e)
      : RowMap(a.SB, BCQ ? 1 : a.bits == 3 ? (f ? 1 : 2) : a.bits) {
    fb = BCQ ? 1 : a.bits == 3 ? (f ? 1 : 2) : a.bits;
    w = BCQ ? a.w0 + (size_t)f * (a.Kp / 32) * a.Np : f ? a.w1 : a.w0;
    w += (size_t)e * ((size_t)a.Kp * fb / 32) * a.Np;
    grid = a.grid + (size_t)e * a.ng * a.Np;
    zoff = BCQ ? nullptr : a.zoff + (size_t)e * a.ng * a.Np;
    gw = a.Kp / a.ng * fb / 32;
    r0 = k0 * fb / 32;
    r1 = k1 * fb / 32;
    srow = BCQ ? f : 0;
    sstep = BCQ ? a.bits : 1;
    mul = BCQ ? 2.f : a.bits == 3 && f ? 4.f : 1.f;
    zero = BCQ || f == 0;
  }
};

__device__ __forceinline__ void gemv_bar() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;" ::"n"(GCT) : "memory");
}

// the cluster's barrier, split: every thread arrives once its block's
// mbarriers are initialized and waits before it touches another block's
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// an arrival, releasing this thread's (and, after a block barrier, its
// block's) writes at cluster scope, on the mbarrier at `bar` of rank 0
__device__ __forceinline__ void mbar_arrive_rank0(uint64_t* bar) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
               : "=r"(r)
               : "r"(smem_u32(bar)));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          r)
      : "memory");
}
// mbar_wait with the arrivals' writes acquired at cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAITC;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// the sum of 32 staged x values, in a fixed order (int8: exact)
__device__ __forceinline__ float run_sum(const int8_t* x) {
  const int4* v = reinterpret_cast<const int4*>(x);
  int s = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 q = v[j];
    s = __dp4a(q.x, 0x01010101, s);
    s = __dp4a(q.y, 0x01010101, s);
    s = __dp4a(q.z, 0x01010101, s);
    s = __dp4a(q.w, 0x01010101, s);
  }
  return (float)s;
}
__device__ __forceinline__ float run_sum(const __nv_bfloat16* x) {
  const uint4* v = reinterpret_cast<const uint4*>(x);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 q = v[j];
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s += __uint_as_float(u[e] << 16) + __uint_as_float(u[e] & 0xffff0000u);
  }
  return s;
}
__device__ __forceinline__ float run_sum(const float* x) {
  const float4* v = reinterpret_cast<const float4*>(x);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q = v[j];
    s += q.x + q.y + q.z + q.w;
  }
  return s;
}

// the pieces of a chunk: piece p takes the K rows [k0, k1), whole units
// (ops/qmatmul.gemv_pieces writes out the same cut)
__host__ __device__ inline void gemv_piece(int Kp, int unit, int splits,
                                           int p, int& k0, int& k1) {
  const int units = (Kp + unit - 1) / unit;
  k0 = p * units / splits * unit;
  k1 = (p + 1) * units / splits * unit;
  k0 = k0 < Kp ? k0 : Kp;
  k1 = k1 < Kp ? k1 : Kp;
}

// the producer warp: the piece's x range (#4: none, its consumers stage
// x), then its stages (the fields or planes in order, 32 word rows of the
// chunk a stage, a lane a row)
template <typename ST, bool BCQ, bool NORM>
__device__ void gemv_produce(const GemvArgs& a, unsigned char* ring,
                             uint64_t* full, uint64_t* empty, uint64_t* xbar,
                             ST* xs, int c, int k0, int k1, int nf, int e) {
  const int lane = threadIdx.x & 31;
  if (!NORM && lane == 0) {
    const int xb = (k1 - k0) * (int)sizeof(ST);
    mbar_expect(xbar, xb);
    bulk_copy(xs, reinterpret_cast<const ST*>(a.x) + k0, xb, xbar);
  }
  const int cols = a.Np - c * CC < CC ? a.Np - c * CC : CC;
  const int rowb = cols * 4;
  int k = 0;
  for (int f = 0; f < nf; ++f) {
    const GField<BCQ> fd(a, f, k0, k1, e);
    for (int r = fd.r0; r < fd.r1; r += RR, ++k) {
      const int slot = k % a.ns;
      if (k >= a.ns) mbar_wait(&empty[slot], ((k / a.ns) - 1) & 1);
      const int nr = fd.r1 - r < RR ? fd.r1 - r : RR;
      if (lane == 0) mbar_expect(&full[slot], nr * rowb);
      __syncwarp();
      if (lane < nr)
        bulk_copy(ring + (size_t)slot * STAGE_BYTES + lane * CC * 4,
                  fd.w + (size_t)(r + lane) * a.Np + c * CC, rowb,
                  &full[slot]);
    }
  }
}

// a warp's rows [gr0, gr0 + nr) of a stage (rows: the first of them)
// into its four columns' products d and zero-point terms z. sc / zz: the
// grid (and, uniform, zero-point) row of gr0's group g0, read already;
// z0: whether gr0 is that group's first row in the piece
template <typename ST, int FB, bool BCQ>
__device__ __forceinline__ void gemv_rows(
    const GemvArgs& a, const int4* rows, int gr0, int nr, const ST* xs,
    const GField<BCQ>& fd, const float* xg, int gA, int n0, bool live,
    float4 sc, float4 zz, bool z0, float (&d)[4], float (&z)[4]) {
  using AT = typename DotAcc<ST>::type;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fold = [&](const AT (&dot)[4], int g, float4 s, float4 zo, bool zr) {
    d[0] += (float)dot[0] * (s.x * fd.mul);
    d[1] += (float)dot[1] * (s.y * fd.mul);
    d[2] += (float)dot[2] * (s.z * fd.mul);
    d[3] += (float)dot[3] * (s.w * fd.mul);
    if (zr) {
      const float4 zs = BCQ ? s : zo;
      const float xv = xg[g - gA];
      z[0] += xv * zs.x;
      z[1] += xv * zs.y;
      z[2] += xv * zs.z;
      z[3] += xv * zs.w;
    }
  };
  const int g0 = gr0 / fd.gw;
  if (fd.gw % GRW == 0) {  // the warp's rows lie in one group
    AT dot[4] = {0, 0, 0, 0};
    rows_dot<FB, GRW>(rows, gr0 - fd.r0, nr, xs, fd, dot);
    fold(dot, g0, sc, zz, z0);
    return;
  }
  for (int i = 0; i < nr; ++i) {  // groups shorter than the warp's rows
    const int gr = gr0 + i, g = gr / fd.gw;
    const bool zr = fd.zero && gr == max(g * fd.gw, fd.r0);
    if (g != g0 && live) {
      sc = ldg4(fd.grid + (size_t)(g * fd.sstep + fd.srow) * a.Np + n0);
      zz = !BCQ && zr ? ldg4(fd.zoff + (size_t)g * a.Np + n0) : zero4;
    }
    AT dot[4] = {0, 0, 0, 0};
    rows_dot<FB, 1>(rows + i * (CC / 4), gr - fd.r0, 1, xs, fd, dot);
    fold(dot, g, sc, zz, i == 0 ? z0 : zr);
  }
}

// #4's input row: the f32 row in device memory, read again in each pass
// (L2 holds it: every block of the launch reads the same row)
struct GlobalRow {
  const float4* x;
  int NV;
  template <int U>
  __device__ __forceinline__ void load(int v0, int step,
                                       float4 (&v)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = v0 + step * u < NV ? __ldg(x + v0 + step * u)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void passed() const {}
  __device__ __forceinline__ float4 get(int vi) const { return __ldg(x + vi); }
  __device__ __forceinline__ void put(int, float4) const {}
};

// #4: the whole row's norm and int8 scale, then the piece's K range [k0,
// k1) of the staged row into xs. Returns sx (a16: 1).
template <typename ST>
__device__ float gemv_norm_stage(const GemvArgs& a, ST* xs, float* red,
                                 int k0, int k1) {
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* n4 = reinterpret_cast<const float4*>(a.nw);
  const float4* b4 = reinterpret_cast<const float4*>(a.nb);
  GlobalRow row{x4, a.Kp / 4};
  float mu, rstd;
  const float sx = row_norm<GCT, 4, sizeof(ST) == 1>(
      row, a.Kp / 4, a.nw, a.nb, a.norm, a.eps, red, mu, rstd);
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int vi = k0 / 4 + (int)threadIdx.x; vi < k1 / 4; vi += GCT)
    store_staged(xs, vi - k0 / 4,
                 norm4(__ldg(x4 + vi), __ldg(n4 + vi),
                       a.norm == 2 ? __ldg(b4 + vi) : z4, a.norm, mu, rstd),
                 sx);
  return sx;
}

// the consumer warps: the piece's group sums of x (#4: after staging the
// piece's range of the normed row), then its stages; D / Z: thread t <
// CC's column of the piece's products and zero-point terms; sx: #4's int8
// scale (else 1)
template <typename ST, bool BCQ, bool NORM>
__device__ void gemv_consume(const GemvArgs& a, unsigned char* ring,
                             uint64_t* full, uint64_t* empty, uint64_t* xbar,
                             ST* xs, float* runs, float* xg, float* red,
                             int c, int k0, int k1, int nf, int e, float& D,
                             float& Z, float& sx) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = a.Kp / a.ng, gA = k0 / G, ngp = (k1 - 1) / G - gA + 1;
  sx = 1.f;
  if constexpr (NORM) {
    sx = gemv_norm_stage<ST>(a, xs, red, k0, k1);
    gemv_bar();
  } else {
    mbar_wait(xbar, 0);
  }
  for (int i = t; i < (k1 - k0) / 32; i += GCT) runs[i] = run_sum(xs + 32 * i);
  gemv_bar();
  for (int g = warp; g < ngp; g += GW) {  // each group's part of the piece
    const int lo = max(k0, (gA + g) * G) - k0;
    const int hi = min(k1, (gA + g + 1) * G) - k0;
    float v = 0.f;
    for (int i = lo / 32 + lane; i < hi / 32; i += 32) v += runs[i];
    v = warp_sum(v);
    if (lane == 0) xg[g] = v;
  }
  gemv_bar();
  const int n0 = c * CC + 4 * lane;
  const bool live = n0 < a.Np;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float d[4] = {0.f, 0.f, 0.f, 0.f}, z[4] = {0.f, 0.f, 0.f, 0.f};
  int k = 0;
  for (int f = 0; f < nf; ++f) {
    const GField<BCQ> fd(a, f, k0, k1, e);
    for (int r = fd.r0; r < fd.r1; r += RR, ++k) {
      const int slot = k % a.ns;
      const int gr0 = r + GRW * warp, nr = min(GRW, fd.r1 - gr0);
      // the first row's group grid, asked for before the stage lands
      const int g0 = gr0 / fd.gw;
      const bool z0 = fd.zero && nr > 0 && gr0 == max(g0 * fd.gw, fd.r0);
      float4 sc = zero4, zz = zero4;
      if (live && nr > 0) {
        sc = ldg4(fd.grid + (size_t)(g0 * fd.sstep + fd.srow) * a.Np + n0);
        if (!BCQ && z0) zz = ldg4(fd.zoff + (size_t)g0 * a.Np + n0);
      }
      mbar_wait(&full[slot], (k / a.ns) & 1);
      if (nr > 0) {
        const int4* rows =
            reinterpret_cast<const int4*>(ring + (size_t)slot * STAGE_BYTES) +
            GRW * warp * (CC / 4);
        if constexpr (BCQ) {
          gemv_rows<ST, 1, BCQ>(a, rows, gr0, nr, xs, fd, xg, gA, n0, live, sc,
                                zz, z0, d, z);
        } else {
          switch (fd.fb) {
            case 1: gemv_rows<ST, 1, BCQ>(a, rows, gr0, nr, xs, fd, xg, gA, n0,
                                          live, sc, zz, z0, d, z); break;
            case 2: gemv_rows<ST, 2, BCQ>(a, rows, gr0, nr, xs, fd, xg, gA, n0,
                                          live, sc, zz, z0, d, z); break;
            case 4: gemv_rows<ST, 4, BCQ>(a, rows, gr0, nr, xs, fd, xg, gA, n0,
                                          live, sc, zz, z0, d, z); break;
            default: gemv_rows<ST, 8, BCQ>(a, rows, gr0, nr, xs, fd, xg, gA,
                                           n0, live, sc, zz, z0, d, z); break;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  // the piece: the warps' partials summed in warp order
  *reinterpret_cast<float4*>(red + warp * CC + 4 * lane) =
      make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(red + (GW + warp) * CC + 4 * lane) =
      make_float4(z[0], z[1], z[2], z[3]);
  gemv_bar();
  if (t < CC) {
    D = Z = 0.f;
#pragma unroll
    for (int w = 0; w < GW; ++w) {
      D += red[w * CC + t];
      Z += red[(GW + w) * CC + t];
    }
  }
}

template <typename ST, bool BCQ, bool SEL, bool NORM>
__device__ __forceinline__ void gemv_block(const GemvArgs& a) {
  extern __shared__ __align__(128) unsigned char gsmem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(gsmem + a.off_bar);
  uint64_t* empty = full + a.ns;
  uint64_t* xbar = empty + a.ns;
  uint64_t* pieces = xbar + 1;  // rank 0: the other pieces' arrivals
  ST* xs = reinterpret_cast<ST*>(gsmem + a.off_x);
  const int t = threadIdx.x;
  const int piece = blockIdx.x % a.splits, c = blockIdx.x / a.splits;
  int e = 0;  // #9: the expert, read before anything else
  if constexpr (SEL) {
    e = __ldg(a.eidx);
    if (e < 0 || e >= a.E) {  // the same e in every block: the cluster
      // leaves before its barrier, no arrival is awaited
      if (piece == 0 && t < CC && c * CC + t < a.Np)
        a.out[c * CC + t] = __int_as_float(0x7fc00000);
      return;
    }
  }
  int k0, k1;
  gemv_piece(a.Kp, a.unit, a.splits, piece, k0, k1);
  const int nf = BCQ ? a.bits : a.bits == 3 ? 2 : 1;
  if (t == 0) {
    for (int i = 0; i < a.ns; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], GW);
    }
    mbar_init(xbar, 1);
    mbar_init(pieces, a.splits - 1 > 0 ? a.splits - 1 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (a.splits > 1) cluster_arrive_relaxed();
  float D = 0.f, Z = 0.f, sx = 1.f;
  if (t >= GCT)
    gemv_produce<ST, BCQ, NORM>(a, gsmem, full, empty, xbar, xs, c, k0, k1,
                                nf, e);
  else
    gemv_consume<ST, BCQ, NORM>(a, gsmem, full, empty, xbar, xs,
                                reinterpret_cast<float*>(gsmem + a.off_runs),
                                reinterpret_cast<float*>(gsmem + a.off_xg),
                                reinterpret_cast<float*>(gsmem + a.off_red),
                                c, k0, k1, nf, e, D, Z, sx);
  const int n = c * CC + t;
  // a finished column: #4 applies the int8 scale and the bias
  auto finish = [&](float d, float z) {
    if constexpr (NORM)
      return (d - z) * sx + (a.bias != nullptr ? __ldg(a.bias + n) : 0.f);
    else
      return d - z;
  };
  if (a.splits == 1) {
    if (t < CC && n < a.Np) a.out[n] = finish(D, Z);
    return;
  }
  // the chunk's pieces: each writes its sums into rank 0's shared memory
  // and arrives there; rank 0 sums them in piece order (the zero-point
  // term subtracted once, after)
  float* dz = reinterpret_cast<float*>(gsmem + a.off_red) + 2 * GW * CC;
  cluster_wait();  // every block's mbarriers are initialized
  if (t >= GCT) return;
  if (piece > 0) {
    if (t < CC) {
      float* r0 = cooperative_groups::this_cluster().map_shared_rank(dz, 0);
      r0[2 * piece * CC + t] = D;
      r0[(2 * piece + 1) * CC + t] = Z;
    }
    gemv_bar();
    if (t == 0) mbar_arrive_rank0(pieces);
  } else if (t < CC) {
    mbar_wait_cluster(pieces, 0);
    for (int p = 1; p < a.splits; ++p) {
      D += dz[2 * p * CC + t];
      Z += dz[(2 * p + 1) * CC + t];
    }
    if (n < a.Np) a.out[n] = finish(D, Z);
  }
}

template <typename ST>
__global__ void __launch_bounds__(GTHREADS, 2)
    qgemv_kernel(const __grid_constant__ GemvArgs a) {
  gemv_block<ST, false, false, false>(a);
}

template <typename ST>
__global__ void __launch_bounds__(GTHREADS, 2)
    bcq_gemv_kernel(const __grid_constant__ GemvArgs a) {
  gemv_block<ST, true, false, false>(a);
}

template <typename ST>
__global__ void __launch_bounds__(GTHREADS, 2)
    qsel_gemv_kernel(const __grid_constant__ GemvArgs a) {
  gemv_block<ST, false, true, false>(a);
}

// #4: ST is the staged row's type (int8: a8, bf16: a16); x is f32
template <typename ST>
__global__ void __launch_bounds__(GTHREADS, 2)
    norm_qkv_gemv_kernel(const __grid_constant__ GemvArgs a) {
  gemv_block<ST, false, false, true>(a);
}

inline int galign16(int v) { return (v + 15) & ~15; }

// the shared-memory layout of a's cut (a.splits pieces): the offsets and
// the ring's depth, two blocks an SM where it fits; the bytes, or 0 where
// not even two stages fit
template <typename ST>
size_t gemv_layout(GemvArgs& a) {
  int kmax = 0;
  for (int p = 0; p < a.splits; ++p) {
    int k0, k1;
    gemv_piece(a.Kp, a.unit, a.splits, p, k0, k1);
    kmax = k1 - k0 > kmax ? k1 - k0 : kmax;
  }
  const int gmax = kmax / (a.Kp / a.ng) + 2;  // groups a piece touches
  const int red = 2 * GW * CC * 4 + 2 * GMAXS * CC * 4;
  const int rest = galign16(kmax * (int)sizeof(ST)) + galign16(kmax / 32 * 4) +
                   galign16(gmax * 4) + red + (2 * GMAXNS + 2) * 8;
  int ns = (GPAIR - rest) / STAGE_BYTES;
  if (ns < 2) ns = (GROOM - rest) / STAGE_BYTES;
  ns = ns > GMAXNS ? GMAXNS : ns;
  if (ns < 2) return 0;
  a.ns = ns;
  a.off_x = ns * STAGE_BYTES;
  a.off_runs = a.off_x + galign16(kmax * (int)sizeof(ST));
  a.off_xg = a.off_runs + galign16(kmax / 32 * 4);
  a.off_red = a.off_xg + galign16(gmax * 4);
  a.off_bar = a.off_red + red;
  return (size_t)a.off_bar + (2 * ns + 2) * 8;
}

void gemv_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                 const GemvArgs& a, size_t smem, cudaStream_t st) {
  cfg = {};
  cfg.gridDim = dim3((a.Np + CC - 1) / CC * a.splits);
  cfg.blockDim = dim3(GTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;  // the pieces of one chunk
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Launch the single-row kernel on a (a.x ... a.bits, a.unit filled in;
// a.splits the most pieces a chunk may take, ops/qmatmul.gemv_splits).
// The launch takes as many pieces, at most a.splits, as keep every
// chunk's cluster resident at once (cudaOccupancyMaxActiveClusters: a
// cluster's blocks share one GPC, so not every free block slot takes a
// large cluster), and sets the offsets and the ring's depth. Returns the
// launch's cudaError_t, or cudaErrorInvalidValue (launching nothing) for
// what the kernel does not take: groups that do not cover whole
// subblocks, an Np that is no multiple of 4, a cut that is not whole
// units, pointers off a 16-byte boundary, more than GMAXS pieces. SEL
// (#9, uniform only): a.eidx and a.E select the expert of a bank. NORM
// (#4, uniform only): a.x is the f32 row, a.nw (a.nb) its norm, a.bias
// the output's bias or null; ST the staged row's type.
template <typename ST, bool BCQ, bool SEL = false, bool NORM = false>
int gemv_launch(GemvArgs a, cudaStream_t st) {
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  if (NORM && (BCQ || SEL || a.nw == nullptr || !aligned(a.nw) ||
               a.norm < 0 || a.norm > 2 ||
               (a.norm == 2 && (a.nb == nullptr || !aligned(a.nb)))))
    return (int)cudaErrorInvalidValue;
  const int fbmin = BCQ || a.bits == 3 ? 1 : a.bits;
  if (a.Kp < 32 || a.SB < 32 || a.Kp % a.SB || a.ng < 1 || a.Kp % a.ng ||
      (a.Kp / a.ng) % a.SB || a.Np < 1 || a.Np % 4 || a.splits < 1 ||
      a.splits > GMAXS || a.unit % a.SB || a.unit % (GRW * 32 / fbmin) ||
      (a.Kp + a.unit - 1) / a.unit < a.splits || !aligned(a.x) ||
      !aligned(a.w0) || !aligned(a.grid) || a.out == nullptr ||
      (!BCQ && (a.zoff == nullptr || !aligned(a.zoff) ||
                (a.bits == 3) != (a.w1 != nullptr) ||
                (a.w1 != nullptr && !aligned(a.w1)))) ||
      (BCQ && (a.bits < 1 || a.bits > 8)) ||
      (SEL && (BCQ || a.eidx == nullptr || a.E < 1)))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const GemvArgs);
  if constexpr (BCQ)
    kern = bcq_gemv_kernel<ST>;
  else if constexpr (NORM)
    kern = norm_qkv_gemv_kernel<ST>;
  else if constexpr (SEL)
    kern = qsel_gemv_kernel<ST>;
  else
    kern = qgemv_kernel<ST>;
  cudaError_t err;
  // clusters of s blocks resident at once, by (s, one block an SM): the
  // kernel's registers and the card's alone decide it
  static int resident[GMAXS + 1][2] = {};
  if (resident[1][0] == 0) {
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GROOM)) !=
        cudaSuccess)
      return (int)err;
    for (int s = 1; s <= GMAXS; ++s)
      for (int one = 0; one < 2; ++one) {
        GemvArgs probe = a;
        probe.splits = s;
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        gemv_config(cfg, attr, probe, one ? GROOM : GPAIR, st);
        cfg.gridDim = dim3(s);
        int n = 0;
        if ((err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg)) !=
            cudaSuccess)
          return (int)err;
        resident[s][one] = n;
      }
  }
  const int chunks = (a.Np + CC - 1) / CC;
  size_t smem = 0;
  for (;; --a.splits) {
    smem = gemv_layout<ST>(a);
    if (a.splits == 1 ||
        (smem > 0 && resident[a.splits][smem > GPAIR] >= chunks))
      break;
  }
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  gemv_config(cfg, attr, a, smem, st);
  if ((err = cudaLaunchKernelEx(&cfg, kern, a)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
