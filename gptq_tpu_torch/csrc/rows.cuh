// Device code of the batched-decode kernels of #4 (norm_qkv_rows_kernel)
// and #5 / #6 (mlp_rows_kernel): 2 .. 32 activation rows on uniform packed
// weights, the product on the tensor cores. ffn_rows.cu launches them;
// ops/ffn.py's norm_qkv_route / mlp_route send rows 2 .. 32 here ("rows").
//
// Replaces, at those rows, the Pallas kernels of gptq_tpu/ops/ffn.py
// _norm_qkv_kernel, _attn_mlp_kernel and _ffn_kernel (the tiled
// norm_qkv_kernel / mlp_kernel of ffn.cu keep BCQ sign planes and the
// weights this file refuses). What they compute, with the JAX kernels'
// rounding points:
//   #4:  out   = norm(x) @ W (+ b)
//   #5:  r2    = bf16(xres + o(attn) + b_o)
//        inner = bf16(act(gate n) * up n), n = bf16(norm(r2))  (fc1: act)
//        out   = down(inner) + b_d + r2
//   #6:  #5 from gate|up on m, no norm and no residual.
// Each phase's input row is rounded to bf16 (a16) or quantized to int8
// with scale absmax / 127 (a8, round half to even).
//
// Bound on an H100: the packed weight bytes over the memory rate (at 32
// rows and 4 bits the products are a few percent of the tensor cores'
// time). The TPU kernels prepare each row once and stream each weight
// word once through the MXU over all rows; so does this design:
//   * rows prepared once a phase: block m (< M) takes row m, computes its
//     norm and int8 scale (wstream.cuh row_norm), writes the prepared row
//     (int8 codes, or bf16 in the B-fragment order below) and its group
//     sums to the caller's scratch, then a grid barrier (the generation
//     counter in the caller's sync words, never reset from the host, so a
//     CUDA graph replays it);
//   * each packed word is read from device memory once a launch: the plan
//     of the weight stream (ops/layer_fused.layer_plan, one block an SM,
//     128-column chunks of 32-word-row stages, cut in K where the work
//     asks for it) gives every block a near-equal share. A producer warp
//     keeps a ring of stages filled by TMA: the stage's words (four boxes
//     of 32 columns, 128-byte swizzle) at once, also ahead of a phase
//     barrier (weights never depend on an earlier phase), and the x
//     segments the stage's codes meet (128 K rows by the padded row count
//     each) once the phase's rows are prepared (a gate the consumers
//     open after the barrier);
//   * the product is mma.sync on the tensor cores with the weight as the
//     16-row A operand ("swap AB": out^T = W^T x^T, the activation rows
//     the 8-wide B tiles, N = M rounded up to 8): a8 m16n8k32 s8 x s8 ->
//     s32 (a code as itself; the 8-bit field's stored byte is code - 128),
//     a16 m16n8k16 bf16 -> f32 (a code c of an fb-bit field as the exact
//     bf16 mul (2^fb + c), a shift, a mask and one byte permute a pair;
//     8-bit codes by the 2^23 trick). A byteplane word (ops/pack.py) holds
//     four consecutive K rows of one column in its bytes, which is one A
//     register; B comes by ldmatrix from the swizzled x segment. mma.sync
//     was chosen over wgmma: at 8-32 rows the kernel is bound by the word
//     stream, and register fragments keep the per-field shifts, the
//     per-group fold and the word-to-column map simple;
//   * per group g the partial P of the MMA folds in f32, acc += P scale;
//     a chunk is finished as y = (sum - sum_g xsum (zoff + OFF scale)) sx
//     + b, where OFF is the codes' offset (a8: -128 for 8 bits, else 0;
//     a16: the bf16 codes' 2^fb terms, 0 for 8 bits): by its block where
//     one block streams it whole, else, after a grid barrier, by every
//     block a share of the columns, its pieces summed in piece order (a
//     chunk's last block finishing it alone held the phase up by one trip
//     to L2 a piece);
//   * row independence: the plan, the k-step order, the group folds and
//     the piece order are functions of the weights alone, and row m's
//     statistics are block m's, so row m's output is the same bits at any
//     M and in any slot;
//   * #5's phases (o, gate|up, down) are one launch: prepare, barrier,
//     product; then a barrier, the finish of the chunks cut in K and a
//     barrier before the next phase's preparation (after the last phase:
//     a barrier and the finish). gate|up rows are written out before the
//     activation; the down phase's preparation forms bf16(act(g) u).
// Weights taken: uniform 2, 3, 4 or 8 bits, Np a multiple of 128, Kp and
// groups multiples of 128 rows, subblocks of at least 128 rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused.cuh"    // WeightDesc, weight_ok, act_fn
#include "tma.cuh"
#include "wstream.cuh"  // CC, RR, STAGE_BYTES, bf16r, to_stage, row_norm

namespace {

constexpr int RCW = 8;               // consumer warps
constexpr int RCT = RCW * 32;        // consumer threads
constexpr int RTHREADS = RCT + 32;   // and the producer warp
constexpr int RMAX_STAGES = 8;
constexpr int RITEM = 8;             // ints of a plan item
constexpr int SEGK = 128;            // K rows of an x segment
constexpr int RSMEM = 232448;        // a block's shared memory
// a block's %globaltimer stamps: the start, then for each phase (at most
// three) its barrier before the preparation, the preparation's end, the
// barrier after it and the product's end
constexpr int RSTAMPS = 13;

// one launch (a __grid_constant__ parameter: the tensor maps must lie in
// parameter, constant or global memory). Weight w: 0 q|k|v (#4), 1 o,
// 2 gate|up, 3 down (#5 / #6), as layer_plan numbers them.
struct RowsArgs {
  CUtensorMap wmap[4][2];  // weight w, field f: 32 columns x RR word rows
  CUtensorMap xmap[4];     // phase w's prepared rows: 128 bytes x MP rows
  WeightDesc wd[4];        // bias: null or Np f32
  const int* items;        // the plan (layer_plan with glu off)
  const int* first;        // (blocks + 1) item offsets
  const float* x;          // #4: x; #5: attn; #6: m; (M, first Kp) f32
  const float* xres;       // #5: (M, o.Np) bf16 values
  const float* nw;         // the norm's weight (#4: ln1, #5: ln2), or null
  const float* nb;         // layernorm's bias, or null
  void* xq[4];             // phase w's prepared rows (M, Kp)
  float* sx[4];            // (M,) int8 scales (1: a16)
  float* xsum[4];          // (M, ng) the prepared rows' group sums
  float* r2;               // #5: (M, o.Np)
  float* gu;               // #5 / #6: (M, gate|up Np), before the activation
  float* out;              // (M, the last weight's Np)
  float* part;             // (pieces, M, CC) the pieces' sums
  const int* cuts;         // the chunks cut in K: (chunk, first piece slot,
                           // pieces), weight w's at cut_off[w] ..
  int cut_off[5];
  unsigned* sync;          // [0] barrier count, [1] generation
  long long* stamps;       // (blocks, RSTAMPS) %globaltimer, or null
  int M, MP, first_w, last_w, norm, act, glu;
  float eps;
  // shared memory: ring | union (a prepared row, or the pieces' partials
  // and the phase's int8 scales and group sums) | mbarriers
  int ns, slot_bytes, xseg, off_uni, off_bar;
};

__device__ __forceinline__ void rbar() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;" ::"n"(RCT) : "memory");
}

__device__ __forceinline__ unsigned r_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// every consumer thread of every block arrives; none leaves before all
// have, and the writes of every block before its arrival are visible then
// (layer_stream.cuh grid_bar: the count in sync[0], reset by the last
// arrival, which then releases generation `gen` in sync[1])
__device__ void rows_grid_bar(unsigned* sync, unsigned gen) {
  rbar();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(sync)
                 : "memory");
    if (old == gridDim.x - 1) {
      atomicExch(sync, 0u);
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(sync + 1),
                   "r"(gen)
                   : "memory");
    } else {
      while (r_ld_acquire(sync + 1) != gen) {
      }
    }
  }
  rbar();
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void rows_stamp(const RowsArgs& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * RSTAMPS + i] = t;
  }
}

// generic-proxy writes of global memory ordered before async-proxy (TMA)
// reads of it
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__host__ __device__ inline int rows_field_bits(int bits, int f) {
  return bits == 3 ? (f ? 1 : 2) : bits;
}

// A stage: word rows [r0, r0 + nr) of an fb-bit field (ops/pack.py: the
// word at row s Wsb + j of subblock s holds rows s SB + e quarter + 4 j +
// b in bits fb e of byte b). Its codes meet nseg x segments of SEGK K
// rows: where a subblock's field is at least a stage deep (Wsb >= RR),
// one segment a plane at kbase + t quarter; else the stage's whole
// subblocks, consecutive from kbase.
struct Geo {
  int lsb, lq, lw, r0, nseg, kbase, step;
  __device__ Geo(int SB, int fb, int r0_, int nr) {
    const int lfb = 31 - __clz(fb);
    lsb = 31 - __clz(SB);
    lw = lsb + lfb - 5;  // log2 Wsb
    lq = lsb + lfb - 3;  // log2 of a plane's rows in a subblock
    r0 = r0_;
    nseg = (nr << 5) >> (lfb + 7);
    if (lw >= 5) {  // Wsb >= RR
      kbase = ((r0 >> lw) << lsb) + 4 * (r0 & ((1 << lw) - 1));
      step = 1 << lq;
    } else {
      kbase = (r0 >> lw) << lsb;
      step = SEGK;
    }
  }
  __device__ __forceinline__ int kseg(int t) const { return kbase + t * step; }
  // the stage row and bit shift of the word whose bytes hold K rows
  // kq .. kq + 3
  __device__ __forceinline__ void loc(int kq, int fb, int& sr, int& sh) const {
    const int s = kq >> lsb, r = kq & ((1 << lsb) - 1);
    const int e = r >> lq, j = (r & ((1 << lq) - 1)) >> 2;
    sr = (s << lw) + j - r0;
    sh = fb * e;
  }
};

// the block's stages in order (the producer's two cursors: words, x)
struct Cursor {
  const int* items;
  int i, end, r;
  __device__ explicit Cursor(const RowsArgs& a)
      : items(a.items), i(a.first[blockIdx.x]), end(a.first[blockIdx.x + 1]) {
    r = i < end ? __ldg(items + (size_t)i * RITEM + 2) : 0;
  }
  __device__ __forceinline__ bool valid() const { return i < end; }
  __device__ __forceinline__ int at(int j) const {
    return __ldg(items + (size_t)i * RITEM + j);
  }
  __device__ __forceinline__ void next() {
    r += RR;
    if (r >= at(3) && ++i < end) r = at(2);
  }
};

// the x segments of the cursor's stage into its slot (the phase's rows
// are prepared: the caller waited on its gate)
template <bool A8>
__device__ void issue_x(const RowsArgs& a, unsigned char* ring,
                        uint64_t* xfull, const Cursor& c, int L) {
  const int w = c.at(0) & 3, f = (c.at(0) >> 2) & 1;
  const WeightDesc& wd = a.wd[w];
  const int fb = rows_field_bits(wd.bits, f);
  const int nr = min(RR, wd.Kp * fb / 32 - c.r);
  const Geo g(wd.SB, fb, c.r, nr);
  const int slot = L % a.ns;
  unsigned char* xs = ring + (size_t)slot * a.slot_bytes + STAGE_BYTES;
  mbar_expect(&xfull[slot], g.nseg * a.xseg);
  for (int t = 0; t < g.nseg; ++t) {
    tma2d(xs + t * a.xseg, &a.xmap[w], g.kseg(t), 0, &xfull[slot]);
    if (!A8)  // a bf16 segment is two boxes of 64 K rows
      tma2d(xs + t * a.xseg + a.xseg / 2, &a.xmap[w], g.kseg(t) + 64, 0,
            &xfull[slot]);
  }
}

// phase w's gate: open (its rows prepared; a generic-to-async proxy fence
// the first time it is seen open), waiting for it if `wait`
__device__ __forceinline__ bool gate_open(uint64_t* xgate, int w,
                                          unsigned& opened, bool wait) {
  if ((opened >> w) & 1) return true;
  if (wait)
    mbar_wait(&xgate[w], 0);
  else if (!mbar_test(&xgate[w], 0))
    return false;
  fence_async_global();
  opened |= 1u << w;
  return true;
}

// The producer warp (one thread): each stage's words as soon as its slot
// is free, and its x segments once its phase's gate is open, ahead of the
// words where they can be (a stage waits for both, and an x copy queued
// behind weight copies waits out their trip to device memory); a slot is
// reused only after the stage before in it was consumed, which needs that
// stage's x, so the x copies trail the word copies by at most the ring.
template <bool A8>
__device__ void rows_produce(const RowsArgs& a, unsigned char* ring,
                             uint64_t* wfull, uint64_t* xfull,
                             uint64_t* empty, uint64_t* xgate) {
  if ((threadIdx.x & 31) != 0) return;
  Cursor cw(a), cx(a);
  int L = 0, Lx = 0;  // stages whose words / x are issued
  unsigned opened = 0;
  auto x_until = [&](int last, bool wait) {  // x of stages Lx .. last
    while (Lx <= last && gate_open(xgate, cx.at(0) & 3, opened, wait)) {
      issue_x<A8>(a, ring, xfull, cx, Lx++);
      cx.next();
    }
  };
  while (cw.valid()) {
    const int slot = L % a.ns;
    if (L >= a.ns) {
      x_until(L - a.ns, true);  // the slot's last stage needs its x
      x_until(L - 1, false);
      mbar_wait(&empty[slot], ((L / a.ns) - 1) & 1);
    }
    x_until(L, false);
    const int w = cw.at(0) & 3, f = (cw.at(0) >> 2) & 1;
    unsigned char* st = ring + (size_t)slot * a.slot_bytes;
    mbar_expect(&wfull[slot], STAGE_BYTES);
#pragma unroll
    for (int q = 0; q < CC / 32; ++q)
      tma2d(st + q * (STAGE_BYTES / 4), &a.wmap[w][f], cw.at(1) * CC + 32 * q,
            cw.r, &wfull[slot]);
    cw.next();
    ++L;
  }
  x_until(L - 1, true);
}

// ---------------------------------------------------------------------------
// a phase's rows, prepared once
// ---------------------------------------------------------------------------

// row_norm's row (wstream.cuh), kept f32 in shared memory: mode 0 the
// source as it is, 1 bf16(act(g) * u) of a gate|up row, 2 bf16(act(y))
struct PrepRow {
  float4* u4;
  const float4* src;
  const float4* up;
  int mode, act, NV;
  template <int U>
  __device__ __forceinline__ void load(int v0, int step, float4 (&v)[U]) {
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vi = v0 + step * u;
      v[u] = vi < NV ? __ldcg(src + vi) : z4;
      if (mode != 0 && vi < NV) {
        const float4 m =
            mode == 1 ? __ldcg(up + vi) : make_float4(1.f, 1.f, 1.f, 1.f);
        v[u].x = bf16r(act_fn(act, v[u].x) * m.x);
        v[u].y = bf16r(act_fn(act, v[u].y) * m.y);
        v[u].z = bf16r(act_fn(act, v[u].z) * m.z);
        v[u].w = bf16r(act_fn(act, v[u].w) * m.w);
      }
      if (vi < NV) u4[vi] = v[u];
    }
  }
  __device__ __forceinline__ void passed() {}
  __device__ __forceinline__ float4 get(int vi) const { return u4[vi]; }
  __device__ __forceinline__ void put(int vi, float4 x) { u4[vi] = x; }
};

__device__ __forceinline__ uint32_t pack_s8(float4 v, float sx) {
  const int8_t* z = nullptr;
  return (uint32_t)(uint8_t)to_stage(v.x, sx, (int8_t*)z) |
         (uint32_t)(uint8_t)to_stage(v.y, sx, (int8_t*)z) << 8 |
         (uint32_t)(uint8_t)to_stage(v.z, sx, (int8_t*)z) << 16 |
         (uint32_t)(uint8_t)to_stage(v.w, sx, (int8_t*)z) << 24;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}
__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// Row m of phase w, by one block's consumers: the source row (x, attn, r2
// or m, or the gate|up row through the activation), its norm and int8
// scale (row_norm), then the prepared row and the sum of each unit of 16
// K rows (a thread a unit, in K order), then each group's sum of its
// units (a warp a group). a16 rows are stored with each 16 K rows in the order
// 0 1 4 5 8 9 12 13 2 3 6 7 10 11 14 15, so that ldmatrix gives the B
// fragment of a k16 step whose A register t holds the bytes of word t.
template <typename ST>
__device__ void prep_row(const RowsArgs& a, int w, int m,
                         unsigned char* uni) {
  constexpr bool A8 = sizeof(ST) == 1;
  const WeightDesc& wd = a.wd[w];
  const int K = wd.Kp, NV = K / 4, t = threadIdx.x;
  float4* u4 = reinterpret_cast<float4*>(uni);
  float* runs = reinterpret_cast<float*>(uni) + K;
  float* red = runs + K / 16;
  const float* src;
  const float* up = nullptr;
  const float* nw = nullptr;
  int mode = 0;
  if (w == 3) {  // the gate|up row through the activation
    src = a.gu + (size_t)m * a.wd[2].Np;
    if (a.glu) {
      up = src + K;
      mode = 1;
    } else {
      mode = 2;
    }
  } else if (w == 2 && a.first_w == 1) {  // ln2 over r2
    src = a.r2 + (size_t)m * K;
    nw = a.nw;
  } else {  // x (#4: ln1), attn (#5) or m (#6)
    src = a.x + (size_t)m * K;
    nw = w == 0 ? a.nw : nullptr;
  }
  PrepRow row{u4, reinterpret_cast<const float4*>(src),
              reinterpret_cast<const float4*>(up), mode, a.act, NV};
  float mu, rstd;
  const float sx =
      row_norm<RCT, 4, A8>(row, NV, nw, a.nb, a.norm, a.eps, red, mu, rstd);
  rbar();  // a run holds other threads' vectors (a16 ends with no barrier)
  unsigned char* dst =
      reinterpret_cast<unsigned char*>(a.xq[w]) + (size_t)m * K * sizeof(ST);
  for (int u = t; u < K / 16; u += RCT) {  // a unit: 16 K rows, 4 vectors
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = u4[4 * u + j];
    float s = 0.f;
    if constexpr (A8) {
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = pack_s8(v[j], sx);
        s += (float)__dp4a((int)q[j], 0x01010101, 0);  // exact
      }
      *reinterpret_cast<uint4*>(dst + 16 * u) =
          make_uint4(q[0], q[1], q[2], q[3]);
    } else {
      uint32_t p[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = pack_bf16(v[j].x, v[j].y);
        p[4 + j] = pack_bf16(v[j].z, v[j].w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s += lo_f(p[j]) + hi_f(p[j]) + lo_f(p[4 + j]) + hi_f(p[4 + j]);
      uint4* d = reinterpret_cast<uint4*>(dst + 32 * u);
      d[0] = make_uint4(p[0], p[1], p[2], p[3]);
      d[1] = make_uint4(p[4], p[5], p[6], p[7]);
    }
    runs[u] = s;
  }
  rbar();
  const int upg = K / wd.ng / 16;  // units a group
  for (int gi = t >> 5; gi < wd.ng; gi += RCW) {
    float v = 0.f;
    for (int c = t & 31; c < upg; c += 32) v += runs[gi * upg + c];
    v = warp_sum(v);
    if ((t & 31) == 0) a.xsum[w][(size_t)m * wd.ng + gi] = v;
  }
  if (t == 0) a.sx[w][m] = sx;
  fence_async_global();  // the TMA of other blocks reads the rows
}

// ---------------------------------------------------------------------------
// the tensor-core product of a stage
// ---------------------------------------------------------------------------

template <typename ST>
struct RPart { using type = float; };
template <>
struct RPart<int8_t> { using type = int; };

__device__ __forceinline__ void mma_rows(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_rows(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldm_x2(uint32_t& r0, uint32_t& r1,
                                       uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// a8: a word's codes at shift sh, at bit ms of each byte (a 3-bit weight's
// 1-bit field: 4 c), as s8; the 8-bit field's stored byte (code - 128)
template <int FB>
__device__ __forceinline__ uint32_t codes_s8(uint32_t w, int sh, int ms) {
  if constexpr (FB == 8) {
    return w;
  } else {
    constexpr uint32_t M = ((1u << FB) - 1u) * 0x01010101u;
    return ((w >> sh) & M) << ms;
  }
}

// a16: a word's four codes at shift sh as the bf16 numbers 2^ms (2^FB + c)
// (FB < 8: the code under the exponent 127 + FB + ms), or c (FB = 8);
// lo: bytes 0 and 1, hi: bytes 2 and 3
template <int FB>
__device__ __forceinline__ void codes_bf16(uint32_t w, int sh, int ms,
                                           uint32_t& lo, uint32_t& hi) {
  if constexpr (FB == 8) {
    const uint32_t u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(0x4B000000u | ((u >> (8 * b)) & 0xFFu)) -
             8388608.f;
    lo = pack_bf16(f[0], f[1]);
    hi = pack_bf16(f[2], f[3]);
  } else {
    constexpr uint32_t M = ((1u << FB) - 1u) * 0x01010101u;
    const int E = 127 + FB + ms;
    const uint32_t LO = (uint32_t)((E & 1) << 7) * 0x01010101u;
    const uint32_t HI = (uint32_t)(E >> 1) * 0x01010101u;
    const uint32_t v = (((w >> sh) & M) << (7 - FB)) | LO;
    lo = __byte_perm(v, HI, 0x4140);
    hi = __byte_perm(v, HI, 0x4342);
  }
}

// A warp's place in a 128-column stage: subtile q (32 columns, one box),
// k-steps of parity kp; A row g of its 16-row tile mt is the box column
// cw(g) + 8 mt, row g + 8 the column after it. This map puts the 16 lanes
// of an 8-byte shared load (A rows g, g + 8 of four word rows) on distinct
// banks under the 128-byte swizzle.
struct Lane {
  int g, tig, q, kp, cwb, lane;
  __device__ Lane() {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    g = lane >> 2;
    tig = lane & 3;
    q = warp & 3;
    kp = warp >> 2;
    cwb = 2 * (g & 1) + 16 * ((g >> 1) & 1) + 4 * (g >> 2);
  }
};

// a group's scales of this lane's columns cw(g) and cw(g) + 1 of each
// tile, loaded when the group starts and used when it is folded
__device__ __forceinline__ void group_scale(const WeightDesc& wd, int c, int g,
                                            const Lane& ln, float2 (&sc)[2]) {
  const float* sp =
      wd.scale + (size_t)g * wd.Np + c * CC + 32 * ln.q + ln.cwb;
  sc[0] = __ldg(reinterpret_cast<const float2*>(sp));
  sc[1] = __ldg(reinterpret_cast<const float2*>(sp + 8));
}

// the group partials into the f32 sums, acc += P scale[g], then P = 0
template <typename PT>
__device__ __forceinline__ void fold(const float2 (&sc)[2], int ntl,
                                     PT (&part)[2][4][4],
                                     float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= ntl) continue;
      acc[mt][nt][0] += (float)part[mt][nt][0] * sc[mt].x;
      acc[mt][nt][1] += (float)part[mt][nt][1] * sc[mt].x;
      acc[mt][nt][2] += (float)part[mt][nt][2] * sc[mt].y;
      acc[mt][nt][3] += (float)part[mt][nt][3] * sc[mt].y;
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0;
    }
  }
}

// The stage's k-steps of this warp's parity over its 32 columns, a
// segment at a time (SEGK K rows: one group, since groups are whole
// segments), two k-steps (32 K rows a8, 16 a16) at a time: first their A
// words and B fragments from shared memory, then per k-step the A
// registers from the words of its quads (Geo::loc) and one MMA per
// 16-column tile and 8-row tile. ms: log2 of the field's multiplier (a
// 3-bit weight's 1-bit field: 2). G: the group's K rows, or 0 for one
// group.
template <typename ST, int FB>
__device__ __forceinline__ void stage_mma(
    const RowsArgs& a, const WeightDesc& wd, int ms, const Geo& geo,
    const unsigned char* wst, const unsigned char* xst, int c, int ntl,
    int G, const Lane& ln, typename RPart<ST>::type (&part)[2][4][4],
    float (&acc)[2][4][4], int& gcur, float2 (&sc)[2]) {
  constexpr bool A8 = sizeof(ST) == 1;
  constexpr int KS = A8 ? 32 : 16, KPS = SEGK / KS;
  // a lane's k-steps of a segment, those loaded at once, its quads
  constexpr int NI = KPS / 2, NB = 2, NQ = A8 ? 2 : 1;
  const unsigned char* wq = wst + ln.q * (STAGE_BYTES / 4);
  const int xr = ln.lane & 7, hk = (ln.lane >> 3) & 1;
  const int box = a.MP * 128;  // bytes of an x box
  for (int t = 0; t < geo.nseg; ++t) {
    const int ks = geo.kseg(t);
    const int gi = G == 0 ? 0 : ks / G;
    if (gi != gcur) {
      if (gcur >= 0) fold(sc, ntl, part, acc);
      gcur = gi;
      group_scale(wd, c, gi, ln, sc);
    }
    const uint32_t xs = smem_u32(xst + t * a.xseg);
#pragma unroll
    for (int i0 = 0; i0 < NI; i0 += NB) {
      uint2 wv[NB][NQ][2];
      int sh[NB][NQ];
      uint32_t bf[NB][4][2];
#pragma unroll
      for (int ii = 0; ii < NB; ++ii) {
        const int i = ln.kp + 2 * (i0 + ii);
        const int kk = ks + KS * i;
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          int sr;
          geo.loc(kk + 16 * qq + 4 * ln.tig, FB, sr, sh[ii][qq]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int cw = ln.cwb + 8 * mt;
            wv[ii][qq][mt] = lds64(wq + sr * 128 +
                                   ((((cw >> 2) ^ (sr & 7)) << 4) |
                                    ((cw & 3) << 2)));
          }
        }
        const int bx = A8 ? 0 : i >> 2, ch = A8 ? 2 * i : 2 * (i & 3);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntl) continue;
          const int row = nt * 8 + xr;
          ldm_x2(bf[ii][nt][0], bf[ii][nt][1],
                 xs + bx * box + row * 128 + (((ch + hk) ^ (row & 7)) << 4));
        }
      }
#pragma unroll
      for (int ii = 0; ii < NB; ++ii) {
        uint32_t A[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (A8) {
            A[mt][0] = codes_s8<FB>(wv[ii][0][mt].x, sh[ii][0], ms);
            A[mt][1] = codes_s8<FB>(wv[ii][0][mt].y, sh[ii][0], ms);
            const int q1 = 1 % NQ;  // the k-step's second quad
            A[mt][2] = codes_s8<FB>(wv[ii][q1][mt].x, sh[ii][q1], ms);
            A[mt][3] = codes_s8<FB>(wv[ii][q1][mt].y, sh[ii][q1], ms);
          } else {
            codes_bf16<FB>(wv[ii][0][mt].x, sh[ii][0], ms, A[mt][0],
                           A[mt][2]);
            codes_bf16<FB>(wv[ii][0][mt].y, sh[ii][0], ms, A[mt][1],
                           A[mt][3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntl) continue;
          mma_rows(part[0][nt], A[0], bf[ii][nt][0], bf[ii][nt][1]);
          mma_rows(part[1][nt], A[1], bf[ii][nt][0], bf[ii][nt][1]);
        }
      }
    }
  }
}

// A thread finishes one column of a chunk (col = t % CC) for the rows
// half, half + 2, ... (half = t / CC): RROWS of them at most.
constexpr int RROWS = 32 / (RCT / CC);

// The finish of column n of weight w for the R rows m0, m0 + step, ...:
// first its loads (the zero-point term through the rows' group sums, the
// bias, each row's residual), which do not need the column's sums, then
// (store) the value with the int8 scale and the phase's epilogue. ssx /
// sxs: the phase's int8 scales (M) and group sums (M, ng), staged in
// shared memory.
template <int R>
struct ColFinish {
  float z[R], rv[R], b;
};

template <bool A8, int R>
__device__ __forceinline__ void col_loads(const RowsArgs& a, int w, int n,
                                          int m0, int step, const float* sxs,
                                          ColFinish<R>& cf) {
  const WeightDesc& wd = a.wd[w];
  const float OFF = A8 ? (wd.bits == 8 ? -128.f : 0.f)
                       : (wd.bits == 8   ? 0.f
                          : wd.bits == 3 ? 12.f
                                         : (float)(1 << wd.bits));
  const int M = a.M, ng = wd.ng;
#pragma unroll
  for (int r = 0; r < R; ++r) cf.z[r] = 0.f;
#pragma unroll 4
  for (int g = 0; g < ng; ++g) {
    const float sc = __ldg(wd.scale + (size_t)g * wd.Np + n);
    const float ze = __ldg(wd.zoff + (size_t)g * wd.Np + n) + OFF * sc;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + step * r;
      if (m < M) cf.z[r] += sxs[m * ng + g] * ze;
    }
  }
  cf.b = wd.bias != nullptr ? __ldg(wd.bias + n) : 0.f;
  // the residual of every row before any store: a load after a store to
  // a buffer that may alias it would wait for the store
  const float* res = w == 1 ? a.xres : w == 3 && a.first_w == 1 ? a.r2
                                                                 : nullptr;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + step * r;
    cf.rv[r] = res != nullptr && m < M
                   ? __ldcg(res + (size_t)m * wd.Np + n)
                   : 0.f;
  }
}

template <int R>
__device__ __forceinline__ void col_store(const RowsArgs& a, int w, int n,
                                          int m0, int step,
                                          const float (&v)[R],
                                          const float* ssx,
                                          const ColFinish<R>& cf) {
  const WeightDesc& wd = a.wd[w];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + step * r;
    if (m >= a.M) continue;
    float y = (v[r] - cf.z[r]) * ssx[m];
    if (wd.bias != nullptr) y += cf.b;
    const size_t o = (size_t)m * wd.Np + n;
    if (w == 0)
      a.out[o] = y;
    else if (w == 1)
      a.r2[o] = bf16r(cf.rv[r] + y);
    else if (w == 2)
      a.gu[o] = y;
    else
      a.out[o] = a.first_w == 1 ? y + cf.rv[r] : y;
  }
}

// The chunks of weight w cut in K, finished by every block after a grid
// barrier (their pieces are in `part`): a thread takes one column of a
// chunk for four rows, with the column's loads and four pieces' loads in
// flight at once, and sums the pieces in piece order.
template <bool A8>
__device__ void finish_cuts(const RowsArgs& a, int w, const float* ssx,
                            const float* sxs) {
  const int ne = a.cut_off[w + 1] - a.cut_off[w];
  const int M = a.M, groups = (M + 3) / 4;
  for (int idx = blockIdx.x * RCT + threadIdx.x; idx < ne * groups * CC;
       idx += gridDim.x * RCT) {
    const int e = idx / (groups * CC), rem = idx - e * groups * CC;
    const int m0 = 4 * (rem / CC), col = rem % CC;
    const int* ce = a.cuts + 3 * (a.cut_off[w] + e);
    const int n = __ldg(ce) * CC + col, first = __ldg(ce + 1);
    const int np = __ldg(ce + 2);
    ColFinish<4> cf;
    col_loads<A8, 4>(a, w, n, m0, 1, sxs, cf);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < np; j0 += 4) {
      float pv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pv[jj][r] = j0 + jj < np && m0 + r < M
                          ? __ldcg(a.part +
                                   ((size_t)(first + j0 + jj) * M + m0 + r) *
                                       CC +
                                   col)
                          : 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j0 + jj < np)
#pragma unroll
          for (int r = 0; r < 4; ++r) v[r] += pv[jj][r];
    }
    col_store<4>(a, w, n, m0, 1, v, ssx, cf);
  }
}

// The block's items of weight w from the ring (stage counter k carried
// over the phases). A piece's two warp partials of a column are summed in
// warp order; a chunk of one piece is finished at once, the pieces of a
// chunk cut in K are written out for finish_cuts. stats: the phase's int8
// scales (MP) and group sums (M, ng) in shared memory.
template <typename ST>
__device__ void rows_consume(const RowsArgs& a, int w, int& item, int& k,
                             unsigned char* ring, uint64_t* wfull,
                             uint64_t* xfull, uint64_t* empty,
                             unsigned char* uni, const float* stats) {
  constexpr bool A8 = sizeof(ST) == 1;
  using PT = typename RPart<ST>::type;
  const WeightDesc& wd = a.wd[w];
  const int t = threadIdx.x, M = a.M, ntl = a.MP / 8;
  const int col = t % CC, half = t / CC;
  const int G = wd.ng == 1 ? 0 : wd.Kp / wd.ng;
  const Lane ln;
  float* red = reinterpret_cast<float*>(uni);
  const float* ssx = stats;
  const float* sxs = stats + a.MP;
  float acc[2][4][4];
  PT part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e] = 0;
  const int end = a.first[blockIdx.x + 1];
  for (; item < end; ++item) {
    const int* it = a.items + (size_t)item * RITEM;
    const int head = __ldg(it);
    if ((head & 3) != w) break;
    const int f = (head >> 2) & 1, c = __ldg(it + 1);
    const int r0 = __ldg(it + 2), r1 = __ldg(it + 3);
    if (head & 8) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const int fb = rows_field_bits(wd.bits, f);
    const int ms = wd.bits == 3 && f ? 2 : 0;
    int gcur = -1;
    float2 sc[2];
    for (int r = r0; r < r1; r += RR, ++k) {
      const int slot = k % a.ns;
      mbar_wait(&wfull[slot], (k / a.ns) & 1);
      mbar_wait(&xfull[slot], (k / a.ns) & 1);
      const unsigned char* st = ring + (size_t)slot * a.slot_bytes;
      const Geo geo(wd.SB, fb, r, min(RR, r1 - r));
      switch (fb) {
        case 1:
          stage_mma<ST, 1>(a, wd, ms, geo, st, st + STAGE_BYTES, c, ntl, G,
                           ln, part, acc, gcur, sc);
          break;
        case 2:
          stage_mma<ST, 2>(a, wd, ms, geo, st, st + STAGE_BYTES, c, ntl, G,
                           ln, part, acc, gcur, sc);
          break;
        case 4:
          stage_mma<ST, 4>(a, wd, ms, geo, st, st + STAGE_BYTES, c, ntl, G,
                           ln, part, acc, gcur, sc);
          break;
        default:
          stage_mma<ST, 8>(a, wd, ms, geo, st, st + STAGE_BYTES, c, ntl, G,
                           ln, part, acc, gcur, sc);
          break;
      }
      __syncwarp();
      if (ln.lane == 0) mbar_arrive(&empty[slot]);
    }
    if (gcur >= 0) fold(sc, ntl, part, acc);
    if (!(head & 16)) continue;  // the piece goes on in the next item
    // the piece: both warps' partials of each column, in warp order
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = nt * 8 + 2 * ln.tig + (e & 1);
          if (nt < ntl && m < M)
            red[(ln.kp * a.MP + m) * CC + 32 * ln.q + ln.cwb + 8 * mt +
                (e >> 1)] = acc[mt][nt][e];
        }
    rbar();
    const int npieces = head >> 8;
    float v[RROWS];
#pragma unroll
    for (int r = 0; r < RROWS; ++r) {
      const int m = half + 2 * r;
      v[r] = m < M ? red[m * CC + col] + red[(a.MP + m) * CC + col] : 0.f;
    }
    if (npieces == 1) {
      ColFinish<RROWS> cf;
      col_loads<A8, RROWS>(a, w, c * CC + col, half, 2, sxs, cf);
      col_store<RROWS>(a, w, c * CC + col, half, 2, v, ssx, cf);
    } else {  // finish_cuts sums the pieces
      float* pp = a.part + (size_t)__ldg(it + 4) * M * CC + col;
#pragma unroll
      for (int r = 0; r < RROWS; ++r) {
        const int m = half + 2 * r;
        if (m < M) __stcg(pp + (size_t)m * CC, v[r]);
      }
    }
    rbar();  // red is read
  }
}

// One launch: the phases of weights first_w .. last_w, each its rows'
// preparation (blocks 0 .. M - 1), a grid barrier, its gate opened, its
// product; after each a grid barrier and, where the plan cuts chunks of
// its weight in K, their finish and one more barrier.
template <typename ST>
__device__ __forceinline__ void rows_body(const RowsArgs& a) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  unsigned char* sm =
      rows_smem + ((1024 - (smem_u32(rows_smem) & 1023)) & 1023);
  unsigned char* ring = sm;
  unsigned char* uni = sm + a.off_uni;
  float* stats = reinterpret_cast<float*>(uni + 2 * a.MP * CC * 4);
  uint64_t* wfull = reinterpret_cast<uint64_t*>(sm + a.off_bar);
  uint64_t* xfull = wfull + a.ns;
  uint64_t* empty = xfull + a.ns;
  uint64_t* xgate = empty + a.ns;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.ns; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&xfull[i], 1);
      mbar_init(&empty[i], RCW);
    }
    for (int w = 0; w < 4; ++w) mbar_init(&xgate[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= RCT) {
    rows_produce<sizeof(ST) == 1>(a, ring, wfull, xfull, empty, xgate);
    return;
  }
  unsigned gen = 0;
  if (threadIdx.x == 0) gen = r_ld_acquire(a.sync + 1);
  int item = a.first[blockIdx.x], k = 0;
  rows_stamp(a, 0);
  constexpr bool A8 = sizeof(ST) == 1;
  for (int w = a.first_w; w <= a.last_w; ++w) {
    const int s0 = 1 + 4 * (w - a.first_w);
    if (w > a.first_w) {  // phase w - 1's pieces written, then finished
      rows_grid_bar(a.sync, ++gen);
      if (a.cut_off[w] > a.cut_off[w - 1]) {
        finish_cuts<A8>(a, w - 1, stats, stats + a.MP);
        rows_grid_bar(a.sync, ++gen);
      }
    }
    rows_stamp(a, s0);
    if ((int)blockIdx.x < a.M) prep_row<ST>(a, w, blockIdx.x, uni);
    rows_stamp(a, s0 + 1);
    rows_grid_bar(a.sync, ++gen);  // the rows are prepared
    rows_stamp(a, s0 + 2);
    if (threadIdx.x == 0) mbar_arrive(&xgate[w]);
    // the phase's int8 scales and group sums, once a block
    const int ng = a.wd[w].ng;
    for (int i = threadIdx.x; i < a.M * (ng + 1); i += RCT)
      stats[i < a.M ? i : a.MP + i - a.M] =
          __ldcg(i < a.M ? a.sx[w] + i : a.xsum[w] + i - a.M);
    rbar();
    rows_consume<ST>(a, w, item, k, ring, wfull, xfull, empty, uni, stats);
    rows_stamp(a, s0 + 3);
  }
  if (a.cut_off[a.last_w + 1] > a.cut_off[a.last_w]) {
    rows_grid_bar(a.sync, ++gen);
    finish_cuts<A8>(a, a.last_w, stats, stats + a.MP);
  }
}

template <typename ST>
__global__ void __launch_bounds__(RTHREADS, 1)
    norm_qkv_rows_kernel(const __grid_constant__ RowsArgs a) {
  rows_body<ST>(a);
}

template <typename ST>
__global__ void __launch_bounds__(RTHREADS, 1)
    mlp_rows_kernel(const __grid_constant__ RowsArgs a) {
  rows_body<ST>(a);
}

}  // namespace
