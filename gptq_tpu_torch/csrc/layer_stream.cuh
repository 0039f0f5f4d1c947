// Device code of the weight-stream kernels: the whole-layer kernel
// (layer_fused.cu, #12) and, at one row, the MLP half of a block (ffn.cu's
// mlp_stream_kernel, #5 / #6), whose phases are a subset of #12's. The
// weight stream is kept apart from the phases' arithmetic. layer_fused.cu's
// header comment gives the design; this file holds its parts:
//   * the static plan's items (ops/layer_fused.layer_plan) and the
//     producer warp that streams their stages through a ring of shared-
//     memory stages with TMA, gated at the phase boundaries;
//   * the consumer warps' barrier over the grid (a named bar.sync, then one
//     thread's release / acquire on a generation counter in device memory,
//     never reset from the host, so that a CUDA graph replays it);
//   * a phase's input row staged once per block (the norm and the int8
//     scale through wstream.cuh's row_norm, which #4's single-row kernel
//     shares; the int8 or bf16 row, the group sums of the zero-point term);
//   * the stage product over byteplane codes (wstream.cuh's rows, four
//     columns a lane) and the K-split pieces summed in piece order by a
//     chunk's last block (a ticket), which applies the phase's epilogue;
//   * the weight phases after attention (o + residual, norm + gate|up +
//     act, down + residual), which both kernels run from the plan's first
//     weight: q|k|v (#12), o (#5) or gate|up (#6);
//   * the attention phase: per-warp online states over slot tiles staged by
//     cp.async, the splits merged in split order by a kv head's last split;
//   * the host side both launchers share: the weight check, the
//     shared-memory layout and the co-resident grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_rows.cuh"  // cp_async16, warp_max, row_dot
#include "fused.cuh"  // WeightDesc, weight_ok, bf16r, act_fn, to_stage
#include "tma.cuh"
#include "wstream.cuh"  // CC, RR, STAGE_BYTES, RowMap, rows_dot

namespace {

constexpr int NCW = 16;                   // consumer warps
constexpr int CTHREADS = 32 * NCW;        // consumer threads
constexpr int LTHREADS = CTHREADS + 32;   // and the producer warp
constexpr int RW = RR / NCW;              // a consumer warp's rows a stage
constexpr int MAX_STAGES = 8;
constexpr int ITEM = 8;                   // ints of a plan item
constexpr int NSTAMP = 10;
constexpr int MAXP = 32;                  // cut chunks' pieces a block a phase
constexpr int PLE = 6;                    // ints of a piece list entry
constexpr int LMAXG = 8;                  // query heads a kv head

// one launch's arguments (a __grid_constant__ kernel parameter: the tensor
// maps must lie in parameter, constant or global memory)
struct LArgs {
  CUtensorMap maps[8];  // weight w, field f: maps[2 * w + f]
  WeightDesc wd[4];     // q|k|v, o, gate|up, down (bias: null, or Np f32)
  const int* items;     // the plan (layer_plan)
  const int* first;     // (grid + 1) item offsets
  const float* x;       // (hidden,) f32 block input (#5: xres)
  const float* ln1;
  const float* ln2;     // the norm over r2, or null (#6: none)
  const float* ln2b;    // its bias (norm 2, layernorm), else null
  const float* cs;  // (hd,) rope tables of this position
  const float* sn;
  const int* len;   // (1,) slots already cached
  void* kc;         // (S, Hkv, hd) this layer's cache, bf16 or f32
  void* vc;
  float* qkvo;   // (qkv.Np) the q|k|v row (before rope)
  float* pml;    // (Hkv nsplit G, 2) the splits' (m, l)
  float* pacc;   // (Hkv nsplit G, hd) the splits' unnormalised outputs
  float* attn;   // (H hd) the attention row (block 0 writes it; #5: input)
  float* r2;     // (hidden) bf16(x + o(attn)) (#6: the input row)
  float* gu;     // (gate|up Np) the gate|up row (before act)
  float* inner;  // (F) bf16(act(gate) * up) (block 0 writes it)
  float* out;    // (hidden) y
  float* part;   // (pieces, CC) the pieces' partial sums
  unsigned* sync;  // [0] barrier count, [1] generation, [2 ..] tickets
  long long* stamps;  // (grid, NSTAMP) %globaltimer, or null
  int S, H, Hkv, hd, nsplit, norm, act, ns, max_items;
  int first_w;  // the plan's first weight: 0 (#12), 1 (o: #5), 2 (gate|up: #6)
  int glu;      // act(gate) * up; else act(fc1) (gate|up is fc1 alone)
  float eps, sm_scale;
  // dynamic shared memory: ring | union (f32 row / attention) | staged row
  // | warp partials | group sums | the block's items | mbarriers
  int off_uni, off_xs, off_red, off_xg, off_it, off_bar;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cbar() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;" ::"n"(CTHREADS) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// every consumer thread of every block arrives; none leaves before all
// have arrived, and then the writes of every block before its arrival are
// visible (the release of the arrival is cumulative over the block's
// bar.sync). gen is the generation the barrier opens: thread 0 read the
// counter at the kernel's start (no block can pass a barrier before every
// block has arrived, so all read the same value) and adds one a barrier.
__device__ void grid_bar(const LArgs& a, unsigned gen) {
  cbar();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(a.sync)
                 : "memory");
    if (old == gridDim.x - 1) {
      atomicExch(a.sync, 0u);  // before the release below
      st_release(a.sync + 1, gen);
    } else {
      while (ld_acquire(a.sync + 1) != gen) {
      }
    }
  }
  cbar();
}

__device__ __forceinline__ void stamp(const LArgs& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * NSTAMP + i] = t;
  }
}

// gate|up chunks c and c + F / CC are finished together (the GLU output
// written once, by the chunk pair's last block) where CC divides F
__device__ __forceinline__ bool paired(const LArgs& a) {
  return a.glu && (a.wd[2].Np / 2) % CC == 0;
}

// field f of a weight: its bit width and its shift in the code
__device__ __forceinline__ int field_bits(int bits, int f) {
  return bits == 3 ? (f ? 1 : 2) : bits;
}

// ---------------------------------------------------------------------------
// the producer warp: the block's items' stages, in order, into the ring
// ---------------------------------------------------------------------------

// The producer holds before each phase after the plan's first (gates[w]): o's
// weights wait until the block's consumers have o's input row, so the
// attention and the boundary's trips (tickets, barrier, staging loads) run
// on a quiet memory system, where a ring already refilling would queue
// each trip behind this SM's stream; gate|up's and down's go on as soon
// as the consumers have read the phase before's last stage (measured on
// an H100: the best of the two rules for each boundary). A phase starts
// with one stage alone (its first data comes back in one trip, not behind
// every SM's whole ring) and goes on ns deep.
__device__ void produce(const LArgs& a, unsigned char* ring, uint64_t* full,
                        uint64_t* empty, uint64_t* gates) {
  if ((threadIdx.x & 31) != 0) return;
  int k = 0, lastw = -1;  // stages issued, the phase of the last
  for (int i = a.first[blockIdx.x]; i < a.first[blockIdx.x + 1]; ++i) {
    const int* it = a.items + (size_t)i * ITEM;
    const int w = it[0] & 3, f = (it[0] >> 2) & 1;
    bool ramp = false;
    if (w != lastw) {
      if (w > a.first_w) mbar_wait(&gates[w], 0);
      lastw = w;
      ramp = true;
    }
    const CUtensorMap* m = &a.maps[2 * w + f];
    // a box of RR word rows, or of the whole field where it is shorter
    const int rows = a.wd[w].Kp * field_bits(a.wd[w].bits, f) / 32;
    const int bytes = (rows < RR ? rows : RR) * CC * 4;
    for (int r = it[2]; r < it[3]; r += RR, ++k) {
      const int slot = k % a.ns;
      if (k >= a.ns) mbar_wait(&empty[slot], ((k / a.ns) - 1) & 1);
      mbar_expect(&full[slot], bytes);
      tma2d(ring + (size_t)slot * STAGE_BYTES, m, it[1] * CC, r, &full[slot]);
      if (ramp) {  // the phase's first stage alone
        mbar_wait(&full[slot], (k / a.ns) & 1);
        ramp = false;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// a phase's input row, staged once per block
// ---------------------------------------------------------------------------

template <typename ST>
struct Stage {  // the consumer side of one block's shared memory
  float* uni;   // union: the f32 input row, or the attention phase's tiles
  ST* xs;       // the staged row (int8 codes or bf16)
  float* red;   // (NCW, CC) warp partials; [0 .. NCW) block reductions
  float* xg;    // group sums of the staged row
  uint64_t* gates;  // the producer's, one a phase
  float sx;     // the row's int8 scale (1: a16)
};

// #12's input row: read once (pass 1, the finished rows of an earlier
// phase: x, the attention row, r2, and the GLU output, or without a
// gate|up pairing the gate|up row) and kept, f32, in shared memory (u4),
// where pass 2 leaves its norm; block 0 writes the GLU output it forms
struct KeptRow {
  float4* u4;
  const float4* src;
  const float4* g4;  // the up half of the gate|up row, or null (no GLU here)
  float4* inner;     // block 0's GLU output, or null
  uint64_t* gate;    // the producer's gate to open after pass 1, or null
  int act, NV;
  template <int U>
  __device__ __forceinline__ void load(int v0, int step, float4 (&v)[U]) {
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 g2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vi = v0 + step * u;
      v[u] = vi < NV ? __ldcg(src + vi) : z4;
      g2[u] = g4 != nullptr && vi < NV ? __ldcg(g4 + vi) : z4;
    }
    if (g4 != nullptr) {  // the GLU output, rounded to bf16
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u].x = bf16r(act_fn(act, v[u].x) * g2[u].x);
        v[u].y = bf16r(act_fn(act, v[u].y) * g2[u].y);
        v[u].z = bf16r(act_fn(act, v[u].z) * g2[u].z);
        v[u].w = bf16r(act_fn(act, v[u].w) * g2[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vi = v0 + step * u;
      if (vi < NV) {
        u4[vi] = v[u];
        if (inner != nullptr) inner[vi] = v[u];
      }
    }
  }
  __device__ __forceinline__ void passed() {
    if (gate != nullptr && threadIdx.x == 0) mbar_arrive(gate);
  }
  __device__ __forceinline__ float4 get(int vi) const { return u4[vi]; }
  __device__ __forceinline__ void put(int vi, float4 x) { u4[vi] = x; }
};

template <typename ST>
__device__ void stage_row(const LArgs& a, int w, Stage<ST>& s) {
  constexpr bool A8 = sizeof(ST) == 1;
  const WeightDesc& wd = a.wd[w];
  const int K = wd.Kp, NV = K / 4, t = threadIdx.x;
  const int F = a.wd[3].Kp;
  const float* nw = w == 0 ? a.ln1 : w == 2 ? a.ln2 : nullptr;
  float4* u4 = reinterpret_cast<float4*>(s.uni);
  // the row's norm and int8 scale (wstream.cuh row_norm; a thread takes
  // vectors t, t + CTHREADS, ... here and in pass 3). Every block stages
  // the same bits in the same order: a chunk's last block finishes it with
  // its own row statistics.
  const bool glu_here = w == 3 && a.glu && !paired(a);
  const float* src = w == 0 ? a.x : w == 1 ? a.attn : w == 2 ? a.r2
                   : glu_here ? a.gu : a.inner;
  KeptRow row{u4, reinterpret_cast<const float4*>(src),
              glu_here ? reinterpret_cast<const float4*>(a.gu + F) : nullptr,
              glu_here && blockIdx.x == 0 ? reinterpret_cast<float4*>(a.inner)
                                          : nullptr,
              w == 1 ? &s.gates[1] : nullptr,  // o's weights may go on
              a.act, NV};
  float mu, rstd;
  s.sx = row_norm<CTHREADS, 4, A8>(row, NV, nw, a.ln2b, a.norm, a.eps, s.red,
                                   mu, rstd);
  // pass 3: the staged row, then the sum of each run of 32 (a thread a
  // run: a group is whole runs), then the group sums from the runs'
  for (int vi = t; vi < NV; vi += CTHREADS)
    store_staged(s.xs, vi, u4[vi], s.sx);
  cbar();
  for (int ci = t; ci < K / 32; ci += CTHREADS) {
    const int4* v = reinterpret_cast<const int4*>(s.xs + ci * 32);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * (int)sizeof(ST); ++j) {
      const int4 q = v[j];
      const unsigned u[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                             (unsigned)q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (A8)  // four int8 codes at once, exact
          sum += (float)__dp4a((int)u[e], 0x01010101, 0);
        else
          sum += __uint_as_float(u[e] << 16) +
                 __uint_as_float(u[e] & 0xffff0000u);
      }
    }
    s.red[ci] = sum;
  }
  cbar();
  const int cpg = K / wd.ng / 32;  // 32s a group
  for (int g = t >> 5; g < wd.ng; g += NCW) {
    float v = 0.f;
    for (int c = t & 31; c < cpg; c += 32) v += s.red[g * cpg + c];
    v = warp_sum(v);
    if ((t & 31) == 0) s.xg[g] = v;
  }
  cbar();
}

// ---------------------------------------------------------------------------
// the stage product: a lane's four columns over a stage's word rows
// ---------------------------------------------------------------------------

// field f of a weight: its width, its row map (wstream.cuh) and its grid
struct Field : RowMap {
  int fb, gw, ng, Np;  // gw: word rows a group
  float mul;           // 2^shift of the field
  const float* scale;
  __device__ Field(const WeightDesc& wd, int f)
      : RowMap(wd.SB, field_bits(wd.bits, f)) {
    fb = field_bits(wd.bits, f);
    ng = wd.ng;
    gw = wd.Kp / wd.ng * fb / 32;
    Np = wd.Np;
    mul = wd.bits == 3 && f ? 4.f : 1.f;
    scale = wd.scale;
  }
};

// a warp's rows of a stage: word rows [r, r + nr) (nr <= RW, one group)
// of a field into a lane's four columns n0 .. n0 + 3, scaled by the group's
template <typename ST, int FB>
__device__ __forceinline__ void warp_rows(const int4* rows, int r, int nr,
                                          const ST* xs, const Field& fd,
                                          int n0, float (&acc)[4]) {
  using AT = typename Acc<ST>::type;
  AT dot[4] = {0, 0, 0, 0};
  rows_dot<FB, RW>(rows, r, nr, xs, fd, dot);
  const int g = fd.ng == 1 ? 0 : r / fd.gw;
  const float4 sc = __ldg(
      reinterpret_cast<const float4*>(fd.scale + (size_t)g * fd.Np + n0));
  acc[0] += (float)dot[0] * sc.x * fd.mul;
  acc[1] += (float)dot[1] * sc.y * fd.mul;
  acc[2] += (float)dot[2] * sc.z * fd.mul;
  acc[3] += (float)dot[3] * sc.w * fd.mul;
}

// column n of a weight is complete (v: its sum over K, in staged units):
// its value, after the zero points, the int8 scale and the bias
template <typename ST>
__device__ __forceinline__ float finished(const WeightDesc& wd, int n, float v,
                                          const Stage<ST>& s) {
  float z = 0.f;
  for (int g = 0; g < wd.ng; ++g)
    z += __ldg(wd.zoff + (size_t)g * wd.Np + n) * s.xg[g];
  const float y = (v - z) * s.sx;
  return wd.bias != nullptr ? y + __ldg(wd.bias + n) : y;
}

// a gate|up chunk pair (gate column n, up column n + F) is complete: the
// GLU output
template <typename ST>
__device__ __forceinline__ void finish_glu(const LArgs& a, int n, float vg,
                                           float vu, const Stage<ST>& s) {
  const WeightDesc& wd = a.wd[2];
  a.inner[n] = bf16r(act_fn(a.act, finished(wd, n, vg, s)) *
                     finished(wd, n + wd.Np / 2, vu, s));
}

// ... and the phase's epilogue
template <typename ST>
__device__ __forceinline__ void finish(const LArgs& a, int w, int n, float v,
                                       const Stage<ST>& s) {
  const float y = finished(a.wd[w], n, v, s);
  if (w == 0) {
    a.qkvo[n] = y;
  } else if (w == 1) {
    a.r2[n] = bf16r(__ldg(a.x + n) + y);
  } else if (w == 2) {
    if (a.glu)
      a.gu[n] = y;
    else  // fc1: its activation is the down phase's input
      a.inner[n] = bf16r(act_fn(a.act, y));
  } else {
    a.out[n] = a.first_w <= 1 ? y + __ldcg(a.r2 + n) : y;  // #6: no residual
  }
}

// the block's items of weight w from the ring (stage counter k carried
// over the phases), each piece summed over the warps. A chunk of one
// piece is finished at once; the pieces of a chunk cut in K are written
// out, and at the phase's end the block takes a ticket for each (all at
// once) and, for the chunks it ends last, sums their pieces in piece order
// and finishes them; a gate|up pair's last block writes the GLU output.
// pl: MAXP pieces' (first slot, pieces, ticket, the up chunk's first slot
// and pieces, chunk), then MAXP flags.
template <typename ST>
__device__ void consume(const LArgs& a, int w, int& item, int& k,
                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                        const Stage<ST>& s, int* pl, const int* items) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int npl = 0;  // pieces of cut chunks so far
  const int end = a.first[blockIdx.x + 1] - a.first[blockIdx.x];
  for (; item < end; ++item) {
    const int* it = items + item * ITEM;  // the block's items, in smem
    const int head = it[0];
    if ((head & 3) != w) break;
    const int f = (head >> 2) & 1, c = it[1];
    if (head & 8) acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
    const Field fd(a.wd[w], f);
    const int n0 = c * CC + 4 * lane;
    for (int r = it[2]; r < it[3]; r += RR, ++k) {
      const int slot = k % a.ns;
      mbar_wait(&full[slot], (k / a.ns) & 1);
      // this warp's RW rows of the stage (one group: groups are whole runs
      // of RW word rows)
      const int4* rows = reinterpret_cast<const int4*>(
                             ring + (size_t)slot * STAGE_BYTES) +
                         RW * warp * (CC / 4);
      const int gr0 = r + RW * warp, nr = min(RW, it[3] - gr0);
      if (nr > 0) {
        switch (fd.fb) {
          case 1: warp_rows<ST, 1>(rows, gr0, nr, s.xs, fd, n0, acc); break;
          case 2: warp_rows<ST, 2>(rows, gr0, nr, s.xs, fd, n0, acc); break;
          case 4: warp_rows<ST, 4>(rows, gr0, nr, s.xs, fd, n0, acc); break;
          default: warp_rows<ST, 8>(rows, gr0, nr, s.xs, fd, n0, acc); break;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    if (!(head & 16)) continue;  // the piece goes on in the next item
    // the piece: the warps' partials summed in warp order
    *reinterpret_cast<float4*>(s.red + warp * CC + 4 * lane) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    cbar();
    float v = 0.f;
    if (t < CC)
      for (int j = 0; j < NCW; ++j) v += s.red[j * CC + t];
    const int npieces = head >> 8;  // the chunk's (pair: the gate's)
    const int npair = head & 32 ? it[7] >> 20 : 0;  // the up chunk's
    if (npieces + npair == 1) {
      if (t < CC) finish<ST>(a, w, c * CC + t, v, s);
    } else {
      if (t < CC) __stcg(a.part + (size_t)it[4] * CC + t, v);
      if (t == 0) {
        int* e = pl + PLE * npl;
        e[0] = it[5], e[1] = npieces, e[2] = it[6], e[3] = it[7] & 0xFFFFF;
        e[4] = npair, e[5] = head & 32 ? c % (a.wd[2].Np / 2 / CC) : c;
      }
      ++npl;
    }
    cbar();  // red is read
  }
  // past o the next weights need not wait for the boundary's work
  if ((w == 1 || w == 2) && t == 0) mbar_arrive(&s.gates[w + 1]);
  if (npl == 0) return;
  int* last = pl + PLE * MAXP;
  if (t < npl) {  // a ticket a piece: its release (cumulative over the bar
    // above) publishes the block's partials, its acquire the others'
    const int* e = pl + PLE * t;
    unsigned* tk = a.sync + 2 + a.Hkv + e[2];
    unsigned got;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(got)
                 : "l"(tk)
                 : "memory");
    last[t] = got == (unsigned)(e[1] + e[4]) - 1;
    if (last[t]) *tk = 0;  // for the next launch
  }
  cbar();
  for (int q = t; q < npl * CC; q += CTHREADS) {
    const int p = q / CC, col = q - p * CC;
    if (!last[p]) continue;
    const int* e = pl + PLE * p;
    float sum = 0.f, up = 0.f;  // in piece order
    for (int j = 0; j < e[1]; ++j)
      sum += __ldcg(a.part + (size_t)(e[0] + j) * CC + col);
    for (int j = 0; j < e[4]; ++j)
      up += __ldcg(a.part + (size_t)(e[3] + j) * CC + col);
    if (e[4] > 0)
      finish_glu<ST>(a, e[5] * CC + col, sum, up, s);
    else
      finish<ST>(a, w, e[5] * CC + col, sum, s);
  }
}

// ---------------------------------------------------------------------------
// a block's start and the weight phases after attention
// ---------------------------------------------------------------------------

struct Ring {  // a block's mbarriers and consume's piece list
  uint64_t* full;
  uint64_t* empty;
  uint64_t* gates;  // the producer's, one a phase
  int* pl;
};

// the block's mbarriers initialised; the producer warp streams the block's
// items and returns false; the consumers copy the block's items into
// shared memory (read after the first staging's barriers) and return true
template <typename ST>
__device__ bool block_start(const LArgs& a, unsigned char* smem, Ring& r,
                            Stage<ST>& s, int*& items) {
  r.full = reinterpret_cast<uint64_t*>(smem + a.off_bar);
  r.empty = r.full + a.ns;
  r.gates = r.empty + a.ns;
  r.pl = reinterpret_cast<int*>(r.gates + 4);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.ns; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], NCW);
    }
    for (int w = 0; w < 4; ++w) mbar_init(&r.gates[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CTHREADS) {  // the producer warp
    produce(a, smem, r.full, r.empty, r.gates);
    return false;
  }
  s = Stage<ST>{reinterpret_cast<float*>(smem + a.off_uni),
                reinterpret_cast<ST*>(smem + a.off_xs),
                reinterpret_cast<float*>(smem + a.off_red),
                reinterpret_cast<float*>(smem + a.off_xg), r.gates, 1.f};
  items = reinterpret_cast<int*>(smem + a.off_it);
  const int i0 = a.first[blockIdx.x] * ITEM;
  const int n = a.first[blockIdx.x + 1] * ITEM - i0;
  for (int i = threadIdx.x; i < n; i += CTHREADS) items[i] = a.items[i0 + i];
  return true;
}

// the weight phases w0 .. 3 of the block's items (1: o + residual, 2: the
// norm over r2 + gate|up + act, 3: down + residual), a grid barrier before
// each but the plan's first; each stages its input row once, then takes
// its stages from the ring (k: the stage counter, carried over the phases)
template <typename ST>
__device__ void weight_phases(const LArgs& a, int w0, unsigned gen, int& item,
                              int& k, unsigned char* ring, const Ring& r,
                              Stage<ST>& s, const int* items) {
  for (int w = w0; w < 4; ++w) {
    if (w > a.first_w) {
      stamp(a, 2 * w + 1);
      grid_bar(a, ++gen);
      stamp(a, 2 * w + 2);
    }
    stage_row<ST>(a, w, s);
    consume<ST>(a, w, item, k, ring, r.full, r.empty, s, r.pl, items);
  }
  stamp(a, 9);
}

// #5 / #6 at one row: the weight phases from the plan's first weight (o,
// or gate|up without it); one persistent block an SM, all resident
template <typename ST>
__global__ void __launch_bounds__(LTHREADS, 1)
    mlp_stream_kernel(const __grid_constant__ LArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring r;
  Stage<ST> s;
  int* items;
  if (!block_start<ST>(a, smem, r, s, items)) return;
  int item = 0, k = 0;
  const unsigned gen = threadIdx.x == 0 ? ld_acquire(a.sync + 1) : 0;
  weight_phases<ST>(a, a.first_w, gen, item, k, smem, r, s, items);
}

// ---------------------------------------------------------------------------
// the attention phase
// ---------------------------------------------------------------------------

template <typename CT>
__device__ __forceinline__ CT to_cache(float v);
template <>
__device__ __forceinline__ float to_cache<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_cache<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element d of the roped head at offset off of the q|k|v row: the products
// rounded one at a time, as PyTorch computes x * cos + rotate_half(x) * sin
__device__ __forceinline__ float rope_at(const LArgs& a, int off, int d) {
  const int half = a.hd >> 1;
  const float* r = a.qkvo + off;
  const float xd = __ldcg(r + d);
  if (d < half)
    return __fsub_rn(__fmul_rn(xd, a.cs[d]), __fmul_rn(__ldcg(r + d + half), a.sn[d]));
  return __fadd_rn(__fmul_rn(xd, a.cs[d]), __fmul_rn(__ldcg(r + d - half), a.sn[d]));
}

// the attention tiles of a cache type and head dim: NT slots a tile whose
// K and V rows (padded by 16 bytes: 8 lanes on 8 rows hit 8 bank groups)
// fit 40 KB with two tiles in flight
template <typename CT, int HD>
struct ATile {
  static constexpr int RS = HD * (int)sizeof(CT) + 16;
  static constexpr int FIT = 40 * 1024 / (4 * RS);
  static constexpr int NT = FIT >= 32 ? 32 : FIT >= 16 ? 16 : 8;
  static constexpr int VR = HD * (int)sizeof(CT) / 16;  // vectors a row
  // shared memory: two tiles | q (G heads) | the warps' states | p | the
  // warps' (m, l), the fresh scores | the fresh k and v as the cache holds
  // them
  static constexpr int BYTES = 4 * NT * RS + 4 * LMAXG * HD +
                               4 * NCW * HD + 4 * NCW * NT + 4 * 3 * NCW +
                               4 * LMAXG + 8 * HD;
};

// the (kv head, split) items of this block: split j of kv head h takes the
// filled slots [j per, (j + 1) per); per-warp online states (warp w: head
// w % gp, the (w / gp)-th run of each tile's slots), merged in warp order
// into the split's (m, l, acc); split 0 also writes the fresh rows at slot
// len (no block reads that slot) and folds the fresh column into its state
// this block's item (kv head h, split) of the attention phase: split j of
// kv head h takes the filled slots [j per, (j + 1) per); Hkv nsplit items
// over at least as many blocks
struct AItem {
  int h, split, c0, n;
  __device__ AItem(const LArgs& a, int len) {
    h = blockIdx.x / a.nsplit;
    split = blockIdx.x - h * a.nsplit;
    const int per = (len + a.nsplit - 1) / a.nsplit;
    c0 = split * per;
    n = blockIdx.x < a.Hkv * a.nsplit ? max(0, min(len, c0 + per) - c0) : 0;
  }
};

// tile u of the block's item: its K and V rows by cp.async (one group,
// empty past the last tile) into buffer u & 1
template <typename CT, int HD>
__device__ __forceinline__ void attn_issue(const LArgs& a, unsigned char* uni,
                                           const AItem& im, int u) {
  using T = ATile<CT, HD>;
  constexpr int RS = T::RS, NT = T::NT, VR = T::VR;
  const size_t rs = (size_t)a.Hkv * HD;  // elements between two slots
  const CT* kb = (const CT*)a.kc + (size_t)im.c0 * rs + (size_t)im.h * HD;
  const CT* vb = (const CT*)a.vc + (size_t)im.c0 * rs + (size_t)im.h * HD;
  unsigned char* st = uni + (u & 1) * 2 * NT * RS;
  for (int i = threadIdx.x; u * NT < im.n && i < 2 * NT * VR; i += CTHREADS) {
    const int kv = i / (NT * VR), r = (i / VR) % NT, v = i % VR;
    const int slot = u * NT + r;
    if (slot < im.n)
      cp_async16(st + (kv * NT + r) * RS + v * 16,
                 reinterpret_cast<const unsigned char*>(
                     (kv ? vb : kb) + (size_t)slot * rs) + v * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// tiles 0 and 1 of the block's item, issued before the barrier ahead of
// the attention phase (the cache slots below len do not depend on it)
template <typename CT>
__device__ void attn_prefetch(const LArgs& a, unsigned char* uni,
                              int len_raw) {
  const AItem im(a, min(max(len_raw, 0), a.S));
  for (int u = 0; u < 2; ++u) {
    if (a.hd == 64)
      attn_issue<CT, 64>(a, uni, im, u);
    else if (a.hd == 128)
      attn_issue<CT, 128>(a, uni, im, u);
    else
      attn_issue<CT, 256>(a, uni, im, u);
  }
}

// the block's item: per-warp online states (warp w: head w % gp, the
// (w / gp)-th run of each tile's slots), merged in warp order into the
// split's (m, l, acc); split 0 also writes the fresh rows at slot len (no
// block reads that slot) and folds the fresh column into its state. Tiles
// 0 and 1 were issued before the barrier that precedes this phase.
template <typename CT, int HD>
__device__ __noinline__ void attn_phase(const LArgs& a, unsigned char* uni,
                                        int len_raw) {
  using T = ATile<CT, HD>;
  constexpr int RS = T::RS, NT = T::NT, VR = T::VR, ND = HD / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = a.H / a.Hkv;
  const int gp = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  const int nsub = NCW / gp, g = warp % gp, sub = warp / gp;
  const bool live = g < G;
  float* s_q = reinterpret_cast<float*>(uni + 4 * NT * RS);
  float* s_wacc = s_q + LMAXG * HD;
  float* s_p = s_wacc + NCW * HD;
  float* s_wm = s_p + NCW * NT;
  float* s_wl = s_wm + NCW;
  float* s_sf = s_wl + NCW;
  float* s_kf = s_sf + LMAXG;  // the fresh k, v rounded to the cache dtype
  float* s_vf = s_kf + HD;
  const AItem im(a, min(max(len_raw, 0), a.S));
  const int koff = a.H * HD, voff = koff + a.Hkv * HD;
  if (blockIdx.x < a.Hkv * a.nsplit) {
    const int h = im.h, split = im.split, n = im.n;
    const int ntile = (n + NT - 1) / NT;
    for (int i = t; i < G * HD; i += CTHREADS)
      s_q[i] = __fmul_rn(rope_at(a, (h * G + i / HD) * HD, i % HD), a.sm_scale);
    for (int d = t; d < HD; d += CTHREADS) {
      s_kf[d] = to_f(to_cache<CT>(rope_at(a, koff + h * HD, d)));
      s_vf[d] = to_f(to_cache<CT>(__ldcg(a.qkvo + voff + h * HD + d)));
    }
    cbar();  // s_q, s_kf, s_vf
    if (split == 0 && len_raw >= 0 && len_raw < a.S) {  // the fresh rows
      CT* kw = (CT*)a.kc + ((size_t)len_raw * a.Hkv + h) * HD;
      CT* vw = (CT*)a.vc + ((size_t)len_raw * a.Hkv + h) * HD;
      for (int d = t; d < HD; d += CTHREADS) {
        kw[d] = to_cache<CT>(s_kf[d]);
        vw[d] = to_cache<CT>(s_vf[d]);
      }
    }
    if (split == 0 && warp < G) {  // the fresh column's score
      float d0 = 0.f;
      for (int d = lane; d < HD; d += 32) d0 += s_q[warp * HD + d] * s_kf[d];
      d0 = warp_sum(d0);
      if (lane == 0) s_sf[warp] = d0;
    }
    float m_run = -INFINITY, l_run = 0.f, acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    for (int u = 0; u < ntile; ++u) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      cbar();  // tile u landed for every thread
      const unsigned char* st = uni + (u & 1) * 2 * NT * RS;
      const int nt = min(NT, n - u * NT);
      const int run = (nt + nsub - 1) / nsub, r0 = sub * run;
      const int mine = max(0, min(run, nt - r0));
      if (live && mine > 0) {
        int lps = 1;  // lanes a slot (its vectors split over them)
        while (lps < 32 && mine * lps * 2 <= 32 && lps * 2 <= VR) lps <<= 1;
        const int kk = lane / lps, part = lane % lps;
        float sc = -INFINITY;
        {
          float d0 = kk < mine ? row_dot<CT>(s_q + g * HD, st + (r0 + kk) * RS,
                                             HD, part, lps)
                               : 0.f;
          for (int o = 1; o < lps; o <<= 1) d0 += __shfl_xor_sync(FULL, d0, o);
          if (kk < mine) sc = d0;
        }
        const float m_new = fmaxf(m_run, warp_max(sc));
        const float alpha = __expf(m_run - m_new);  // 0 while m = -inf
        const float p = kk < mine ? __expf(sc - m_new) : 0.f;
        if (part == 0 && kk < mine) s_p[warp * NT + kk] = p;
        l_run = l_run * alpha + warp_sum(part == 0 ? p : 0.f);
        m_run = m_new;
        __syncwarp();
        float av[ND];
#pragma unroll
        for (int i = 0; i < ND; ++i) av[i] = 0.f;
        const unsigned char* vrow = st + NT * RS + r0 * RS + lane * ND * sizeof(CT);
        for (int j = 0; j < mine; ++j) {
          const float pj = s_p[warp * NT + j];
          const CT* vv = reinterpret_cast<const CT*>(vrow + j * RS);
#pragma unroll
          for (int i = 0; i < ND; ++i) av[i] += pj * to_f(vv[i]);
        }
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] = acc[i] * alpha + av[i];
        __syncwarp();
      }
      cbar();  // tile u is read before tile u + 2 overwrites it
      attn_issue<CT, HD>(a, uni, im, u + 2);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // the warps' states merge (run order) into the split's
    if (lane == 0) {
      s_wm[warp] = live ? m_run : -INFINITY;
      s_wl[warp] = l_run;
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) s_wacc[warp * HD + lane * ND + i] = acc[i];
    cbar();
    for (int it = t; it < G * HD; it += CTHREADS) {
      const int hg = it / HD, d = it - hg * HD;
      float M = -INFINITY;
      for (int j = 0; j < nsub; ++j) M = fmaxf(M, s_wm[j * gp + hg]);
      if (split == 0) M = fmaxf(M, s_sf[hg]);
      float l = 0.f, v = 0.f;
      for (int j = 0; j < nsub; ++j) {
        const float mj = s_wm[j * gp + hg];
        const float e = mj == -INFINITY ? 0.f : __expf(mj - M);
        l += s_wl[j * gp + hg] * e;
        v += s_wacc[(j * gp + hg) * HD + d] * e;
      }
      if (split == 0) {  // the fresh column, as the cache holds it
        const float e = __expf(s_sf[hg] - M);
        l += e;
        v += e * s_vf[d];
      }
      const size_t o = (size_t)blockIdx.x * G + hg;
      a.pacc[o * HD + d] = v;
      if (d == 0) {
        a.pml[2 * o] = M;
        a.pml[2 * o + 1] = l;
      }
    }
    // the kv head's last split merges the splits' states, in split order,
    // into the attention row of its G query heads (a ticket, reset by it)
    int* last = reinterpret_cast<int*>(s_p);
    cbar();
    if (t == 0) {
      unsigned* tk = a.sync + 2 + h;
      unsigned got;
      asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                   : "=r"(got)
                   : "l"(tk)
                   : "memory");
      *last = got == (unsigned)a.nsplit - 1;
      if (*last) *tk = 0;  // for the next launch
    }
    cbar();
    if (*last) {
      for (int it = t; it < G * HD; it += CTHREADS) {
        const int hg = it / HD, d = it - hg * HD;
        float M = -INFINITY, l = 0.f, v = 0.f;
        for (int j = 0; j < a.nsplit; ++j) {
          const size_t o = ((size_t)h * a.nsplit + j) * G + hg;
          const float mj = __ldcg(a.pml + 2 * o);
          const float lj = __ldcg(a.pml + 2 * o + 1);
          const float vj = __ldcg(a.pacc + o * HD + d);
          if (mj == -INFINITY) continue;  // an empty split weighs nothing
          const float Mn = fmaxf(M, mj);
          const float e0 = M == -INFINITY ? 0.f : __expf(M - Mn);
          const float e1 = __expf(mj - Mn);
          l = l * e0 + lj * e1;
          v = v * e0 + vj * e1;
          M = Mn;
        }
        a.attn[((size_t)h * G + hg) * HD + d] = v / l;  // l > 0: split 0
      }  // holds the fresh column
    }
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side, shared by layer_fused.cu and ffn.cu
// ---------------------------------------------------------------------------

constexpr int SMEM_LIMIT = 232448;  // a block's shared memory

inline int align16(int v) { return (v + 15) & ~15; }
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// a weight the stream takes: uniform, Np a multiple of CC, its grids on
// 16-byte boundaries (read as float4), groups of whole runs of a consumer
// warp's RW word rows in every field
inline bool stream_weight_ok(const WeightDesc* w) {
  if (!weight_ok(w) || w->fmt != 0 || w->Np % CC || !aligned16(w->scale) ||
      !aligned16(w->zoff))
    return false;
  const int fbmin = w->bits == 3 ? 1 : w->bits;
  return w->ng == 1 || (w->Kp / w->ng) * fbmin / 32 % RW == 0;
}

// the shared-memory layout of a launch whose union (the f32 input row, or
// #12's attention tiles) takes `uni` bytes: the offsets and the ring's
// depth; the bytes, or 0 where it does not fit
template <typename ST>
size_t stream_layout(LArgs& a, int uni) {
  int kmax = 0, ngmax = 1;
  for (const WeightDesc& w : a.wd) {
    kmax = w.Kp > kmax ? w.Kp : kmax;
    ngmax = w.ng > ngmax ? w.ng : ngmax;
  }
  if (kmax / 32 > NCW * CC) return 0;  // the staged row's 32s' sums
  uni = align16(kmax * 4 > uni ? kmax * 4 : uni);
  a.off_uni = 0;  // after the ring, below
  a.off_xs = uni;
  a.off_red = a.off_xs + align16(kmax * (int)sizeof(ST));
  a.off_xg = a.off_red + NCW * CC * 4;
  a.off_it = a.off_xg + align16(ngmax * 4);
  a.off_bar = a.off_it + align16(a.max_items * ITEM * 4);
  const int tail = 32 + (PLE + 1) * MAXP * 4;  // the gates, the piece list
  const int rest = a.off_bar + 2 * MAX_STAGES * 8 + tail;
  int ns = (SMEM_LIMIT - rest) / STAGE_BYTES;
  ns = ns > MAX_STAGES ? MAX_STAGES : ns;
  if (ns < 2) return 0;
  a.ns = ns;
  const int ring = ns * STAGE_BYTES;
  a.off_uni += ring;
  a.off_xs += ring;
  a.off_red += ring;
  a.off_xg += ring;
  a.off_it += ring;
  a.off_bar += ring;
  return (size_t)a.off_bar + 2 * ns * 8 + tail;
}

// a launch of `kern` on `blocks` blocks, all resident at once (the
// cooperative attribute: the consumers' grid barrier waits for every
// block), in the form a stream capture records; per_sm: the kernel's
// resident blocks, found once (the kernel and the card decide it)
inline int stream_launch(void (*kern)(const LArgs), const LArgs& a, int blocks,
                         size_t smem, int& per_sm, cudaStream_t st) {
  cudaError_t err;
  if (per_sm < 0) {
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             SMEM_LIMIT)) != cudaSuccess)
      return (int)err;
    int dev = 0, sms = 0, n = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kern, LTHREADS, SMEM_LIMIT)) != cudaSuccess)
      return (int)err;
    per_sm = n * sms;  // blocks resident at the largest plan
  }
  if (blocks > per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(LTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kern, a)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
