// The whole llama decoder layer at decode time (B = T = 1) in one
// cooperative launch.
//
// Replaces gptq_tpu/ops/layer_fused.py:_layer_kernel (decode_layer_fused),
// with that kernel's rounding points:
//   h1     = bf16(norm1(x))                 x: the f32 block input
//   q|k|v  = h1 @ dequant(Wqkv)             f32
//   q, k   = rope(q), rope(k)               f32, rotate-half; q *= sm_scale
//   kf, vf = k, v rounded to the cache dtype, written at slot len
//   attn   = softmax(q . k_t for t < len, q . kf) @ (v_t, vf)
//   r2     = bf16(x + attn @ dequant(Wo))
//   inner  = bf16(act(gate(n)) * up(n)),    n = bf16(norm2(r2))
//   y      = down(inner) + r2
// where every matmul quantizes its whole input row to int8 (a8: absmax /
// 127, round half to even) or rounds it to bf16 (a16).
//
// Bound on an H100: the packed weight bytes (~103 MB per llama-7B layer at
// 4 bits, groupsize -1) plus the len cache slots read, over the memory
// rate: 0.031 ms at 128 filled slots.
//
// Design: the weights do not depend on the activations, so only the
// arithmetic waits for a phase's input; the weight stream is its own warp
// (layer_stream.cuh holds the device code):
//   * one persistent block an SM (cooperative launch: all resident), 16
//     consumer warps and a producer warp. A static plan (ops/layer_fused.
//     layer_plan, a host function of the weights' shapes and the SM count)
//     gives every block a near-equal share of every weight's packed words:
//     runs of 16 KB stages (128 columns x 32 word rows of one field), so
//     the narrow weights (o, down) are cut in K as well as in columns.
//   * the producer warp keeps a ring of up to 8 stages (128 KB) full with
//     TMA (a tensor map of each field's (word rows, Np) plane, encoded on
//     the host by layer_maps, which the wrapper keeps for each weight); the
//     consumers release a stage as they read it. It holds o's stages
//     until the block has o's input row (the attention and the boundary's
//     trips then meet a quiet memory system) and lets gate|up's and down's
//     run on through their boundaries; a phase starts with one stage
//     alone, then goes on 8 deep.
//   * the consumers meet on a barrier of their own between phases (named
//     bar.sync, then a release / acquire on a generation counter that is
//     never reset from the host); the grid barrier of cooperative groups
//     would need the producer, which runs ahead.
//   * each phase: the consumers stage the input row once per block (its
//     norm, int8 scale or bf16 rounding, group sums; every block computes
//     the same bits), then take the stages from the ring: a lane dots four
//     columns' words with the staged row (qdot.cuh's byteplane algebra:
//     dp4a for a8), the group scale applied per warp and stage; a run's
//     partials are summed over the warps, and the partials of a chunk cut
//     in K are summed in piece order by the block that ends the chunk last
//     (a ticket it resets), so that two launches give the same bits. That
//     block applies the zero points, the int8 scale and the phase's
//     epilogue (r2 = bf16(x + o); gate|up chunk pairs: the GLU output).
//   * attention: an item per (kv head, split) covers ceil(len / nsplit) of
//     the filled slots (len read from device memory: one launch serves
//     every position and a CUDA graph replays it); its first K / V tiles
//     are asked for by cp.async before the barrier ahead of the phase, two
//     in flight; each warp keeps its own online state over a run of each
//     tile's slots, lanes scoring whole slots, so a score needs no
//     reduction over the warp; split 0 writes the fresh rows at slot len
//     (no block reads that slot) and folds the fresh column into its
//     state. The kv head's last split (a ticket) merges the splits' states
//     in split order into the attention row: no combine phase and no
//     barrier of its own.
// The weight phases after attention, and the parts around them, are
// layer_stream.cuh's, which ffn.cu's single-row MLP kernel (#5 / #6)
// launches too, from o or gate|up.
// Measured on an H100 (PERF.md §6): 0.106 ms at 128 filled slots
// against 0.184 for the design this replaced (a cooperative grid of
// 32-column tiles, 4-byte loads, five grid.sync()s); the kernel's own
// %globaltimer timeline shows the phase boundaries' latency, not the
// stream, as what is left.
// The rope products are rounded one at a time (__fmul_rn / __fadd_rn), as
// PyTorch computes x * cos + rotate_half(x) * sin: the written row is the
// cache-dtype rounding of the plain rope of the kernel's own q|k|v row. The
// cache is read in place in its stacked layout (the caller passes the
// layer's base). Slot len must lie below S; at len >= S (a full cache)
// the fresh rows are not written. An optional buffer receives each block's
// %globaltimer at the phase boundaries (ops/layer_fused.timeline_split).

#include <string.h>

#include "layer_stream.cuh"

namespace {

template <typename ST, typename CT>
__global__ void __launch_bounds__(LTHREADS, 1)
    layer_kernel(const __grid_constant__ LArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring r;
  Stage<ST> s;
  int* items;
  if (!block_start<ST>(a, smem, r, s, items)) return;
  const int len = *a.len;  // slots cached (read here: its trip overlaps)
  int item = 0, k = 0;
  unsigned gen = threadIdx.x == 0 ? ld_acquire(a.sync + 1) : 0;  // grid_bar
  stamp(a, 0);
  stage_row<ST>(a, 0, s);  // ln1 + q|k|v
  consume<ST>(a, 0, item, k, smem, r.full, r.empty, s, r.pl, items);
  unsigned char* uni = smem + a.off_uni;  // rope, fresh rows, split states
  attn_prefetch<CT>(a, uni, len);
  stamp(a, 1);
  grid_bar(a, ++gen);
  stamp(a, 2);
  if (a.hd == 64)
    attn_phase<CT, 64>(a, uni, len);
  else if (a.hd == 128)
    attn_phase<CT, 128>(a, uni, len);
  else
    attn_phase<CT, 256>(a, uni, len);
  // o + residual, ln2 + gate|up, act * up + down + residual
  weight_phases<ST>(a, 1, gen, item, k, smem, r, s, items);
}

template <typename ST, typename CT>
int attn_bytes(int hd) {
  return hd == 64    ? ATile<CT, 64>::BYTES
         : hd == 128 ? ATile<CT, 128>::BYTES
                     : ATile<CT, 256>::BYTES;
}

template <typename ST, typename CT>
int layer_run(LArgs& a, int blocks, cudaStream_t st) {
  const size_t smem = stream_layout<ST>(a, attn_bytes<ST, CT>(a.hd));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  static int per_sm = -1;  // depends on the kernel and the card only
  return stream_launch(layer_kernel<ST, CT>, a, blocks, smem, per_sm, st);
}

static_assert(sizeof(CUtensorMap) == 128, "layer_maps writes 2 x 128 bytes");

// the TMA maps of a weight's fields: (word rows, Np) int32 planes, boxes of
// CC columns x RR rows (or the whole field where it is shorter)
bool weight_maps(const WeightDesc& w, CUtensorMap* maps) {
  const int32_t* base[2] = {w.w0, w.w1};
  memset(maps, 0, 2 * sizeof(CUtensorMap));
  for (int f = 0; f < (w.bits == 3 ? 2 : 1); ++f) {
    const int rows = w.Kp * (w.bits == 3 ? (f ? 1 : 2) : w.bits) / 32;
    const cuuint64_t dims[2] = {(cuuint64_t)w.Np, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)w.Np * 4};
    const cuuint32_t box[2] = {CC, (cuuint32_t)(rows < RR ? rows : RR)};
    if (!aligned16(base[f]) ||
        !tmap(&maps[f], CU_TENSOR_MAP_DATA_TYPE_INT32, 2, base[f], dims,
              strides, box, false))
      return false;
  }
  return true;
}

}  // namespace

// The TMA maps of one weight of the layer (uniform grid, Np a multiple of
// 128): its fields' two maps (the second zero below 3 bits), 2 x 128 bytes
// into `out`, for layer_launch. They are a function of the fields'
// addresses and the weight's (bits, Kp, Np) alone, so a caller may keep
// them as long as those hold. Returns 0, or cudaErrorInvalidValue.
extern "C" int layer_maps(const WeightDesc* w, void* out) {
  CUtensorMap maps[2];
  if (!weight_ok(w) || w->fmt != 0 || w->Np % CC || out == nullptr ||
      !weight_maps(*w, maps))
    return (int)cudaErrorInvalidValue;
  memcpy(out, maps, sizeof(maps));
  return 0;
}

// One decoder layer for one token. x, ln1, ln2: (hidden,) f32; norm: 0
// rmsnorm, 1 rmsnorm1p; cs, sn: (hd,) f32 rope tables of the position len;
// len: (1,) int32 in device memory; kc, vc: this layer's (S, Hkv, hd) cache
// (cache_kind 0 = f32, 1 = bf16), written at slot len; act: 0 silu, 1 gelu,
// 2 gelu_tanh, 3 relu; the four weights (uniform grids, Np a multiple of
// 128): q|k|v (hidden x >= (H + 2 Hkv) hd), o (H hd x hidden), gate|up
// (hidden x 2 F), down (F x hidden), and each one's maps from layer_maps.
// items / first: the plan of `blocks` blocks (ops/layer_fused.layer_plan),
// no block with more than max_items items, nor more than MAXP pieces of
// chunks cut in K in one phase (max_cut). Scratch (the caller's): qkvo
// (qkv.Np), pml (Hkv nsplit G 2), pacc (Hkv nsplit G hd), attn (H hd), r2
// (hidden), gu (2 F), inner (F), part (the plan's pieces x 128); sync: 2 +
// the plan's tickets uint32 (the grid barrier's count, its generation,
// the tickets), zero before the first launch and, but the generation, left
// zero by every launch that runs to its end; launches that share them
// must not overlap (one stream); stamps: null or (blocks, NSTAMP) int64.
// out: (hidden,) f32.
// Returns the cooperative launch's cudaError_t (cudaErrorInvalidValue for
// what the kernel does not take, launching nothing).
extern "C" int layer_launch(const float* x, const float* ln1,
                            const float* ln2, int norm, float eps,
                            const float* cs, const float* sn, const int* len,
                            void* kc, void* vc, int cache_kind, int S, int H,
                            int Hkv, int hd, float sm_scale, int act, int a8,
                            const WeightDesc* qkv, const WeightDesc* o,
                            const WeightDesc* gu, const WeightDesc* dn,
                            const void* m_qkv, const void* m_o,
                            const void* m_gu, const void* m_dn,
                            const int* items, const int* first, int blocks,
                            int max_items, int max_cut,
                            float* qkvo, float* pml, float* pacc, int nsplit,
                            float* attn, float* r2, float* gbuf, float* inner,
                            float* out, float* part, unsigned* sync,
                            long long* stamps, void* stream) {
  const WeightDesc* ws[4] = {qkv, o, gu, dn};
  const void* ms[4] = {m_qkv, m_o, m_gu, m_dn};
  for (const void* m : ms)
    if (m == nullptr) return (int)cudaErrorInvalidValue;
  for (const WeightDesc* w : ws)
    if (!stream_weight_ok(w)) return (int)cudaErrorInvalidValue;
  const int hidden = qkv->Kp;
  if (H < 1 || Hkv < 1 || H % Hkv || H / Hkv > LMAXG ||
      (hd != 64 && hd != 128 && hd != 256) ||
      qkv->Np < (H + 2 * Hkv) * hd || o->Kp != H * hd || o->Np != hidden ||
      gu->Kp != hidden || gu->Np != 2 * dn->Kp || dn->Np != hidden ||
      norm < 0 || norm > 1 || act < 0 || act > 3 || cache_kind < 0 ||
      cache_kind > 1 || S < 1 || nsplit < 1 || Hkv * nsplit > blocks ||
      blocks < 1 || max_items < 0 || max_cut < 0 || max_cut > MAXP ||
      x == nullptr || ln1 == nullptr || ln2 == nullptr ||
      cs == nullptr || sn == nullptr || len == nullptr || items == nullptr ||
      first == nullptr || sync == nullptr || !aligned16(kc) ||
      !aligned16(vc))
    return (int)cudaErrorInvalidValue;
  LArgs a{};
  for (int w = 0; w < 4; ++w) {
    a.wd[w] = *ws[w];
    a.wd[w].bias = nullptr;  // the llama layer has no biases
    memcpy(&a.maps[2 * w], ms[w], 2 * sizeof(CUtensorMap));
  }
  a.items = items;
  a.first = first;
  a.max_items = max_items;
  a.x = x;
  a.ln1 = ln1;
  a.ln2 = ln2;
  a.cs = cs;
  a.sn = sn;
  a.len = len;
  a.kc = kc;
  a.vc = vc;
  a.qkvo = qkvo;
  a.pml = pml;
  a.pacc = pacc;
  a.attn = attn;
  a.r2 = r2;
  a.gu = gbuf;
  a.inner = inner;
  a.out = out;
  a.part = part;
  a.sync = sync;
  a.stamps = stamps;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.nsplit = nsplit;
  a.norm = norm;
  a.act = act;
  a.eps = eps;
  a.sm_scale = sm_scale;
  a.first_w = 0;
  a.glu = 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (a8)
    return cache_kind ? layer_run<int8_t, __nv_bfloat16>(a, blocks, st)
                      : layer_run<int8_t, float>(a, blocks, st);
  return cache_kind ? layer_run<__nv_bfloat16, __nv_bfloat16>(a, blocks, st)
                    : layer_run<__nv_bfloat16, float>(a, blocks, st);
}
