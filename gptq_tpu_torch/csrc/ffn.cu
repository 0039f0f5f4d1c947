// Fused serving kernels: whole phases of a decoder layer in one launch.
//
// Replaces the Pallas kernels of gptq_tpu/ops/ffn.py:
//   * norm_qkv_kernel  <- _norm_qkv_kernel (norm_qkv_fused):
//       out = norm(x) @ dequant(W) (+ b)            ln1 + q|k|v, or the head
//   * mlp_kernel       <- _attn_mlp_kernel (attn_mlp_fused), and without its
//                         first phase <- _ffn_kernel (ffn_fused):
//       r2    = bf16(xres + o(attn) + b_o)                        phase 1
//       inner = bf16(act(gate(n)) * up(n)), n = bf16(norm(r2))    phase 2
//             (or bf16(act(fc1(n))) without GLU)
//       out   = down(inner) + b_d + r2                            phase 3
// with the JAX kernels' rounding points: every phase quantizes its whole
// input row to int8 (a8: scale = absmax / 127, round half to even) or
// rounds it to bf16 (a16), and each weight is uniform-grid packed codes
// (2/3/4/8 bits, per-tensor or grouped grids; ops/pack.py layout) or BCQ
// sign planes (the BCQ branch of the TPU kernels' _stream_matmul):
//       W[k, n] = sum_b alpha[g(k), b, n] * (2 B_b[k, n] - 1)
// with B_b (bits, Kp/32, Np) 1-bit fields and alpha (ng, bits, Np) f32.
//
// Bound on an H100: at decode (M <= 32 rows) every phase streams its
// packed weight once, so the packed bytes (codes and grids, or planes and
// alphas) over the memory rate.
//
// Design (simple and right first):
//   * a block owns tiles of 32 output columns (one per lane, so a warp's
//     word loads are one 128-byte line). Its 16 warps take the tile's
//     (subblock, run of <= 16 word rows) items; a lane loads each word of
//     its column once and uses every code in it (qdot.cuh: dp4a for a8).
//     The group grid applies to each item's partial; the zero offset once
//     per subblock from the staged row's subblock sum. Warps' partials are
//     summed in shared memory: no atomics.
//   * every block recomputes, for its input rows, the norm statistics and
//     the int8 scale from the f32 source (a block-wide reduction over the
//     row in L2), then stages the transformed row (int8 or bf16) in shared
//     memory. Rows longer than the stage are staged in chunks of whole
//     subblocks (32 int8 rows of 11264 do not fit a block's 227 KB). The
//     dot runs over at most 4 staged rows at a time (registers), so 32
//     rows re-read a tile's words 8 times, from L2; decode has one row.
//   * the MLP kernel's phases depend on whole rows of the previous phase
//     (the norm of r2, the absmax of inner), so it is one cooperative
//     launch, sized by the occupancy API, with a grid-wide barrier between
//     the phases. r2 (M x hidden) and inner (M x ffn) live in device
//     scratch (the caller's), which stays in the 50 MB L2. Before each
//     barrier a block prefetches the words of its first tile of the next
//     phase into L2 (the weights never depend on an earlier phase; the
//     Hopper form of the TPU kernel's cross-phase DMA prefetch).
//   * a block that owns gate column j also owns up column j + ffn, so
//     act(g) * u is formed in its epilogue.
//   * BCQ: the same tiles, staging and phases; the tile product
//     (fused.cuh: bcq_planes_tile) runs plane_dot<1> over each plane's
//     words and applies x . (2B - 1) = 2 (x . B) - sum(x): alpha once per
//     (subblock, plane) on the partial, sum(x) from the staged subblock
//     sums (exact int32 for a8, the row scale applied at the end). It is
//     a separate non-inlined function, chosen per weight at run time, so
//     the uniform tile (shared with layer_fused.cu) is unchanged.
// The device code both kernels share with layer_fused.cu is in fused.cuh.
//
// At one row (decode), #5 and #6 on uniform weights take mlp_stream_kernel
// instead (mlp_stream_launch; ops/ffn.mlp_route picks it): the weight
// phases of the whole-layer kernel #12 (layer_stream.cuh, the same device
// code layer_fused.cu launches) from o (#5) or gate|up (#6). A producer
// warp an SM streams the packed words through a ring of 16 KB stages by
// TMA under a static plan (ops/layer_fused.layer_plan over o, gate|up and
// down), so every block streams a near-equal share of every phase and the
// narrow o and down weights are cut in K as well as in columns; 16
// consumer warps stage each phase's input row once per block and take the
// stages (wstream.cuh's product: a lane four columns, every code of each
// word), the pieces of a chunk cut in K summed in piece order by its last
// block (a ticket), which applies the zero points, the int8 scale, the
// bias and the phase's epilogue (r2, the GLU or fc1 activation, the
// residual). The consumers meet on a grid barrier of their own between
// phases (a generation counter in the caller's sync words, never reset
// from the host: a CUDA graph replays it). The rows 2 .. 32 of batched
// decode and short prefills, and BCQ sign planes, keep mlp_kernel above.
//
// At one row (decode), #4 on uniform weights takes norm_qkv_gemv_kernel
// instead (csrc/gemv.cuh; ops/ffn.norm_qkv_route picks it, the wrapper
// passes the single-row cut): #1's single-row stream, each 128-column
// chunk cut in K into a cluster's pieces, with the norm in front. Its
// producer warp fills the ring with weight stages at once while the
// consumer warps compute the row's norm and int8 scale from the f32 row
// in L2 (the row arithmetic of #12's stage_row, wstream.cuh row_norm) and
// stage their piece's range. Rows 2 .. 32 and BCQ sign planes keep
// norm_qkv_kernel.

#include <string.h>

#include "fused.cuh"
#include "gemv.cuh"          // norm_qkv_gemv_kernel, gemv_launch
#include "layer_stream.cuh"  // mlp_stream_kernel, its host side

namespace {

// the single-row (decode) instantiation keeps to 64 registers so that two
// blocks share an SM: twice the word loads in flight (measured on an
// H100: q|k|v 0.053 -> 0.043 ms; the same cap slowed mlp_kernel, which
// then spills, from 0.120 to 0.177 ms, so that one keeps 128)
template <int TM, typename ST>
__global__ void __launch_bounds__(THREADS, TM == 1 ? 2 : 1)
norm_qkv_kernel(RowSrc src, int M, WeightDesc wd, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan<TM, ST> pl(smem);
  norm_rows<TM, ST, true>(src, M, wd, out, pl);
}

template <int TM, typename ST>
__global__ void __launch_bounds__(THREADS) mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan<TM, ST> pl(smem);
  cg::grid_group grid = cg::this_grid();
  mlp_phases<TM, ST, true>(a, pl, grid);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// one block per resident slot at most: a block computes its rows'
// statistics once and walks several tiles
template <int TM, typename ST>
cudaError_t norm_qkv_run(const RowSrc& src, int M, const WeightDesc& wd,
                         float* out, cudaStream_t st) {
  auto kern = norm_qkv_kernel<TM, ST>;
  const size_t smem = Plan<TM, ST>::BYTES;
  static int resident = 0;
  cudaError_t err = resident_blocks(kern, smem, resident);
  if (err != cudaSuccess) return err;
  const int tiles = wd.Np / COLS;
  kern<<<tiles < resident ? tiles : resident, THREADS, smem, st>>>(src, M, wd,
                                                                   out);
  return cudaGetLastError();
}

template <typename ST>
cudaError_t norm_qkv_rows(const RowSrc& src, int M, const WeightDesc& wd,
                          float* out, cudaStream_t st) {
  if (M == 1) return norm_qkv_run<1, ST>(src, M, wd, out, st);
  return norm_qkv_run<MAX_ROWS, ST>(src, M, wd, out, st);
}

// the cooperative kernel's grid: co-resident blocks only
template <int TM, typename ST>
cudaError_t mlp_run(MlpArgs& a, cudaStream_t st) {
  auto kern = mlp_kernel<TM, ST>;
  const size_t smem = Plan<TM, ST>::BYTES;
  static int resident = 0;
  cudaError_t err = resident_blocks(kern, smem, resident);
  if (err != cudaSuccess) return err;
  int tiles = (a.glu ? a.gu.Np / 2 : a.gu.Np) / COLS;
  if (a.has_o && a.o.Np / COLS > tiles) tiles = a.o.Np / COLS;
  if (a.dn.Np / COLS > tiles) tiles = a.dn.Np / COLS;
  const int grid = tiles < resident ? tiles : resident;
  return coop_launch(kern, grid, smem, st, a);
}

template <typename ST>
cudaError_t mlp_rows(MlpArgs& a, cudaStream_t st) {
  if (a.M == 1) return mlp_run<1, ST>(a, st);
  return mlp_run<MAX_ROWS, ST>(a, st);
}

}  // namespace

// x: (M, K) f32 (bf16 values); nw: (K,) f32; nb: (K,) f32 for layernorm,
// else null; norm: 0 rmsnorm, 1 rmsnorm1p, 2 layernorm; out: (M, Np) f32.
// splits > 0: the single-row kernel (M = 1, a uniform weight; splits /
// unit its cut, ops/qmatmul.gemv_splits / gemv_unit; x, nw, nb on 16-byte
// boundaries); 0: the tiled norm_qkv_kernel. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for what the kernel does not take,
// launching nothing).
extern "C" int norm_qkv_launch(const float* x, int M, int K, const float* nw,
                               const float* nb, int norm, float eps, int a8,
                               const WeightDesc* w, float* out, int splits,
                               int unit, void* stream) {
  if (M < 1 || M > MAX_ROWS || !weight_ok(w, true) || K != w->Kp ||
      nw == nullptr || norm < 0 || norm > 2 || (norm == 2 && nb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (splits > 0) {
    if (M != 1 || w->fmt != 0 || w->bits == 1)
      return (int)cudaErrorInvalidValue;
    GemvArgs a{};
    a.x = x;
    a.w0 = w->w0;
    a.w1 = w->w1;
    a.grid = w->scale;
    a.zoff = w->zoff;
    a.out = out;
    a.nw = nw;
    a.nb = norm == 2 ? nb : nullptr;
    a.bias = w->bias;
    a.norm = norm;
    a.eps = eps;
    a.Kp = w->Kp;
    a.Np = w->Np;
    a.SB = w->SB;
    a.ng = w->ng;
    a.bits = w->bits;
    a.splits = splits;
    a.unit = unit;
    return a8 ? gemv_launch<int8_t, false, false, true>(a, st)
              : gemv_launch<__nv_bfloat16, false, false, true>(a, st);
  }
  const RowSrc src{x, nw, nb, K, norm, eps};
  return (int)(a8 ? norm_qkv_rows<int8_t>(src, M, *w, out, st)
                  : norm_qkv_rows<__nv_bfloat16>(src, M, *w, out, st));
}

// With o: the attention-output + MLP half of a block (x = attn (M, o.Kp),
// xres (M, o.Np), ln2 nw / nb, scratch r2 (M, o.Np)); without o (null): the
// MLP alone on x = m (M, gu.Kp). inner: (M, gu.Np / 2 with glu, else
// gu.Np) scratch; out: (M, dn.Np). act: 0 silu, 1 gelu, 2 gelu_tanh,
// 3 relu. Returns the cooperative launch's cudaError_t.
extern "C" int mlp_launch(const float* x, const float* xres, const float* nw,
                          const float* nb, int norm, float eps, int act,
                          int glu, int a8, int M, const WeightDesc* o,
                          const WeightDesc* gu, const WeightDesc* dn,
                          float* r2, float* inner, float* out, void* stream) {
  if (M < 1 || M > MAX_ROWS || !weight_ok(gu, true) ||
      !weight_ok(dn, true) || act < 0 ||
      act > 3 || (glu ? gu->Np != 2 * dn->Kp : gu->Np != dn->Kp))
    return (int)cudaErrorInvalidValue;
  MlpArgs a{};
  a.gu = *gu;
  a.dn = *dn;
  a.x = x;
  a.inner = inner;
  a.out = out;
  a.M = M;
  a.act = act;
  a.glu = glu;
  a.has_o = o != nullptr;
  if (o != nullptr) {
    if (!weight_ok(o, true) || o->Np != gu->Kp || dn->Np != o->Np ||
        xres == nullptr || r2 == nullptr || nw == nullptr || norm < 0 ||
        norm > 2 || (norm == 2 && nb == nullptr))
      return (int)cudaErrorInvalidValue;
    a.o = *o;
    a.xres = xres;
    a.nw = nw;
    a.nb = nb;
    a.r2 = r2;
    a.norm = norm;
    a.eps = eps;
  }
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(a8 ? mlp_rows<int8_t>(a, st) : mlp_rows<__nv_bfloat16>(a, st));
}

// #5 / #6 at one row on the weight stream (mlp_stream_kernel). With o: x
// the attention row (o.Kp), xres (o.Np) bf16 values, the norm over r2 (nw,
// nb for layernorm; norm 0 rmsnorm, 1 rmsnorm1p, 2 layernorm), scratch r2
// (o.Np); without o (null): x the MLP's input row (gu.Kp), no norm, no
// residual. gu, dn (and o): uniform weights the stream takes, each with
// its maps (layer_fused.cu layer_maps) and its bias (Np f32) or null. items / first: the
// plan of `blocks` blocks (ops/layer_fused.layer_plan over o, gate|up and
// down, or gate|up and down), max_items / max_cut as layer_launch takes
// them. Scratch (the caller's, 16-byte aligned): gbuf (gu.Np), inner
// (dn.Kp), part (the plan's pieces x 128); sync: 2 + the plan's tickets
// uint32, as layer_launch's (the same words may serve both kernels on one
// stream). out: (dn.Np) f32. act: 0 silu, 1 gelu, 2 gelu_tanh, 3 relu.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for what the
// kernel does not take, launching nothing).
extern "C" int mlp_stream_launch(
    const float* x, const float* xres, const float* nw, const float* nb,
    int norm, float eps, int act, int glu, int a8, const WeightDesc* o,
    const WeightDesc* gu, const WeightDesc* dn, const void* m_o,
    const void* m_gu, const void* m_dn, const float* b_o, const float* b_g,
    const float* b_d, const int* items, const int* first, int blocks,
    int max_items, int max_cut, float* r2, float* gbuf, float* inner,
    float* out, float* part, unsigned* sync, void* stream) {
  if (!stream_weight_ok(gu) || !stream_weight_ok(dn) || m_gu == nullptr ||
      m_dn == nullptr || act < 0 || act > 3 ||
      (glu ? gu->Np != 2 * dn->Kp : gu->Np != dn->Kp) || !aligned16(x) ||
      !aligned16(gbuf) || !aligned16(inner) || out == nullptr ||
      part == nullptr || items == nullptr || first == nullptr ||
      sync == nullptr || blocks < 1 || max_items < 0 || max_cut < 0 ||
      max_cut > MAXP)
    return (int)cudaErrorInvalidValue;
  if (o != nullptr &&
      (!stream_weight_ok(o) || m_o == nullptr || o->Np != gu->Kp ||
       dn->Np != o->Np || xres == nullptr || !aligned16(r2) ||
       !aligned16(nw) || norm < 0 || norm > 2 ||
       (norm == 2 && !aligned16(nb)) || nw == nullptr ||
       (norm == 2 && nb == nullptr)))
    return (int)cudaErrorInvalidValue;
  LArgs a{};
  const WeightDesc* ws[4] = {nullptr, o, gu, dn};
  const void* ms[4] = {nullptr, m_o, m_gu, m_dn};
  const float* bs[4] = {nullptr, b_o, b_g, b_d};
  for (int w = 1; w < 4; ++w) {
    if (ws[w] == nullptr) continue;
    a.wd[w] = *ws[w];
    a.wd[w].bias = bs[w];
    memcpy(&a.maps[2 * w], ms[w], 2 * sizeof(CUtensorMap));
  }
  a.items = items;
  a.first = first;
  a.max_items = max_items;
  a.first_w = o != nullptr ? 1 : 2;
  a.glu = glu;
  a.act = act;
  a.eps = eps;
  if (o != nullptr) {
    a.attn = const_cast<float*>(x);
    a.x = xres;
    a.r2 = r2;
    a.ln2 = nw;
    a.ln2b = norm == 2 ? nb : nullptr;
    a.norm = norm;
  } else {
    a.r2 = const_cast<float*>(x);  // gate|up's input row, no norm
  }
  a.gu = gbuf;
  a.inner = inner;
  a.out = out;
  a.part = part;
  a.sync = sync;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = a8 ? stream_layout<int8_t>(a, 0)
                         : stream_layout<__nv_bfloat16>(a, 0);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  static int per_sm[2] = {-1, -1};  // by a8: the kernel and the card decide
  return a8 ? stream_launch(mlp_stream_kernel<int8_t>, a, blocks, smem,
                            per_sm[1], st)
            : stream_launch(mlp_stream_kernel<__nv_bfloat16>, a, blocks, smem,
                            per_sm[0], st);
}
