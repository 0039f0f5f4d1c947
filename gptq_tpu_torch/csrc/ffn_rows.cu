// The batched-decode kernels of #4 and #5 / #6 on the tensor cores (2 ..
// 32 activation rows, uniform weights): norm_qkv_rows_kernel and
// mlp_rows_kernel, whose device code and design are in rows.cuh. This file
// holds their host side: the weight checks, the shared-memory layout, the
// TMA maps and the cooperative launch, in the form a stream capture
// records. ops/ffn.py (_rows_cuda) calls rows_launch.

#include <string.h>

#include "rows.cuh"

namespace {

inline bool al16(const void* p) { return ((uintptr_t)p & 15) == 0; }
inline int up1k(int v) { return (v + 1023) & ~1023; }
inline int up16(int v) { return (v + 15) & ~15; }

// a weight the rows kernels take (ops/ffn.rows_ok says the same)
bool rows_weight_ok(const WeightDesc* w) {
  if (!weight_ok(w) || w->fmt != 0) return false;
  if (w->bits != 2 && w->bits != 3 && w->bits != 4 && w->bits != 8)
    return false;
  return w->Np % CC == 0 && w->Kp % SEGK == 0 && w->SB >= SEGK &&
         (w->Kp / w->ng) % SEGK == 0 && al16(w->w0) && al16(w->w1) &&
         al16(w->scale) && al16(w->zoff) && al16(w->bias);
}

// the shared-memory layout into `a` (the bytes, or 0 where no ring of two
// stages fits); mirrored by ops/ffn._rows_smem
int rows_layout(RowsArgs& a, int a8) {
  int kmax = 0, fbmin = 8, ngmax = 1;
  for (int w = a.first_w; w <= a.last_w; ++w) {
    const WeightDesc& wd = a.wd[w];
    kmax = wd.Kp > kmax ? wd.Kp : kmax;
    ngmax = wd.ng > ngmax ? wd.ng : ngmax;
    const int fb = rows_field_bits(wd.bits, wd.bits == 3 ? 1 : 0);
    fbmin = fb < fbmin ? fb : fbmin;
  }
  a.xseg = a.MP * 128 * (a8 ? 1 : 2);
  a.slot_bytes = up1k(STAGE_BYTES + RR * 32 / fbmin / SEGK * a.xseg);
  const int red = 2 * a.MP * CC * 4 + (a.MP + a.MP * ngmax) * 4;
  const int row = kmax * 4 + kmax / 16 * 4 + RCW * 4;
  const int uni = up16(red > row ? red : row);
  const int bars = (3 * RMAX_STAGES + 4) * 8;
  int ns = (RSMEM - 1024 - uni - bars) / a.slot_bytes;
  ns = ns > RMAX_STAGES ? RMAX_STAGES : ns;
  if (ns < 2) return 0;
  a.ns = ns;
  a.off_uni = ns * a.slot_bytes;
  a.off_bar = a.off_uni + uni;
  return 1024 + a.off_bar + bars;
}

// the TMA maps: each field's words (boxes of 32 columns x RR word rows)
// and each phase's prepared rows (boxes of 128 bytes x MP rows, rows past
// M read as zeros), all in the 128-byte swizzle
bool rows_maps(RowsArgs& a, int a8) {
  bool ok = true;
  for (int w = a.first_w; w <= a.last_w; ++w) {
    const WeightDesc& wd = a.wd[w];
    const int32_t* fields[2] = {wd.w0, wd.w1};
    for (int f = 0; f < (wd.bits == 3 ? 2 : 1); ++f) {
      const cuuint64_t d[2] = {(cuuint64_t)wd.Np,
                               (cuuint64_t)wd.Kp * rows_field_bits(wd.bits, f) /
                                   32};
      const cuuint64_t s[1] = {(cuuint64_t)wd.Np * 4};
      const cuuint32_t b[2] = {32, RR};
      ok = ok && tmap(&a.wmap[w][f], CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
                      fields[f], d, s, b, true);
    }
    const int es = a8 ? 1 : 2;
    const cuuint64_t d[2] = {(cuuint64_t)wd.Kp, (cuuint64_t)a.M};
    const cuuint64_t s[1] = {(cuuint64_t)wd.Kp * es};
    const cuuint32_t b[2] = {(cuuint32_t)(128 / es), (cuuint32_t)a.MP};
    ok = ok && tmap(&a.xmap[w],
                    a8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, a.xq[w], d, s, b, true);
  }
  return ok;
}

// the kernel on `blocks` blocks, all resident at once (the cooperative
// attribute: the grid barrier waits for every block); per_sm: its
// resident blocks on this card, found once
int rows_run(void (*kern)(const RowsArgs), const RowsArgs& a, int blocks,
             int smem, int& resident, cudaStream_t st) {
  cudaError_t err;
  if (resident < 0) {
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RSMEM)) !=
        cudaSuccess)
      return (int)err;
    int dev = 0, sms = 0, n = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kern, RTHREADS, RSMEM)) != cudaSuccess)
      return (int)err;
    resident = n * sms;
  }
  if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(RTHREADS);
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

// kind 0 (#4, norm_qkv_rows_kernel): x (M, q.Kp) f32 bf16 values, the norm
// nw (+ nb for layernorm; norm 0 rmsnorm, 1 rmsnorm1p, 2 layernorm), the
// weight q; out (M, q.Np). kind 1 (#5 / #6, mlp_rows_kernel): with o, x the
// attention rows (M, o.Kp), xres (M, o.Np), the norm over r2; without o
// (null), x the MLP's input rows (M, gu.Kp), no norm; gu, dn; glu: act(gate)
// * up, else act(fc1); act 0 silu, 1 gelu, 2 gelu_tanh, 3 relu; out (M,
// dn.Np). Each weight's bias (Np f32) rides in its descriptor, or null.
// items / first: ops/layer_fused.layer_plan of the weights (glu off) over
// `blocks` blocks; cuts: its chunks cut in K, (chunk, first piece slot,
// pieces) int32 each, weight w's from entry cut_off[w] (5 ints, host
// memory) on. Scratch (the caller's, 16-byte aligned): xq[w] (M, Kp)
// int8 (a8) or bf16, sx (4, M), xsum[w] (M, ng), r2 (M, o.Np), gu (M,
// gu.Np), part (the plan's pieces, M, 128); sync: 2 uint32 (the barrier
// words of the stream kernels on this stream); stamps: (blocks,
// RSTAMPS) int64 %globaltimer readings, or null. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for what the kernels do not take,
// launching nothing).
extern "C" int rows_launch(int kind, const float* x, const float* xres,
                           const float* nw, const float* nb, int norm,
                           float eps, int act, int glu, int a8, int M,
                           const WeightDesc* q, const WeightDesc* o,
                           const WeightDesc* gu, const WeightDesc* dn,
                           const int* items, const int* first, int blocks,
                           const int* cuts, const int* cut_off,
                           void* xq0, void* xq1, void* xq2, void* xq3,
                           float* sx, float* xs0, float* xs1, float* xs2,
                           float* xs3, float* r2, float* gbuf, float* out,
                           float* part, unsigned* sync,
                           long long* stamps, void* stream) {
  RowsArgs a;
  memset(&a, 0, sizeof(a));
  const WeightDesc* ws[4] = {q, o, gu, dn};
  if (kind == 0) {
    a.first_w = a.last_w = 0;
    if (q == nullptr || nw == nullptr || norm < 0 || norm > 2 ||
        (norm == 2 && nb == nullptr))
      return (int)cudaErrorInvalidValue;
  } else if (kind == 1) {
    a.first_w = o != nullptr ? 1 : 2;
    a.last_w = 3;
    if (gu == nullptr || dn == nullptr || act < 0 || act > 3 ||
        (glu ? gu->Np != 2 * dn->Kp : gu->Np != dn->Kp) || gbuf == nullptr)
      return (int)cudaErrorInvalidValue;
    if (o != nullptr &&
        (o->Np != gu->Kp || dn->Np != o->Np || xres == nullptr ||
         r2 == nullptr || nw == nullptr || norm < 0 || norm > 2 ||
         (norm == 2 && nb == nullptr) || !al16(r2)))
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  void* xqs[4] = {xq0, xq1, xq2, xq3};
  float* xss[4] = {xs0, xs1, xs2, xs3};
  if (M < 1 || M > 32 || x == nullptr || out == nullptr || part == nullptr ||
      sx == nullptr || sync == nullptr || items == nullptr ||
      first == nullptr || blocks < 1 || !al16(x) || !al16(nw) || !al16(nb) ||
      !al16(gbuf))
    return (int)cudaErrorInvalidValue;
  for (int w = a.first_w; w <= a.last_w; ++w) {
    if (!rows_weight_ok(ws[w]) || xqs[w] == nullptr || xss[w] == nullptr ||
        !al16(xqs[w]))
      return (int)cudaErrorInvalidValue;
    a.wd[w] = *ws[w];
    a.xq[w] = xqs[w];
    a.xsum[w] = xss[w];
    a.sx[w] = sx + w * M;
  }
  if (cut_off == nullptr || (cuts == nullptr && cut_off[4] > 0))
    return (int)cudaErrorInvalidValue;
  a.items = items;
  a.first = first;
  a.cuts = cuts;
  memcpy(a.cut_off, cut_off, sizeof(a.cut_off));
  a.x = x;
  a.xres = xres;
  a.nw = nw;
  a.nb = norm == 2 ? nb : nullptr;
  a.r2 = r2;
  a.gu = gbuf;
  a.out = out;
  a.part = part;
  a.sync = sync;
  a.stamps = stamps;
  a.M = M;
  a.MP = (M + 7) & ~7;
  a.norm = norm;
  a.act = act;
  a.glu = glu;
  a.eps = eps;
  const int smem = rows_layout(a, a8);
  if (smem == 0 || !rows_maps(a, a8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static int resident[4] = {-1, -1, -1, -1};  // by kind and a8
  if (kind == 0)
    return a8 ? rows_run(norm_qkv_rows_kernel<int8_t>, a, blocks, smem,
                         resident[1], st)
              : rows_run(norm_qkv_rows_kernel<__nv_bfloat16>, a, blocks, smem,
                         resident[0], st);
  return a8 ? rows_run(mlp_rows_kernel<int8_t>, a, blocks, smem, resident[3],
                       st)
            : rows_run(mlp_rows_kernel<__nv_bfloat16>, a, blocks, smem,
                       resident[2], st);
}
