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
// rate.
//
// Design (simple and right first): one cooperative launch of co-resident
// blocks (occupancy API) with grid-wide barriers between its phases:
//   1. ln1 + q|k|v: the norm_qkv kernel's body (fused.cuh: norm_rows);
//      each block then pulls its first tile of o into L2.
//   2. split flash decoding: an item per (kv head, split) covers
//      ceil(len / nsplit) of the filled slots, len read from device memory,
//      so one launch serves every position and a CUDA graph can replay it.
//      An item ropes the G query heads of its kv head from the q|k|v row;
//      its 16 warps take whole slots, each keeping the online-softmax
//      state of up to 4 query heads (more heads take another pass over the
//      slots); the warps' states merge in shared memory into the split's
//      unnormalised (m, l, acc). The item of split 0 also writes the kv
//      head's fresh rows at slot len: attention reads only slots < len, so
//      no block reads the slot being written.
//   3. combine: a warp per query head merges the splits' states with the
//      fresh column (recomputed from the q|k|v row, rounded to the cache
//      dtype as written) and normalises, into the f32 attention row.
//   4-6. the MLP kernel's phases (fused.cuh: mlp_phases): o + residual,
//      ln2 + gate|up + act, down + residual.
// The rope products are rounded one at a time (__fmul_rn / __fadd_rn), as
// PyTorch computes x * cos + rotate_half(x) * sin: the written row is the
// cache-dtype rounding of the plain rope of the kernel's own q|k|v row. The
// cache is read in place in its stacked layout (the caller passes the
// layer's base). Slot len must lie below S; at len >= S (a full cache)
// the fresh rows are not written.

#include "cache_row.cuh"
#include "fused.cuh"

namespace {

constexpr int GB = 4;  // query heads of one pass over a split's slots
constexpr int MAX_HD = 256;
constexpr float NEG_INF = -1e9f;
// the attention phase's shared memory: each warp's (m, l, acc) of GB heads
constexpr size_t ATTN_SMEM = sizeof(float) * WARPS * GB * (MAX_HD + 2);

struct LayerArgs {
  MlpArgs mlp;       // o, gate|up, down: mlp.x is attn, mlp.xres is x
  WeightDesc qkv;
  const float* x;    // (hidden,) f32 block input
  const float* ln1;  // (hidden,) norm weight
  const float* cs;   // (hd,) rope tables of this position
  const float* sn;
  const int* len;    // (1,) int32: slots already cached
  void* kc;          // (S, Hkv, hd) this layer's cache, bf16 or f32
  void* vc;
  float* qkvo;  // (qkv.Np,) scratch: the q|k|v row
  float* pml;   // (Hkv * nsplit * G * 2,) the splits' (m, l)
  float* pacc;  // (Hkv * nsplit * G * hd,) the splits' unnormalised outputs
  float* attn;  // (H * hd,) the attention row (= mlp.x)
  int S, H, Hkv, hd, nsplit, norm1;
  float eps, sm_scale;
};

template <typename CT>
__device__ __forceinline__ CT to_cache(float v);
template <>
__device__ __forceinline__ float to_cache<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_cache<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element d of the roped head at offset off of the q|k|v row
__device__ __forceinline__ float rope_at(const LayerArgs& a, int off, int d) {
  const int half = a.hd >> 1;
  const float* r = a.qkvo + off;
  if (d < half)
    return __fsub_rn(__fmul_rn(r[d], a.cs[d]), __fmul_rn(r[d + half], a.sn[d]));
  return __fadd_rn(__fmul_rn(r[d], a.cs[d]), __fmul_rn(r[d - half], a.sn[d]));
}

// phase 2: the (kv head, split) items that fall to this block
template <typename CT, int ND>
__device__ __noinline__ void attn_items(const LayerArgs& a, float* sm) {
  constexpr int hd = ND * 32;
  constexpr int TB = 16 / ND;  // slots a warp loads per round
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = a.H / a.Hkv;
  const int len_raw = *a.len;
  const int len = min(max(len_raw, 0), a.S);
  const int per = (len + a.nsplit - 1) / a.nsplit;
  const int koff = a.H * hd;
  const int voff = koff + a.Hkv * hd;
  const size_t rs = (size_t)a.Hkv * hd;  // elements between two slots
  float* s_m = sm;                       // [WARPS][GB]
  float* s_l = sm + WARPS * GB;          // [WARPS][GB]
  float* s_acc = sm + 2 * WARPS * GB;    // [WARPS][GB][hd]

  for (int item = blockIdx.x; item < a.Hkv * a.nsplit; item += gridDim.x) {
    const int h = item / a.nsplit;
    const int split = item - h * a.nsplit;
    if (split == 0 && len_raw >= 0 && len_raw < a.S) {
      CT* kw = (CT*)a.kc + ((size_t)len_raw * a.Hkv + h) * hd;
      CT* vw = (CT*)a.vc + ((size_t)len_raw * a.Hkv + h) * hd;
      for (int d = threadIdx.x; d < hd; d += THREADS) {
        kw[d] = to_cache<CT>(rope_at(a, koff + h * hd, d));
        vw[d] = to_cache<CT>(a.qkvo[voff + h * hd + d]);
      }
    }
    const int c0 = split * per;
    const int c1 = min(len, c0 + per);
    const CT* kb = (const CT*)a.kc + (size_t)h * hd;
    const CT* vb = (const CT*)a.vc + (size_t)h * hd;
    for (int g0 = 0; g0 < G; g0 += GB) {
      const int gn = min(GB, G - g0);
      float qr[GB][ND], acc[GB][ND], m[GB], l[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          acc[g][i] = 0.f;
          qr[g][i] = g < gn ? __fmul_rn(rope_at(a, (h * G + g0 + g) * hd,
                                                lane * ND + i),
                                        a.sm_scale)
                            : 0.f;
        }
      }
      for (int t0 = c0 + warp * TB; t0 < c1; t0 += WARPS * TB) {
        float kr[TB][ND], vr[TB][ND];
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          if (t0 + j < c1) {
            load_slice<CT, ND>(kb + (size_t)(t0 + j) * rs, lane, kr[j]);
            load_slice<CT, ND>(vb + (size_t)(t0 + j) * rs, lane, vr[j]);
          } else {
#pragma unroll
            for (int i = 0; i < ND; ++i) kr[j][i] = vr[j][i] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= gn) break;
          float s[TB];
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < TB; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < ND; ++i) dot += qr[g][i] * kr[j][i];
            dot = warp_sum(dot);
            s[j] = t0 + j < c1 ? dot : NEG_INF;
            mx = fmaxf(mx, s[j]);
          }
          const float m_new = fmaxf(m[g], mx);
          const float alpha = __expf(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int i = 0; i < ND; ++i) acc[g][i] *= alpha;
#pragma unroll
          for (int j = 0; j < TB; ++j) {
            const float p = t0 + j < c1 ? __expf(s[j] - m_new) : 0.f;
            l[g] += p;
#pragma unroll
            for (int i = 0; i < ND; ++i) acc[g][i] += p * vr[j][i];
          }
          m[g] = m_new;
        }
      }
      // merge the warps' states into this split's (m, l, acc)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= gn) break;
        if (lane == 0) {
          s_m[warp * GB + g] = m[g];
          s_l[warp * GB + g] = l[g];
        }
#pragma unroll
        for (int i = 0; i < ND; ++i)
          s_acc[(warp * GB + g) * hd + lane * ND + i] = acc[g][i];
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < gn * hd; idx += THREADS) {
        const int g = idx / hd;
        const int d = idx - g * hd;
        float M = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w * GB + g]);
        float acc_d = 0.f, ll = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float e = __expf(s_m[w * GB + g] - M);
          acc_d += s_acc[(w * GB + g) * hd + d] * e;
          ll += s_l[w * GB + g] * e;
        }
        const size_t o = (size_t)item * G + g0 + g;
        a.pacc[o * hd + d] = acc_d;
        if (d == 0) {
          a.pml[2 * o] = M;
          a.pml[2 * o + 1] = ll;
        }
      }
      __syncthreads();
    }
  }
}

// phase 3: a warp per query head merges the splits and the fresh column
template <typename CT, int ND>
__device__ __noinline__ void combine_heads(const LayerArgs& a) {
  constexpr int hd = ND * 32;
  const int lane = threadIdx.x & 31;
  const int G = a.H / a.Hkv;
  const int koff = a.H * hd;
  const int voff = koff + a.Hkv * hd;
  for (int hq = blockIdx.x * WARPS + (threadIdx.x >> 5); hq < a.H;
       hq += gridDim.x * WARPS) {
    const int h = hq / G;
    const int g = hq - h * G;
    float vf[ND];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = lane * ND + i;
      const float q = __fmul_rn(rope_at(a, hq * hd, d), a.sm_scale);
      const float kf = to_f(to_cache<CT>(rope_at(a, koff + h * hd, d)));
      vf[i] = to_f(to_cache<CT>(a.qkvo[voff + h * hd + d]));
      dot += q * kf;
    }
    const float sf = warp_sum(dot);
    const size_t o0 = (size_t)h * a.nsplit * G + g;  // split s: o0 + s * G
    float M = sf;
    for (int s = 0; s < a.nsplit; ++s)
      M = fmaxf(M, a.pml[2 * (o0 + (size_t)s * G)]);
    float l = 0.f, acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      const size_t o = o0 + (size_t)s * G;
      const float e = __expf(a.pml[2 * o] - M);
      l += a.pml[2 * o + 1] * e;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] += a.pacc[o * hd + lane * ND + i] * e;
    }
    const float e = __expf(sf - M);
    l += e;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      a.attn[(size_t)hq * hd + lane * ND + i] = (acc[i] + e * vf[i]) / l;
  }
}

template <typename ST, typename CT>
__global__ void __launch_bounds__(THREADS) layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan<1, ST> pl(smem);
  cg::grid_group grid = cg::this_grid();

  // phase 1: ln1 + q|k|v
  const RowSrc s0{a.x, a.ln1, nullptr, a.qkv.Kp, a.norm1, a.eps};
  norm_rows<1, ST>(s0, 1, a.qkv, a.qkvo, pl);
  if (blockIdx.x < a.mlp.o.Np / COLS) prefetch_tile(a.mlp.o, blockIdx.x * COLS);
  __threadfence();
  grid.sync();

  // phase 2: rope, the fresh rows, the splits' attention states
  float* sm = reinterpret_cast<float*>(smem);
  if (a.hd == 64)
    attn_items<CT, 2>(a, sm);
  else if (a.hd == 128)
    attn_items<CT, 4>(a, sm);
  else
    attn_items<CT, 8>(a, sm);
  __threadfence();
  grid.sync();

  // phase 3: the attention row
  if (a.hd == 64)
    combine_heads<CT, 2>(a);
  else if (a.hd == 128)
    combine_heads<CT, 4>(a);
  else
    combine_heads<CT, 8>(a);
  __threadfence();
  grid.sync();

  // phases 4-6: o + residual, ln2 + gate|up + act, down + residual
  mlp_phases<1, ST>(a.mlp, pl, grid);
}

template <typename ST, typename CT>
cudaError_t layer_run(LayerArgs& a, cudaStream_t st) {
  auto kern = layer_kernel<ST, CT>;
  const size_t plan = Plan<1, ST>::BYTES;
  const size_t smem = plan > ATTN_SMEM ? plan : ATTN_SMEM;
  static int resident = 0;
  cudaError_t err = resident_blocks(kern, smem, resident);
  if (err != cudaSuccess) return err;
  int tiles = a.qkv.Np / COLS;
  const int widths[3] = {a.mlp.o.Np, a.mlp.gu.Np / 2, a.mlp.dn.Np};
  for (int w : widths)
    if (w / COLS > tiles) tiles = w / COLS;
  if (a.Hkv * a.nsplit > tiles) tiles = a.Hkv * a.nsplit;
  const int grid = tiles < resident ? tiles : resident;
  return coop_launch(kern, grid, smem, st, a);
}

}  // namespace

// One decoder layer for one token. x, ln1, ln2: (hidden,) f32; norm: 0
// rmsnorm, 1 rmsnorm1p; cs, sn: (hd,) f32 rope tables of the position len;
// len: (1,) int32 in device memory; kc, vc: this layer's (S, Hkv, hd) cache
// (cache_kind 0 = f32, 1 = bf16), written at slot len; act: 0 silu, 1 gelu,
// 2 gelu_tanh, 3 relu; the four weights: q|k|v (hidden x >= (H + 2 Hkv)
// hd), o (H hd x hidden), gate|up (hidden x 2 F), down (F x hidden).
// Scratch (the caller's): qkvo (qkv.Np), pml (Hkv nsplit G 2), pacc
// (Hkv nsplit G hd), attn (H hd), r2 (hidden), inner (F); out: (hidden,)
// f32. Returns the cooperative launch's cudaError_t.
extern "C" int layer_launch(const float* x, const float* ln1,
                            const float* ln2, int norm, float eps,
                            const float* cs, const float* sn, const int* len,
                            void* kc, void* vc, int cache_kind, int S, int H,
                            int Hkv, int hd, float sm_scale, int act, int a8,
                            const WeightDesc* qkv, const WeightDesc* o,
                            const WeightDesc* gu, const WeightDesc* dn,
                            float* qkvo, float* pml, float* pacc, int nsplit,
                            float* attn, float* r2, float* inner, float* out,
                            void* stream) {
  if (!weight_ok(qkv) || !weight_ok(o) || !weight_ok(gu) || !weight_ok(dn))
    return (int)cudaErrorInvalidValue;
  const int hidden = qkv->Kp;
  if (H < 1 || Hkv < 1 || H % Hkv || (hd != 64 && hd != 128 && hd != 256) ||
      qkv->Np < (H + 2 * Hkv) * hd || o->Kp != H * hd || o->Np != hidden ||
      gu->Kp != hidden || gu->Np != 2 * dn->Kp || dn->Np != hidden ||
      norm < 0 || norm > 1 || act < 0 || act > 3 || cache_kind < 0 ||
      cache_kind > 1 || S < 1 || nsplit < 1 || x == nullptr ||
      ln1 == nullptr || ln2 == nullptr || cs == nullptr || sn == nullptr ||
      len == nullptr || kc == nullptr || vc == nullptr)
    return (int)cudaErrorInvalidValue;
  LayerArgs a{};
  a.mlp.o = *o;
  a.mlp.gu = *gu;
  a.mlp.dn = *dn;
  a.mlp.x = attn;
  a.mlp.xres = x;
  a.mlp.nw = ln2;
  a.mlp.nb = nullptr;
  a.mlp.r2 = r2;
  a.mlp.inner = inner;
  a.mlp.out = out;
  a.mlp.M = 1;
  a.mlp.norm = norm;
  a.mlp.act = act;
  a.mlp.glu = 1;
  a.mlp.has_o = 1;
  a.mlp.eps = eps;
  a.qkv = *qkv;
  a.x = x;
  a.ln1 = ln1;
  a.cs = cs;
  a.sn = sn;
  a.len = len;
  a.kc = kc;
  a.vc = vc;
  a.qkvo = qkvo;
  a.pml = pml;
  a.pacc = pacc;
  a.attn = attn;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.nsplit = nsplit;
  a.norm1 = norm;
  a.eps = eps;
  a.sm_scale = sm_scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (a8)
    return (int)(cache_kind ? layer_run<int8_t, __nv_bfloat16>(a, st)
                            : layer_run<int8_t, float>(a, st));
  return (int)(cache_kind ? layer_run<__nv_bfloat16, __nv_bfloat16>(a, st)
                          : layer_run<__nv_bfloat16, float>(a, st));
}
