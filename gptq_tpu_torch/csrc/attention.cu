// Single-token decode attention straight off the KV cache (flash-decoding:
// a split over the cache and a combine pass), int8 cache with
// per-token-head scales or a bf16 / f32 cache.
//
// Replaces gptq_tpu/ops/attention.py:_attn_kernel (decode_attention) and
// :_attn_kernel_wide (decode_attention_wide): both Pallas kernels compute
// the same function, so one kernel ports both. For query head hq of batch
// row b, with kv head h = hq / G (GQA):
//
//     s_t = sm_scale * ks[b, t, h] * (q[b, hq] . k[b, t, h])   t < len[b]
//     out = softmax(s) @ (vs[b, t, h] * v[b, t, h])
//
// plus, when given, the current token's own (not yet written) f32 pair
// fresh_k / fresh_v merged into the softmax exactly as one more column
// (the deferred cache write of model_forward). Masked slots follow the TPU
// kernel's NEG_INF = -1e9 semantics: they get probability 0 while any slot
// or the fresh pair is valid; a row with length 0 and no fresh pair
// attends to nothing and its output is zeros. A stacked (L, B, S, Hkv, hd) cache is read
// in place: base pointer plus layer * layer stride.
//
// Design. The TPU kernel walks the cache in blocks on one core, carrying
// (m, l, acc) in scratch; on the GPU that walk is cut in two passes:
//   * attn_partial: a block per (batch row, kv head, split of `chunk`
//     slots). Each of its 4 warps takes whole tokens, TB at a time: lane i
//     holds dims [i*ND, i*ND + ND) of q, so a warp reads one cache row with
//     one coalesced load and all TB rows' k and v loads are in flight before
//     any arithmetic. Scores come from warp reductions; each warp keeps its
//     own online-softmax state for the G query heads of the kv head, so the
//     loop needs no block barrier. The 4 warps' states merge in shared
//     memory into the split's unnormalised (m, l, acc), written to scratch.
//   * attn_combine: a warp per (batch row, query head) merges the splits'
//     states with the fresh pair and normalises.
// hd (64, 128 or 256) is a template constant; G <= 8 is a runtime value.
// Bound on an H100: the cache bytes read over the memory rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cache_row.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;  // query heads per kv head
constexpr float NEG_INF = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename CT, int ND>  // ND = hd / 32 dims per lane
__global__ void __launch_bounds__(THREADS)
attn_partial(const float* __restrict__ q, const CT* __restrict__ kc,
             const CT* __restrict__ vc, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ lens,
             int S, int H, int Hkv, int chunk, float sm_scale,
             float* __restrict__ pml, float* __restrict__ pacc) {
  constexpr int hd = ND * 32;
  constexpr int TB = 32 / ND;  // tokens a warp loads per round
  __shared__ float s_m[WARPS][MAXG], s_l[WARPS][MAXG];
  __shared__ float s_acc[WARPS][MAXG][hd];

  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int split = blockIdx.y;
  const int G = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(lens[b], S);
  const int c0 = split * chunk;
  const int c1 = min(len, c0 + chunk);

  float qr[MAXG][ND], acc[MAXG][ND], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < G ? q[((size_t)b * H + (size_t)h * G + g) * hd + lane * ND + i] * sm_scale
                       : 0.f;
    }
  }

  const size_t rs = (size_t)Hkv * hd;  // elements between two tokens' rows
  const CT* kb = kc + ((size_t)b * S * Hkv + h) * hd;
  const CT* vb = vc + ((size_t)b * S * Hkv + h) * hd;
  const float* ksb = ksc != nullptr ? ksc + (size_t)b * S * Hkv + h : nullptr;
  const float* vsb = vsc != nullptr ? vsc + (size_t)b * S * Hkv + h : nullptr;

  for (int t0 = c0 + warp * TB; t0 < c1; t0 += WARPS * TB) {
    float kr[TB][ND], vr[TB][ND], kscl[TB], vscl[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int t = t0 + j;
      if (t < c1) {
        load_slice<CT, ND>(kb + t * rs, lane, kr[j]);
        load_slice<CT, ND>(vb + t * rs, lane, vr[j]);
        kscl[j] = ksb != nullptr ? ksb[(size_t)t * Hkv] : 1.f;
        vscl[j] = vsb != nullptr ? vsb[(size_t)t * Hkv] : 1.f;
      } else {
#pragma unroll
        for (int i = 0; i < ND; ++i) kr[j][i] = vr[j][i] = 0.f;
        kscl[j] = vscl[j] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[TB];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < ND; ++i) dot += qr[g][i] * kr[j][i];
        dot = warp_sum(dot);
        s[j] = t0 + j < c1 ? dot * kscl[j] : NEG_INF;
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
        const float pv = p * vscl[j];  // the v scale folds into p
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[g][i] += pv * vr[j][i];
      }
      m[g] = m_new;
    }
  }

  // merge the warps' states into this split's (m, l, acc)
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) s_acc[warp][g][lane * ND + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * hd; idx += THREADS) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = __expf(s_m[w][g] - M);
      a += s_acc[w][g][d] * e;
      ll += s_l[w][g] * e;
    }
    const size_t o = ((size_t)bh * gridDim.y + split) * G + g;
    pacc[o * hd + d] = a;
    if (d == 0) {
      pml[2 * o] = M;
      pml[2 * o + 1] = ll;
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(THREADS)
attn_combine(const float* __restrict__ q, const float* __restrict__ fk,
             const float* __restrict__ fv, const float* __restrict__ pml,
             const float* __restrict__ pacc, int B, int H, int Hkv,
             int nsplit, float sm_scale, float* __restrict__ out) {
  constexpr int hd = ND * 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);  // b * H + hq
  if (row >= B * H) return;  // whole warps leave together
  const int b = row / H;
  const int hq = row - b * H;
  const int G = H / Hkv;
  const int h = hq / G;
  const int g = hq - h * G;
  const size_t bh = (size_t)b * Hkv + h;
  const size_t o0 = bh * nsplit * G + g;  // split s at o0 + s * G

  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pml[2 * (o0 + (size_t)s * G)]);
  float sf = NEG_INF;
  if (fk != nullptr) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      dot += q[(size_t)row * hd + lane * ND + i] * sm_scale *
             fk[bh * hd + lane * ND + i];
    sf = warp_sum(dot);
    M = fmaxf(M, sf);
  }
  float l = 0.f, a[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) a[i] = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t o = o0 + (size_t)s * G;
    const float e = __expf(pml[2 * o] - M);
    l += pml[2 * o + 1] * e;
#pragma unroll
    for (int i = 0; i < ND; ++i) a[i] += pacc[o * hd + lane * ND + i] * e;
  }
  if (fk != nullptr) {
    const float e = __expf(sf - M);
    l += e;
#pragma unroll
    for (int i = 0; i < ND; ++i) a[i] += e * fv[bh * hd + lane * ND + i];
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;  // nothing attended: zeros
#pragma unroll
  for (int i = 0; i < ND; ++i) out[(size_t)row * hd + lane * ND + i] = a[i] * inv;
}

template <typename CT, int ND>
void launch_nd(const void* q, const void* k, const void* v, long long layer_off,
               const void* ks, const void* vs, long long scale_layer_off,
               const void* fk, const void* fv, const void* lens, int B, int S,
               int H, int Hkv, float sm_scale, int nsplit, int chunk,
               void* pml, void* pacc, void* out, cudaStream_t st) {
  const float* ksp = ks ? (const float*)ks + scale_layer_off : nullptr;
  const float* vsp = vs ? (const float*)vs + scale_layer_off : nullptr;
  attn_partial<CT, ND><<<dim3(B * Hkv, nsplit), THREADS, 0, st>>>(
      (const float*)q, (const CT*)k + layer_off, (const CT*)v + layer_off,
      ksp, vsp, (const int*)lens, S, H, Hkv, chunk, sm_scale, (float*)pml,
      (float*)pacc);
  attn_combine<ND><<<(B * H + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const float*)q, (const float*)fk, (const float*)fv, (const float*)pml,
      (const float*)pacc, B, H, Hkv, nsplit, sm_scale, (float*)out);
}

template <typename CT>
bool launch(const void* q, const void* k, const void* v, long long layer_off,
            const void* ks, const void* vs, long long scale_layer_off,
            const void* fk, const void* fv, const void* lens, int B, int S,
            int H, int Hkv, int hd, float sm_scale, int nsplit, int chunk,
            void* pml, void* pacc, void* out, cudaStream_t st) {
  switch (hd) {
    case 64: launch_nd<CT, 2>(q, k, v, layer_off, ks, vs, scale_layer_off, fk, fv, lens, B, S, H, Hkv, sm_scale, nsplit, chunk, pml, pacc, out, st); return true;
    case 128: launch_nd<CT, 4>(q, k, v, layer_off, ks, vs, scale_layer_off, fk, fv, lens, B, S, H, Hkv, sm_scale, nsplit, chunk, pml, pacc, out, st); return true;
    case 256: launch_nd<CT, 8>(q, k, v, layer_off, ks, vs, scale_layer_off, fk, fv, lens, B, S, H, Hkv, sm_scale, nsplit, chunk, pml, pacc, out, st); return true;
    default: return false;
  }
}

}  // namespace

// cache_kind: 0 = f32, 1 = bf16, 2 = int8 (k_scale / v_scale required).
// layer_off / scale_layer_off: element offsets of the chosen layer in a
// stacked cache (0 for an unstacked one). fk / fv may be null. The cache
// splits into nsplit runs of `chunk` slots (nsplit * chunk >= S); pml
// (B*Hkv*nsplit*G*2 floats) and pacc (B*Hkv*nsplit*G*hd floats) are the
// caller's scratch for the splits' states.
// Returns cudaGetLastError() after the launches.
extern "C" int attn_launch(const void* q, const void* k, const void* v,
                           int cache_kind, long long layer_off,
                           const void* ks, const void* vs,
                           long long scale_layer_off, const void* fk,
                           const void* fv, const void* lens, int B, int S,
                           int H, int Hkv, int hd, float sm_scale, int nsplit,
                           int chunk, void* pml, void* pacc, void* out,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H % Hkv || H / Hkv > MAXG || nsplit < 1 || (long long)nsplit * chunk < S)
    return (int)cudaErrorInvalidValue;
  bool ok;
  if (cache_kind == 0)
    ok = launch<float>(q, k, v, layer_off, ks, vs, scale_layer_off, fk, fv,
                       lens, B, S, H, Hkv, hd, sm_scale, nsplit, chunk, pml,
                       pacc, out, st);
  else if (cache_kind == 1)
    ok = launch<__nv_bfloat16>(q, k, v, layer_off, ks, vs, scale_layer_off,
                               fk, fv, lens, B, S, H, Hkv, hd, sm_scale,
                               nsplit, chunk, pml, pacc, out, st);
  else if (cache_kind == 2 && ks != nullptr && vs != nullptr)
    ok = launch<int8_t>(q, k, v, layer_off, ks, vs, scale_layer_off, fk, fv,
                        lens, B, S, H, Hkv, hd, sm_scale, nsplit, chunk, pml,
                        pacc, out, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
