// Partial (unnormalised) single-token decode attention over a KV-cache
// shard whose slots carry global positions: the per-shard half of
// sequence-parallel decode. int8 cache with per-token-head scales, or a
// bf16 / f32 cache.
//
// Replaces gptq_tpu/ops/attention.py:_attn_partial_wide_kernel
// (decode_attention_partial_wide) and :_attn_partial_kernel
// (decode_attention_partial). The two Pallas kernels compute one function
// (the wide one only lays the heads out for the MXU and rounds its
// operands to bf16), so one kernel ports both, in f32. For query head hq
// of batch row b, with kv head h = hq / G (GQA), over the slots t with
// pos[t] >= 0:
//
//     s_t = sm_scale * ks[b, t, h] * (q[b, hq] . k[b, t, h])
//           [+ slope[hq] * pos[t]]                       (alibi, HF BLOOM)
//     m   = max_t s_t
//     l   = sum_t exp(s_t - m)
//     acc = sum_t exp(s_t - m) * vs[b, t, h] * v[b, t, h]
//
// and nothing is divided by l: the caller merges the fresh token and the
// other shards' states exactly (parallel/sp.py). A row with no valid slot
// gives m = -inf, l = 0, acc = 0. The caller hands in the chosen layer of
// a stacked cache as a base pointer (a view, no copy).
//
// Design: the split-and-combine of attention.cu, masked by content.
//   * attnp_split: a block per (batch row, kv head, split of `chunk`
//     slots). Each of its 4 warps takes whole slots, TB at a time: lane i
//     holds dims [i*ND, i*ND + ND) of q, so a warp reads one cache row with
//     one coalesced load. A slot with pos < 0 is neither loaded nor
//     counted, so an empty stretch of the shard costs only its pos words.
//     Each warp keeps its own online-softmax state for the G query heads
//     of the kv head; the 4 states merge in shared memory into the split's
//     (m, l, acc), written to scratch.
//   * attnp_combine: a warp per (batch row, query head) merges the
//     splits' states into the unnormalised (m, l, acc).
// A state with m = -inf has weight 0 in every merge (never exp(-inf + inf)).
// hd (64, 128 or 256) is a template constant; G <= 8 is a runtime value.
// Bound on an H100: the valid slots' cache bytes over the memory rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cache_row.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;  // query heads per kv head
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// weight of a state with max m in a merge whose max is M >= m
__device__ __forceinline__ float rescale(float m, float M) {
  return M == -INFINITY ? 0.f : __expf(m - M);
}

template <typename CT, int ND>  // ND = hd / 32 dims per lane
__global__ void __launch_bounds__(THREADS)
attnp_split(const float* __restrict__ q, const CT* __restrict__ kc,
            const CT* __restrict__ vc, const float* __restrict__ ksc,
            const float* __restrict__ vsc, const int* __restrict__ pos,
            const float* __restrict__ slopes, int S, int H, int Hkv,
            int chunk, float sm_scale, float* __restrict__ pml,
            float* __restrict__ pacc) {
  constexpr int hd = ND * 32;
  constexpr int TB = 32 / ND;  // slots a warp loads per round
  __shared__ float s_m[WARPS][MAXG], s_l[WARPS][MAXG];
  __shared__ float s_acc[WARPS][MAXG][hd];

  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int split = blockIdx.y;
  const int G = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = split * chunk;
  const int c1 = min(S, c0 + chunk);

  float qr[MAXG][ND], acc[MAXG][ND], m[MAXG], l[MAXG], slope[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    slope[g] = (slopes != nullptr && g < G) ? slopes[h * G + g] : 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < G ? q[((size_t)b * H + (size_t)h * G + g) * hd + lane * ND + i] * sm_scale
                       : 0.f;
    }
  }

  const size_t rs = (size_t)Hkv * hd;  // elements between two slots' rows
  const CT* kb = kc + ((size_t)b * S * Hkv + h) * hd;
  const CT* vb = vc + ((size_t)b * S * Hkv + h) * hd;
  const float* ksb = ksc != nullptr ? ksc + (size_t)b * S * Hkv + h : nullptr;
  const float* vsb = vsc != nullptr ? vsc + (size_t)b * S * Hkv + h : nullptr;

  for (int t0 = c0 + warp * TB; t0 < c1; t0 += WARPS * TB) {
    float kr[TB][ND], vr[TB][ND], kscl[TB], vscl[TB], kpos[TB];
    bool ok[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int t = t0 + j;
      const int p = t < c1 ? pos[t] : -1;
      ok[j] = p >= 0;
      kpos[j] = (float)max(p, 0);
      if (ok[j]) {
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
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < ND; ++i) dot += qr[g][i] * kr[j][i];
        dot = warp_sum(dot);
        s[j] = ok[j] ? dot * kscl[j] + slope[g] * kpos[j] : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[g], mx);
      if (m_new == -INFINITY) continue;  // no valid slot yet (warp-uniform)
      const float alpha = __expf(m[g] - m_new);  // 0 while m[g] = -inf
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const float p = ok[j] ? __expf(s[j] - m_new) : 0.f;
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
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = rescale(s_m[w][g], M);
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
attnp_combine(const float* __restrict__ pml, const float* __restrict__ pacc,
              int B, int H, int Hkv, int nsplit, float* __restrict__ m_out,
              float* __restrict__ l_out, float* __restrict__ acc_out) {
  constexpr int hd = ND * 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);  // b * H + hq
  if (row >= B * H) return;  // whole warps leave together
  const int b = row / H;
  const int hq = row - b * H;
  const int G = H / Hkv;
  const int h = hq / G;
  const int g = hq - h * G;
  const size_t o0 = ((size_t)b * Hkv + h) * nsplit * G + g;  // split s at o0 + s * G

  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pml[2 * (o0 + (size_t)s * G)]);
  float l = 0.f, a[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) a[i] = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t o = o0 + (size_t)s * G;
    const float e = rescale(pml[2 * o], M);
    l += pml[2 * o + 1] * e;
#pragma unroll
    for (int i = 0; i < ND; ++i) a[i] += pacc[o * hd + lane * ND + i] * e;
  }
  if (lane == 0) {
    m_out[row] = M;
    l_out[row] = l;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) acc_out[(size_t)row * hd + lane * ND + i] = a[i];
}

template <typename CT, int ND>
void launch_nd(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* pos, const void* slopes, int B,
               int S, int H, int Hkv, float sm_scale, int nsplit, int chunk,
               void* pml, void* pacc, void* m, void* l, void* acc,
               cudaStream_t st) {
  attnp_split<CT, ND><<<dim3(B * Hkv, nsplit), THREADS, 0, st>>>(
      (const float*)q, (const CT*)k, (const CT*)v, (const float*)ks,
      (const float*)vs, (const int*)pos, (const float*)slopes, S, H, Hkv,
      chunk, sm_scale, (float*)pml, (float*)pacc);
  attnp_combine<ND><<<(B * H + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const float*)pml, (const float*)pacc, B, H, Hkv, nsplit, (float*)m,
      (float*)l, (float*)acc);
}

template <typename CT>
bool launch(const void* q, const void* k, const void* v, const void* ks,
            const void* vs, const void* pos, const void* slopes, int B, int S,
            int H, int Hkv, int hd, float sm_scale, int nsplit, int chunk,
            void* pml, void* pacc, void* m, void* l, void* acc,
            cudaStream_t st) {
  switch (hd) {
    case 64: launch_nd<CT, 2>(q, k, v, ks, vs, pos, slopes, B, S, H, Hkv, sm_scale, nsplit, chunk, pml, pacc, m, l, acc, st); return true;
    case 128: launch_nd<CT, 4>(q, k, v, ks, vs, pos, slopes, B, S, H, Hkv, sm_scale, nsplit, chunk, pml, pacc, m, l, acc, st); return true;
    case 256: launch_nd<CT, 8>(q, k, v, ks, vs, pos, slopes, B, S, H, Hkv, sm_scale, nsplit, chunk, pml, pacc, m, l, acc, st); return true;
    default: return false;
  }
}

}  // namespace

// cache_kind: 0 = f32, 1 = bf16, 2 = int8 (k_scale / v_scale required).
// k / v / ks / vs point at one layer's (B, S, Hkv[, hd]) planes; slopes
// (H f32) may be null. The cache splits into nsplit runs of `chunk` slots
// (nsplit * chunk >= S); pml (B*Hkv*nsplit*G*2 floats) and pacc
// (B*Hkv*nsplit*G*hd floats) are the caller's scratch for the splits'
// states. Outputs: m, l (B*H floats) and acc (B*H*hd floats).
// Returns cudaGetLastError() after the launches.
extern "C" int attnp_launch(const void* q, const void* k, const void* v,
                            int cache_kind, const void* ks, const void* vs,
                            const void* pos, const void* slopes, int B, int S,
                            int H, int Hkv, int hd, float sm_scale,
                            int nsplit, int chunk, void* pml, void* pacc,
                            void* m, void* l, void* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H % Hkv || H / Hkv > MAXG || nsplit < 1 || (long long)nsplit * chunk < S)
    return (int)cudaErrorInvalidValue;
  bool ok;
  if (cache_kind == 0)
    ok = launch<float>(q, k, v, ks, vs, pos, slopes, B, S, H, Hkv, hd,
                       sm_scale, nsplit, chunk, pml, pacc, m, l, acc, st);
  else if (cache_kind == 1)
    ok = launch<__nv_bfloat16>(q, k, v, ks, vs, pos, slopes, B, S, H, Hkv, hd,
                               sm_scale, nsplit, chunk, pml, pacc, m, l, acc,
                               st);
  else if (cache_kind == 2 && ks != nullptr && vs != nullptr)
    ok = launch<int8_t>(q, k, v, ks, vs, pos, slopes, B, S, H, Hkv, hd,
                        sm_scale, nsplit, chunk, pml, pacc, m, l, acc, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
