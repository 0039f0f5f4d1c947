// Single-token decode attention off the KV cache, in two modes of one
// kernel body (attn_tile; kernels attnp_tile and attnd_tile). int8 cache with per-token-head scales, or a
// bf16 / f32 cache.
//
// Partial mode: the unnormalised state over a cache shard whose slots
// carry global positions, the per-shard half of sequence-parallel decode.
// Replaces gptq_tpu/ops/attention.py:_attn_partial_wide_kernel
// (decode_attention_partial_wide) and :_attn_partial_kernel
// (decode_attention_partial).
//
// Decode mode (DEC, entry attnd_launch, kernel attnd_tile): replaces
// gptq_tpu/ops/attention.py:_attn_kernel (decode_attention) and
// :_attn_kernel_wide (decode_attention_wide), which compute one function:
// the slots t < len[b] of each row (no pos words, no slopes), the fresh
// column (q . fresh_k, f32) merged by the cluster's rank 0 after the
// splits, then out = acc / l (zeros for a row with nothing to attend),
// in the same one launch. Bound: the filled slots' bytes over the memory
// rate (0.34 us at 128 int8 slots of llama-7B width): it is latency
// bound, as the partial mode, and takes the same design.
//
// Partial mode, in full. The two Pallas kernels compute one function
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
// Bound on an H100: the valid slots' cache bytes over the memory rate; at
// the shapes of sequence-parallel decode (a few MB a layer) what bounds it
// is latency: the dependent steps from the launch to the last store.
//
// Design: slot-parallel scores over tiles of listed slots staged in
// shared memory; at these sizes every step of the chain from launch to
// the last store is a latency, so the design keeps the chain short.
//   * a block of 8 warps (Cfg) per (batch row, kv head, group of gh
//     of its G query heads, split); the splits of one (row, kv head, head
//     group), at most 8, are one thread block cluster (the head groups and
//     splits give the card its blocks: ops/attention.partial_grid). Split
//     j takes the shard's 32-slot tiles j, j + nsplit, ... (a valid
//     stretch spreads over the splits), 16 at a time.
//   * the block reads those tiles' pos words (beside q, in one trip) and
//     compacts the valid slots into a list (warp ballots, slot order): a
//     slot with pos < 0 is neither loaded nor counted.
//   * the listed slots' K and V rows (16-byte cp.async vectors, rows padded
//     by 16 bytes so 8 lanes reading 8 rows hit 8 bank groups) and their
//     scales stream through a ring of compute tiles (32-128 slots: Cfg),
//     each issued a ring's depth ahead; one block barrier a tile.
//   * warp w owns head w % gp (gh rounded up to a power of two) and one
//     of warps / gp runs of each tile's slots, with its own online softmax
//     state: lanes score whole slots (or 2-32 lanes a slot, dims split,
//     where its run is short) against q in shared memory, so no score
//     needs a reduction across the warp; one max and one sum a tile (two
//     warp reductions); then P.V with lane l owning dims l * hd / 32 ..
//   * the runs' states merge in shared memory into the split's, and the
//     cluster's rank 0 merges the splits' states (read from the other
//     blocks' shared memory, in split order) into the outputs: one
//     launch, no global round trip, the same result whichever block ends
//     last. A state with m = -inf weighs 0.
// hd (64, 128 or 256) is a template constant; G <= 8 is a runtime value.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXG = 8;      // query heads per kv head
constexpr int TS = 32;       // slots of a shard tile (a warp's ballot)
constexpr int MAXA = 16;     // shard tiles a batch lists
constexpr int MAXV = MAXA * TS;
constexpr int MAXNS = 8;     // ring depth
constexpr int MAXSPLIT = 8;  // splits: a portable cluster
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (< MAXNS) of this thread's groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// 4 (2) consecutive elements of a staged row as floats
template <typename CT>
__device__ __forceinline__ float4 load4(const unsigned char* p) {
  float f[4];
  if constexpr (sizeof(CT) == 1) {
    widen(*reinterpret_cast<const uint32_t*>(p), f, CT());
  } else if constexpr (sizeof(CT) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    widen(w.x, f, CT());
    widen(w.y, f + 2, CT());
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
  return make_float4(f[0], f[1], f[2], f[3]);
}
template <typename CT>
__device__ __forceinline__ float2 load2(const unsigned char* p) {
  if constexpr (sizeof(CT) == 1) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    return make_float2((float)(int8_t)(w & 0xFF), (float)(int8_t)(w >> 8));
  } else if constexpr (sizeof(CT) == 2) {
    float f[2];
    widen(*reinterpret_cast<const uint32_t*>(p), f, CT());
    return make_float2(f[0], f[1]);
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}


// A launch's shape for a cache type and head dim: 8 warps (two blocks an
// SM), compute tiles of N listed slots whose K and V rows fit 36 KB (32,
// 64 or 128), a ring of tiles within 72 KB (at least two).
template <typename CT, int HD>
struct Cfg {
  static constexpr int WARPS = 8, THREADS = 32 * WARPS;
  static constexpr int RS = HD * sizeof(CT) + 16;  // a staged row's bytes
  static constexpr int FIT = 36 * 1024 / (2 * RS);
  static constexpr int N = FIT >= 128 ? 128 : FIT >= 64 ? 64 : 32;
  static constexpr int BYTES = 2 * N * RS + 2 * N * 4;  // rows, scales
  static constexpr int RING = 72 * 1024;
};

// DEC (decode_attention, #2 / #3): the valid slots are t < lens[b]
// (no pos words, no slopes), and rank 0 merges the fresh column (fk / fv,
// null without it) into the splits' state and writes the normalised
// output to acc_out (m_out / l_out unused).
template <typename CT, int HD, bool DEC>
__device__ __forceinline__ void
attn_tile(const float* __restrict__ q, const CT* __restrict__ kc,
           const CT* __restrict__ vc, const float* __restrict__ ksc,
           const float* __restrict__ vsc, const int* __restrict__ pos,
           const float* __restrict__ slopes, int S, int H, int Hkv, int gh,
           float sm_scale, int ns, float* __restrict__ m_out,
           float* __restrict__ l_out, float* __restrict__ acc_out,
           const int* __restrict__ lens, const float* __restrict__ fk,
           const float* __restrict__ fv) {
  using T = Cfg<CT, HD>;
  constexpr int RS = T::RS, N = T::N, ND = HD / 32;
  constexpr int WARPS = T::WARPS, THREADS = T::THREADS;
  __shared__ __align__(16) float s_q[MAXG * HD];
  __shared__ int s_idx[MAXV];
  __shared__ float s_pos[MAXV];
  __shared__ float s_p[WARPS][N];  // a warp's p * vs of a tile
  __shared__ float s_wm[WARPS], s_wl[WARPS];
  __shared__ __align__(16) float s_wacc[WARPS][HD];
  // this split's state, which rank 0 of the cluster reads
  __shared__ float s_m[MAXG], s_l[MAXG];
  __shared__ __align__(16) float s_acc[MAXG * HD];
  __shared__ float s_slope[MAXG];
  __shared__ float s_sf[MAXG];  // DEC: the fresh column's scores
  __shared__ __align__(16) float s_fk[DEC ? HD : 1], s_fv[DEC ? HD : 1];
  __shared__ int s_cnt[MAXA];
  extern __shared__ __align__(16) unsigned char ring[];

  const int ngrp = H / Hkv / gh;  // head groups a kv head
  const int bh = blockIdx.x / ngrp;  // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int hq0 = h * (H / Hkv) + (blockIdx.x - bh * ngrp) * gh;  // 1st head
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int G = gh;  // the block's query heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if constexpr (DEC) {
    // q (unscaled: sm_scale goes on the scores) and split 0's fresh pair
    // come in by cp.async, in one group ahead of the tiles', so their trip
    // overlaps the cache rows'
    const float* qb = q + ((size_t)b * H + hq0) * HD;
    for (int i = 4 * tid; i < G * HD; i += 4 * THREADS)
      cp_async16(s_q + i, qb + i);
    if (split == 0 && fk != nullptr)
      for (int i = 4 * tid; i < 2 * HD; i += 4 * THREADS) {
        const float* f = (i < HD ? fk : fv) + ((size_t)b * Hkv + h) * HD;
        cp_async16((i < HD ? s_fk : s_fv) + i % HD, f + i % HD);
      }
    cp_commit();
  } else {
    for (int i = tid; i < G * HD; i += THREADS)
      s_q[i] = q[((size_t)b * H + hq0) * HD + i] * sm_scale;
  }
  if (tid < G) s_slope[tid] = slopes != nullptr ? slopes[hq0 + tid] : 0.f;
  // the valid slots: pos[t] >= 0, or (DEC) t < len
  const int len = DEC ? min(max(lens[b], 0), S) : S;
  const float qs = DEC ? sm_scale : 1.f;  // the scale still on the scores

  const size_t rs = (size_t)Hkv * HD;  // elements between two slots' rows
  const CT* kb = kc + ((size_t)b * S * Hkv + h) * HD;
  const CT* vb = vc + ((size_t)b * S * Hkv + h) * HD;
  const float* ksb = ksc != nullptr ? ksc + (size_t)b * S * Hkv + h : nullptr;
  const float* vsb = vsc != nullptr ? vsc + (size_t)b * S * Hkv + h : nullptr;
  constexpr int VR = HD * sizeof(CT) / 16;  // 16-byte vectors a row

  // warp w: head g = w % gp and the sub-th of nsub = WARPS / gp runs of each
  // tile's slots (gp: G up to a power of two), with its own online state;
  // lane l owns dims l * ND .. l * ND + ND - 1 of its P.V
  const int gp = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  const int nsub = WARPS / gp, g = warp % gp, sub = warp / gp;
  const bool live = g < G;
  const float* qg = s_q + g * HD;
  float* sp = s_p[warp];
  float m_run = -INFINITY, l_run = 0.f, acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  // the split's shard tiles, 16 a batch
  const int nt = (len + TS - 1) / TS;
  const int na = split < nt ? (nt - 1 - split) / nsplit + 1 : 0;
  for (int a0 = 0; a0 < na; a0 += MAXA) {
    // the batch's pos words, then its valid slots in slot order
    int pv[MAXA / WARPS];
#pragma unroll
    for (int r = 0; r < MAXA / WARPS; ++r) {
      const int a = a0 + r * WARPS + warp;
      const int t = (split + a * nsplit) * TS + lane;
      pv[r] = a >= na || t >= len ? -1 : DEC ? t : pos[t];
    }
    unsigned mask[MAXA / WARPS];
#pragma unroll
    for (int r = 0; r < MAXA / WARPS; ++r) {
      mask[r] = __ballot_sync(FULL, pv[r] >= 0);
      if (lane == 0) s_cnt[r * WARPS + warp] = __popc(mask[r]);
    }
    __syncthreads();  // also: the last batch's tiles are consumed
    int nv = 0, off[MAXA / WARPS];  // list offsets of this warp's tiles
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      if (a % WARPS == warp) off[a / WARPS] = nv;
      nv += s_cnt[a];
    }
#pragma unroll
    for (int r = 0; r < MAXA / WARPS; ++r)
      if (pv[r] >= 0) {
        const int i = off[r] + __popc(mask[r] & ((1u << lane) - 1u));
        s_idx[i] = (split + (a0 + r * WARPS + warp) * nsplit) * TS + lane;
        s_pos[i] = (float)pv[r];
      }
    __syncthreads();

    const int ntile = (nv + N - 1) / N;
    // tile u's copies into ring slot u % ns: K rows, V rows, k / v scales
    auto issue = [&](int u) {
      if (u < ntile) {
        unsigned char* st = ring + (u % ns) * T::BYTES;
        for (int i = tid; i < 2 * N * VR; i += THREADS) {
          const int kv = i / (N * VR), r = (i / VR) % N, v = i % VR;
          const int li = u * N + r;
          if (li < nv) {
            const CT* src = (kv ? vb : kb) + (size_t)s_idx[li] * rs;
            cp_async16(st + (kv * N + r) * RS + v * 16,
                       reinterpret_cast<const unsigned char*>(src) + v * 16);
          }
        }
        for (int i = tid; ksb != nullptr && i < 2 * N; i += THREADS) {
          const int kv = i / N, r = i % N, li = u * N + r;
          if (li < nv)
            cp_async4(st + 2 * N * RS + (kv * N + r) * 4,
                      (kv ? vsb : ksb) + (size_t)s_idx[li] * Hkv);
        }
      }
      cp_commit();  // one group a tile, empty or not
    };
    for (int u = 0; u < ns - 1; ++u) issue(u);

    for (int u = 0; u < ntile; ++u) {
      cp_wait(ns - 2);  // tile u's group is done
      __syncthreads();  // its copies landed; tile u - 1 is consumed
      issue(u + ns - 1);
      if (!live) continue;
      const unsigned char* st = ring + (u % ns) * T::BYTES;
      const float* sk = reinterpret_cast<const float*>(st + 2 * N * RS);
      const int n = min(N, nv - u * N);  // valid slots of the tile
      const int run = (n + nsub - 1) / nsub, r0 = sub * run;
      const int mine = max(0, min(run, n - r0));  // my slots r0 .. r0 + mine
      if (mine == 0) continue;  // warp-uniform
      // lps lanes a slot split its 16-byte vectors (a power of two, at
      // most the row's vectors), so a warp's lanes cover its run
      int lps = 1;
      while (lps < 32 && mine * lps * 2 <= 32 &&
             32 * lps <= HD * (int)sizeof(CT))
        lps <<= 1;
      const int per = 32 / lps;  // slots a warp pass
      const int part = lane % lps;
      float mx = -INFINITY;
      float sv[N / 32];
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
        sv[j] = -INFINITY;
        if (per * j >= mine) continue;  // warp-uniform
        const int k = lane / lps + per * j;  // my k-th slot
        float sc = 0.f;
        if (k < mine)
          sc = row_dot<CT>(qg, st + (r0 + k) * RS, HD, part, lps);
        for (int o = 1; o < lps; o <<= 1) sc += __shfl_xor_sync(FULL, sc, o);
        if (k < mine)
          sv[j] = sc * (ksb != nullptr ? sk[r0 + k] : 1.f) * qs +
                  s_slope[g] * s_pos[u * N + r0 + k];
        mx = fmaxf(mx, sv[j]);
      }
      const float m_new = fmaxf(m_run, warp_max(mx));  // finite: mine >= 1
      const float alpha = __expf(m_run - m_new);       // 0 while m = -inf
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
        if (per * j >= mine) continue;
        const int k = lane / lps + per * j;
        if (k < mine && part == 0) {
          const float p = __expf(sv[j] - m_new);
          ps += p;
          sp[k] = p * (vsb != nullptr ? sk[N + r0 + k] : 1.f);
        }
      }
      l_run = l_run * alpha + warp_sum(ps);
      m_run = m_new;
      __syncwarp();
      // P.V over my run: this lane's ND dims
      float a[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) a[i] = 0.f;
      const unsigned char* vrow =
          st + N * RS + r0 * RS + lane * ND * sizeof(CT);
#pragma unroll 4
      for (int k = 0; k < mine; ++k) {
        const float pk = sp[k];
        const unsigned char* vr = vrow + k * RS;
        if constexpr (ND == 2) {
          const float2 vv = load2<CT>(vr);
          a[0] += pk * vv.x;
          a[1] += pk * vv.y;
        } else {
#pragma unroll
          for (int i = 0; i < ND; i += 4) {
            const float4 vv = load4<CT>(vr + i * sizeof(CT));
            a[i] += pk * vv.x;
            a[i + 1] += pk * vv.y;
            a[i + 2] += pk * vv.z;
            a[i + 3] += pk * vv.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = acc[i] * alpha + a[i];
      __syncwarp();  // sp is read before the next tile writes it
    }
  }

  if constexpr (DEC) {  // q . fresh k (q, fk: in smem once waited for)
    cp_wait(0);
    __syncthreads();
    if (split == 0 && fk != nullptr && warp < G) {
      float d = 0.f;
      for (int i = lane; i < HD; i += 32) d += s_q[warp * HD + i] * s_fk[i];
      d = warp_sum(d);
      if (lane == 0) s_sf[warp] = d * sm_scale;
    }
  }
  // the runs' states of each head merge (run order) into this split's
  if (lane == 0) {
    s_wm[warp] = live ? m_run : -INFINITY;
    s_wl[warp] = l_run;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) s_wacc[warp][lane * ND + i] = acc[i];
  __syncthreads();
  for (int it = tid; it < G * HD; it += THREADS) {
    const int hg = it / HD, d = it - hg * HD;
    float M = -INFINITY;
    for (int k = 0; k < nsub; ++k) M = fmaxf(M, s_wm[k * gp + hg]);
    float l = 0.f, v = 0.f;
    for (int k = 0; k < nsub; ++k) {
      const float e = rescale(s_wm[k * gp + hg], M);
      l += s_wl[k * gp + hg] * e;
      v += s_wacc[k * gp + hg][d] * e;
    }
    s_acc[it] = v;
    if (d == 0) {
      s_m[hg] = M;
      s_l[hg] = l;
    }
  }
  // the splits' states merge in the cluster's rank 0 (split order)
  cg::cluster_group cl = cg::this_cluster();
  if (nsplit > 1) cl.sync();  // every split's state is in its smem
  else __syncthreads();
  if (split == 0) {
    for (int it = tid; it < G * HD; it += THREADS) {
      const int hg = it / HD, d = it - hg * HD;
      float mk[MAXSPLIT], lk[MAXSPLIT], ak[MAXSPLIT];
      float M = -INFINITY;
#pragma unroll
      for (int k = 0; k < MAXSPLIT; ++k)  // all loads in flight at once
        if (k < nsplit) {
          mk[k] = *cl.map_shared_rank(s_m + hg, k);
          lk[k] = *cl.map_shared_rank(s_l + hg, k);
          ak[k] = *cl.map_shared_rank(s_acc + it, k);
          M = fmaxf(M, mk[k]);
        }
      float l = 0.f, v = 0.f;
#pragma unroll
      for (int k = 0; k < MAXSPLIT; ++k)
        if (k < nsplit) {
          const float e = rescale(mk[k], M);
          v += ak[k] * e;
          l += lk[k] * e;
        }
      const size_t row = (size_t)b * H + hq0 + hg;
      if constexpr (DEC) {  // the fresh column, then normalise
        if (fk != nullptr) {
          const float sf = s_sf[hg], M2 = fmaxf(M, sf);
          const float e = rescale(M, M2), ef = __expf(sf - M2);
          l = l * e + ef;
          v = v * e + ef * s_fv[d];
        }
        acc_out[row * HD + d] = l > 0.f ? v / l : 0.f;  // nothing: zeros
      } else {
        acc_out[row * HD + d] = v;
        if (d == 0) {
          m_out[row] = M;
          l_out[row] = l;
        }
      }
    }
  }
  if (nsplit > 1) cl.sync();  // rank 0 is done reading the others' smem
}

// the two modes as kernels of their own names (a profile tells them apart)
#define ATTN_KERNEL(NAME, DEC)                                               \
  template <typename CT, int HD>                                             \
  __global__ void __launch_bounds__(Cfg<CT, HD>::THREADS) NAME(              \
      const float* __restrict__ q, const CT* __restrict__ kc,                \
      const CT* __restrict__ vc, const float* __restrict__ ksc,              \
      const float* __restrict__ vsc, const int* __restrict__ pos,            \
      const float* __restrict__ slopes, int S, int H, int Hkv, int gh,       \
      float sm_scale, int ns, float* __restrict__ m_out,                     \
      float* __restrict__ l_out, float* __restrict__ acc_out,                \
      const int* __restrict__ lens, const float* __restrict__ fk,            \
      const float* __restrict__ fv) {                                        \
    attn_tile<CT, HD, DEC>(q, kc, vc, ksc, vsc, pos, slopes, S, H, Hkv, gh,  \
                           sm_scale, ns, m_out, l_out, acc_out, lens, fk,    \
                           fv);                                              \
  }
ATTN_KERNEL(attnp_tile, false)
ATTN_KERNEL(attnd_tile, true)
#undef ATTN_KERNEL

// the pointers of one launch (DEC: lens, fk, fv; else pos, slopes, m, l)
struct Ptrs {
  const void *q, *k, *v, *ks, *vs, *pos, *slopes, *lens, *fk, *fv;
  void *m, *l, *acc;
};

template <typename CT, int HD, bool DEC>
int launch_hd(const Ptrs& p, int B, int S, int H, int Hkv, int gh,
              float sm_scale, int nsplit, cudaStream_t st) {
  using T = Cfg<CT, HD>;
  auto kern = DEC ? attnd_tile<CT, HD> : attnp_tile<CT, HD>;
  static int room = 0;  // dynamic shared memory a block may take
  if (room == 0) {
    cudaFuncAttributes fa{};
    cudaFuncGetAttributes(&fa, kern);
    room = SMEM_LIMIT - (int)fa.sharedSizeBytes;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         room);  // a failure shows at the launch
  }
  // as many tiles as fit the ring, at least two
  int ns = (T::RING < room ? T::RING : room) / T::BYTES;
  ns = ns < 2 ? 2 : ns > MAXNS ? MAXNS : ns;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H / gh, nsplit);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = ns * T::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;  // the splits of one (row, kv head)
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, (const float*)p.q, (const CT*)p.k, (const CT*)p.v,
      (const float*)p.ks, (const float*)p.vs, (const int*)p.pos,
      (const float*)p.slopes, S, H, Hkv, gh, sm_scale, ns, (float*)p.m,
      (float*)p.l, (float*)p.acc, (const int*)p.lens, (const float*)p.fk,
      (const float*)p.fv);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool DEC>
int launch(const Ptrs& p, int cache_kind, int B, int S, int H, int Hkv,
           int gh, int hd, float sm_scale, int nsplit, cudaStream_t st) {
  if (Hkv < 1 || H % Hkv || H / Hkv > MAXG || gh < 1 || (H / Hkv) % gh ||
      nsplit < 1 || nsplit > MAXSPLIT || ((uintptr_t)p.k & 15) ||
      ((uintptr_t)p.v & 15) || (cache_kind == 2) != (p.ks != nullptr) ||
      (p.ks == nullptr) != (p.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto ct_tag, auto hd_tag) {
    using CT = decltype(ct_tag);
    constexpr int HD = decltype(hd_tag)::value;
    return launch_hd<CT, HD, DEC>(p, B, S, H, Hkv, gh, sm_scale, nsplit, st);
  };
  auto by_hd = [&](auto ct_tag) {
    switch (hd) {
      case 64: return go(ct_tag, std::integral_constant<int, 64>());
      case 128: return go(ct_tag, std::integral_constant<int, 128>());
      case 256: return go(ct_tag, std::integral_constant<int, 256>());
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (cache_kind) {
    case 0: return by_hd(float());
    case 1: return by_hd(__nv_bfloat16());
    case 2: return by_hd(int8_t());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cache_kind: 0 = f32, 1 = bf16, 2 = int8 (k_scale / v_scale required).
// k / v / ks / vs point at one layer's (B, S, Hkv[, hd]) planes, 16-byte
// aligned rows; slopes (H f32) may be null. A block takes gh of a kv
// head's G query heads (gh divides G); nsplit (1..8) splits of each
// (batch row, kv head, head group) form one cluster, split j reading the
// 32-slot shard tiles j, j + nsplit, ... Outputs: m, l (B*H floats) and
// acc (B*H*hd floats). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for what the kernel does not take, launching
// nothing).
extern "C" int attnp_launch(const void* q, const void* k, const void* v,
                            int cache_kind, const void* ks, const void* vs,
                            const void* pos, const void* slopes, int B, int S,
                            int H, int Hkv, int gh, int hd, float sm_scale,
                            int nsplit, void* m, void* l, void* acc,
                            void* stream) {
  const Ptrs p{q, k, v, ks, vs, pos, slopes, nullptr, nullptr, nullptr,
               m, l, acc};
  return launch<false>(p, cache_kind, B, S, H, Hkv, gh, hd, sm_scale, nsplit,
                       (cudaStream_t)stream);
}

// decode_attention (#2 / #3) on the same tiles: the slots t < lens[b]
// (B int32) of each row, the fresh column fk / fv ((B, Hkv, hd) f32, both
// null without it) merged by rank 0, out the normalised (B, H, hd) f32
// attention (zeros for a row with nothing to attend). Grid and returns as
// attnp_launch.
extern "C" int attnd_launch(const void* q, const void* k, const void* v,
                            int cache_kind, const void* ks, const void* vs,
                            const void* lens, const void* fk, const void* fv,
                            int B, int S, int H, int Hkv, int gh, int hd,
                            float sm_scale, int nsplit, void* out,
                            void* stream) {
  if ((fk == nullptr) != (fv == nullptr) || lens == nullptr)
    return (int)cudaErrorInvalidValue;
  const Ptrs p{q, k, v, ks, vs, nullptr, nullptr, lens, fk, fv,
               nullptr, nullptr, out};
  return launch<true>(p, cache_kind, B, S, H, Hkv, gh, hd, sm_scale, nsplit,
                      (cudaStream_t)stream);
}
