#!/usr/bin/env python3
"""Smoke run of gptq_tpu_torch (the PyTorch / CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one GPU

Phases, in order (any failure exits non-zero; there is no CPU fallback):
  1. build   - nvcc builds the eight kernel libraries from csrc/ (qmatmul,
               attention, ffn, bcq_matmul, qstream, qexpert, layer_fused,
               attention_partial; in parallel).
  2. kernels - each kernel's wrapper against its plain PyTorch version on
               the card at llama-7B shapes, with stated tolerances, and
               timed beside its plain version, a one-call PyTorch
               yardstick (or, for the fused kernels, the unfused route of
               the same function) and the card's bound. The fused
               kernels' BCQ branch (3-bit sign planes, g-1 and g128, M 1
               and 32, a8 and a16) the same way, with the near-tie rule,
               its unfused route being the norm and #13. The BCQ kernel
               (#13) and the streamed qmm (#7, GPTQ_TPU_MATMUL_IMPL=
               streamed) are held the same way; #7 is also timed beside
               kernel #1 on the same weight. The expert kernels: #8 (the
               batched bank) and #9 (the select, index in device memory)
               at Mixtral-8x7B shapes. The whole-layer kernel (#12) at
               llama-7B width, a8 and a16, on bf16 caches of 256 and 2048
               slots and an f32 one, with the near-tie rule of
               tests/test_torch_ffn.py, its cache write bit for bit, timed
               beside its plain version and the fused route's launches
               over the same layer. The partial-attention kernel (#10 /
               #11, one kernel) on stacked caches of 2048 local slots with
               1,100 valid: llama-7B (int8, bf16, f32), Mixtral GQA 4
               (with and without alibi slopes), TinyLlama-1.1B (hd 64) and
               a BLOOM-style G = 1 case with slopes, each timed beside its
               plain version and SDPA over the dequantized cache. The
               shared int8 quantizer on rows of exact .5 ties: the card's
               codes equal the CPU's bit for bit.
  3. quantize - GPTQ (4-bit, groupsize 128, act-order, static groups,
               true-sequential) of a 2-layer llama-7B-width model from
               seeded weights on 16 x 512 synthetic tokens, pack, a
               save / load round trip, and the PPL of the packed model
               (through the qmm kernel) against the dequantized dense
               model. Then the BCQ path: GPTQ `lut` mode (3-bit,
               groupsize 128, APoT alphas, true-sequential) of another
               2-layer model, pack to sign planes, save / load, PPL through
               the BCQ kernel against its dequantized dense twin, and
               greedy tokens of kernel against plain decoding; and the
               time of one whole-weight `--bcq` layer.
  4. serve   - a 32-layer llama-7B-width 4-bit packed checkpoint from
               seeded codes, served through `gptq_tpu_torch.cli`
               (--benchmark 128 --faster-kernel --int8_kv --quant_lm_head 8)
               on the fused route (the default on the card), again on the
               unfused route (GPTQ_TPU_FFN_FUSION=off, without the head
               flag), and through DecodeEngine.generate (4 requests of
               64 + 64 tokens); a 2-layer model whose o projection is
               act-order takes the ffn_fused route. Each run's launch
               counters must rise by the expected amounts; a profile gives
               each route's device time per step; at 2 layers, kernel
               decoding and plain decoding give the same greedy tokens on
               each route. Then a 32-layer 3-bit g128 BCQ checkpoint from
               seeded signs and alphas through the same CLI (128
               bcq_matmul + 32 attention launches per step, no qmm, no
               fused kernel) with its profile, a 2-layer 4-bit serve on
               the streamed route (GPTQ_TPU_FFN_FUSION=off,
               GPTQ_TPU_MATMUL_IMPL=streamed: 8 streamed launches per
               step, no qmm) with kernel-vs-plain greedy tokens, and the
               CLI's --lut_bench table. The whole-layer route: the same
               32-layer checkpoint with GPTQ_TPU_LAYER_FUSION=on and a bf16
               cache (per step 32 layer launches and the head's norm_qkv,
               nothing else) with its profile, and 2-layer greedy tokens
               against the plain versions and the fused route on the same
               cache; the CLI's --benchmark_batch 4 (generate_chained);
               the chained protocol (benchmark_decode_chained, one CUDA
               graph per chain) on 32 layers of the layer route and of the
               fused route, and 2-layer generate_chained tokens against
               generate on each.
  5. sp      - sequence-parallel serving (engine/serving.SPEngine) on a
               one-rank NCCL process group: the serve phase's 32-layer
               checkpoint at sp = 1 (fused, a8, 8-bit head, int8 cache,
               max_len 2048): per step 32 partial-wide (#10) launches, 33
               norm_qkv, 32 attn_mlp and no flat attention or #12; the
               per-token median over 128 tokens, benchmark_chained (one
               CUDA graph per chain, the all-reduces captured inside) and
               a profile; a 1,024-token prompt through the ring prefill
               and 64 decoded tokens; 2 layers on a bf16 cache at that
               width and at TinyLlama-1.1B width (hd 64: #11): greedy
               tokens against the plain versions, and the logits against
               DecodeEngine's flat decode at the prefill and 16 teacher-
               forced steps, a limit that a planted fault (the fresh
               pair left out of the combine) must exceed. Greedy checks
               part only at an exact tie of the plain version's logits
               (greedy_check's tie rule).
  6. moe     - Mixtral-8x7B width (spec_from_hf_config of its published
               config): GPTQ of a 1-layer model (attention linears, then
               gptq_quantize_experts), pack_model + pack_experts, save /
               load, PPL through #1 (512-row windows) against the dense
               twin; an 8-layer 4-bit checkpoint from seeded codes served
               through the CLI (--faster-kernel --int8_kv --quant_lm_head
               8: per step 6L select, L qmm, L+1 norm_qkv, L attention
               launches) with its profile; 2-layer requests of 16 / 32
               tokens (prefill through #8) and 48 (per-expert #1), greedy
               tokens against the plain versions; one layer's decode FFN
               under torch.cuda.set_sync_debug_mode("error"); and the
               whole 32-layer model (~23.6 GB) through
               engine.decode.benchmark_decode, with its profile and byte
               bound.
  7. cli     - quantize from a model directory through
               gptq_tpu_torch.cli: a 2-layer LLaMA-7B-width HF directory
               written here (config.json and an F16 model.safetensors
               from a seed, 1.24 GiB), the tokenizer and `datasets`
               stood in by seeded synthetic text; w4 g128 act-order
               true-sequential with the 8-bit head (--eval_pack --save),
               then --lut_eval 3-bit g128: each run's stage times, its
               PPL evals' launches (#1, then #13; exact counts) and its
               wikitext2 PPL against the dense twin of its saved file;
               then the saved w4 file served through the CLI.
Then one JSON line {"kernels": [...]}, and last {"ok": true, "device": ...}.

Imports nothing of JAX or of the JAX package. Exits non-zero, printing no
result, when no CUDA device is available or when run outside the repo.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

PHASES = ("build", "kernels", "quantize", "serve", "sp", "moe", "cli")
QMM_SRC = "gptq_tpu_torch/csrc/qmatmul.cu"
ATTN_SRC = "gptq_tpu_torch/csrc/attention.cu"
FFN_SRC = "gptq_tpu_torch/csrc/ffn.cu"
BCQ_SRC = "gptq_tpu_torch/csrc/bcq_matmul.cu"
STREAM_SRC = "gptq_tpu_torch/csrc/qstream.cu"
MOE_SRC = "gptq_tpu_torch/csrc/qexpert.cu"
LAYER_SRC = "gptq_tpu_torch/csrc/layer_fused.cu"
PARTIAL_SRC = "gptq_tpu_torch/csrc/attention_partial.cu"
# a8 qmm: exact int32 dot, f32 epilogue order differs; a16: f32 sums of
# bf16 x times codes in another order; attention: f32 math, other order;
# fused kernels (relative to max|plain|): they round to bf16 (and, a8,
# int8) between phases, so an element whose f32 sum lands near a rounding
# boundary can come out one step apart (the largest sound reading on an
# H100 was 1.25e-3, attn_mlp M=32 a8). Where the down phase's output
# dwarfs the residual r2, this limit cannot see r2: residual_check holds
# r2 on its own.
# The BCQ kernel (#13) and the streamed qmm (#7) are held like qmm: f32
# (a8: exact int32 partials at M = 1) sums in another order.
# partial attention (#10 / #11): f32 math in another order; l and acc grow
# with the valid slots (up to ~1e3 here), so the limit is relative:
# |got - plain| <= 1e-3 * (1 + |plain|), m compared where l > 0.
# logits_a8: whole-model a8 logits of two decode routes that differ only
# in summation order (the SP decode against the flat one), relative to
# max |logit|: int8 activation ties flip, as in the fused route's logits
# against gptq_tpu (tests/test_torch_fused_serving.py, a8: 1.6e-2); the
# logits are bf16 (one ulp ~ 4e-3 of max there). sp_vs_flat shows that a
# planted fault in the combine reads above it.
TOL = {"qmm_a8": 1e-4, "qmm_a16": 2e-3, "attn": 1e-3, "fused": 3e-3,
       "partial": 1e-3, "logits_a8": 1.6e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> dict:
    """Data-sheet memory rate (B/s) and dense peaks (op/s) of the card."""
    if "H200" in name:
        return {"bw": 4.8e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12}
    if "PCIe" in name:
        return {"bw": 2.0e12, "bf16": 756e12, "int8": 1513e12, "f32": 51e12}
    if "NVL" in name:
        return {"bw": 3.9e12, "bf16": 835e12, "int8": 1670e12, "f32": 60e12}
    return {"bw": 3.35e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def llama7b_spec(n_layers: int = 32):
    from gptq_tpu_torch.models.common import ArchSpec

    return ArchSpec(arch="llama", n_layers=n_layers, hidden=4096, n_heads=32,
                    n_kv_heads=32, ffn=11008, vocab=32000, max_pos=2048,
                    act="silu", pos="rope", norm_type="rmsnorm",
                    linear_bias=False, tie_embeddings=False)


def mixtral_spec(n_layers: int = 32):
    """Mixtral-8x7B's published config values through the port's
    spec_from_hf_config (expert capacity E / k = 4.0: dropless)."""
    from types import SimpleNamespace

    from gptq_tpu_torch.models.registry import spec_from_hf_config

    return spec_from_hf_config(SimpleNamespace(
        model_type="mixtral", hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=n_layers, num_attention_heads=32,
        num_key_value_heads=8, vocab_size=32000,
        max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-5,
        tie_word_embeddings=False, num_local_experts=8,
        num_experts_per_tok=2))


def random_words(gen, rows, cols, device):
    import torch

    w = torch.randint(0, 2**32, (rows, cols), generator=gen,
                      dtype=torch.int64, device=device)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def packed_linear(gen, K, N, bits, groupsize, device, perm=False):
    """Random packed weight of logical (K, N): stored dims padded like
    pack_quantized pads them, pad grids zero."""
    import torch

    from gptq_tpu_torch.ops.pack import FIELD_SPLITS, PackedWeight, pad_dim

    Kp, Np = pad_dim(K, groupsize), pad_dim(N)
    ng = 1 if groupsize <= 0 else Kp // groupsize
    words = tuple(random_words(gen, Kp // (32 // fb), Np, device)
                  for fb, _ in FIELD_SPLITS[bits])
    scale = torch.randn((ng, Np), generator=gen, device=device).abs() \
        * 0.002 + 0.01
    scale[:, N:] = 0
    zoff = scale * (2 ** (bits - 1))
    p = (torch.randperm(K, generator=gen, device=device).to(torch.int32)
         if perm else None)
    return PackedWeight(words=words, scale=scale, zoff=zoff, perm=p, bits=bits,
                        K=K, N=N, groupsize=groupsize)


def packed_bank(gen, E, K, N, bits, groupsize, device):
    """Random PackedExperts bank of E experts of logical (K, N), stored
    dims padded as pack_expert_stack pads them, pad grids zero."""
    import torch

    from gptq_tpu_torch.ops.pack import FIELD_SPLITS, PackedExperts, pad_dim

    Kp, Np = pad_dim(K, groupsize), pad_dim(N)
    ng = 1 if groupsize <= 0 else Kp // groupsize
    words = tuple(torch.stack([random_words(gen, Kp // (32 // fb), Np, device)
                               for _ in range(E)])
                  for fb, _ in FIELD_SPLITS[bits])
    scale = torch.randn((E, ng, Np), generator=gen, device=device).abs() \
        * 0.002 + 0.01
    scale[..., N:] = 0
    return PackedExperts(words=words, scale=scale, zoff=scale * (2 ** (bits - 1)),
                         bits=bits, K=K, N=N, groupsize=groupsize)


def synth_moe_params(spec, device, seed=0, bits=4):
    """Seeded random Mixtral params in the real serving format (the
    counterpart of the JAX package's bench.py:synth_moe_packed_params):
    packed attention linears, PackedExperts banks, f32 routers, a bf16
    embedding and norms, a dense bf16 lm_head."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, f, E = spec.hidden, spec.ffn, spec.n_experts
    kv = spec.kv_heads * spec.hd

    def lin(K, N):
        return {"w": packed_linear(gen, K, N, bits, -1, device), "b": None}

    def ones():
        return {"w": torch.ones(h, dtype=torch.bfloat16, device=device)}

    layers = []
    for _ in range(spec.n_layers):
        layers.append({
            "q": lin(h, h), "k": lin(h, kv), "v": lin(h, kv), "o": lin(h, h),
            "router": {"w": torch.randn((E, h), generator=gen, device=device)
                       * 0.02, "b": None},
            "experts": {"gate": packed_bank(gen, E, h, f, bits, -1, device),
                        "up": packed_bank(gen, E, h, f, bits, -1, device),
                        "down": packed_bank(gen, E, f, h, bits, -1, device)},
            "ln1": ones(), "ln2": ones()})
    emb = (torch.randn((spec.vocab, h), generator=gen, device=device)
           * 0.02).to(torch.bfloat16)
    return {"embed": {"tokens": emb}, "layers": layers, "final_ln": ones(),
            "lm_head": {"w": emb, "b": None}}


def bcq_linear(gen, K, N, bits, groupsize, device):
    """Random BCQ weight of logical (K, N) from seeded signs and alphas
    (the counterpart of the JAX package's kernel_bench.make_random_bcq),
    stored dims padded as pack_bcq pads them, pad alphas zero."""
    import torch

    from gptq_tpu_torch.ops.pack import PackedWeight, pad_dim

    Kp, Np = pad_dim(K, groupsize), pad_dim(N)
    ng = 1 if groupsize <= 0 else Kp // groupsize
    words = random_words(gen, bits * Kp // 32, Np, device).reshape(
        bits, Kp // 32, Np)
    alpha = torch.randn((ng, bits, Np), generator=gen, device=device).abs() \
        * 0.004 + 0.002
    alpha[:, :, N:] = 0
    return PackedWeight(words=(words,), alpha=alpha, bits=bits, K=K, N=N,
                        groupsize=groupsize, fmt="bcq")


def synth_packed_params(spec, device, bits=4, groupsize=-1, seed=0,
                        fmt="uniform"):
    """Seeded random packed llama params (the counterpart of the JAX
    package's bench.py:synth_packed_params): random codes (fmt="bcq":
    sign planes and alphas) in the real serving format, bf16 embedding /
    norms, a dense bf16 lm_head."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, f = spec.hidden, spec.ffn
    kv = spec.kv_heads * spec.hd
    make = bcq_linear if fmt == "bcq" else packed_linear

    def lin(K, N):
        return {"w": make(gen, K, N, bits, groupsize, device), "b": None}

    layers = []
    for _ in range(spec.n_layers):
        layers.append({
            "q": lin(h, h), "k": lin(h, kv), "v": lin(h, kv), "o": lin(h, h),
            "gate": lin(h, f), "up": lin(h, f), "down": lin(f, h),
            "ln1": {"w": torch.ones(h, dtype=torch.bfloat16, device=device)},
            "ln2": {"w": torch.ones(h, dtype=torch.bfloat16, device=device)},
        })
    emb = (torch.randn((spec.vocab, h), generator=gen, device=device)
           * 0.02).to(torch.bfloat16)
    return {"embed": {"tokens": emb}, "layers": layers,
            "final_ln": {"w": torch.ones(h, dtype=torch.bfloat16,
                                         device=device)},
            "lm_head": {"w": emb, "b": None}}


def device_ms(fn) -> float:
    """Median device time of fn() in ms: kernel_bench.time_fn's protocol
    (CUDA events, the L2 flushed before each call so weights stream from
    device memory as in decode, and a spin kernel holding the device while
    the host queues the call, so the events time the device work and not
    the host's launch overhead)."""
    from gptq_tpu_torch.ops.kernel_bench import time_fn

    return time_fn(fn).median_s * 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def qmm_checks(device, peaks, timer, report):
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    shapes = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096)]
    weights = []
    for K, N in shapes:
        weights.append(("w4g-1", packed_linear(gen, K, N, 4, -1, device)))
        weights.append(("w4g128p", packed_linear(gen, K, N, 4, 128, device,
                                                 perm=True)))
    weights.append(("w3g128p", packed_linear(gen, 4096, 4096, 3, 128, device,
                                             perm=True)))
    weights.append(("w8g-1", packed_linear(gen, 4096, 4096, 8, -1, device)))
    rows = []
    worst = 0.0
    modes = (("a16", torch.bfloat16), ("a16", torch.float32),
             ("a8", torch.float32))
    for tag, pw in weights:
        for M in (1, 2048):
            x32 = torch.randn((M, pw.K), generator=gen, device=device)
            for act, xdt in modes:
                a8 = act == "a8"
                x = x32.to(xdt)
                got = Q.dequant_matmul(x, pw, a8=a8).float()
                want = Q.dequant_matmul_reference(x, pw, a8=a8).float()
                torch.cuda.synchronize()
                diff = (got - want).abs()
                err = float(diff.max())
                rel = err / float(want.abs().max())
                tol = TOL["qmm_a8" if a8 else "qmm_a16"]
                # a bf16 output may also round the other way: one bf16 ulp
                ulp = 2.0**-7 * want.abs() if xdt == torch.bfloat16 else 0.0
                if not bool((diff <= tol * want.abs().max() + ulp).all()):
                    raise AssertionError(
                        f"qmm {tag} K={pw.K} N={pw.N} M={M} {act} {xdt}: "
                        f"rel err {rel:.3g} > {tol}")
                if xdt == torch.float32:  # bf16 outputs add their rounding
                    worst = max(worst, err)
                row = {"w": tag, "K": pw.K, "N": pw.N, "M": M, "a8": a8,
                       "x": str(xdt).replace("torch.", ""),
                       "max_abs_err": err, "rel_err": rel}
                if (tag in ("w4g-1", "w4g128p") and xdt == torch.bfloat16
                        or (a8 and M == 1 and tag in ("w4g-1", "w4g128p"))):
                    row.update(matmul_times(
                        pw, x, a8, peaks, timer, kernel=Q._qmm_cuda,
                        prepare=Q._prepare, wrapper=Q.dequant_matmul,
                        plain=Q.dequant_matmul_reference, dense=Q.dequant))
                rows.append(row)
                log("qmm " + json.dumps(row))
    report["qmm_rows"] = rows
    report["qmm_max_abs_err"] = worst


def attn_checks(device, peaks, timer, report):
    import torch

    from gptq_tpu_torch.ops import attention as A

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    H, hd = 32, 128
    rows = []
    worst = 0.0
    for S in (256, 2048):
        for B in (1, 4):
            for Hkv in (32, 8):
                for cache in ("int8", "bf16"):
                    for stacked in (False, True):
                        lead = (2, B) if stacked else (B,)
                        q = torch.randn((B, H, hd), generator=gen,
                                        device=device)
                        if cache == "int8":
                            k = torch.randint(-127, 128, (*lead, S, Hkv, hd),
                                              generator=gen, device=device,
                                              dtype=torch.int8)
                            v = torch.randint(-127, 128, (*lead, S, Hkv, hd),
                                              generator=gen, device=device,
                                              dtype=torch.int8)
                            ks = torch.rand((*lead, S, Hkv), generator=gen,
                                            device=device) * 0.02 + 0.001
                            vs = torch.rand((*lead, S, Hkv), generator=gen,
                                            device=device) * 0.02 + 0.001
                        else:
                            k = torch.randn((*lead, S, Hkv, hd), generator=gen,
                                            device=device).to(torch.bfloat16)
                            v = torch.randn((*lead, S, Hkv, hd), generator=gen,
                                            device=device).to(torch.bfloat16)
                            ks = vs = None
                        fk = torch.randn((B, Hkv, hd), generator=gen,
                                         device=device)
                        fv = torch.randn((B, Hkv, hd), generator=gen,
                                         device=device)
                        lens = torch.randint(1, S + 1, (B,), generator=gen,
                                             device=device, dtype=torch.int32)
                        layer = 1 if stacked else None
                        kw = dict(k_scale=ks, v_scale=vs, fresh_k=fk,
                                  fresh_v=fv, layer=layer)
                        sm = 1.0 / math.sqrt(hd)
                        got = A.decode_attention(q, k, v, lens, sm, **kw)
                        want = A.decode_attention_reference(q, k, v, lens, sm,
                                                            **kw)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        if not err <= TOL["attn"]:
                            raise AssertionError(
                                f"attention S={S} B={B} Hkv={Hkv} {cache} "
                                f"stacked={stacked}: max abs err {err:.3g}")
                        worst = max(worst, err)
                        rows.append({"S": S, "B": B, "Hkv": Hkv,
                                     "cache": cache, "stacked": stacked,
                                     "max_abs_err": err})
    # a row of length 0 with no fresh pair attends to nothing: zeros
    q = torch.randn((2, H, hd), generator=gen, device=device)
    k = torch.randint(-127, 128, (2, 256, H, hd), generator=gen, device=device,
                      dtype=torch.int8)
    ks = torch.rand((2, 256, H), generator=gen, device=device) * 0.02
    lens = torch.tensor([0, 100], dtype=torch.int32, device=device)
    got = A.decode_attention(q, k, k, lens, 0.09, k_scale=ks, v_scale=ks)
    want = A.decode_attention_reference(q, k, k, lens, 0.09, k_scale=ks,
                                        v_scale=ks)
    torch.cuda.synchronize()
    if not (bool((got[0] == 0).all()) and bool(torch.isfinite(got).all())
            and float((got - want).abs().max()) <= TOL["attn"]):
        raise AssertionError("attention: a length-0 row without a fresh pair "
                             "must give zeros")
    rows.append({"S": 256, "B": 2, "lens": [0, 100], "fresh": False,
                 "max_abs_err": float((got - want).abs().max())})
    log(f"attention: {len(rows)} cases within {TOL['attn']} "
        f"(max abs err {worst:.3g}), length-0 row gives zeros")
    report["attn_rows"] = rows
    report["attn_max_abs_err"] = worst
    # timing at the serving shape: B = 1, llama-7B heads, int8 cache of the
    # CLI benchmark (max_len 256, 128 filled) and a long-context 2048 one
    times = []
    for S, length in ((256, 128), (2048, 2048)):
        times.append(attn_times(gen, device, peaks, timer, S, length))
        log("attention timing " + json.dumps(times[-1]))
    report["attn_times"] = times


def attn_times(gen, device, peaks, timer, S, length) -> dict:
    import torch

    from gptq_tpu_torch.ops import attention as A

    B, H, Hkv, hd = 1, 32, 32, 128
    q = torch.randn((B, H, hd), generator=gen, device=device)
    k = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                      device=device, dtype=torch.int8)
    v = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                      device=device, dtype=torch.int8)
    ks = torch.rand((B, S, Hkv), generator=gen, device=device) * 0.02
    vs = torch.rand((B, S, Hkv), generator=gen, device=device) * 0.02
    fk = torch.randn((B, Hkv, hd), generator=gen, device=device)
    fv = torch.randn((B, Hkv, hd), generator=gen, device=device)
    sm = 1.0 / math.sqrt(hd)
    kw = dict(k_scale=ks, v_scale=vs, fresh_k=fk, fresh_v=fv)
    ms = timer(lambda: A.decode_attention(q, k, v, length, sm, **kw))
    plain_ms = timer(lambda: A.decode_attention_reference(q, k, v, length, sm,
                                                          **kw))
    # yardstick: SDPA over the dequantized bf16 cache prefix + fresh row
    kd = torch.cat([k[:, :length].float() * ks[:, :length, :, None],
                    fk[:, None]], dim=1).to(torch.bfloat16).transpose(1, 2)
    vd = torch.cat([v[:, :length].float() * vs[:, :length, :, None],
                    fv[:, None]], dim=1).to(torch.bfloat16).transpose(1, 2)
    qd = q[:, :, None].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qd, kd, vd, scale=sm))
    nbytes = (length * Hkv * hd * 2 + length * Hkv * 4 * 2
              + (B * H * hd + 2 * B * Hkv * hd + B * H * hd) * 4 + B * 4)
    ops = 4 * B * H * (length + 1) * hd
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["f32"] * 1e3
    return {"S": S, "length": length, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tie_rows(n_rows=8, width=256, seed=0) -> np.ndarray:
    """f32 rows whose entries sit on exact .5 ties of x / (absmax / 127)
    in IEEE division, each row's absmax (its first entry) chosen so that
    absmax * fl(1 / 127) is one ulp off absmax / 127 (the rows of
    tests/test_torch_cuda.py tie_rows)."""
    f = np.float32
    rng = np.random.default_rng(seed)
    rows = []
    while len(rows) < n_rows:
        a = f(rng.uniform(1.0, 2.0))
        s = a / f(127)
        if s == a * (f(1) / f(127)):
            continue
        j = rng.integers(-126, 126, size=4 * width) + 0.5
        x = (j * s).astype(f)
        x = x[(x / s) == j.astype(f)][:width - 1]  # exact ties only
        if len(x) == width - 1:
            rows.append(np.concatenate([[a], x]).astype(f))
    return np.stack(rows)


def quant_tie_check(device, report):
    """The shared int8 quantizer (every a8 kernel input, the int8 KV rows)
    on rows of exact .5 ties: the card's codes and scales equal the CPU's
    bit for bit (the CPU's equal gptq_tpu's: tests/test_torch_qmatmul.py).
    Also counts the codes a division by the Python number 127.0 (a product
    with the reciprocal on the card) would have moved."""
    import torch

    from gptq_tpu_torch.models.common import _quantize_kv
    from gptq_tpu_torch.ops.qmatmul import quantize_acts_int8

    x = torch.from_numpy(tie_rows())
    xg = x.to(device)
    q_cpu, s_cpu = quantize_acts_int8(x)
    q_gpu, s_gpu = quantize_acts_int8(xg)
    kq_cpu, ks_cpu = _quantize_kv(x.reshape(8, 4, 64))
    kq_gpu, ks_gpu = _quantize_kv(xg.reshape(8, 4, 64))
    same = (torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
            and torch.equal(kq_gpu.cpu(), kq_cpu)
            and torch.equal(ks_gpu.cpu(), ks_cpu))
    old = xg.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    moved = int((torch.clamp(torch.round(xg / old), -127, 127).to(torch.int8)
                 != q_gpu).sum())
    log(f"int8 quantizer on {x.shape[0]} rows of exact .5 ties: card == CPU "
        f"bit for bit: {same}; a division by the number 127.0 on the card "
        f"would move {moved} of {x.numel()} codes")
    if not same:
        raise AssertionError("int8 quantizer: the card's codes or scales "
                             "differ from the CPU's on tie rows")
    report["quant_ties"] = {"rows": x.shape[0], "codes": x.numel(),
                            "equal": same, "moved_by_reciprocal": moved}


def partial_pos(S: int, prompt: int, decoded: int) -> "np.ndarray":
    """Rank 0's positions in a 2-rank SPCache of S local slots after a
    2 * prompt-token prompt and 2 * decoded decode steps (round-robin)."""
    pos = np.full((S,), -1, np.int32)
    pos[:prompt] = np.arange(prompt)
    pos[prompt:prompt + decoded] = 2 * prompt + 2 * np.arange(decoded)
    return pos


def partial_checks(device, peaks, timer, report):
    """#10 and #11 (one kernel, csrc/attention_partial.cu) against their
    plain version on stacked caches of 2048 local slots, 1,100 of them
    valid and laid out round-robin, each case timed beside the plain
    version, the byte / operation bound and a yardstick."""
    import torch

    from gptq_tpu_torch.models.common import alibi_slopes
    from gptq_tpu_torch.ops import attention as A

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    S, L, B = 2048, 32, 1
    pos_np = partial_pos(S, 1024, 76)
    n_valid = int((pos_np >= 0).sum())
    pos = torch.from_numpy(pos_np).to(device)
    # (case, entry, H, Hkv, hd, layers, caches, slopes)
    cases = (("llama-7B", "wide", 32, 32, 128, L, ("int8", "bf16", "f32"),
              False),
             ("Mixtral GQA 4", "wide", 32, 8, 128, L, ("int8",), False),
             ("Mixtral GQA 4 + alibi", "wide", 32, 8, 128, L, ("int8",), True),
             ("TinyLlama-1.1B (hd 64, GQA 8)", "narrow", 32, 4, 64, 22,
              ("int8", "bf16"), False),
             ("BLOOM-style G=1 hd 64 + alibi", "narrow", 32, 32, 64, L,
              ("int8",), True))
    rows = []
    worst = 0.0
    for case, entry, H, Hkv, hd, nl, caches, use_slopes in cases:
        fn = (A.decode_attention_partial_wide if entry == "wide"
              else A.decode_attention_partial)
        slopes = (torch.from_numpy(alibi_slopes(H)).to(device)
                  if use_slopes else None)
        layer = nl // 2
        for cache in caches:
            shape = (nl, B, S, Hkv, hd)
            if cache == "int8":
                k = torch.randint(-127, 128, shape, generator=gen,
                                  device=device, dtype=torch.int8)
                v = torch.randint(-127, 128, shape, generator=gen,
                                  device=device, dtype=torch.int8)
                ks = torch.rand(shape[:-1], generator=gen, device=device) \
                    * 0.02 + 0.001
                vs = torch.rand(shape[:-1], generator=gen, device=device) \
                    * 0.02 + 0.001
            else:
                dt = torch.bfloat16 if cache == "bf16" else torch.float32
                k = torch.randn(shape, generator=gen, device=device).to(dt)
                v = torch.randn(shape, generator=gen, device=device).to(dt)
                ks = vs = None
            q = torch.randn((B, H, hd), generator=gen, device=device)
            sm = 1.0 / math.sqrt(hd)
            kw = dict(k_scale=ks, v_scale=vs, slopes=slopes, layer=layer)
            got = fn(q, k, v, pos, sm, **kw)
            want = A.decode_attention_partial_wide_reference(q, k, v, pos, sm,
                                                             **kw)
            torch.cuda.synchronize()
            err = 0.0
            live = want[1] > 0
            for g_, w_ in ((got[0][live], want[0][live]), (got[1], want[1]),
                           (got[2], want[2])):
                d = (g_ - w_).abs()
                err = max(err, float(d.max()))
                if not bool((d <= TOL["partial"] * (1 + w_.abs())).all()):
                    raise AssertionError(
                        f"partial attention {case} {cache}: max abs err "
                        f"{float(d.max()):.3g} beyond {TOL['partial']} "
                        f"(relative)")
            worst = max(worst, err)
            row = {"case": case, "entry": entry, "cache": cache, "H": H,
                   "Hkv": Hkv, "hd": hd, "layers": nl, "S": S,
                   "valid": n_valid, "slopes": use_slopes,
                   "max_abs_err": err}
            row.update(partial_times(timer, peaks, fn, q, k, v, pos, sm, kw,
                                     n_valid))
            rows.append(row)
            log("partial attention " + json.dumps(row))
            del k, v, ks, vs
        torch.cuda.empty_cache()
    report["partial_rows"] = rows
    report["partial_max_abs_err"] = worst


def partial_times(timer, peaks, fn, q, k, v, pos, sm, kw, n_valid) -> dict:
    """Kernel, plain version and yardstick ms of one partial-attention
    call, and its bound: the valid slots' cache bytes (the kernel reads
    only those) plus pos, q and the outputs over the memory rate, or the
    f32 operations (q . k and p v over the valid slots) over the f32
    peak. The yardstick, scaled_dot_product_attention over the layer's
    dequantized bf16 cache with the pos mask (and the alibi bias), gives
    the normalised output, not (m, l, acc), and reads every slot."""
    import torch

    from gptq_tpu_torch.ops import attention as A

    ms = timer(lambda: fn(q, k, v, pos, sm, **kw))
    plain_ms = timer(lambda: A.decode_attention_partial_wide_reference(
        q, k, v, pos, sm, **kw))
    li = kw["layer"]
    B, H, hd = q.shape
    Hkv = k.shape[-2]
    kd, vd = k[li].float(), v[li].float()
    if kw["k_scale"] is not None:
        kd = kd * kw["k_scale"][li][..., None]
        vd = vd * kw["v_scale"][li][..., None]
    kd = kd.to(torch.bfloat16).transpose(1, 2).contiguous()
    vd = vd.to(torch.bfloat16).transpose(1, 2).contiguous()
    valid = pos >= 0
    bias = torch.zeros((1, H, 1, pos.shape[0]), device=q.device)
    if kw["slopes"] is not None:
        bias = bias + (kw["slopes"][None, :, None, None]
                       * pos.clamp_min(0).float()[None, None, None, :])
    mask = torch.where(valid[None, None, None, :], bias,
                       torch.full_like(bias, float("-inf"))).to(torch.bfloat16)
    qd = q[:, :, None].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qd, kd, vd, attn_mask=mask, scale=sm,
                                enable_gqa=H != Hkv))
    nbytes = (n_valid * Hkv * hd * 2 * k.element_size()
              + (n_valid * Hkv * 4 * 2 if kw["k_scale"] is not None else 0)
              + pos.numel() * 4 + B * H * hd * 4 + B * H * (hd + 2) * 4
              + (H * 4 if kw["slopes"] is not None else 0))
    ops = 4 * B * H * n_valid * hd
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["f32"] * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def env_var(name, value):
    """Run with the environment variable `name` set to `value`."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def fusion_mode(mode):
    """Run with GPTQ_TPU_FFN_FUSION=mode (the serving route switch)."""
    return env_var("GPTQ_TPU_FFN_FUSION", mode)


def matmul_impl(impl):
    """Run with GPTQ_TPU_MATMUL_IMPL=impl (the packed matmul's route)."""
    return env_var("GPTQ_TPU_MATMUL_IMPL", impl)


def packed_bytes(pw) -> int:
    """Bytes of a packed weight: words (or sign planes) and grids (or
    alphas)."""
    return (sum(w.numel() * 4 for w in pw.words)
            + sum(t.numel() * 4 for t in (pw.scale, pw.zoff, pw.alpha)
                  if t is not None))


def fused_times(timer, peaks, M, a8, weights, io_bytes, kernel, wrapper,
                plain, unfused) -> dict:
    """Device times of one fused function: the bare kernel launch, the
    wrapper, the plain version and the unfused route (qmm launches and the
    PyTorch glue between them), beside the byte / operation bound."""
    ms = timer(kernel)
    wrapper_ms = timer(wrapper)
    plain_ms = timer(plain)
    with fusion_mode("off"):
        unfused_ms = timer(unfused)
    nbytes = sum(packed_bytes(pw) for pw in weights) + io_bytes
    ops = 2 * M * sum(pw.Kp * pw.Np for pw in weights)
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["int8" if a8 else "bf16"] * 1e3
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "unfused_ms": unfused_ms, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def residual_check(what, attn, xres, ln, o, gu, dn0, a8) -> float:
    """attn_mlp with down's grid zeroed: the output is the residual r2
    alone, which the main check cannot see where the down phase's output
    dwarfs it. Both sides round r2 to bf16, so an element may land one
    bf16 step (2^-7 of itself) apart, and one near 0 may differ by its f32
    sum's rounding (1e-5 of max|r2| allowed); a residual left out reads
    1.0 of max|r2|. Returns max|diff| / max|r2|."""
    from gptq_tpu_torch.ops import ffn as Fz

    got = Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn0, a8=a8).float()
    want = Fz.attn_mlp_fused_reference(attn, xres, ln, o, gu, dn0,
                                       a8=a8).float()
    diff = (got - want).abs()
    bound = 2.0**-7 * want.abs() + 1e-5 * want.abs().max()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{what}, down zeroed: the residual r2 is off by "
                             f"{float(diff.max()):.3g}")
    return float(diff.max() / want.abs().max())


def fused_checks(device, peaks, timer, report):
    """The fused kernels (#4 norm_qkv, #5 attn_mlp, #6 ffn) against their
    plain versions at llama-7B shapes, M in {1, 32}, a8 and a16; timed at
    the decode shape (M = 1, a8)."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.models.common import FusedSplits, ServeFlags
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops.pack import fuse_packed

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    spec = llama7b_spec(1)
    H, F, V = spec.hidden, spec.ffn, spec.vocab
    ln = torch.ones(H, dtype=torch.float32, device=device)
    flags = ServeFlags(a8=True)
    rows, worst = [], {}

    def fused_weight(K, N, bits, gs, parts):
        pws = [packed_linear(gen, K, N, bits, gs, device) for _ in range(parts)]
        return fuse_packed(pws), FusedSplits(tuple((p.Np, p.N) for p in pws))

    def check(kernel, tag, M, a8, got, want):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not (math.isfinite(err) and rel <= TOL["fused"]):
            raise AssertionError(f"{kernel} {tag} M={M} a8={a8}: rel err "
                                 f"{rel:.3g} > {TOL['fused']}")
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        row = {"kernel": kernel, "w": tag, "M": M, "a8": a8,
               "max_abs_err": err, "rel_err": rel}
        rows.append(row)
        return row

    # 4: ln1 + q|k|v (w4), and final_ln + the 8-bit lm_head
    nq = [("q|k|v w4g-1", fused_weight(H, H, 4, -1, 3)[0]),
          ("q|k|v w4g128", fused_weight(H, H, 4, 128, 3)[0]),
          ("head w8g-1", packed_linear(gen, H, V, 8, -1, device))]
    for tag, pw in nq:
        for M in (1, 32):
            x = torch.randn((M, H), generator=gen, device=device)
            for a8 in (True, False):
                row = check("norm_qkv", tag, M, a8,
                            Fz.norm_qkv_fused(x, ln, pw, a8=a8),
                            Fz.norm_qkv_fused_reference(x, ln, pw, a8=a8))
                if M == 1 and a8 and "g128" not in tag:
                    xb = x.to(torch.bfloat16)
                    x2 = xb.float()
                    lin = {"w": pw, "b": None, "serve": flags}
                    row.update(fused_times(
                        timer, peaks, M, a8, [pw],
                        M * H * 2 + H * 2 + M * pw.Np * 4,
                        kernel=lambda: Fz._norm_qkv_cuda(
                            x2, ln, pw, "rmsnorm", 1e-5, True, None, None),
                        wrapper=lambda: Fz.norm_qkv_fused(xb, ln, pw),
                        plain=lambda: Fz.norm_qkv_fused_reference(xb, ln, pw),
                        unfused=lambda: common.linear_apply(
                            lin, common.norm_apply(spec, {"w": ln}, xb))))
                log("fused " + json.dumps(row))

    # 5 and 6: o (4096^2), gate|up (4096 x 2*11264), down (11264 x 4096)
    for tag, bits, gs in (("w4g-1", 4, -1), ("w4g128", 4, 128),
                          ("w3g128", 3, 128)):
        o = packed_linear(gen, H, H, bits, gs, device)
        gu, splits = fused_weight(H, F, bits, gs, 2)
        dn = packed_linear(gen, F, H, bits, gs, device)
        dn0 = dataclasses.replace(dn, scale=torch.zeros_like(dn.scale),
                                  zoff=torch.zeros_like(dn.zoff))
        p = {"o": {"w": o, "b": None, "serve": flags},
             "gateup_fused": {"w": gu, "splits": splits,
                              "b_parts": [None, None], "serve": flags},
             "down": {"w": dn, "b": None, "serve": flags}, "ln2": {"w": ln}}
        for M in (1, 32):
            attn = torch.randn((M, H), generator=gen, device=device)
            xres = torch.randn((M, H), generator=gen,
                               device=device).to(torch.bfloat16)
            m = torch.randn((M, H), generator=gen, device=device)
            for a8 in (True, False):
                row5 = check("attn_mlp", tag, M, a8,
                             Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn,
                                               a8=a8),
                             Fz.attn_mlp_fused_reference(attn, xres, ln, o, gu,
                                                         dn, a8=a8))
                row5["r2_rel_err"] = residual_check(
                    f"attn_mlp {tag} M={M} a8={a8}", attn, xres, ln, o, gu,
                    dn0, a8)
                row6 = check("ffn", tag, M, a8, Fz.ffn_fused(m, gu, dn, a8=a8),
                             Fz.ffn_fused_reference(m, gu, dn, a8=a8))
                if M == 1 and a8 and tag == "w4g-1":
                    x2 = xres.float()
                    a3, r3 = attn.reshape(1, 1, H), xres.reshape(1, 1, H)
                    row5.update(fused_times(
                        timer, peaks, M, a8, [o, gu, dn],
                        M * H * 4 + M * H * 2 + H * 2 + M * H * 4,
                        kernel=lambda: Fz._mlp_cuda(
                            attn, x2, ln, o, gu, dn, "silu", "rmsnorm", 1e-5,
                            True, True, None, None, None, None),
                        wrapper=lambda: Fz.attn_mlp_fused(attn, xres, ln, o,
                                                          gu, dn),
                        plain=lambda: Fz.attn_mlp_fused_reference(
                            attn, xres, ln, o, gu, dn),
                        unfused=lambda: common._finish_block(
                            spec, p, r3, a3, None, None)))

                    def unfused_ffn():
                        g, u = common._apply_fused(p["gateup_fused"], m)
                        return common.linear_apply(
                            p["down"], common.activation(spec, g) * u)

                    row6.update(fused_times(
                        timer, peaks, M, a8, [gu, dn], M * H * 4 * 2,
                        kernel=lambda: Fz._mlp_cuda(
                            m, None, None, None, gu, dn, "silu", "rmsnorm",
                            0.0, True, True, None, None, None, None),
                        wrapper=lambda: Fz.ffn_fused(m, gu, dn),
                        plain=lambda: Fz.ffn_fused_reference(m, gu, dn),
                        unfused=unfused_ffn))
                log("fused " + json.dumps(row5))
                log("fused " + json.dumps(row6))
    report["fused_rows"] = rows
    report["fused_max_abs_err"] = worst


def fused_bcq_checks(device, peaks, timer, report):
    """The BCQ branch of #4-#6 against the plain versions at llama-7B
    shapes (3-bit sign planes, groupsize -1 and 128, M 1 and 32, a8 and
    a16), with the near-tie rule of tests/test_torch_ffn.py (tie_check)
    and attn_mlp's residual on its own; each case timed beside its plain
    version, the unfused route of the same function (the norm and #13 on
    the same weights, GPTQ_TPU_FFN_FUSION=off) and its byte bound."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.models.common import FusedSplits, ServeFlags
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops.pack import fuse_packed

    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    spec = llama7b_spec(1)
    H, F = spec.hidden, spec.ffn
    ln = torch.ones(H, dtype=torch.float32, device=device)
    rows, worst = [], {}

    def fused_weight(K, N, gs, parts):
        pws = [bcq_linear(gen, K, N, 3, gs, device) for _ in range(parts)]
        return fuse_packed(pws), FusedSplits(tuple((p.Np, p.N) for p in pws))

    def times(M, a8, weights, io_bytes, kernel, plain, unfused):
        ms = timer(kernel)
        plain_ms = timer(plain)
        with fusion_mode("off"):
            unfused_ms = timer(unfused)
        nbytes = sum(packed_bytes(pw) for pw in weights) + io_bytes
        ops = 2 * M * sum(pw.Kp * pw.Np for pw in weights)
        t_bytes = nbytes / peaks["bw"] * 1e3
        t_ops = ops / peaks["int8" if a8 else "bf16"] * 1e3
        return {"ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def check(kernel, row, got, plain):
        err, rel, flips = tie_check(
            f"{kernel} bcq {row['w']} M={row['M']} a8={row['a8']}", got,
            plain, TOL["fused"])
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        row.update(kernel=kernel, max_abs_err=err, rel_err=rel, flips=flips)
        rows.append(row)

    for gs in (-1, 128):
        tag = f"w3g{gs}"
        qkv, _ = fused_weight(H, H, gs, 3)
        o = bcq_linear(gen, H, H, 3, gs, device)
        gu, splits = fused_weight(H, F, gs, 2)
        dn = bcq_linear(gen, F, H, 3, gs, device)
        dn0 = dataclasses.replace(dn, alpha=torch.zeros_like(dn.alpha))
        for M in (1, 32):
            x = torch.randn((M, H), generator=gen, device=device)
            attn = torch.randn((M, H), generator=gen, device=device)
            xres = torch.randn((M, H), generator=gen,
                               device=device).to(torch.bfloat16)
            for a8 in (True, False):
                flags = ServeFlags(a8=a8)
                p = {"o": {"w": o, "b": None, "serve": flags},
                     "gateup_fused": {"w": gu, "splits": splits,
                                      "b_parts": [None, None],
                                      "serve": flags},
                     "down": {"w": dn, "b": None, "serve": flags},
                     "ln2": {"w": ln}}
                xb, x2 = x.to(torch.bfloat16), x.to(torch.bfloat16).float()
                r4 = {"w": tag, "M": M, "a8": a8}
                check("norm_qkv", r4, Fz.norm_qkv_fused(x, ln, qkv, a8=a8),
                      lambda: Fz.norm_qkv_fused_reference(x, ln, qkv, a8=a8))
                lin = {"w": qkv, "b": None, "serve": flags}
                r4.update(times(
                    M, a8, [qkv], M * H * 2 + H * 4 + M * qkv.Np * 4,
                    kernel=lambda: Fz._norm_qkv_cuda(
                        x2, ln, qkv, "rmsnorm", 1e-5, a8, None, None),
                    plain=lambda: Fz.norm_qkv_fused_reference(xb, ln, qkv,
                                                              a8=a8),
                    unfused=lambda: common.linear_apply(
                        lin, common.norm_apply(spec, {"w": ln}, xb))))
                r5 = {"w": tag, "M": M, "a8": a8}
                check("attn_mlp", r5,
                      Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn, a8=a8),
                      lambda: Fz.attn_mlp_fused_reference(
                          attn, xres, ln, o, gu, dn, a8=a8))
                r5["r2_rel_err"] = residual_check(
                    f"attn_mlp bcq {tag} M={M} a8={a8}", attn, xres, ln, o,
                    gu, dn0, a8)
                xr2 = xres.float()
                a3, r3 = attn.reshape(1, M, H), xres.reshape(1, M, H)
                r5.update(times(
                    M, a8, [o, gu, dn], M * H * 4 + M * H * 2 + H * 4
                    + M * H * 4,
                    kernel=lambda: Fz._mlp_cuda(
                        attn, xr2, ln, o, gu, dn, "silu", "rmsnorm", 1e-5,
                        True, a8, None, None, None, None),
                    plain=lambda: Fz.attn_mlp_fused_reference(
                        attn, xres, ln, o, gu, dn, a8=a8),
                    unfused=lambda: common._finish_block(spec, p, r3, a3,
                                                         None, None)))
                r6 = {"w": tag, "M": M, "a8": a8}
                check("ffn", r6, Fz.ffn_fused(attn, gu, dn, a8=a8),
                      lambda: Fz.ffn_fused_reference(attn, gu, dn, a8=a8))

                def unfused_ffn():
                    g, u = common._apply_fused(p["gateup_fused"], attn)
                    return common.linear_apply(
                        p["down"], common.activation(spec, g) * u)

                r6.update(times(
                    M, a8, [gu, dn], M * H * 4 * 2,
                    kernel=lambda: Fz._mlp_cuda(
                        attn, None, None, None, gu, dn, "silu", "rmsnorm",
                        0.0, True, a8, None, None, None, None),
                    plain=lambda: Fz.ffn_fused_reference(attn, gu, dn,
                                                         a8=a8),
                    unfused=unfused_ffn))
                for r in (r4, r5, r6):
                    log("fused bcq " + json.dumps(r))
        del qkv, o, gu, dn, dn0
    report["fused_bcq_rows"] = rows
    report["fused_bcq_max_abs_err"] = worst


# ---------------------------------------------------------------------------
# the whole-layer kernel (#12)
# ---------------------------------------------------------------------------

class Ties:
    """The plain versions' rounding points (ops/ffn._bf16 and the int8
    activation quantizer) patched to record the elements lying within
    NEAR x (row max) of a rounding boundary, and to round the elements
    keyed in `flip` the other way (tests/test_torch_ffn.py::_Ties). Each
    is ranked by its distance to the boundary relative to its own value:
    the kernel's f32 value differs from the plain one by a few ulps of
    itself, so the nearest in that measure are the likeliest to flip."""

    NEAR = 2e-6

    def __init__(self, flip=frozenset(), record=True):
        self.near, self.flip, self.n, self.record = [], flip, 0, record
        self.kinds, self.gaps = [], {}
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        from gptq_tpu_torch.ops import ffn as Fz

        self.bf16, self.quant = Fz._bf16, Fz.quantize_acts_int8
        self.stack.enter_context(mock.patch.object(Fz, "_bf16", self._bf16))
        self.stack.enter_context(mock.patch.object(Fz, "quantize_acts_int8",
                                                   self._quant))
        return self

    def __exit__(self, *exc):
        self.stack.close()

    def _round(self, kind, v, r, other):
        """r with each flipped element of this point set to other where it
        still lies within NEAR of its boundary in this run (an earlier flip
        moves later points' values); with `record`, the point's near ties
        noted (on the device, then one copy to the host)."""
        import torch

        point = self.n
        self.n += 1
        self.kinds.append(kind)
        idx = [e for p, e in self.flip if p == point]
        if not (self.record or idx):
            return r
        rowmax = v.abs().amax(dim=-1, keepdim=True)
        gap = (v - (r + other) / 2).abs()
        dist = (gap / rowmax).reshape(-1)
        near = (dist <= self.NEAR) & (v != r).reshape(-1)
        if self.record:
            own = (gap / v.abs()).reshape(-1)
            at = near.nonzero().reshape(-1)
            for e, d, o in zip(at.tolist(), dist[at].tolist(),
                               own[at].tolist()):
                self.near.append((o, (point, e)))
                self.gaps[point, e] = d
        if not idx:
            return r
        ix = torch.tensor(idx, device=r.device)
        out = r.reshape(-1).clone()
        out[ix] = torch.where(near[ix], other.reshape(-1)[ix], out[ix])
        return out.reshape(r.shape)

    def _bf16(self, v):
        import torch

        r = self.bf16(v)
        bits = r.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        step = torch.where(v.abs() > r.abs(), bits + 1, bits - 1)
        other = step.to(torch.int16).view(torch.bfloat16).to(torch.float32)
        return self._round("bf16", v, r, other)

    def _quant(self, x2):
        import torch

        xq, sx = self.quant(x2)
        v = x2.to(torch.float32) / sx
        q = xq.to(torch.float32)
        other = torch.where(v > q, q + 1, q - 1).clamp(-127, 127)
        return self._round("int8", v, q, other).to(torch.int8), sx


def tie_check(what, got, plain, tol) -> tuple:
    """got (the kernel's output) within tol of max|plain()|; a larger
    difference passes only if rounding at most 4 of the plain version's
    near-tie elements the other way (chosen greedily, one at a time) brings
    it within tol. The rule of tests/test_torch_ffn.py::_check, with two
    differences for llama-7B shapes, where a point holds thousands of near
    ties: the candidates are the 128 nearest, ranked by the gap relative to
    the element's own value (Ties), and the 32 nearest of each rounding
    point besides, since one early flip (a bf16 residual element) carries
    through every later point of its row and the later points, wider,
    would crowd it out of the 128; where a flip was needed, its point,
    the point's kind and its gap over the row max are logged.
    Returns (max abs err, rel err, flips needed)."""
    import torch

    torch.cuda.synchronize()
    got = got.float()

    def rel(want):
        want = want.float()
        return float((got - want).abs().max() / want.abs().max())

    with Ties() as ties:
        want = plain().float()
    err = rel(want)
    abs_err = float((got - want).abs().max())
    flips = frozenset()
    ranked = [k for _, k in sorted(ties.near)]
    cands, per_point = ranked[:128], {}
    for k in ranked[128:]:
        if per_point.setdefault(k[0], 0) < 32:
            per_point[k[0]] += 1
            cands.append(k)
    while not err <= tol and len(flips) < 4:
        best = None
        for key in cands:
            if key in flips:
                continue
            with Ties(flips | {key}, record=False):
                e = rel(plain())
            if best is None or e < best[0]:
                best = (e, flips | {key})
        if best is None or best[0] >= err:
            break
        err, flips = best
    if flips:
        log(f"{what}: flipped " + ", ".join(
            f"point {p} ({ties.kinds[p]}) element {e}, gap "
            f"{ties.gaps[p, e]:.3g} of the row max" for p, e in sorted(flips)))
    if not (math.isfinite(err) and err <= tol):
        rows = ((got - want).abs().amax(dim=-1) / want.abs().max()).reshape(-1)
        raise AssertionError(f"{what}: rel err {err:.3g} > {tol} with "
                             f"{len(flips)} of {len(ties.near)} near-tie "
                             f"flips; rows over the limit "
                             f"{(rows > tol).nonzero().reshape(-1).tolist()} "
                             f"of {rows.numel()}")
    return abs_err, err, len(flips)


def layer_weights(gen, spec, device, bits=4, groupsize=-1):
    """A llama layer's packed q|k|v, o, gate|up and down (random codes)."""
    from gptq_tpu_torch.ops.pack import fuse_packed

    H, F = spec.hidden, spec.ffn
    kvw = spec.kv_heads * spec.hd

    def lin(K, N):
        return packed_linear(gen, K, N, bits, groupsize, device)

    return (fuse_packed([lin(H, n) for n in (H, kvw, kvw)]), lin(H, H),
            fuse_packed([lin(H, F), lin(H, F)]), lin(F, H))


def layer_checks(device, peaks, timer, report):
    """#12 against decode_layer_fused_reference at llama-7B width (one
    layer, 4-bit g-1): a8 and a16 on a bf16 cache at S = 256 (128 slots
    filled) and S = 2048 (1,100 filled, many splits), a8 on an f32 cache;
    the written cache rows bit for bit; every other slot untouched; the
    residual alone (down's grid zeroed); timed beside the plain version
    and the port's fused route over the same layer (norm_qkv + rope glue +
    attention + attn_mlp)."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.models.common import ServeFlags
    from gptq_tpu_torch.ops import layer_fused as LF

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    spec = llama7b_spec(2)
    H, nh, Hkv, hd = spec.hidden, spec.n_heads, spec.kv_heads, spec.hd
    kvw = Hkv * hd
    ws = layer_weights(gen, spec, device)
    qkv, o, gu, dn = ws
    w1 = torch.rand(H, generator=gen, device=device) + 0.5
    w2 = torch.rand(H, generator=gen, device=device) + 0.5
    opts = dict(act=spec.act, norm=spec.norm_type, eps=float(spec.norm_eps),
                sm_scale=float(spec.scale))
    kw = dict(n_heads=nh, n_kv_heads=Hkv, head_dim=hd, layer=1, **opts)
    flags = ServeFlags(a8=True)
    rows, worst = [], 0.0
    for S, length, a8, cdt in (
            (256, 128, True, torch.bfloat16), (256, 128, False, torch.bfloat16),
            (2048, 1100, True, torch.bfloat16),
            (2048, 1100, False, torch.bfloat16),
            (256, 128, True, torch.float32)):
        x = torch.randn((1, 1, H), generator=gen, device=device)
        cache0 = [torch.randn((2, 1, S, Hkv, hd), generator=gen,
                              device=device).to(cdt) for _ in range(2)]
        lens = torch.tensor(length, dtype=torch.int32, device=device)
        cos, sin = common.rope_tables(spec, lens.reshape(1, 1))
        args = (cos, sin, w1, w2, qkv, o, gu, dn)
        what = f"layer S={S} filled={length} a8={a8} {cdt}"
        kern = [c.clone() for c in cache0]
        got = LF.decode_layer_fused(x, *kern, lens, *args, a8=a8, **kw)
        plain = [c.clone() for c in cache0]
        err, rel, flips = tie_check(what, got, lambda: LF.decode_layer_fused_reference(
            x, *plain, lens, *args, a8=a8, **kw), TOL["fused"])
        worst = max(worst, err)
        # the written rows: the cache-dtype rounding of the plain rope of
        # the kernel's own q|k|v row, bit for bit; no other slot changes
        own = [c.clone() for c in cache0]
        _, scratch = LF._layer_cuda(x, *own, lens, cos, sin, w1, w2, *ws, nh, Hkv,
                                 hd, spec.act, spec.norm_type,
                                 float(spec.norm_eps), float(spec.scale), a8, 1)
        torch.cuda.synchronize()
        qkvo = scratch["qkv"]
        fresh = [LF.rope_rows(qkvo[H:H + kvw].reshape(Hkv, hd),
                              cos.reshape(-1), sin.reshape(-1)).to(cdt),
                 qkvo[H + kvw:H + 2 * kvw].reshape(Hkv, hd).to(cdt)]
        rest = torch.ones(S, dtype=torch.bool, device=device)
        rest[length] = False
        for c_k, c_o, c0, f in zip(kern, own, cache0, fresh):
            if not (torch.equal(c_k, c_o) and torch.equal(c_k[0], c0[0])
                    and torch.equal(c_k[1, :, rest], c0[1, :, rest])
                    and torch.equal(c_k[1, 0, length], f)):
                raise AssertionError(f"{what}: the cache write is not the "
                                     f"kernel's roped fresh row alone")
        row = {"S": S, "filled": length, "a8": a8,
               "cache": str(cdt).replace("torch.", ""), "max_abs_err": err,
               "rel_err": rel, "near_tie_flips": flips,
               "cache_row": "bit-exact"}
        if S == 256 and a8 and cdt == torch.bfloat16:
            # the residual alone: down's grid zeroed leaves y = r2, held per
            # element to one bf16 step (random weights make the down
            # output dwarf r2 in the check above)
            dn0 = dataclasses.replace(dn, scale=torch.zeros_like(dn.scale),
                                      zoff=torch.zeros_like(dn.zoff))
            args0 = (cos, sin, w1, w2, qkv, o, gu, dn0)
            g0 = LF.decode_layer_fused(x, *[c.clone() for c in cache0], lens,
                                       *args0, a8=a8, **kw).float()
            w0 = LF.decode_layer_fused_reference(
                x, *[c.clone() for c in cache0], lens, *args0, a8=a8,
                **kw).float()
            torch.cuda.synchronize()
            d0 = (g0 - w0).abs()
            if not bool((d0 <= 2.0**-7 * w0.abs() + 1e-5 * w0.abs().max())
                        .all()):
                raise AssertionError(f"{what}, down zeroed: the residual r2 is "
                                     f"off by {float(d0.max()):.3g}")
            row["r2_rel_err"] = float(d0.max() / w0.abs().max())
        if cdt == torch.bfloat16 and a8:
            row.update(layer_times(timer, peaks, spec, x, cache0, lens, args,
                                   kw, flags))
        rows.append(row)
        log("layer " + json.dumps(row))
    report["layer_rows"] = rows
    report["layer_max_abs_err"] = worst


def layer_times(timer, peaks, spec, x, cache0, lens, args, kw, flags) -> dict:
    """Device times of one decoder layer at one token: the bare kernel
    launch, the wrapper, the plain version and the port's fused route
    (block_forward on the deferred-write path: norm_qkv, the rope glue,
    the attention kernel with the fresh pair, attn_mlp), beside the bound:
    the packed weights and the filled cache slots read, the fresh rows
    written, over the memory rate; or the products over the int8 peak and
    the attention's over the f32 peak, whichever is longer."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.models.common import FusedSplits
    from gptq_tpu_torch.ops import layer_fused as LF

    cos, sin, w1, w2, qkv, o, gu, dn = args
    H, nh, Hkv, hd = spec.hidden, spec.n_heads, spec.kv_heads, spec.hd
    kvw = Hkv * hd
    kc, vc = (c.clone() for c in cache0)
    ms = timer(lambda: LF._layer_cuda(
        x, kc, vc, lens, *args, nh, Hkv, hd, kw["act"], kw["norm"], kw["eps"],
        kw["sm_scale"], True, 1))
    wrapper_ms = timer(lambda: LF.decode_layer_fused(x, kc, vc, lens, *args,
                                                     a8=True, **kw))
    plain_ms = timer(lambda: LF.decode_layer_fused_reference(
        x, kc, vc, lens, *args, a8=True, **kw))
    p = {"ln1": {"w": w1}, "ln2": {"w": w2},
         "qkv_fused": {"w": qkv, "b_parts": [None] * 3, "serve": flags,
                       "splits": FusedSplits(((H, H), (kvw, kvw),
                                              (kvw, kvw)))},
         "o": {"w": o, "b": None, "serve": flags},
         "gateup_fused": {"w": gu, "b_parts": [None] * 2, "serve": flags,
                          "splits": FusedSplits(((gu.Np // 2, gu.N // 2),) * 2)},
         "down": {"w": dn, "b": None, "serve": flags}}
    xb = x.to(torch.bfloat16)
    with env_var("GPTQ_TPU_LAYER_FUSION", "off"), fusion_mode("auto"):
        fused_route_ms = timer(lambda: common.block_forward(
            spec, p, xb, cache=(kc[1], vc[1], None, None), cache_len=lens,
            rope=(cos, sin), defer_write=True,
            full_cache=(kc, vc, None, None, 1)))
    length = int(lens)
    item = cache0[0].element_size()
    nbytes = (sum(packed_bytes(pw) for pw in (qkv, o, gu, dn))
              + 2 * length * kvw * item + 2 * kvw * item
              + 2 * H * 4 + 2 * H * 4 + 2 * hd * 4 + 4)
    mm_ops = 2 * sum(pw.Kp * pw.Np for pw in (qkv, o, gu, dn))
    attn_ops = 4 * nh * (length + 1) * hd
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = (mm_ops / peaks["int8"] + attn_ops / peaks["f32"]) * 1e3
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "fused_route_ms": fused_route_ms, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096)]


def close_check(what, got, want, tol, bf16_out) -> float:
    """|got - want| within tol of max|want| (plus one bf16 step of each
    element when the output is bf16); returns max |got - want|."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ulp = 2.0**-7 * want.abs() if bf16_out else 0.0
    if not bool((diff <= tol * want.abs().max() + ulp).all()):
        raise AssertionError(f"{what}: rel err "
                             f"{float(diff.max() / want.abs().max()):.3g} > "
                             f"{tol}")
    return float(diff.max())


def bcq_checks(device, peaks, timer, report):
    """#13 against bcq_matmul_reference at llama-7B shapes: bits 2/3/4,
    groupsize -1 and 128, M 1 and 32, a8 / bf16 / f32; timed at the decode
    shape (3-bit g128 a8, M = 1, the four linears of one layer) and at the
    PPL eval's M = 512."""
    import torch

    from gptq_tpu_torch.ops import bcq_matmul as B

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    rows, worst, dec = [], 0.0, []
    modes = (("a8", torch.float32), ("a16", torch.bfloat16),
             ("a16", torch.float32))
    for K, N in SHAPES_7B:
        for bits in (2, 3, 4):
            for gs in (-1, 128):
                pw = bcq_linear(gen, K, N, bits, gs, device)
                for M in (1, 32):
                    x32 = torch.randn((M, K), generator=gen, device=device)
                    for act, xdt in modes:
                        a8 = act == "a8"
                        x = x32.to(xdt)
                        err = close_check(
                            f"bcq_matmul K={K} N={N} w{bits} g{gs} M={M} "
                            f"{act} {xdt}", B.bcq_matmul(x, pw, a8=a8),
                            B.bcq_matmul_reference(x, pw, a8=a8),
                            TOL["qmm_a8" if a8 else "qmm_a16"],
                            xdt == torch.bfloat16)
                        if xdt == torch.float32:
                            worst = max(worst, err)
                        row = {"K": K, "N": N, "bits": bits, "g": gs, "M": M,
                               "act": act, "x": str(xdt)[6:],
                               "max_abs_err": err}
                        if bits == 3 and gs == 128 and M == 1 and a8:
                            row.update(matmul_times(
                                pw, x, a8, peaks, timer,
                                kernel=B._bcq_cuda, prepare=B._prepare,
                                wrapper=B.bcq_matmul,
                                plain=B.bcq_matmul_reference,
                                dense=B.bcq_dequant))
                            dec.append(row)
                        rows.append(row)
                del pw
        log(f"bcq_matmul K={K} N={N}: 36 cases within tolerance")
    # the PPL eval's 512-row blocks go through the tiled kernel (bf16 x,
    # as the torch.matmul yardstick runs)
    pw = bcq_linear(gen, 4096, 12288, 3, 128, device)
    x = torch.randn((512, 4096), generator=gen,
                    device=device).to(torch.bfloat16)
    row = {"K": 4096, "N": 12288, "bits": 3, "g": 128, "M": 512,
           "act": "a16", "x": "bfloat16",
           "max_abs_err": close_check("bcq_matmul M=512",
                                      B.bcq_matmul(x, pw),
                                      B.bcq_matmul_reference(x, pw),
                                      TOL["qmm_a16"], True)}
    row.update(matmul_times(pw, x, False, peaks, timer, kernel=B._bcq_cuda,
                            prepare=B._prepare, wrapper=B.bcq_matmul,
                            plain=B.bcq_matmul_reference, dense=B.bcq_dequant))
    log("bcq_matmul timing " + json.dumps(row))
    for r in dec:
        log("bcq_matmul timing " + json.dumps(r))
    report["bcq_rows"] = rows
    report["bcq_decode"] = dec
    report["bcq_m512"] = row
    report["bcq_max_abs_err"] = worst


def matmul_times(pw, x, a8, peaks, timer, kernel, prepare, wrapper, plain,
                 dense, extra=None) -> dict:
    """Device times of one packed matmul: the bare kernel launch, the
    wrapper, the plain version and torch.matmul on the dequantized bf16
    weight (the one-call PyTorch yardstick), beside the byte / operation
    bound of its inputs and output. `extra`: more named calls to time."""
    import torch

    M = x.shape[0]
    x2, _ = prepare(x, pw, a8)
    ms = timer(lambda: kernel(x2, pw))
    out = {"ms": ms, "wrapper_ms": timer(lambda: wrapper(x, pw, a8=a8)),
           "plain_ms": timer(lambda: plain(x, pw, a8=a8))}
    wd = dense(pw).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    out["library_ms"] = timer(lambda: torch.matmul(xb, wd))
    del wd
    for name, fn in (extra or {}).items():
        out[name] = timer(lambda: fn(x2, pw))
    grids = sum(t.numel() * 4 for t in (pw.scale, pw.zoff, pw.alpha)
                if t is not None)
    words = sum(w.numel() * 4 for w in pw.words)
    x_bytes = M * pw.Kp * (1 if a8 else x.element_size()) + (M * 4 if a8
                                                             else 0)
    nbytes = words + grids + x_bytes + M * pw.Np * 4
    # the least work: one product with the dequantized weight, at the peak
    # of the activations' type
    ops = 2 * M * pw.Kp * pw.Np
    kind = ("int8" if a8 else "bf16" if x.dtype == torch.bfloat16
            else "f32")
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks[kind] * 1e3
    out.update({"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return out


def stream_checks(device, peaks, timer, report):
    """#7 (GPTQ_TPU_MATMUL_IMPL=streamed) against dequant_matmul_reference
    at llama-7B shapes: 2/4/8-bit, groupsize -1 and 128, M 1 and 8, a8 and
    a16 (bf16); timed at M = 1 w4a8 g-1 beside kernel #1 on the same
    weight."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    rows, worst, dec = [], 0.0, []
    with matmul_impl("streamed"):
        for K, N in SHAPES_7B:
            for bits in (2, 4, 8):
                for gs in (-1, 128):
                    pw = packed_linear(gen, K, N, bits, gs, device)
                    for M in (1, 8):
                        x32 = torch.randn((M, K), generator=gen,
                                          device=device)
                        for a8, xdt in ((True, torch.float32),
                                        (False, torch.bfloat16)):
                            x = x32.to(xdt)
                            before = (Q.launches, Q.stream_launches)
                            got = Q.dequant_matmul(x, pw, a8=a8)
                            if (Q.launches, Q.stream_launches) != \
                                    (before[0], before[1] + 1):
                                raise AssertionError("streamed route did not "
                                                     "launch kernel #7")
                            err = close_check(
                                f"streamed qmm K={K} N={N} w{bits} g{gs} "
                                f"M={M} a8={a8}", got,
                                Q.dequant_matmul_reference(x, pw, a8=a8),
                                TOL["qmm_a8" if a8 else "qmm_a16"], not a8)
                            if a8:
                                worst = max(worst, err)
                            row = {"K": K, "N": N, "bits": bits, "g": gs,
                                   "M": M, "a8": a8, "max_abs_err": err}
                            if bits == 4 and gs == -1 and M == 1 and a8:
                                row.update(matmul_times(
                                    pw, x, a8, peaks, timer,
                                    kernel=Q._stream_cuda, prepare=Q._prepare,
                                    wrapper=Q.dequant_matmul,
                                    plain=Q.dequant_matmul_reference,
                                    dense=Q.dequant,
                                    extra={"qmm_ms": Q._qmm_cuda}))
                                dec.append(row)
                            rows.append(row)
            log(f"streamed qmm K={K} N={N}: 24 cases within tolerance")
    for r in dec:
        log("streamed qmm timing " + json.dumps(r))
    report["stream_rows"] = rows
    report["stream_decode"] = dec
    report["stream_max_abs_err"] = worst


def expert_checks(device, peaks, timer, report):
    """#8 and #9 against their plain versions at Mixtral-8x7B shapes: the
    gate / up bank (8 x 4096 -> 14336, x shared) and the down bank
    (8 x 14336 -> 4096, x per expert); #8 at M 2 / 16 / 32, f32 and bf16
    x, 4-bit g-1 and g128, and one case each at 2, 3 and 8 bits; #9 at
    M = 1 on each projection for expert indices held in a device tensor.
    Timed at the path's shapes: #8 at a 16-token prefill, #9 at decode,
    bf16 x."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    E, H, F = 8, 4096, 14336
    tol = TOL["qmm_a16"]  # f32 outputs: sums in another order
    rows, worst = [], 0.0
    banks = {}
    for tag, bits, gs, K, N, per_x, Ms, dts in (
            ("gate w4g-1", 4, -1, H, F, False, (2, 16, 32), ("f32", "bf16")),
            ("down w4g-1", 4, -1, F, H, True, (2, 16, 32), ("f32", "bf16")),
            ("gate w4g128", 4, 128, H, F, False, (2, 16, 32),
             ("f32", "bf16")),
            ("down w4g128", 4, 128, F, H, True, (2, 16, 32), ("f32", "bf16")),
            ("gate w2g-1", 2, -1, H, F, False, (16,), ("bf16",)),
            ("down w3g128", 3, 128, F, H, True, (16,), ("bf16",)),
            ("gate w8g-1", 8, -1, H, F, False, (16,), ("bf16",))):
        pe = packed_bank(gen, E, K, N, bits, gs, device)
        for M in Ms:
            x32 = torch.randn((E, M, K) if per_x else (M, K), generator=gen,
                              device=device)
            for dt in dts:
                x = x32.to(torch.bfloat16) if dt == "bf16" else x32
                before = Q.expert_launches
                got = Q.expert_dequant_matmul(x, pe)
                if Q.expert_launches != before + 1:
                    raise AssertionError("expert_dequant_matmul did not "
                                         "launch kernel #8")
                err = close_check(f"expert matmul {tag} M={M} {dt}", got,
                                  Q.expert_dequant_matmul_reference(x, pe),
                                  tol, False)
                worst = max(worst, err)
                row = {"w": tag, "K": K, "N": N, "M": M, "x": dt,
                       "per_x": per_x, "max_abs_err": err}
                if M == 16 and dt == "bf16" and bits == 4 and gs == -1:
                    row.update(expert_times(pe, x, peaks, timer))
                rows.append(row)
                log("expert matmul " + json.dumps(row))
        if tag in ("gate w4g-1", "down w4g-1", "gate w4g128"):
            banks[tag] = pe
        del pe
    banks["up w4g-1"] = packed_bank(gen, E, H, F, 4, -1, device)
    sel = []
    for tag in ("gate w4g-1", "up w4g-1", "down w4g-1", "gate w4g128"):
        pe = banks[tag]
        x32 = torch.randn((1, pe.K), generator=gen, device=device)
        for e in (0, 3, 7):
            idx = torch.tensor([e], dtype=torch.int32, device=device)
            for dt in ("f32", "bf16"):
                x = x32.to(torch.bfloat16) if dt == "bf16" else x32
                before = Q.select_launches
                got = Q.expert_dequant_matmul_select(x, pe, idx)
                if Q.select_launches != before + 1:
                    raise AssertionError("expert_dequant_matmul_select did "
                                         "not launch kernel #9")
                err = close_check(
                    f"expert select {tag} e={e} {dt}", got,
                    Q.expert_dequant_matmul_select_reference(x, pe, idx),
                    tol, False)
                worst = max(worst, err)
                row = {"w": tag, "K": pe.K, "N": pe.N, "M": 1, "e": e,
                       "x": dt, "max_abs_err": err}
                if e == 3 and dt == "bf16" and "g128" not in tag:
                    row.update(select_times(pe, x, idx, peaks, timer))
                    sel.append(row)
                rows.append(row)
        log(f"expert select {tag}: 6 cases within {tol}")
    for r in sel:
        log("expert select timing " + json.dumps(r))
    report["expert_rows"] = rows
    report["expert_max_abs_err"] = worst


def expert_times(pe, x, peaks, timer) -> dict:
    """Device times of #8 on one bank: the bare launch, the plain version
    and torch.bmm on the dequantized bf16 bank, beside the byte bound
    (the whole bank read once) and the operation bound at the bf16
    tensor-core peak; `cuda_core_ms`: the operations at the f32 CUDA-core
    peak, which bound a kernel on CUDA cores."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    E, M = pe.E, x.shape[-2]
    out = {"ms": timer(lambda: Q._expert_cuda(x, pe)),
           "plain_ms": timer(lambda: Q.expert_dequant_matmul_reference(x, pe))}
    wd = Q.dequant_experts(pe).to(torch.bfloat16)  # (E, K, N)
    xb = x.to(torch.bfloat16)
    xe = xb if xb.dim() == 3 else xb.expand(E, M, pe.K)
    out["library_ms"] = timer(lambda: torch.bmm(xe, wd))
    del wd
    nbytes = (sum(w.numel() * 4 for w in pe.words)
              + (pe.scale.numel() + pe.zoff.numel()) * 4
              + x.numel() * x.element_size() + E * M * pe.Np * 4)
    ops = 2 * E * M * pe.Kp * pe.Np
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["bf16"] * 1e3
    out.update({"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "cuda_core_ms": ops / peaks["f32"] * 1e3})
    return out


def select_times(pe, x, idx, peaks, timer) -> dict:
    """Device times of #9 on one selected expert: the bare launch, the
    plain version and torch.matmul on that expert's dequantized bf16
    weight, beside the byte bound of one expert's words and grids."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    out = {"ms": timer(lambda: Q._select_cuda(x, pe, idx)),
           "plain_ms": timer(
               lambda: Q.expert_dequant_matmul_select_reference(x, pe, idx))}
    wd = Q.dequant(pe.expert(idx)).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    out["library_ms"] = timer(lambda: torch.matmul(xb, wd))
    del wd
    nbytes = (sum(w[0].numel() * 4 for w in pe.words)
              + (pe.scale[0].numel() + pe.zoff[0].numel()) * 4
              + x.numel() * x.element_size() + pe.Np * 4 + 4)
    ops = 2 * pe.Kp * pe.Np
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["bf16"] * 1e3
    out.update({"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return out


# ---------------------------------------------------------------------------
# phase 3: quantize -> pack -> save / load -> PPL
# ---------------------------------------------------------------------------

def dense_weight(pw):
    """(N, K) dense f32 weight in the original column order of a packed
    weight (act-order weights store K permuted)."""
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import qmatmul as Q

    w = (B.bcq_dequant(pw) if pw.fmt == "bcq" else Q.dequant(pw)).T
    if pw.perm is None:
        return w.contiguous()
    out = w.new_empty(w.shape)
    out[:, pw.perm.long()] = w
    return out

def phase_quantize(device, tmp, report):
    import torch

    from gptq_tpu_torch.config import QuantConfig
    from gptq_tpu_torch.data import synthetic_stream
    from gptq_tpu_torch.eval.ppl import eval_ppl
    from gptq_tpu_torch.io import load_checkpoint, save_checkpoint
    from gptq_tpu_torch.models.common import init_params
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.ops.pack import PackedWeight
    from gptq_tpu_torch.pipeline import pack_model, quantize_model

    spec = llama7b_spec(2)
    params = init_params(spec, seed=0, dtype=torch.float32, device=device)
    calib = torch.as_tensor(synthetic_stream(spec.vocab, 16 * 512, seed=1)
                            .reshape(16, 512), device=device).long()
    cfg = QuantConfig(wbits=4, groupsize=128, act_order=True,
                      static_groups=True, true_sequential=True, nsamples=16)
    t0 = time.perf_counter()
    res = quantize_model(spec, params, calib, cfg, log=lambda s: None)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    per_layer = [res.times[f"layer{i}"] for i in range(spec.n_layers)]
    log(f"quantize: {spec.n_layers} layers at llama-7B width in "
        f"{t_quant:.1f} s ({', '.join(f'{t:.1f}' for t in per_layer)} s "
        f"per layer); losses " + json.dumps(
            {k: round(v, 3) for k, v in res.losses.items()}))
    pack_model(spec, params, res.quantizers, cfg)
    path = os.path.join(tmp, "quant2.npz")
    save_checkpoint(path, spec, params, cfg)
    spec2, loaded, cfg2 = load_checkpoint(path, device=device)
    assert spec2 == spec and cfg2 == cfg
    for i, lp in enumerate(params["layers"]):
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            a, b = lp[key]["w"], loaded["layers"][i][key]["w"]
            assert isinstance(b, PackedWeight) and b.bits == 4
            for wa, wb in zip(a.words, b.words):
                assert torch.equal(wa, wb), f"words differ after load {i}.{key}"
            assert torch.equal(a.perm, b.perm)
    test = synthetic_stream(spec.vocab, 4 * 512, seed=2)
    Q.launches = 0
    ppl_packed = eval_ppl(spec, loaded, test, 512, log=lambda s: None)
    torch.cuda.synchronize()
    qmm_eval = Q.launches
    assert qmm_eval == 4 * 7 * spec.n_layers, qmm_eval
    ppl_dense = eval_ppl(spec, dense_twin(loaded), test, 512,
                         log=lambda s: None)
    rel = abs(ppl_packed / ppl_dense - 1.0)
    log(f"ppl: packed {ppl_packed:.4f} (qmm kernel, {qmm_eval} launches) vs "
        f"dense-dequantized {ppl_dense:.4f}: rel diff {rel:.2e}")
    if not (math.isfinite(ppl_packed) and rel < 0.005):
        raise AssertionError(f"packed vs dense PPL differ by {rel:.3g}")
    report["quantize"] = {"seconds": t_quant, "per_layer_s": per_layer,
                          "ppl_packed": ppl_packed, "ppl_dense": ppl_dense}


def dense_twin(params):
    """The same model with every packed linear dequantized to dense f32."""
    from gptq_tpu_torch.ops.pack import PackedWeight

    return {**params, "layers": [
        {k: ({"w": dense_weight(v["w"]), "b": None}
             if isinstance(v.get("w"), PackedWeight) else v)
         for k, v in lp.items()} for lp in params["layers"]]}


def plain_versions():
    """Patch every kernel wrapper the model core calls with its plain
    version (for kernel-vs-plain greedy tokens)."""
    from gptq_tpu_torch.models import common, moe
    from gptq_tpu_torch.ops import attention as A
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.parallel import sp

    stack = contextlib.ExitStack()
    for mod, name, fn in (
            (sp, "decode_attention_partial",
             A.decode_attention_partial_reference),
            (sp, "decode_attention_partial_wide",
             A.decode_attention_partial_wide_reference),
            (common, "decode_layer_fused", LF.decode_layer_fused_reference),
            (common, "dequant_matmul", Q.dequant_matmul_reference),
            (common, "bcq_matmul", B.bcq_matmul_reference),
            (common, "decode_attention", A.decode_attention_reference),
            (common, "norm_qkv_fused", Fz.norm_qkv_fused_reference),
            (common, "attn_mlp_fused", Fz.attn_mlp_fused_reference),
            (common, "ffn_fused", Fz.ffn_fused_reference),
            (moe, "dequant_matmul", Q.dequant_matmul_reference),
            (moe, "expert_dequant_matmul",
             Q.expert_dequant_matmul_reference),
            (moe, "expert_dequant_matmul_select",
             Q.expert_dequant_matmul_select_reference)):
        stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


def greedy_check(what, eng, prompt, n_new, kernel_name, want=None) -> list:
    """Greedy tokens of kernel decoding (which must launch kernel_name, and
    exactly the counts `want` where given) against plain decoding (which
    must launch nothing).

    The tie rule: where the two decodings first part, the step passes only
    if the plain version's logits of the two tokens, taken along its
    decode path at the common prefix, are exactly equal (random weights
    give near-flat logits, and an exact tie may go either way under sums
    taken in another order). Both decodings then go on from the plain
    version's token, and a later parting is judged the same way. Any
    other parting fails."""
    import torch

    _drop_graphs(eng)
    reset_counts()
    kern = eng.generate(prompt, n_new)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not counts[kernel_name] > 0:
        raise AssertionError(f"{what}: kernel decoding launched no "
                             f"{kernel_name}")
    if want is not None:
        expect(counts, want, what)
    plain = plain_generate(eng, prompt, n_new, f"{what}: plain decoding")
    log(f"{what}: greedy tokens, kernels {kern[0].tolist()} vs plain "
        f"{plain[0].tolist()}")
    g = 0  # decoding restarted from prompt + plain[:, :g]
    while not np.array_equal(kern, plain):
        i = int(np.argmax(kern[0] != plain[0]))
        ctx = np.concatenate([prompt, plain[:, :g]], axis=1)
        with plain_decoding(eng):
            lp = decode_logits(eng, ctx, plain[0, g:i].tolist())
        tk, tp = int(kern[0, i]), int(plain[0, i])
        if float(lp[tk]) != float(lp[tp]):
            raise AssertionError(f"{what}: kernel and plain decoding disagree; "
                                 + divergence(eng, prompt, kern, plain))
        log(f"{what}: exact tie at step {i} (plain logits of {tp} and {tk} "
            f"both {float(lp[tp]):.6g}); both go on from {tp}")
        g = i + 1
        ctx = np.concatenate([prompt, plain[:, :g]], axis=1)
        if g == n_new:
            kern = plain
            break
        kern = np.concatenate([plain[:, :g], eng.generate(ctx, n_new - g)], 1)
        plain = np.concatenate(
            [plain[:, :g], plain_generate(eng, ctx, n_new - g, what)], 1)
    return plain[0].tolist()


def _drop_graphs(eng) -> None:
    """Forget the CUDA graphs an engine captured (a replay would run the
    launches captured, whichever wrappers are patched in now)."""
    graphs = getattr(eng, "_graphs", None)
    if graphs is not None:
        graphs.clear()


@contextlib.contextmanager
def plain_decoding(eng):
    """plain_versions() for one engine's decoding, its graphs dropped on
    the way in and out."""
    _drop_graphs(eng)
    try:
        with plain_versions():
            yield
    finally:
        _drop_graphs(eng)


def plain_generate(eng, prompt, n_new, what) -> np.ndarray:
    """eng.generate on the plain versions, which must launch nothing."""
    with plain_decoding(eng):
        reset_counts()
        out = eng.generate(prompt, n_new)
        expect(launch_counts(), {}, what)
    return out


def divergence(eng, prompt, kern, plain) -> str:
    """At the first step where the two decodings part: both logits on the
    common prefix, the plain version's margin between its token and the
    kernel's, and the largest logit difference."""
    import torch

    i = int(np.argmax(kern[0] != plain[0]))
    ids = torch.as_tensor(np.concatenate([prompt, kern[:, :i]], axis=1),
                          device=eng.device)
    lk, _ = eng.prefill(ids)
    with plain_versions():
        lp, _ = eng.prefill(ids)
    lk, lp = lk[0].float(), lp[0].float()
    tk, tp = int(kern[0, i]), int(plain[0, i])
    top = torch.topk(lp, 3)
    return (f"step {i}: plain logits of its token {tp} and the kernel's {tk}: "
            f"{float(lp[tp]):.6g} / {float(lp[tk]):.6g} (kernel's: "
            f"{float(lk[tp]):.6g} / {float(lk[tk]):.6g}); max |kernel - "
            f"plain| {float((lk - lp).abs().max()):.3g} of max |plain| "
            f"{float(lp.abs().max()):.3g}; plain top-3 "
            f"{top.values.tolist()} at {top.indices.tolist()}")


def phase_quantize_bcq(device, tmp, report):
    """The BCQ path: GPTQ lut mode -> pack_bcq -> save / load -> PPL through
    #13 against the dense twin, greedy tokens, and one --bcq layer's time."""
    import torch

    from gptq_tpu_torch.config import QuantConfig
    from gptq_tpu_torch.data import synthetic_stream
    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.eval.ppl import eval_ppl
    from gptq_tpu_torch.io import load_checkpoint, save_checkpoint
    from gptq_tpu_torch.models.common import init_params
    from gptq_tpu_torch.ops.pack import PackedWeight
    from gptq_tpu_torch.pipeline import pack_model, quantize_model

    spec = llama7b_spec(2)
    params = init_params(spec, seed=3, dtype=torch.float32, device=device)
    calib = torch.as_tensor(synthetic_stream(spec.vocab, 16 * 512, seed=4)
                            .reshape(16, 512), device=device).long()
    cfg = QuantConfig(wbits=3, groupsize=128, lut_eval=True, bcq_round=5,
                      apot_nums=2, use_bst=True, true_sequential=True,
                      nsamples=16)
    t0 = time.perf_counter()
    res = quantize_model(spec, params, calib, cfg, log=lambda s: None)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    per_layer = [res.times[f"layer{i}"] for i in range(spec.n_layers)]
    log(f"quantize (lut, BCQ 3-bit g128): {spec.n_layers} layers in "
        f"{t_quant:.1f} s ({', '.join(f'{t:.1f}' for t in per_layer)} s per "
        f"layer); losses " + json.dumps(
            {k: round(v, 3) for k, v in res.losses.items()}))
    pack_model(spec, params, res.quantizers, cfg)
    path = os.path.join(tmp, "bcq2.npz")
    save_checkpoint(path, spec, params, cfg)
    spec2, loaded, cfg2 = load_checkpoint(path, device=device)
    assert spec2 == spec and cfg2 == cfg
    for i, lp in enumerate(params["layers"]):
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            a, b = lp[key]["w"], loaded["layers"][i][key]["w"]
            assert isinstance(b, PackedWeight) and b.fmt == "bcq" \
                and b.bits == 3, (i, key)
            assert torch.equal(a.words[0], b.words[0]), (i, key)
            assert torch.equal(a.alpha, b.alpha), (i, key)
    test = synthetic_stream(spec.vocab, 4 * 512, seed=2)
    reset_counts()
    ppl_packed = eval_ppl(spec, loaded, test, 512, log=lambda s: None)
    torch.cuda.synchronize()
    n_eval = launch_counts()
    expect(n_eval, {"bcq": 4 * 7 * spec.n_layers}, "BCQ PPL eval")
    ppl_dense = eval_ppl(spec, dense_twin(loaded), test, 512,
                         log=lambda s: None)
    rel = abs(ppl_packed / ppl_dense - 1.0)
    log(f"ppl (BCQ): packed {ppl_packed:.4f} (bcq_matmul kernel, "
        f"{n_eval['bcq']} launches) vs dense-dequantized {ppl_dense:.4f}: "
        f"rel diff {rel:.2e}")
    if not (math.isfinite(ppl_packed) and rel < 0.005):
        raise AssertionError(f"BCQ packed vs dense PPL differ by {rel:.3g}")
    # f32 activations and cache: this model's logits are nearly flat (PPL
    # ~6e4 over 32000 tokens), and under int8 activations and cache one
    # rounding tie flipped between the kernel and the plain version moves
    # the logits by ~1% of their range, more than the gap between the top
    # two at some steps (PERF.md, Findings). The w3a8 int8-KV route's tokens
    # are held on the serve phase's 2-layer BCQ model.
    eng = DecodeEngine(spec, loaded, max_len=128, batch=1,
                       cache_dtype=torch.float32, a8=False)
    prompt = np.random.default_rng(6).integers(0, spec.vocab, size=(1, 64))
    tokens = greedy_check("2-layer BCQ decoding (f32 activations and cache)",
                          eng, prompt, 16, "bcq")
    del eng, loaded, params

    # one whole-weight --bcq layer (Hessian-free, 5 rounds)
    spec1 = llama7b_spec(1)
    p1 = init_params(spec1, seed=5, dtype=torch.float32, device=device)
    cfg1 = QuantConfig(wbits=3, groupsize=128, bcq=True, nsamples=1)
    res1 = quantize_model(spec1, p1, calib[:1], cfg1, log=lambda s: None)
    torch.cuda.synchronize()
    log(f"quantize (--bcq, 3-bit g128, 5 rounds): one layer in "
        f"{res1.times['layer0']:.2f} s")
    report["quantize_bcq"] = {
        "seconds": t_quant, "per_layer_s": per_layer,
        "ppl_packed": ppl_packed, "ppl_dense": ppl_dense,
        "greedy_tokens": tokens, "bcq_rtn_layer_s": res1.times["layer0"]}


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """Every kernel wrapper's launch count. A wrapper counts its calls
    from Python: while a CUDA graph is captured each captured launch counts
    once, and a replay runs no Python and counts nothing. So every count
    this script asserts is taken over eager runs (the per-token protocol,
    generate) and none over replays."""
    from gptq_tpu_torch.ops import attention as A
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF
    from gptq_tpu_torch.ops import qmatmul as Q

    return {"qmm": Q.launches, "stream": Q.stream_launches,
            "bcq": B.launches, "attention": A.launches,
            "norm_qkv": Fz.norm_qkv_launches,
            "attn_mlp": Fz.attn_mlp_launches, "ffn": Fz.ffn_launches,
            "expert": Q.expert_launches, "select": Q.select_launches,
            "layer": LF.launches, "partial": A.partial_launches,
            "partial_wide": A.partial_wide_launches}


def reset_counts() -> None:
    from gptq_tpu_torch.ops import attention as A
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF
    from gptq_tpu_torch.ops import qmatmul as Q

    Q.launches = Q.stream_launches = B.launches = A.launches = 0
    Fz.norm_qkv_launches = Fz.attn_mlp_launches = Fz.ffn_launches = 0
    Q.expert_launches = Q.select_launches = LF.launches = 0
    A.partial_launches = A.partial_wide_launches = 0


def expect(counts: dict, want: dict, what: str) -> None:
    """Every kernel's count equals `want` (a missing name: 0)."""
    bad = {k: (v, want.get(k, 0)) for k, v in counts.items()
           if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches (got, want) {bad}")


def serve_cli(path, n_tok, flags, mode, impl="pallas", layer="off",
              protocol="per-token") -> tuple:
    """One CLI benchmark run on route `mode` (GPTQ_TPU_FFN_FUSION), packed-
    matmul route `impl` and whole-layer route `layer` (GPTQ_TPU_LAYER_
    FUSION); the result line must name `protocol`. (benchmark dict, counts,
    printed lines)."""
    import torch

    from gptq_tpu_torch import cli

    buf = io.StringIO()
    with fusion_mode(mode), matmul_impl(impl), \
            env_var("GPTQ_TPU_LAYER_FUSION", layer):
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["dummy", "c4", "--load", path, "--benchmark",
                           str(n_tok), *flags])
        torch.cuda.synchronize()
        counts = launch_counts()
    out = buf.getvalue()
    log(f"cli ({mode}, layer fusion {layer}): "
        + out.strip().replace("\n", " | "))
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    if line["protocol"] != protocol:
        raise AssertionError(f"cli: protocol {line['protocol']}, expected "
                             f"{protocol}")
    return line["benchmark"], counts, out


def phase_serve(device, tmp, card, report):
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.io import save_checkpoint
    from gptq_tpu_torch.pipeline import quantize_lm_head

    spec = llama7b_spec(32)
    L = spec.n_layers
    t0 = time.perf_counter()
    params = synth_packed_params(spec, device, seed=0)
    path = os.path.join(tmp, "serve32.npz")
    save_checkpoint(path, spec, params)
    log(f"serve: synthesized + saved a 32-layer 4-bit checkpoint "
        f"({os.path.getsize(path) / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")

    n_tok, warmup = 128, 100
    steps = warmup + n_tok
    serve = {}
    # the main path: the fused route (the default on the card), with the
    # lm_head quantized to 8 bits and served by the fused head
    bench, counts, out = serve_cli(
        path, n_tok, ["--faster-kernel", "--int8_kv", "--quant_lm_head", "8"],
        "auto")
    assert "lm_head quantized to 8 bits" in out
    expect(counts, {"norm_qkv": (L + 1) * steps, "attn_mlp": L * steps,
                    "attention": L * steps}, "fused cli")
    serve["fused"] = {"median_ms": bench["median_s"] * 1e3,
                      "tokens_per_s": bench["tokens_per_s"],
                      "p90_ms": bench["p90_s"] * 1e3, "launches": counts}
    # the unfused route of the first slice: one qmm launch per linear
    bench, counts, _ = serve_cli(path, n_tok, ["--faster-kernel", "--int8_kv"],
                                 "off")
    expect(counts, {"qmm": 4 * L * steps, "attention": L * steps},
           "unfused cli")
    serve["unfused"] = {"median_ms": bench["median_s"] * 1e3,
                        "tokens_per_s": bench["tokens_per_s"],
                        "p90_ms": bench["p90_s"] * 1e3, "launches": counts}
    # the whole-layer route (#12): GPTQ_TPU_LAYER_FUSION=on over a bf16
    # cache; per step one layer launch a layer and the head's norm_qkv
    bench, counts, _ = serve_cli(
        path, n_tok, ["--faster-kernel", "--quant_lm_head", "8"], "auto",
        layer="on")
    expect(counts, {"layer": L * steps, "norm_qkv": steps}, "layer cli")
    serve["layer"] = {"median_ms": bench["median_s"] * 1e3,
                      "tokens_per_s": bench["tokens_per_s"],
                      "p90_ms": bench["p90_s"] * 1e3, "launches": counts}
    # batched lock-step decode: 4 sequences through generate_chained, its
    # chunks CUDA graphs (the counts hold eager and capture-time calls)
    bench, counts, _ = serve_cli(
        path, n_tok, ["--faster-kernel", "--int8_kv", "--quant_lm_head", "8",
                      "--benchmark_batch", "4"], "auto", protocol="batch4")
    serve["batch4"] = {"tokens_per_s": bench["tokens_per_s"],
                       "step_ms": bench["step_s"] * 1e3,
                       "launches_eager": counts}
    log(f"decode batch 4 (cli --benchmark {n_tok} --faster-kernel --int8_kv "
        f"--quant_lm_head 8 --benchmark_batch 4, chained): "
        f"{bench['tokens_per_s']:.2f} tok/s, {bench['step_s'] * 1e3:.3f} "
        f"ms/step on {card}")
    os.remove(path)
    for route, flags in (("fused", "--int8_kv --quant_lm_head 8"),
                         ("unfused", "--int8_kv"),
                         ("layer", "--quant_lm_head 8, layer fusion on, "
                                   "bf16 KV")):
        r = serve[route]
        log(f"decode {route} (cli --benchmark {n_tok} --faster-kernel "
            f"{flags}, B=1): median {r['median_ms']:.3f} ms/token, "
            f"{r['tokens_per_s']:.2f} tok/s on {card}; launches "
            + json.dumps(r["launches"]))
    report["serve"] = serve

    # 4 requests through DecodeEngine.generate on the fused route: the
    # 64-row prefill takes the unfused route (more than 32 rows)
    dense_head = params["lm_head"]
    assert quantize_lm_head(spec, params, bits=8)
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    rng = np.random.default_rng(5)
    req_s = []
    for _ in range(4):
        prompt = rng.integers(0, spec.vocab, size=(1, 64))
        reset_counts()
        t0 = time.perf_counter()
        toks = eng.generate(prompt, 64)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
        assert toks.shape == (1, 64) and (toks >= 0).all() \
            and (toks < spec.vocab).all()
        expect(launch_counts(), {"qmm": 4 * L + 1, "norm_qkv": (L + 1) * 64,
                                 "attn_mlp": L * 64, "attention": L * 64},
               "requests")
    log(f"requests: 4 x (64 prompt + 64 new) in "
        f"{', '.join(f'{s:.2f}' for s in req_s)} s")
    report["requests_s"] = req_s

    # device time per decode step of each route (the unfused one as the
    # cli ran it: a dense bf16 head)
    unfused_eng = DecodeEngine(spec, {**params, "lm_head": dense_head},
                               max_len=128, batch=1, cache_dtype=torch.int8,
                               a8=True)
    layer_eng = DecodeEngine(spec, params, max_len=128, batch=1,
                             cache_dtype=torch.bfloat16, a8=True)
    # the layer route's prompt comes from its own generator, so that the
    # checks below see the prompts they saw before that route was added
    layer_rng = np.random.default_rng(15)
    for route, e, mode, layer in (("fused", eng, "auto", "off"),
                                  ("unfused", unfused_eng, "off", "off"),
                                  ("layer", layer_eng, "auto", "on")):
        draw = layer_rng if route == "layer" else rng
        with fusion_mode(mode), env_var("GPTQ_TPU_LAYER_FUSION", layer):
            prof = profile_decode(e, draw.integers(0, spec.vocab,
                                                   size=(1, 64)))
        if prof["device_ms"] > 0:
            prof["device_busy_share"] = (prof["device_ms"]
                                         / serve[route]["median_ms"])
        log(f"decode profile {route} " + json.dumps(prof))
        serve[route]["profile"] = prof

    # the ffn_fused route: an act-order o projection keeps attn_mlp off,
    # so the MLP alone fuses (gate|up + act + down)
    small = llama7b_spec(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    p_ffn = {**params, "layers": [
        {**lp, "o": {"w": packed_linear(gen, spec.hidden, spec.hidden, 4, 128,
                                        device, perm=True), "b": None}}
        for lp in params["layers"][:2]]}
    eng_ffn = DecodeEngine(small, p_ffn, max_len=64, batch=1,
                           cache_dtype=torch.int8, a8=True)
    reset_counts()
    eng_ffn.generate(rng.integers(0, small.vocab, size=(1, 16)), 8)
    torch.cuda.synchronize()
    ffn_counts = launch_counts()
    # 9 forwards (a 16-row prefill, 8 steps), each 2 layers + the head
    expect(ffn_counts, {"norm_qkv": 9 * 3, "ffn": 9 * 2, "qmm": 9 * 2,
                        "attention": 8 * 2}, "ffn route")
    log("ffn route (2 layers, act-order o): launches " + json.dumps(ffn_counts))
    report["ffn_route_launches"] = ffn_counts

    # 2 layers, on each route: kernel decoding and plain decoding agree
    # token for token
    p2 = {**params, "layers": params["layers"][:2]}
    prompt = rng.integers(0, small.vocab, size=(1, 64))
    eng2 = DecodeEngine(small, p2, max_len=128, batch=1,
                        cache_dtype=torch.int8, a8=True)
    for mode, route_kernel in (("auto", "attn_mlp"), ("off", "qmm")):
        with fusion_mode(mode):
            greedy_check(f"2-layer decoding ({mode})", eng2, prompt, 16,
                         route_kernel)
    # the layer route on a bf16 cache: kernels against the plain versions
    # (a 64-row prefill takes qmm, 16 steps 2 layer launches and the head),
    # and against the fused route on the same cache
    eng2b = DecodeEngine(small, p2, max_len=128, batch=1,
                         cache_dtype=torch.bfloat16, a8=True)
    with env_var("GPTQ_TPU_LAYER_FUSION", "on"):
        layer_toks = greedy_check(
            "2-layer decoding (layer route, bf16 KV)", eng2b, prompt, 16,
            "layer", want={"qmm": 4 * 2 + 1, "layer": 2 * 16,
                           "norm_qkv": 16})
    fused_toks = greedy_check("2-layer decoding (fused, bf16 KV)", eng2b,
                              prompt, 16, "attn_mlp")
    report["layer_vs_fused"] = route_check(eng2b, prompt, layer_toks,
                                           fused_toks)
    serve_chained(device, spec, params, card, report)
    del params, p2, p_ffn, eng, unfused_eng, eng2, eng_ffn, dense_head
    del layer_eng, eng2b
    torch.cuda.empty_cache()
    serve_bcq(device, tmp, card, report)
    serve_streamed(device, tmp, report)
    lut_bench(report)


def decode_logits(eng, prompt, forced) -> "torch.Tensor":
    """The decode step's logits after `prompt` and the forced tokens."""
    import torch

    logits, cache = eng.prefill(torch.as_tensor(prompt, device=eng.device))
    for t in forced:
        logits, cache = eng.step(cache, torch.tensor([[t]], device=eng.device))
    return logits[0].float()


def route_check(eng, prompt, layer_toks, fused_toks) -> dict:
    """The layer route's greedy tokens against the fused route's on one
    bf16 cache. The two routes round at different points by design (each
    the JAX kernel's own: the layer kernel keeps the attention row in f32
    into o's int8 codes and rounds the fresh rows to the cache dtype; the
    fused route rounds the attention row to bf16 and attends the fresh
    rows in f32), so they may part where two logits nearly tie. Equal
    tokens pass; where they part, both routes' logits on the common
    prefix must agree within the fused kernels' tolerance, and the two
    tokens must be each other's runner-up by less than twice the largest
    logit difference. Returns what it saw."""
    if layer_toks == fused_toks:
        log(f"2-layer decoding on a bf16 cache: the layer route and the "
            f"fused route give the same {len(layer_toks)} tokens")
        return {"equal": True}
    i = next(j for j, (a, b) in enumerate(zip(layer_toks, fused_toks))
             if a != b)
    with env_var("GPTQ_TPU_LAYER_FUSION", "on"):
        lg = decode_logits(eng, prompt, layer_toks[:i])
    lf = decode_logits(eng, prompt, layer_toks[:i])
    spread = float((lg - lf).abs().max())
    rel = spread / float(lf.abs().max())
    a, b = layer_toks[i], fused_toks[i]
    gaps = [abs(float(lg[a] - lg[b])), abs(float(lf[a] - lf[b]))]
    seen = {"equal": False, "step": i, "spread": spread, "rel": rel,
            "gaps": gaps}
    log(f"2-layer decoding on a bf16 cache: the routes part at step {i} "
        f"({a} vs {b}); logits differ by {spread:.3g} ({rel:.3g} of max), "
        f"the two tokens' gap {gaps[0]:.3g} (layer) / {gaps[1]:.3g} (fused)")
    if not (rel <= TOL["fused"] and max(gaps) <= 2 * spread):
        raise AssertionError(f"2-layer decoding on a bf16 cache: the layer "
                             f"route and the fused route part at step {i} "
                             f"beyond a near tie: {seen}")
    return seen


def serve_chained(device, spec, params, card, report):
    """The chained protocol: engine.decode.benchmark_decode_chained (a
    128-token chain and a 64-token one, each one CUDA graph) on the
    32-layer model on the layer route (bf16 KV) and on the default fused
    route (int8 KV); then generate_chained against generate on 2 layers of
    each route. params carry the 8-bit head. The counters count only
    eager calls and each captured launch once (launch_counts), so the
    chained runs' counts are printed and not asserted."""
    import torch

    from gptq_tpu_torch.engine.decode import (DecodeEngine,
                                              benchmark_decode_chained)
    from gptq_tpu_torch.models.common import fuse_serving

    served = fuse_serving(spec, params, a8=True)
    ids = np.random.default_rng(11).integers(0, spec.vocab, size=(1, 128))
    routes = (("layer", "on", torch.bfloat16), ("fused", "off", torch.int8))
    out = {}
    for route, layer, cdt in routes:
        with env_var("GPTQ_TPU_LAYER_FUSION", layer), fusion_mode("auto"):
            reset_counts()
            t0 = time.perf_counter()
            r = benchmark_decode_chained(spec, served, ids, cache_dtype=cdt,
                                         log=lambda s: None)
            torch.cuda.synchronize()
            r["wall_s"] = time.perf_counter() - t0
            r["launches_eager_and_captured"] = launch_counts()
        out[route] = r
        log(f"chained {route} ({str(cdt).replace('torch.', '')} KV, 32 "
            f"layers, 128 tokens): per_token {r['per_token_s'] * 1e3:.3f} ms"
            f" ({r['tokens_per_s']:.2f} tok/s), full_run "
            f"{r['full_run_s']:.4f} s, half_run {r['half_run_s']:.4f} s, "
            f"dispatch_rtt {r['dispatch_rtt_s'] * 1e3:.4f} ms, below noise "
            f"floor {r['below_noise_floor']} on {card}; "
            + json.dumps(r["launches_eager_and_captured"]))
    # 2 layers: the chained tokens equal the per-token ones on each route
    small = llama7b_spec(2)
    p2 = {**params, "layers": params["layers"][:2]}
    prompt = np.random.default_rng(12).integers(0, small.vocab, size=(1, 20))
    for route, layer, cdt in routes:
        with env_var("GPTQ_TPU_LAYER_FUSION", layer), fusion_mode("auto"):
            eng = DecodeEngine(small, p2, max_len=64, batch=1, cache_dtype=cdt,
                               a8=True)
            want = eng.generate(prompt, 24)
            got = eng.generate_chained(prompt, 24, chunk=8)
        log(f"2-layer generate_chained ({route}): {got[0].tolist()}")
        if not np.array_equal(got, want):
            raise AssertionError(f"generate_chained ({route}) parts from "
                                 f"generate: {got[0].tolist()} vs "
                                 f"{want[0].tolist()}")
        out[route]["chained_tokens_equal"] = True
    report["chained"] = out


def serve_bcq(device, tmp, card, report):
    """The BCQ route: a 32-layer 3-bit g128 BCQ checkpoint through the CLI;
    every packed linear launches #13 (the fused kernels take uniform
    weights only), 128 per step, plus 32 attention launches."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.io import save_checkpoint

    spec = llama7b_spec(32)
    L = spec.n_layers
    t0 = time.perf_counter()
    params = synth_packed_params(spec, device, bits=3, groupsize=128, seed=7,
                                 fmt="bcq")
    path = os.path.join(tmp, "bcq32.npz")
    save_checkpoint(path, spec, params)
    log(f"serve (BCQ): synthesized + saved a 32-layer 3-bit g128 BCQ "
        f"checkpoint ({os.path.getsize(path) / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    n_tok, warmup = 128, 100
    steps = warmup + n_tok
    bench, counts, out = serve_cli(path, n_tok,
                                   ["--faster-kernel", "--int8_kv"], "auto")
    os.remove(path)
    quant = json.loads(out.strip().splitlines()[-1])["quant"]
    assert quant["wbits"] == 3 and quant["lut_eval"] is True, quant
    expect(counts, {"bcq": 4 * L * steps, "attention": L * steps},
           "BCQ cli")
    r = {"median_ms": bench["median_s"] * 1e3,
         "tokens_per_s": bench["tokens_per_s"],
         "p90_ms": bench["p90_s"] * 1e3, "launches": counts}
    log(f"decode bcq (cli --benchmark {n_tok} --faster-kernel --int8_kv, "
        f"w3g128 BCQ, B=1): median {r['median_ms']:.3f} ms/token, "
        f"{r['tokens_per_s']:.2f} tok/s on {card}; launches "
        + json.dumps(counts))
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    prof = profile_decode(eng, np.random.default_rng(8).integers(
        0, spec.vocab, size=(1, 64)))
    if prof["device_ms"] > 0:
        prof["device_busy_share"] = prof["device_ms"] / r["median_ms"]
    log("decode profile bcq " + json.dumps(prof))
    r["profile"] = prof
    report.setdefault("serve", {})["bcq"] = r
    # 2 layers: kernel decoding and plain decoding agree token for token
    small = llama7b_spec(2)
    eng2 = DecodeEngine(small, {**params, "layers": params["layers"][:2]},
                        max_len=128, batch=1, cache_dtype=torch.int8,
                        a8=True)
    prompt = np.random.default_rng(9).integers(0, small.vocab, size=(1, 64))
    r["greedy_tokens"] = greedy_check("2-layer BCQ decoding (w3a8, int8 KV)",
                                      eng2, prompt, 16, "bcq")


def serve_streamed(device, tmp, report):
    """The streamed route: a 2-layer 4-bit checkpoint through the CLI with
    GPTQ_TPU_FFN_FUSION=off and GPTQ_TPU_MATMUL_IMPL=streamed (8 launches
    of #7 per step, no qmm), and kernel-vs-plain greedy tokens."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.io import save_checkpoint

    spec = llama7b_spec(2)
    params = synth_packed_params(spec, device, bits=4, groupsize=-1, seed=11)
    path = os.path.join(tmp, "stream2.npz")
    save_checkpoint(path, spec, params)
    n_tok, warmup = 32, 100
    steps = warmup + n_tok
    bench, counts, _ = serve_cli(path, n_tok, ["--faster-kernel", "--int8_kv"],
                                 "off", impl="streamed")
    os.remove(path)
    expect(counts, {"stream": 4 * 2 * steps, "attention": 2 * steps},
           "streamed cli")
    r = {"median_ms": bench["median_s"] * 1e3,
         "tokens_per_s": bench["tokens_per_s"], "launches": counts}
    log(f"decode streamed (2 layers, w4a8, cli --benchmark {n_tok}): median "
        f"{r['median_ms']:.3f} ms/token; launches " + json.dumps(counts))
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    prompt = np.random.default_rng(12).integers(0, spec.vocab, size=(1, 64))
    with fusion_mode("off"), matmul_impl("streamed"):
        r["greedy_tokens"] = greedy_check("2-layer streamed decoding", eng,
                                          prompt, 16, "stream")
    report.setdefault("serve", {})["streamed"] = r


def lut_bench(report):
    """`python -m gptq_tpu_torch.cli dummy c4 --lut_bench --groupsize 128`,
    its table printed line by line."""
    from gptq_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["dummy", "c4", "--lut_bench", "--groupsize", "128"])
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log("lut_bench " + line)
    assert len(lines) == 7, lines  # dense, uniform 2/3/4/8, BCQ 2/3
    report["lut_bench"] = lines


# ---------------------------------------------------------------------------
# phase 5: the Mixtral-8x7B MoE path
# ---------------------------------------------------------------------------

def moe_dense_twin(params):
    """The MoE model with every packed linear and expert bank dequantized
    to dense f32 ((E, out, in) expert stacks)."""
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.ops.pack import PackedExperts

    twin = dense_twin(params)
    for lp in twin["layers"]:
        ex = lp.get("experts")
        if ex is not None:
            lp["experts"] = {k: (Q.dequant_experts(v).transpose(1, 2)
                                 if isinstance(v, PackedExperts) else v)
                             for k, v in ex.items()}
    return twin


def moe_quantize(device, tmp, report):
    """quantize_model (attention linears) -> gptq_quantize_experts ->
    pack_model + pack_experts -> save / load -> PPL through the kernels
    against the dequantized dense twin, on a 1-layer Mixtral-width model
    with 16 x 512 synthetic tokens."""
    import torch

    from gptq_tpu_torch.config import QuantConfig
    from gptq_tpu_torch.data import synthetic_stream
    from gptq_tpu_torch.eval.ppl import eval_ppl
    from gptq_tpu_torch.io import load_checkpoint, save_checkpoint
    from gptq_tpu_torch.models.common import init_params
    from gptq_tpu_torch.models.moe import gptq_quantize_experts, pack_experts
    from gptq_tpu_torch.ops.pack import PackedExperts
    from gptq_tpu_torch.pipeline import pack_model, quantize_model

    spec = mixtral_spec(1)
    params = init_params(spec, seed=0, dtype=torch.float32, device=device)
    calib = torch.as_tensor(synthetic_stream(spec.vocab, 16 * 512, seed=1)
                            .reshape(16, 512), device=device).long()
    cfg = QuantConfig(wbits=4, groupsize=-1, true_sequential=True,
                      nsamples=16)
    t0 = time.perf_counter()
    res = quantize_model(spec, params, calib, cfg, log=lambda s: None)
    torch.cuda.synchronize()
    t_attn = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = gptq_quantize_experts(spec, params, calib, cfg,
                                   log=lambda s: None, keep_grids=True)
    torch.cuda.synchronize()
    t_exp = time.perf_counter() - t0
    assert len(losses) == 3 * spec.n_experts and "_grids" in \
        params["layers"][0]["experts"]
    log(f"moe quantize: one Mixtral-width layer, attention linears "
        f"{t_attn:.1f} s, {3 * spec.n_experts} expert projections "
        f"{t_exp:.1f} s; expert losses " + json.dumps(
            {k: round(v, 3) for k, v in losses.items()}))
    pack_model(spec, params, res.quantizers, cfg)
    pack_experts(params, bits=4, groupsize=-1)
    path = os.path.join(tmp, "moe1.npz")
    save_checkpoint(path, spec, params, cfg)
    spec2, loaded, cfg2 = load_checkpoint(path, device=device)
    os.remove(path)
    assert spec2 == spec and cfg2 == cfg
    for name in ("gate", "up", "down"):
        a = params["layers"][0]["experts"][name]
        b = loaded["layers"][0]["experts"][name]
        assert isinstance(b, PackedExperts) and b.bits == 4 \
            and b.E == spec.n_experts
        for wa, wb in zip(a.words, b.words):
            assert torch.equal(wa, wb), f"{name} words differ after load"
    del params
    test = synthetic_stream(spec.vocab, 4 * 512, seed=2)
    reset_counts()
    ppl_packed = eval_ppl(spec, loaded, test, 512, log=lambda s: None)
    torch.cuda.synchronize()
    counts = launch_counts()
    # 512-row windows: each expert's projections go through #1 (N > 32),
    # 24 a layer, beside q, k, v and o
    expect(counts, {"qmm": 4 * (4 + 3 * spec.n_experts)}, "MoE PPL eval")
    ppl_dense = eval_ppl(spec, moe_dense_twin(loaded), test, 512,
                         log=lambda s: None)
    rel = abs(ppl_packed / ppl_dense - 1.0)
    log(f"ppl (MoE, w4 g-1): packed {ppl_packed:.4f} ({counts['qmm']} qmm "
        f"launches) vs dense-dequantized {ppl_dense:.4f}: rel diff "
        f"{rel:.2e}")
    if not (math.isfinite(ppl_packed) and rel < 0.005):
        raise AssertionError(f"MoE packed vs dense PPL differ by {rel:.3g}")
    report["moe_quantize"] = {"attn_s": t_attn, "experts_s": t_exp,
                              "ppl_packed": ppl_packed,
                              "ppl_dense": ppl_dense, "eval_launches": counts}


def moe_decode_counts(L, steps):
    """Launches of `steps` batch-1 decode steps of an L-layer MoE model on
    the default route (JAX routing: MoE layers keep attn_mlp off): ln1 +
    q|k|v and the head through norm_qkv, o through qmm, top-2 x (gate,
    up, down) selections, attention."""
    return {"norm_qkv": (L + 1) * steps, "qmm": L * steps,
            "select": 6 * L * steps, "attention": L * steps}


def moe_step_bytes(spec, params, n_ctx) -> int:
    """Bytes one batch-1 decode step must read: every attention linear's
    packed words and grids, the two selected experts' three projections
    per layer, the routers, the packed head, the int8 KV cache over n_ctx
    positions with its scales."""
    pe = params["layers"][0]["experts"]
    per_expert = sum(sum(w[0].numel() * 4 for w in b.words)
                     + (b.scale[0].numel() + b.zoff[0].numel()) * 4
                     for b in pe.values())
    attn = sum(packed_bytes(params["layers"][0][k]["w"])
               for k in ("q", "k", "v", "o"))
    router = params["layers"][0]["router"]["w"].numel() * 4
    kv = 2 * n_ctx * spec.kv_heads * (spec.hd + 4)
    return (spec.n_layers * (attn + spec.expert_top_k * per_expert + router
                             + kv) + packed_bytes(params["lm_head"]["w"]))


def moe_serve(device, tmp, card, peaks, report):
    """The 8-layer Mixtral checkpoint through the CLI, with exact launch
    counts and a profile; requests through #8 and per-expert #1 on 2
    layers, greedy tokens against the plain versions; the whole 32-layer
    model in-process; one layer's decode FFN without a host sync."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine, benchmark_decode
    from gptq_tpu_torch.io import save_checkpoint
    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.models.moe import moe_ffn
    from gptq_tpu_torch.pipeline import quantize_lm_head

    spec = mixtral_spec(8)
    L = spec.n_layers
    t0 = time.perf_counter()
    params = synth_moe_params(spec, device, seed=3)
    path = os.path.join(tmp, "moe8.npz")
    save_checkpoint(path, spec, params)
    log(f"moe serve: synthesized + saved an 8-layer Mixtral-width 4-bit "
        f"checkpoint ({os.path.getsize(path) / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    n_tok, warmup = 128, 100
    bench, counts, out = serve_cli(
        path, n_tok, ["--faster-kernel", "--int8_kv", "--quant_lm_head", "8"],
        "auto")
    os.remove(path)
    assert "lm_head quantized to 8 bits" in out
    expect(counts, moe_decode_counts(L, warmup + n_tok), "MoE cli")
    r = {"median_ms": bench["median_s"] * 1e3,
         "tokens_per_s": bench["tokens_per_s"],
         "p90_ms": bench["p90_s"] * 1e3, "launches": counts}
    log(f"decode moe (cli, 8 layers, --benchmark {n_tok} --faster-kernel "
        f"--int8_kv --quant_lm_head 8, B=1): median {r['median_ms']:.3f} "
        f"ms/token on {card}; launches " + json.dumps(counts))
    assert quantize_lm_head(spec, params, bits=8)
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    prof = profile_decode(eng, np.random.default_rng(13).integers(
        0, spec.vocab, size=(1, 16)))
    if prof["device_ms"] > 0:
        prof["device_busy_share"] = prof["device_ms"] / r["median_ms"]
    log("decode profile moe8 " + json.dumps(prof))
    r["profile"] = prof
    moe = report.setdefault("moe", {})
    moe["cli8"] = r
    del eng

    # requests on 2 layers with an f32 embedding: f32 activations and
    # cache, since random weights give near-flat logits whose top two an
    # int8 rounding flip can swap (PERF.md, Findings)
    small = mixtral_spec(2)
    p2 = {**params, "layers": params["layers"][:2],
          "embed": {"tokens": params["embed"]["tokens"].float()}}
    eng2 = DecodeEngine(small, p2, max_len=128, batch=1,
                        cache_dtype=torch.float32, a8=False)
    rng = np.random.default_rng(14)
    n_new, E, L2 = 6, small.n_experts, small.n_layers
    reqs = {}
    for T in (16, 32, 48):
        prompt = rng.integers(0, small.vocab, size=(1, T))
        dec = moe_decode_counts(L2, n_new)
        if T <= 32:  # prefill through #8: 3 launches a layer
            want = {"norm_qkv": dec["norm_qkv"] + L2 + 1,
                    "qmm": dec["qmm"] + L2, "expert": 3 * L2,
                    "select": dec["select"], "attention": dec["attention"]}
        else:  # per-expert #1: 3E a layer, beside q|k|v, o and the head
            want = {"norm_qkv": dec["norm_qkv"],
                    "qmm": dec["qmm"] + L2 * (2 + 3 * E) + 1,
                    "select": dec["select"], "attention": dec["attention"]}
        toks = greedy_check(f"2-layer MoE request T={T} (f32 activations "
                            f"and cache)", eng2, prompt, n_new,
                            "expert" if T <= 32 else "qmm", want)
        reqs[T] = {"launches": want, "tokens": toks}
    moe["requests"] = reqs
    del eng2, p2

    # one layer's decode FFN under the sync debug mode: the routing and the
    # expert index never reach the host
    lp = fuse_serving(spec, params, a8=True)["layers"][0]
    x = torch.randn((1, 1, spec.hidden), device=device).to(torch.bfloat16)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe_ffn(spec, lp, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    expect(launch_counts(), {"select": 6}, "moe_ffn under sync debug")
    assert bool(torch.isfinite(y).all())
    log("moe_ffn at N = 1 ran under torch.cuda.set_sync_debug_mode('error'): "
        "6 select launches, no host sync")
    del params, lp
    torch.cuda.empty_cache()

    # the whole model: 32 layers on the card, no checkpoint on disk
    spec = mixtral_spec(32)
    t0 = time.perf_counter()
    params = synth_moe_params(spec, device, seed=5)
    assert quantize_lm_head(spec, params, bits=8)
    fused = fuse_serving(spec, params, a8=True)
    torch.cuda.synchronize()
    t_syn = time.perf_counter() - t0
    alloc = torch.cuda.memory_allocated() / 2**30
    ids = np.random.default_rng(15).integers(0, spec.vocab, size=(1, n_tok))
    reset_counts()
    bench = benchmark_decode(spec, fused, ids, cache_dtype=torch.int8,
                             log=lambda s: None)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect(counts, moe_decode_counts(spec.n_layers, warmup + n_tok),
           "MoE 32 layers")
    nbytes = moe_step_bytes(spec, params, n_tok // 2)
    r32 = {"median_ms": bench["median_s"] * 1e3,
           "tokens_per_s": bench["tokens_per_s"],
           "p90_ms": bench["p90_s"] * 1e3, "launches": counts,
           "synth_s": t_syn, "allocated_gib": alloc, "step_bytes": nbytes,
           "bound_ms": nbytes / peaks["bw"] * 1e3}
    eng = DecodeEngine(spec, fused, max_len=256, batch=1,
                       cache_dtype=torch.int8, a8=True)
    prof = profile_decode(eng, np.random.default_rng(16).integers(
        0, spec.vocab, size=(1, 16)))
    if prof["device_ms"] > 0:
        prof["device_busy_share"] = prof["device_ms"] / r32["median_ms"]
    r32["profile"] = prof
    log(f"decode moe (32 layers, Mixtral-8x7B width, w4a8 + w8 head + int8 "
        f"KV, B=1, in-process benchmark_decode): median "
        f"{r32['median_ms']:.3f} ms/token, {r32['tokens_per_s']:.2f} tok/s "
        f"on {card}; {alloc:.1f} GiB on the card; byte bound "
        f"{r32['bound_ms']:.3f} ms/token ({nbytes / 1e9:.3f} GB per step)")
    log("decode profile moe32 " + json.dumps(prof))
    moe["decode32"] = r32
    del eng, fused, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase: sequence-parallel serving (SPEngine) at sp = 1
# ---------------------------------------------------------------------------

def tinyllama_spec(n_layers: int = 22):
    """TinyLlama-1.1B's published config (hidden 2048, 32 heads, 4 KV
    heads, head dim 64, ffn 5632, vocab 32000)."""
    from gptq_tpu_torch.models.common import ArchSpec

    return ArchSpec(arch="llama", n_layers=n_layers, hidden=2048, n_heads=32,
                    n_kv_heads=4, ffn=5632, vocab=32000, max_pos=2048,
                    act="silu", pos="rope", norm_type="rmsnorm",
                    linear_bias=False, tie_embeddings=False)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed_steps(eng, cache, tok, n) -> tuple:
    """n synchronised eager decode steps: (per-step seconds, cache, tok)."""
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        logits, cache = eng.step(cache, tok)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("sp decode: non-finite logits")
    return times, cache, tok


def phase_sp(device, card, report):
    """SPEngine (parallel/sp.py, engine/serving.py) on a one-rank NCCL
    process group: the SPCache layout, the content mask, #10 on every
    layer of every step, the fresh-pair merge, the all_reduce combine and
    the deferred write all run on the card at sp = 1."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        sp_serve(device, card, report)
        torch.cuda.empty_cache()
        sp_tiny(device, report)
    finally:
        dist.destroy_process_group()


def sp_serve(device, card, report):
    """The 32-layer llama-7B-width checkpoint of the serve phase through
    SPEngine(sp=1): fused route, a8, the 8-bit head, int8 cache, max_len
    2048 (per-token median, chained benchmark, profile), a 1,024-token
    prompt through the ring prefill and 64 decoded tokens; then 2 layers
    on a bf16 cache: greedy tokens against the plain versions and the
    logits against DecodeEngine's flat decode."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.engine.serving import SPEngine
    from gptq_tpu_torch.pipeline import quantize_lm_head

    spec = llama7b_spec(32)
    L = spec.n_layers
    params = synth_packed_params(spec, device, seed=0)
    assert quantize_lm_head(spec, params, bits=8)
    eng = SPEngine(spec, params, sp=1, max_len=2048, cache_dtype=torch.int8,
                   fuse=True, a8=True, device=device)
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, spec.vocab, size=(1, 64))
    logits, cache = eng.prefill(torch.as_tensor(prompt, device=device))
    tok = logits.argmax(-1)[:, None]
    reset_counts()
    _, cache, tok = timed_steps(eng, cache, tok, 4)
    expect(launch_counts(), {"partial_wide": 4 * L, "norm_qkv": 4 * (L + 1),
                             "attn_mlp": 4 * L}, "sp decode (4 steps)")
    n_tok = 128
    times, cache, tok = timed_steps(eng, cache, tok, n_tok)
    counts = launch_counts()
    expect(counts, {"partial_wide": (4 + n_tok) * L,
                    "norm_qkv": (4 + n_tok) * (L + 1),
                    "attn_mlp": (4 + n_tok) * L}, "sp decode")
    r = {"median_ms": float(np.median(times)) * 1e3,
         "p90_ms": float(np.percentile(times, 90)) * 1e3,
         "tokens_per_s": 1.0 / float(np.median(times)), "n_tokens": n_tok,
         "launches": counts}
    # the host's cost of one combine all_reduce (one-rank NCCL group)
    import torch.distributed as dist

    buf = torch.zeros((1, spec.n_heads, spec.hd + 1), device=device)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    r["all_reduce_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    ids = rng.integers(0, spec.vocab, size=(1, 128))
    reset_counts()
    r["chained"] = eng.benchmark_chained(ids, log=lambda s: None)
    r["chained"]["launches_eager_and_captured"] = launch_counts()
    prof = profile_decode(eng, prompt)
    if prof["device_ms"] > 0:
        prof["device_busy_share"] = prof["device_ms"] / r["median_ms"]
    r["profile"] = prof
    c = r["chained"]
    log(f"sp decode (sp=1, 32 layers, w4a8 + w8 head, int8 KV, max_len "
        f"2048, B=1): median {r['median_ms']:.3f} ms/token "
        f"({r['tokens_per_s']:.2f} tok/s), chained "
        f"{c['per_token_s'] * 1e3:.3f} ms/token (full {c['full_run_s']:.4f} "
        f"s, half {c['half_run_s']:.4f} s, below noise floor "
        f"{c['below_noise_floor']}), one all_reduce {r['all_reduce_ms']:.4f} "
        f"ms of host time, on {card}; launches " + json.dumps(counts))
    log("decode profile sp " + json.dumps(prof))
    # long context: a 1,024-token prompt through the ring prefill, then 64
    # decoded tokens over ~1,100 filled slots
    long_ids = rng.integers(0, spec.vocab, size=(1, 1024))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(torch.as_tensor(long_ids, device=device))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("sp ring prefill: non-finite logits")
    times, cache, _ = timed_steps(eng, cache, logits.argmax(-1)[:, None], 64)
    filled = int((cache.pos >= 0).sum())
    assert cache.length == 1024 + 64 and filled == 1024 + 64
    r["long"] = {"prompt": 1024, "new_tokens": 64, "filled_slots": filled,
                 "prefill_s": prefill_s,
                 "median_ms": float(np.median(times)) * 1e3}
    log(f"sp long context: 1,024-token ring prefill {prefill_s:.3f} s, then "
        f"64 tokens at {filled} filled slots: median "
        f"{r['long']['median_ms']:.3f} ms/token on {card}")
    del eng, cache, logits
    torch.cuda.empty_cache()

    # 2 layers on a bf16 cache: kernels against the plain versions, and
    # the SP decode's logits against DecodeEngine's flat decode
    small = llama7b_spec(2)
    p2 = {**params, "layers": params["layers"][:2]}
    del params
    eng2 = SPEngine(small, p2, sp=1, max_len=128, cache_dtype=torch.bfloat16,
                    fuse=True, a8=True, device=device)
    prompt2 = rng.integers(0, small.vocab, size=(1, 64))
    toks = greedy_check("2-layer SP decoding (bf16 KV)", eng2, prompt2, 16,
                        "partial_wide")
    flat = DecodeEngine(small, p2, max_len=128, batch=1,
                        cache_dtype=torch.bfloat16, a8=True)
    r.update(sp_vs_flat("2-layer SP decode", eng2, flat, prompt2, toks,
                        {"partial_wide": 16 * 2, "norm_qkv": 16 * 3,
                         "attn_mlp": 16 * 2})[0])
    r["greedy_tokens"] = toks
    report["sp"] = r


def teacher_forced(eng, prompt, toks) -> tuple:
    """The logits of the prefill and of one eager step per token of toks,
    stacked in f32, and the launch counts of those steps alone."""
    import torch

    logits, cache = eng.prefill(torch.as_tensor(prompt, device=eng.device))
    rows = [logits[0].float()]
    reset_counts()
    for t in toks:
        logits, cache = eng.step(cache, torch.tensor([[t]], device=eng.device))
        rows.append(logits[0].float())
    torch.cuda.synchronize()
    return torch.stack(rows), launch_counts()


def sp_vs_flat(what, eng, flat, prompt, toks, want_counts) -> tuple:
    """The SP decode's logits against DecodeEngine's flat decode on the
    same weights and cache dtype, at the prefill and at every step of toks
    (teacher-forced): the worst row's max |sp - flat| / max |flat| must
    stay within TOL["logits_a8"]. The same reading with a planted fault,
    the token's own k / v pair left out of the combine, must exceed it
    (else the limit could not tell). The SP steps must launch exactly
    want_counts. Returns (readings, those counts)."""
    from gptq_tpu_torch.parallel import sp

    def rel(got, want):
        return float(((got - want).abs().amax(-1)
                      / want.abs().amax(-1)).max())

    want, _ = teacher_forced(flat, prompt, toks)
    got, counts = teacher_forced(eng, prompt, toks)
    expect(counts, want_counts, f"{what}: {len(toks)} steps")
    combine = sp._sp_fresh_combine

    def fresh_pair_skipped(spec, q, k, v, parts, my_turn, *rest):
        return combine(spec, q, k, v, parts, False, *rest)

    with mock.patch.object(sp, "_sp_fresh_combine", fresh_pair_skipped):
        faulty, _ = teacher_forced(eng, prompt, toks)
    out = {"vs_flat_rel": rel(got, want),
           "fresh_pair_skipped_rel": rel(faulty, want),
           "vs_flat_steps": len(toks)}
    log(f"{what} vs DecodeEngine's flat decode (prefill + {len(toks)} "
        f"teacher-forced steps): max |sp - flat| / max |flat| "
        f"{out['vs_flat_rel']:.4g} (limit {TOL['logits_a8']}); with the "
        f"fresh pair left out of the combine (planted fault) "
        f"{out['fresh_pair_skipped_rel']:.4g}")
    if not out["vs_flat_rel"] <= TOL["logits_a8"]:
        raise AssertionError(f"{what} parts from the flat decode: {out}")
    if not out["fresh_pair_skipped_rel"] > TOL["logits_a8"]:
        raise AssertionError(f"{what}: the SP-vs-flat limit cannot see a "
                             f"fresh pair left out: {out}")
    return out, counts


def sp_tiny(device, report):
    """2 layers at TinyLlama-1.1B width (hd 64: #11) through SPEngine:
    greedy tokens against the plain versions, and the logits against the
    flat decode over 16 eager steps, whose #11 launches the kernels line
    reports."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.engine.serving import SPEngine
    from gptq_tpu_torch.pipeline import quantize_lm_head

    spec = tinyllama_spec(2)
    params = synth_packed_params(spec, device, seed=3)
    assert quantize_lm_head(spec, params, bits=8)
    eng = SPEngine(spec, params, sp=1, max_len=128,
                   cache_dtype=torch.bfloat16, fuse=True, a8=True,
                   device=device)
    prompt = np.random.default_rng(22).integers(0, spec.vocab, size=(1, 64))
    toks = greedy_check("2-layer SP decoding at TinyLlama width (hd 64, "
                        "bf16 KV)", eng, prompt, 16, "partial")
    flat = DecodeEngine(spec, params, max_len=128, batch=1,
                        cache_dtype=torch.bfloat16, a8=True)
    r, counts = sp_vs_flat("2-layer SP decode at TinyLlama width", eng, flat,
                           prompt, toks, {"partial": 16 * 2,
                                          "norm_qkv": 16 * 3,
                                          "attn_mlp": 16 * 2})
    report["sp_tiny"] = {"greedy_tokens": toks, "launches": counts, **r}


# ---------------------------------------------------------------------------
# phase 7: the quantize CLI from a model directory
# ---------------------------------------------------------------------------

# LLaMA-7B's published config (huggyllama/llama-7b config.json), depth cut
LLAMA7B_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "hidden_size": 4096, "intermediate_size": 11008,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "num_hidden_layers": 32, "max_position_embeddings": 2048,
              "rms_norm_eps": 1e-06, "vocab_size": 32000,
              "hidden_act": "silu", "tie_word_embeddings": False,
              "torch_dtype": "float16"}


def write_hf_llama(path, n_layers, device, seed=0) -> int:
    """An HF llama checkpoint directory at LLaMA-7B width: config.json and
    one F16 model.safetensors (8-byte header length, JSON header, raw
    bytes) of seeded random weights, scaled as models.common.init_params
    scales them, written tensor by tensor. Returns the bytes written."""
    import torch

    cfg = dict(LLAMA7B_HF, num_hidden_layers=n_layers)
    H, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    shapes = {"model.embed_tokens.weight": (V, H)}
    for i in range(n_layers):
        lp = f"model.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            shapes[f"{lp}self_attn.{name}.weight"] = (H, H)
        shapes[f"{lp}mlp.gate_proj.weight"] = (F, H)
        shapes[f"{lp}mlp.up_proj.weight"] = (F, H)
        shapes[f"{lp}mlp.down_proj.weight"] = (H, F)
        shapes[f"{lp}input_layernorm.weight"] = (H,)
        shapes[f"{lp}post_attention_layernorm.weight"] = (H,)
    shapes["model.norm.weight"] = (H,)
    shapes["lm_head.weight"] = (V, H)
    header, off = {}, 0
    for name, shape in shapes.items():
        n = 2 * math.prod(shape)
        header[name] = {"dtype": "F16", "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for name, shape in shapes.items():
            if len(shape) == 1:
                t = torch.ones(shape, device=device)
            else:
                scale = (0.02 if name.startswith(("model.embed", "lm_head"))
                         else 0.4 / math.sqrt(shape[1]))
                t = torch.randn(shape, generator=gen, device=device) * scale
            f.write(t.to(torch.float16).view(torch.int16).cpu().numpy()
                    .tobytes())
    return 8 + len(head) + off


class SmokeTokenizer:
    """Stands in for the model's tokenizer: text -> seeded synthetic ids,
    2,100 to 4,097 of them as the text grows (every c4 document is longer
    than a 2,048-token window; a joined test split holds two windows)."""

    def __init__(self, vocab):
        self.vocab = vocab

    def __call__(self, text, **kw):
        from types import SimpleNamespace

        from gptq_tpu_torch.data import synthetic_stream

        n = min(max(len(text) // 4, 2100), 2 * 2048 + 1)
        return SimpleNamespace(input_ids=synthetic_stream(
            self.vocab, n, seed=len(text) % 997))


@contextlib.contextmanager
def offline_data(vocab):
    """The CLI's tokenizer (gptq_tpu_torch.cli.load_tokenizer) and the HF
    `datasets` module, stood in: 64 seeded documents per split."""
    import zlib
    from types import SimpleNamespace

    from gptq_tpu_torch import cli

    def load_dataset(path, *a, split=None, **kw):
        rng = np.random.default_rng(zlib.crc32(f"{path}/{split}".encode()))
        rows = [" ".join(f"w{int(v)}" for v in rng.integers(
            0, 5000, size=int(rng.integers(300, 1500)))) for _ in range(64)]
        return _Split(rows, "sentence" if path == "ptb_text_only"
                      else "text")

    tok = SmokeTokenizer(vocab)
    with mock.patch.object(cli, "load_tokenizer",
                           lambda model, required=True: tok), \
            mock.patch.dict(sys.modules, {"datasets": SimpleNamespace(
                load_dataset=load_dataset)}):
        yield tok


class _Split:
    """A datasets split stand-in: rows by index, a column by name."""

    def __init__(self, rows, key):
        self.rows, self.key = rows, key

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.rows
        return {self.key: self.rows[i]}


STAGES = (("convert", r"converted .* in ([0-9.]+)s"),
          ("calibrate", r"calibration set .* in ([0-9.]+)s"),
          ("quantize", r"quantization done in ([0-9.]+)s"),
          ("pack", r"packed in ([0-9.]+)s"),
          ("save", r"saved .* in ([0-9.]+)s"))


def cli_quantize(what, argv, want_counts) -> dict:
    """One run of gptq_tpu_torch.cli.main on a model directory under the
    stood-in data; the kernel launches of the run (all of them in its PPL
    evals: the calibration runs dense weights) must equal
    want_counts(windows evaluated). Returns the stage times, the PPLs and
    the launch counts."""
    import re

    import torch

    from gptq_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log(f"cli {what} | {line}")
    assert rc == 0, rc
    stages = {k: float(m.group(1)) for k, pat in STAGES
              if (m := re.search(pat, out))}
    stages["layers"] = [float(v) for v in
                        re.findall(r"layer \d+ done in ([0-9.]+)s", out)]
    ppl = {m.group(1): float(m.group(2)) for m in
           re.finditer(r"^(\S+): ppl (\S+) in", out, re.M)}
    stages["evals"] = {m.group(1): float(m.group(2)) for m in
                       re.finditer(r"^(\S+): ppl \S+ in ([0-9.]+)s", out,
                                   re.M)}
    windows = sum(int(w) for w in re.findall(r"over (\d+) windows", out))
    if len(ppl) != 3 or not all(map(math.isfinite, ppl.values())):
        raise AssertionError(f"cli {what}: PPL lines {ppl}")
    expect(counts, want_counts(windows), f"cli {what} PPL evals")
    log(f"cli {what}: {wall:.1f} s wall; stages " + json.dumps(stages)
        + f"; PPL {json.dumps(ppl)} over {windows} windows; launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    return {"wall_s": wall, "stages": stages, "ppl": ppl,
            "windows": windows, "launches": counts}


def dense_ppl(spec, path, tok, device) -> float:
    """wikitext2 PPL of a saved checkpoint with every packed linear (the
    head too) dequantized to dense f32: the packed evals' reference."""
    from gptq_tpu_torch.data import get_loaders
    from gptq_tpu_torch.eval.ppl import eval_ppl
    from gptq_tpu_torch.io import load_checkpoint
    from gptq_tpu_torch.ops.pack import PackedWeight

    _, params, _ = load_checkpoint(path, device=device)
    dense = dense_twin(params)
    if isinstance(params["lm_head"]["w"], PackedWeight):
        dense["lm_head"] = {"w": dense_weight(params["lm_head"]["w"]),
                            "b": None}
    _, test = get_loaders("wikitext2", seed=0, seqlen=spec.max_pos,
                          tokenizer=tok)
    return eval_ppl(spec, dense, test.input_ids, spec.max_pos,
                    log=lambda s: None)


def phase_cli(device, tmp, report):
    """quantize from a model directory through the CLI: a 2-layer
    LLaMA-7B-width HF directory (F16 safetensors) -> convert -> calibrate
    (16 c4 windows of 2,048) -> GPTQ w4 g128 act-order true-sequential ->
    pack (+ the 8-bit head) -> save -> PPL through #1; then --lut_eval
    (3-bit g128) -> sign planes -> PPL through #13; each PPL against the
    dense twin of its saved file; then the saved w4 file served through
    the CLI (--benchmark 32 --faster-kernel --int8_kv: act-order weights
    take the unfused route, the 8-bit head the fused one). --new-eval
    keeps each test set at two windows (c4's classic protocol evaluates
    256)."""
    from gptq_tpu_torch.models.convert import hf_config
    from gptq_tpu_torch.models.registry import spec_from_hf_config

    L = 2
    hf = os.path.join(tmp, "llama-7b-2l")
    t0 = time.perf_counter()
    nbytes = write_hf_llama(hf, L, device, seed=7)
    write_s = time.perf_counter() - t0
    spec = spec_from_hf_config(hf_config(hf))
    log(f"cli: wrote a {L}-layer LLaMA-7B-width HF directory (F16 "
        f"safetensors, {nbytes / 2**30:.2f} GiB) in {write_s:.1f} s")
    log("cli: the tokenizer (gptq_tpu_torch.cli.load_tokenizer) and the "
        "`datasets` module are stood in: seeded synthetic ids of 64 "
        "seeded documents per split (no tokenizer files, no download)")
    q4, qb = os.path.join(tmp, "cli_w4.npz"), os.path.join(tmp, "cli_b3.npz")
    common = ["--nsamples", "16", "--new-eval", "--results_log",
              os.path.join(tmp, "ppl.txt")]
    out = {"write_s": write_s, "bytes": nbytes}
    with offline_data(spec.vocab) as tok:
        out["w4"] = cli_quantize(
            "w4", [hf, "c4", "--wbits", "4", "--groupsize", "128",
                   "--act-order", "--true-sequential", "--eval_pack",
                   "--quant_lm_head", "8", "--save", q4, *common],
            lambda w: {"qmm": w * (7 * L + 1)})
        out["b3"] = cli_quantize(
            "lut b3", [hf, "c4", "--wbits", "3", "--groupsize", "128",
                       "--lut_eval", "--eval_pack", "--save", qb, *common],
            lambda w: {"bcq": w * 7 * L})
        for tag, path in (("w4", q4), ("b3", qb)):
            ppl = out[tag]["ppl"]["wikitext2"]
            ref = dense_ppl(spec, path, tok, device)
            rel = abs(ppl / ref - 1.0)
            log(f"cli {tag}: wikitext2 PPL packed {ppl:.4f} vs "
                f"dense-dequantized {ref:.4f}: rel diff {rel:.2e}")
            if not rel < 0.005:
                raise AssertionError(f"cli {tag}: packed vs dense PPL differ "
                                     f"by {rel:.3g}")
            out[tag]["ppl_dense"] = ref
    n_tok, steps = 32, 100 + 32
    bench, counts, _ = serve_cli(q4, n_tok, ["--faster-kernel", "--int8_kv"],
                                 "auto")
    # act-order weights keep the unfused route (one qmm launch per linear
    # of q|k|v, o, gate|up, down); the packed 8-bit head runs fused
    expect(counts, {"qmm": 4 * L * steps, "norm_qkv": steps,
                    "attention": L * steps}, "cli serve of the saved file")
    out["serve"] = {"median_ms": bench["median_s"] * 1e3,
                    "tokens_per_s": bench["tokens_per_s"], "launches": counts}
    report["cli"] = out


def phase_moe(device, tmp, card, peaks, report):
    moe_quantize(device, tmp, report)
    import torch

    torch.cuda.empty_cache()
    moe_serve(device, tmp, card, peaks, report)


def profile_decode(eng, prompt, steps=8) -> dict:
    """Device time per decode step by kernel family, from a torch.profiler
    trace of `steps` steps after a 64-token prefill. The profiled steps'
    wall time includes the profiler's own overhead; the busy share is
    taken against the unprofiled benchmark median instead. A trace that
    holds no device events reports device_ms 0 (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logits, cache = eng.prefill(torch.as_tensor(prompt, device=eng.device))
    tok = logits.argmax(-1)[:, None]
    for _ in range(3):
        logits, cache = eng.step(cache, tok)
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = eng.step(cache, tok)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams = (("qmm", ("qmm_kernel", "qmv_kernel")),
            ("select", ("qsel_kernel",)), ("expert", ("qexpert_kernel",)),
            ("bcq", ("bcq_mv_kernel", "bcq_mm_kernel")),
            ("stream", ("qstream_kernel",)),
            ("attention", ("attn_partial", "attn_combine")),
            ("partial", ("attnp_split", "attnp_combine")),
            ("norm_qkv", ("norm_qkv_kernel",)), ("mlp", ("mlp_kernel",)),
            ("layer", ("layer_kernel",)))
    ms = {f: 0.0 for f, _ in fams}
    ms["other"] = 0.0
    n = dict.fromkeys(ms, 0.0)
    host = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3 / steps, e.key,
                         e.count / steps))
            continue
        fam = next((f for f, keys in fams if any(k in e.key for k in keys)),
                   "other")
        ms[fam] += e.device_time_total / 1e3 / steps
        n[fam] += e.count / steps
    # the host side: the operators with the most self CPU time a step
    # (under the profiler, which adds its own cost to each)
    host_top = [{"op": k, "self_ms": t, "calls": c}
                for t, k, c in sorted(host, reverse=True)[:8]]
    return {"steps": steps, "profiled_wall_ms": wall / steps * 1e3,
            "device_ms": sum(ms.values()),
            "device_ms_by_family": ms, "device_events_per_step": n,
            "host_top": host_top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gptq_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
        f"(torch.backends.cuda.matmul.allow_tf32 = False)")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + json.dumps({k: round(v["seconds"], 1) for k, v in built.items()}))
    for name, r in built.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    report = {}
    timer = device_ms
    if "kernels" in phases:
        for check in (qmm_checks, attn_checks, fused_checks,
                      fused_bcq_checks, layer_checks, bcq_checks,
                      stream_checks, expert_checks, partial_checks):
            t0 = time.perf_counter()
            check(device, peaks, timer, report)
            log(f"{check.__name__}: {time.perf_counter() - t0:.1f} s")
        quant_tie_check(device, report)
    tmp = tempfile.mkdtemp(prefix="gptq_tpu_torch_smoke_")
    try:
        for phase, run in (
                ("quantize", lambda: (phase_quantize(device, tmp, report),
                                      phase_quantize_bcq(device, tmp,
                                                         report))),
                ("serve", lambda: phase_serve(device, tmp, card, report)),
                ("sp", lambda: (phase_sp(device, card, report),
                                torch.cuda.empty_cache())),
                ("moe", lambda: phase_moe(device, tmp, card, peaks, report)),
                ("cli", lambda: phase_cli(device, tmp, report))):
            if phase in phases:
                t0 = time.perf_counter()
                run()
                log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    if "kernels" in phases:
        serve = report.get("serve", {})
        fused_launches = serve.get("fused", {}).get("launches", {})

        def timed(kernel, tag):
            return next(r for r in report["fused_rows"] if r["kernel"] == kernel
                        and r["w"] == tag and "ms" in r)

        def bcq_branch(name):
            """The BCQ branch's readings (the same kernel; BCQ weights
            never take the fused route from the model, so its launches are
            the checks' only)."""
            rs = [r for r in report["fused_bcq_rows"] if r["kernel"] == name]
            head = next(r for r in rs if r["w"] == "w3g128" and r["M"] == 1
                        and r["a8"])
            return {"max_abs_err": report["fused_bcq_max_abs_err"][name],
                    **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "unfused_ms")},
                    "shape": "3-bit BCQ sign planes g128, a8, M=1",
                    "rows": [{k: r[k] for k in ("w", "M", "a8", "ms",
                                                "plain_ms", "unfused_ms",
                                                "bound_ms", "rel_err")}
                             for r in rs]}

        def fused_entry(name, line, row, launches, shape):
            return {"name": name, "route": "cuda", "source": FFN_SRC,
                    "replaces": f"gptq_tpu/ops/ffn.py:{line}",
                    "launches": launches,
                    "max_abs_err": report["fused_max_abs_err"][name],
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    # no one PyTorch call computes these functions
                    "library_ms": None, "unfused_ms": row["unfused_ms"],
                    "wrapper_ms": row["wrapper_ms"], "shape": shape,
                    "bcq": bcq_branch(name)}

        dec = [r for r in report["qmm_rows"]
               if r["w"] == "w4g-1" and r["M"] == 1 and r["a8"]]
        at = report["attn_times"][0]
        kernels = [
            {"name": "qmm", "route": "cuda", "source": QMM_SRC,
             "replaces": "gptq_tpu/ops/qmatmul.py:156",
             # on the unfused route (the fused one launches no qmm at decode)
             "launches": serve.get("unfused", {}).get("launches", {})
             .get("qmm", 0),
             "max_abs_err": report["qmm_max_abs_err"],
             "ms": sum(r["ms"] for r in dec),
             "plain_ms": sum(r["plain_ms"] for r in dec),
             "bound_ms": sum(r["bound_ms"] for r in dec),
             "bound_by": "bytes",
             "library_ms": sum(r["library_ms"] for r in dec),
             "shape": "one llama-7B layer's four packed linears (K x N: "
                      "4096x12288, 4096x4096, 4096x22528, 11264x4096), "
                      "w4a8 groupsize -1, M=1; times summed"},
            {"name": "decode_attention", "route": "cuda", "source": ATTN_SRC,
             "replaces": "gptq_tpu/ops/attention.py:253",
             # the head-loop kernel computes the same function (hd % 128 != 0)
             "also_replaces": "gptq_tpu/ops/attention.py:40",
             "launches": fused_launches.get("attention", 0),
             "max_abs_err": report["attn_max_abs_err"],
             "ms": at["ms"], "plain_ms": at["plain_ms"],
             "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
             "library_ms": at["library_ms"],
             "shape": f"B=1, H=Hkv=32, hd=128, int8 cache S={at['S']}, "
                      f"{at['length']} filled + fresh pair"},
            fused_entry("norm_qkv", 483, timed("norm_qkv", "q|k|v w4g-1"),
                        fused_launches.get("norm_qkv", 0),
                        "ln1 + q|k|v 4096x12288 w4a8 g-1, M=1 (head 4096x32256 "
                        "w8a8 in head_*)"),
            fused_entry("attn_mlp", 383, timed("attn_mlp", "w4g-1"),
                        fused_launches.get("attn_mlp", 0),
                        "o 4096x4096 + ln2 + gate|up 4096x22528 + down "
                        "11264x4096, w4a8 g-1, M=1"),
            fused_entry("ffn", 312, timed("ffn", "w4g-1"),
                        report.get("ffn_route_launches", {}).get("ffn", 0),
                        "gate|up 4096x22528 + down 11264x4096, w4a8 g-1, M=1; "
                        "launches from the 2-layer act-order-o route"),
        ]
        lr = [r for r in report["layer_rows"] if "ms" in r]
        kernels.append({
            "name": "layer_fused", "route": "cuda", "source": LAYER_SRC,
            "replaces": "gptq_tpu/ops/layer_fused.py:97",
            "launches": serve.get("layer", {}).get("launches", {})
            .get("layer", 0),
            "max_abs_err": report["layer_max_abs_err"],
            "ms": lr[0]["ms"], "plain_ms": lr[0]["plain_ms"],
            "bound_ms": lr[0]["bound_ms"], "bound_by": lr[0]["bound_by"],
            # no one PyTorch call computes a decoder layer
            "library_ms": None, "fused_route_ms": lr[0]["fused_route_ms"],
            "wrapper_ms": lr[0]["wrapper_ms"],
            "long": {k: lr[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "fused_route_ms")},
            "shape": "one llama-7B layer (q|k|v 4096x12288, o 4096x4096, "
                     "gate|up 4096x22528, down 11264x4096), w4a8 g-1, bf16 "
                     "cache S=256 with 128 filled (long: S=2048, 1,100 "
                     "filled); launches from the 32-layer CLI serve on the "
                     "layer route"})
        head = timed("norm_qkv", "head w8g-1")
        kernels[2].update({f"head_{k}": head[k] for k in
                           ("ms", "plain_ms", "bound_ms", "unfused_ms")})

        def summed(rows, key):
            vals = [r[key] for r in rows]
            return None if None in vals else sum(vals)

        layer = ("one llama-7B layer's four packed linears (K x N: "
                 "4096x12288, 4096x4096, 4096x22528, 11264x4096), M=1, "
                 "times summed")
        sd, bd = report["stream_decode"], report["bcq_decode"]
        kernels.append({
            "name": "streamed_qmm", "route": "cuda", "source": STREAM_SRC,
            "replaces": "gptq_tpu/ops/qmatmul.py:205",
            "launches": serve.get("streamed", {}).get("launches", {})
            .get("stream", 0),
            "max_abs_err": report["stream_max_abs_err"],
            "ms": summed(sd, "ms"), "plain_ms": summed(sd, "plain_ms"),
            "bound_ms": summed(sd, "bound_ms"), "bound_by": "bytes",
            "library_ms": summed(sd, "library_ms"),
            "qmm_ms": summed(sd, "qmm_ms"),
            "wrapper_ms": summed(sd, "wrapper_ms"),
            "shape": layer + "; w4a8 groupsize -1; launches from the 2-layer "
                             "streamed serve"})
        kernels.append({
            "name": "bcq_matmul", "route": "cuda", "source": BCQ_SRC,
            "replaces": "gptq_tpu/ops/bcq_matmul.py:70",
            "launches": serve.get("bcq", {}).get("launches", {})
            .get("bcq", 0),
            "max_abs_err": report["bcq_max_abs_err"],
            "ms": summed(bd, "ms"), "plain_ms": summed(bd, "plain_ms"),
            "bound_ms": summed(bd, "bound_ms"), "bound_by": "bytes",
            "library_ms": summed(bd, "library_ms"),
            "wrapper_ms": summed(bd, "wrapper_ms"),
            "m512": {k: report["bcq_m512"][k] for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by")},
            "shape": layer + "; 3-bit BCQ groupsize 128, a8 (m512: "
                             "4096x12288, M=512, bf16 x)"})
        if "expert_rows" in report:
            moe = report.get("moe", {})
            ex = {r["w"]: r for r in report["expert_rows"]
                  if "ms" in r and "e" not in r}
            se = {r["w"]: r for r in report["expert_rows"]
                  if "ms" in r and "e" in r}
            # one layer's 16-token prefill: gate and up share x (the gate
            # bank stands for both), down takes x per expert
            pre = [ex["gate w4g-1"], ex["gate w4g-1"], ex["down w4g-1"]]
            # one layer's decode: top-2 x (gate, up, down)
            dec = [se["gate w4g-1"], se["up w4g-1"], se["down w4g-1"]] * 2
            kernels.append({
                "name": "expert_matmul", "route": "cuda", "source": MOE_SRC,
                "replaces": "gptq_tpu/ops/qmatmul.py:177",
                "launches": sum(r["launches"].get("expert", 0) for r in
                                moe.get("requests", {}).values()),
                "max_abs_err": report["expert_max_abs_err"],
                "ms": summed(pre, "ms"), "plain_ms": summed(pre, "plain_ms"),
                "bound_ms": summed(pre, "bound_ms"), "bound_by": "bytes",
                "library_ms": summed(pre, "library_ms"),
                "cuda_core_ms": summed(pre, "cuda_core_ms"),
                "shape": "one Mixtral-8x7B layer's three banks at a 16-token "
                         "prefill (8 x 4096x14336 gate / up, x shared; 8 x "
                         "14336x4096 down, x per expert), 4-bit g-1, bf16 x, "
                         "times summed; launches from the 2-layer requests"})
            kernels.append({
                "name": "expert_select", "route": "cuda", "source": MOE_SRC,
                "replaces": "gptq_tpu/ops/qmatmul.py:730",
                "launches": moe.get("cli8", {}).get("launches", {})
                .get("select", 0),
                "max_abs_err": report["expert_max_abs_err"],
                "ms": summed(dec, "ms"), "plain_ms": summed(dec, "plain_ms"),
                "bound_ms": summed(dec, "bound_ms"), "bound_by": "bytes",
                "library_ms": summed(dec, "library_ms"),
                "shape": "one Mixtral-8x7B layer's six decode selections "
                         "(top-2 x gate / up 4096x14336, down 14336x4096), "
                         "4-bit g-1, M=1 bf16 x, index in device memory, "
                         "times summed; launches from the 8-layer CLI "
                         "serve"})
        pr = report["partial_rows"]
        yard = ("scaled_dot_product_attention over the layer's dequantized "
                "bf16 cache with the pos mask: the normalised output, not "
                "(m, l, acc)")

        def partial_entry(name, line, row, launches, shape):
            return {"name": name, "route": "cuda", "source": PARTIAL_SRC,
                    "replaces": f"gptq_tpu/ops/attention.py:{line}",
                    "launches": launches,
                    "max_abs_err": report["partial_max_abs_err"],
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "library_note": yard,
                    "shape": shape,
                    "rows": [{k: r[k] for k in ("case", "cache", "ms",
                                                "plain_ms", "bound_ms",
                                                "library_ms")}
                             for r in pr if r["entry"] == row["entry"]]}

        cut = "stacked cache of 2048 local slots, 1,100 valid (round-robin)"
        kernels.append(partial_entry(
            "decode_attention_partial_wide", 497,
            next(r for r in pr if r["case"] == "llama-7B"
                 and r["cache"] == "int8"),
            report.get("sp", {}).get("launches", {}).get("partial_wide", 0),
            "B=1, H=Hkv=32, hd=128, int8 " + cut + " of 32 layers; launches "
            "from 132 eager steps of the 32-layer SPEngine(sp=1) decode"))
        kernels.append(partial_entry(
            "decode_attention_partial", 684,
            next(r for r in pr if r["entry"] == "narrow"
                 and r["cache"] == "int8"),
            report.get("sp_tiny", {}).get("launches", {}).get("partial", 0),
            "TinyLlama-1.1B: B=1, H=32, Hkv=4, hd=64, int8 " + cut + " of 22 "
            "layers; launches from 16 eager steps of the 2-layer "
            "TinyLlama-width SPEngine(sp=1) decode"))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
