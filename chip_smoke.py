#!/usr/bin/env python3
"""Smoke run of gptq_tpu_torch (the PyTorch / CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one GPU

Phases, in order (any failure exits non-zero; there is no CPU fallback):
  1. build   - nvcc builds the ten kernel libraries from csrc/ (qmatmul,
               ffn, bcq_matmul, qstream, qexpert, layer_fused,
               attention_partial, qmma, qexpert_mma, ffn_rows; in
               parallel) and
               prints each kernel's ptxas line (registers, spills, shared
               memory).
  2. kernels - each kernel's wrapper against its plain PyTorch version on
               the card at llama-7B shapes, with stated tolerances, and
               timed beside its plain version, a one-call PyTorch
               yardstick (or, for the fused kernels, the unfused route of
               the same function) and the card's bound. At one row #5 /
               #6 run on #12's weight stream (mlp_stream_kernel) and #4
               on #1's single-row stream (norm_qkv_gemv_kernel: llama-7B
               and Mixtral-8x7B q|k|v, the 8-bit head), each held to the
               plain version with the near-tie rule and timed beside the
               tiled kernel it replaced there (mlp_kernel,
               norm_qkv_kernel), two launches bit for bit. At rows 2-32
               (rows_checks) #4 and #5 / #6 run on the tensor cores
               (norm_qkv_rows_kernel, mlp_rows_kernel): held to their
               plain versions with the near-tie rule at M 2-32, two
               launches bit for bit, each row the same bits at M = 4 and
               32 in other slots, and timed at M = 4 and 32 beside the
               tiled kernel forced, torch.matmul over the dequantized
               bf16 weights and the bound. The fused
               kernels' BCQ branch (3-bit sign planes, g-1 and g128, M 1
               and 32, a8 and a16) the same way, with the near-tie rule,
               its unfused route being the norm and #13. The BCQ kernel
               (#13) and the streamed qmm (#7, GPTQ_TPU_MATMUL_IMPL=
               streamed) are held the same way; at one row #7 launches
               #1's single-row kernel (its output #1's bit for bit), timed
               beside #1 and the qstream_kernel it replaced there. The
               expert kernels: #8 (the
               batched bank) and #9 (the select, index in device memory;
               at one row qsel_gemv_kernel, timed beside the qsel_kernel
               it replaced there) at Mixtral-8x7B shapes. The whole-layer kernel (#12) at
               llama-7B width, a8 and a16, on bf16 caches of 256 and 2048
               slots and an f32 one, with the near-tie rule of
               tests/test_torch_ffn.py, its cache write bit for bit, two
               launches bit for bit, timed beside its plain version and
               the fused route's launches over the same layer, with a
               `layer timeline` line (each phase's split from the
               kernel's %globaltimer stamps). Decode attention (#3, the
               decode mode of attention_partial.cu) is timed beside SDPA
               on int8 caches of 256 and 2048 slots, a bf16 one, Mixtral's
               GQA 4 layout and a batch of 4. The partial-attention kernel (#10 /
               #11, one kernel) on stacked caches of 2048 local slots with
               1,100 valid: llama-7B (int8, bf16, f32), Mixtral GQA 4
               (with and without alibi slopes), TinyLlama-1.1B (hd 64) and
               a BLOOM-style G = 1 case with slopes, each timed beside its
               plain version and SDPA over the dequantized cache. The
               shared int8 quantizer on rows of exact .5 ties: the card's
               codes equal the CPU's bit for bit. The tensor-core kernels
               of #1 and #13 (csrc/qmma.cu, from 2 rows up):
               #1 at M = 2048 over one llama-7B layer's four linears with
               bf16, f32 and int8 (a8) x, #13 at M = 512 and 2048 the
               same way, and the crossover rows (M 2-128: the CUDA-core
               loop against the tensor-core kernel on one weight). At one
               row #1 and #13 are csrc/gemv.cuh's streamed kernels
               (qgemv_kernel, bcq_gemv_kernel), timed with the wrapper's
               host time a call.
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
               each route's device time per step and its single-row
               kernels by name (the fused route's 32 mlp_stream_kernel and
               33 norm_qkv_gemv_kernel launches a step, no mlp_kernel or
               norm_qkv_kernel; the unfused route's 128 qgemv_kernel; the
               layer route's head on norm_qkv_gemv_kernel); at 2
               layers, kernel
               decoding and plain decoding give the same greedy tokens on
               each route. Then an 8-layer 3-bit g128 BCQ checkpoint from
               seeded signs and alphas through the same CLI (32
               bcq_matmul + 8 attention launches per step, no qmm, no
               fused kernel) with its profile, a 2-layer 4-bit serve on
               the streamed route (GPTQ_TPU_FFN_FUSION=off,
               GPTQ_TPU_MATMUL_IMPL=streamed: 8 streamed launches per
               step, no qmm; by name 8 qgemv_kernel, no qstream_kernel)
               with kernel-vs-plain greedy tokens, and the
               CLI's --lut_bench table. The whole-layer route: the same
               32-layer checkpoint with GPTQ_TPU_LAYER_FUSION=on and a bf16
               cache (per step 32 layer launches and the head's norm_qkv,
               nothing else) with its profile, and 2-layer greedy tokens
               against the plain versions and the fused route on the same
               cache; the CLI's --benchmark_batch 4 (generate_chained);
               the chained protocol (benchmark_decode_chained, one CUDA
               graph per chain) on 32 layers of the layer route, the
               fused route and the unfused route, on 8 of the BCQ route, and
               2-layer generate_chained tokens against generate on each.
  5. sp      - sequence-parallel serving (engine/serving.SPEngine) on a
               one-rank NCCL process group: an 8-layer llama-7B-width
               model at sp = 1 (fused, a8, 8-bit head, int8 cache,
               max_len 2048): per step 8 partial-wide (#10) launches, 9
               norm_qkv, 8 attn_mlp and no flat attention or #12 (by
               name 9 norm_qkv_gemv_kernel, 8 mlp_stream_kernel); the
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
               16-layer model (~12 GB) through
               engine.decode.benchmark_decode, with its profile (96
               qsel_gemv_kernel, 16 qgemv_kernel and 17
               norm_qkv_gemv_kernel launches a step, no qsel_kernel or
               norm_qkv_kernel) and byte
               bound, and through benchmark_decode_chained (its step
               captured in a CUDA graph, which no host sync survives).
  7. cli     - quantize from a model directory through
               gptq_tpu_torch.cli: a 2-layer LLaMA-7B-width HF directory
               written here (config.json and an F16 model.safetensors
               from a seed, 1.24 GiB), the tokenizer and `datasets`
               stood in by seeded synthetic text; w4 g128 act-order
               true-sequential with the 8-bit head (--eval_pack --save)
               and beside it, in a process of its own, --lut_eval 3-bit
               g128: each run's stage times, its
               PPL evals' launches (#1, then #13; exact counts) and its
               wikitext2 PPL against the dense twin of its saved file;
               then the saved w4 file served through the CLI.
  8. batch   - continuous batching (engine/batching.ContinuousBatcher):
               the serve phase's 32-layer checkpoint (w4a8 g-1, 8-bit
               head, fuse_serving(a8=True)) with 32 slots, max_len 256,
               window 16 (one CUDA graph of 16 lock-steps): uniform
               traffic (64 requests of 128 tokens, 64 new, one bucket of
               128, prefill groups of 16) on a bf16 and an int8 cache,
               and churn (96 seeded requests, prompts of 16-128 and 8-64
               new tokens, buckets 32 / 64 / 128, int8):
               each cell's tok/s with the prefill, dispatches, lock-steps,
               the device ms of a step from a profile of one window, its
               busy share and byte bound. Checks: one prefill dispatch
               launches 128 #1 on the tensor cores and nothing else, one
               eager lock-step 33 #4, 32 #5, 32 #3 and no #12 (counters;
               all of #4 / #5 on the rows kernels), and each profiled
               window a step 33 norm_qkv_rows_kernel, 32 mlp_rows_kernel,
               32 attnd_tile and no tiled, layer or single-row kernel (by
               name); window 16's tokens equal window 1's
               (churn); four requests alone through DecodeEngine.generate
               and, at 2 layers, the plain versions give the batcher's
               tokens, every position teacher-forced on them and parting
               only at a near tie of both sides' logits (forced_agree);
               #4 / #5 at M = 4 and 32 and #3 at B = 32 with per-slot
               lengths held to their plain versions on the inputs they
               are timed on. The quantize phase's
               last leg is the layer-streamed host offload: a 4-layer
               LLaMA-7B-width HF directory quantized (w4 g128 act-order)
               on the device and with params_from_dir(host=True), the
               packed words equal bit for bit and the offload's peak
               device memory at least two f32 blocks lower.
  9. families - OPT-6.7B (32 layers), BLOOM-7b1 and Gemma-7B (8 layers
               each) at their published widths (spec_from_hf_config of
               their config.json values), w4a8 g-1 weights, biases and
               norms from a seed, an 8-bit head: on the served layer 0,
               #4's branches (layernorm + biases on OPT's three q|k|v
               parts and BLOOM's fused q|k|v, Gemma's rmsnorm1p; the
               padded OPT head, the BLOOM and Gemma heads), #5 (fc1 ->
               relu / gelu_tanh -> fc2 with o / fc1 / fc2 biases; Gemma's
               GLU gelu_tanh) and Gemma's #6 at M = 1 and 32, Gemma's #12
               (hd 256, H hd != hidden) and #3 at hd 256 (int8 / bf16, B 1
               and 32), each held to its plain version (the near-tie
               rule) and timed beside it, the unfused route, the library
               call and the bound; 2-layer greedy tokens of kernel against
               plain decoding (Gemma also on the layer route); the served
               model's exact launches a step (L + 1 #4, L #5, L #3 but
               under alibi; Gemma's layer route L #12 + 1), per-token
               median, device ms a step and busy share; then a 2-layer
               OPT-6.7B-width F16 directory through the CLI (w4 g128
               act-order --new-eval --save, PPL against the dense twin,
               a serve with the untied 8-bit head).
 10. mixed   - mixed precision: #1 on a 3-bit v (4096x4096), #4 on a
               3-bit llama q|k|v and on OPT-6.7B's layernorm + biased
               q|k|v at 3 bits, #5 / #6 on o 3 / gate|up 4 / down 3
               (configs/linearwise.json) at M = 1 and 32, a8 and a16,
               and #12 at q|k|v 4 / o 3 / gate|up 4 / down 3 and at 3
               bits, each held to its plain version (the near-tie rule)
               and timed; in-process serves (B = 1, 8-bit head) at
               linearwise.json's bits (32 layers, int8 KV: 96 #1, 32 #5,
               32 #3 and the head's #4 a step), at per-layer bits (8
               layers, 4 at 3 bits then 4 at 4: fused on int8 KV and the
               layer route on bf16) and at per-module bits (2 layers, one
               with a dense o: #6), with exact launches, a profile's
               device ms a step beside the byte bound, and 2-layer greedy
               tokens against the plain versions; then the CLI on the
               2-layer directories of the cli and families phases:
               --analyse on llama, then side by side, each in a process
               of its own, --linearmix (llama) and --layermix (OPT,
               `opt-6.7b`), each saved and served after, --quant_config
               results/quant_config.json, --non_linear and --columnwise
               (s per layer; PPL evals' launches exact); and
               add_actquant's 8-bit activation quantizers on the
               --linearmix file, served through #1, greedy tokens against
               plain. The kernels line counts a mixed entry's launches
               on the weights it names only.
Then one JSON line {"kernels": [...]}, and last {"ok": true, "device": ...}.

Imports nothing of JAX or of the JAX package. Exits non-zero, printing no
result, when no CUDA device is available or when run outside the repo.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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

PHASES = ("build", "kernels", "quantize", "serve", "sp", "moe", "cli",
          "batch", "families", "mixed")
QMM_SRC = "gptq_tpu_torch/csrc/qmatmul.cu"
FFN_SRC = "gptq_tpu_torch/csrc/ffn.cu"
BCQ_SRC = "gptq_tpu_torch/csrc/bcq_matmul.cu"
STREAM_SRC = "gptq_tpu_torch/csrc/qstream.cu"
MOE_SRC = "gptq_tpu_torch/csrc/qexpert.cu"
LAYER_SRC = "gptq_tpu_torch/csrc/layer_fused.cu"
MMA_SRC = "gptq_tpu_torch/csrc/qmma.cu"
MOE_MMA_SRC = "gptq_tpu_torch/csrc/qexpert_mma.cu"
PARTIAL_SRC = "gptq_tpu_torch/csrc/attention_partial.cu"
GEMV_SRC = "gptq_tpu_torch/csrc/gemv.cuh"
ROWS_SRC = "gptq_tpu_torch/csrc/ffn_rows.cu"
ROWS_DEV_SRC = "gptq_tpu_torch/csrc/rows.cuh"
STREAM_DEV_SRC = "gptq_tpu_torch/csrc/layer_stream.cuh"
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
# planted fault in the combine reads above it. It also holds the families'
# 2-layer kernel decoding against the plain versions (forced_greedy),
# raised to FLOOR_MARGIN x the floor read in the same run where the plain
# versions drift further than it from their own f64 twin (OPT-6.7B at a8;
# scripts/family_drift.py reads the drift, the floor and planted faults).
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
                        fmt="uniform", bits_of=None):
    """Seeded random packed llama params (the counterpart of the JAX
    package's bench.py:synth_packed_params): random codes (fmt="bcq":
    sign planes and alphas) in the real serving format, bf16 embedding /
    norms, a dense bf16 lm_head. bits_of(i, key), where given, sets the
    bits of layer i's linear `key` (mixed precision)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, f = spec.hidden, spec.ffn
    kv = spec.kv_heads * spec.hd
    make = bcq_linear if fmt == "bcq" else packed_linear

    def lin(K, N, i=None, key=None):
        b = bits if bits_of is None else bits_of(i, key)
        return {"w": make(gen, K, N, b, groupsize, device), "b": None}

    layers = []
    for i in range(spec.n_layers):
        layers.append({
            "q": lin(h, h, i, "q"), "k": lin(h, kv, i, "k"),
            "v": lin(h, kv, i, "v"), "o": lin(h, h, i, "o"),
            "gate": lin(h, f, i, "gate"), "up": lin(h, f, i, "up"),
            "down": lin(f, h, i, "down"),
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
    # groups shallower than a tensor-core stage (64 K rows at a16, 128 at
    # a8) keep csrc/qmatmul.cu's CUDA-core loop at many rows: 2-bit g16
    # always, g64 at a8 (from a generator of their own, so the weights and
    # inputs above stay what they were)
    gen_s = torch.Generator(device=device)
    gen_s.manual_seed(11)
    weights.append(("w4g64", packed_linear(gen_s, 4096, 12288, 4, 64,
                                           device)))
    weights.append(("w2g16", packed_linear(gen_s, 4096, 4096, 2, 16, device)))

    def want_route(tag, M, a8):
        if M == 1:
            return "single_row"
        if tag == "w2g16" or (tag == "w4g64" and a8):
            return "shallow"
        return "mma"

    rows = []
    worst = 0.0
    modes = (("a16", torch.bfloat16), ("a16", torch.float32),
             ("a8", torch.float32))
    for tag, pw in weights:
        # M = 4: batched decode (the smallest row counts go to the tensor
        # cores too)
        for M in (1, 4, 2048):
            g = gen_s if tag in ("w4g64", "w2g16") or M == 4 else gen
            x32 = torch.randn((M, pw.K), generator=g, device=device)
            for act, xdt in modes:
                a8 = act == "a8"
                x = x32.to(xdt)
                route = Q.qmm_route(M, pw.bits, pw.groupsize, xdt, a8=a8,
                                    Np=pw.Np)
                if route != want_route(tag, M, a8):
                    raise AssertionError(f"qmm {tag} M={M} {act}: route "
                                         f"{route}")
                before = (Q.launches, Q.mma_launches)
                got = Q.dequant_matmul(x, pw, a8=a8).float()
                mma = route == "mma"
                if (Q.launches, Q.mma_launches) != (before[0] + (not mma),
                                                    before[1] + mma):
                    raise AssertionError(f"qmm {tag} M={M} {act}: route "
                                         f"{route} launched another kernel")
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
                # bf16 outputs add their rounding; the tensor-core rows
                # are qmm_mma's (mma_worst)
                if xdt == torch.float32 and route != "mma":
                    worst = max(worst, err)
                row = {"w": tag, "K": pw.K, "N": pw.N, "M": M, "a8": a8,
                       "x": str(xdt).replace("torch.", ""), "route": route,
                       "max_abs_err": err, "rel_err": rel}
                # M = 1: bf16 and a8 (decode); M = 2048: every x type
                # (prefill: a8; PPL eval: f32)
                if tag in ("w4g-1", "w4g128p") and (
                        M == 2048 or (M == 1 and (xdt == torch.bfloat16
                                                  or a8))):
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
    # CLI benchmark (max_len 256, 128 filled) and a long-context 2048 one;
    # then a bf16 cache, Mixtral's GQA 4 head layout (32 query heads on 8
    # kv heads) and a batch of 4 rows
    times = []
    for S, length, cache, Hkv, B in ((256, 128, "int8", 32, 1),
                                     (2048, 2048, "int8", 32, 1),
                                     (2048, 2048, "bf16", 32, 1),
                                     (2048, 2048, "int8", 8, 1),
                                     (256, 128, "int8", 32, 4)):
        times.append(attn_times(gen, device, peaks, timer, S, length, cache,
                                Hkv, B))
        log("attention timing " + json.dumps(times[-1]))
    report["attn_times"] = times


def attn_times(gen, device, peaks, timer, S, length, cache="int8", Hkv=32,
               B=1, H=32, hd=128) -> dict:
    """#3 (one launch of attention_partial.cu's decode mode) held to its
    plain version on the timed inputs (max abs err within TOL["attn"]),
    then timed beside it and SDPA over the same (dequantized, bf16) cache
    prefix and fresh column, every row at `length` (a list: each row at
    its own length, the continuous batcher's lock-step; SDPA then reads
    the longest prefix under a mask); bound: the filled slots' bytes (and
    scales) plus q, the fresh pair and the output."""
    import torch

    from gptq_tpu_torch.ops import attention as A

    G = H // Hkv
    lens = [length] * B if isinstance(length, int) else list(length)
    per_row = not isinstance(length, int)
    if per_row:
        length = torch.tensor(lens, dtype=torch.int32, device=device)
    q = torch.randn((B, H, hd), generator=gen, device=device)
    if cache == "int8":
        k = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                          device=device, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                          device=device, dtype=torch.int8)
        ks = torch.rand((B, S, Hkv), generator=gen, device=device) * 0.02
        vs = torch.rand((B, S, Hkv), generator=gen, device=device) * 0.02
    else:
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=device).to(
            torch.bfloat16)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=device).to(
            torch.bfloat16)
        ks = vs = None
    fk = torch.randn((B, Hkv, hd), generator=gen, device=device)
    fv = torch.randn((B, Hkv, hd), generator=gen, device=device)
    sm = 1.0 / math.sqrt(hd)
    kw = dict(k_scale=ks, v_scale=vs, fresh_k=fk, fresh_v=fv)
    got = A.decode_attention(q, k, v, length, sm, **kw)
    want = A.decode_attention_reference(q, k, v, length, sm, **kw)
    err = float((got - want).abs().max())
    if not err <= TOL["attn"]:
        raise AssertionError(f"attention S={S} B={B} Hkv={Hkv} {cache} "
                             f"lengths {lens}: max abs err {err:.3g}")
    del got, want
    ms = timer(lambda: A.decode_attention(q, k, v, length, sm, **kw))
    plain_ms = timer(lambda: A.decode_attention_reference(q, k, v, length, sm,
                                                          **kw))

    # yardstick: SDPA over the dequantized bf16 cache prefix + fresh row
    top = max(lens)

    def dq(c, sc):
        c = c[:, :top].float()
        return c * sc[:, :top, :, None] if sc is not None else c

    kd = torch.cat([dq(k, ks), fk[:, None]], dim=1).to(torch.bfloat16)
    vd = torch.cat([dq(v, vs), fv[:, None]], dim=1).to(torch.bfloat16)
    kd = kd.transpose(1, 2).contiguous()  # (B, Hkv, L, hd): each kv head
    vd = vd.transpose(1, 2).contiguous()  # read once, as the kernel does
    qd = q[:, :, None].to(torch.bfloat16)
    mask = None
    if per_row:  # each row's prefix and its fresh column
        t = torch.arange(top + 1, device=device)
        mask = ((t[None] < length[:, None]) | (t[None] == top))[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qd, kd, vd, attn_mask=mask, scale=sm,
                                enable_gqa=G > 1))
    item = k.element_size()
    filled = sum(lens)
    nbytes = ((filled * Hkv * hd * item * 2
               + (filled * Hkv * 4 * 2 if ks is not None else 0))
              + (B * H * hd + 2 * B * Hkv * hd + B * H * hd) * 4 + B * 4)
    ops = 4 * H * (filled + B) * hd
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["f32"] * 1e3
    length = lens if per_row else lens[0]
    return {"S": S, "length": length, "cache": cache, "H": H, "Hkv": Hkv,
            "hd": hd, "B": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
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


def host_us(fn, n=100) -> float:
    """fn's host time a call in µs: n calls queued back to back with no
    synchronisation (the device behind), after three warm calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def fused_times(timer, peaks, M, a8, weights, io_bytes, kernel, wrapper,
                plain, unfused, tiles=None) -> dict:
    """Device times of one fused function: the bare kernel launch, the
    wrapper, the plain version and the unfused route (qmm launches and the
    PyTorch glue between them), beside the byte / operation bound; with
    `tiles` (one row: the launch of the tiled mlp_kernel, which the stream
    replaced there) its time too and the wrapper's host time a call."""
    ms = timer(kernel)
    wrapper_ms = timer(wrapper)
    plain_ms = timer(plain)
    with fusion_mode("off"):
        unfused_ms = timer(unfused)
    nbytes = sum(packed_bytes(pw) for pw in weights) + io_bytes
    ops = 2 * M * sum(pw.Kp * pw.Np for pw in weights)
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks["int8" if a8 else "bf16"] * 1e3
    out = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "unfused_ms": unfused_ms, "bytes": nbytes,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if tiles is not None:
        out["tiles_ms"] = timer(tiles)
        out["wrapper_host_us"] = host_us(wrapper)
    return out


def residual_check(what, attn, xres, ln, o, gu, dn0, a8, **kw) -> float:
    """attn_mlp with down's grid zeroed: the output is the residual r2
    alone, which the main check cannot see where the down phase's output
    dwarfs it. Both sides round r2 to bf16, so an element may land one
    bf16 step (2^-7 of itself) apart, and one near 0 may differ by its f32
    sum's rounding (1e-5 of max|r2| allowed); a residual left out reads
    1.0 of max|r2|. kw: attn_mlp's other arguments (act, norm, glu, the
    biases but b_d). Returns max|diff| / max|r2|."""
    from gptq_tpu_torch.ops import ffn as Fz

    got = Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn0, a8=a8, **kw).float()
    want = Fz.attn_mlp_fused_reference(attn, xres, ln, o, gu, dn0, a8=a8,
                                       **kw).float()
    diff = (got - want).abs()
    bound = 2.0**-7 * want.abs() + 1e-5 * want.abs().max()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{what}, down zeroed: the residual r2 is off by "
                             f"{float(diff.max()):.3g}")
    return float(diff.max() / want.abs().max())


def stream_vs_tiles(what, args, gu, dn, a8) -> float:
    """#5 / #6 at one row on the weight stream and the tiled kernel it
    replaced there (both forced): two stream launches bit for bit, the
    barrier and ticket words clean after them. args: (x, xres, ln2, o), or
    (m, None, None, None). Returns max|stream - tiles| / max|tiles|, which
    is not held to a limit: each is held to the plain version, and a
    near tie that the two round apart moves the output by up to ~1e-2."""
    import torch

    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF

    kw = ("silu", "rmsnorm", 1e-5, True, a8, None, None, None, None)
    x, xres, ln, o = args
    tiles = Fz._mlp_cuda(x, xres, ln, o, gu, dn, *kw, route="tiles")
    one = Fz._mlp_cuda(x, xres, ln, o, gu, dn, *kw, route="stream")
    two = Fz._mlp_cuda(x, xres, ln, o, gu, dn, *kw, route="stream")
    torch.cuda.synchronize()
    rel = float((one - tiles).abs().max() / tiles.abs().max())
    if not math.isfinite(rel) or not torch.equal(one, two) \
            or not LF.sync_clean(x.device):
        raise AssertionError(f"{what}: two stream launches differ, or the "
                             f"sync words are not clean")
    return rel


def norm_qkv_vs_tiles(what, x2, ln, pw, a8, plain) -> float:
    """#4 at one row on the single-row stream and the tiled kernel it
    replaced there (both forced): two stream launches bit for bit, the
    tiled kernel held to the plain version with the near-tie rule.
    Returns max|stream - tiles| / max|tiles|, which is not held to a
    limit: each is held to the plain version, and a near tie that the two
    round apart moves an output element by one int8 code's product."""
    import torch

    from gptq_tpu_torch.ops import ffn as Fz

    kw = ("rmsnorm", 1e-5, a8, None, None)
    tiles = Fz._norm_qkv_cuda(x2, ln, pw, *kw, route="tiles")
    one = Fz._norm_qkv_cuda(x2, ln, pw, *kw, route="stream")
    two = Fz._norm_qkv_cuda(x2, ln, pw, *kw, route="stream")
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"{what}: two stream launches differ")
    tie_check(f"{what} (tiles forced)", tiles, plain, TOL["fused"])
    rel = float((one - tiles).abs().max() / tiles.abs().max())
    if not math.isfinite(rel):
        raise AssertionError(f"{what}: stream against tiles {rel}")
    return rel


def fused_checks(device, peaks, timer, report):
    """The fused kernels (#4 norm_qkv, #5 attn_mlp, #6 ffn) against their
    plain versions at llama-7B shapes (#4 also at Mixtral-8x7B's q|k|v),
    M in {1, 32}, a8 and a16; timed at the decode shape (M = 1, a8; #5 /
    #6 and llama q|k|v at a16 too). At M = 1 #4 runs on #1's single-row
    stream (norm_qkv_gemv_kernel; ffn.norm_qkv_route) and #5 / #6 on the
    weight stream (mlp_stream_kernel; ffn.mlp_route), each held to the
    plain version and to the tiled kernel it replaced there (forced) on
    every tag, two launches bit for bit, and timed beside it."""
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
    rows, worst = [], {}

    def fused_weight(K, N, bits, gs, parts):
        pws = [packed_linear(gen, K, N, bits, gs, device) for _ in range(parts)]
        return fuse_packed(pws), FusedSplits(tuple((p.Np, p.N) for p in pws))

    def check(kernel, tag, M, a8, got, want):
        """got within TOL["fused"] of max|want|; want: the plain version's
        output, or (the weight stream at one row, the rows kernels at 32)
        the plain version itself, and then the near-tie rule of the layer
        checks (tie_check): their f32 sums run in another order, so
        a residual or activation element within a few ulps of a bf16 or
        int8 rounding boundary may round the other way, and its row moves
        by up to ~1e-2 of max|want| through ln2 and the int8 codes."""
        torch.cuda.synchronize()
        flips = 0
        if callable(want):
            err, rel, flips = tie_check(f"{kernel} {tag} M={M} a8={a8}", got,
                                        want, TOL["fused"])
        else:
            got, want = got.float(), want.float()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
        if not (math.isfinite(err) and rel <= TOL["fused"]):
            raise AssertionError(f"{kernel} {tag} M={M} a8={a8}: rel err "
                                 f"{rel:.3g} > {TOL['fused']}")
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        row = {"kernel": kernel, "w": tag, "M": M, "a8": a8,
               "max_abs_err": err, "rel_err": rel, "flips": flips}
        rows.append(row)
        return row

    def norm_qkv_rows(tag, pw, g):
        """#4 at M 1 and 32, a8 and a16, x drawn from g. At one row the
        weight stream (norm_qkv_gemv_kernel; ffn.norm_qkv_route) is held
        to the plain version with the near-tie rule and to the tiled
        norm_qkv_kernel it replaced there (norm_qkv_vs_tiles); the a8 rows
        but w4 g128's, and llama q|k|v's a16 row, are timed beside it."""
        for M in (1, 32):
            x = torch.randn((M, H), generator=g, device=device)
            for a8 in (True, False):
                route = Fz.norm_qkv_route(M, pw, a8)
                if route != ("stream" if M == 1 else "rows"):
                    raise AssertionError(f"norm_qkv {tag} M={M}: route "
                                         f"{route}")
                plain = functools.partial(Fz.norm_qkv_fused_reference, x, ln,
                                          pw, a8=a8)
                row = check("norm_qkv", tag, M, a8,
                            Fz.norm_qkv_fused(x, ln, pw, a8=a8), plain)
                row["route"] = route
                if M == 1:
                    x2 = x.to(torch.bfloat16).float()
                    row["tiles_rel_err"] = norm_qkv_vs_tiles(
                        f"norm_qkv {tag} a8={a8}", x2, ln, pw, a8, plain)
                if M == 1 and "g128" not in tag and (a8 or tag ==
                                                     "q|k|v w4g-1"):
                    xb = x.to(torch.bfloat16)
                    x2 = xb.float()
                    lin = {"w": pw, "b": None, "serve": ServeFlags(a8=a8)}
                    kw = ("rmsnorm", 1e-5, a8, None, None)
                    row.update(fused_times(
                        timer, peaks, M, a8, [pw],
                        M * H * 2 + H * 2 + M * pw.Np * 4,
                        kernel=lambda: Fz._norm_qkv_cuda(x2, ln, pw, *kw),
                        wrapper=lambda: Fz.norm_qkv_fused(xb, ln, pw, a8=a8),
                        plain=lambda: Fz.norm_qkv_fused_reference(xb, ln, pw,
                                                                  a8=a8),
                        unfused=lambda: common.linear_apply(
                            lin, common.norm_apply(spec, {"w": ln}, xb)),
                        tiles=lambda: Fz._norm_qkv_cuda(x2, ln, pw, *kw,
                                                        route="tiles")))
                log("fused " + json.dumps(row))

    # 4: ln1 + q|k|v (w4), and final_ln + the 8-bit lm_head
    nq = [("q|k|v w4g-1", fused_weight(H, H, 4, -1, 3)[0]),
          ("q|k|v w4g128", fused_weight(H, H, 4, 128, 3)[0]),
          ("head w8g-1", packed_linear(gen, H, V, 8, -1, device))]
    for tag, pw in nq:
        norm_qkv_rows(tag, pw, gen)
    # Mixtral-8x7B's ln1 + q|k|v (8 KV heads: 4096 x 6144), its own seed
    gen_mx = torch.Generator(device=device)
    gen_mx.manual_seed(13)
    mx = fuse_packed([packed_linear(gen_mx, H, n, 4, -1, device)
                      for n in (H, H // 4, H // 4)])
    norm_qkv_rows("q|k|v mixtral w4g-1", mx, gen_mx)
    del mx

    # 5 and 6: o (4096^2), gate|up (4096 x 2*11264), down (11264 x 4096)
    for tag, bits, gs in (("w4g-1", 4, -1), ("w4g128", 4, 128),
                          ("w3g128", 3, 128)):
        o = packed_linear(gen, H, H, bits, gs, device)
        gu, splits = fused_weight(H, F, bits, gs, 2)
        dn = packed_linear(gen, F, H, bits, gs, device)
        dn0 = dataclasses.replace(dn, scale=torch.zeros_like(dn.scale),
                                  zoff=torch.zeros_like(dn.zoff))
        ps = {a8: {"o": {"w": o, "b": None, "serve": ServeFlags(a8=a8)},
                   "gateup_fused": {"w": gu, "splits": splits,
                                    "b_parts": [None, None],
                                    "serve": ServeFlags(a8=a8)},
                   "down": {"w": dn, "b": None, "serve": ServeFlags(a8=a8)},
                   "ln2": {"w": ln}} for a8 in (True, False)}
        for M in (1, 32):
            attn = torch.randn((M, H), generator=gen, device=device)
            xres = torch.randn((M, H), generator=gen,
                               device=device).to(torch.bfloat16)
            m = torch.randn((M, H), generator=gen, device=device)
            for a8 in (True, False):
                route = Fz.mlp_route(M, o, gu, dn, a8)
                if route != ("stream" if M == 1 else "rows"):
                    raise AssertionError(f"attn_mlp {tag} M={M}: route {route}")
                plain5 = functools.partial(Fz.attn_mlp_fused_reference, attn,
                                           xres, ln, o, gu, dn, a8=a8)
                plain6 = functools.partial(Fz.ffn_fused_reference, m, gu, dn,
                                           a8=a8)
                row5 = check("attn_mlp", tag, M, a8,
                             Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn,
                                               a8=a8), plain5)
                row5["r2_rel_err"] = residual_check(
                    f"attn_mlp {tag} M={M} a8={a8}", attn, xres, ln, o, gu,
                    dn0, a8)
                row6 = check("ffn", tag, M, a8, Fz.ffn_fused(m, gu, dn, a8=a8),
                             plain6)
                for row, args in ((row5, (attn, xres.float(), ln, o)),
                                  (row6, (m, None, None, None))):
                    row["route"] = route
                    if M == 1:  # the stream against the kernel it replaced
                        row["tiles_rel_err"] = stream_vs_tiles(
                            f"{row['kernel']} {tag} a8={a8}", args, gu, dn,
                            a8)
                if M == 1 and tag == "w4g-1":
                    p = ps[a8]  # the unfused route at the same activations
                    x2 = xres.float()
                    a3, r3 = attn.reshape(1, 1, H), xres.reshape(1, 1, H)
                    row5.update(fused_times(
                        timer, peaks, M, a8, [o, gu, dn],
                        M * H * 4 + M * H * 2 + H * 2 + M * H * 4,
                        kernel=lambda: Fz._mlp_cuda(
                            attn, x2, ln, o, gu, dn, "silu", "rmsnorm", 1e-5,
                            True, a8, None, None, None, None),
                        wrapper=lambda: Fz.attn_mlp_fused(attn, xres, ln, o,
                                                          gu, dn, a8=a8),
                        plain=lambda: Fz.attn_mlp_fused_reference(
                            attn, xres, ln, o, gu, dn, a8=a8),
                        unfused=lambda: common._finish_block(
                            spec, p, r3, a3, None, None),
                        tiles=lambda: Fz._mlp_cuda(
                            attn, x2, ln, o, gu, dn, "silu", "rmsnorm", 1e-5,
                            True, a8, None, None, None, None,
                            route="tiles")))

                    def unfused_ffn():
                        g, u = common._apply_fused(p["gateup_fused"], m)
                        return common.linear_apply(
                            p["down"], common.activation(spec, g) * u)

                    row6.update(fused_times(
                        timer, peaks, M, a8, [gu, dn], M * H * 4 * 2,
                        kernel=lambda: Fz._mlp_cuda(
                            m, None, None, None, gu, dn, "silu", "rmsnorm",
                            0.0, True, a8, None, None, None, None),
                        wrapper=lambda: Fz.ffn_fused(m, gu, dn, a8=a8),
                        plain=lambda: Fz.ffn_fused_reference(m, gu, dn,
                                                             a8=a8),
                        unfused=unfused_ffn,
                        tiles=lambda: Fz._mlp_cuda(
                            m, None, None, None, gu, dn, "silu", "rmsnorm",
                            0.0, True, a8, None, None, None, None,
                            route="tiles")))
                log("fused " + json.dumps(row5))
                log("fused " + json.dumps(row6))
    report["fused_rows"] = rows
    report["fused_max_abs_err"] = worst


def rows_checks(device, peaks, timer, report):
    """#4 and #5 / #6 at rows 2-32 on the tensor cores (csrc/ffn_rows.cu:
    norm_qkv_rows_kernel, mlp_rows_kernel; ffn.norm_qkv_route / mlp_route
    "rows") at llama-7B shapes: ln1 + q|k|v and #5 / #6 on w4 g-1 at M 2,
    3, 4, 8, 16, 32, a8 and a16, the 8-bit head at a8, w4 g128 and w3 g128
    at M = 4 and 32, a8: each held to its plain version with the near-tie
    rule (tie_check), two launches bit for bit, the barrier and ticket
    words clean after them. Timed at M = 4 and 32 (w4 g-1 and the head,
    a8) beside the tiled kernel forced on the same inputs (norm_qkv_kernel,
    mlp_kernel: the kernel the rows kernels replaced), the plain version,
    the unfused route, torch.matmul over the dequantized bf16 weights (#5
    / #6: the three / two products) and the bound. Row independence: each
    of four rows is the same bits at M = 4 as in other slots at M = 32."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.models.common import FusedSplits, ServeFlags
    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF
    from gptq_tpu_torch.ops.pack import fuse_packed

    gen = torch.Generator(device=device)
    gen.manual_seed(23)
    spec = llama7b_spec(1)
    H, F, V = spec.hidden, spec.ffn, spec.vocab
    ln = torch.ones(H, dtype=torch.float32, device=device)
    rows, worst = [], {}

    def held(kernel, tag, M, a8, run, plain):
        """run() twice bit for bit, within TOL["fused"] of plain() with
        the near-tie rule; the row of the readings."""
        one, two = run(), run()
        torch.cuda.synchronize()
        what = f"rows {kernel} {tag} M={M} a8={a8}"
        if not torch.equal(one, two) or not LF.sync_clean(device):
            raise AssertionError(f"{what}: two launches differ, or the sync "
                                 f"words are not clean")
        err, rel, flips = tie_check(what, one, plain, TOL["fused"])
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        return {"kernel": kernel, "w": tag, "M": M, "a8": a8,
                "max_abs_err": err, "rel_err": rel, "flips": flips}

    def same_rows(kernel, run):
        """Rows 5, 17, 30, 0 of a 32-row launch against a 4-row launch
        of those rows: the same bits."""
        idx = torch.tensor([5, 17, 30, 0], device=device)
        full, part = run(None), run(idx)
        torch.cuda.synchronize()
        if not torch.equal(full[idx], part):
            raise AssertionError(f"rows {kernel}: a row's output depends on "
                                 f"M or its slot (max diff "
                                 f"{float((full[idx] - part).abs().max())})")

    for tag, bits, gs in (("w4g-1", 4, -1), ("w4g128", 4, 128),
                          ("w3g128", 3, 128)):
        parts = [packed_linear(gen, H, H, bits, gs, device) for _ in range(3)]
        nq = [(f"q|k|v {tag}", fuse_packed(parts))]
        if tag == "w4g-1":
            nq.append(("head w8g-1", packed_linear(gen, H, V, 8, -1, device)))
        o = packed_linear(gen, H, H, bits, gs, device)
        gparts = [packed_linear(gen, H, F, bits, gs, device) for _ in range(2)]
        gu = fuse_packed(gparts)
        splits = FusedSplits(tuple((p.Np, p.N) for p in gparts))
        dn = packed_linear(gen, F, H, bits, gs, device)
        full = tag == "w4g-1"
        for M in ((2, 3, 4, 8, 16, 32) if full else (4, 32)):
            for a8 in ((True, False) if full else (True,)):
                timed = full and a8 and M in (4, 32)
                xb = torch.randn((M, H), generator=gen,
                                 device=device).to(torch.bfloat16)
                x2 = xb.float()
                kw = ("rmsnorm", 1e-5, a8, None, None)
                for wtag, pw in nq:
                    if wtag.startswith("head") and not a8:
                        continue
                    if Fz.norm_qkv_route(M, pw, a8) != "rows":
                        raise AssertionError(f"rows norm_qkv {wtag} M={M}: "
                                             f"route "
                                             f"{Fz.norm_qkv_route(M, pw, a8)}")
                    # x2: xb's values in f32, so that both outputs are f32
                    # (a bf16 output rounds an element one ulp, up to
                    # 2^-8 of it, apart where the sums straddle a step)
                    row = held("norm_qkv", wtag, M, a8,
                               lambda: Fz.norm_qkv_fused(x2, ln, pw, a8=a8),
                               functools.partial(Fz.norm_qkv_fused_reference,
                                                 x2, ln, pw, a8=a8))
                    if timed:
                        lin = {"w": pw, "b": None,
                               "serve": ServeFlags(a8=a8)}
                        row.update(fused_times(
                            timer, peaks, M, a8, [pw],
                            M * H * 2 + H * 4 + M * pw.Np * 4,
                            kernel=lambda: Fz._norm_qkv_cuda(x2, ln, pw, *kw),
                            wrapper=lambda: Fz.norm_qkv_fused(xb, ln, pw,
                                                              a8=a8),
                            plain=lambda: Fz.norm_qkv_fused_reference(
                                xb, ln, pw, a8=a8),
                            unfused=lambda: common.linear_apply(
                                lin, common.norm_apply(spec, {"w": ln}, xb)),
                            tiles=lambda: Fz._norm_qkv_cuda(
                                x2, ln, pw, *kw, route="tiles")))
                        dq = dense_weight(pw).T.to(torch.bfloat16).contiguous()
                        row["library_ms"] = timer(lambda: torch.matmul(xb, dq))
                        del dq
                    rows.append(row)
                    log("rows " + json.dumps(row))
                attn = torch.randn((M, H), generator=gen, device=device)
                xres = torch.randn((M, H), generator=gen,
                                   device=device).to(torch.bfloat16)
                m = torch.randn((M, H), generator=gen, device=device)
                if Fz.mlp_route(M, o, gu, dn, a8) != "rows" or \
                        Fz.mlp_route(M, None, gu, dn, a8) != "rows":
                    raise AssertionError(f"rows mlp {tag} M={M}: not the "
                                         f"rows route")
                row5 = held("attn_mlp", tag, M, a8,
                            lambda: Fz.attn_mlp_fused(attn, xres, ln, o, gu,
                                                      dn, a8=a8),
                            functools.partial(Fz.attn_mlp_fused_reference,
                                              attn, xres, ln, o, gu, dn,
                                              a8=a8))
                row6 = held("ffn", tag, M, a8,
                            lambda: Fz.ffn_fused(m, gu, dn, a8=a8),
                            functools.partial(Fz.ffn_fused_reference, m, gu,
                                              dn, a8=a8))
                if timed:
                    x2r = xres.float()
                    mk = ("silu", "rmsnorm", 1e-5, True, a8, None, None,
                          None, None)
                    p = {"o": {"w": o, "b": None, "serve": ServeFlags(a8=a8)},
                         "gateup_fused": {"w": gu, "splits": splits,
                                          "b_parts": [None, None],
                                          "serve": ServeFlags(a8=a8)},
                         "down": {"w": dn, "b": None,
                                  "serve": ServeFlags(a8=a8)},
                         "ln2": {"w": ln}}
                    a3, r3 = attn.reshape(M, 1, H), xres.reshape(M, 1, H)
                    row5.update(fused_times(
                        timer, peaks, M, a8, [o, gu, dn],
                        M * H * 4 + M * H * 2 + H * 4 + M * H * 4,
                        kernel=lambda: Fz._mlp_cuda(attn, x2r, ln, o, gu, dn,
                                                    *mk),
                        wrapper=lambda: Fz.attn_mlp_fused(attn, xres, ln, o,
                                                          gu, dn, a8=a8),
                        plain=lambda: Fz.attn_mlp_fused_reference(
                            attn, xres, ln, o, gu, dn, a8=a8),
                        unfused=lambda: common._finish_block(spec, p, r3, a3,
                                                             None, None),
                        tiles=lambda: Fz._mlp_cuda(attn, x2r, ln, o, gu, dn,
                                                   *mk, route="tiles")))

                    def unfused_ffn():
                        g, u = common._apply_fused(p["gateup_fused"], m)
                        return common.linear_apply(
                            p["down"], common.activation(spec, g) * u)

                    row6.update(fused_times(
                        timer, peaks, M, a8, [gu, dn], M * H * 4 * 2,
                        kernel=lambda: Fz._mlp_cuda(m, None, None, None, gu,
                                                    dn, *mk),
                        wrapper=lambda: Fz.ffn_fused(m, gu, dn, a8=a8),
                        plain=lambda: Fz.ffn_fused_reference(m, gu, dn,
                                                             a8=a8),
                        unfused=unfused_ffn,
                        tiles=lambda: Fz._mlp_cuda(m, None, None, None, gu,
                                                   dn, *mk, route="tiles")))
                    # the products over the dequantized bf16 weights (the
                    # activation and the norms left out)
                    dq = {id(w): dense_weight(w).T.to(torch.bfloat16)
                          .contiguous() for w in (o, gu, dn)}
                    ab, mb = attn.to(torch.bfloat16), m.to(torch.bfloat16)
                    F2 = dq[id(dn)].shape[0]

                    def library(x, with_o):
                        y = torch.matmul(x, dq[id(o)]) if with_o else x
                        g = torch.matmul(y, dq[id(gu)])
                        return torch.matmul(g[:, :F2], dq[id(dn)][:F2])

                    row5["library_ms"] = timer(lambda: library(ab, True))
                    row6["library_ms"] = timer(lambda: library(mb, False))
                    del dq
                for row in (row5, row6):
                    rows.append(row)
                    log("rows " + json.dumps(row))
        if full:
            pw = nq[0][1]
            g32 = torch.randn((3, 32, H), generator=gen, device=device)
            for a8 in (True, False):
                def sel(idx, t):
                    return t if idx is None else t[idx]

                same_rows("norm_qkv", lambda idx: Fz.norm_qkv_fused(
                    sel(idx, g32[0]), ln, pw, a8=a8))
                same_rows("attn_mlp", lambda idx: Fz.attn_mlp_fused(
                    sel(idx, g32[0]), sel(idx, g32[1]).to(torch.bfloat16),
                    ln, o, gu, dn, a8=a8))
                same_rows("ffn", lambda idx: Fz.ffn_fused(
                    sel(idx, g32[2]), gu, dn, a8=a8))
            log("rows: rows 5, 17, 30, 0 of M = 32 equal an M = 4 launch of "
                "them bit for bit (#4, #5, #6; a8 and a16)")
            # where a launch's time goes (a8, M = 32): each phase's barrier
            # before its preparation, the preparation's end, the barrier
            # after it and the product's end, µs from the first block's
            # start, the latest block at each point (ffn.rows_timeline)
            st = torch.zeros((_build.sm_count(device), Fz.ROWS_STAMPS),
                             dtype=torch.int64, device=device)
            xr = g32[1].to(torch.bfloat16).float()
            Fz._rows_cuda(g32[0].to(torch.bfloat16).float(), None, ln, None,
                          "rmsnorm", 1e-5, "silu", False, True,
                          [pw, None, None, None], [None] * 4, stamps=st)
            tl = {"norm_qkv": Fz.rows_timeline(st, 1)}
            st.zero_()
            Fz._rows_cuda(g32[0], xr, ln, None, "rmsnorm", 1e-5, "silu",
                          True, True, [None, o, gu, dn], [None] * 4,
                          stamps=st)
            tl["attn_mlp"] = Fz.rows_timeline(st, 3)
            log("rows timeline (w4a8 g-1, M = 32, µs) " + json.dumps(tl))
            report["rows_timeline"] = tl
        del nq, o, gu, dn, parts, gparts
    report["rows_rows"] = rows
    report["rows_max_abs_err"] = worst


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
        self.kinds, self.gaps, self.widths = [], {}, []
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
        self.widths.append((v.numel() // v.shape[-1], v.shape[-1]))
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
    """got (the kernel's output) within tol of max|plain()|, row by row; a
    row over tol passes only if rounding at most 4 of its own near-tie
    elements in the plain version the other way (chosen greedily, one at a
    time) brings it within tol. The rule of tests/test_torch_ffn.py::_check,
    applied per row as tests/test_torch_ffn_rows.py::_check_rows applies it
    (a row's output depends on its own inputs only), with two differences
    for llama-7B shapes, where a point holds thousands of near ties: a
    row's candidates are its 128 nearest, ranked by the gap relative to
    the element's own value (Ties), and its 32 nearest of each rounding
    point besides, since one early flip (a bf16 residual element) carries
    through every later point of its row and the later points, wider,
    would crowd it out of the 128. Each greedy round replays the plain
    version once a candidate rank, every searching row trying its own
    candidate of that rank. Where a rounding point is not laid out in
    got's rows, all rows form one group that searches as one row does.
    Where a flip was needed, its point, the point's kind and its gap over
    the row max are logged. Returns (max abs err, rel err, flips needed)."""
    import torch

    torch.cuda.synchronize()
    got = got.float()
    M = got.numel() // got.shape[-1]
    got2 = got.reshape(M, -1)

    with Ties() as ties:
        want = plain().float()
    scale = want.abs().max()

    def row_errs(w):
        return ((got2 - w.float().reshape(M, -1)).abs().amax(-1)
                / scale).tolist()

    errs = row_errs(want)
    abs_err = float((got - want).abs().max())
    by_row = all(rows == M for rows, _ in ties.widths)
    groups = [[m] for m in range(M)] if by_row else [list(range(M))]

    def group_of(key):
        p, e = key
        return e // ties.widths[p][1] if by_row else 0

    ranked = {}
    for _, k in sorted(ties.near):
        ranked.setdefault(group_of(k), []).append(k)
    cands = {}
    for g, keys in ranked.items():
        cands[g], per_point = keys[:128], {}
        for k in keys[128:]:
            if per_point.setdefault(k[0], 0) < 32:
                per_point[k[0]] += 1
                cands[g].append(k)

    def gerr(g, e):
        return max(e[m] for m in groups[g])

    err = {g: gerr(g, errs) for g in range(len(groups))}
    flips = {g: frozenset() for g in err}
    searching = [g for g in err if not err[g] <= tol and cands.get(g)]
    rounds = 0
    while searching and rounds < 4:
        rounds += 1
        trial = {g: [k for k in cands[g] if k not in flips[g]]
                 for g in searching}
        best = {}
        for i in range(max(len(t) for t in trial.values())):
            keys = frozenset().union(*flips.values()).union(
                t[i] for t in trial.values() if i < len(t))
            with Ties(keys, record=False):
                e = row_errs(plain())
            for g, t in trial.items():
                if i < len(t) and (g not in best or gerr(g, e) < best[g][0]):
                    best[g] = (gerr(g, e), t[i])
        for g in list(searching):
            if g not in best or best[g][0] >= err[g]:
                searching.remove(g)
                continue
            err[g], flips[g] = best[g][0], flips[g] | {best[g][1]}
            if err[g] <= tol:
                searching.remove(g)
    used = sorted(frozenset().union(*flips.values()))
    if used:
        log(f"{what}: flipped " + ", ".join(
            f"point {p} ({ties.kinds[p]}) element {e}, gap "
            f"{ties.gaps[p, e]:.3g} of the row max" for p, e in used))
    worst = max(err.values())
    if not (math.isfinite(worst) and worst <= tol):
        over = [m for g, e in err.items() if not e <= tol
                for m in groups[g] if not errs[m] <= tol]
        raise AssertionError(f"{what}: rel err {worst:.3g} > {tol} with "
                             f"{len(used)} of {len(ties.near)} near-tie "
                             f"flips; rows over the limit {over} of {M}")
    return abs_err, worst, len(used)


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
        # two launches on the same inputs: the same bits (the K-split
        # pieces are summed in a fixed order, whichever block ends last)
        again = [c.clone() for c in cache0]
        got2 = LF.decode_layer_fused(x, *again, lens, *args, a8=a8, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got, got2)
                and all(torch.equal(a, b) for a, b in zip(kern, again))):
            raise AssertionError(f"{what}: two launches differ")
        row = {"S": S, "filled": length, "a8": a8,
               "cache": str(cdt).replace("torch.", ""), "max_abs_err": err,
               "rel_err": rel, "near_tie_flips": flips,
               "cache_row": "bit-exact", "reproducible": True}
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
            row["timeline"] = layer_timeline(x, cache0, lens, args, kw)
            log(f"layer timeline S={S} filled={length} "
                + json.dumps(row["timeline"]))
        rows.append(row)
        log("layer " + json.dumps(row))
    # every launch above ran to its end: the barrier and ticket words are
    # back to zero (but the barrier's generation)
    if not LF.sync_clean(device):
        raise AssertionError("layer: the kernel left barrier or ticket words "
                             "set")
    report["layer_rows"] = rows
    report["layer_max_abs_err"] = worst


def layer_timeline(x, cache0, lens, args, kw, runs=5) -> dict:
    """#12's per-phase split from the kernel's %globaltimer stamps
    (ops/layer_fused.timeline_split): `runs` launches, each after an L2
    flush as in device_ms, and the split of the one with the median
    total."""
    import torch

    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import layer_fused as LF

    kc, vc = (c.clone() for c in cache0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=x.device)
    splits = []
    for _ in range(runs):
        stamps = torch.zeros((_build.sm_count(x.device), LF.STAMPS),
                             dtype=torch.int64, device=x.device)
        flush.zero_()
        LF._layer_cuda(x, kc, vc, lens, *args, kw["n_heads"],
                       kw["n_kv_heads"], kw["head_dim"], kw["act"],
                       kw["norm"], kw["eps"], kw["sm_scale"], True,
                       kw["layer"], stamps=stamps)
        torch.cuda.synchronize()
        splits.append(LF.timeline_split(stamps.cpu()))
    splits.sort(key=lambda r: r["total_us"])
    return splits[len(splits) // 2]


def layer_times(timer, peaks, spec, x, cache0, lens, args, kw, flags) -> dict:
    """Device times of one decoder layer at one token: the bare kernel
    launch, the wrapper (and its host time a call), the plain version and
    the port's fused route
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
    wrapper_host_us = host_us(lambda: LF.decode_layer_fused(
        x, kc, vc, lens, *args, a8=True, **kw))
    plain_ms = timer(lambda: LF.decode_layer_fused_reference(
        x, kc, vc, lens, *args, a8=True, **kw))
    p = {"ln1": {"w": w1}, "ln2": {"w": w2},
         "qkv_fused": {"w": qkv, "b_parts": [None] * 3, "serve": flags,
                       "splits": FusedSplits(((nh * hd, nh * hd), (kvw, kvw),
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
    return {"ms": ms, "wrapper_ms": wrapper_ms,
            "wrapper_host_us": wrapper_host_us,
            "plain_ms": plain_ms, "fused_route_ms": fused_route_ms,
            "bytes": nbytes,
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
    groupsize -1 and 128, M 1, 4 and 32, a8 / bf16 / f32, each call's
    route and launch checked; timed at the decode shape (3-bit g128 a8 and
    bf16 x, M = 1, the four linears of one layer) and at the PPL eval's
    M = 512;
    one weight the tensor-core kernel does not take (8 planes, g16) at
    M = 512 through the CUDA-core loop."""
    import torch

    from gptq_tpu_torch.ops import bcq_matmul as B

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    # M = 4 and the shallow weight draw from a generator of their own, so
    # the weights and inputs of the other cases stay what they were
    gen_s = torch.Generator(device=device)
    gen_s.manual_seed(12)
    rows, worst, dec, dec_bf16 = [], 0.0, [], []
    modes = (("a8", torch.float32), ("a16", torch.bfloat16),
             ("a16", torch.float32))

    def checked(what, x, pw, a8, want_route):
        """bcq_matmul(x) within tolerance of the plain version, through
        the kernel want_route names; returns max |got - want|."""
        M = x.shape[0]
        route = B.bcq_route(M, pw.bits, pw.groupsize, pw.Np)
        if route != want_route:
            raise AssertionError(f"{what}: route {route}")
        before = (B.launches, B.mma_launches)
        got = B.bcq_matmul(x, pw, a8=a8)
        mma = route == "mma"
        if (B.launches, B.mma_launches) != (before[0] + (not mma),
                                            before[1] + mma):
            raise AssertionError(f"{what}: route {route} launched another "
                                 f"kernel")
        return close_check(what, got, B.bcq_matmul_reference(x, pw, a8=a8),
                           TOL["qmm_a8" if a8 else "qmm_a16"],
                           x.dtype == torch.bfloat16)

    for K, N in SHAPES_7B:
        for bits in (2, 3, 4):
            for gs in (-1, 128):
                pw = bcq_linear(gen, K, N, bits, gs, device)
                for M in (1, 4, 32):
                    x32 = torch.randn((M, K), generator=gen_s if M == 4
                                      else gen, device=device)
                    for act, xdt in modes:
                        a8 = act == "a8"
                        x = x32.to(xdt)
                        route = "single_row" if M == 1 else "mma"
                        err = checked(
                            f"bcq_matmul K={K} N={N} w{bits} g{gs} M={M} "
                            f"{act} {xdt}", x, pw, a8, route)
                        # the tensor-core rows are bcq_mma's (mma_worst)
                        if xdt == torch.float32 and route != "mma":
                            worst = max(worst, err)
                        row = {"K": K, "N": N, "bits": bits, "g": gs, "M": M,
                               "act": act, "x": str(xdt)[6:], "route": route,
                               "max_abs_err": err}
                        if bits == 3 and gs == 128 and M == 1 and (
                                a8 or xdt == torch.bfloat16):
                            row.update(matmul_times(
                                pw, x, a8, peaks, timer,
                                kernel=B._bcq_cuda, prepare=B._prepare,
                                wrapper=B.bcq_matmul,
                                plain=B.bcq_matmul_reference,
                                dense=B.bcq_dequant))
                            (dec if a8 else dec_bf16).append(row)
                        rows.append(row)
                del pw
        log(f"bcq_matmul K={K} N={N}: 54 cases within tolerance")
    pw = bcq_linear(gen_s, 4096, 4096, 8, 16, device)
    x32 = torch.randn((512, 4096), generator=gen_s, device=device)
    for act, xdt in modes:
        a8 = act == "a8"
        err = checked(f"bcq_matmul 4096x4096 w8 g16 M=512 {act} {xdt}",
                      x32.to(xdt), pw, a8, "shallow")
        if xdt == torch.float32:
            worst = max(worst, err)
        rows.append({"K": 4096, "N": 4096, "bits": 8, "g": 16, "M": 512,
                     "act": act, "x": str(xdt)[6:], "route": "shallow",
                     "max_abs_err": err})
    log("bcq_matmul 4096x4096 w8 g16 M=512 (CUDA-core loop): 3 cases within "
        "tolerance")
    del pw
    # the PPL eval's and the prefill's rows go through the tensor-core
    # kernel: M = 512 and 2048, each x type
    pw = bcq_linear(gen, 4096, 12288, 3, 128, device)
    big = []
    for M in (512, 2048):
        x32 = torch.randn((M, 4096), generator=gen, device=device)
        for act, xdt in modes:
            a8 = act == "a8"
            x = x32.to(xdt)
            err = checked(f"bcq_matmul M={M} {act} {xdt}", x, pw, a8,
                          "mma")
            row = {"K": 4096, "N": 12288, "bits": 3, "g": 128, "M": M,
                   "act": act, "x": str(xdt)[6:],
                   "route": B.bcq_route(M, 3, 128, pw.Np),
                   "max_abs_err": err}
            row.update(matmul_times(
                pw, x, a8, peaks, timer, kernel=B._bcq_cuda,
                prepare=B._prepare, wrapper=B.bcq_matmul,
                plain=B.bcq_matmul_reference, dense=B.bcq_dequant))
            log("bcq_matmul timing " + json.dumps(row))
            big.append(row)
    for r in dec + dec_bf16:
        log("bcq_matmul timing " + json.dumps(r))
    report["bcq_rows"] = rows
    report["bcq_decode"] = dec
    report["bcq_decode_bf16"] = dec_bf16
    report["bcq_mma"] = big
    report["bcq_m512"] = next(r for r in big
                              if r["M"] == 512 and r["x"] == "bfloat16")
    report["bcq_max_abs_err"] = worst


def mma_crossover(device, peaks, timer, report):
    """The crossover rows of #1 and #13: the CUDA-core loop against the
    tensor-core kernel at M = 2-8 and 16-128 on one weight each
    (4096x12288: w4 g-1, and 3-bit g128 BCQ), bf16 / f32 / a8 x, each
    route's output held against the plain product. qmm_route and
    bcq_route send every M >= 2 to the tensor cores on this reading."""
    import torch

    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    weights = {"qmm": (Q, Q._qmm_cuda, Q.dequant,
                       packed_linear(gen, 4096, 12288, 4, -1, device)),
               "bcq": (B, B._bcq_cuda, B.bcq_dequant,
                       bcq_linear(gen, 4096, 12288, 3, 128, device))}
    rows = []
    for M in (2, 3, 4, 5, 6, 7, 8, 16, 32, 64, 128):
        x32 = torch.randn((M, 4096), generator=gen, device=device)
        for act, xdt in (("bf16", torch.bfloat16), ("f32", torch.float32),
                         ("a8", torch.float32)):
            a8 = act == "a8"
            for name, (mod, kernel, dense, pw) in weights.items():
                x2, _ = mod._prepare(x32.to(xdt), pw, a8)
                want = torch.matmul(x2.float(), dense(pw))
                row = {"kernel": name, "M": M, "x": act}
                for route, key in (("shallow", "loop_ms"), ("mma", "mma_ms")):
                    close_check(f"crossover {name} M={M} {act} {route}",
                                kernel(x2, pw, route)[:, :pw.N], want,
                                TOL["qmm_a8" if a8 else "qmm_a16"], False)
                    row[key] = timer(lambda: kernel(x2, pw, route))
                rows.append(row)
                log("mma crossover " + json.dumps(row))
    for name in weights:
        mine = [r for r in rows if r["kernel"] == name]
        # the smallest M from which the tensor-core kernel wins every row
        frm = min((r["M"] for r in mine
                   if all(q["mma_ms"] < q["loop_ms"] for q in mine
                          if q["M"] >= r["M"])), default=None)
        log(f"mma crossover {name}: the tensor-core kernel is faster for "
            f"every x type at every M measured from M = {frm} (the routes "
            f"send M >= 2 to it)")
        report[f"mma_crossover_from_{name}"] = frm
    report["mma_crossover"] = rows


def matmul_times(pw, x, a8, peaks, timer, kernel, prepare, wrapper, plain,
                 dense, extra=None) -> dict:
    """Device times of one packed matmul: the bare kernel launch, the
    wrapper (at one row also its host time a call), the plain version and
    torch.matmul on the dequantized bf16 weight (the one-call PyTorch
    yardstick), beside the byte / operation bound of its inputs and
    output. `extra`: more named calls to time."""
    import torch

    M = x.shape[0]
    x2, _ = prepare(x, pw, a8)
    ms = timer(lambda: kernel(x2, pw))
    out = {"ms": ms, "wrapper_ms": timer(lambda: wrapper(x, pw, a8=a8)),
           "plain_ms": timer(lambda: plain(x, pw, a8=a8))}
    if M == 1:  # decode: the wrapper's host time a call
        out["wrapper_host_us"] = host_us(lambda: wrapper(x, pw, a8=a8))
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
    # of the activations' type; an f32 x as its split's two bf16 passes
    ops = 2 * M * pw.Kp * pw.Np
    kind = "int8" if a8 else "bf16"
    if not a8 and x.dtype != torch.bfloat16:
        ops *= 2
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks[kind] * 1e3
    out.update({"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return out


def stream_checks(device, peaks, timer, report):
    """#7 (GPTQ_TPU_MATMUL_IMPL=streamed) against dequant_matmul_reference
    at llama-7B shapes: 2/4/8-bit, groupsize -1 and 128, M 1 and 8, a8 and
    a16 (bf16). At M = 1 the route launches #1's single-row stream
    (csrc/gemv.cuh qgemv_kernel): its output equals #1's bit for bit, and
    qstream_kernel, forced there, is held to the plain version too; timed
    at M = 1 w4a8 g-1 beside kernel #1 and the forced qstream_kernel on
    the same weight."""
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
                            if M == 1:  # #1's kernel, and the old one
                                x2, _ = Q._prepare(x, pw, a8)
                                if not torch.equal(Q._stream_cuda(x2, pw),
                                                   Q._qmm_cuda(x2, pw)):
                                    raise AssertionError(
                                        f"streamed qmm K={K} N={N} w{bits} "
                                        f"g{gs} a8={a8}: M = 1 is not #1's "
                                        f"single-row kernel")
                                tiles = Q._stream_cuda(x2, pw, route="tiles")
                                if a8:
                                    tiles = tiles * Q._prepare(x, pw, a8)[1]
                                row["tiles_max_abs_err"] = close_check(
                                    f"streamed qmm K={K} N={N} w{bits} "
                                    f"g{gs} M=1 a8={a8} (tiles forced)",
                                    tiles[:, :pw.N],
                                    Q.dequant_matmul_reference(x, pw, a8=a8),
                                    TOL["qmm_a8" if a8 else "qmm_a16"],
                                    not a8)
                            if bits == 4 and gs == -1 and M == 1 and a8:
                                row.update(matmul_times(
                                    pw, x, a8, peaks, timer,
                                    kernel=Q._stream_cuda, prepare=Q._prepare,
                                    wrapper=Q.dequant_matmul,
                                    plain=Q.dequant_matmul_reference,
                                    dense=Q.dequant,
                                    extra={"qmm_ms": Q._qmm_cuda,
                                           "tiles_ms": functools.partial(
                                               Q._stream_cuda,
                                               route="tiles")}))
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
    x, 4-bit g-1 and g128, and one case each at 2, 3 and 8 bits, on the
    kernel expert_route picks (the tensor-core csrc/qexpert_mma.cu, or
    csrc/qexpert.cu's CUDA-core loop for the 3-bit g128 bank, whose
    128-row subblocks hold no stage window); #9 at M = 1 on each
    projection for expert indices held in a device tensor. Timed at the
    path's shapes: #8 on the 4-bit g-1 banks at M 2 / 16 / 32, bf16 and
    f32 x, beside the CUDA-core loop on the same bank (forced), #9 at
    decode, bf16 x."""
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
                route = Q.expert_route(M, bits, gs, x.dtype, pe.Kp, pe.Np)
                if (route == "mma") != (tag != "down w3g128"):
                    raise AssertionError(f"expert matmul {tag}: route "
                                         f"{route}")
                before = (Q.expert_launches, Q.expert_mma_launches)
                got = Q.expert_dequant_matmul(x, pe)
                mma = route == "mma"
                if (Q.expert_launches, Q.expert_mma_launches) != (
                        before[0] + (not mma), before[1] + mma):
                    raise AssertionError("expert_dequant_matmul did not "
                                         f"launch kernel #8's {route} "
                                         "kernel")
                want = Q.expert_dequant_matmul_reference(x, pe)
                err = close_check(f"expert matmul {tag} M={M} {dt}", got,
                                  want, tol, False)
                worst = max(worst, err)
                row = {"w": tag, "K": K, "N": N, "M": M, "x": dt,
                       "per_x": per_x, "route": route, "max_abs_err": err}
                if bits == 4 and gs == -1:
                    row.update(expert_times(pe, x, peaks, timer,
                                            plain=M == 16 and dt == "bf16"))
                rows.append(row)
                log("expert matmul " + json.dumps(row))
                del got, want
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
                if Q.select_route(1, pe.Np) != "single_row":
                    raise AssertionError(f"expert select {tag}: route")
                before = Q.select_launches
                got = Q.expert_dequant_matmul_select(x, pe, idx)
                if Q.select_launches != before + 1:
                    raise AssertionError("expert_dequant_matmul_select did "
                                         "not launch kernel #9")
                err = close_check(
                    f"expert select {tag} e={e} {dt}", got,
                    Q.expert_dequant_matmul_select_reference(x, pe, idx),
                    tol, False)
                # the row kernel it replaced at one row, forced; two
                # launches of the single-row kernel bit for bit
                rows_k = Q._select_cuda(x, pe, idx, route="rows")
                again = Q._select_cuda(x, pe, idx)
                close_check(f"expert select {tag} e={e} {dt} against "
                            f"qsel_kernel", got, rows_k[:, :pe.N], tol, False)
                if not torch.equal(again[:, :pe.N], got):
                    raise AssertionError(f"expert select {tag} e={e} {dt}: "
                                         f"two launches differ")
                worst = max(worst, err)
                row = {"w": tag, "K": pe.K, "N": pe.N, "M": 1, "e": e,
                       "x": dt, "route": "single_row", "max_abs_err": err}
                if e == 3 and dt == "bf16" and "g128" not in tag:
                    row.update(select_times(pe, x, idx, peaks, timer))
                    sel.append(row)
                rows.append(row)
        bad = torch.tensor([pe.E], dtype=torch.int32, device=device)
        if not bool(torch.isnan(Q.expert_dequant_matmul_select(
                x32, pe, bad)).all()):
            raise AssertionError(f"expert select {tag}: an index outside "
                                 f"the bank gave numbers, not NaN")
        log(f"expert select {tag}: 6 cases within {tol}, against "
            f"qsel_kernel, bit for bit twice; index {pe.E}: NaN")
    for r in sel:
        log("expert select timing " + json.dumps(r))
    report["expert_rows"] = rows
    report["expert_max_abs_err"] = worst


def expert_times(pe, x, peaks, timer, plain=True) -> dict:
    """Device times of #8 on one bank: the bare launch of the kernel the
    route picks, of the CUDA-core loop on the same bank (`loop_ms`), the
    plain version (where `plain`) and torch.bmm on the dequantized bf16
    bank, beside the byte bound (the whole bank read once) and the
    operation bound at the bf16 tensor-core peak; `cuda_core_ms`: the
    operations at the f32 CUDA-core peak, which bound a kernel on CUDA
    cores."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    E, M = pe.E, x.shape[-2]
    out = {"ms": timer(lambda: Q._expert_cuda(x, pe)),
           "loop_ms": timer(lambda: Q._expert_cuda(x, pe, route="shallow"))}
    if plain:
        out["plain_ms"] = timer(
            lambda: Q.expert_dequant_matmul_reference(x, pe))
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
    """Device times of #9 on one selected expert: the bare launch (the
    single-row qsel_gemv_kernel), the row kernel qsel_kernel it replaced
    at one row (`rows_ms`, forced), the plain version and torch.matmul on
    that expert's dequantized bf16 weight, beside the byte bound of one
    expert's words and grids; the wrapper's host time a call."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    out = {"ms": timer(lambda: Q._select_cuda(x, pe, idx)),
           "rows_ms": timer(lambda: Q._select_cuda(x, pe, idx, route="rows")),
           "plain_ms": timer(
               lambda: Q.expert_dequant_matmul_select_reference(x, pe, idx)),
           "wrapper_host_us": host_us(
               lambda: Q.expert_dequant_matmul_select(x, pe, idx))}
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
    reset_counts()
    ppl_packed = eval_ppl(spec, loaded, test, 512, log=lambda s: None)
    torch.cuda.synchronize()
    # 512-row windows: every linear on the tensor cores
    qmm_eval = launch_counts()["qmm_mma"]
    expect(launch_counts(), {"qmm_mma": 4 * 7 * spec.n_layers},
           "PPL eval of the packed model")
    ppl_dense = eval_ppl(spec, dense_twin(loaded), test, 512,
                         log=lambda s: None)
    rel = abs(ppl_packed / ppl_dense - 1.0)
    log(f"ppl: packed {ppl_packed:.4f} (qmm_mma kernel, {qmm_eval} launches) vs "
        f"dense-dequantized {ppl_dense:.4f}: rel diff {rel:.2e}")
    if not (math.isfinite(ppl_packed) and rel < 0.005):
        raise AssertionError(f"packed vs dense PPL differ by {rel:.3g}")
    report["quantize"] = {"seconds": t_quant, "per_layer_s": per_layer,
                          "ppl_packed": ppl_packed, "ppl_dense": ppl_dense}


def quantize_offload(device, tmp, report):
    """Layer-streamed host offload: a 4-layer LLaMA-7B-width HF directory
    (F16 safetensors from a seed) quantized twice, w4 g128 act-order
    true-sequential on 16 x 512 tokens, then packed: on the device, and
    with params_from_dir(host=True) (each block staged onto the card for
    its layer, its quantized weights written back; pack_model one linear
    at a time). The packed words, grids and permutations must be equal
    bit for bit, and the offload run's peak device memory at least two
    blocks' f32 weights below the on-device run's."""
    import torch

    from gptq_tpu_torch.config import QuantConfig
    from gptq_tpu_torch.data import synthetic_stream
    from gptq_tpu_torch.models.convert import params_from_dir
    from gptq_tpu_torch.pipeline import pack_model, quantize_model

    L = 4
    path = os.path.join(tmp, "llama-7b-4l")
    t0 = time.perf_counter()
    nbytes = write_hf_llama(path, L, device, seed=11)
    log(f"offload: wrote a {L}-layer LLaMA-7B-width HF directory (F16, "
        f"{nbytes / 2**30:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    cfg = QuantConfig(wbits=4, groupsize=128, act_order=True,
                      true_sequential=True, nsamples=16)
    calib = torch.as_tensor(synthetic_stream(32000, 16 * 512, seed=3)
                            .reshape(16, 512), device=device).long()
    runs, packed = {}, {}
    for mode in ("device", "offload"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        spec, params = params_from_dir(path, device=device,
                                       host=mode == "offload")
        t_load = time.perf_counter() - t0
        on_card = {k: params["layers"][0][k]["w"].device.type
                   for k in ("q", "down")}
        if on_card != dict.fromkeys(on_card, "cpu" if mode == "offload"
                                    else device.type):
            raise AssertionError(f"offload ({mode}): linears on {on_card}")
        res = quantize_model(spec, params, calib, cfg, log=lambda s: None)
        pack_model(spec, params, res.quantizers, cfg)
        torch.cuda.synchronize()
        per_layer = [res.times[f"layer{i}"] for i in range(L)]
        runs[mode] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                      "base_bytes": base, "load_s": t_load,
                      "per_layer_s": per_layer,
                      "s_per_layer": sum(per_layer) / L,
                      "total_s": time.perf_counter() - t0}
        log(f"offload ({mode}): peak device memory "
            f"{runs[mode]['peak_bytes'] / 2**30:.3f} GiB (max_memory_"
            f"allocated; {base / 2**30:.3f} GiB held before), load "
            f"{t_load:.1f} s, {runs[mode]['s_per_layer']:.2f} s/layer ("
            + ", ".join(f"{t:.2f}" for t in per_layer) + ")")
        packed[mode] = [
            [t.cpu() for k in ("q", "k", "v", "o", "gate", "up", "down")
             for t in (*lp[k]["w"].words, lp[k]["w"].scale, lp[k]["w"].zoff,
                       lp[k]["w"].perm)]
            for lp in params["layers"]]
        del params, res
    for i, (a, b) in enumerate(zip(packed["device"], packed["offload"])):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"offload: layer {i}'s packed leaves differ "
                                 f"from the on-device run's")
    block = 4 * (4 * spec.hidden * spec.hidden
                 + 3 * spec.hidden * spec.ffn)  # one block's f32 linears
    saved = runs["device"]["peak_bytes"] - runs["offload"]["peak_bytes"]
    log(f"offload: packed words, grids and perms equal bit for bit; peak "
        f"{saved / 2**30:.3f} GiB lower ({saved / block:.2f} blocks of "
        f"{block / 2**30:.3f} GiB f32 linears)")
    if saved < 2 * block:
        raise AssertionError(f"offload: the peak is only {saved / 2**30:.3f} "
                             f"GiB lower, less than two f32 blocks")
    shutil.rmtree(path, ignore_errors=True)
    report["offload"] = {**runs, "saved_bytes": saved, "block_bytes": block}


def dense_twin(params):
    """The same model with every packed linear dequantized to dense f32."""
    from gptq_tpu_torch.ops.pack import PackedWeight

    return {**params, "layers": [
        {k: ({"w": dense_weight(v["w"]), "b": v.get("b")}
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


def f64_matmuls():
    """Inside plain_versions(): the plain versions' matmuls in f64 (ops/ffn's
    phases, dequant_matmul_reference's), each rounded once to f32. A
    computation as exact as the plain one that differs from it in rounding
    only: its distance from the plain version is the floor under a
    kernel-vs-plain reading of the same function."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import qmatmul as Q

    def phase64(x, pw, a8, bias=None):
        w = Fz._dequant_stored(pw).double()
        if a8:
            xq, sx = Fz.quantize_acts_int8(x)
            y = torch.matmul(xq.double(), w) * sx.double()
        else:
            y = torch.matmul(Fz._bf16(x).double(), w)
        if bias is not None:
            y = y + Fz._vec(bias, pw.Np).double()
        return y.float()

    def matmul64(x, pw, a8=False):
        x2, sx = Q._prepare(x, pw, a8)
        y = torch.matmul(x2.double(), Q.dequant(pw).double())
        if sx is not None:
            y = y * sx.double()
        if pw.bias is not None:
            y = y + pw.bias.double()
        return y.float().reshape(*x.shape[:-1], pw.N).to(x.dtype)

    stack = contextlib.ExitStack()
    for mod, name, fn in ((Fz, "_phase", phase64),
                          (common, "dequant_matmul", matmul64)):
        stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


def greedy_check(what, eng, prompt, n_new, kernel_name, want=None,
                 families=()) -> list:
    """Greedy tokens of kernel decoding (which must launch kernel_name, and
    exactly the counts `want` where given, `families` as expect() takes
    them) against plain decoding (which must launch nothing).

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
        expect(counts, want, what, families)
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
    # 512-row windows: every linear on the tensor cores
    expect(n_eval, {"bcq_mma": 4 * 7 * spec.n_layers}, "BCQ PPL eval")
    ppl_dense = eval_ppl(spec, dense_twin(loaded), test, 512,
                         log=lambda s: None)
    rel = abs(ppl_packed / ppl_dense - 1.0)
    log(f"ppl (BCQ): packed {ppl_packed:.4f} (bcq_mma kernel, "
        f"{n_eval['bcq_mma']} launches) vs dense-dequantized {ppl_dense:.4f}: "
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

    return {"qmm": Q.launches, "qmm_mma": Q.mma_launches,
            "stream": Q.stream_launches, "bcq": B.launches,
            "bcq_mma": B.mma_launches, "attention": A.launches,
            "norm_qkv": Fz.norm_qkv_launches,
            "attn_mlp": Fz.attn_mlp_launches, "ffn": Fz.ffn_launches,
            "expert": Q.expert_launches, "select": Q.select_launches,
            "expert_mma": Q.expert_mma_launches,
            "layer": LF.launches, "partial": A.partial_launches,
            "partial_wide": A.partial_wide_launches}


def reset_counts() -> None:
    from gptq_tpu_torch.ops import attention as A
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF
    from gptq_tpu_torch.ops import qmatmul as Q

    Q.launches = Q.stream_launches = B.launches = A.launches = 0
    Q.mma_launches = B.mma_launches = 0
    Fz.norm_qkv_launches = Fz.attn_mlp_launches = Fz.ffn_launches = 0
    Fz.norm_qkv_rows_launches = Fz.mlp_rows_launches = 0
    Q.expert_launches = Q.select_launches = LF.launches = 0
    Q.expert_mma_launches = 0
    A.partial_launches = A.partial_wide_launches = 0


# the tensor-core kernel of a family: #1's (qmm) and #13's (bcq)
MMA_OF = {"qmm_mma": "qmm", "bcq_mma": "bcq"}


def expect(counts: dict, want: dict, what: str, families=()) -> None:
    """Every kernel's count equals `want` (a missing name: 0). A family
    named in `families` ("qmm", "bcq") is counted as one, its CUDA-core
    and tensor-core kernels summed: only where the token routing decides
    how many rows each launch takes (MoE experts), so that the split
    between the two cannot be known ahead."""
    counts = dict(counts)
    for mma, fam in MMA_OF.items():
        if fam in families:
            counts[fam] = counts.get(fam, 0) + counts.pop(mma, 0)
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
    dense_head = dict(params["lm_head"])  # quantize_lm_head packs in place
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
        # the 64-row prefill: each layer's four linears and the head on
        # the tensor cores; the decode steps on the fused kernels
        expect(launch_counts(), {"qmm_mma": 4 * L + 1,
                                 "norm_qkv": (L + 1) * 64,
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
        # one row: #5 on the weight stream, #4 (q|k|v and the head) and #1
        # on the single-row stream
        single_row_check(f"{route} decode profile", prof, {
            "fused": {"mlp_stream_kernel": L, "norm_qkv_gemv_kernel": L + 1},
            "unfused": {"qgemv_kernel": 4 * L},
            "layer": {"norm_qkv_gemv_kernel": 1}}[route], {
            "fused": {"norm_qkv": L + 1, "attn_mlp": L, "attention": L},
            "unfused": {"qmm": 4 * L, "attention": L},
            "layer": {"layer": L, "norm_qkv": 1}}[route])

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
    # 9 forwards (a 16-row prefill, 8 steps), each 2 layers + the head;
    # the o projection takes the tensor cores in the prefill, qmv after
    expect(ffn_counts, {"norm_qkv": 9 * 3, "ffn": 9 * 2, "qmm_mma": 2,
                        "qmm": 8 * 2, "attention": 8 * 2}, "ffn route")
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
            "layer", want={"qmm_mma": 4 * 2 + 1, "layer": 2 * 16,
                           "norm_qkv": 16})
    fused_toks = greedy_check("2-layer decoding (fused, bf16 KV)", eng2b,
                              prompt, 16, "attn_mlp")
    report["layer_vs_fused"] = route_check(eng2b, prompt, layer_toks,
                                           fused_toks)
    serve_chained(device, spec, params, dense_head, card, report)
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


def chained_run(route, spec, served, ids, cdt, card, layer="off",
                mode="auto") -> dict:
    """benchmark_decode_chained (a 128-token chain and a 64-token one, each
    one CUDA graph) on one route, its result logged. The counters count
    only eager calls and each captured launch once (launch_counts), so the
    counts are printed and not asserted."""
    import torch

    from gptq_tpu_torch.engine.decode import benchmark_decode_chained

    with env_var("GPTQ_TPU_LAYER_FUSION", layer), fusion_mode(mode):
        reset_counts()
        t0 = time.perf_counter()
        r = benchmark_decode_chained(spec, served, ids, cache_dtype=cdt,
                                     log=lambda s: None)
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["launches_eager_and_captured"] = launch_counts()
    log(f"chained {route} ({str(cdt).replace('torch.', '')} KV, "
        f"{spec.n_layers} layers, {ids.shape[-1]} tokens): per_token "
        f"{r['per_token_s'] * 1e3:.3f} ms ({r['tokens_per_s']:.2f} tok/s), "
        f"full_run {r['full_run_s']:.4f} s, half_run {r['half_run_s']:.4f} "
        f"s, dispatch_rtt {r['dispatch_rtt_s'] * 1e3:.4f} ms, below noise "
        f"floor {r['below_noise_floor']} on {card}; "
        + json.dumps(r["launches_eager_and_captured"]))
    return r


def chained_tokens(route, spec, params, prompt, cdt, layer="off",
                   mode="auto") -> None:
    """generate_chained's greedy tokens equal generate's on one route."""
    from gptq_tpu_torch.engine.decode import DecodeEngine

    with env_var("GPTQ_TPU_LAYER_FUSION", layer), fusion_mode(mode):
        eng = DecodeEngine(spec, params, max_len=64, batch=1, cache_dtype=cdt,
                           a8=True)
        want = eng.generate(prompt, 24)
        got = eng.generate_chained(prompt, 24, chunk=8)
    log(f"2-layer generate_chained ({route}): {got[0].tolist()}")
    if not np.array_equal(got, want):
        raise AssertionError(f"generate_chained ({route}) parts from "
                             f"generate: {got[0].tolist()} vs "
                             f"{want[0].tolist()}")


def serve_chained(device, spec, params, dense_head, card, report):
    """The chained protocol on the 32-layer model: the layer route (bf16
    KV), the default fused route (int8 KV), both with the 8-bit head in
    params, and the unfused route (int8 KV, the dense head, #1 at one row
    128 times a step); then generate_chained against generate on 2 layers
    of each route."""
    import torch

    from gptq_tpu_torch.models.common import fuse_serving

    served = fuse_serving(spec, params, a8=True)
    unfused = {**params, "lm_head": dense_head}
    ids = np.random.default_rng(11).integers(0, spec.vocab, size=(1, 128))
    routes = (("layer", "on", "auto", torch.bfloat16, served),
              ("fused", "off", "auto", torch.int8, served),
              ("unfused", "off", "off", torch.int8,
               fuse_serving(spec, unfused, a8=True)))
    out = {route: chained_run(route, spec, p, ids, cdt, card, layer, mode)
           for route, layer, mode, cdt, p in routes}
    # 2 layers: the chained tokens equal the per-token ones on each route
    small = llama7b_spec(2)
    prompt = np.random.default_rng(12).integers(0, small.vocab, size=(1, 20))
    for route, layer, mode, cdt, _ in routes:
        p2 = unfused if route == "unfused" else params
        chained_tokens(route, small, {**p2, "layers": p2["layers"][:2]},
                       prompt, cdt, layer, mode)
        out[route]["chained_tokens_equal"] = True
    # the layer route's graph replays left the kernel's barrier and ticket
    # words zero (but the barrier's generation)
    from gptq_tpu_torch.ops import layer_fused as LF

    if not LF.sync_clean(device):
        raise AssertionError("chained: the layer kernel left barrier or "
                             "ticket words set")
    report["chained"] = out


def serve_bcq(device, tmp, card, report):
    """The BCQ route: an 8-layer 3-bit g128 BCQ checkpoint (llama-7B
    width; 32 layers until PR 16, cut for the smoke's time limit) through
    the CLI; every packed linear launches #13 (the fused kernels take
    uniform weights only), 32 per step, plus 8 attention launches; its
    profile,
    2-layer greedy tokens against the plain versions, the chained protocol
    and 2-layer generate_chained against generate."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.io import save_checkpoint

    spec = llama7b_spec(8)
    L = spec.n_layers
    t0 = time.perf_counter()
    params = synth_packed_params(spec, device, bits=3, groupsize=128, seed=7,
                                 fmt="bcq")
    path = os.path.join(tmp, f"bcq{L}.npz")
    save_checkpoint(path, spec, params)
    log(f"serve (BCQ): synthesized + saved a {L}-layer 3-bit g128 BCQ "
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
    # the chained protocol (#13 at one row 128 times a step), and 2-layer
    # generate_chained against generate
    del eng, eng2
    from gptq_tpu_torch.models.common import fuse_serving

    ids = np.random.default_rng(11).integers(0, spec.vocab, size=(1, 128))
    r["chained"] = chained_run("bcq", spec, fuse_serving(spec, params,
                                                         a8=True),
                               ids, torch.int8, card)
    chained_tokens("bcq", small, {**params, "layers": params["layers"][:2]},
                   np.random.default_rng(12).integers(0, small.vocab,
                                                      size=(1, 20)),
                   torch.int8)
    r["chained"]["chained_tokens_equal"] = True


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
        # one row: #7 launches #1's single-row stream, no qstream_kernel
        prof = profile_decode(eng, np.random.default_rng(17).integers(
            0, spec.vocab, size=(1, 64)))
    if prof["device_ms"] > 0:
        prof["device_busy_share"] = prof["device_ms"] / r["median_ms"]
    log("decode profile streamed " + json.dumps(prof))
    r["profile"] = prof
    single_row_check("streamed decode profile", prof,
                     {"qgemv_kernel": 4 * spec.n_layers},
                     {"stream": 4 * spec.n_layers,
                      "attention": spec.n_layers})
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
    # 24 a layer, beside q, k, v and o; the rows an expert gets decide
    # which of #1's kernels it takes, so the family counts as one
    expect(counts, {"qmm": 4 * (4 + 3 * spec.n_experts)}, "MoE PPL eval",
           families=("qmm",))
    ppl_dense = eval_ppl(spec, moe_dense_twin(loaded), test, 512,
                         log=lambda s: None)
    rel = abs(ppl_packed / ppl_dense - 1.0)
    log(f"ppl (MoE, w4 g-1): packed {ppl_packed:.4f} ({counts['qmm']} qmm "
        f"+ {counts['qmm_mma']} qmm_mma launches) vs dense-dequantized "
        f"{ppl_dense:.4f}: rel diff "
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
    model in-process, per token and chained (a CUDA graph a chain); one
    layer's decode FFN without a host sync."""
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
    single_row_check("moe8 decode profile", prof,
                     {"qsel_gemv_kernel": 6 * L, "qgemv_kernel": L,
                      "norm_qkv_gemv_kernel": L + 1},
                     moe_decode_counts(L, 1))
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
        if T <= 32:  # prefill through #8 on the tensor cores: 3 launches
            # a layer, o on the tensor cores too
            want = {"norm_qkv": dec["norm_qkv"] + L2 + 1,
                    "qmm": dec["qmm"], "qmm_mma": L2,
                    "expert_mma": 3 * L2,
                    "select": dec["select"], "attention": dec["attention"]}
            fams = ()
        else:  # per-expert #1: 3E a layer, beside q|k|v, o and the head
            # (the rows each expert gets pick its kernel: one family)
            want = {"norm_qkv": dec["norm_qkv"],
                    "qmm": dec["qmm"] + L2 * (2 + 3 * E) + 1,
                    "select": dec["select"], "attention": dec["attention"]}
            fams = ("qmm",)
        toks = greedy_check(f"2-layer MoE request T={T} (f32 activations "
                            f"and cache)", eng2, prompt, n_new,
                            "expert_mma" if T <= 32 else "qmm", want,
                            fams)
        reqs[T] = {"launches": want, "tokens": toks}
    # the CUDA-core #8 on the banks expert_route sends to it: 3-bit g128
    # experts, whose 128-row subblocks hold no stage window
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    h, f = small.hidden, small.ffn
    p3 = {**p2, "layers": [
        {**lp, "experts": {n: packed_bank(gen, E, K, N, 3, 128, device)
                           for n, K, N in (("gate", h, f), ("up", h, f),
                                           ("down", f, h))}}
        for lp in p2["layers"]]}
    eng3 = DecodeEngine(small, p3, max_len=128, batch=1,
                        cache_dtype=torch.float32, a8=False)
    dec = moe_decode_counts(L2, n_new)
    want = {"norm_qkv": dec["norm_qkv"] + L2 + 1, "qmm": dec["qmm"],
            "qmm_mma": L2, "expert": 3 * L2, "select": dec["select"],
            "attention": dec["attention"]}
    toks = greedy_check("2-layer MoE request T=16, 3-bit g128 experts (the "
                        "CUDA-core #8)", eng3,
                        rng.integers(0, small.vocab, size=(1, 16)), n_new,
                        "expert", want)
    reqs["16 w3g128"] = {"launches": want, "tokens": toks}
    moe["requests"] = reqs
    del eng2, eng3, p2, p3

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

    # the whole model on the card, no checkpoint on disk: 16 layers (32
    # until PR 16, cut for the smoke's time limit)
    spec = mixtral_spec(16)
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
           f"MoE {spec.n_layers} layers")
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
    # the MoE layer's routing glue: the kernels of no family, a layer
    prof["other_kernels_per_layer"] = (prof["device_events_per_step"]["other"]
                                       / spec.n_layers)
    r32["profile"] = prof
    r32["prefill"] = moe_prefill_times(eng, spec, device)
    log(f"moe prefill ({spec.n_layers} layers, Mixtral-8x7B width, w4a8, "
        f"B=1; #8 on the tensor cores) " + json.dumps(r32["prefill"]))
    log(f"decode moe ({spec.n_layers} layers, Mixtral-8x7B width, w4a8 + w8 "
        f"head + int8 "
        f"KV, B=1, in-process benchmark_decode): median "
        f"{r32['median_ms']:.3f} ms/token, {r32['tokens_per_s']:.2f} tok/s "
        f"on {card}; {alloc:.1f} GiB on the card; byte bound "
        f"{r32['bound_ms']:.3f} ms/token ({nbytes / 1e9:.3f} GB per step)")
    log("decode profile moe32 " + json.dumps(prof))
    single_row_check("moe32 decode profile", prof,
                     {"qsel_gemv_kernel": 6 * spec.n_layers,
                      "qgemv_kernel": spec.n_layers,
                      "norm_qkv_gemv_kernel": spec.n_layers + 1},
                     moe_decode_counts(spec.n_layers, 1))
    # the chained protocol: each chain one CUDA graph, whose capture fails
    # on any host synchronisation of the step (the routing, the expert
    # indices and their selections stay on the card)
    del eng
    r32["chained"] = chained_run("moe", spec, fused, ids, torch.int8, card)
    moe["decode32"] = r32
    del fused, params
    torch.cuda.empty_cache()


def moe_prefill_times(eng, spec, device) -> dict:
    """Seconds of one prefill of T = 16 and 32 tokens on the engine's
    MoE model (host clock to a synchronize; the median of 3 after
    a warm-up), with one prefill's launches: each layer's experts take #8
    on the tensor cores, 3 launches a layer."""
    import torch

    out = {}
    for T in (16, 32):
        ids = torch.as_tensor(np.random.default_rng(17 + T).integers(
            0, spec.vocab, size=(1, T)), device=device)
        eng.prefill(ids)
        torch.cuda.synchronize()
        reset_counts()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.prefill(ids)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        per = {k: v // 3 for k, v in launch_counts().items() if v}
        if per.get("expert_mma") != 3 * spec.n_layers or "expert" in per:
            raise AssertionError(f"MoE prefill T={T}: launches {per}")
        out[T] = {"median_s": sorted(runs)[1], "runs_s": runs,
                  "launches": per}
    return out


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
    """An 8-layer llama-7B-width model (32 layers until PR 16, cut for the
    smoke's time limit) through
    SPEngine(sp=1): fused route, a8, the 8-bit head, int8 cache, max_len
    2048 (per-token median, chained benchmark, profile), a 1,024-token
    prompt through the ring prefill and 64 decoded tokens; then 2 layers
    on a bf16 cache: greedy tokens against the plain versions and the
    logits against DecodeEngine's flat decode."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.engine.serving import SPEngine
    from gptq_tpu_torch.pipeline import quantize_lm_head

    spec = llama7b_spec(8)
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
    single_row_check("sp decode profile", prof,
                     {"mlp_stream_kernel": L, "norm_qkv_gemv_kernel": L + 1},
                     {"partial_wide": L, "norm_qkv": L + 1, "attn_mlp": L})
    c = r["chained"]
    log(f"sp decode (sp=1, {L} layers, w4a8 + w8 head, int8 KV, max_len "
        f"2048, B=1): median {r['median_ms']:.3f} ms/token "
        f"({r['tokens_per_s']:.2f} tok/s), chained "
        f"{c['per_token_s'] * 1e3:.3f} ms/token (full {c['full_run_s']:.4f} "
        f"s, half {c['half_run_s']:.4f} s, below noise floor "
        f"{c['below_noise_floor']}), one all_reduce {r['all_reduce_ms']:.4f} "
        f"ms of host time, on {card}; launches " + json.dumps(counts))
    log("decode profile sp " + json.dumps(prof))
    # long context: a 1,024-token prompt through the ring prefill, then 64
    # decoded tokens over ~1,100 filled slots
    long_ids = torch.as_tensor(rng.integers(0, spec.vocab, size=(1, 1024)),
                               device=device)
    # one prefill to warm up (its wall time kept apart: it is the first at
    # 1,024 rows), then the median of three; each launches exactly each
    # layer's four packed linears and the head on the tensor cores
    pre_s, pre_counts = [], None
    for i in range(4):
        cache = logits = None
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = eng.prefill(long_ids)
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
        pre_counts = {k: v for k, v in launch_counts().items() if v}
        expect(pre_counts, {"qmm_mma": 4 * L + 1}, f"sp ring prefill {i}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("sp ring prefill: non-finite logits")
    prefill_s = float(np.median(pre_s[1:]))
    log("sp ring prefill launches (each prefill) " + json.dumps(pre_counts))
    times, cache, _ = timed_steps(eng, cache, logits.argmax(-1)[:, None], 64)
    filled = int((cache.pos >= 0).sum())
    assert cache.length == 1024 + 64 and filled == 1024 + 64
    r["long"] = {"prompt": 1024, "new_tokens": 64, "filled_slots": filled,
                 "prefill_s": prefill_s, "prefill_warmup_s": pre_s[0],
                 "prefill_runs_s": pre_s[1:], "prefill_launches": pre_counts,
                 "median_ms": float(np.median(times)) * 1e3}
    log(f"sp long context: 1,024-token ring prefill {prefill_s:.3f} s (median "
        f"of {', '.join(f'{t:.4f}' for t in pre_s[1:])} s after a warm-up "
        f"prefill of {pre_s[0]:.4f} s), then "
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
    one F16 model.safetensors of seeded random weights (write_hf_dir).
    Returns the bytes written."""
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
    return write_hf_dir(path, cfg, shapes, device, seed)


def write_hf_dir(path, cfg, shapes, device, seed) -> int:
    """config.json (cfg) and one F16 model.safetensors (8-byte header
    length, JSON header, raw bytes) of seeded random weights of `shapes`,
    scaled as models.common.init_params scales them (embeddings 0.02,
    matrices 0.4 / sqrt(in), norm weights 1, biases 0.02), written tensor
    by tensor. Returns the bytes written."""
    import torch

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
            if len(shape) == 1 and name.endswith(".bias"):
                t = torch.randn(shape, generator=gen, device=device) * 0.02
            elif len(shape) == 1:
                t = torch.ones(shape, device=device)
            else:
                scale = (0.02 if "embed" in name or name.startswith("lm_head")
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


def cli_batch(runs) -> list:
    """Runs of cli_quantize side by side, each in a process of its own
    (this script with --cli-run) under the stood-in data: the solver's
    column loop is host-bound Python, one core a run, and its small
    kernels leave the card idle most of the time, so runs side by side
    each keep about their time alone (s per layer in each run's log
    line). `runs`: (what, argv, launches a PPL window, tokenizer vocab).
    Returns each run's cli_quantize result, in order, after logging its
    lines; a run that fails raises here, and no process outlives the
    call."""
    procs = []
    try:
        for what, argv, per_window, vocab in runs:
            f = tempfile.TemporaryFile("w+")
            arg = json.dumps({"what": what, "argv": argv,
                              "per_window": per_window, "vocab": vocab})
            procs.append((what, f, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cli-run",
                 arg], stdout=f, stderr=subprocess.STDOUT)))
        out = []
        for what, f, p in procs:
            rc = p.wait()
            f.seek(0)
            lines = f.read().splitlines()
            res = [line for line in lines if line.startswith(RESULT)]
            for line in lines:
                if not line.startswith(RESULT):
                    log(line)
            if rc != 0 or len(res) != 1:
                raise AssertionError(f"cli {what}: its process exited {rc}")
            out.append(json.loads(res[0][len(RESULT):]))
        return out
    finally:
        for _, f, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()


def cli_run(arg) -> int:
    """One run of cli_batch, in its own process: cli_quantize under the
    stood-in data; its result is printed on a line that starts with
    RESULT."""
    import torch

    run = json.loads(arg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with offline_data(run["vocab"]):
        res = cli_quantize(run["what"], run["argv"], lambda w: {
            k: v * w for k, v in run["per_window"].items()})
    print(RESULT + json.dumps(res), flush=True)
    return 0


# the line of a cli_run process that holds its result
RESULT = "cli_run result: "


def dense_ppl(spec, path, tok, device) -> float:
    """wikitext2 PPL of a saved checkpoint with every packed linear (the
    head too) dequantized to dense f32: the packed evals' reference."""
    from gptq_tpu_torch.data import get_loaders
    from gptq_tpu_torch.eval.ppl import eval_ppl
    from gptq_tpu_torch.io import load_checkpoint
    from gptq_tpu_torch.ops.pack import PackedWeight

    _, params, _ = load_checkpoint(path, device=device)
    dense = dense_twin(params)
    if params["lm_head"] is not None and isinstance(params["lm_head"]["w"],
                                                    PackedWeight):
        dense["lm_head"] = {"w": dense_weight(params["lm_head"]["w"]),
                            "b": None}
    _, test = get_loaders("wikitext2", seed=0, seqlen=spec.max_pos,
                          tokenizer=tok)
    return eval_ppl(spec, dense, test.input_ids, spec.max_pos,
                    log=lambda s: None)


# the CLI's 2-layer model directories, written once under the smoke's
# temporary directory and shared by the cli, families and mixed phases (the
# OPT one is named as configs/layerwise.json's row)
CLI_DIRS = {
    "llama-7b": lambda path, device: write_hf_llama(path, 2, device, seed=7),
    "opt-6.7b": lambda path, device: write_hf_opt(path, 2, device, seed=31)}


def cli_dir(tmp, model, device) -> tuple:
    """The 2-layer HF directory of `model` (CLI_DIRS) at its published
    width, F16 safetensors: (path, bytes written, seconds; both 0 where an
    earlier phase wrote it)."""
    path = os.path.join(tmp, model)
    if os.path.exists(os.path.join(path, "config.json")):
        return path, 0, 0.0
    t0 = time.perf_counter()
    nbytes = CLI_DIRS[model](path, device)
    return path, nbytes, time.perf_counter() - t0


def phase_cli(device, tmp, report):
    """quantize from a model directory through the CLI: the 2-layer
    LLaMA-7B-width HF directory (cli_dir) -> convert -> calibrate
    (16 c4 windows of 2,048) -> GPTQ w4 g128 act-order true-sequential ->
    pack (+ the 8-bit head) -> save -> PPL through #1; beside it
    (cli_batch) --lut_eval (3-bit g128) -> sign planes -> PPL through #13;
    each PPL against the
    dense twin of its saved file; then the saved w4 file served through
    the CLI (--benchmark 32 --faster-kernel --int8_kv: act-order weights
    take the unfused route, the 8-bit head the fused one). --new-eval
    keeps each test set at two windows (c4's classic protocol evaluates
    256)."""
    from gptq_tpu_torch.models.convert import hf_config
    from gptq_tpu_torch.models.registry import spec_from_hf_config

    L = 2
    hf, nbytes, write_s = cli_dir(tmp, "llama-7b", device)
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
    # side by side (cli_batch); 2,048-row windows: every linear and the
    # head on the tensor cores, none on the CUDA-core kernel
    out["w4"], out["b3"] = cli_batch([
        ("w4", [hf, "c4", "--wbits", "4", "--groupsize", "128",
                "--act-order", "--true-sequential", "--eval_pack",
                "--quant_lm_head", "8", "--save", q4, *common],
         {"qmm_mma": 7 * L + 1}, spec.vocab),
        ("lut b3", [hf, "c4", "--wbits", "3", "--groupsize", "128",
                    "--lut_eval", "--eval_pack", "--save", qb, *common],
         {"bcq_mma": 7 * L}, spec.vocab)])
    with offline_data(spec.vocab) as tok:
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
    trace of `steps` steps after a 64-token prefill, and the wrappers'
    launch counts over those steps (reset just before them). The profiled
    steps' wall time includes the profiler's own overhead; the busy share
    is taken against the unprofiled benchmark median instead. A trace that
    holds no device events reports device_ms 0 (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logits, cache = eng.prefill(torch.as_tensor(prompt, device=eng.device))
    tok = logits.argmax(-1)[:, None]
    for _ in range(3):
        logits, cache = eng.step(cache, tok)
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = eng.step(cache, tok)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    fams = (("qmm", ("qmm_kernel", "qgemv_kernel")), ("mma", ("qmma_kernel",)),
            ("select", ("qsel_kernel", "qsel_gemv_kernel")),
            ("expert", ("qexpert_kernel",)),
            ("expert_mma", ("qexpert_mma_kernel", "xprep_kernel")),
            ("bcq", ("bcq_gemv_kernel", "bcq_mm_kernel")),
            ("stream", ("qstream_kernel",)),
            ("attention", ("attnd_tile",)),
            ("partial", ("attnp_tile",)),
            ("norm_qkv", ("norm_qkv_kernel", "norm_qkv_gemv_kernel",
                          "norm_qkv_rows_kernel")),
            ("mlp", ("mlp_kernel", "mlp_stream_kernel", "mlp_rows_kernel")),
            ("layer", ("layer_kernel",)))
    ms = {f: 0.0 for f, _ in fams}
    ms["other"] = 0.0
    n = dict.fromkeys(ms, 0.0)
    # launches a step of #1 / #7's, #4's, #5 / #6's and #9's kernels by
    # name: the single-row ones and those they replaced at one row
    named = dict.fromkeys(SINGLE_ROW_KERNELS, 0.0)
    host, buffer_requests = [], 0
    for e in prof.key_averages():
        if e.key == "Activity Buffer Request":  # CUPTI's, on the host
            buffer_requests += e.count
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3 / steps, e.key,
                         e.count / steps))
            continue
        fam = next((f for f, keys in fams if any(k in e.key for k in keys)),
                   "other")
        ms[fam] += e.device_time_total / 1e3 / steps
        n[fam] += e.count / steps
        for name in named:
            if name + "<" in e.key:
                named[name] += e.count / steps
    # the host side: the operators with the most self CPU time a step
    # (under the profiler, which adds its own cost to each)
    host_top = [{"op": k, "self_ms": t, "calls": c}
                for t, k, c in sorted(host, reverse=True)[:8]]
    return {"steps": steps, "profiled_wall_ms": wall / steps * 1e3,
            "device_ms": sum(ms.values()),
            "device_ms_by_family": ms, "device_events_per_step": n,
            "kernels_per_step": named, "launches": counts,
            "buffer_requests": buffer_requests, "host_top": host_top}


# the single-row kernels of #1 / #7 (qgemv_kernel), #4, #5 / #6 and #9,
# and the kernels that serve those functions at more rows (profile_decode
# counts them by name)
SINGLE_ROW_KERNELS = ("mlp_stream_kernel", "mlp_kernel", "qsel_gemv_kernel",
                      "qsel_kernel", "norm_qkv_gemv_kernel", "norm_qkv_kernel",
                      "qgemv_kernel", "qmm_kernel", "qstream_kernel",
                      "norm_qkv_rows_kernel", "mlp_rows_kernel")


def single_row_check(what, prof, want, counts=None) -> None:
    """A decode profile's routes (at one row; window_profile's: at the
    batcher's slots). The wrappers' launch counts over the profiled steps
    equal `counts` a step times the steps (a missing name: 0; None: a
    graph replay, which calls no wrapper), and where the trace holds
    device events, each kernel named in `want` appears in it, none above
    its launches a step, and the rest of the kernels the profile counts
    by name do not appear. The counters give the exact
    number, the names the kernel each launch took: a CUPTI trace can drop
    a kernel record (seen on an H100: a one-call trace that held an
    "Activity Buffer Request" and no qgemv_kernel; one norm_qkv_gemv_kernel
    of 72 and of 264 in the Mixtral profiles), so a shortfall by name is
    logged beside the trace's buffer requests, not counted."""
    steps = prof["steps"]
    if counts is not None:
        expect(prof["launches"], {k: v * steps for k, v in counts.items()},
               f"{what} (launch counters over {steps} steps)")
    if prof["device_ms"] <= 0:
        log(f"{what}: the trace holds no device events; kernels by name not "
            f"measured")
        return
    bad = {}
    for k, v in prof["kernels_per_step"].items():
        w = want.get(k, 0)
        if v > w + 1e-9 or (w > 0) != (v > 0):
            bad[k] = (v, w)
        elif v < w:
            log(f"{what}: the trace holds {round((w - v) * steps)} {k} "
                f"record(s) fewer than its {w * steps} launches "
                f"({prof['buffer_requests']} activity buffer requests)")
    if bad:
        raise AssertionError(f"{what}: launches a step by kernel (got, want) "
                             f"{bad}")


# ---------------------------------------------------------------------------
# batch: continuous batching (engine/batching.ContinuousBatcher)
# ---------------------------------------------------------------------------

def step_bytes(spec, served, lens, cache_item, scaled) -> int:
    """Bytes one lock-step must move at least: every packed weight of the
    layers and the head once, the norms, each slot's filled cache rows
    (and an int8 cache's scales) of every layer read and its fresh rows
    written, one bf16 embedding row and one f32 logits row a slot."""
    from gptq_tpu_torch.ops.pack import PackedWeight

    weights = [e["w"] for lp in served["layers"] for e in lp.values()
               if isinstance(e, dict) and isinstance(e.get("w"),
                                                      PackedWeight)]
    weights.append(served["lm_head"]["w"])
    H, L, B = spec.hidden, spec.n_layers, len(lens)
    per_tok = 2 * spec.kv_heads * (spec.hd * cache_item + (4 if scaled
                                                           else 0))
    return (sum(packed_bytes(w) for w in weights) + (2 * L + 1) * H * 2
            + L * (sum(lens) + B) * per_tok
            + B * H * 2 + B * served["lm_head"]["w"].N * 4)


# the kernels a batcher lock-step's profile counts by name: #3's decode
# kernel, #12's whole-layer kernel and SINGLE_ROW_KERNELS
BATCH_KERNELS = ("attnd_tile", "layer_kernel") + SINGLE_ROW_KERNELS


def window_profile(n, replay) -> tuple:
    """Device time a lock-step by kernel family, and launches a step of
    BATCH_KERNELS by name, from a torch.profiler trace of replay(n), one
    replay of the batcher's n-step window graph. Fails if the trace holds
    no device event. Returns (profile, the window's tokens)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fams = (("norm_qkv", ("norm_qkv_kernel", "norm_qkv_gemv_kernel",
                          "norm_qkv_rows_kernel")),
            ("mlp", ("mlp_kernel", "mlp_stream_kernel", "mlp_rows_kernel")),
            ("attention", ("attnd_tile",)), ("layer", ("layer_kernel",)),
            ("qmm", ("qgemv_kernel", "qmm_kernel", "qmma")))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        toks = replay(n)
        torch.cuda.synchronize()
    ms = dict.fromkeys([f for f, _ in fams] + ["other"], 0.0)
    named = dict.fromkeys(BATCH_KERNELS, 0.0)
    buffer_requests = 0
    for e in prof.key_averages():
        if e.key == "Activity Buffer Request":  # CUPTI's, on the host
            buffer_requests += e.count
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((f for f, keys in fams if any(k in e.key for k in keys)),
                   "other")
        ms[fam] += e.device_time_total / 1e3 / n
        for name in named:
            if name + "<" in e.key:
                named[name] += e.count / n
    if not sum(ms.values()) > 0:
        raise AssertionError("batch profile: the trace of a window's graph "
                             "replay holds no device event")
    return {"steps": n, "device_ms": sum(ms.values()),
            "device_ms_by_family": ms, "kernels_per_step": named,
            "buffer_requests": buffer_requests}, toks


def batcher_run(cb, requests, window, profile_window=None) -> dict:
    """Submit `requests` ((prompt, max_new) pairs) and run the batcher to
    the end: tokens, wall seconds (prefill included, and the capture of a
    window graph met for the first time), prefill dispatches, decode
    steps, the wall seconds of the windows not profiled and their steps;
    with profile_window = k, the k-th window runs under the profiler
    (window_profile)."""
    import torch

    real = cb._window
    stats = {"steps": 0, "window_s": 0.0, "windows": 0, "timed_steps": 0}

    def timed_window(n):
        stats["windows"] += 1
        stats["steps"] += n
        if stats["windows"] == profile_window:
            lens = cb.lengths.tolist()
            t0 = time.perf_counter()
            stats["profile"], out = window_profile(n, real)
            stats["profile"].update(lens=lens,
                                    wall_s=time.perf_counter() - t0)
            return out
        t0 = time.perf_counter()
        out = real(n)
        torch.cuda.synchronize()
        stats["window_s"] += time.perf_counter() - t0
        stats["timed_steps"] += n
        return out

    cb._window = timed_window
    calls = cb.prefill_calls
    try:
        for prompt, n in requests:
            cb.submit(prompt, max_new_tokens=int(n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cb.run(window=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del cb._window
    toks = [r.output for r in res]
    n_tok = sum(len(t) for t in toks)
    return {"tokens": toks, "wall_s": wall, "new_tokens": n_tok,
            "tokens_per_s": n_tok / wall,
            "prefill_calls": cb.prefill_calls - calls, **stats}


def engine_forced_logits(eng, prompts, toks) -> list:
    """DecodeEngine's logits teacher-forced on toks: for request i, the
    f32 rows (len(toks[i]), vocab) of prefill(prompts[i]) and of eng.step
    on each of toks[i][:-1], the logits by which DecodeEngine.generate
    picks each token."""
    import torch

    out = []
    for p, t in zip(prompts, toks):
        lg, cache = eng.prefill(torch.as_tensor(np.asarray(p)[None],
                                                device=eng.device))
        rows = [lg[0].float()]
        for x in t[:-1]:
            lg, cache = eng.step(cache, torch.tensor([[int(x)]],
                                                     device=eng.device))
            rows.append(lg[0].float())
        out.append(torch.stack(rows))
    return out


def batcher_forced_logits(cb, prompts, toks) -> list:
    """A batcher's lock-step logits teacher-forced on toks: the prompts
    fill cb's free slots, cb.B at a time (_fill_slots, request k of a wave
    in slot k), then each eager lock-step's logits (cb._logits) are kept
    for the requests still running and each slot's next token is the
    forced one. Returns per request its f32 rows (len(toks[i]), vocab)."""
    import torch

    out = [[] for _ in prompts]
    for w0 in range(0, len(prompts), cb.B):
        wave = list(range(w0, min(w0 + cb.B, len(prompts))))
        uids = [cb.submit(prompts[i], max_new_tokens=len(toks[i]))
                for i in wave]
        cb._fill_slots()
        assert [r.uid for r in cb.slot_req[:len(wave)]] == uids
        for j in range(max(len(toks[i]) for i in wave)):
            lg = cb._logits().float()
            nxt = cb.tokens.tolist()
            for k, i in enumerate(wave):
                if j < len(toks[i]):
                    out[i].append(lg[k])
                    nxt[k] = int(toks[i][j])
            cb.tokens.copy_(torch.tensor(nxt, device=cb.device))
            cb.lengths.add_(1).clamp_(max=cb.S - 1)
        cb.slot_req = [None] * cb.B
        cb.lengths.zero_()
    return [torch.stack(r) for r in out]


def forced_agree(what, toks, ref, got, tol) -> dict:
    """Two decodings' logits teacher-forced on the same tokens toks (`got`
    the side that emitted them, `ref` the reference), held to
    route_check's rule at every position of every request: the logits
    agree within tol x max |ref| (the whole-logit relative difference of
    TOL["logits_a8"]), and where either side's top token is not the
    emitted one (a parting), each side's top logit lies within twice the
    largest logit difference of that side's logit of every token in
    question (the emitted one and both tops): a near tie that sums in
    another order may round either way. Teacher forcing carries the
    comparison on past a parting. Returns the partings, the largest gap
    as a share of its limit, the positions where the emitting side's own
    top differs from its token, and the largest relative difference."""
    import torch

    parted, self_parted, worst = [], 0, 0.0
    for r, (t, la, lb) in enumerate(zip(toks, ref, got)):
        spread = (la - lb).abs().amax(-1)
        rel = spread / la.abs().amax(-1)
        worst = max(worst, float(rel.max()))
        if not float(rel.max()) <= tol:
            j = int(rel.argmax())
            raise AssertionError(f"{what}: request {r} step {j}: logits "
                                 f"differ by {float(rel[j]):.3g} of max "
                                 f"|logit| > {tol}")
        tt = torch.as_tensor(np.asarray(t), device=la.device)
        ta, tb = la.argmax(-1), lb.argmax(-1)
        self_parted += int((tb != tt).sum())
        for j in torch.nonzero((ta != tt) | (tb != tt)).flatten().tolist():
            us = {int(tt[j]), int(ta[j]), int(tb[j])}
            gap = max(float(s[j].max() - s[j][u]) for s in (la, lb)
                      for u in us)
            parted.append({"request": r, "step": j, "emitted": int(tt[j]),
                           "ref_top": int(ta[j]), "emitter_top": int(tb[j]),
                           "gap": gap, "spread": float(spread[j]),
                           "rel": float(rel[j])})
            if not gap <= 2 * float(spread[j]):
                raise AssertionError(f"{what}: request {r} parts at step {j} "
                                     f"beyond a near tie: {parted[-1]}")
    def share(p):
        return p["gap"] / (2 * p["spread"]) if p["spread"] > 0 else 0.0

    if parted:
        log(f"{what}: the closest of {len(parted)} partings to the limit "
            + json.dumps(max(parted, key=share)))
    return {"positions": sum(len(t) for t in toks), "parted": parted,
            "worst_gap_share": max(map(share, parted), default=0.0),
            "emitter_parted": self_parted,
            "max_rel": worst}


def batch_kernel_times(device, spec, served, peaks, timer) -> list:
    """#4 (ln1 + q|k|v, and final_ln + the 8-bit head) and #5 (o + ln2 +
    MLP) on the batcher's layer-0 weights at M = 4 and 32, a8: each held
    to its plain version (the near-tie rule), timed beside its plain
    version, the unfused route, torch.matmul over the dequantized bf16
    weights at the same M, and its bound."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.ops import ffn as Fz

    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    H = spec.hidden
    lp = served["layers"][0]
    ln = torch.ones(H, dtype=torch.float32, device=device)
    qkv, head = lp["qkv_fused"], served["lm_head"]
    o, gu, dn = lp["o"]["w"], lp["gateup_fused"]["w"], lp["down"]["w"]
    dq = {id(w): dense_weight(w).T.to(torch.bfloat16).contiguous()
          for w in (qkv["w"], head["w"], o, gu, dn)}
    rows = []
    for M in (4, 32):
        xb = torch.randn((M, H), generator=gen,
                         device=device).to(torch.bfloat16)
        x2 = xb.float()
        for name, e in (("q|k|v", qkv), ("head", head)):
            pw = e["w"]
            kw = ("rmsnorm", 1e-5, True, None, None)
            # x2 (xb's values in f32): f32 outputs on both sides
            _, rel, flips = tie_check(
                f"batch #4 {name} M={M}",
                Fz.norm_qkv_fused(x2, ln, pw, a8=True),
                functools.partial(Fz.norm_qkv_fused_reference, x2, ln, pw,
                                  a8=True), TOL["fused"])
            lin = {"w": pw, "b": None, "serve": e.get("serve")}
            row = {"kernel": "norm_qkv", "w": name, "M": M, "rel_err": rel,
                   "flips": flips, **fused_times(
                       timer, peaks, M, True, [pw],
                       M * H * 2 + H * 4 + M * pw.Np * 4,
                       kernel=lambda: Fz._norm_qkv_cuda(x2, ln, pw, *kw),
                       wrapper=lambda: Fz.norm_qkv_fused(xb, ln, pw, a8=True),
                       plain=lambda: Fz.norm_qkv_fused_reference(xb, ln, pw,
                                                                 a8=True),
                       unfused=lambda: common.linear_apply(
                           lin, common.norm_apply(spec, {"w": ln}, xb)))}
            row["library_ms"] = timer(lambda: torch.matmul(xb, dq[id(pw)]))
            rows.append(row)
            log("batch kernel " + json.dumps(row))
        attn = torch.randn((M, H), generator=gen, device=device)
        xres = torch.randn((M, H), generator=gen,
                           device=device).to(torch.bfloat16)
        _, rel, flips = tie_check(
            f"batch #5 M={M}", Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn,
                                                 a8=True),
            functools.partial(Fz.attn_mlp_fused_reference, attn, xres, ln, o,
                              gu, dn, a8=True), TOL["fused"])
        p = {k: lp[k] for k in ("o", "gateup_fused", "down")}
        p["ln2"] = {"w": ln}
        a3, r3 = attn.reshape(M, 1, H), xres.reshape(M, 1, H)
        ab = attn.to(torch.bfloat16)
        F2 = dq[id(dn)].shape[0]

        def library():
            y = torch.matmul(ab, dq[id(o)])
            g = torch.matmul(y, dq[id(gu)])
            return torch.matmul(g[:, :F2], dq[id(dn)][:F2])

        row = {"kernel": "attn_mlp", "w": "o + gate|up + down", "M": M,
               "rel_err": rel, "flips": flips, **fused_times(
                   timer, peaks, M, True, [o, gu, dn],
                   M * H * 4 + M * H * 2 + H * 4 + M * H * 4,
                   kernel=lambda: Fz._mlp_cuda(
                       attn, xres.float(), ln, o, gu, dn, "silu", "rmsnorm",
                       1e-5, True, True, None, None, None, None),
                   wrapper=lambda: Fz.attn_mlp_fused(attn, xres, ln, o, gu,
                                                     dn, a8=True),
                   plain=lambda: Fz.attn_mlp_fused_reference(
                       attn, xres, ln, o, gu, dn, a8=True),
                   unfused=lambda: common._finish_block(spec, p, r3, a3,
                                                        None, None))}
        # three products over the dequantized bf16 weights (the MLP's
        # activation and the norms left out)
        row["library_ms"] = timer(library)
        rows.append(row)
        log("batch kernel " + json.dumps(row))
    return rows


# ---------------------------------------------------------------------------
# families: OPT, BLOOM and Gemma at their published widths
# ---------------------------------------------------------------------------

# the published config.json values of facebook/opt-6.7b,
# bigscience/bloom-7b1 and google/gemma-7b, and the depth each is served
# at here (BLOOM and Gemma cut to 8 layers; PERF.md section 4)
FAMILY_HF = {
    "opt-6.7b": {"model_type": "opt", "num_hidden_layers": 32,
                 "hidden_size": 4096, "num_attention_heads": 32,
                 "ffn_dim": 16384, "vocab_size": 50272,
                 "max_position_embeddings": 2048, "word_embed_proj_dim": 4096,
                 "do_layer_norm_before": True, "activation_function": "relu",
                 "enable_bias": True, "torch_dtype": "float16"},
    "bloom-7b1": {"model_type": "bloom", "n_layer": 30, "hidden_size": 4096,
                  "n_head": 32, "vocab_size": 250880,
                  "layer_norm_epsilon": 1e-5, "torch_dtype": "float16"},
    "gemma-7b": {"model_type": "gemma", "num_hidden_layers": 28,
                 "hidden_size": 3072, "num_attention_heads": 16,
                 "num_key_value_heads": 16, "head_dim": 256,
                 "intermediate_size": 24576, "vocab_size": 256000,
                 "max_position_embeddings": 8192, "rms_norm_eps": 1e-6,
                 "rope_theta": 10000.0,
                 "hidden_activation": "gelu_pytorch_tanh",
                 "torch_dtype": "bfloat16"},
}
FAMILY_LAYERS = {"opt-6.7b": 32, "bloom-7b1": 8, "gemma-7b": 8}


def family_spec(model, n_layers):
    """The port's spec of a published config (registry.spec_from_hf_config)
    at n_layers."""
    from types import SimpleNamespace

    from gptq_tpu_torch.models.registry import spec_from_hf_config

    cfg = dict(FAMILY_HF[model])
    cfg["n_layer" if cfg["model_type"] == "bloom"
        else "num_hidden_layers"] = n_layers
    return spec_from_hf_config(SimpleNamespace(**cfg))


def synth_family_params(spec, device, seed=0, bits=4):
    """Seeded random params of an OPT / BLOOM / Gemma spec in the serving
    format: every block linear a random 4-bit g-1 packed weight
    (packed_linear, its grids scaled so that the weights' rms is init_params'
    0.4 / sqrt(K): packed_linear's rms of ~0.05 makes q . k scores of
    ~10 sigma, a near one-hot softmax in which a cache row's int8 tie
    moves a decode step's logits by percents; its zero points at the
    uniform codes' mean 7.5, so that each column's weights average zero,
    as trained weights do: packed_linear's zero point of 8 sets every
    weight half a step below zero on average, and after relu's positive
    mean an fc2 output is mostly one component common to the whole row,
    ~8x its varying part, which OPT's residual, with no embedding
    layernorm, carries into every layernorm to be subtracted, so that one
    bf16 ulp of the residual moved the 2-layer logits by percents:
    scripts/family_drift.py reads both) with the family's bf16
    biases, bf16 norms (layernorm
    weights near 1 with biases; Gemma's rmsnorm1p weights near 0), a bf16
    embedding (OPT: and its learned positions; BLOOM: its layernorm) and
    the head tied to it, as all three have it (phase_families packs it to
    8 bits with quantize_lm_head, as the CLI does)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, f, V = spec.hidden, spec.ffn, spec.vocab
    qd, kvd = spec.n_heads * spec.hd, spec.kv_heads * spec.hd

    def vec(n, base=0.0, scale=0.02):
        return (torch.randn(n, generator=gen, device=device) * scale
                + base).to(torch.bfloat16)

    def lin(K, N):
        pw = packed_linear(gen, K, N, bits, -1, device)
        # packed_linear's rms: 0.011 x 4.64 at 4 bits; at other bits 0.011
        # x the uniform codes' rms about their mean (2.29 at 3)
        rms = 0.051 if bits == 4 else 0.011 * math.sqrt((4 ** bits - 1) / 12)
        f = 0.4 / math.sqrt(K) / rms
        return {"w": dataclasses.replace(
                    pw, scale=pw.scale * f,
                    zoff=pw.scale * f * ((1 << bits) - 1) / 2),
                "b": vec(N) if spec.linear_bias else None}

    def norm():
        if spec.norm_type == "layernorm":
            return {"w": vec(h, 1.0, 0.05), "b": vec(h)}
        return {"w": vec(h, 0.0, 0.05)}  # rmsnorm1p scales by 1 + w

    layers = []
    for _ in range(spec.n_layers):
        lp = {"ln1": norm(), "ln2": norm(), "o": lin(qd, h)}
        if spec.arch == "bloom":
            lp["qkv"] = lin(h, 3 * h)
        else:
            lp.update(q=lin(h, qd), k=lin(h, kvd), v=lin(h, kvd))
        if spec.arch == "gemma":
            lp.update(gate=lin(h, f), up=lin(h, f), down=lin(f, h))
        else:
            lp.update(fc1=lin(h, f), fc2=lin(f, h))
        layers.append(lp)
    emb = (torch.randn((V, h), generator=gen, device=device)
           * 0.02).to(torch.bfloat16)
    embed = {"tokens": emb}
    if spec.arch == "opt":
        embed.update(positions=(torch.randn((spec.max_pos + 2, h),
                                            generator=gen, device=device)
                                * 0.02).to(torch.bfloat16),
                     project_in=None, project_out=None)
    elif spec.arch == "bloom":
        embed["ln"] = norm()
    return {"embed": embed, "layers": layers, "final_ln": norm(),
            "lm_head": None}


def family_kernel_rows(model, spec, served, device, peaks, timer,
                       seed=17, tag="w4g-1", prefix="families",
                       parts=("q|k|v", "head", "mlp"), a8s=(True,)) -> list:
    """The family's branches of #4 (ln1 + q|k|v: OPT three biased parts,
    BLOOM one fused biased linear, Gemma rmsnorm1p; final_ln + the 8-bit
    head), #5 (o + ln2 + the MLP: OPT fc1 -> relu -> fc2, BLOOM gelu_tanh,
    both with o / fc1 / fc2 biases; Gemma GLU gelu_tanh at 24,576) and,
    for Gemma, #6 (gate|up + act + down), on the served layer 0 at M = 1
    (the weight streams) and M = 32 (the rows kernels), a8 as served:
    each held to its plain version with the near-tie rule (tie_check;
    #5's residual on its own, residual_check), then timed beside the plain
    version, the unfused route, torch.matmul over the dequantized bf16
    weights (#5: the three products) and the bound. The mixed phase calls
    it on layers of mixed bits: `tag` names the MLP's weights in its rows,
    `prefix` its log lines, `parts` the checks to run ("q|k|v", "head",
    "mlp") and `a8s` the activation modes (a16 too)."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.ops import ffn as Fz

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lp = served["layers"][0]
    h, eps, nt = spec.hidden, float(spec.norm_eps), spec.norm_type
    bloom = spec.arch == "bloom"
    qkv_e = lp["qkv"] if bloom else lp["qkv_fused"]
    b_qkv = qkv_e["b"] if bloom else common._qkv_fused_bias(qkv_e)
    g_e, d_e, glu = common._mlp_entries(spec, lp)
    o, gu, dn = lp["o"]["w"], g_e["w"], d_e["w"]
    mlp_kw = dict(act=spec.act, norm=nt, eps=eps, glu=glu,
                  b_ln=lp["ln2"].get("b"), b_o=lp["o"].get("b"),
                  b_g=None if glu else g_e.get("b"),
                  b_d=None if glu else d_e.get("b"))
    ln2 = lp["ln2"]["w"]
    dq = {}

    def dense(pw):  # the dequantized bf16 (K, N) weight, made once
        if id(pw) not in dq:
            dq[id(pw)] = dense_weight(pw).T.to(torch.bfloat16).contiguous()
        return dq[id(pw)]

    rows = []

    def norm_qkv_row(tag, ln, pw, b, M, a8):
        x = torch.randn((M, h), generator=gen, device=device)
        xb = x.to(torch.bfloat16)
        x2 = xb.float()
        kw = dict(norm=nt, eps=eps, a8=a8, b_ln=ln.get("b"), b_qkv=b)
        route = Fz.norm_qkv_route(M, pw, a8)
        if route != ("stream" if M == 1 else "rows"):
            raise AssertionError(f"{model} norm_qkv {tag} M={M}: route "
                                 f"{route}")
        plain = functools.partial(Fz.norm_qkv_fused_reference, x, ln["w"],
                                  pw, **kw)
        err, rel, flips = tie_check(f"{model} norm_qkv {tag} M={M} a8={a8}",
                                    Fz.norm_qkv_fused(x, ln["w"], pw, **kw),
                                    plain, TOL["fused"])
        unfused_p = (served_as(a8) if tag == "q|k|v" else
                     {"embed": {}, "final_ln": served["final_ln"],
                      "lm_head": served["lm_head"]})

        def unfused():
            if tag == "q|k|v":
                return common._qkv(spec, unfused_p, common.norm_apply(
                    spec, ln, xb.reshape(1, M, h)), None)
            return common.head_forward(spec, unfused_p, xb.reshape(1, M, h))

        row = {"model": model, "kernel": "norm_qkv", "w": tag, "M": M,
               "a8": a8, "bits": pw.bits,
               "route": route, "max_abs_err": err, "rel_err": rel,
               "flips": flips, "N": pw.N, "Np": pw.Np, "K": pw.Kp}
        row.update(fused_times(
            timer, peaks, M, a8, [pw], M * h * 2 + 2 * h * 4 + M * pw.Np * 4,
            kernel=lambda: Fz._norm_qkv_cuda(x2, ln["w"], pw, nt, eps, a8,
                                             ln.get("b"), b),
            wrapper=lambda: Fz.norm_qkv_fused(xb, ln["w"], pw, **kw),
            plain=lambda: Fz.norm_qkv_fused_reference(xb, ln["w"], pw, **kw),
            unfused=unfused))
        w = dense(pw)
        row["library_ms"] = timer(lambda: torch.matmul(xb, w))
        log(f"{prefix} {model} " + json.dumps(row))
        rows.append(row)

    def mlp_rows(M, a8):
        attn = torch.randn((M, o.Kp), generator=gen, device=device)
        xres = torch.randn((M, h), generator=gen,
                           device=device).to(torch.bfloat16)
        route = Fz.mlp_route(M, o, gu, dn, a8)
        if route != ("stream" if M == 1 else "rows"):
            raise AssertionError(f"{model} attn_mlp M={M}: route {route}")
        err, rel, flips = tie_check(
            f"{model} attn_mlp M={M} a8={a8}",
            Fz.attn_mlp_fused(attn, xres, ln2, o, gu, dn, a8=a8, **mlp_kw),
            functools.partial(Fz.attn_mlp_fused_reference, attn, xres, ln2,
                              o, gu, dn, a8=a8, **mlp_kw), TOL["fused"])
        dn0 = dataclasses.replace(dn, scale=torch.zeros_like(dn.scale),
                                  zoff=torch.zeros_like(dn.zoff))
        r2 = residual_check(f"{model} attn_mlp M={M}", attn, xres, ln2, o, gu,
                            dn0, a8, **{k: v for k, v in mlp_kw.items()
                                        if k != "b_d"})
        x2 = xres.float()
        a3, r3 = attn.reshape(1, M, -1), xres.reshape(1, M, h)
        wo, wg, wd = dense(o), dense(gu), dense(dn)
        ab = attn.to(torch.bfloat16)

        def library():  # gate's logical columns lead its stored half
            g = torch.matmul(torch.matmul(ab, wo), wg)
            return torch.matmul(g[:, :wd.shape[0]], wd)

        row = {"model": model, "kernel": "attn_mlp", "w": tag, "M": M,
               "a8": a8, "route": route, "glu": glu, "act": spec.act,
               "max_abs_err": err, "rel_err": rel, "flips": flips,
               "r2_rel_err": r2}
        row.update(fused_times(
            timer, peaks, M, a8, [o, gu, dn],
            M * o.Kp * 4 + M * h * 2 + 2 * h * 4 + M * h * 4,
            kernel=lambda: Fz._mlp_cuda(
                attn, x2, ln2, o, gu, dn, spec.act, nt, eps, glu, a8,
                mlp_kw["b_ln"], mlp_kw["b_o"], mlp_kw["b_g"], mlp_kw["b_d"]),
            wrapper=lambda: Fz.attn_mlp_fused(attn, xres, ln2, o, gu, dn,
                                              a8=a8, **mlp_kw),
            plain=lambda: Fz.attn_mlp_fused_reference(
                attn, xres, ln2, o, gu, dn, a8=a8, **mlp_kw),
            unfused=lambda: common._finish_block(spec, served_as(a8), r3, a3,
                                                 None, None)))
        row["library_ms"] = timer(library)
        log(f"{prefix} {model} " + json.dumps(row))
        rows.append(row)
        if not glu:
            return
        m = torch.randn((M, h), generator=gen, device=device)
        err, rel, flips = tie_check(
            f"{model} ffn M={M} a8={a8}", Fz.ffn_fused(m, gu, dn, act=spec.act,
                                                       a8=a8),
            functools.partial(Fz.ffn_fused_reference, m, gu, dn,
                              act=spec.act, a8=a8), TOL["fused"])
        mb = m.to(torch.bfloat16)
        row = {"model": model, "kernel": "ffn", "w": tag, "M": M, "a8": a8,
               "route": Fz.mlp_route(M, None, gu, dn, a8), "glu": glu,
               "act": spec.act, "max_abs_err": err, "rel_err": rel,
               "flips": flips}

        def unfused_ffn():
            lq = served_as(a8)
            g, u = common._apply_fused(lq["gateup_fused"], m)
            return common.linear_apply(lq["down"],
                                       common.activation(spec, g) * u)

        row.update(fused_times(
            timer, peaks, M, a8, [gu, dn], M * h * 4 * 2,
            kernel=lambda: Fz._mlp_cuda(m, None, None, None, gu, dn, spec.act,
                                        nt, 0.0, True, a8, None, None, None,
                                        None),
            wrapper=lambda: Fz.ffn_fused(m, gu, dn, act=spec.act, a8=a8),
            plain=lambda: Fz.ffn_fused_reference(m, gu, dn, act=spec.act,
                                                 a8=a8),
            unfused=unfused_ffn))
        row["library_ms"] = timer(lambda: torch.matmul(
            torch.matmul(mb, wg)[:, :wd.shape[0]], wd))
        log(f"{prefix} {model} " + json.dumps(row))
        rows.append(row)

    def served_as(a8):
        """Layer 0 with every entry's activation mode a8 (the unfused
        route of the same function)."""
        if a8:
            return lp
        return {k: ({kk: vv for kk, vv in v.items() if kk != "serve"}
                    if isinstance(v, dict) else v) for k, v in lp.items()}

    for a8 in a8s:
        for M in (1, 32):
            if "q|k|v" in parts:
                norm_qkv_row("q|k|v", lp["ln1"], qkv_e["w"], b_qkv, M, a8)
            if "head" in parts:
                norm_qkv_row("head", served["final_ln"],
                             served["lm_head"]["w"], None, M, a8)
            if "mlp" in parts:
                mlp_rows(M, a8)
    dq.clear()
    return rows


def gemma_layer_rows(model, spec, served, device, peaks, timer,
                     seed=19, prefix="families", attention=True) -> list:
    """#12 at Gemma-7B's layer (rmsnorm1p, gelu_tanh, hd 256, H hd = 4,096
    != hidden 3,072) on the served layer 0, a8 and a16, over a bf16 cache
    of 256 slots with 128 filled: held to its plain version with the
    near-tie rule, the written k / v rows bit for bit against the
    kernel's own roped q|k|v row, two launches bit for bit; a8 timed (
    layer_times: the plain version, the fused route over the same layer,
    the bound); and #3 at Gemma's heads (H = Hkv = 16, hd 256) on int8 and
    bf16 caches, one row and 32 (attn_times: the plain version, SDPA). The
    mixed phase calls it on llama layers of mixed bits (`prefix` its log
    lines; attention=False: no #3 rows)."""
    import torch

    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.models.common import ServeFlags
    from gptq_tpu_torch.ops import layer_fused as LF

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lp = served["layers"][0]
    H, nh, Hkv, hd = spec.hidden, spec.n_heads, spec.kv_heads, spec.hd
    qd, kvw = nh * hd, Hkv * hd
    ws = (lp["qkv_fused"]["w"], lp["o"]["w"], lp["gateup_fused"]["w"],
          lp["down"]["w"])
    if not LF.layer_fusable(ws[0], lp["qkv_fused"]["splits"], *ws[1:], H,
                            nh, Hkv, head_dim=hd):
        raise AssertionError(f"{model}: layer_fusable refuses the layer")
    w1, w2 = lp["ln1"]["w"], lp["ln2"]["w"]
    kw = dict(n_heads=nh, n_kv_heads=Hkv, head_dim=hd, layer=1, act=spec.act,
              norm=spec.norm_type, eps=float(spec.norm_eps),
              sm_scale=float(spec.scale))
    rows = []
    S, length = 256, 128
    for a8 in (True, False):
        x = torch.randn((1, 1, H), generator=gen, device=device)
        cache0 = [torch.randn((2, 1, S, Hkv, hd), generator=gen,
                              device=device).to(torch.bfloat16)
                  for _ in range(2)]
        lens = torch.tensor(length, dtype=torch.int32, device=device)
        cos, sin = common.rope_tables(spec, lens.reshape(1, 1))
        args = (cos, sin, w1, w2, *ws)
        what = f"{model} layer a8={a8}"
        kern = [c.clone() for c in cache0]
        got = LF.decode_layer_fused(x, *kern, lens, *args, a8=a8, **kw)
        plain = [c.clone() for c in cache0]
        err, rel, flips = tie_check(what, got, lambda: LF.decode_layer_fused_reference(
            x, *plain, lens, *args, a8=a8, **kw), TOL["fused"])
        own = [c.clone() for c in cache0]
        y2, scratch = LF._layer_cuda(x, *own, lens, *args, nh, Hkv, hd,
                                     spec.act, spec.norm_type,
                                     float(spec.norm_eps), float(spec.scale),
                                     a8, 1)
        torch.cuda.synchronize()
        row_qkv = scratch["qkv"]
        fresh = [LF.rope_rows(row_qkv[qd:qd + kvw].reshape(Hkv, hd),
                              cos.reshape(-1), sin.reshape(-1))
                 .to(torch.bfloat16),
                 row_qkv[qd + kvw:qd + 2 * kvw].reshape(Hkv, hd)
                 .to(torch.bfloat16)]
        for c_k, c_o, f in zip(kern, own, fresh):
            if not (torch.equal(c_k, c_o) and torch.equal(c_k[1, 0, length],
                                                          f)):
                raise AssertionError(f"{what}: the cache write is not the "
                                     f"kernel's roped fresh row")
        if not torch.equal(got, y2):
            raise AssertionError(f"{what}: two launches differ")
        row = {"model": model, "kernel": "layer", "S": S, "filled": length,
               "a8": a8, "cache": "bfloat16", "max_abs_err": err,
               "rel_err": rel, "flips": flips}
        if a8:
            row.update(layer_times(timer, peaks, spec, x, cache0, lens, args,
                                   kw, ServeFlags(a8=True)))
        row["bits"] = [pw.bits for pw in ws]
        log(f"{prefix} {model} " + json.dumps(row))
        rows.append(row)
    if not LF.sync_clean(device):
        raise AssertionError(f"{model}: #12 left barrier or ticket words set")
    for cache in (("int8", "bf16") if attention else ()):
        for B in (1, 32):
            r = attn_times(gen, device, peaks, timer, S, length, cache=cache,
                           Hkv=Hkv, B=B, H=nh, hd=hd)
            r.update(model=model, kernel="attention")
            log(f"families {model} " + json.dumps(r))
            rows.append(r)
    return rows


def family_decode_counts(spec, layer=False) -> dict:
    """A decode step's launches on the served route: ln1 + q|k|v and the
    head (#4), the post-attention half (#5), the attention (#3; alibi takes
    the plain attention, as in the JAX package); on the layer route L #12
    and the head."""
    L = spec.n_layers
    if layer:
        return {"layer": L, "norm_qkv": 1}
    counts = {"norm_qkv": L + 1, "attn_mlp": L}
    if spec.pos != "alibi":
        counts["attention"] = L
    return counts


@contextlib.contextmanager
def launches_in(name, key=lambda *args, **kw: "all"):
    """Counts the kernel launches made inside models/common.<name> apart,
    by key(*args) of each call: yields a dict {key: {kernel: launches}}
    that holds, once the block ends, the launches made there."""
    from gptq_tpu_torch.models import common

    seen, real = {}, getattr(common, name)

    def inner(*args, **kw):
        before = launch_counts()
        try:
            return real(*args, **kw)
        finally:
            mine = seen.setdefault(key(*args, **kw),
                                   dict.fromkeys(before, 0))
            for k, v in launch_counts().items():
                mine[k] += v - before[k]

    with mock.patch.object(common, name, inner):
        yield seen


def bits_key(entries) -> str:
    """"w" and the bits of the packed weights among the linear entries
    (say "w3", or "w3/4" for a layer of two widths); "dense" if none."""
    from gptq_tpu_torch.ops.pack import PackedWeight

    bits = sorted({e["w"].bits for e in entries if isinstance(e, dict)
                   and isinstance(e.get("w"), PackedWeight)})
    return "w" + "/".join(map(str, bits)) if bits else "dense"


# the launches of a served model apart by the bits of the weights they ran
# on: each linear's (linear_apply), each layer's (block_forward)
BY_LINEAR = ("linear_apply", lambda lin, x: bits_key([lin]))
BY_LAYER = ("block_forward", lambda spec, p, *a, **kw: bits_key(p.values()))


def serve_routes(what, spec, params, device, card, peaks, routes,
                 by=None) -> dict:
    """A served model (a8, B = 1, an 8-bit head on #4) on each of `routes`:
    (route, cache dtype, GPTQ_TPU_LAYER_FUSION, launches a step, kernels by
    name a step). 16 eager decode steps with the counters set to 0 just
    before and read just after (exact launches: the main path's; #4's
    inside the head counted apart as norm_qkv_head, one a step; with `by`,
    BY_LINEAR or BY_LAYER, each kernel's launches also apart by the bits of
    the weights they ran on, under launches_by), finite logits, the
    per-token median (engine.decode.benchmark_decode), a profile's device
    ms a step, busy share and kernels by name, and the step's byte bound
    (step_bytes)."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine, benchmark_decode

    out = {}
    rng = np.random.default_rng(73)
    for route, cdt, layer, per_step, by_name in routes:
        with env_var("GPTQ_TPU_LAYER_FUSION", layer):
            eng = DecodeEngine(spec, params, max_len=256, batch=1,
                               cache_dtype=cdt, a8=True)
            logits, cache = eng.prefill(torch.as_tensor(
                rng.integers(0, spec.vocab, size=(1, 16)), device=device))
            tok = logits.argmax(-1)[:, None]
            steps = 16
            torch.cuda.synchronize()
            split = (launches_in(*by) if by is not None
                     else contextlib.nullcontext({}))
            with launches_in("head_forward") as head, split as split_by:
                reset_counts()
                for _ in range(steps):
                    logits, cache = eng.step(cache, tok)
                    tok = logits.argmax(-1)[:, None]
                torch.cuda.synchronize()
                counts = launch_counts()
            expect(counts, {k: v * steps for k, v in per_step.items()},
                   f"{what} {route} decode")
            # #4's launches by caller: the head's apart from q|k|v's
            n_head = head["all"]["norm_qkv"]
            if n_head != steps:
                raise AssertionError(f"{what} {route} decode: the head "
                                     f"launched #4 {n_head} times in "
                                     f"{steps} steps")
            counts["norm_qkv"] -= n_head
            counts["norm_qkv_head"] = n_head
            lg = logits.float()
            if not bool(torch.isfinite(lg).all()) or lg.shape != (
                    1, spec.vocab):
                raise AssertionError(f"{what} {route}: logits of shape "
                                     f"{tuple(lg.shape)}, finite "
                                     f"{bool(torch.isfinite(lg).all())}")
            bench = benchmark_decode(spec, eng.params, rng.integers(
                0, spec.vocab, size=(1, 64)), warmup=8, log=lambda s: None,
                cache_dtype=cdt)
            prof = profile_decode(eng, rng.integers(0, spec.vocab,
                                                    size=(1, 64)))
        med = bench["median_s"] * 1e3
        single_row_check(f"{what} {route} decode profile", prof, by_name,
                         per_step)
        # the profiled steps' least bytes: weights once, the cache filled
        # by the 64-token prompt and 3 warm steps
        nbytes = step_bytes(spec, eng.params, [64 + 3],
                            torch.tensor([], dtype=cdt).element_size(),
                            cdt == torch.int8)
        r = {"route": route, "cache": str(cdt).replace("torch.", ""),
             "layers": spec.n_layers, "median_ms": med,
             "tokens_per_s": bench["tokens_per_s"],
             "p90_ms": bench["p90_s"] * 1e3, "launches": counts,
             "launches_per_step": per_step, "steps": steps,
             "device_ms": prof["device_ms"],
             "device_busy_share": (prof["device_ms"] / med
                                   if prof["device_ms"] > 0 else None),
             "device_ms_by_family": prof["device_ms_by_family"],
             "kernels_per_step": prof["kernels_per_step"],
             "step_bytes": nbytes,
             "step_bound_ms": nbytes / peaks["bw"] * 1e3}
        if by is not None:
            r["launches_by"] = {k: {n: v for n, v in c.items() if v}
                                for k, c in split_by.items()}
        log(f"{what} decode {route} ({spec.n_layers} layers, "
            f"{r['cache']} KV): median {med:.3f} ms/token, device "
            f"{prof['device_ms']:.3f} ms a step (bound "
            f"{r['step_bound_ms']:.3f}), busy share "
            f"{r['device_busy_share']} on {card}; " + json.dumps(r))
        out[route] = r
        del eng
    return out


def logit_drift(ref, got):
    """Each step's max |got - ref| over max |ref| (forced_agree's measure)
    of two teacher-forced logit stacks."""
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1)).tolist()


# a kernel-vs-plain logit reading may lie this far above the floor, the
# plain version's own distance from its f64 twin (forced_greedy)
FLOOR_MARGIN = 1.5


def forced_greedy(what, eng, prompt, n_new, want, tol) -> dict:
    """Greedy tokens of kernel decoding (its launches exactly `want`) held
    to the plain versions' (which launch nothing) by forced_agree: both
    teacher-forced on the kernel's tokens, their logits within the limit
    of max |logit| at every step, and where either side's top token is not
    the kernel's, only at a near tie of both sides' logits. The limit is
    tol, or FLOOR_MARGIN times the floor where that is larger: the floor
    is how far the plain versions' logits move when their matmuls run in
    f64 (f64_matmuls), which no route computed in f32 can be held below
    (on the families' 2-layer OPT-6.7B at a8 it reads above
    TOL["logits_a8"]: scripts/family_drift.py)."""
    import torch

    _drop_graphs(eng)
    reset_counts()
    toks = eng.generate(prompt, n_new)
    torch.cuda.synchronize()
    expect(launch_counts(), want, what)
    t = [toks[0].tolist()]
    kern = engine_forced_logits(eng, [prompt[0]], t)
    with plain_decoding(eng):
        reset_counts()
        plain = engine_forced_logits(eng, [prompt[0]], t)
        plain_toks = eng.generate(prompt, n_new)[0].tolist()
        with f64_matmuls():
            plain64 = engine_forced_logits(eng, [prompt[0]], t)
        expect(launch_counts(), {}, f"{what}: plain decoding")
    floor = max(logit_drift(plain[0], plain64[0]))
    limit = max(tol, FLOOR_MARGIN * floor)
    seen = forced_agree(what, t, plain, kern, limit)
    n_eq = sum(a == b for a, b in zip(t[0], plain_toks))
    log(f"{what}: greedy tokens, kernels {t[0]} vs plain {plain_toks} "
        f"({n_eq} of {n_new} equal); teacher-forced on the kernel tokens, "
        f"{len(seen['parted'])} of {seen['positions']} positions part at a "
        f"near tie, logits within {seen['max_rel']:.4g} of max |logit| "
        f"(limit {limit:.4g}: the larger of {tol} and {FLOOR_MARGIN} x the "
        f"floor {floor:.4g}, the plain versions in f32 against f64)")
    return {"tokens": t[0], "plain_tokens": plain_toks, "equal": n_eq,
            "parted": len(seen["parted"]), "max_rel": seen["max_rel"],
            "floor": floor, "limit": limit,
            "worst_gap_share": seen["worst_gap_share"]}


def greedy_routes(what, spec, params, routes, prefill, chained=()) -> dict:
    """A cut of a served model (params' layers as given; a8, bf16
    activations, the 8-bit head): kernel decoding against plain decoding
    on each route of `routes` ((route, cache dtype, GPTQ_TPU_LAYER_FUSION,
    launches a step)) by forced_greedy (TOL["logits_a8"], or FLOOR_MARGIN
    x the floor read in the run where that is larger): a 64-token prompt,
    whose launches are `prefill` (the unfused route: each packed linear on
    the tensor cores), then 16 steps, launches exact. On the routes named
    in `chained`, generate_chained's tokens (CUDA graphs; learned
    positions and alibi read the device length) equal generate's."""
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine

    small = dataclasses.replace(spec, n_layers=len(params["layers"]))
    prompt = np.random.default_rng(29).integers(0, spec.vocab, size=(1, 64))
    n_new, out = 16, {}
    for route, cdt, layer, per_step in routes:
        want = {k: v * n_new for k, v in per_step.items()}
        for k, v in prefill.items():
            want[k] = want.get(k, 0) + v
        with env_var("GPTQ_TPU_LAYER_FUSION", layer):
            eng = DecodeEngine(small, params, max_len=128, batch=1,
                               cache_dtype=cdt, a8=True)
            out[route] = forced_greedy(
                f"{what} {small.n_layers}-layer decoding ({route}, "
                f"{str(cdt).replace('torch.', '')} KV)", eng, prompt, n_new,
                want, TOL["logits_a8"])
            if route in chained:
                toks = eng.generate_chained(prompt, n_new, chunk=8)[0]
                if toks.tolist() != out[route]["tokens"]:
                    raise AssertionError(
                        f"{what} {route}: generate_chained parts from "
                        f"generate: {toks.tolist()} vs "
                        f"{out[route]['tokens']}")
        out[route]["launches"] = want  # forced_greedy held them exactly
        del eng
    torch.cuda.empty_cache()
    return out


def write_hf_opt(path, n_layers, device, seed=0) -> int:
    """An HF OPT checkpoint directory at OPT-6.7B width (its published
    config.json at n_layers): one F16 model.safetensors of seeded random
    weights and biases (write_hf_dir), learned positions of 2,050 rows and
    no lm_head.weight (OPT ties its head to the embedding). Returns the
    bytes written."""
    cfg = dict(FAMILY_HF["opt-6.7b"], num_hidden_layers=n_layers,
               architectures=["OPTForCausalLM"])
    H, F, V = cfg["hidden_size"], cfg["ffn_dim"], cfg["vocab_size"]
    pre = "model.decoder."
    shapes = {pre + "embed_tokens.weight": (V, H),
              pre + "embed_positions.weight": (
                  cfg["max_position_embeddings"] + 2, H)}

    def linear(name, n_out, n_in):
        shapes[name + ".weight"] = (n_out, n_in)
        shapes[name + ".bias"] = (n_out,)

    for i in range(n_layers):
        lp = f"{pre}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{lp}self_attn.{name}", H, H)
        linear(lp + "fc1", F, H)
        linear(lp + "fc2", H, F)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[f"{lp}{ln}.weight"] = shapes[f"{lp}{ln}.bias"] = (H,)
    shapes[pre + "final_layer_norm.weight"] = (H,)
    shapes[pre + "final_layer_norm.bias"] = (H,)
    return write_hf_dir(path, cfg, shapes, device, seed)


def family_cli(device, tmp) -> dict:
    """One OPT path through gptq_tpu_torch.cli: the 2-layer
    OPT-6.7B-width F16 directory (cli_dir), the tokenizer and `datasets`
    stood in as in the cli phase (offline_data): w4 g128 act-order
    true-sequential, --new-eval, --save (its PPL evals: 2,048-row windows,
    each layer's six linears on the tensor cores, the tied head dense), the
    saved file's wikitext2 PPL against its dense twin; then the saved file
    served through the CLI (--faster-kernel --int8_kv --quant_lm_head 8:
    act-order weights keep the unfused route, four #1 a layer a step; the
    head, untied and packed to 8 bits, on #4)."""
    from gptq_tpu_torch.models.convert import hf_config
    from gptq_tpu_torch.models.registry import spec_from_hf_config

    L = 2
    hf, nbytes, write_s = cli_dir(tmp, "opt-6.7b", device)
    spec = spec_from_hf_config(hf_config(hf))
    log(f"families cli: wrote a {L}-layer OPT-6.7B-width HF directory (F16 "
        f"safetensors, {nbytes / 2**30:.2f} GiB) in {write_s:.1f} s; "
        f"tokenizer and datasets stood in")
    path = os.path.join(tmp, "opt_w4.npz")
    with offline_data(spec.vocab) as tok:
        out = cli_quantize(
            "opt w4", [hf, "c4", "--wbits", "4", "--groupsize", "128",
                       "--act-order", "--true-sequential", "--nsamples", "8",
                       "--new-eval", "--save", path, "--results_log",
                       os.path.join(tmp, "opt_ppl.txt")],
            lambda w: {"qmm_mma": w * 6 * L})
        ppl = out["ppl"]["wikitext2"]
        ref = dense_ppl(spec, path, tok, device)
    rel = abs(ppl / ref - 1.0)
    log(f"families cli opt w4: wikitext2 PPL packed {ppl:.4f} vs "
        f"dense-dequantized {ref:.4f}: rel diff {rel:.2e}")
    if not rel < 0.005:
        raise AssertionError(f"families cli: packed vs dense PPL differ by "
                             f"{rel:.3g}")
    out["ppl_dense"] = ref
    n_tok, steps = 32, 100 + 32
    bench, counts, printed = serve_cli(
        path, n_tok, ["--faster-kernel", "--int8_kv", "--quant_lm_head", "8"],
        "auto")
    assert "lm_head quantized to 8 bits" in printed
    expect(counts, {"qmm": 4 * L * steps, "norm_qkv": steps,
                    "attention": L * steps}, "families cli serve")
    out["serve"] = {"median_ms": bench["median_s"] * 1e3,
                    "tokens_per_s": bench["tokens_per_s"], "launches": counts}
    os.remove(path)
    return out


# the families' kernel branches in the kernels line: (row kernel, the
# entry's name, its source, the TPU kernel it replaces, its device code)
FAMILY_KERNELS = {
    "norm_qkv": ("norm_qkv", FFN_SRC, "gptq_tpu/ops/ffn.py:483", GEMV_SRC),
    "attn_mlp": ("attn_mlp", FFN_SRC, "gptq_tpu/ops/ffn.py:383",
                 STREAM_DEV_SRC),
    "ffn": ("ffn", FFN_SRC, "gptq_tpu/ops/ffn.py:312", STREAM_DEV_SRC),
    "layer": ("layer_fused", LAYER_SRC, "gptq_tpu/ops/layer_fused.py:97",
              STREAM_DEV_SRC),
    "attention": ("decode_attention", PARTIAL_SRC,
                  "gptq_tpu/ops/attention.py:253", PARTIAL_SRC),
}
BRANCH = {"opt-6.7b": "layernorm + biases, relu, no GLU",
          "bloom-7b1": "layernorm + biases, gelu_tanh, no GLU, fused q|k|v",
          "gemma-7b": "rmsnorm1p, gelu_tanh GLU, hd 256"}


CACHE_OF = {"int8": "int8", "bf16": "bfloat16"}


def family_entries(fam) -> list:
    """The kernels line's entries of the families phase: one per family and
    branch, its M = 1 (#3: B = 1) readings, the M = 32 (B = 32) ones under
    m32, launches from the family's served decode steps (the wrappers'
    counters over those eager steps; #4's head counted apart from its
    q|k|v, #3's on the route that serves the entry's cache)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "unfused_ms", "wrapper_ms", "fused_route_ms", "rel_err")
    out = []
    groups = {}
    for r in fam["rows"]:
        tag = r.get("w") or r.get("cache")
        groups.setdefault((r["model"], r["kernel"], tag), []).append(r)
    for (model, kernel, tag), rs in groups.items():
        name, src, replaces, dev = FAMILY_KERNELS[kernel]
        one = next(r for r in rs if r.get("M", r.get("B", 1)) == 1
                   and "ms" in r and r.get("a8", True))
        many = [r for r in rs if r.get("M", r.get("B")) == 32]
        serve = fam["serve"][model]
        if kernel == "layer":
            launches = serve.get("layer", {}).get("launches", {}).get(
                "layer", 0)
        elif kernel == "attention":  # the route that serves this cache
            launches = sum(r["launches"].get("attention", 0)
                           for r in serve.values()
                           if r["cache"] == CACHE_OF[tag])
        else:
            launches = serve["fused"]["launches"][
                "norm_qkv_head" if tag == "head" else kernel]
        entry = {"name": f"{name} [{model} {tag}: {BRANCH[model]}]",
                 "route": "cuda", "source": src, "replaces": replaces,
                 "device_code": dev, "launches": launches,
                 "max_abs_err": max(r["max_abs_err"] for r in rs),
                 **{k: one.get(k) for k in keys}}
        if entry["library_ms"] is None and kernel != "layer":
            raise AssertionError(f"{entry['name']}: no library time")
        entry["kernel_route"] = one.get("route")  # ops/ffn's, at M = 1
        if many:
            entry["m32"] = {k: many[0].get(k) for k in keys}
            entry["m32"]["kernel_route"] = many[0].get("route")
        entry["shape"] = {k: one[k] for k in ("K", "N", "Np", "S", "filled",
                                              "cache", "Hkv", "hd", "a8")
                          if k in one}
        out.append(entry)
    return out


def phase_families(device, tmp, card, peaks, report):
    """OPT-6.7B (32 layers), BLOOM-7b1 and Gemma-7B (8 layers each) at
    their published widths, weights from a seed: each family's kernel
    branches held and timed (family_kernel_rows, gemma_layer_rows), its
    2-layer greedy tokens against the plain versions (greedy_routes), its
    served model's launches, per-token latency and profile (serve_routes);
    then one OPT path through the CLI (family_cli)."""
    import torch

    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.pipeline import quantize_lm_head

    fam = {"rows": [], "serve": {}, "greedy": {}}
    for model, L in FAMILY_LAYERS.items():
        t0 = time.perf_counter()
        spec = family_spec(model, L)
        params = synth_family_params(spec, device, seed=len(model))
        assert quantize_lm_head(spec, params, bits=8)
        served = fuse_serving(spec, params, a8=True)
        cfg = FAMILY_HF[model]
        log(f"families {model}: {L} of "
            f"{cfg.get('num_hidden_layers', cfg.get('n_layer'))} layers, "
            f"spec {json.dumps(dataclasses.asdict(spec))}; built in "
            f"{time.perf_counter() - t0:.1f} s")
        timer = device_ms
        fam["rows"] += family_kernel_rows(model, spec, served, device, peaks,
                                          timer)
        if spec.arch == "gemma":
            fam["rows"] += gemma_layer_rows(model, spec, served, device,
                                            peaks, timer)
        # 2 layers; q|k|v (BLOOM's own, fuse_serving's), o, fc1 /
        # gate|up, fc2 / down and the head in the prefill
        small = dataclasses.replace(spec, n_layers=2)
        routes = [("fused", torch.int8, "off", family_decode_counts(small))]
        if spec.arch == "gemma":
            routes.append(("layer", torch.bfloat16, "on",
                           family_decode_counts(small, True)))
        fam["greedy"][model] = greedy_routes(
            model, spec, {**params, "layers": params["layers"][:2]}, routes,
            {"qmm_mma": 4 * 2 + 1}, chained=("fused",))
        routes = [("fused", torch.int8, "off", family_decode_counts(spec),
                   {"norm_qkv_gemv_kernel": L + 1, "mlp_stream_kernel": L})]
        if spec.arch == "gemma":
            routes.append(("layer", torch.bfloat16, "on",
                           family_decode_counts(spec, True),
                           {"norm_qkv_gemv_kernel": 1}))
        fam["serve"][model] = serve_routes(f"families {model}", spec, params,
                                           device, card, peaks, routes)
        del params, served
        torch.cuda.empty_cache()
        log(f"families {model}: {time.perf_counter() - t0:.1f} s")
    fam["cli"] = family_cli(device, tmp)
    report["families"] = fam


def phase_batch(device, card, peaks, report):
    """Continuous batching at llama-7B width: the serve phase's 32-layer
    checkpoint (w4a8 g-1, 8-bit head, fuse_serving(a8=True)) through
    engine.batching.ContinuousBatcher with 32 slots, max_len 256."""
    import torch

    from gptq_tpu_torch.engine.batching import ContinuousBatcher
    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.pipeline import quantize_lm_head

    from torch.profiler import ProfilerActivity, profile

    spec = llama7b_spec(32)
    L, B, S, W = spec.n_layers, 32, 256, 16
    t_phase = time.perf_counter()
    # the profiler's first use in a process takes seconds (CUPTI); pay it
    # here, outside the timed runs that profile one window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = synth_packed_params(spec, device, seed=0)
    assert quantize_lm_head(spec, params, bits=8)
    served = fuse_serving(spec, params, a8=True)
    log(f"batch: the serve phase's 32-layer checkpoint (w4a8 g-1, 8-bit "
        f"head) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(14)
    uniform = [(rng.integers(0, spec.vocab, size=128), 64)
               for _ in range(64)]
    churn = [(rng.integers(0, spec.vocab, size=int(n)), int(m))
             for n, m in zip(rng.integers(16, 129, size=96),
                             rng.integers(8, 65, size=96))]
    out = {}

    def batcher(cache, buckets):
        return ContinuousBatcher(spec, served, batch_slots=B, max_len=S,
                                 cache_dtype=cache, prefill_buckets=buckets,
                                 prefill_group=16)

    # the launch counters: one prefill dispatch of 16 prompts of 128
    # tokens (2,048 rows: every linear on the tensor cores, no head), then
    # one eager lock-step at 32 slots (33 #4, 32 #5, 32 #3, no #12)
    cb = batcher(torch.int8, (128,))
    for prompt, n in uniform[:16]:
        cb.submit(prompt, max_new_tokens=n)
    reset_counts()
    cb._fill_slots()
    torch.cuda.synchronize()
    expect(launch_counts(), {"qmm_mma": 4 * L}, "batch prefill dispatch")
    reset_counts()
    t0 = time.perf_counter()
    cb.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts = launch_counts()
    expect(step_counts, {"norm_qkv": L + 1, "attn_mlp": L, "attention": L},
           "batch lock-step")
    rows_launches = {"norm_qkv_rows_kernel": Fz.norm_qkv_rows_launches,
                     "mlp_rows_kernel": Fz.mlp_rows_launches}
    if rows_launches != {"norm_qkv_rows_kernel": L + 1,
                         "mlp_rows_kernel": L}:
        raise AssertionError(f"batch lock-step: rows kernels' launches "
                             f"{rows_launches}")
    log(f"batch: launches of one prefill dispatch {{'qmm_mma': {4 * L}}}, "
        f"of one lock-step at {B} slots " + json.dumps(
            {k: v for k, v in step_counts.items() if v}))
    del cb
    # every cell serves its whole traffic: uniform 64 requests on each
    # cache (a second wave in refilled slots), churn all 96 (64 refills)
    log(f"batch: one eager lock-step took {step_s * 1e3:.1f} ms; launches "
        f"of the rows kernels " + json.dumps(rows_launches) + "; no "
        f"warm-up run (the window graph is captured inside the timed run, "
        f"its capture in the wall time)")
    # the window's kernels by name a step: #4 at 32 rows for the layers
    # and the head, #5 and #3 a layer, on the rows kernels; no tiled
    # kernel, no #12, no single-row kernel
    want = {"norm_qkv_rows_kernel": L + 1, "mlp_rows_kernel": L,
            "attnd_tile": L}

    cells = (("uniform bf16", torch.bfloat16, uniform, (128,)),
             ("uniform int8", torch.int8, uniform, (128,)),
             ("churn int8", torch.int8, churn, (32, 64, 128)))
    for name, cache, reqs, buckets in cells:
        r = batcher_run(batcher(cache, buckets), reqs, W, profile_window=2)
        prof = r["profile"]
        single_row_check(f"batch {name} window profile", prof, want)
        item = 1 if cache == torch.int8 else 2
        nb = np.mean([step_bytes(spec, served, [x + i for x in prof["lens"]],
                                 item, cache == torch.int8)
                      for i in range(W)])
        cell = {"tokens_per_s": r["tokens_per_s"], "wall_s": r["wall_s"],
                "requests": len(reqs), "new_tokens": r["new_tokens"],
                "prefill_calls": r["prefill_calls"],
                "decode_steps": r["steps"], "windows": r["windows"],
                "step_device_ms": prof["device_ms"],
                "step_wall_ms": r["window_s"] / r["timed_steps"] * 1e3,
                "busy_share_windows": (prof["device_ms"] * r["timed_steps"]
                                       / (r["window_s"] * 1e3)),
                "busy_share_run": (prof["device_ms"] * r["steps"]
                                   / (r["wall_s"] * 1e3)),
                "step_bound_ms": nb / peaks["bw"] * 1e3, "step_bytes": nb,
                "profile": prof, "tokens": r["tokens"]}
        out[name] = cell
        log(f"batch {name}: {cell['tokens_per_s']:.2f} tok/s with prefill "
            f"({r['new_tokens']} tokens of {len(reqs)} requests in "
            f"{r['wall_s']:.3f} s), {r['prefill_calls']} prefill dispatches, "
            f"{r['steps']} lock-steps, {cell['step_wall_ms']:.3f} ms a step "
            f"in the windows, {prof['device_ms']:.3f} device ms a step "
            f"(graph replay; bound {cell['step_bound_ms']:.3f} ms, "
            f"{nb / 2**30:.3f} GiB), busy {cell['busy_share_windows']:.3f} "
            f"of the windows, {cell['busy_share_run']:.3f} of the run, on "
            f"{card}; by family " + json.dumps(prof["device_ms_by_family"])
            + "; kernels a step " + json.dumps(
                {k: v for k, v in prof["kernels_per_step"].items() if v})
            + f" [{time.perf_counter() - t_phase:.1f} s]")
        if cell["busy_share_windows"] > 1.05:
            raise AssertionError(f"batch {name}: profile of a step "
                                 f"{prof['device_ms']} ms")

    # four requests of each cell alone through DecodeEngine.generate (one
    # row, the single-row kernels) against the batcher's tokens on the
    # same cache, every position teacher-forced on the batcher's tokens
    # (forced_agree): the first four of the one-wave cell, and in the
    # others the first four that ran in refilled slots (requests 32-35).
    # The batcher's side replays them on 4 slots: the rows kernels compute
    # each row alone, bit for bit at any M (rows_checks), so its logits
    # stand for the 32-slot run's; where its top differs from the emitted
    # token
    # (forced_agree counts those positions) the same near-tie rule holds
    engines = {}
    for name, cache, reqs, buckets in cells:
        idx = range(4) if len(reqs) <= B else range(B, B + 4)
        prompts4 = [reqs[i][0] for i in idx]
        got = [out[name]["tokens"][i] for i in idx]
        if cache not in engines:
            engines[cache] = DecodeEngine(spec, params, max_len=S, batch=1,
                                          cache_dtype=cache, a8=True)
        eng = engines[cache]
        alone = [eng.generate(reqs[i][0][None], reqs[i][1])[0].tolist()
                 for i in idx]
        first = [next((j for j, (a, b) in enumerate(zip(w, g)) if a != b),
                      None) for w, g in zip(alone, got)]
        ref = engine_forced_logits(eng, prompts4, got)
        cb4 = ContinuousBatcher(spec, served, batch_slots=4, max_len=S,
                                cache_dtype=cache, prefill_buckets=buckets,
                                prefill_group=4)
        seen = forced_agree(f"batch {name} vs DecodeEngine", got, ref,
                            batcher_forced_logits(cb4, prompts4, got),
                            TOL["logits_a8"])
        del cb4, ref
        log(f"batch {name}: requests {list(idx)} alone through "
            f"DecodeEngine.generate part from the batcher's tokens at steps "
            f"{first} (None: equal); teacher-forced on the batcher's tokens, "
            f"{len(seen['parted'])} of {seen['positions']} positions part at "
            f"a near tie (largest gap {seen['worst_gap_share']:.3g} of twice "
            f"the spread), the 4-slot replay's top differs from the emitted "
            f"token at {seen['emitter_parted']}, logits within "
            f"{seen['max_rel']:.4g} of max |logit| (limit "
            f"{TOL['logits_a8']}) [{time.perf_counter() - t_phase:.1f} s]")
        out[name]["alone"] = {"requests": list(idx), "first_parting": first,
                              **seen}
    del engines, eng

    # 2 layers: window 16 against window 1 on all 96 churn requests at 32
    # slots (64 refills, most mid-window); the batcher's kernel tokens
    # against its plain versions', both teacher-forced on the kernel
    # tokens (forced_agree)
    small = llama7b_spec(2)
    p2 = {**params, "layers": params["layers"][:2]}
    s2 = fuse_serving(small, p2, a8=True)
    w16, w1 = (batcher_run(ContinuousBatcher(
        small, s2, batch_slots=B, max_len=S, cache_dtype=torch.int8,
        prefill_buckets=(32, 64, 128), prefill_group=16), churn, w)["tokens"]
               for w in (W, 1))
    if w16 != w1:
        bad = [i for i, (a, b) in enumerate(zip(w16, w1)) if a != b]
        raise AssertionError(f"batch: 2 layers, window 16 and window 1 "
                             f"tokens differ for requests {bad}")
    log(f"batch: 2 layers, churn int8, window 16 tokens equal window 1's for "
        f"all {len(churn)} requests ({len(churn) - B} refills) "
        f"[{time.perf_counter() - t_phase:.1f} s]")
    reqs2 = [(rng.integers(0, small.vocab, size=int(n)), 16)
             for n in rng.integers(16, 65, size=12)]
    prompts2 = [p for p, _ in reqs2]

    def batcher2():
        return ContinuousBatcher(small, s2, batch_slots=8, max_len=128,
                                 cache_dtype=torch.int8,
                                 prefill_buckets=(32, 64), prefill_group=8)

    reset_counts()
    got_kernel = batcher_run(batcher2(), reqs2, 4)["tokens"]
    counts = launch_counts()
    if not (counts["attention"] and counts["norm_qkv"]
            and counts["attn_mlp"]):
        raise AssertionError(f"2-layer batcher: launches {counts}")
    kern = batcher_forced_logits(batcher2(), prompts2, got_kernel)
    with plain_versions():
        reset_counts()
        got_plain = batcher_run(batcher2(), reqs2, 1)["tokens"]
        plain = batcher_forced_logits(batcher2(), prompts2, got_kernel)
        expect(launch_counts(), {}, "2-layer batcher on the plain versions")
    seen = forced_agree("2-layer batcher, kernels vs plain", got_kernel,
                        plain, kern, TOL["logits_a8"])
    n_eq = sum(a == b for a, b in zip(got_kernel, got_plain))
    log(f"batch: 2-layer kernel tokens equal the plain versions' for {n_eq} "
        f"of 12 requests; teacher-forced on the kernel tokens, "
        f"{len(seen['parted'])} of {seen['positions']} positions part at a "
        f"near tie, logits within {seen['max_rel']:.4g} of max |logit| "
        f"[{time.perf_counter() - t_phase:.1f} s]")
    out["plain"] = {"equal_requests": n_eq, **seen}
    del kern, plain

    # the kernels at the batcher's shapes
    rows = batch_kernel_times(device, spec, served, peaks, device_ms)
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    lens = rng.integers(128, 193, size=B).tolist()
    attn = [attn_times(gen, device, peaks, device_ms, S, lens, cache=c, B=B)
            for c in ("int8", "bf16")]
    for a in attn:
        log("batch attention " + json.dumps(a))
    for cell in out.values():
        if isinstance(cell, dict):
            cell.pop("tokens", None)
    report["batch"] = {"cells": out, "step_launches": step_counts,
                       "rows_launches": rows_launches,
                       "kernel_rows": rows, "attn_rows": attn}
    del params, p2, s2, served
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# mixed: mixed precision (bits per linear, per layer, per module) on the
# kernels, the serving routes and the CLI
# ---------------------------------------------------------------------------

# the per-layer bits of the in-process serve: 4 layers at 3 bits, then 4 at 4
MIXED_LAYER_BITS = (3, 3, 3, 3, 4, 4, 4, 4)
# the kernel checks' layer: q|k|v 3 bits (#4), o 3 / gate|up 4 / down 3
# (configs/linearwise.json's MLP: #5 / #6)
MIXED_KERNEL_BITS = {"q": 3, "k": 3, "v": 3, "o": 3, "gate": 4, "up": 4,
                     "down": 3}
# #12's two layers: q|k|v 4 beside linearwise's o / gate|up / down, and
# all four at 3 bits
MIXED_LAYERS = {"w4/3/4/3": {"q": 4, "k": 4, "v": 4, "o": 3, "gate": 4,
                             "up": 4, "down": 3},
                "w3": dict.fromkeys(MIXED_KERNEL_BITS, 3)}


def linearwise_bits():
    """bits_of(i, key) of configs/linearwise.json for the llama linears,
    through the port's MixedPrecision and the CLI's table lookup."""
    from gptq_tpu_torch.cli import _cfg_path
    from gptq_tpu_torch.config import MixedPrecision
    from gptq_tpu_torch.models.registry import get_arch

    with open(_cfg_path("linearwise.json")) as f:
        mp = MixedPrecision(linear_bits=json.load(f))
    name_of = {key: name for name, key in get_arch("llama").linears.items()}
    return lambda i, key: mp.bits_for(i, name_of[key], 4)


def mixed_qmm_rows(v, device, peaks, timer) -> list:
    """#1 at one row on a 3-bit 4096x4096 weight (linearwise's v), a8 and
    bf16 a16: held to the plain version as qmm_checks holds #1, timed
    beside it, torch.matmul over the dequantized bf16 weight and the
    bound."""
    import torch

    from gptq_tpu_torch.ops import qmatmul as Q

    gen = torch.Generator(device=device)
    gen.manual_seed(71)
    rows = []
    for a8, xdt in ((True, torch.float32), (False, torch.bfloat16)):
        x = torch.randn((1, v.K), generator=gen, device=device).to(xdt)
        route = Q.qmm_route(1, v.bits, v.groupsize, xdt, a8=a8, Np=v.Np)
        if route != "single_row":
            raise AssertionError(f"mixed qmm w3 a8={a8}: route {route}")
        got = Q.dequant_matmul(x, v, a8=a8).float()
        want = Q.dequant_matmul_reference(x, v, a8=a8).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        tol = TOL["qmm_a8" if a8 else "qmm_a16"]
        ulp = 2.0**-7 * want.abs() if xdt == torch.bfloat16 else 0.0
        if not bool((diff <= tol * want.abs().max() + ulp).all()):
            raise AssertionError(f"mixed qmm w3 a8={a8}: rel err "
                                 f"{float(diff.max() / want.abs().max()):.3g}")
        row = {"kernel": "qmm", "w": "v w3g-1", "K": v.K, "N": v.N, "M": 1,
               "a8": a8, "x": str(xdt).replace("torch.", ""), "route": route,
               "max_abs_err": float(diff.max()),
               "rel_err": float(diff.max() / want.abs().max())}
        row.update(matmul_times(
            v, x, a8, peaks, timer, kernel=Q._qmm_cuda, prepare=Q._prepare,
            wrapper=Q.dequant_matmul, plain=Q.dequant_matmul_reference,
            dense=Q.dequant))
        log("mixed " + json.dumps(row))
        rows.append(row)
    return rows


def mixed_kernel_rows(device, peaks, timer) -> list:
    """The kernels at mixed bits, llama-7B width (ffn 11,264 stored): #4
    on a 3-bit q|k|v and #5 / #6 on o 3 / gate|up 4 / down 3 at M = 1 (the
    streams) and M = 32 (the rows kernels), a8 and a16
    (family_kernel_rows); #4 on OPT-6.7B's layernorm + biased q|k|v at 3
    bits; #12 on q|k|v 4 / o 3 / gate|up 4 / down 3 and on all four at 3
    bits (gemma_layer_rows: the plain version, the written cache rows, two
    launches, the fused route, the bound); #1 on the 3-bit v. Each held
    to its plain version with the near-tie rule."""
    from gptq_tpu_torch.models.common import fuse_serving

    spec = llama7b_spec(1)
    params = synth_packed_params(spec, device, seed=41,
                                 bits_of=lambda i, k: MIXED_KERNEL_BITS[k])
    served = fuse_serving(spec, params, a8=True)
    rows = mixed_qmm_rows(params["layers"][0]["v"]["w"], device, peaks,
                          timer)
    rows += family_kernel_rows("llama-7b", spec, served, device, peaks,
                               timer, seed=43, tag="o3 gate|up4 down3",
                               prefix="mixed", parts=("q|k|v", "mlp"),
                               a8s=(True, False))
    del params, served
    for tag, bits in MIXED_LAYERS.items():
        p = synth_packed_params(spec, device, seed=47,
                                bits_of=lambda i, k, b=bits: b[k])
        rows += gemma_layer_rows(f"llama-7b {tag}", spec,
                                 fuse_serving(spec, p, a8=True), device,
                                 peaks, timer, prefix="mixed",
                                 attention=False)
    ospec = family_spec("opt-6.7b", 1)
    op = synth_family_params(ospec, device, seed=53, bits=3)
    rows += family_kernel_rows("opt-6.7b", ospec,
                               fuse_serving(ospec, op, a8=True), device,
                               peaks, timer, seed=59, prefix="mixed",
                               parts=("q|k|v",), a8s=(True, False))
    return rows


def mixed_serves(device, card, peaks) -> dict:
    """The served models of mixed bits, in process, weights from a seed,
    an 8-bit head, a8, B = 1:
      * linearmix: 32 llama-7B layers at configs/linearwise.json's bits
        (q / k 4, v 3: q|k|v stays three #1; o 3, gate|up 4, down 3: one
        #5), int8 KV: a step 96 #1, 32 #5, 32 #3 and the head's #4;
      * per-layer: 8 layers, 4 at 3 bits then 4 at 4, int8 KV on the fused
        route (9 #4, 8 #5, 8 #3 a step) and bf16 KV on the layer route (8
        #12 and the head's #4);
      * per-module: 2 layers, one q|k|v 4 / o 3 / gate|up 4 / down 3 and
        one whose o is dense (as a columnwise o stays), gate|up 4 / down
        3: fused (3 #4, 1 #5, 1 #6, 2 #3 a step) and on the layer route
        (1 #12; the dense-o layer on #4 and #6, its attention in torch on
        the write-first path).
    Each (but per-module) through serve_routes, its launches also apart
    by the bits of the weights they ran on (linearmix by linear, per-layer
    by layer); each, cut to 2 layers, through greedy_routes."""
    import torch

    from gptq_tpu_torch.pipeline import quantize_lm_head

    out = {}
    spec = llama7b_spec(32)
    t0 = time.perf_counter()
    params = synth_packed_params(spec, device, seed=83,
                                 bits_of=linearwise_bits())
    assert quantize_lm_head(spec, params, bits=8)
    fused_lm = {"qmm": 96, "attn_mlp": 32, "attention": 32, "norm_qkv": 1}
    out["linearmix"] = serve_routes(
        "mixed linearmix", spec, params, device, card, peaks,
        [("fused", torch.int8, "off", fused_lm,
          {"qgemv_kernel": 96, "mlp_stream_kernel": 32,
           "norm_qkv_gemv_kernel": 1})], by=BY_LINEAR)
    # q / k / v, o, gate|up, down a layer and the head on the tensor cores
    out["linearmix"]["greedy"] = greedy_routes(
        "mixed linearmix", spec, {**params, "layers": params["layers"][:2]},
        [("fused", torch.int8, "off", {"qmm": 6, "attn_mlp": 2,
                                       "attention": 2, "norm_qkv": 1})],
        {"qmm_mma": 6 * 2 + 1})
    log(f"mixed linearmix: {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec = llama7b_spec(len(MIXED_LAYER_BITS))
    params = synth_packed_params(spec, device, seed=89,
                                 bits_of=lambda i, k: MIXED_LAYER_BITS[i])
    assert quantize_lm_head(spec, params, bits=8)
    L = spec.n_layers
    out["layerwise"] = serve_routes(
        "mixed per-layer bits", spec, params, device, card, peaks,
        [("fused", torch.int8, "off",
          {"norm_qkv": L + 1, "attn_mlp": L, "attention": L},
          {"norm_qkv_gemv_kernel": L + 1, "mlp_stream_kernel": L}),
         ("layer", torch.bfloat16, "on", {"layer": L, "norm_qkv": 1},
          {"norm_qkv_gemv_kernel": 1})], by=BY_LAYER)
    # layers 3 and 4: one at 3 bits, one at 4
    out["layerwise"]["greedy"] = greedy_routes(
        "mixed per-layer bits", spec,
        {**params, "layers": params["layers"][3:5]},
        [("fused", torch.int8, "off",
          {"norm_qkv": 3, "attn_mlp": 2, "attention": 2}),
         ("layer", torch.bfloat16, "on", {"layer": 2, "norm_qkv": 1})],
        {"qmm_mma": 4 * 2 + 1})
    log(f"mixed per-layer bits: {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    spec = llama7b_spec(2)
    layers = [MIXED_LAYERS["w4/3/4/3"],
              {"q": 4, "k": 4, "v": 4, "o": 4, "gate": 4, "up": 4,
               "down": 3}]
    params = synth_packed_params(spec, device, seed=97,
                                 bits_of=lambda i, k: layers[i][k])
    o = params["layers"][1]["o"]
    params["layers"][1]["o"] = {"w": dense_weight(o["w"]).to(torch.bfloat16),
                                "b": None}
    assert quantize_lm_head(spec, params, bits=8)
    # prefill: layer 0 q|k|v, o, gate|up, down; layer 1 all but o; the head
    out["per_module"] = {"greedy": greedy_routes(
        "mixed per-module bits", spec, params,
        [("fused", torch.int8, "off",
          {"norm_qkv": 3, "attn_mlp": 1, "ffn": 1, "attention": 2}),
         # the dense-o layer keeps the write-first path: its attention
         # over the written cache in torch, as in the JAX package
         ("layer", torch.bfloat16, "on",
          {"layer": 1, "norm_qkv": 2, "ffn": 1})],
        {"qmm_mma": 4 + 3 + 1})}
    del params
    torch.cuda.empty_cache()
    return out


def mixed_cli(device, tmp) -> dict:
    """The CLI at mixed bits and with the other quantizers, on the 2-layer
    LLaMA-7B-width and OPT-6.7B-width directories of the cli and families
    phases (cli_dir), 4 x 2,048 calibration tokens, the tokenizer and
    `datasets` stood in (offline_data), --new-eval:
      * --analyse on the llama directory (results/quant_config.json under
        a working directory of its own);
      * side by side (cli_batch), each PPL eval's launches exact:
        --linearmix (llama) and --layermix (OPT: layerwise.json's
        opt-6.7b row, both layers 3 bits) with --save; on the llama
        directory --quant_config on the analysed file (its columnwise
        modules stay dense), --non_linear and --columnwise (dense
        results: no launches in the PPL evals; the columnwise solves at
        --bcq_round 1), s per layer in each;
      * the --linearmix and --layermix files served through the CLI
        (--benchmark --faster-kernel --int8_kv --quant_lm_head 8);
      * the --linearmix file with add_actquant's 8-bit activation
        quantizers, served through #1: greedy tokens against the plain
        versions (greedy_routes)."""
    import torch

    from gptq_tpu_torch import cli
    from gptq_tpu_torch.data import synthetic_stream
    from gptq_tpu_torch.io import load_checkpoint
    from gptq_tpu_torch.models.convert import hf_config
    from gptq_tpu_torch.models.registry import spec_from_hf_config
    from gptq_tpu_torch.pipeline import add_actquant

    L = 2
    d = os.path.join(tmp, "mixed")
    os.makedirs(d, exist_ok=True)
    llama, _, _ = cli_dir(tmp, "llama-7b", device)
    opt, _, _ = cli_dir(tmp, "opt-6.7b", device)
    lv = spec_from_hf_config(hf_config(llama)).vocab
    ov = spec_from_hf_config(hf_config(opt)).vocab
    common = ["--nsamples", "4", "--new-eval", "--results_log",
              os.path.join(d, "ppl.txt")]
    q_lin, q_lay, q_qc = (os.path.join(d, f"{n}.npz")
                          for n in ("linearmix", "layermix", "quant_config"))
    out = {}

    with offline_data(lv):
        buf = io.StringIO()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([llama, "c4", "--wbits", "3", "--nsamples",
                               "4", "--analyse"])
            with open("results/quant_config.json") as f:
                qc = json.load(f)
        finally:
            os.chdir(cwd)
    assert rc == 0
    wall = time.perf_counter() - t0
    for line in buf.getvalue().strip().splitlines()[:2]:
        log(f"cli mixed analyse | {line}")
    if len(qc) != 7 * L or {v["bits"] for v in qc.values()} != {3}:
        raise AssertionError(f"mixed cli --analyse: {len(qc)} entries "
                             f"{sorted({v['bits'] for v in qc.values()})}")
    dense_n = sum(v["columnwise"] for v in qc.values())
    out["analyse"] = {"wall_s": wall, "columnwise": dense_n,
                      "modules": len(qc)}
    log(f"mixed cli --analyse: {wall:.1f} s, {dense_n} of {len(qc)} "
        f"modules columnwise")

    runs = {
        # q / k / v, o, gate, up, down a layer on the tensor cores
        "linearmix": ([llama, "--wbits", "4", "--linearmix", "--save",
                       q_lin], {"qmm_mma": 7 * L}, lv),
        "layermix": ([opt, "--wbits", "4", "--groupsize", "128",
                      "--layermix", "--save", q_lay], {"qmm_mma": 6 * L},
                     ov),
        # the columnwise solves at one refinement round of the APoT
        # alphas (--bcq_round, 5 by default): a re-fit every 8 columns
        # sets the batch's wall time
        "quant_config": ([llama, "--wbits", "3", "--quant_config",
                          os.path.join(d, "results", "quant_config.json"),
                          "--bcq_round", "1", "--save", q_qc],
                         {"qmm_mma": len(qc) - dense_n}, lv),
        "non_linear": ([llama, "--wbits", "3", "--non_linear"], {}, lv),
        "columnwise": ([llama, "--wbits", "3", "--columnwise",
                        "--bcq_round", "1"], {}, lv)}
    res = cli_batch([(f"mixed {k}", [argv[0], "c4", *argv[1:], *common],
                      per_window, vocab)
                     for k, (argv, per_window, vocab) in runs.items()])
    out.update(zip(runs, res))

    serve_flags = ["--faster-kernel", "--int8_kv", "--quant_lm_head", "8"]
    n_tok, steps = 8, 100 + 8
    for key, path, want in (
            # q / k 4 bits and v 3 stay three #1; o 3, gate|up 4, down 3
            # one #5
            ("linearmix", q_lin, {"qmm": 3 * L * steps, "attn_mlp": L * steps,
                                  "attention": L * steps, "norm_qkv": steps}),
            # opt-6.7b's first layers are 3 bits: layernorm + biases
            # through #4 and #5
            ("layermix", q_lay, {"norm_qkv": (L + 1) * steps,
                                 "attn_mlp": L * steps,
                                 "attention": L * steps})):
        bench, counts, _ = serve_cli(path, n_tok, serve_flags, "auto")
        expect(counts, want, f"mixed cli serve of the --{key} file")
        out[key]["serve"] = {"median_ms": bench["median_s"] * 1e3,
                             "launches": counts, "steps": steps}

    # add_actquant at 8 bits on the --linearmix file: every linear through
    # #1 (act_q keeps the fused kernels off; gate|up share their quantizer
    # and fuse, q / k / v differ in bits)
    spec, params, _ = load_checkpoint(q_lin, device=device)
    calib = torch.as_tensor(synthetic_stream(spec.vocab, 4 * 128, seed=5)
                            .reshape(4, 128), device=device)
    t0 = time.perf_counter()
    add_actquant(spec, params, calib, bits=8)
    out["act_q"] = {"fit_s": time.perf_counter() - t0}
    out["act_q"]["greedy"] = greedy_routes(
        "mixed act_q 8-bit", spec, params,
        [("unfused", torch.int8, "off", {"qmm": 6 * L, "attention": L})],
        {"qmm_mma": 6 * L})["unfused"]
    del params
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def phase_mixed(device, tmp, card, peaks, report):
    """Mixed precision on the card: the kernels at mixed bits
    (mixed_kernel_rows), the in-process serves at per-linear, per-layer
    and per-module bits (mixed_serves) and the CLI's mixed-precision,
    analysis and quantizer flags (mixed_cli)."""
    import torch

    t0 = time.perf_counter()
    mx = {"rows": mixed_kernel_rows(device, peaks, device_ms)}
    torch.cuda.empty_cache()
    log(f"mixed kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mx["serve"] = mixed_serves(device, card, peaks)
    log(f"mixed serves: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mx["cli"] = mixed_cli(device, tmp)
    log(f"mixed cli: {time.perf_counter() - t0:.1f} s")
    report["mixed"] = mx


def mixed_entries(mx) -> list:
    """The kernels line's entries of the mixed phase: one per kernel and
    bit mix, its M = 1 a8 readings (a16 under a16, M = 32 under m32),
    launches from the mixed serves' eager steps (the main path of that
    mix), only those on the weights the entry names (launches_by)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "unfused_ms", "wrapper_ms", "fused_route_ms", "rel_err",
            "tiles_ms")
    sv, cli = mx["serve"], mx["cli"]
    lm = sv["linearmix"]["fused"]
    lw = sv["layerwise"]
    pm = sv["per_module"]["greedy"]
    opt_serve = cli["layermix"]["serve"]
    launches = {
        # v's 32 a step: the #1 launches on 3-bit weights (q / k: 4 bits)
        ("qmm", "v w3g-1"): lm["launches_by"].get("w3", {}).get("qmm", 0),
        # the 3-bit layers' (4 of 8) q|k|v
        ("norm_qkv", "llama-7b", "q|k|v"):
            lw["fused"]["launches_by"].get("w3", {}).get(
                "norm_qkv", 0),
        # both layers of the --layermix file are 3 bits; less the head's
        ("norm_qkv", "opt-6.7b", "q|k|v"):
            opt_serve["launches"]["norm_qkv"] - opt_serve["steps"],
        ("attn_mlp",): lm["launches"]["attn_mlp"],
        ("ffn",): sum(r.get("launches", {}).get("ffn", 0)
                      for r in pm.values()),
        ("layer", "llama-7b w4/3/4/3"): pm["layer"]["launches"]["layer"],
        ("layer", "llama-7b w3"): lw["layer"]["launches_by"].get(
            "w3", {}).get("layer", 0),
    }
    what = {
        "qmm": ("qmm", QMM_SRC, "gptq_tpu/ops/qmatmul.py:156", GEMV_SRC),
        **{k: v for k, v in FAMILY_KERNELS.items()
           if k in ("norm_qkv", "attn_mlp", "ffn", "layer")}}
    groups = {}
    for r in mx["rows"]:
        key = (r["kernel"], r.get("model", ""), r["w"] if "w" in r else "")
        groups.setdefault(key, []).append(r)
    out = []
    for (kernel, model, tag), rs in groups.items():
        name, src, replaces, dev = what[kernel]
        one = next(r for r in rs if r.get("M", 1) == 1 and r.get("a8", True)
                   and "ms" in r)
        a16 = [r for r in rs if r.get("M", 1) == 1 and not r.get("a8", True)
               and "ms" in r]
        many = [r for r in rs if r.get("M") == 32 and r.get("a8", True)]
        n = next(v for k, v in launches.items()
                 if k[0] == kernel and all(p in (model, tag) for p in k[1:]))
        label = {"qmm": tag, "attn_mlp": tag,
                 "ffn": tag.replace("o3 ", ""),
                 "norm_qkv": f"{model} {tag} w{one.get('bits')}"}.get(
                     kernel, model)
        entry = {"name": f"{name} [mixed: {label}]", "route": "cuda",
                 "source": src, "replaces": replaces, "device_code": dev,
                 "launches": n,
                 "max_abs_err": max(r["max_abs_err"] for r in rs),
                 **{k: one.get(k) for k in keys},
                 "kernel_route": one.get("route")}
        if a16:
            entry["a16"] = {k: a16[0].get(k) for k in keys}
        if many:
            entry["m32"] = {k: many[0].get(k) for k in keys}
            entry["m32"]["kernel_route"] = many[0].get("route")
        out.append(entry)
    if any(e["launches"] <= 0 for e in out):
        raise AssertionError("mixed: a kernel of the mixed path launched no "
                             "time: " + json.dumps(
                                 {e["name"]: e["launches"] for e in out}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--checks", default="",
                    help="comma-separated subset of the kernels phase's "
                         "checks, by function name (default: all; a subset "
                         "prints no kernels line)")
    ap.add_argument("--cli-run", default="",
                    help="one CLI quantize run (JSON), as cli_batch starts "
                         "it in a process of its own")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    checks = set(filter(None, args.checks.split(",")))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.cli_run:
        return cli_run(args.cli_run)
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
    for name in _build.SOURCES:
        # each kernel's ptxas lines (name, registers, spills, smem), from
        # this build or the log kept beside an earlier one
        path = _build._lib_path(name)[:-3] + ".log"
        text = built[name]["log"] if name in built else (
            open(path).read() if os.path.exists(path) else "")
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"  {name}: {line.strip()}")

    report = {}
    timer = device_ms
    if "kernels" in phases:
        for check in (qmm_checks, attn_checks, fused_checks, rows_checks,
                      fused_bcq_checks, layer_checks, bcq_checks,
                      stream_checks, expert_checks, partial_checks,
                      mma_crossover):
            if checks and check.__name__ not in checks:
                continue
            t0 = time.perf_counter()
            check(device, peaks, timer, report)
            log(f"{check.__name__}: {time.perf_counter() - t0:.1f} s")
        if not checks:
            quant_tie_check(device, report)
    tmp = tempfile.mkdtemp(prefix="gptq_tpu_torch_smoke_")
    try:
        for phase, run in (
                ("quantize", lambda: (phase_quantize(device, tmp, report),
                                      phase_quantize_bcq(device, tmp,
                                                         report),
                                      quantize_offload(device, tmp,
                                                       report))),
                ("serve", lambda: phase_serve(device, tmp, card, report)),
                ("sp", lambda: (phase_sp(device, card, report),
                                torch.cuda.empty_cache())),
                ("moe", lambda: phase_moe(device, tmp, card, peaks, report)),
                ("cli", lambda: phase_cli(device, tmp, report)),
                ("batch", lambda: phase_batch(device, card, peaks, report)),
                ("families", lambda: phase_families(device, tmp, card, peaks,
                                                    report)),
                ("mixed", lambda: phase_mixed(device, tmp, card, peaks,
                                              report))):
            if phase in phases:
                t0 = time.perf_counter()
                run()
                log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    if "kernels" in phases and not checks:
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
            entry = {"name": name, "route": "cuda", "source": FFN_SRC,
                     "replaces": f"gptq_tpu/ops/ffn.py:{line}",
                     "launches": launches,
                     "max_abs_err": report["fused_max_abs_err"][name],
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     # no one PyTorch call computes these functions
                     "library_ms": None, "unfused_ms": row["unfused_ms"],
                     "wrapper_ms": row["wrapper_ms"], "shape": shape,
                     "bcq": bcq_branch(name)}
            # M = 1: #4 on #1's single-row stream, #5 / #6 on #12's
            a16 = next(r for r in report["fused_rows"]
                       if r["kernel"] == name and r["w"] == row["w"]
                       and r["M"] == 1 and not r["a8"] and "ms" in r)
            single = ("norm_qkv_gemv_kernel" if name == "norm_qkv"
                      else "mlp_stream_kernel")
            tiled = "norm_qkv_kernel" if name == "norm_qkv" else "mlp_kernel"
            entry.update({
                "kernels": [f"{single} (M = 1, uniform)",
                            f"{tiled} (BCQ; M 2-32 where the rows kernels "
                            f"refuse)"],
                "device_code": (GEMV_SRC if name == "norm_qkv"
                                else STREAM_DEV_SRC),
                "tiles_ms": row["tiles_ms"],
                "wrapper_host_us": row["wrapper_host_us"],
                "a16": {k: a16[k] for k in ("ms", "tiles_ms", "plain_ms",
                                            "bound_ms", "unfused_ms")}})
            return entry

        def summed(rows, key):
            vals = [r[key] for r in rows]
            return None if None in vals else sum(vals)

        dec = [r for r in report["qmm_rows"]
               if r["w"] == "w4g-1" and r["M"] == 1 and r["a8"]]
        dec_bf16 = [r for r in report["qmm_rows"]
                    if r["w"] == "w4g-1" and r["M"] == 1 and "ms" in r
                    and r["x"] == "bfloat16"]
        at = report["attn_times"][0]
        kernels = [
            {"name": "qmm", "route": "cuda", "source": QMM_SRC,
             "replaces": "gptq_tpu/ops/qmatmul.py:156",
             # M = 1: qgemv_kernel of csrc/gemv.cuh (PR 11)
             "device_code": GEMV_SRC,
             # on the unfused route (the fused one launches no qmm at decode)
             "launches": serve.get("unfused", {}).get("launches", {})
             .get("qmm", 0),
             "max_abs_err": report["qmm_max_abs_err"],
             "ms": sum(r["ms"] for r in dec),
             "plain_ms": sum(r["plain_ms"] for r in dec),
             "bound_ms": sum(r["bound_ms"] for r in dec),
             "bound_by": "bytes",
             "library_ms": sum(r["library_ms"] for r in dec),
             "wrapper_ms": sum(r["wrapper_ms"] for r in dec),
             "wrapper_host_us": sum(r["wrapper_host_us"] for r in dec),
             "per_linear_ms": [r["ms"] for r in dec],
             "bf16": {k: summed(dec_bf16, k) for k in
                      ("ms", "plain_ms", "bound_ms", "library_ms")},
             "shape": "one llama-7B layer's four packed linears (K x N: "
                      "4096x12288, 4096x4096, 4096x22528, 11264x4096), "
                      "w4a8 groupsize -1, M=1; times summed (bf16: bf16 "
                      "x, a16)"},
            {"name": "decode_attention", "route": "cuda", "source": PARTIAL_SRC,
             "replaces": "gptq_tpu/ops/attention.py:253",
             # the head-loop kernel computes the same function (hd % 128 != 0)
             "also_replaces": "gptq_tpu/ops/attention.py:40",
             "launches": fused_launches.get("attention", 0),
             "max_abs_err": report["attn_max_abs_err"],
             "ms": at["ms"], "plain_ms": at["plain_ms"],
             "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
             "library_ms": at["library_ms"],
             "rows": report["attn_times"],
             "shape": f"B=1, H=Hkv=32, hd=128, int8 cache S={at['S']}, "
                      f"{at['length']} filled + fresh pair (rows: S=2048 "
                      f"int8 and bf16, Mixtral GQA 4, B=4)"},
            fused_entry("norm_qkv", 483, timed("norm_qkv", "q|k|v w4g-1"),
                        fused_launches.get("norm_qkv", 0),
                        "ln1 + q|k|v 4096x12288 w4a8 g-1, M=1 (head 4096x32256 "
                        "w8a8 in head_*, Mixtral's q|k|v 4096x6144 w4a8 g-1 "
                        "in mixtral, a16 the llama q|k|v at bf16)"),
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
            "timeline": lr[0]["timeline"],
            "long": {k: lr[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "fused_route_ms",
                                           "timeline")},
            "shape": "one llama-7B layer (q|k|v 4096x12288, o 4096x4096, "
                     "gate|up 4096x22528, down 11264x4096), w4a8 g-1, bf16 "
                     "cache S=256 with 128 filled (long: S=2048, 1,100 "
                     "filled); launches from the 32-layer CLI serve on the "
                     "layer route"})
        head = timed("norm_qkv", "head w8g-1")
        kernels[2].update({f"head_{k}": head[k] for k in
                           ("ms", "tiles_ms", "plain_ms", "bound_ms",
                            "unfused_ms")})
        mx = timed("norm_qkv", "q|k|v mixtral w4g-1")
        kernels[2]["mixtral"] = {k: mx[k] for k in
                                 ("ms", "tiles_ms", "plain_ms", "bound_ms",
                                  "unfused_ms")}
        if "batch" in report:
            # the continuous batcher's shapes: launches of one eager
            # lock-step at 32 slots, times at M = 4 and 32 (#4, #5) and
            # B = 32 with per-slot lengths (#3)
            bt = report["batch"]
            keys = ("ms", "wrapper_ms", "plain_ms", "unfused_ms",
                    "library_ms", "bound_ms", "bound_by", "rel_err")
            for entry, kernel in ((kernels[2], "norm_qkv"),
                                  (kernels[3], "attn_mlp")):
                entry["batch"] = {
                    "launches_per_step": bt["step_launches"][kernel],
                    "rows": [{"w": r["w"], "M": r["M"],
                              **{k: r[k] for k in keys}}
                             for r in bt["kernel_rows"]
                             if r["kernel"] == kernel]}
            kernels[1]["batch"] = {
                "launches_per_step": bt["step_launches"]["attention"],
                "rows": [{k: r[k] for k in ("cache", "B", "S", "max_abs_err",
                                            "ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}
                         for r in bt["attn_rows"]]}

        # #4 and #5 / #6 at rows 2-32 on the tensor cores: launches of the
        # batch phase's eager lock-step at 32 slots (the main path of
        # rows 2-32), readings at M = 32 (m4: M = 4), a8
        rr = report["rows_rows"]
        keys = ("ms", "tiles_ms", "plain_ms", "unfused_ms", "library_ms",
                "bound_ms", "bound_by", "wrapper_ms", "wrapper_host_us",
                "rel_err")

        def rows_at(kernel, tag, M):
            r = next(r for r in rr if r["kernel"] == kernel and r["w"] == tag
                     and r["M"] == M and r["a8"] and "ms" in r)
            return {k: r[k] for k in keys}

        def rows_entry(name, kernel, line, tag, shape, **extra):
            r = rows_at(kernel, tag, 32)
            return {"name": name, "route": "cuda", "source": ROWS_SRC,
                    "device_code": ROWS_DEV_SRC,
                    "replaces": f"gptq_tpu/ops/ffn.py:{line}",
                    "launches": report.get("batch", {})
                    .get("rows_launches", {}).get(name, 0),
                    "max_abs_err": report["rows_max_abs_err"][kernel],
                    **r, "m4": rows_at(kernel, tag, 4), "shape": shape,
                    **extra}

        kernels.append(rows_entry(
            "norm_qkv_rows_kernel", "norm_qkv", 483, "q|k|v w4g-1",
            "ln1 + q|k|v 4096x12288 w4a8 g-1, M=32 (m4: M=4; head: "
            "final_ln + 4096x32256 w8a8); tiles_ms: the tiled "
            "norm_qkv_kernel forced on the same inputs",
            head={M: rows_at("norm_qkv", "head w8g-1", M) for M in (4, 32)},
            timeline=report["rows_timeline"]["norm_qkv"]))
        kernels.append(rows_entry(
            "mlp_rows_kernel", "attn_mlp", 383, "w4g-1",
            "o 4096x4096 + ln2 + gate|up 4096x22528 + down 11264x4096, "
            "w4a8 g-1, M=32 (m4: M=4; ffn: #6, gate|up + down); library: "
            "the three (#6: two) products over the dequantized bf16 "
            "weights; tiles_ms: the tiled mlp_kernel forced",
            also_replaces="gptq_tpu/ops/ffn.py:312",
            ffn={M: rows_at("ffn", "w4g-1", M) for M in (4, 32)},
            timeline=report["rows_timeline"]["attn_mlp"]))

        layer = ("one llama-7B layer's four packed linears (K x N: "
                 "4096x12288, 4096x4096, 4096x22528, 11264x4096), M=1, "
                 "times summed")
        sd, bd = report["stream_decode"], report["bcq_decode"]
        kernels.append({
            "name": "streamed_qmm", "route": "cuda", "source": STREAM_SRC,
            "replaces": "gptq_tpu/ops/qmatmul.py:205",
            # M = 1: qgemv_kernel of csrc/gemv.cuh
            "kernels": ["qgemv_kernel (M = 1)", "qstream_kernel (M 2-8)"],
            "device_code": GEMV_SRC,
            "tiles_ms": summed(sd, "tiles_ms"),
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
            # M = 1: bcq_gemv_kernel of csrc/gemv.cuh (PR 11)
            "device_code": GEMV_SRC,
            "launches": serve.get("bcq", {}).get("launches", {})
            .get("bcq", 0),
            "max_abs_err": report["bcq_max_abs_err"],
            "ms": summed(bd, "ms"), "plain_ms": summed(bd, "plain_ms"),
            "bound_ms": summed(bd, "bound_ms"), "bound_by": "bytes",
            "library_ms": summed(bd, "library_ms"),
            "wrapper_ms": summed(bd, "wrapper_ms"),
            "wrapper_host_us": summed(bd, "wrapper_host_us"),
            "per_linear_ms": [r["ms"] for r in bd],
            "bf16": {k: summed(report["bcq_decode_bf16"], k) for k in
                     ("ms", "plain_ms", "bound_ms", "library_ms")},
            "m512": {k: report["bcq_m512"][k] for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by")},
            "shape": layer + "; 3-bit BCQ groupsize 128, a8 (m512: "
                             "4096x12288, M=512, bf16 x)"})
        cli = report.get("cli", {})

        def mma_sum(rows):
            """One llama-7B layer's four linears at M = 2048, summed."""
            out = {k: summed(rows, k) for k in ("ms", "wrapper_ms",
                                                "plain_ms", "bound_ms",
                                                "library_ms")}
            out["bound_by"] = rows[0]["bound_by"]
            return out

        def mma_worst(rows):
            return max(r["max_abs_err"] for r in rows
                       if r["route"] == "mma" and r["x"] == "float32")

        qr = [r for r in report["qmm_rows"] if r["M"] == 2048 and "ms" in r]
        q = {(w, x, a8): mma_sum([r for r in qr if r["w"] == w
                                  and r["x"] == x and r["a8"] == a8])
             for w in ("w4g-1", "w4g128p")
             for x, a8 in (("bfloat16", False), ("float32", False),
                           ("float32", True))}
        kernels.append({
            "name": "qmm_mma", "route": "cuda", "source": MMA_SRC,
            "replaces": "gptq_tpu/ops/qmatmul.py:156",
            # the cli phase's PPL evals: 2,048-row windows, f32 x
            "launches": cli.get("w4", {}).get("launches", {})
            .get("qmm_mma", 0),
            "max_abs_err": mma_worst(report["qmm_rows"]),
            **q[("w4g-1", "bfloat16", False)],
            "f32": q[("w4g-1", "float32", False)],
            "a8": q[("w4g-1", "float32", True)],
            "g128_actorder": {"bf16": q[("w4g128p", "bfloat16", False)],
                              "f32": q[("w4g128p", "float32", False)],
                              "a8": q[("w4g128p", "float32", True)]},
            "sp_prefill_launches": report.get("sp", {}).get("long", {})
            .get("prefill_launches", {}).get("qmm_mma", 0),
            "shape": "one llama-7B layer's four packed linears (K x N: "
                     "4096x12288, 4096x4096, 4096x22528, 11264x4096), w4 "
                     "g-1, M=2048 bf16 x (f32: split into two bf16 halves; "
                     "a8: int8 x), times summed; launches from the cli "
                     "phase's PPL evals"})
        bm = report["bcq_mma"]

        def bcq_row(M, x, act):
            r = next(r for r in bm if r["M"] == M and r["x"] == x
                     and r["act"] == act)
            return {k: r[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}

        kernels.append({
            "name": "bcq_mma", "route": "cuda", "source": MMA_SRC,
            "replaces": "gptq_tpu/ops/bcq_matmul.py:70",
            "launches": cli.get("b3", {}).get("launches", {})
            .get("bcq_mma", 0),
            "max_abs_err": mma_worst(bm + report["bcq_rows"]),
            **bcq_row(512, "bfloat16", "a16"),
            "rows": {f"M{M} {x}": bcq_row(M, "bfloat16" if x == "bf16"
                                          else "float32",
                                          "a8" if x == "a8" else "a16")
                     for M in (512, 2048) for x in ("bf16", "f32", "a8")},
            "shape": "4096x12288 3-bit BCQ g128, M=512 bf16 x (rows: M 512 "
                     "/ 2048 at bf16, f32 and a8 x); launches from the cli "
                     "phase's lut PPL evals"})
        if "expert_rows" in report:
            moe = report.get("moe", {})
            ex_all = [r for r in report["expert_rows"]
                      if "ms" in r and "e" not in r]
            ex = {r["w"]: r for r in ex_all
                  if r["M"] == 16 and r["x"] == "bf16"}
            se = {r["w"]: r for r in report["expert_rows"]
                  if "ms" in r and "e" in r}
            # one layer's 16-token prefill: gate and up share x (the gate
            # bank stands for both), down takes x per expert
            pre = [ex["gate w4g-1"], ex["gate w4g-1"], ex["down w4g-1"]]
            # one layer's decode: top-2 x (gate, up, down)
            dec = [se["gate w4g-1"], se["up w4g-1"], se["down w4g-1"]] * 2
            reqs = moe.get("requests", {})
            kernels.append({
                "name": "expert_matmul_mma", "route": "cuda",
                "source": MOE_MMA_SRC,
                "replaces": "gptq_tpu/ops/qmatmul.py:177",
                "launches": sum(r["launches"].get("expert_mma", 0)
                                for r in reqs.values()),
                "max_abs_err": report["expert_max_abs_err"],
                "ms": summed(pre, "ms"), "plain_ms": summed(pre, "plain_ms"),
                "bound_ms": summed(pre, "bound_ms"), "bound_by": "bytes",
                "library_ms": summed(pre, "library_ms"),
                "cuda_core_ms": summed(pre, "cuda_core_ms"),
                "rows": {f"M{r['M']} {r['x']} {r['w'][:4]}":
                         {k: r[k] for k in ("ms", "loop_ms", "library_ms",
                                            "bound_ms", "cuda_core_ms")}
                         for r in ex_all},
                "shape": "one Mixtral-8x7B layer's three banks at a 16-token "
                         "prefill (8 x 4096x14336 gate / up, x shared; 8 x "
                         "14336x4096 down, x per expert), 4-bit g-1, bf16 x, "
                         "times summed (rows: each bank at M 2 / 16 / 32, "
                         "bf16 and f32 x); launches from the 2-layer "
                         "requests at T = 16 / 32"})
            kernels.append({
                "name": "expert_matmul", "route": "cuda", "source": MOE_SRC,
                "replaces": "gptq_tpu/ops/qmatmul.py:177",
                "launches": sum(r["launches"].get("expert", 0)
                                for r in reqs.values()),
                "max_abs_err": report["expert_max_abs_err"],
                "ms": summed(pre, "loop_ms"),
                "plain_ms": summed(pre, "plain_ms"),
                "bound_ms": summed(pre, "bound_ms"), "bound_by": "bytes",
                "library_ms": summed(pre, "library_ms"),
                "cuda_core_ms": summed(pre, "cuda_core_ms"),
                "shape": "the CUDA-core #8 (expert_route's \"shallow\" "
                         "banks), timed on the same three 4-bit g-1 banks "
                         "at M = 16, bf16 x, times summed; launches from "
                         "the 2-layer request on 3-bit g128 experts"})
            kernels.append({
                "name": "expert_select", "route": "cuda", "source": MOE_SRC,
                "replaces": "gptq_tpu/ops/qmatmul.py:730",
                # M = 1: qsel_gemv_kernel of csrc/gemv.cuh
                "kernels": ["qsel_gemv_kernel (M = 1)",
                            "qsel_kernel (M > 1)"],
                "device_code": GEMV_SRC,
                "rows_ms": summed(dec, "rows_ms"),
                "wrapper_host_us": dec[0]["wrapper_host_us"],
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
            "from 132 eager steps of the 8-layer SPEngine(sp=1) decode"))
        kernels.append(partial_entry(
            "decode_attention_partial", 684,
            next(r for r in pr if r["entry"] == "narrow"
                 and r["cache"] == "int8"),
            report.get("sp_tiny", {}).get("launches", {}).get("partial", 0),
            "TinyLlama-1.1B: B=1, H=32, Hkv=4, hd=64, int8 " + cut + " of 22 "
            "layers; launches from 16 eager steps of the 2-layer "
            "TinyLlama-width SPEngine(sp=1) decode"))
    if "families" in report:
        kernels += family_entries(report["families"])
    if "mixed" in report:
        kernels += mixed_entries(report["mixed"])
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
