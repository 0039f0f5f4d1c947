#!/usr/bin/env python3
"""Smoke run of gptq_tpu_torch (the PyTorch / CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one GPU

Phases, in order (any failure exits non-zero; there is no CPU fallback):
  1. build   - nvcc builds the six kernel libraries from csrc/ (qmatmul,
               attention, ffn, bcq_matmul, qstream, qexpert; in parallel).
  2. kernels - each kernel's wrapper against its plain PyTorch version on
               the card at llama-7B shapes, with stated tolerances, and
               timed beside its plain version, a one-call PyTorch
               yardstick (or, for the fused kernels, the unfused route of
               the same function) and the card's bound. The BCQ kernel
               (#13) and the streamed qmm (#7, GPTQ_TPU_MATMUL_IMPL=
               streamed) are held the same way; #7 is also timed beside
               kernel #1 on the same weight. The expert kernels: #8 (the
               batched bank) and #9 (the select, index in device memory)
               at Mixtral-8x7B shapes.
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
               CLI's --lut_bench table.
  5. moe     - Mixtral-8x7B width (spec_from_hf_config of its published
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

PHASES = ("build", "kernels", "quantize", "serve", "moe")
QMM_SRC = "gptq_tpu_torch/csrc/qmatmul.cu"
ATTN_SRC = "gptq_tpu_torch/csrc/attention.cu"
FFN_SRC = "gptq_tpu_torch/csrc/ffn.cu"
BCQ_SRC = "gptq_tpu_torch/csrc/bcq_matmul.cu"
STREAM_SRC = "gptq_tpu_torch/csrc/qstream.cu"
MOE_SRC = "gptq_tpu_torch/csrc/qexpert.cu"
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
TOL = {"qmm_a8": 1e-4, "qmm_a16": 2e-3, "attn": 1e-3, "fused": 3e-3}


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
    return (sum(w.numel() * 4 for w in pw.words)
            + (pw.scale.numel() + pw.zoff.numel()) * 4)


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
    from gptq_tpu_torch.ops import qmatmul as Q

    stack = contextlib.ExitStack()
    for mod, name, fn in (
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
    must launch nothing)."""
    import torch

    reset_counts()
    kern = eng.generate(prompt, n_new)
    torch.cuda.synchronize()
    if not launch_counts()[kernel_name] > 0:
        raise AssertionError(f"{what}: kernel decoding launched no "
                             f"{kernel_name}")
    if want is not None:
        expect(launch_counts(), want, what)
    with plain_versions():
        reset_counts()
        plain = eng.generate(prompt, n_new)
        expect(launch_counts(), {}, f"{what}: plain decoding")
    log(f"{what}: greedy tokens, kernels {kern[0].tolist()} vs plain "
        f"{plain[0].tolist()}")
    if not np.array_equal(kern, plain):
        raise AssertionError(f"{what}: kernel and plain decoding disagree; "
                             + divergence(eng, prompt, kern, plain))
    return kern[0].tolist()


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
    """Every kernel wrapper's launch count."""
    from gptq_tpu_torch.ops import attention as A
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import qmatmul as Q

    return {"qmm": Q.launches, "stream": Q.stream_launches,
            "bcq": B.launches, "attention": A.launches,
            "norm_qkv": Fz.norm_qkv_launches,
            "attn_mlp": Fz.attn_mlp_launches, "ffn": Fz.ffn_launches,
            "expert": Q.expert_launches, "select": Q.select_launches}


def reset_counts() -> None:
    from gptq_tpu_torch.ops import attention as A
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import qmatmul as Q

    Q.launches = Q.stream_launches = B.launches = A.launches = 0
    Fz.norm_qkv_launches = Fz.attn_mlp_launches = Fz.ffn_launches = 0
    Q.expert_launches = Q.select_launches = 0


def expect(counts: dict, want: dict, what: str) -> None:
    """Every kernel's count equals `want` (a missing name: 0)."""
    bad = {k: (v, want.get(k, 0)) for k, v in counts.items()
           if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches (got, want) {bad}")


def serve_cli(path, n_tok, flags, mode, impl="pallas") -> tuple:
    """One CLI benchmark run on route `mode` (GPTQ_TPU_FFN_FUSION) and
    packed-matmul route `impl`; (benchmark dict, counts, printed lines)."""
    import torch

    from gptq_tpu_torch import cli

    buf = io.StringIO()
    with fusion_mode(mode), matmul_impl(impl):
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["dummy", "c4", "--load", path, "--benchmark",
                           str(n_tok), *flags])
        torch.cuda.synchronize()
        counts = launch_counts()
    out = buf.getvalue()
    log(f"cli ({mode}): " + out.strip().replace("\n", " | "))
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])["benchmark"], counts, out


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
    os.remove(path)
    for route in ("fused", "unfused"):
        r = serve[route]
        log(f"decode {route} (cli --benchmark {n_tok} --faster-kernel "
            f"--int8_kv{' --quant_lm_head 8' if route == 'fused' else ''}, "
            f"B=1): median {r['median_ms']:.3f} ms/token, "
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
    for route, e, mode in (("fused", eng, "auto"),
                           ("unfused", unfused_eng, "off")):
        with fusion_mode(mode):
            prof = profile_decode(e, rng.integers(0, spec.vocab, size=(1, 64)))
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
    del params, p2, p_ffn, eng, unfused_eng, eng2, eng_ffn, dense_head
    torch.cuda.empty_cache()
    serve_bcq(device, tmp, card, report)
    serve_streamed(device, tmp, report)
    lut_bench(report)


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
            ("norm_qkv", ("norm_qkv_kernel",)), ("mlp", ("mlp_kernel",)))
    ms = {f: 0.0 for f, _ in fams}
    ms["other"] = 0.0
    n = dict.fromkeys(ms, 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((f for f, keys in fams if any(k in e.key for k in keys)),
                   "other")
        ms[fam] += e.device_time_total / 1e3 / steps
        n[fam] += e.count / steps
    return {"steps": steps, "profiled_wall_ms": wall / steps * 1e3,
            "device_ms": sum(ms.values()),
            "device_ms_by_family": ms, "device_events_per_step": n}


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
        qmm_checks(device, peaks, timer, report)
        attn_checks(device, peaks, timer, report)
        fused_checks(device, peaks, timer, report)
        bcq_checks(device, peaks, timer, report)
        stream_checks(device, peaks, timer, report)
        expert_checks(device, peaks, timer, report)
    tmp = tempfile.mkdtemp(prefix="gptq_tpu_torch_smoke_")
    try:
        if "quantize" in phases:
            phase_quantize(device, tmp, report)
            phase_quantize_bcq(device, tmp, report)
        if "serve" in phases:
            phase_serve(device, tmp, card, report)
        if "moe" in phases:
            phase_moe(device, tmp, card, peaks, report)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    if "kernels" in phases:
        serve = report.get("serve", {})
        fused_launches = serve.get("fused", {}).get("launches", {})

        def timed(kernel, tag):
            return next(r for r in report["fused_rows"] if r["kernel"] == kernel
                        and r["w"] == tag and "ms" in r)

        def fused_entry(name, line, row, launches, shape):
            return {"name": name, "route": "cuda", "source": FFN_SRC,
                    "replaces": f"gptq_tpu/ops/ffn.py:{line}",
                    "launches": launches,
                    "max_abs_err": report["fused_max_abs_err"][name],
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    # no one PyTorch call computes these functions
                    "library_ms": None, "unfused_ms": row["unfused_ms"],
                    "wrapper_ms": row["wrapper_ms"], "shape": shape}

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
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
