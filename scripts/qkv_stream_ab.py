#!/usr/bin/env python3
"""#4 (ln1 + q|k|v, the fused norm_qkv kernel) and #7 (the streamed
matmul) at one row (decode) in two checkouts of this repo, side by side
on one CUDA card.

    python3 scripts/qkv_stream_ab.py A_DIR B_DIR [--out FILE]

For each checkout, in a process of its own and in the order A, B, B, A,
on seeded random codes (the checkout's chip_smoke.packed_linear and
synth_packed_params):
  * #4 at M = 1, rmsnorm: llama-7B's ln1 + q|k|v (4096 x 12288, 4-bit
    groupsize -1) at a8 and a16, Mixtral-8x7B's (4096 x 6144) at a8 and
    the 8-bit head (4096 x 32256) at a8: the bare kernel launch's device
    time (ops/ffn._norm_qkv_cuda, the route the checkout picks; the
    checkout's kernel_bench.time_fn: CUDA events, L2 flushed);
  * #7 at M = 1, w4a8 groupsize -1: a llama-7B layer's four linears
    (4096x12288, 4096x4096, 4096x22528, 11264x4096) through
    ops/qmatmul._stream_cuda, and #1 (_qmm_cuda) on the same weights,
    each summed;
  * the device time of a decode step (chip_smoke.profile_decode: a
    torch.profiler trace of 8 steps) of an 8-layer llama-7B-width model
    on the fused route (w4a8, 8-bit head, int8 KV), with its norm_qkv
    family, and of a 2-layer one on the streamed route
    (GPTQ_TPU_MATMUL_IMPL=streamed, unfused), with its linears' kernels;
  * the bits of the kernels that share the row code this change lifted
    out of #12 (wstream.cuh row_norm): a hash of #5's and #6's outputs at
    llama-7B width (ops/ffn._mlp_cuda, M = 1, a8 and a16) and of 4 decode
    steps' logits of a 4-layer model on the whole-layer route (#12,
    GPTQ_TPU_LAYER_FUSION=on, bf16 KV, dense head, so that no other
    changed kernel runs in the step).

Prints the card's name and power limit, a JSON line for each run and a
summary line of each checkout's two readings (sorted) and whether every
hash agrees across the four runs, and writes the runs and the summary to
--out. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import sys

from _ab import run_ab

H, F = 4096, 11264
LINEARS = ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096))


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the checkout's own
    import numpy as np
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import layer_fused as LF
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.ops.kernel_bench import time_fn
    from gptq_tpu_torch.ops.pack import fuse_packed
    from gptq_tpu_torch.pipeline import quantize_lm_head

    if not torch.cuda.is_available():
        raise SystemExit("qkv_stream_ab: no CUDA card")
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def ms(fn):
        return time_fn(fn).median_s * 1e3

    def digest(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]

    out = {"tree": tree}
    ln = torch.ones(H, dtype=torch.float32, device=dev)
    x2 = torch.randn((1, H), generator=gen, device=dev).to(
        torch.bfloat16).float()
    for tag, parts, bits, runs in (
            ("qkv", (H, H, H), 4, (("a8", True), ("a16", False))),
            ("mixtral qkv", (H, H // 4, H // 4), 4, (("a8", True),)),
            ("head", (32256,), 8, (("a8", True),))):
        pw = fuse_packed([cs.packed_linear(gen, H, n, bits, -1, dev)
                          for n in parts])
        for act, a8 in runs:
            out[f"norm_qkv {tag} {act} ms"] = ms(lambda: Fz._norm_qkv_cuda(
                x2, ln, pw, "rmsnorm", 1e-5, a8, None, None))
        del pw
    stream, qmm = [], []
    for K, N in LINEARS:
        pw = cs.packed_linear(gen, K, N, 4, -1, dev)
        x = torch.randn((1, K), generator=gen, device=dev)
        xq, _ = Q._prepare(x, pw, True)
        stream.append(ms(lambda: Q._stream_cuda(xq, pw)))
        qmm.append(ms(lambda: Q._qmm_cuda(xq, pw)))
        del pw
    out["streamed four linears ms"] = sum(stream)
    out["qmm four linears ms"] = sum(qmm)
    out["streamed per_linear_ms"] = stream
    torch.cuda.empty_cache()

    # the bits of #5 / #6 and #12
    o = cs.packed_linear(gen, H, H, 4, -1, dev)
    gu = fuse_packed([cs.packed_linear(gen, H, F, 4, -1, dev)
                      for _ in range(2)])
    dn = cs.packed_linear(gen, F, H, 4, -1, dev)
    attn = torch.randn((1, H), generator=gen, device=dev)
    xres = torch.randn((1, H), generator=gen, device=dev).to(
        torch.bfloat16).float()
    for act, a8 in (("a8", True), ("a16", False)):
        out[f"attn_mlp {act} bits"] = digest(Fz._mlp_cuda(
            attn, xres, ln, o, gu, dn, "silu", "rmsnorm", 1e-5, True, a8,
            None, None, None, None))
        out[f"ffn {act} bits"] = digest(Fz._mlp_cuda(
            attn, None, None, None, gu, dn, "silu", "rmsnorm", 0.0, True, a8,
            None, None, None, None))
    del o, gu, dn
    torch.cuda.empty_cache()
    prompt = np.random.default_rng(8).integers(0, 32000, size=(1, 64))
    spec = cs.llama7b_spec(4)
    params = cs.synth_packed_params(spec, dev, seed=0)  # a dense head
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.bfloat16, a8=True)
    with cs.fusion_mode("auto"), cs.env_var("GPTQ_TPU_LAYER_FUSION", "on"):
        logits, cache = eng.prefill(torch.as_tensor(prompt[:, :16],
                                                    device=dev))
        tok = logits.argmax(-1)[:, None]
        before, steps = LF.launches, []
        for _ in range(4):
            logits, cache = eng.step(cache, tok)
            steps.append(logits.float())
            tok = logits.argmax(-1)[:, None]
        out["layer route logits bits"] = digest(torch.cat(steps))
        out["layer route launches"] = LF.launches - before
    del eng, params
    torch.cuda.empty_cache()

    spec = cs.llama7b_spec(8)
    params = cs.synth_packed_params(spec, dev, seed=0)
    assert quantize_lm_head(spec, params, bits=8)
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    with cs.fusion_mode("auto"), cs.env_var("GPTQ_TPU_LAYER_FUSION", "off"):
        prof = cs.profile_decode(eng, prompt % spec.vocab)
    out["fused 8-layer step device ms"] = prof["device_ms"]
    out["fused 8-layer norm_qkv ms"] = prof["device_ms_by_family"]["norm_qkv"]
    del eng, params
    torch.cuda.empty_cache()
    spec = cs.llama7b_spec(2)
    params = cs.synth_packed_params(spec, dev, bits=4, groupsize=-1, seed=11)
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    with cs.fusion_mode("off"), cs.matmul_impl("streamed"):
        prof = cs.profile_decode(eng, prompt % spec.vocab)
    fam = prof["device_ms_by_family"]
    out["streamed 2-layer step device ms"] = prof["device_ms"]
    # qstream_kernel counts as "stream", the single-row qgemv_kernel as "qmm"
    out["streamed 2-layer linears ms"] = fam["stream"] + fam["qmm"]
    return out


def main(argv=None) -> int:
    return run_ab(__file__, worker, __doc__, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
