#!/usr/bin/env python3
"""#5 / #6 (the fused MLP kernels) and #9 (the expert select) at one row
(decode) in two checkouts of this repo, side by side on one CUDA card.

    python3 scripts/mlp_select_ab.py A_DIR B_DIR [--out FILE]

For each checkout, in a process of its own and in the order A, B, B, A,
on seeded random codes (the checkout's chip_smoke.packed_linear /
packed_bank):
  * #5 attn_mlp (o 4096x4096 + ln2 + gate|up 4096x22528 + down
    11264x4096) and #6 ffn (gate|up + down), 4-bit groupsize -1, M = 1,
    a8 and a16: the bare kernel launch's device time (ops/ffn._mlp_cuda,
    the route the checkout picks; the checkout's kernel_bench.time_fn:
    CUDA events, L2 flushed), and the host's time for one attn_mlp_fused
    call (scripts/_ab.host_times: 100 calls queued with no
    synchronisation, the median of five batches);
  * #9: one Mixtral-8x7B layer's six decode selections (top-2 x gate / up
    8 x 4096x14336, down 8 x 14336x4096), 4-bit groupsize -1, bf16 x,
    expert 3 in device memory: each selection's device time, summed;
  * the device time of a decode step (chip_smoke.profile_decode: a
    torch.profiler trace of 8 steps) of an 8-layer llama-7B-width model on
    the fused route (w4a8, 8-bit head, int8 KV) and of a 4-layer
    Mixtral-8x7B-width one (w4a8 experts).

Prints the card's name and power limit, a JSON line for each run and a
summary line of each checkout's two readings (sorted), and writes the
runs and the summary to --out. Needs a CUDA card.
"""

from __future__ import annotations

import sys

from _ab import host_times, run_ab

H, F, E, MF = 4096, 11264, 8, 14336


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the checkout's own
    import numpy as np
    import torch

    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.ops.kernel_bench import time_fn
    from gptq_tpu_torch.ops.pack import fuse_packed
    from gptq_tpu_torch.pipeline import quantize_lm_head

    if not torch.cuda.is_available():
        raise SystemExit("mlp_select_ab: no CUDA card")
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def ms(fn):
        return time_fn(fn).median_s * 1e3

    out = {"tree": tree}
    o = cs.packed_linear(gen, H, H, 4, -1, dev)
    gu = fuse_packed([cs.packed_linear(gen, H, F, 4, -1, dev)
                      for _ in range(2)])
    dn = cs.packed_linear(gen, F, H, 4, -1, dev)
    ln = torch.ones(H, dtype=torch.float32, device=dev)
    attn = torch.randn((1, H), generator=gen, device=dev)
    xres = torch.randn((1, H), generator=gen, device=dev).to(torch.bfloat16)
    x2 = xres.float()
    for act, a8 in (("a8", True), ("a16", False)):
        out[f"attn_mlp {act} ms"] = ms(lambda: Fz._mlp_cuda(
            attn, x2, ln, o, gu, dn, "silu", "rmsnorm", 1e-5, True, a8, None,
            None, None, None))
        out[f"ffn {act} ms"] = ms(lambda: Fz._mlp_cuda(
            attn, None, None, None, gu, dn, "silu", "rmsnorm", 0.0, True, a8,
            None, None, None, None))
    out["attn_mlp host_us"] = host_times(
        lambda: Fz.attn_mlp_fused(attn, xres, ln, o, gu, dn))["host_us"]
    del o, gu, dn
    idx = torch.tensor([3], dtype=torch.int32, device=dev)
    per = []
    for K, N in ((H, MF), (H, MF), (MF, H)):  # gate, up, down
        pe = cs.packed_bank(gen, E, K, N, 4, -1, dev)
        x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
        per.append(ms(lambda: Q._select_cuda(x, pe, idx)))
        del pe
    out["select six ms"] = 2 * sum(per)
    out["select per_projection_ms"] = per
    torch.cuda.empty_cache()

    prompt = np.random.default_rng(8).integers(0, 32000, size=(1, 64))
    spec = cs.llama7b_spec(8)
    params = cs.synth_packed_params(spec, dev, seed=0)
    assert quantize_lm_head(spec, params, bits=8)
    eng = DecodeEngine(spec, params, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    with cs.fusion_mode("auto"), cs.env_var("GPTQ_TPU_LAYER_FUSION", "off"):
        prof = cs.profile_decode(eng, prompt % spec.vocab)
    out["fused 8-layer step device ms"] = prof["device_ms"]
    out["fused 8-layer mlp ms"] = prof["device_ms_by_family"]["mlp"]
    del eng, params
    torch.cuda.empty_cache()
    spec = cs.mixtral_spec(4)
    params = cs.synth_moe_params(spec, dev, seed=5)
    assert quantize_lm_head(spec, params, bits=8)
    fused = fuse_serving(spec, params, a8=True)
    eng = DecodeEngine(spec, fused, max_len=128, batch=1,
                       cache_dtype=torch.int8, a8=True)
    prof = cs.profile_decode(eng, prompt[:, :16] % spec.vocab)
    out["moe 4-layer step device ms"] = prof["device_ms"]
    out["moe 4-layer select ms"] = prof["device_ms_by_family"]["select"]
    return out


def main(argv=None) -> int:
    return run_ab(__file__, worker, __doc__, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
