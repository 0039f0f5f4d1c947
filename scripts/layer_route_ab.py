#!/usr/bin/env python3
"""The per-token layer route (#12) of two checkouts of this repo, side by
side on one CUDA card.

    python3 scripts/layer_route_ab.py A_DIR B_DIR [--out FILE]

For each checkout, in a process of its own and in the order A, B, B, A:
  * the median ms/token of the CLI's per-token benchmark (`--benchmark 128
    --faster-kernel --quant_lm_head 8`, GPTQ_TPU_LAYER_FUSION=on, bf16 KV)
    on a 32-layer llama-7B-width checkpoint of seeded random 4-bit codes,
    through that checkout's chip_smoke.py (`serve_cli`), as its serve
    phase runs it;
  * the host's time for one decode_layer_fused call at llama-7B width
    (S = 256, 128 slots filled, the length a device tensor, as the model
    passes it): 100 calls queued with no synchronisation, after a
    warm-up, over 100; and the wall time a call once the device has run
    them all (the device's pace, where the host keeps ahead); five such
    batches, their median.

Prints the card's name and power limit, a JSON line for each run and a
summary line of each checkout's two readings (sorted), and writes the
runs and the summary to --out. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile

from _ab import host_times, run_ab


def worker(tree: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return measure(tree, tmp)


def measure(tree: str, tmp: str) -> dict:
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the checkout's own
    import torch

    from gptq_tpu_torch.io import save_checkpoint
    from gptq_tpu_torch.models import common
    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import layer_fused as LF

    if not torch.cuda.is_available():
        raise SystemExit("layer_route_ab: no CUDA card")
    _build.build_all()  # the checkout's kernels, one nvcc each at once
    dev = torch.device("cuda")
    spec = cs.llama7b_spec(32)
    params = cs.synth_packed_params(spec, dev, seed=0)
    path = os.path.join(tmp, "serve32.npz")
    save_checkpoint(path, spec, params)
    del params
    bench, counts, _ = cs.serve_cli(
        path, 128, ["--faster-kernel", "--quant_lm_head", "8"], "auto",
        layer="on")
    os.remove(path)
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    small = cs.llama7b_spec(2)
    ws = cs.layer_weights(gen, small, dev)
    H, nh, Hkv, hd = small.hidden, small.n_heads, small.kv_heads, small.hd
    x = torch.randn((1, 1, H), generator=gen, device=dev)
    kc, vc = (torch.randn((2, 1, 256, Hkv, hd), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    w1 = torch.rand(H, generator=gen, device=dev) + 0.5
    w2 = torch.rand(H, generator=gen, device=dev) + 0.5
    lens = torch.tensor(128, dtype=torch.int32, device=dev)
    cos, sin = common.rope_tables(small, lens.reshape(1, 1))
    kw = dict(n_heads=nh, n_kv_heads=Hkv, head_dim=hd, act=small.act,
              norm=small.norm_type, eps=float(small.norm_eps),
              sm_scale=float(small.scale), a8=True, layer=1)
    wrapper = host_times(lambda: LF.decode_layer_fused(
        x, kc, vc, lens, cos, sin, w1, w2, *ws, **kw))
    return {"tree": tree, "median_ms": bench["median_s"] * 1e3,
            "p90_ms": bench["p90_s"] * 1e3,
            "tokens_per_s": bench["tokens_per_s"],
            "layer_launches": counts.get("layer"),
            "wrapper_host_us": wrapper["host_us"],
            "wrapper_wall_us": wrapper["wall_us"]}


def main(argv=None) -> int:
    return run_ab(__file__, worker, __doc__, argv=argv,
                  keys=lambda k: k in ("median_ms", "wrapper_host_us",
                                       "wrapper_wall_us"))


if __name__ == "__main__":
    sys.exit(main())
