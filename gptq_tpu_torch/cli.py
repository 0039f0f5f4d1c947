"""Load-and-serve command line (port of the --load / --benchmark path of
gptq_tpu/cli.py, with the same flag names):

    python -m gptq_tpu_torch.cli dummy c4 --load q.npz --benchmark 128 \
        --faster-kernel --int8_kv --quant_lm_head 8

    python -m gptq_tpu_torch.cli dummy c4 --lut_bench --groupsize 128

Runs on the GPU (`--device cuda`, the default, raises without one).
`--lut_bench` prints the serving matmuls' latencies (ops/kernel_bench.py)
at the flags' groupsize (and --wbits, if below 16). The benchmark's
result line carries the loaded checkpoint's quantization fields. An MoE
(Mixtral-style) checkpoint serves the same way, its expert banks through
csrc/qexpert.cu.
Quantizing from a model directory and the PPL evals over the HF datasets
are not ported yet (ROADMAP queue 1): serving needs --load.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gptq_tpu_torch")
    p.add_argument("model", type=str,
                   help="model name (only used for logs with --load)")
    p.add_argument("dataset", type=str, nargs="?", default="c4",
                   choices=["wikitext2", "ptb", "c4", "ptb-new", "c4-new"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load", type=str, default="")
    p.add_argument("--benchmark", type=int, default=0)
    p.add_argument("--check", action="store_true")
    p.add_argument("--faster-kernel", action="store_true")
    p.add_argument("--int8_kv", action="store_true",
                   help="serve with the int8 KV cache (per-token-head "
                        "scales; the decode-attention kernel reads it "
                        "directly)")
    p.add_argument("--quant_lm_head", type=int, default=0, metavar="BITS",
                   help="also quantize the output projection (RTN, e.g. 8); "
                        "the fused route serves it with the norm in one "
                        "launch")
    p.add_argument("--wbits", type=int, default=16,
                   choices=[1, 2, 3, 4, 8, 16])
    p.add_argument("--groupsize", type=int, default=-1)
    p.add_argument("--lut_bench", action="store_true",
                   help="time the serving matmuls (uniform and BCQ) at "
                        "llama-7B width and exit")
    p.add_argument("--device", type=str, default="cuda")
    return p


QUANT_FIELDS = ("wbits", "groupsize", "lut_eval", "bcq_round", "apot_nums",
                "use_bst")


def quant_fields(params: dict, cfg) -> dict:
    """The result line's quantization fields: the checkpoint's own config,
    or, for a checkpoint saved without one, what the first packed weight
    under params['layers'] says, in the JAX package's tree order (sorted
    keys). The JAX CLI takes the first leaf of the whole tree, which can
    be a packed lm_head (ROADMAP section 3)."""
    from gptq_tpu_torch.config import QuantConfig
    from gptq_tpu_torch.ops.pack import PackedWeight

    if cfg is not None:
        return {f: getattr(cfg, f) for f in QUANT_FIELDS}
    out = {f: getattr(QuantConfig(), f) for f in QUANT_FIELDS}
    for lp in params["layers"]:
        for key in sorted(lp):
            w = lp[key].get("w") if isinstance(lp[key], dict) else None
            if isinstance(w, PackedWeight):
                out.update(wbits=w.bits, groupsize=w.groupsize,
                           lut_eval=w.fmt == "bcq")
                return out
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from gptq_tpu_torch.config import resolve_device
    from gptq_tpu_torch.engine.decode import benchmark_decode
    from gptq_tpu_torch.io import load_checkpoint
    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.pipeline import quantize_lm_head

    device = resolve_device(args.device)
    if args.lut_bench:
        from gptq_tpu_torch.ops.kernel_bench import bench_kernels

        if device.type != "cuda":
            raise SystemExit("--lut_bench measures the card: it needs "
                             "--device cuda")
        bench_kernels(groupsize=max(args.groupsize, -1),
                      bits_list=((args.wbits,) if args.wbits < 16
                                 else (2, 3, 4, 8)))
        return 0
    if not args.load:
        raise SystemExit("gptq_tpu_torch.cli needs --load: quantizing from a "
                         "model directory is not ported yet (ROADMAP)")
    spec, params, loaded_cfg = load_checkpoint(args.load, device=device)
    print(f"loaded packed checkpoint {args.load}")
    quant = quant_fields(params, loaded_cfg)
    if args.quant_lm_head and quantize_lm_head(spec, params,
                                               bits=args.quant_lm_head):
        print(f"lm_head quantized to {args.quant_lm_head} bits")
    if args.benchmark:
        ids = np.random.default_rng(args.seed).integers(
            0, spec.vocab, size=(1, args.benchmark))
        if args.faster_kernel:
            params = fuse_serving(spec, params, a8=True)
            print("--faster-kernel: serving with dynamic int8 activations")
        cache_dtype = torch.int8 if args.int8_kv else torch.bfloat16
        r = benchmark_decode(spec, params, ids, check=args.check,
                             cache_dtype=cache_dtype)
        print(json.dumps({"benchmark": r, "quant": quant,
                          "device": str(device),
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
