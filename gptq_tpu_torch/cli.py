"""Load-and-serve command line (port of the --load / --benchmark path of
gptq_tpu/cli.py, with the same flag names):

    python -m gptq_tpu_torch.cli dummy c4 --load q.npz --benchmark 128 \
        --faster-kernel --int8_kv --quant_lm_head 8

    python -m gptq_tpu_torch.cli dummy c4 --lut_bench --groupsize 128

    python -m gptq_tpu_torch.cli dummy c4 --load q.npz --benchmark 128 \
        --faster-kernel --benchmark_batch 4

    torchrun --nproc-per-node 2 -m gptq_tpu_torch.cli dummy c4 \
        --load q.npz --benchmark 128 --faster-kernel --sp 2

Runs on the GPU (`--device cuda`, the default, raises without one).
`--lut_bench` prints the serving matmuls' latencies (ops/kernel_bench.py)
at the flags' groupsize (and --wbits, if below 16). The benchmark takes
the JAX CLI's protocol: `--benchmark_batch N` (N > 1) times the second of
two generate_chained runs of N sequences; otherwise the on-device
chained protocol (engine.decode.benchmark_decode_chained) when one
dispatch round trip costs more than 1 ms, else the per-token one. The
result line names the protocol and carries the loaded checkpoint's
quantization fields. GPTQ_TPU_LAYER_FUSION=on serves each decode layer
in one launch (csrc/layer_fused.cu). An MoE (Mixtral-style) checkpoint
serves the same way, its expert banks through csrc/qexpert.cu. `--sp N`
(N > 1, under torchrun with N processes: N must equal WORLD_SIZE) serves
through engine/serving.SPEngine, the KV cache sharded over the N ranks
(one CUDA device each, cuda:LOCAL_RANK; gloo on the CPU), with the
chained protocol; only rank 0 prints the result line, protocol
`chained-sp{N}`.
Quantizing from a model directory and the PPL evals over the HF datasets
are not ported yet (ROADMAP queue 1): serving needs --load.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

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
    p.add_argument("--benchmark_batch", type=int, default=1,
                   help="batched lock-step decode: N sequences through "
                        "generate_chained, tok/s over all of them")
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
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ways: long-context serving with "
                        "the KV cache sharded over N torchrun processes "
                        "(ring-attention prefill + SPCache decode). int8 "
                        "cache is the default at max_len >= 1024")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ways (not ported yet)")
    p.add_argument("--max_len", type=int, default=0,
                   help="serving cache capacity for --sp benchmarks "
                        "(default: benchmark length + headroom)")
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
    from gptq_tpu_torch.engine import decode
    from gptq_tpu_torch.io import load_checkpoint
    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.pipeline import quantize_lm_head

    if args.sp > 1 and args.ep > 1:
        raise SystemExit("--sp and --ep are separate serving engines; "
                         "pick one")
    if args.ep > 1:
        raise SystemExit("--ep: expert-parallel serving is not ported yet "
                         "(ROADMAP item 18, the rest)")
    device = resolve_device(args.device)
    if args.sp > 1:
        device = _sp_device(args.sp, device)
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
        if args.sp > 1:
            return _serve_sp(args, spec, params, ids, quant, device)
        if args.benchmark_batch > 1:
            # batched lock-step decode: weight reads amortise over the batch
            n, nb = args.benchmark, args.benchmark_batch
            eng = decode.DecodeEngine(spec, params, max_len=n + 8, batch=nb,
                                      cache_dtype=cache_dtype)
            prompt = np.tile(ids[:1, :1], (nb, 1))
            # the first run captures the chunks' graphs
            eng.generate_chained(prompt, max_new_tokens=n)
            t0 = time.perf_counter()
            eng.generate_chained(prompt, max_new_tokens=n)
            dt = time.perf_counter() - t0
            rate = n * nb / dt
            print(f"batch {nb}: {rate:.1f} tok/s ({dt / n * 1e3:.2f} ms/step "
                  f"incl dispatch)")
            r = {"tokens_per_s": rate, "step_s": dt / n, "batch": nb,
                 "n_tokens": n}
            protocol = f"batch{nb}"
        elif decode.measure_dispatch_rtt(reps=3, device=device) > 1e-3:
            print("dispatch RTT > 1ms: using on-device chained protocol")
            r = decode.benchmark_decode_chained(spec, params, ids,
                                                check=args.check,
                                                cache_dtype=cache_dtype)
            protocol = "chained"
        else:
            r = decode.benchmark_decode(spec, params, ids, check=args.check,
                                        cache_dtype=cache_dtype)
            protocol = "per-token"
        print(json.dumps({"benchmark": r, "protocol": protocol, "quant": quant,
                          "device": str(device),
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu")}))
    return 0


def _sp_device(sp: int, device: torch.device) -> torch.device:
    """This process's device under torchrun --nproc-per-node sp, and the
    default process group (nccl on CUDA, gloo on the CPU) if none is up."""
    import os

    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != sp:
        raise SystemExit(f"--sp {sp} runs under torchrun --nproc-per-node "
                         f"{sp}: WORLD_SIZE is {world}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return device


def _serve_sp(args, spec, params, ids, quant, device) -> int:
    """The --sp N benchmark: SPEngine's chained protocol on every rank;
    rank 0 prints the result line."""
    from gptq_tpu_torch.engine.serving import SPEngine

    max_len = args.max_len or args.benchmark + args.sp + 8
    eng = SPEngine(spec, params, sp=args.sp, max_len=max_len,
                   cache_dtype=torch.int8 if args.int8_kv else None,
                   fuse=True, a8=args.faster_kernel, device=device)
    r = eng.benchmark_chained(ids, check=args.check,
                              log=print if eng.rank == 0 else lambda s: None)
    if eng.rank == 0:
        print(json.dumps({"benchmark": r, "protocol": f"chained-sp{args.sp}",
                          "quant": quant, "device": str(device),
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
