"""Command line (port of gptq_tpu/cli.py, with the same flag names and
defaults): quantize from a model directory, save, evaluate, serve.

    python -m gptq_tpu_torch.cli /models/llama-7b c4 --wbits 4 \
        --groupsize 128 --act-order --true-sequential --save q.npz

    python -m gptq_tpu_torch.cli /models/llama-7b c4 --wbits 3 \
        --groupsize 128 --lut_eval --eval_pack

    python -m gptq_tpu_torch.cli dummy c4 --load q.npz --benchmark 128 \
        --faster-kernel --int8_kv --quant_lm_head 8

    python -m gptq_tpu_torch.cli /models/opt-6.7b c4 --wbits 4 \
        --layermix --save q.npz

    python -m gptq_tpu_torch.cli /models/llama-7b c4 --wbits 3 --analyse
    python -m gptq_tpu_torch.cli /models/llama-7b c4 --wbits 3 \
        --quant_config results/quant_config.json --eval_pack

    python -m gptq_tpu_torch.cli dummy c4 --lut_bench --groupsize 128

    torchrun --nproc-per-node 2 -m gptq_tpu_torch.cli dummy c4 \
        --load q.npz --benchmark 128 --faster-kernel --sp 2

Runs on the GPU (`--device cuda`, the default, raises without one).

Quantize: without --load, the model is an HF checkpoint directory of
OPT, BLOOM, llama / Mixtral or Gemma, a Meta llama directory or a raw
Gemma .ckpt (models/convert.params_from_dir; GPTQ_TPU_CKPT_DIR maps a hub
id to a local directory). With --wbits < 16 (or --trits) the
calibration windows of `dataset` (data.get_loaders) go through
pipeline.quantize_model: GPTQ (uniform grids; --lut_eval: the solver's
BCQ lut mode; --columnwise: APoT BCQ re-fit every 8 columns; --non_linear
with --hyperbits / --exploreBits / --exploreSplit: the non-uniform
codebook grid), or --nearest (RTN) or --bcq (whole-weight BCQ). Mixed
precision gives each linear its own bits: --layermix (bits per layer of
the model's row in configs/layerwise.json), --linearmix (bits per linear
type, configs/linearwise.json) or --quant_config FILE (per module path
{bits, columnwise}); the tables are read from a local quant_bit/, then a
local configs/, then the repository's configs/ (_cfg_path). --analyse
runs the sensitivity analysis instead (analysis.analyse_model), writes
the derived per-module config to results/quant_config.json under the
working directory and exits. --eval_pack or --save packs the weights,
each linear at its own bits (sign planes for --lut_eval; the columnwise
and non-linear modes stay dense), and --quant_lm_head then packs the
head (a tied head from the embedding table, which the
JAX CLI leaves dense); --quant_experts quantizes a Mixtral model's expert
stacks. --save writes the checkpoint (io.save_checkpoint, readable by
both packages). Then the PPL of wikitext2, ptb and c4 (or --new-eval's
ptb-new / c4-new) is appended to --results_log, in the JAX CLI's line.

The tokenizer is the model directory's own, loaded from local files
only (load_tokenizer): this module never contacts a hub. A --load
--benchmark run goes on without one and skips the PPL evals.

Serve: --load takes a packed checkpoint. `--lut_bench` prints the
serving matmuls' latencies (ops/kernel_bench.py) at the flags'
groupsize (and --wbits, if below 16). The benchmark takes the JAX CLI's
protocol: `--benchmark_batch N` (N > 1) times the second of two
generate_chained runs of N sequences; otherwise the on-device chained
protocol (engine.decode.benchmark_decode_chained) when one dispatch round
trip costs more than 1 ms, else the per-token one. The result line names
the protocol and carries the loaded checkpoint's quantization fields.
GPTQ_TPU_LAYER_FUSION=on serves each decode layer in one launch
(csrc/layer_fused.cu). An MoE (Mixtral-style) checkpoint serves the same
way, its expert banks through csrc/qexpert.cu. `--sp N` (N > 1, under
torchrun with N processes: N must equal WORLD_SIZE) serves through
engine/serving.SPEngine, the KV cache sharded over the N ranks (one CUDA
device each, cuda:LOCAL_RANK; gloo on the CPU), with the chained
protocol; only rank 0 prints the result line, protocol `chained-sp{N}`.

Flags of pieces not ported yet exit with the ROADMAP item that holds
them: --task (item 14), --tp > 1 and --ep > 1 (item 18).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gptq_tpu_torch")
    p.add_argument("model", type=str,
                   help="HF checkpoint directory (or, with --load, a name "
                        "for the logs)")
    p.add_argument("dataset", type=str, nargs="?", default="c4",
                   choices=["wikitext2", "ptb", "c4", "ptb-new", "c4-new"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--nearest", action="store_true")
    p.add_argument("--wbits", type=int, default=16,
                   choices=[1, 2, 3, 4, 8, 16])
    p.add_argument("--trits", action="store_true")
    p.add_argument("--groupsize", type=int, default=-1)
    p.add_argument("--sym", action="store_true")
    p.add_argument("--save", type=str, default="")
    p.add_argument("--load", type=str, default="")
    p.add_argument("--benchmark", type=int, default=0)
    p.add_argument("--benchmark_batch", type=int, default=1,
                   help="batched lock-step decode: N sequences through "
                        "generate_chained, tok/s over all of them")
    p.add_argument("--check", action="store_true")
    p.add_argument("--new-eval", action="store_true")
    p.add_argument("--faster-kernel", action="store_true")
    p.add_argument("--act-order", action="store_true")
    p.add_argument("--static-groups", action="store_true")
    p.add_argument("--true-sequential", action="store_true")
    p.add_argument("--load_weights", type=str, default="")
    p.add_argument("--load_safetensor", type=str, default="")
    p.add_argument("--bcq", action="store_true")
    p.add_argument("--lut_bench", action="store_true",
                   help="time the serving matmuls (uniform and BCQ) at "
                        "llama-7B width and exit")
    p.add_argument("--quant_lm_head", type=int, default=0, metavar="BITS",
                   help="also quantize the output projection (RTN, e.g. 8); "
                        "the fused route serves it with the norm in one "
                        "launch")
    p.add_argument("--quant_experts", default="none",
                   choices=["none", "rtn", "gptq"],
                   help="quantize MoE expert stacks (Mixtral-style models): "
                        "rtn = calibration-free grids; gptq = per-expert "
                        "Hessians from dispatched calibration slots first "
                        "(models/moe.py). Storage format from --expert_bits")
    p.add_argument("--expert_bits", type=int, default=8,
                   choices=[2, 3, 4, 8],
                   help="expert storage width for --quant_experts: 8 = "
                        "int8 codes + per-row scales; 2/3/4 = sub-byte "
                        "PackedExperts banks (csrc/qexpert.cu)")
    p.add_argument("--int8_kv", action="store_true",
                   help="serve with the int8 KV cache (per-token-head "
                        "scales; the decode-attention kernel reads it "
                        "directly)")
    p.add_argument("--lut_eval", action="store_true")
    p.add_argument("--bcq_round", type=int, default=5)
    p.add_argument("--columnwise", action="store_true")
    p.add_argument("--use_bst", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--apot_nums", type=int, default=2)
    p.add_argument("--non_linear", action="store_true")
    p.add_argument("--hyperbits", type=int, default=5)
    p.add_argument("--exploreBits", type=int, default=1)
    p.add_argument("--exploreSplit", type=int, default=20)
    p.add_argument("--linearmix", action="store_true")
    p.add_argument("--layermix", action="store_true")
    p.add_argument("--quant_config", type=str, default="")
    p.add_argument("--task", type=str, default="")
    p.add_argument("--analyse", action="store_true")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("GPTQ_TPU_DATA_DIR", ""),
                   help="local datasets cache for offline runs "
                        "(default: $GPTQ_TPU_DATA_DIR)")
    p.add_argument("--eval_pack", action="store_true",
                   help="pack weights and evaluate through the serving "
                        "kernels")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (not ported yet)")
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
    p.add_argument("--results_log", type=str, default="results/ppl.txt")
    p.add_argument("--device", type=str, default="cuda")
    return p


def config_from_args(args):
    from gptq_tpu_torch.config import QuantConfig

    return QuantConfig(
        wbits=args.wbits, trits=args.trits, groupsize=args.groupsize,
        sym=args.sym, percdamp=args.percdamp, act_order=args.act_order,
        static_groups=args.static_groups, true_sequential=args.true_sequential,
        nearest=args.nearest, dataset=args.dataset, nsamples=args.nsamples,
        seed=args.seed, lut_eval=args.lut_eval, columnwise=args.columnwise,
        bcq_round=args.bcq_round, use_bst=args.use_bst,
        apot_nums=args.apot_nums, bcq=args.bcq, non_linear=args.non_linear,
        hyperbits=args.hyperbits, exploreBits=args.exploreBits,
        exploreSplit=args.exploreSplit, layermix=args.layermix,
        linearmix=args.linearmix,
        quant_config=args.quant_config or None,
        save=args.save or None, load=args.load or None,
        benchmark=args.benchmark, check=args.check,
        faster_kernel=args.faster_kernel, new_eval=args.new_eval,
    )


def _cfg_path(name: str) -> str:
    """A mixed-precision table: a local quant_bit/ (the reference's
    layout), then a local configs/, then the repository's configs/."""
    for cand in (os.path.join("quant_bit", name), os.path.join("configs", name),
                 os.path.join(os.path.dirname(os.path.dirname(
                     os.path.abspath(__file__))), "configs", name)):
        if os.path.exists(cand):
            return cand
    return name


def load_mixed_precision(args, model_name: str):
    """The MixedPrecision of --quant_config / --layermix / --linearmix (in
    that order of precedence), or None. A --layermix model missing from
    layerwise.json exits with the names the table has."""
    from gptq_tpu_torch.config import MixedPrecision

    if args.quant_config:
        with open(args.quant_config) as f:
            return MixedPrecision(module_config=json.load(f))
    if args.layermix:
        with open(_cfg_path("layerwise.json")) as f:
            table = json.load(f)
        name = model_name.rstrip("/").split("/")[-1]
        if name not in table:
            raise SystemExit(f"--layermix: no per-layer bits for {name!r} in "
                             f"layerwise.json; it has {', '.join(table)}")
        return MixedPrecision(layer_bits=table[name])
    if args.linearmix:
        with open(_cfg_path("linearwise.json")) as f:
            return MixedPrecision(linear_bits=json.load(f))
    return None


def append_result_log(path: str, args, ppl: float, dataset: str,
                      protocol: str = "eval") -> None:
    """The JAX CLI's result line, character for character."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    line = (f"model = {args.model.split('/')[-1]}, dataset = {dataset}, "
            f"wbits = {args.wbits}, groupsize = {args.groupsize}, "
            f"lut = {args.lut_eval}, nonLinear = {args.non_linear}, "
            f"columnwise = {args.columnwise}, protocol = {protocol}"
            f"   :   {ppl}")
    if args.non_linear:  # only a loaded checkpoint sets these
        line += (f"  ||  hyperbits = {args.hyperbits}, exploreBits = "
                 f"{args.exploreBits}, exploreSplit = {args.exploreSplit}")
    if args.lut_eval or args.columnwise:
        line += (f"  ||  bcq_round = {args.bcq_round}  ||  apot_nums = "
                 f"{args.apot_nums} use_bst = {args.use_bst}")
    with open(path, "a") as f:
        f.write(line + "\n")


def refuse_unported(args) -> None:
    """Exit with the ROADMAP item of a flag whose piece is not ported."""
    if args.sp > 1 and args.ep > 1:
        raise SystemExit("--sp and --ep are separate serving engines; "
                         "pick one")
    for on, what, item in (
            (args.ep > 1, "--ep: expert-parallel serving", "18, the rest"),
            (args.tp > 1, "--tp: tensor-parallel serving", "18, the rest"),
            (args.task, "--task: the zero-shot harness", "14")):
        if on:
            raise SystemExit(f"{what} is not ported yet (ROADMAP item "
                             f"{item})")


def load_tokenizer(model: str, required: bool = True):
    """The model's tokenizer (transformers' AutoTokenizer, slow variant, as
    the JAX CLI loads it), from local files only: the checkpoint
    directory or the HF cache. Without one, a run that needs it raises;
    one that does not (`required=False`) gets None."""
    from gptq_tpu_torch.models.convert import resolve_model_path

    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            resolve_model_path(model), use_fast=False, local_files_only=True)
    except (ImportError, OSError, ValueError) as e:
        if required:
            raise
        print(f"tokenizer unavailable ({type(e).__name__}); benchmark-only "
              f"run continues, PPL evals skipped")
        return None


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


# the loaded checkpoint's fields that the result line reports
LOADED_FIELDS = ("wbits", "groupsize", "lut_eval", "columnwise", "non_linear",
                 "trits", "sym", "hyperbits", "exploreBits", "exploreSplit",
                 "bcq_round", "apot_nums", "use_bst")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from gptq_tpu_torch.config import resolve_device

    refuse_unported(args)
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
    from gptq_tpu_torch.data import get_loaders
    from gptq_tpu_torch.eval.ppl import eval_ppl
    from gptq_tpu_torch.io import load_checkpoint, save_checkpoint
    from gptq_tpu_torch.pipeline import quantize_lm_head

    cfg = config_from_args(args)
    quant = None
    if args.load:
        spec, params, loaded_cfg = load_checkpoint(args.load, device=device)
        print(f"loaded packed checkpoint {args.load}")
        quant = quant_fields(params, loaded_cfg)
        # the result lines carry the checkpoint's quantization, not this
        # invocation's defaults
        for f in LOADED_FIELDS:
            if loaded_cfg is not None and hasattr(loaded_cfg, f):
                setattr(args, f, getattr(loaded_cfg, f))
            elif loaded_cfg is None and f in quant:
                setattr(args, f, quant[f])
        if args.quant_lm_head and quantize_lm_head(spec, params,
                                                   bits=args.quant_lm_head):
            print(f"lm_head quantized to {args.quant_lm_head} bits")
    else:
        spec, params = _convert(args, device)

    tokenizer = load_tokenizer(args.model,
                               required=not (args.benchmark and args.load))
    seqlen = spec.max_pos

    if args.analyse:
        from gptq_tpu_torch.analysis import analyse_model, derive_quant_config

        calib, _ = get_loaders(args.dataset, nsamples=args.nsamples,
                               seed=args.seed, seqlen=seqlen,
                               tokenizer=tokenizer,
                               data_dir=args.data_dir or None)
        t0 = time.perf_counter()
        st = analyse_model(spec, params, torch.as_tensor(calib, device=device))
        print(f"analysed in {time.perf_counter() - t0:.2f}s")
        qc = derive_quant_config(st, bits=args.wbits,
                                 out_path="results/quant_config.json")
        print(json.dumps(qc, indent=2))
        return 0

    if args.quant_experts != "none":
        # fail loudly on configs the flag cannot act on
        if args.load:
            raise SystemExit("--quant_experts has no effect with --load "
                             "(the checkpoint already fixes its expert "
                             "format); quantize before saving")
        if not spec.n_experts:
            raise SystemExit(f"--quant_experts: {args.model} has no MoE "
                             f"expert stacks (n_experts == 0)")
        if args.quant_experts == "gptq" and not (args.wbits < 16
                                                 or args.trits):
            raise SystemExit("--quant_experts gptq needs the calibration "
                             "pass: set --wbits < 16 (use rtn for "
                             "calibration-free int8 experts)")

    if not args.load and (args.wbits < 16 or args.trits):
        _quantize(args, cfg, spec, params, tokenizer, seqlen, device)
    if args.quant_experts != "none":
        from gptq_tpu_torch.models import moe

        if args.expert_bits < 8:
            moe.pack_experts(params, bits=args.expert_bits,
                             groupsize=args.groupsize)
            print(f"expert stacks packed ({args.quant_experts} -> "
                  f"{args.expert_bits}-bit byteplane banks)")
        else:
            moe.quantize_experts(params, bits=8)
            print(f"expert stacks quantized ({args.quant_experts} -> int8 "
                  f"codes + per-row scales)")

    if args.save and not args.load:
        t0 = time.perf_counter()
        save_checkpoint(args.save, spec, params, cfg)
        print(f"saved {args.save} in {time.perf_counter() - t0:.2f}s")

    datasets = ["wikitext2", "ptb", "c4"]
    if args.new_eval:
        datasets = ["wikitext2", "ptb-new", "c4-new"]
    for ds in datasets if tokenizer is not None else []:
        try:
            _, testenc = get_loaders(ds, seed=args.seed, seqlen=seqlen,
                                     tokenizer=tokenizer,
                                     data_dir=args.data_dir or None)
        except Exception as e:  # noqa: BLE001 -- a missing set is skipped
            print(f"skipping {ds}: {type(e).__name__}: {e}")
            continue
        t0 = time.perf_counter()
        ppl = eval_ppl(spec, params, testenc.input_ids, seqlen)
        print(f"{ds}: ppl {ppl} in {time.perf_counter() - t0:.2f}s")
        append_result_log(args.results_log, args, ppl, ds)

    if args.benchmark:
        _benchmark(args, spec, params, quant or quant_fields(params, cfg),
                   device)
    return 0


def _convert(args, device):
    """(spec, params) of the model directory, with the --load_weights /
    --load_safetensor overlay of fine-tuned weights."""
    from gptq_tpu_torch.models import convert

    t0 = time.perf_counter()
    spec, params = convert.params_from_dir(args.model, device=device)
    print(f"converted {args.model} in {time.perf_counter() - t0:.2f}s")
    src = args.load_safetensor or args.load_weights
    if src:
        if src.endswith(".safetensors"):
            sd = convert.read_safetensors(src)
        else:
            sd = torch.load(src, map_location="cpu", weights_only=True)
        params = convert.params_from_state_dict(sd, spec, device=device)
        print(f"loaded fine-tuned weights from {src}")
    return spec, params


def _quantize(args, cfg, spec, params, tokenizer, seqlen, device) -> None:
    """Calibrate and quantize in place; pack (and quantize the head) for
    --eval_pack / --save; GPTQ the experts for --quant_experts gptq."""
    from gptq_tpu_torch.data import get_loaders
    from gptq_tpu_torch.pipeline import (pack_model, quantize_lm_head,
                                         quantize_model)

    t0 = time.perf_counter()
    calib, _ = get_loaders(args.dataset, nsamples=args.nsamples,
                           seed=args.seed, seqlen=seqlen, tokenizer=tokenizer,
                           data_dir=args.data_dir or None)
    calib = torch.as_tensor(calib, device=device)
    print(f"calibration set {tuple(calib.shape)} in "
          f"{time.perf_counter() - t0:.2f}s")
    mixed = load_mixed_precision(args, args.model)
    t0 = time.perf_counter()
    res = quantize_model(spec, params, calib, cfg, mixed=mixed)
    print(f"quantization done in {time.perf_counter() - t0:.1f}s")
    if args.quant_experts == "gptq":
        from gptq_tpu_torch.models.moe import gptq_quantize_experts

        gptq_quantize_experts(spec, params, calib, cfg, log=print,
                              keep_grids=args.expert_bits < 8)
    if args.eval_pack or args.save:
        t0 = time.perf_counter()
        pack_model(spec, params, res.quantizers, cfg)
        print(f"packed in {time.perf_counter() - t0:.2f}s")
        if args.quant_lm_head and quantize_lm_head(spec, params,
                                                   bits=args.quant_lm_head):
            print(f"lm_head quantized to {args.quant_lm_head} bits")


def _benchmark(args, spec, params, quant, device) -> None:
    """The decode benchmark; prints one JSON result line."""
    from gptq_tpu_torch.engine import decode
    from gptq_tpu_torch.models.common import fuse_serving

    ids = np.random.default_rng(args.seed).integers(
        0, spec.vocab, size=(1, args.benchmark))
    if args.faster_kernel:
        params = fuse_serving(spec, params, a8=True)
        print("--faster-kernel: serving with dynamic int8 activations")
    cache_dtype = torch.int8 if args.int8_kv else torch.bfloat16
    if args.sp > 1:
        _serve_sp(args, spec, params, ids, quant, device)
        return
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


def _serve_sp(args, spec, params, ids, quant, device) -> None:
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


if __name__ == "__main__":
    sys.exit(main())
