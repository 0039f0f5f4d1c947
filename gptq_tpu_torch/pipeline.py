"""Sequential layer-by-layer GPTQ pipeline (port of the GPTQ path of
gptq_tpu/pipeline.py: solver_config_for, _layer_scan, quantize_model,
pack_model).

Per layer: run the block over every calibration sample, capture each
linear's input and fold it into that linear's Hessian, solve, write the
quantize-dequantized weight back, and replay the layer to get the next
layer's inputs. With true_sequential the Hessians of each sub-block group
are re-captured after the previous group is quantized.

The solver's `lut` mode (--lut_eval) fits BCQ alphas and pack_model
packs its sign planes for ops/bcq_matmul.py; the `nonlinear` and
`columnwise` modes write dense quantize-dequantized weights, which
pack_model leaves dense. A MixedPrecision (`mixed=`) gives each linear
its own bits and columnwise flag, and pack_model packs each linear at the
bits its quantizer records. The Hessian-free modes
(--nearest: uniform RTN, --bcq: whole-weight BCQ) write dense weights
and skip the calibration capture. quantize_lm_head packs the output
projection (per-channel RTN; a tied head from the embedding table) for
the fused head. On an MoE model the
attention linears quantize here and the expert stacks through
models/moe.gptq_quantize_experts. With `resume_dir`, quantize_model keeps
a journal of finished layers and an interrupted run restarts at the first
unfinished one. A model converted with params_from_dir(host=True) keeps
its blocks' linear weights in CPU memory; quantize_model then stages one
block at a time onto the calibration device and writes the quantized
weights back to the host (the JAX package's offload branch), and
pack_model packs one linear at a time onto the device, so neither the
dense model nor more than one dense block ever lies on the card.
add_actquant fits the per-input-feature activation quantizers that
models/common.linear_apply fake-quantizes each linear's input with.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from gptq_tpu_torch.config import MixedPrecision, QuantConfig
from gptq_tpu_torch.models.common import (ArchSpec, block_forward, build_mask,
                                          embed_forward, rope_tables)
from gptq_tpu_torch.models.registry import get_arch
from gptq_tpu_torch.ops.pack import PackedWeight, pack_bcq, pack_quantized
from gptq_tpu_torch.quant.bcq import bcq_quantize
from gptq_tpu_torch.quant.gptq import (SolverConfig, gptq_quantize,
                                       hessian_init, hessian_update)
from gptq_tpu_torch.quant.rtn import bcq_rtn_weight, rtn_quantize_weight
from gptq_tpu_torch.quant.uniform import find_params, quantize_uniform


def solver_config_for(cfg: QuantConfig, bits: int,
                      columnwise: bool | None = None) -> SolverConfig:
    """Map the CLI surface onto a SolverConfig. Under --layermix /
    --linearmix the non-linear grid's hyper grid is 2 bits wider than the
    linear's own bits (not under --quant_config)."""
    columnwise = cfg.columnwise if columnwise is None else columnwise
    if cfg.non_linear:
        mode = "nonlinear"
    elif columnwise:
        mode = "columnwise"
    elif cfg.lut_eval:
        mode = "lut"
    else:
        mode = "uniform"
    return SolverConfig(mode=mode, bits=bits, blocksize=cfg.blocksize,
                        percdamp=cfg.percdamp, groupsize=cfg.groupsize,
                        actorder=cfg.act_order,
                        static_groups=cfg.static_groups, sym=cfg.sym,
                        trits=cfg.trits, mse=cfg.mse,
                        bcq_rounds=cfg.bcq_round, use_bst=cfg.use_bst,
                        apot_nums=cfg.apot_nums,
                        hyperbits=(bits + 2 if cfg.layermix or cfg.linearmix
                                   else cfg.hyperbits),
                        explore_bits=cfg.exploreBits,
                        explore_split=cfg.exploreSplit)


@torch.no_grad()
def _layer_scan(spec: ArchSpec, bp: dict, inps: torch.Tensor, positions,
                mask, names: tuple, capture: bool = True):
    """Run one block over every calibration sample: returns (outs,
    Hessian states per linear name). inps: (nsamples, T, hidden)."""
    arch = get_arch(spec.arch)
    rope = rope_tables(spec, positions)
    hstates = {n: hessian_init(bp[arch.linears[n]]["w"].shape[1],
                               device=inps.device) for n in names}
    outs = torch.empty_like(inps)
    for j in range(inps.shape[0]):
        out, _, caps = block_forward(spec, bp, inps[j:j + 1],
                                     positions=positions, mask=mask,
                                     capture=capture and bool(names),
                                     rope=rope)
        outs[j] = out[0]
        if capture and names:
            seen = {}
            for n in names:
                # q/k/v (and gate/up) share one input: fold it once
                key = id(caps[n])
                if key in seen:
                    hstates[n] = seen[key]
                else:
                    hstates[n] = seen[key] = hessian_update(hstates[n], caps[n])
    return outs, hstates


@dataclass
class QuantResult:
    quantizers: dict  # module path -> dict of packing params
    losses: dict      # module path -> float proxy loss
    times: dict


@torch.no_grad()
def quantize_model(spec: ArchSpec, params: dict, calib_ids: torch.Tensor,
                   cfg: QuantConfig, mixed: MixedPrecision | None = None,
                   log: Callable[[str], None] = print,
                   resume_dir: str | None = None) -> QuantResult:
    """Quantize every per-block linear in place (params mutated) with GPTQ,
    or with the Hessian-free RTN (cfg.nearest) / whole-weight BCQ
    (cfg.bcq) modes. `mixed` sets each linear's bits and columnwise flag
    (MixedPrecision.bits_for / columnwise_for of the layer index and the
    HF linear name); without it every linear takes cfg.wbits and
    cfg.columnwise.

    calib_ids: (nsamples, seqlen) token ids on the params' device. With
    `resume_dir`, each finished layer is journaled there (_resume_save)
    and the layers already journaled are restored and replayed to rebuild
    the next layer's inputs, so an interrupted run restarts at the first
    unfinished layer."""
    arch = get_arch(spec.arch)
    nsamples, T = calib_ids.shape
    dev = calib_ids.device
    positions = torch.arange(T, device=dev)[None]
    mask = build_mask(spec, T, T, dev)
    inps = torch.stack([embed_forward(spec, params, calib_ids[j:j + 1],
                                      positions)[0]
                        for j in range(nsamples)])

    if cfg.true_sequential:
        groups = [tuple(g) for g in arch.seq_groups]
    else:
        groups = [tuple(arch.linears.keys())]
    quantizers: dict[str, Any] = {}
    losses: dict[str, float] = {}
    times: dict[str, float] = {}

    start = 0
    if resume_dir is not None:
        start = _resume_load(resume_dir, spec, params, quantizers, losses,
                             log)
        for i in range(start):
            host_bp = params["layers"][i]
            bp = (_stage(host_bp, arch, dev) if _host_block(host_bp, arch, dev)
                  else host_bp)
            inps, _ = _layer_scan(spec, bp, inps, positions, mask, (),
                                  capture=False)
            del bp

    for i, host_bp in enumerate(params["layers"]):
        if i < start:
            continue
        t_layer = time.time()
        # a host-resident block streams: staged onto the device for this
        # layer's work, its quantized weights written back to the host
        offload = _host_block(host_bp, arch, dev)
        bp = _stage(host_bp, arch, dev) if offload else host_bp
        for names in groups:
            # only the linears this layer has: an MoE layer carries router /
            # experts instead of gate / up / down (models/moe.py quantizes
            # those: gptq_quantize_experts)
            names = tuple(n for n in names if arch.linears[n] in bp)
            if not names:
                continue
            if cfg.nearest or cfg.bcq:
                hstates = {}  # Hessian-free: no capture
            else:
                _, hstates = _layer_scan(spec, bp, inps, positions, mask,
                                         names)
            for name in names:
                key = arch.linears[name]
                W = bp[key]["w"]
                full_name = f"{arch.hf_prefix}.{i}.{name}"
                bits, columnwise = cfg.wbits, cfg.columnwise
                if mixed is not None:
                    bits = mixed.bits_for(i, name, bits)
                    columnwise = mixed.columnwise_for(i, name, columnwise)
                t0 = time.time()
                if cfg.nearest or cfg.bcq:
                    if cfg.nearest:
                        mode, bp[key]["w"] = "rtn", rtn_quantize_weight(
                            W, bits, sym=cfg.sym, mse=cfg.mse,
                            groupsize=cfg.groupsize)
                    else:
                        mode, bp[key]["w"] = "bcq_rtn", bcq_rtn_weight(
                            W, bits, rounds=cfg.bcq_round,
                            groupsize=cfg.groupsize,
                            apot_nums=cfg.apot_nums, use_bst=cfg.use_bst)
                    quantizers[full_name] = {"mode": mode, "bits": bits}
                    times[full_name] = time.time() - t0
                    continue
                scfg = solver_config_for(cfg, bits, columnwise)
                H, _, mean_input = hstates[name]
                out = gptq_quantize(W, H, scfg, mean_input)
                bp[key]["w"] = out["Q"].to(W.dtype)
                losses[full_name] = float(out["loss"])
                q = {"mode": scfg.mode, "bits": bits,
                     "groupsize": cfg.groupsize,
                     "perm": out["perm"] if scfg.actorder else None}
                for f in ("scale", "zero", "alpha"):
                    if f in out:
                        q[f] = out[f]
                quantizers[full_name] = q
                times[full_name] = time.time() - t0
                log(f"layer {i} {name}: loss={losses[full_name]:.1f} "
                    f"t={times[full_name]:.2f}s")
        # replay with quantized weights -> inputs for the next layer
        inps, _ = _layer_scan(spec, bp, inps, positions, mask, (),
                              capture=False)
        if offload:
            for key in _linear_keys(host_bp, arch):
                host_bp[key]["w"] = bp[key]["w"].to(
                    host_bp[key]["w"].device)
        bp = W = out = None  # the staged copies go with the layer
        times[f"layer{i}"] = time.time() - t_layer
        log(f"layer {i} done in {times[f'layer{i}']:.2f}s")
        if resume_dir is not None:
            _resume_save(resume_dir, i, host_bp, quantizers, losses, arch)
    return QuantResult(quantizers=quantizers, losses=losses, times=times)


def _linear_keys(bp: dict, arch) -> list:
    """The keys of the linears block bp has (an MoE block has no gate / up
    / down)."""
    return [key for key in arch.linears.values() if key in bp]


def _host_block(bp: dict, arch, dev) -> bool:
    """Whether block bp's linear weights lie off the calibration device
    `dev` (params_from_dir(host=True) keeps them in CPU memory)."""
    return any(bp[key]["w"].device != dev for key in _linear_keys(bp, arch))


def _stage(bp: dict, arch, dev) -> dict:
    """A copy of block bp for one layer's work: each linear's weight
    copied onto `dev`, every other leaf shared."""
    staged = dict(bp)
    for key in _linear_keys(bp, arch):
        staged[key] = {**bp[key], "w": bp[key]["w"].to(dev)}
    return staged


def _resume_save(resume_dir: str, i: int, bp: dict, quantizers: dict,
                 losses: dict, arch) -> None:
    """Journal finished layer i as `layer_{i}.npz` (written to a .tmp file,
    then renamed): its linears' quantized weights, its quantizers' arrays
    and, in a JSON entry, their other fields and the losses. numpy arrays
    only: nothing is pickled."""
    os.makedirs(resume_dir, exist_ok=True)
    prefix = f"{arch.hf_prefix}.{i}."
    arrays = {f"w/{key}": bp[key]["w"].detach().cpu().numpy()
              for key in arch.linears.values() if key in bp}
    meta = {"quantizers": {}, "losses": {k: v for k, v in losses.items()
                                         if k.startswith(prefix)}}
    for name, q in quantizers.items():
        if not name.startswith(prefix):
            continue
        meta["quantizers"][name] = {
            f: v for f, v in q.items() if not isinstance(v, torch.Tensor)}
        for f, v in q.items():
            if isinstance(v, torch.Tensor):
                arrays[f"q/{name}/{f}"] = v.detach().cpu().numpy()
    arrays["meta"] = np.array(json.dumps(meta))
    path = os.path.join(resume_dir, f"layer_{i}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)


def _resume_load(resume_dir: str, spec: ArchSpec, params: dict,
                 quantizers: dict, losses: dict, log) -> int:
    """Restore the journaled layers 0, 1, ... into params, quantizers and
    losses; returns the first layer not journaled."""
    i = 0
    while os.path.exists(path := os.path.join(resume_dir,
                                              f"layer_{i}.npz")):
        bp = params["layers"][i]
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            for name in z.files:
                if name.startswith("w/"):
                    w = bp[name[2:]]["w"]
                    bp[name[2:]]["w"] = torch.from_numpy(z[name]).to(
                        device=w.device, dtype=w.dtype)
            dev = params["embed"]["tokens"].device
            for qname, q in meta["quantizers"].items():
                q = dict(q)
                for name in z.files:
                    if name.startswith(f"q/{qname}/"):
                        q[name.rsplit("/", 1)[1]] = torch.from_numpy(
                            z[name]).to(dev)
                quantizers[qname] = q
        losses.update(meta["losses"])
        i += 1
    if i:
        log(f"resumed: layers 0..{i - 1} already quantized")
    return i


@torch.no_grad()
def add_actquant(spec: ArchSpec, params: dict, calib_ids: torch.Tensor,
                 bits: int, sym: bool = False) -> None:
    """Fit per-input-feature activation quantizers for every block linear
    from the first calibration sample's inputs (find_params with
    weight=False): each linear gets {scale, zero, maxq} under "act_q",
    and linear_apply fake-quantizes its input with them thereafter. Each
    layer's inputs come from replaying the layers before it with their
    quantizers on."""
    arch = get_arch(spec.arch)
    nsamples, T = calib_ids.shape
    dev = calib_ids.device
    positions = torch.arange(T, device=dev)[None]
    mask = build_mask(spec, T, T, dev)
    inps = torch.stack([embed_forward(spec, params, calib_ids[j:j + 1],
                                      positions)[0]
                        for j in range(nsamples)])
    maxq = (1 << bits) - 1
    for bp in params["layers"]:
        _, _, caps = block_forward(spec, bp, inps[:1], positions=positions,
                                   mask=mask, capture=True,
                                   rope=rope_tables(spec, positions))
        for name, key in arch.linears.items():
            if key not in bp:
                continue
            p = find_params(caps[name], bits=bits, perchannel=True, sym=sym,
                            weight=False)
            bp[key]["act_q"] = {"scale": p.scale[0], "zero": p.zero[0],
                                "maxq": maxq}
        inps, _ = _layer_scan(spec, bp, inps, positions, mask, (),
                              capture=False)


def pack_model(spec: ArchSpec, params: dict, quantizers: dict,
               cfg: QuantConfig, tp: int = 1) -> dict:
    """Swap quantized dense linears for PackedWeights, each at the bits its
    quantizer records: uniform grids pack to byteplane fields, the lut
    mode's BCQ to sign planes (the signs recovered against the solver's
    alphas). Linears without an entry, and those of the RTN / whole-
    weight BCQ / non-linear / columnwise modes, stay dense (where they
    are). Each linear is packed on the model's device (the
    embedding's), one at a time: a host-resident weight of an offloaded
    model is copied there alone, so its packed leaves land on the card and
    the dense model never does. `tp` pads the stored dims so that the
    tensor-parallel ranks slice them on subblock boundaries
    (parallel/tp.py)."""
    arch = get_arch(spec.arch)
    dev = params["embed"]["tokens"].device
    for i, bp in enumerate(params["layers"]):
        for name, key in arch.linears.items():
            q = quantizers.get(f"{arch.hf_prefix}.{i}.{name}")
            if q is None:
                continue
            W = bp[key]["w"].to(device=dev, dtype=torch.float32)
            gs = q.get("groupsize", -1)
            if q["mode"] == "uniform" and q["bits"] in (1, 2, 3, 4, 8):
                bp[key]["w"] = pack_quantized(
                    W, q["scale"], q["zero"], q["bits"], groupsize=gs,
                    perm=q.get("perm"), actorder=q.get("perm") is not None,
                    tp=tp)
            elif q["mode"] == "lut":
                _, B = bcq_quantize(W, q["alpha"], groupsize=gs)
                bp[key]["w"] = pack_bcq(B, q["alpha"], groupsize=gs, tp=tp)
    return params


def quantize_lm_head(spec: ArchSpec, params: dict, bits: int = 8,
                     tp: int = 1) -> bool:
    """Quantize the output projection in place: per-channel RTN (the head
    has no calibration Hessian in the sequential pipeline), packed with
    groupsize -1 for the fused head kernel. A tied head (lm_head None:
    BLOOM, Gemma, an OPT directory without lm_head.weight) gets a packed
    lm_head of its own from the embedding table, which the embedding
    keeps dense; the JAX package leaves a tied head dense. A no-op
    (returns False) for a head that is already packed. `tp` pads as
    pack_model's does."""
    lm = params.get("lm_head")
    if lm is None:
        lm = params["lm_head"] = {"w": params["embed"]["tokens"], "b": None}
    if lm.get("w") is None or isinstance(lm["w"], PackedWeight):
        return False
    W = lm["w"].to(torch.float32)  # (vocab, hidden)
    p = find_params(W, bits=bits, perchannel=True, weight=True)
    Q = quantize_uniform(W, p.scale, p.zero, (1 << bits) - 1)
    lm["w"] = pack_quantized(Q, p.scale.reshape(1, -1), p.zero.reshape(1, -1),
                             bits, groupsize=-1, tp=tp)
    return True
