#!/usr/bin/env python3
"""Quantization time of one llama-7B-width layer by solver mode, in two
checkouts of this repo, side by side on one CUDA card.

    python3 scripts/quant_times.py A_DIR B_DIR [--out FILE]

For each checkout, in a process of its own and in the order A, B, B, A:
one llama-7B-width layer (models.common.init_params, seed 0, f32 on the
card) quantized by pipeline.quantize_model on 16 x 512 seeded synthetic
tokens in each mode the checkout has: uniform (w4 g128 act-order
true-sequential, chip_smoke's quantize phase), lut (BCQ 3-bit g128),
non-linear (w3, the codebook grid), columnwise (w3 APoT re-fit every 8
columns), linearwise mixed bits (configs/linearwise.json) and the
sensitivity analysis of the layer (analysis.analyse_model). Each reading
is the layer's wall time in s (the calibration capture, the solves and
the replay). Each mode's quantized weights are hashed (" bits"); every
mode that the first checkout has must hash the same in every run (exit 1
otherwise). A mode the checkout lacks is skipped.

Prints the card's name and power limit, a JSON line for each run and a
summary line of each checkout's two readings (sorted), and writes them to
--out. Needs a CUDA card; builds no kernel (the solver runs in torch).
"""

from __future__ import annotations

import hashlib
import sys

from _ab import run_ab


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from gptq_tpu_torch.config import QuantConfig
    from gptq_tpu_torch.data import synthetic_stream
    from gptq_tpu_torch.models.common import ArchSpec, init_params
    from gptq_tpu_torch.pipeline import quantize_model

    if not torch.cuda.is_available():
        raise SystemExit("quant_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    spec = ArchSpec(arch="llama", n_layers=1, hidden=4096, n_heads=32,
                    n_kv_heads=32, ffn=11008, vocab=32000, max_pos=2048,
                    act="silu", pos="rope", norm_type="rmsnorm",
                    linear_bias=False, tie_embeddings=False)
    calib = torch.as_tensor(synthetic_stream(spec.vocab, 16 * 512, seed=1)
                            .reshape(16, 512), device=dev).long()
    modes = {
        "uniform": (dict(wbits=4, groupsize=128, act_order=True,
                         true_sequential=True), None),
        "lut": (dict(wbits=3, groupsize=128, lut_eval=True), None),
        "non-linear": (dict(wbits=3, non_linear=True), None),
        "columnwise": (dict(wbits=3, columnwise=True), None),
        "linearwise": (dict(wbits=4, linearmix=True), "linearwise.json"),
    }
    out = {}
    for name, (kw, table) in modes.items():
        mixed = None
        if table is not None:
            try:
                from gptq_tpu_torch.cli import _cfg_path
                from gptq_tpu_torch.config import MixedPrecision
            except ImportError:
                continue
            import json

            with open(_cfg_path(table)) as f:
                mixed = MixedPrecision(linear_bits=json.load(f))
        params = init_params(spec, seed=0, dtype=torch.float32, device=dev)
        cfg = QuantConfig(nsamples=16, **kw)
        try:
            res = quantize_model(spec, params, calib, cfg, log=lambda s: None,
                                 **({} if mixed is None else {"mixed": mixed}))
        except NotImplementedError:
            continue  # a mode this checkout does not have
        torch.cuda.synchronize()
        out[f"{name} s"] = res.times["layer0"]
        h = hashlib.sha256()
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            h.update(params["layers"][0][key]["w"].cpu().numpy().tobytes())
        out[f"{name} bits"] = h.hexdigest()[:16]
        del params
        torch.cuda.empty_cache()
    try:
        from gptq_tpu_torch.analysis import analyse_model
    except ImportError:
        return out
    import time

    params = init_params(spec, seed=0, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    analyse_model(spec, params, calib, log=lambda s: None)
    torch.cuda.synchronize()
    out["analyse s"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    sys.exit(run_ab(__file__, worker, __doc__,
                    keys=lambda k: k.endswith(" s")))
