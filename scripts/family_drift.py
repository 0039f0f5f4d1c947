#!/usr/bin/env python3
"""How far the families' kernel decoding drifts from the plain versions,
and why.

    python3 scripts/family_drift.py --out chiprun_out/drift.json

For OPT-6.7B, BLOOM-7b1 and Gemma-7B at their published widths, built as
chip_smoke's families phase builds them and cut to 2 layers (w4a8 g-1,
the tied head packed to 8 bits, an int8 cache, bf16 activations), the
greedy tokens of kernel decoding after a 64-token prompt, then every
step's logits teacher-forced on them by:

  kernel   the served route (chip_smoke.family_greedy's);
  plain    every kernel's plain version (chip_smoke.plain_versions);
  plain64  the plain versions with their matmuls in f64: the floor, two
           computations exact to f32 that differ in rounding only;
  fault    the plain versions with each a8 row scale rounded to bf16: a
           planted fault of at most 2^-9 of a row, as a kernel that kept
           its scales in bf16 would make;
  dropped  the served route with layer 0's fc2 bias left out (OPT,
           BLOOM; Gemma: its ln2 weight), as a route that lost a bias
           would make (with the first zero points only).

Each reading is the largest |a - plain| over max |plain| at any step, the
measure of chip_smoke's TOL["logits_a8"]. Each model runs with the zero
points chip_smoke gives its weights (the codes' mean, 7.5) and with
packed_linear's zero point of 8; OPT also with gelu_tanh for relu, on a
bf16 cache, and on a bf16 cache with bf16 activations (a16).
Besides: max |logit| over the logits' rms (large where the tied head
echoes the input token), the steps whose plain top token is the input
token, and how much of the final layernorm's input row is common to the
row (|row mean| / row rms, the prompt's last row).

First, on each full-depth served model, the families phase's kernel
branch checks (chip_smoke.family_kernel_rows, gemma_layer_rows: #4, #5,
#6, #12 and #3 against their plain versions at M = 1 and 32 under the
near-tie rule, row by row) on inputs of another seed than chip_smoke's.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from unittest import mock

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("family_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke as cs
    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.models import common as C
    from gptq_tpu_torch.models.common import fuse_serving
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.ops.pack import PackedWeight
    from gptq_tpu_torch.pipeline import quantize_lm_head

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    quantize = Q.quantize_acts_int8

    def bf16_scales(x):
        xq, sx = quantize(x)
        return xq, sx.to(torch.bfloat16).float()

    @contextlib.contextmanager
    def changed(kind):  # inside plain_decoding: plain64's, fault's patches
        with contextlib.ExitStack() as st:
            if kind == "plain64":
                st.enter_context(cs.f64_matmuls())
            elif kind == "fault":
                for mod in (Fz, Q):
                    st.enter_context(mock.patch.object(
                        mod, "quantize_acts_int8", bf16_scales))
            yield

    def zero_at(node, zero):
        if isinstance(node, dict):
            return {k: zero_at(v, zero) for k, v in node.items()}
        if isinstance(node, list):
            return [zero_at(v, zero) for v in node]
        if isinstance(node, PackedWeight):
            return dataclasses.replace(node, zoff=node.scale * zero)
        return node

    out = {"card": cs.card_info(), "rows": [], "checks": []}
    print(out["card"], flush=True)
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    keep = ("model", "kernel", "w", "M", "B", "cache", "a8", "route",
            "rel_err", "max_abs_err", "flips")
    for model, L in cs.FAMILY_LAYERS.items():
        spec = cs.family_spec(model, L)
        params = cs.synth_family_params(spec, dev, seed=len(model))
        quantize_lm_head(spec, params, bits=8)
        served = fuse_serving(spec, params, a8=True)
        rows = cs.family_kernel_rows(model, spec, served, dev, peaks,
                                     cs.device_ms, seed=18)
        if spec.arch == "gemma":
            rows += cs.gemma_layer_rows(model, spec, served, dev, peaks,
                                        cs.device_ms, seed=20)
        del served
        for r in rows:
            out["checks"].append({k: r[k] for k in keep if k in r})
            print("seed 18 check " + json.dumps(out["checks"][-1]),
                  flush=True)
        small = dataclasses.replace(spec, n_layers=2)
        p2 = {**params, "layers": params["layers"][:2]}
        del params
        pr = np.random.default_rng(29).integers(0, spec.vocab, size=(1, 64))
        int8 = (torch.int8, True)
        variants = [("zero 7.5", small, p2, int8),
                    ("zero 8", small, zero_at(p2, 8.0), int8)]
        if spec.act == "relu":
            bf16 = (torch.bfloat16, True)
            variants += [
                ("zero 7.5, gelu_tanh",
                 dataclasses.replace(small, act="gelu_tanh"), p2, int8),
                ("zero 7.5, bf16 KV", small, p2, bf16),
                ("zero 7.5, bf16 KV, a16", small, p2, (torch.bfloat16, False))]
        for name, sp, p, (cache, a8) in variants:
            eng = DecodeEngine(sp, p, max_len=128, batch=1, cache_dtype=cache,
                               a8=a8)
            cs._drop_graphs(eng)
            toks = [eng.generate(pr, 16)[0].tolist()]
            lg = {"kernel": cs.engine_forced_logits(eng, [pr[0]], toks)[0]}
            seen = []
            real_head = C.head_forward

            def head(spec_, params_, h):
                seen.append(h[0, -1].float())
                return real_head(spec_, params_, h)

            for kind in ("plain", "plain64", "fault"):
                with cs.plain_decoding(eng), changed(kind), \
                        mock.patch.object(C, "head_forward", head):
                    lg[kind] = cs.engine_forced_logits(eng, [pr[0]], toks)[0]
            kinds = ["kernel", "plain64", "fault"]
            if name == variants[0][0]:
                lay = dict(p["layers"][0])
                if "fc2" in lay:
                    lay["fc2"] = {**lay["fc2"], "b": None}
                else:
                    lay["ln2"] = {"w": torch.zeros_like(lay["ln2"]["w"])}
                bad = DecodeEngine(sp, {**p, "layers": [lay, *p["layers"][1:]]},
                                   max_len=128, batch=1, cache_dtype=cache,
                                   a8=a8)
                lg["dropped"] = cs.engine_forced_logits(bad, [pr[0]], toks)[0]
                kinds.append("dropped")
                del bad
            ref = lg["plain"]
            rms = ref.pow(2).mean(-1).sqrt()
            inputs = torch.tensor([int(pr[0, -1])] + toks[0][:-1],
                                  device=dev)
            h = seen[0]
            row = {"model": model, "variant": name,
                   "max_logit_over_rms": float((ref.abs().amax(-1)
                                                / rms).mean()),
                   "echo_steps": int((ref.argmax(-1) == inputs).sum()),
                   "steps": len(toks[0]),
                   "common_share": float(h.mean().abs()
                                         / h.pow(2).mean().sqrt())}
            for kind in kinds:
                rel = cs.logit_drift(ref, lg[kind])
                row[kind] = max(rel)
                row[kind + "_per_step"] = [round(v, 5) for v in rel]
            row["kernel_vs_plain64"] = max(cs.logit_drift(lg["plain64"],
                                                          lg["kernel"]))
            out["rows"].append(row)
            print(f"{model} {name}: kernel {row['kernel']:.4g}, plain64 "
                  f"{row['plain64']:.4g}, kernel vs plain64 "
                  f"{row['kernel_vs_plain64']:.4g}, fault {row['fault']:.4g}"
                  f", dropped {row.get('dropped', 'not run')}"
                  f"; max|logit| / rms {row['max_logit_over_rms']:.3g}, "
                  f"echo {row['echo_steps']} of {row['steps']} steps, "
                  f"common share {row['common_share']:.3g}; per step: "
                  f"kernel {row['kernel_per_step']}, plain64 "
                  f"{row['plain64_per_step']}", flush=True)
            del eng
        del p2, variants
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
