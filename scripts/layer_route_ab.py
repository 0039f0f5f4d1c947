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

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def host_times(fn, n: int = 100, batches: int = 5) -> dict:
    """fn's host time a call (n calls queued with no synchronisation) and
    the wall time a call until the device has run them all, in µs: the
    median of `batches` batches."""
    import torch

    for _ in range(3):
        fn()
    host, wall = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / n * 1e6)
        wall.append((t2 - t0) / n * 1e6)
    return {"host_us": sorted(host)[batches // 2],
            "wall_us": sorted(wall)[batches // 2]}


def worker(tree: str, tmp: str) -> dict:
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        with tempfile.TemporaryDirectory() as tmp:
            print("RESULT " + json.dumps(worker(args.worker, tmp)),
                  flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for label, tree in (("a", args.a), ("b", args.b), ("b", args.b),
                        ("a", args.a)):
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.a, args.b,
             "--worker", tree], capture_output=True, text=True, cwd=tree)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"layer_route_ab: the run of {tree} failed "
                             f"(exit {proc.returncode})")
        run = {"label": label, **json.loads(line[-1][len("RESULT "):])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {"card": card}
    for label in ("a", "b"):
        mine = [r for r in runs if r["label"] == label]
        summary[label] = {k: sorted(r[k] for r in mine)
                          for k in ("median_ms", "wrapper_host_us",
                                    "wrapper_wall_us")}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
