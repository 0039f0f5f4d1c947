"""The driver that the scripts/*_ab.py comparisons share: one worker run
in two checkouts of this repo, each in a process of its own, in the order
A, B, B, A, on one CUDA card.

A script defines `worker(tree) -> dict` (its readings: keys ending in
" ms" or "host_us" are summarised, keys ending in " bits" must agree
across the four runs) and calls `run_ab(__file__, worker, __doc__)`. The
driver prints the card's name and power limit, a JSON line for each run
and a summary line of each checkout's two readings (sorted), writes the
runs and the summary to --out, and exits 1 where a " bits" reading
differs between runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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


def default_keys(k: str) -> bool:
    return k.endswith(" ms") or k.endswith("host_us")


def run_ab(script: str, worker, doc: str, keys=default_keys,
           argv=None) -> int:
    """`python3 script A_DIR B_DIR [--out FILE]`: worker in A, B, B, A.
    `keys` picks the readings the summary lists."""
    name = os.path.splitext(os.path.basename(script))[0]
    ap = argparse.ArgumentParser(prog=name, description=doc.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker)), flush=True)
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
            [sys.executable, os.path.abspath(script), args.a, args.b,
             "--worker", tree], capture_output=True, text=True, cwd=tree)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{name}: the run of {tree} failed "
                             f"(exit {proc.returncode})")
        run = {"label": label, **json.loads(line[-1][len("RESULT "):])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {"card": card}
    for label in ("a", "b"):
        mine = [r for r in runs if r["label"] == label]
        summary[label] = {k: sorted(r[k] for r in mine) for k in mine[0]
                          if keys(k)}
    summary["bits_equal"] = {k: len({r[k] for r in runs}) == 1
                             for k in runs[0] if k.endswith(" bits")}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0 if all(summary["bits_equal"].values()) else 1
