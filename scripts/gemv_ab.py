#!/usr/bin/env python3
"""#1 and #13 at one row (decode) in two checkouts of this repo, side by
side on one CUDA card.

    python3 scripts/gemv_ab.py A_DIR B_DIR [--out FILE]

For each checkout, in a process of its own and in the order A, B, B, A,
on one llama-7B layer's four linears (K x N: 4096x12288, 4096x4096,
4096x22528, 11264x4096) of seeded random codes (the checkout's
chip_smoke.packed_linear / bcq_linear): 4-bit groupsize -1 (#1) and 3-bit
groupsize 128 BCQ (#13), each with int8 (a8) and bf16 x:
  * the bare kernel launch's device time (the checkout's
    kernel_bench.time_fn: CUDA events, L2 flushed), each linear and their
    sum;
  * the host's time for one wrapper call (dequant_matmul / bcq_matmul on
    the 4096x4096 linear; scripts/_ab.host_times: 100 calls
    queued with no synchronisation, the median of five batches).

Prints the card's name and power limit, a JSON line for each run and a
summary line of each checkout's two readings (sorted), and writes the
runs and the summary to --out. Needs a CUDA card.
"""

from __future__ import annotations

import sys

from _ab import host_times, run_ab

SHAPES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096)]


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the checkout's own
    import torch

    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import bcq_matmul as B
    from gptq_tpu_torch.ops import qmatmul as Q
    from gptq_tpu_torch.ops.kernel_bench import time_fn

    if not torch.cuda.is_available():
        raise SystemExit("gemv_ab: no CUDA card")
    _build.build_all(("qmatmul", "bcq_matmul"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    out = {"tree": tree}
    for tag, mod, make in (
            ("w4g-1", Q, lambda K, N: cs.packed_linear(gen, K, N, 4, -1, dev)),
            ("bcq3g128", B, lambda K, N: cs.bcq_linear(gen, K, N, 3, 128,
                                                       dev))):
        kernel = B._bcq_cuda if mod is B else Q._qmm_cuda
        wrapper = B.bcq_matmul if mod is B else Q.dequant_matmul
        for act, xdt in (("a8", torch.float32), ("bf16", torch.bfloat16)):
            a8 = act == "a8"
            per = []
            for K, N in SHAPES:
                pw = make(K, N)
                x = torch.randn((1, K), generator=gen, device=dev).to(xdt)
                x2, _ = mod._prepare(x, pw, a8)
                per.append(time_fn(lambda: kernel(x2, pw)).median_s * 1e3)
                if (K, N) == (4096, 4096):
                    out[f"{tag} {act} host_us"] = host_times(
                        lambda: wrapper(x, pw, a8=a8))["host_us"]
                del pw
            out[f"{tag} {act} ms"] = sum(per)
            out[f"{tag} {act} per_linear_ms"] = per
    return out


def main(argv=None) -> int:
    return run_ab(__file__, worker, __doc__, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
