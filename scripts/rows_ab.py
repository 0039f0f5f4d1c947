#!/usr/bin/env python3
"""#4 (ln1 + q|k|v, the 8-bit head) and #5 / #6 (the MLP half of a block)
at one row and at the batcher's rows in two checkouts of this repo, side
by side on one CUDA card.

    python3 scripts/rows_ab.py A_DIR B_DIR [--out FILE]

For each checkout, in a process of its own and in the order A, B, B, A,
on seeded random codes (the checkout's chip_smoke.packed_linear), w4a8
groupsize -1 at llama-7B width (the head w8a8):
  * the bits of the one-row kernels (norm_qkv_gemv_kernel,
    mlp_stream_kernel): a hash of #4's output (q|k|v a8 and a16, the
    head a8) and of #5's and #6's (a8 and a16) at M = 1;
  * the device time of the bare launch the checkout's route picks at M =
    4 and 32 (ops/ffn._norm_qkv_cuda, _mlp_cuda; the checkout's
    kernel_bench.time_fn: CUDA events, L2 flushed): q|k|v, the head, #5
    and #6.

Prints the card's name and power limit, a JSON line for each run and a
summary line of each checkout's two readings (sorted) and whether every
hash agrees across the four runs, and writes the runs and the summary to
--out. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import sys

from _ab import run_ab

H, F, V = 4096, 11264, 32256


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the checkout's own
    import torch

    from gptq_tpu_torch.ops import _build
    from gptq_tpu_torch.ops import ffn as Fz
    from gptq_tpu_torch.ops.kernel_bench import time_fn
    from gptq_tpu_torch.ops.pack import fuse_packed

    if not torch.cuda.is_available():
        raise SystemExit("rows_ab: no CUDA card")
    _build.build_all(tuple(n for n in ("ffn", "ffn_rows")
                           if n in _build.SOURCES))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def ms(fn):
        return time_fn(fn).median_s * 1e3

    def digest(t):
        torch.cuda.synchronize()
        raw = t.float().cpu().numpy().tobytes()
        return hashlib.sha256(raw).hexdigest()[:16]

    out = {"tree": tree}
    ln = torch.ones(H, dtype=torch.float32, device=dev)
    qkv = fuse_packed([cs.packed_linear(gen, H, H, 4, -1, dev)
                       for _ in range(3)])
    head = cs.packed_linear(gen, H, V, 8, -1, dev)
    o = cs.packed_linear(gen, H, H, 4, -1, dev)
    gu = fuse_packed([cs.packed_linear(gen, H, F, 4, -1, dev)
                      for _ in range(2)])
    dn = cs.packed_linear(gen, F, H, 4, -1, dev)
    for M in (1, 4, 32):
        x2 = torch.randn((M, H), generator=gen, device=dev).to(
            torch.bfloat16).float()
        attn = torch.randn((M, H), generator=gen, device=dev)
        for tag, pw, acts in (("q|k|v", qkv, (True, False)),
                              ("head", head, (True,))):
            for a8 in acts:
                def nq():
                    return Fz._norm_qkv_cuda(x2, ln, pw, "rmsnorm", 1e-5, a8,
                                             None, None)
                act = "a8" if a8 else "a16"
                if M == 1:
                    out[f"norm_qkv {tag} {act} M=1 bits"] = digest(nq())
                elif a8:
                    out[f"norm_qkv {tag} M={M} ms"] = ms(nq)
        for a8 in (True, False):
            def mlp5():
                return Fz._mlp_cuda(attn, x2, ln, o, gu, dn, "silu",
                                    "rmsnorm", 1e-5, True, a8, None, None,
                                    None, None)

            def mlp6():
                return Fz._mlp_cuda(attn, None, None, None, gu, dn, "silu",
                                    "rmsnorm", 0.0, True, a8, None, None,
                                    None, None)
            act = "a8" if a8 else "a16"
            if M == 1:
                out[f"attn_mlp {act} M=1 bits"] = digest(mlp5())
                out[f"ffn {act} M=1 bits"] = digest(mlp6())
            elif a8:
                out[f"attn_mlp M={M} ms"] = ms(mlp5)
                out[f"ffn M={M} ms"] = ms(mlp6)
    return out


def main(argv=None) -> int:
    return run_ab(__file__, worker, __doc__, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
