"""Kernel latency harness and seeded fixtures (port of
gptq_tpu/ops/kernel_bench.py), behind the CLI's `--lut_bench`.

The fixtures make random packed weights in the real serving formats from
a torch.Generator. `time_fn` times one call on the card with CUDA events:
the 50 MB L2 is flushed before each call, as a decode step finds the
weights, and a spin kernel holds the device while the host queues the
call, so the events see device time, not the host's launch overhead.
There is no CPU mode: a latency of the card comes only from the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gptq_tpu_torch.ops.bcq_matmul import bcq_matmul
from gptq_tpu_torch.ops.pack import PackedWeight, pack_bcq, pack_codes
from gptq_tpu_torch.ops.qmatmul import dequant_matmul


# --- fixtures ---------------------------------------------------------------

def make_random_input(gen: torch.Generator, m: int, k: int,
                      dtype=torch.float32) -> torch.Tensor:
    return torch.randn((m, k), generator=gen, device=gen.device).to(dtype)


def make_random_packed(gen: torch.Generator, k: int, n: int, bits: int,
                       groupsize: int = -1) -> PackedWeight:
    """Random uniform-grid codes, scales and zero offsets."""
    ng = 1 if groupsize <= 0 else k // groupsize
    dev = gen.device
    codes = torch.randint(0, 2**bits, (k, n), generator=gen, device=dev)
    scale = torch.randn((ng, n), generator=gen, device=dev).abs() * 0.01 \
        + 0.001
    return PackedWeight(words=pack_codes(codes, bits, groupsize), scale=scale,
                        zoff=scale * (2 ** (bits - 1)), bits=bits, K=k, N=n,
                        groupsize=groupsize, fmt="uniform")


def make_random_bcq(gen: torch.Generator, k: int, n: int, bits: int,
                    groupsize: int = -1) -> PackedWeight:
    """Random signs and alphas, packed by pack_bcq."""
    ng = 1 if groupsize <= 0 else k // groupsize
    g = k if groupsize <= 0 else groupsize
    dev = gen.device
    B = torch.where(torch.randn((n, ng, g, bits), generator=gen, device=dev)
                    > 0, 1.0, -1.0)
    alpha = torch.randn((n, ng, bits), generator=gen, device=dev).abs() * 0.01
    return pack_bcq(B, alpha, groupsize=groupsize)


# --- latency harness ----------------------------------------------------------

@dataclass
class LatencyStats:
    min_s: float
    max_s: float
    avg_s: float
    median_s: float
    p90_s: float

    def __str__(self) -> str:
        return (f"min {self.min_s*1e6:.1f}us avg {self.avg_s*1e6:.1f}us "
                f"median {self.median_s*1e6:.1f}us p90 {self.p90_s*1e6:.1f}us "
                f"max {self.max_s*1e6:.1f}us")


def time_fn(fn, *args, iters: int = 20, warmup: int = 2,
            spin_cycles: int = 5_000_000) -> LatencyStats:
    """Device time of fn(*args) over `iters` calls, each after an L2 flush
    and a spin kernel, from CUDA events. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn: kernel latencies are measured on a CUDA "
                           "device only")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / 1e3)
    t = np.asarray(ts)
    return LatencyStats(float(t.min()), float(t.max()), float(t.mean()),
                        float(np.median(t)), float(np.percentile(t, 90)))


def bench_kernels(m: int = 1, k: int = 4096, n: int = 4096,
                  bits_list=(2, 3, 4, 8), groupsize: int = 128,
                  seed: int = 0, log=print) -> dict:
    """The `--lut_bench` table: latency of every serving matmul at (m, k, n)
    beside the dense bf16 torch.matmul. Uniform weights take the default
    route of dequant_matmul, BCQ 2/3-bit weights bcq_matmul."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = make_random_input(gen, m, k)
    results = {}

    Wd = (torch.randn((k, n), generator=gen, device="cuda") * 0.01).to(
        torch.bfloat16)
    st = time_fn(lambda a: torch.matmul(a.to(torch.bfloat16), Wd), x)
    results["dense_bf16"] = st
    log(f"dense bf16       : {st}")

    for bits in bits_list:
        pw = make_random_packed(gen, k, n, bits, groupsize)
        st = time_fn(lambda a, pw=pw: dequant_matmul(a, pw), x)
        results[f"uniform_{bits}bit"] = st
        log(f"uniform {bits}-bit    : {st}")

    for bits in (2, 3):
        pw = make_random_bcq(gen, k, n, bits, groupsize)
        st = time_fn(lambda a, pw=pw: bcq_matmul(a, pw), x)
        results[f"bcq_{bits}bit"] = st
        log(f"bcq {bits}-bit        : {st}")
    return results
