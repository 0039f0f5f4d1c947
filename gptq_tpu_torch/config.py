"""Typed configuration (own copy of gptq_tpu/config.py:QuantConfig).

The field set is identical to the JAX package's so a checkpoint header
written by either package (`io.save_checkpoint` stores asdict(cfg))
loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class QuantConfig:
    """Capability surface of the quantization CLI (mirrors the JAX
    package's QuantConfig field for field)."""

    # Core GPTQ
    wbits: int = 16                  # {1,2,3,4,8,16}
    trits: bool = False              # ternary grid
    groupsize: int = -1              # -1 = whole-row groups
    sym: bool = False
    percdamp: float = 0.01
    blocksize: int = 128
    act_order: bool = False
    static_groups: bool = False
    true_sequential: bool = False    # llama sub-block ordering
    nearest: bool = False            # RTN baseline instead of GPTQ
    mse: bool = False                # grid-shrink search in find_params

    # Calibration
    dataset: str = "c4"
    nsamples: int = 128
    seed: int = 0
    seqlen: int | None = None

    # BCQ / shift (APoT) path (quant/bcq.py, GPTQ lut mode, kernel #13;
    # the columnwise solver waits: ROADMAP item 11)
    lut_eval: bool = False
    columnwise: bool = False
    bcq_round: int = 5
    use_bst: bool = True
    apot_nums: int = 2
    bcq: bool = False

    # Non-linear grid path (not ported yet)
    non_linear: bool = False
    hyperbits: int = 5
    exploreBits: int = 1
    exploreSplit: int = 20

    # Mixed precision (not ported yet)
    layermix: bool = False
    linearmix: bool = False
    quant_config: str | None = None

    # Serving / io
    save: str | None = None
    load: str | None = None
    benchmark: int = 0
    check: bool = False
    faster_kernel: bool = False      # serve with dynamic int8 activations (w4a8)
    new_eval: bool = False

    def __post_init__(self) -> None:
        if self.wbits not in (1, 2, 3, 4, 8, 16):
            raise ValueError(f"wbits must be one of 1,2,3,4,8,16, got {self.wbits}")

    @property
    def maxq(self) -> int:
        """Grid max for the uniform quantizer; -1 selects the ternary branch."""
        return -1 if self.trits else (1 << self.wbits) - 1

    def replace(self, **kw: Any) -> "QuantConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "QuantConfig":
        return cls(**json.loads(s))


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default) raises when
    no GPU is present instead of quietly running on the CPU; the CPU is
    used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gptq_tpu_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
