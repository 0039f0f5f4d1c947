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
    # columnwise: the solver re-fits APoT alphas every 8 columns)
    lut_eval: bool = False
    columnwise: bool = False
    bcq_round: int = 5
    use_bst: bool = True
    apot_nums: int = 2
    bcq: bool = False

    # Non-linear grid path (quant/nonlinear.py)
    non_linear: bool = False
    hyperbits: int = 5
    exploreBits: int = 1
    exploreSplit: int = 20

    # Mixed precision (MixedPrecision below)
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


@dataclass
class MixedPrecision:
    """Per-module bit allocation: bits per decoder layer (configs/
    layerwise.json, --layermix), per linear type (configs/linearwise.json,
    --linearmix), or per module path ({bits, columnwise}, --quant_config).

    A --quant_config key names a module by its path; it matches layer i's
    linear when its last path components are `i` and the linear's name
    (in full, or its last component). The JAX package matches by string
    suffix, so there layer 1 takes layer 11's entry when that entry is
    listed first; here the components must be whole."""

    layer_bits: list[int] | None = None          # bits[i] for decoder layer i
    linear_bits: dict[str, int] | None = None     # bits per linear type name
    module_config: dict[str, dict] | None = None  # module path -> {bits, columnwise}

    def module_entry(self, layer_idx: int, linear_name: str) -> dict | None:
        """The first --quant_config entry whose key names this module."""
        if self.module_config is None:
            return None
        short = linear_name.split(".")[-1]
        tails = ([str(layer_idx), *linear_name.split(".")],
                 [str(layer_idx), short])
        for key, cfg in self.module_config.items():
            parts = key.split(".")
            if any(parts[-len(t):] == t for t in tails):
                return cfg
        return None

    def bits_for(self, layer_idx: int, linear_name: str, default: int) -> int:
        cfg = self.module_entry(layer_idx, linear_name)
        if cfg is not None:
            return int(cfg["bits"])
        short = linear_name.split(".")[-1]
        if self.linear_bits is not None and short in self.linear_bits:
            return int(self.linear_bits[short])
        if self.layer_bits is not None:
            return int(self.layer_bits[layer_idx])
        return default

    def columnwise_for(self, layer_idx: int, linear_name: str,
                       default: bool) -> bool:
        cfg = self.module_entry(layer_idx, linear_name)
        return default if cfg is None else bool(cfg.get("columnwise", default))


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
