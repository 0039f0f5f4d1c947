"""Uniform (and ternary) min-max / MSE-searched quantization grids (port
of gptq_tpu/quant/uniform.py).

Grid semantics:
    q(x)  = scale * (clamp(round(x/scale) + zero, 0, maxq) - zero)
    trits = maxq < 0 branch: q(x) = (x > scale/2)*scale + (x < zero/2)*zero
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def quantize_uniform(x: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, maxq: int) -> torch.Tensor:
    """Quantize-dequantize `x` on a uniform grid; maxq < 0 selects the
    ternary branch where scale/zero hold xmax/xmin."""
    if maxq < 0:
        return ((x > scale / 2).to(x.dtype) * scale
                + (x < zero / 2).to(x.dtype) * zero)
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def shrink_factor(i: int, grid: int) -> float:
    """1 - i/grid evaluated in float32, as the JAX scan over f32 shrink
    steps computes it (a float64 value would differ in the last bit)."""
    return float(np.float32(1.0) - np.float32(i) / np.float32(grid))


def _per_step(x: torch.Tensor, maxq: int) -> torch.Tensor:
    """x / maxq as the JAX package computes it once compiled: XLA folds the
    division by a constant into a multiplication by its float32
    reciprocal, which differs from true division in the last bit."""
    return x * torch.tensor(float(np.float32(1.0) / np.float32(maxq)),
                            dtype=x.dtype, device=x.device)


@dataclass(frozen=True)
class UniformParams:
    """Grid parameters: `scale`/`zero` broadcastable against the tensor."""

    scale: torch.Tensor
    zero: torch.Tensor

    def quantize(self, x: torch.Tensor, maxq: int) -> torch.Tensor:
        return quantize_uniform(x, self.scale, self.zero, maxq)


def find_params(x: torch.Tensor, bits: int, perchannel: bool = True,
                sym: bool = False, mse: bool = False, norm: float = 2.4,
                grid: int = 100, maxshrink: float = 0.8, trits: bool = False,
                weight: bool = True) -> UniformParams:
    """(scale, zero) for `x`. For weight=True, x is (rows, cols...) and
    per-channel means per row; the result has shape (rows, 1, ...)."""
    maxq = -1 if trits else (1 << bits) - 1
    shape = x.shape
    x = x.to(torch.float32)

    if perchannel:
        if weight:
            flat = x.reshape(shape[0], -1)
        elif x.dim() == 4:
            flat = x.permute(1, 0, 2, 3).reshape(shape[1], -1)
        elif x.dim() == 3:
            flat = x.reshape(-1, shape[-1]).T
        elif x.dim() == 2:
            flat = x.T
        else:
            flat = x.reshape(1, -1)
    else:
        flat = x.reshape(1, -1)

    zeros_row = torch.zeros(flat.shape[0], dtype=flat.dtype, device=x.device)
    xmin = torch.minimum(flat.amin(dim=1), zeros_row)
    xmax = torch.maximum(flat.amax(dim=1), zeros_row)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, torch.full_like(xmin, -1.0), xmin)
    xmax = torch.where(degenerate, torch.full_like(xmax, 1.0), xmax)

    if maxq < 0:
        scale, zero = xmax, xmin
    else:
        scale = _per_step(xmax - xmin, maxq)
        zero = (torch.full_like(scale, (maxq + 1) / 2) if sym
                else torch.round(-xmin / scale))
        if mse:
            best = torch.full_like(scale, float("inf"))
            for i in range(int(maxshrink * grid)):
                p = shrink_factor(i, grid)
                xmin1, xmax1 = p * xmin, p * xmax
                scale1 = _per_step(xmax1 - xmin1, maxq)
                zero1 = zero if sym else torch.round(-xmin1 / scale1)
                q = quantize_uniform(flat, scale1[:, None], zero1[:, None],
                                     maxq)
                err = ((q - flat).abs() ** norm).sum(dim=1)
                better = err < best
                best = torch.where(better, err, best)
                scale = torch.where(better, scale1, scale)
                zero = torch.where(better, zero1, zero)

    if not perchannel:
        rep = shape[0] if weight else (shape[1] if len(shape) != 3 else shape[2])
        scale = scale.repeat(rep)
        zero = zero.repeat(rep)

    if weight:
        out_shape = (-1,) + (1,) * (len(shape) - 1)
        return UniformParams(scale.reshape(out_shape), zero.reshape(out_shape))
    if len(shape) == 4:
        return UniformParams(scale.reshape(1, -1, 1, 1),
                             zero.reshape(1, -1, 1, 1))
    if len(shape) == 3:
        return UniformParams(scale.reshape(1, 1, -1), zero.reshape(1, 1, -1))
    return UniformParams(scale[None, :], zero[None, :])


@dataclass
class UniformQuantizer:
    """configure / find_params / quantize wrapper over the functions above."""

    bits: int = 4
    perchannel: bool = True
    sym: bool = False
    mse: bool = False
    norm: float = 2.4
    grid: int = 100
    maxshrink: float = 0.8
    trits: bool = False
    params: UniformParams | None = None

    @property
    def maxq(self) -> int:
        return -1 if self.trits else (1 << self.bits) - 1

    def find_params(self, x: torch.Tensor, weight: bool = True) -> UniformParams:
        self.params = find_params(
            x, bits=self.bits, perchannel=self.perchannel, sym=self.sym,
            mse=self.mse, norm=self.norm, grid=self.grid,
            maxshrink=self.maxshrink, trits=self.trits, weight=weight)
        return self.params

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.ready():
            return x
        return quantize_uniform(x, self.params.scale, self.params.zero,
                                self.maxq)

    def ready(self) -> bool:
        return self.params is not None and bool(
            torch.all(self.params.scale != 0))
