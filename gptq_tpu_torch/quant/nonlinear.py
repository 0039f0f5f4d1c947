"""Non-linear (non-uniform grid) quantization (port of
gptq_tpu/quant/nonlinear.py).

A weight is first mapped to a wide uniform "hyper" grid of 2^hyperbits
levels, then snapped to the best 2^wbits-point non-uniform sub-grid.
Candidate codebooks are the center level +/- all combinations of `wbits`
distinct powers of two out of {2^(hyperbits-2) .. 2^-1}; the search sweeps
`exploreSplit+1` scales between the (hyperbits+exploreBits)-bit and
(hyperbits-exploreBits)-bit grid steps.

The search visits the (codebook, scale) pairs in the JAX scan's order and
keeps the first minimum of the loss, one scalar mean over the whole
weight. A hyper-grid index is an integer in [0, 2^hyperbits), so snapping
it to a codebook is one lookup in a table of the nearest level of each
index (the first level at an exact tie, as the argmin over the codebook
picks it).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch


def all_codebooks(hyperbits: int, wbits: int) -> np.ndarray:
    """Static table of candidate codebooks, shape (n_choices, 2^wbits).
    Values live on the hyper grid index scale, centered at
    (2^hyperbits - 1)/2."""
    powers = [2.0 ** i for i in range(hyperbits - 2, -2, -1)]
    center = (2.0 ** hyperbits - 1) / 2
    books = []
    for combo in combinations(powers, wbits):
        levels = [center]
        for a in combo:
            levels = [lv + a for lv in levels] + [lv - a for lv in levels]
        books.append(levels)
    return np.asarray(books, dtype=np.float32)


def _snap_table(codebook: torch.Tensor, maxq: int) -> torch.Tensor:
    """(maxq + 1,) the codebook level nearest each hyper-grid index (the
    first such level of the codebook at a tie)."""
    idx = torch.arange(maxq + 1, dtype=torch.float32, device=codebook.device)
    d = (idx[:, None] - codebook[None, :]).abs()
    return codebook[torch.argmin(d, dim=1)]


def _hyper_quantize(x, scale, zero, maxq: int) -> torch.Tensor:
    """Hyper-grid indices of x (N, K) under per-row scale / zero."""
    return torch.clamp(torch.round((x - zero[:, None]) / scale[:, None]),
                       0, maxq)


def _snapped(x, scale, zero, table, maxq: int) -> torch.Tensor:
    """Snap x's hyper-grid indices to the codebook and dequantize. An index
    that is not a number (a row of zero range) stays one."""
    q = _hyper_quantize(x, scale, zero, maxq)
    ok = torch.isfinite(q)
    snapped = torch.where(ok, table[torch.where(ok, q, 0).long()], q)
    return scale[:, None] * snapped + zero[:, None]


def nonlinear_find_params(x: torch.Tensor, wbits: int, hyperbits: int,
                          explore_bits: int = 1, explore_split: int = 20,
                          inp: torch.Tensor | None = None,
                          use_input: bool = False):
    """Exhaustive (codebook x scale) search minimizing the MSE of W (or of
    W @ input). x: (N, K) weight. Returns (scale (N,), zero (N,), codebook
    (2^wbits,))."""
    dev = x.device
    books = torch.from_numpy(all_codebooks(hyperbits, wbits)).to(dev)
    x = x.to(torch.float32)
    maxq = (1 << hyperbits) - 1

    zeros_row = torch.zeros(x.shape[0], dtype=x.dtype, device=dev)
    xmin = torch.minimum(x.amin(dim=1), zeros_row)
    xmax = torch.maximum(x.amax(dim=1), zeros_row)
    base_scale = (xmax - xmin) / maxq
    zero = torch.round(xmin / base_scale) * base_scale  # dequant-domain zero
    scale_down = (xmax - xmin) / (2.0 ** (hyperbits + explore_bits) - 1)
    scale_up = (xmax - xmin) / (2.0 ** (hyperbits - explore_bits) - 1)
    step = (scale_up - scale_down) / explore_split
    if use_input:
        inp = inp.to(device=dev, dtype=torch.float32)
        target = x @ inp

    losses = []
    for c in range(books.shape[0]):
        table = _snap_table(books[c], maxq)
        for s in range(explore_split + 1):
            scale = scale_down + step * float(s)
            dq = _snapped(x, scale, zero, table, maxq)
            if use_input:
                losses.append(torch.mean((target - dq @ inp) ** 2))
            else:
                losses.append(torch.mean((x - dq) ** 2))
    losses = torch.stack(losses)
    # the scan keeps the first strict minimum; a loss that is not a number
    # never wins, and with none finite the first codebook and the base
    # scale stay
    finite = torch.isfinite(losses)
    if not bool(finite.any()):
        return base_scale, zero, books[0]
    best = int(torch.argmin(torch.where(finite, losses,
                                        torch.full_like(losses, np.inf))))
    c, s = divmod(best, explore_split + 1)
    return scale_down + step * float(s), zero, books[c]


def nonlinear_quantize(x: torch.Tensor, scale: torch.Tensor,
                       zero: torch.Tensor, codebook: torch.Tensor,
                       hyperbits: int) -> torch.Tensor:
    """Quantize-dequantize x (N, K) against a fitted non-uniform grid."""
    maxq = (1 << hyperbits) - 1
    return _snapped(x.to(torch.float32), scale, zero,
                    _snap_table(codebook, maxq), maxq)


class NonLinearQuantizer:
    """Stateful wrapper: fit the grid once, then quantize against it."""

    def __init__(self, wbits=3, hyperbits=5, explore_bits=1,
                 explore_split=20):
        self.wbits = wbits
        self.hyperbits = hyperbits
        self.explore_bits = explore_bits
        self.explore_split = explore_split
        self.scale = None
        self.zero = None
        self.codebook = None

    def find_params(self, x: torch.Tensor, inp: torch.Tensor | None = None):
        self.scale, self.zero, self.codebook = nonlinear_find_params(
            x, self.wbits, self.hyperbits, self.explore_bits,
            self.explore_split, inp=inp, use_input=inp is not None)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.ready():
            raise ValueError("Quantizer not ready.")
        return nonlinear_quantize(x, self.scale, self.zero, self.codebook,
                                  self.hyperbits)

    def ready(self) -> bool:
        return self.scale is not None
