"""Layer-wise second-order (GPTQ) quantization solver (port of the
uniform-grid and BCQ (`lut`) modes of gptq_tpu/quant/gptq.py).

  * Hessian accumulation H = sum (2/n) x x^T with running rescale, one f32
    matmul per calibration batch (TF32 must be off on the card).
  * damped Cholesky -> inverse -> upper Cholesky factor of H^-1, with the
    JAX solver's dead-column and damping handling.
  * the blocked column-serial quantize + error-feedback loop: the JAX
    `lax.scan` over column blocks becomes a Python loop over blocks whose
    body loops over the in-block columns; the trailing update
    W[:, i2:] -= Err1 @ Hinv[i1:i2, :] is one matmul per block.

Uniform grids (act-order, static groups, dynamic groups, sym, mse,
trits) and the `lut` mode: APoT BCQ alphas fit once per group on the
(permuted) weight, then each column takes the sign code nearest to it
among its group's sorted levels (quant/bcq.search_levels). The columnwise / non-linear back-ends raise
NotImplementedError until they are ported (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.quant import bcq as bcq_mod
from gptq_tpu_torch.quant.uniform import shrink_factor


# ---------------------------------------------------------------------------
# Hessian accumulation
# ---------------------------------------------------------------------------

def hessian_init(columns: int, device="cuda", dtype=torch.float32):
    """Zero state: (H, nsamples, mean_input), on the card unless the caller
    names another device."""
    device = resolve_device(device)
    return (torch.zeros((columns, columns), dtype=dtype, device=device), 0,
            torch.zeros((columns,), dtype=dtype, device=device))


def hessian_update(state, inp: torch.Tensor):
    """Fold one calibration batch into H. The sample count grows by the
    leading batch dim; mean_input keeps the last batch's sqrt(2/n)-scaled
    token mean. The scalar factors are computed in float32 as JAX does."""
    H, n, _ = state
    b = inp.shape[0] if inp.dim() >= 3 else 1
    x = inp.reshape(-1, inp.shape[-1]).to(torch.float32)
    n_new = n + b
    scale_old = float(np.float32(n) / np.float32(n_new))
    xs = float(np.sqrt(np.float32(2.0) / np.float32(n_new))) * x
    H = H * scale_old + xs.T @ xs
    return H, n_new, xs.mean(dim=0)


# ---------------------------------------------------------------------------
# Solver configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SolverConfig:
    mode: str = "uniform"  # uniform | lut | columnwise | nonlinear
    bits: int = 4
    blocksize: int = 128
    percdamp: float = 0.01
    groupsize: int = -1
    actorder: bool = False
    static_groups: bool = False
    sym: bool = False
    trits: bool = False
    mse: bool = False
    # BCQ / shift (lut mode)
    bcq_rounds: int = 5
    use_bst: bool = True
    apot_nums: int = 2

    @property
    def maxq(self) -> int:
        return -1 if self.trits else (1 << self.bits) - 1


def _row_params(x: torch.Tensor, cfg: SolverConfig):
    """Per-row (scale, zero) for a (rows, g) slice (min-max, optional MSE
    grid shrink)."""
    maxq = cfg.maxq
    zeros_row = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    xmin = torch.minimum(x.amin(dim=1), zeros_row)
    xmax = torch.maximum(x.amax(dim=1), zeros_row)
    if cfg.sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, torch.full_like(xmin, -1.0), xmin)
    xmax = torch.where(degenerate, torch.full_like(xmax, 1.0), xmax)
    if maxq < 0:
        return xmax, xmin  # trits: scale=xmax, zero=xmin
    scale = (xmax - xmin) / maxq
    zero = (torch.full_like(scale, (maxq + 1) / 2) if cfg.sym
            else torch.round(-xmin / scale))
    if cfg.mse:
        grid, maxshrink, norm = 100, 0.8, 2.4
        best = torch.full_like(scale, float("inf"))
        for i in range(int(maxshrink * grid)):
            p = shrink_factor(i, grid)
            xmin1, xmax1 = p * xmin, p * xmax
            scale1 = (xmax1 - xmin1) / maxq
            zero1 = zero if cfg.sym else torch.round(-xmin1 / scale1)
            q = torch.clamp(torch.round(x / scale1[:, None]) + zero1[:, None],
                            0, maxq)
            dq = scale1[:, None] * (q - zero1[:, None])
            err = ((dq - x).abs() ** norm).sum(dim=1)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)
    return scale, zero


def _quantize_col(w, scale, zero, maxq: int):
    """Uniform quantize-dequantize of one column (rows,)."""
    if maxq < 0:
        return (w > scale / 2) * scale + (w < zero / 2) * zero
    q = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
    return scale * (q - zero)


def _upper_cholesky_inverse(H: torch.Tensor) -> torch.Tensor:
    """U upper-triangular with U^T U = H^-1."""
    n = H.shape[0]
    L = torch.linalg.cholesky(H)
    Hinv = torch.cholesky_solve(torch.eye(n, dtype=H.dtype, device=H.device), L)
    Hinv = (Hinv + Hinv.T) / 2  # symmetrize before the second factorization
    return torch.linalg.cholesky(Hinv).T


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def gptq_quantize(W: torch.Tensor, H: torch.Tensor, cfg: SolverConfig,
                  mean_input=None) -> dict:
    """Quantize one linear's weight.

    W: (rows, cols) weight (rows = out features); H: (cols, cols) Hessian.
    Returns a dict with Q (rows, cols) quantize-dequantized weight in the
    original column order, loss (sum of (w-q)^2 / (2 d^2)), scale/zero
    (num_groups, rows) grids (uniform) or alpha (rows, num_groups, bits)
    BCQ magnitudes (lut), and perm (the act-order permutation)."""
    if cfg.mode not in ("uniform", "lut"):
        raise NotImplementedError(
            f"gptq_quantize mode={cfg.mode!r}: only the uniform and lut "
            f"modes are ported (columnwise / non-linear wait: ROADMAP queue "
            f"1, item 11)")
    lut = cfg.mode == "lut"
    del mean_input  # used by the non-linear back-end only
    rows, cols = W.shape
    dev = W.device
    W = W.to(torch.float32).clone()
    H = H.to(torch.float32).clone()
    maxq = cfg.maxq

    dead = torch.diag(H) == 0
    H = H + torch.diag(dead.to(H.dtype))
    W = W * (~dead)[None, :].to(W.dtype)

    g = cfg.groupsize if cfg.groupsize > 0 else cols
    num_groups = max(1, cols // g)

    # static per-group grids fit on the pre-permutation W
    sg_scale = sg_zero = None
    if cfg.static_groups and not lut:
        Wg = W.reshape(rows, num_groups, g).permute(1, 0, 2)  # (ng, rows, g)
        fits = [_row_params(Wg[i], cfg) for i in range(num_groups)]
        sg_scale = torch.stack([f[0] for f in fits])
        sg_zero = torch.stack([f[1] for f in fits])

    if cfg.actorder:
        perm = torch.argsort(-torch.diag(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]
        invperm = torch.argsort(perm)
    else:
        perm = torch.arange(cols, device=dev)

    damp = cfg.percdamp * torch.mean(torch.diag(H))
    H = H + damp * torch.eye(cols, dtype=H.dtype, device=dev)
    Hinv = _upper_cholesky_inverse(H)

    alpha0 = None
    if lut:  # APoT alphas per group of the (permuted) weight
        _, _, alpha0 = bcq_mod._fit(W, cfg.bits, cfg.bcq_rounds, cfg.groupsize,
                                    cfg.use_bst, cfg.apot_nums, apot=True)
        # each group's sorted levels once, for the per-column search
        order, mids = bcq_mod.sorted_levels(alpha0.reshape(-1, cfg.bits))
        order = order.reshape(rows, -1, order.shape[-1])
        mids = mids.reshape(rows, -1, mids.shape[-1])

    bs = cfg.blocksize
    nb = -(-cols // bs)
    cols_pad = nb * bs
    pad = cols_pad - cols
    W_stale = torch.nn.functional.pad(W, (0, pad))
    Hinv_p = torch.zeros((cols_pad, cols_pad), dtype=Hinv.dtype, device=dev)
    Hinv_p[:cols, :cols] = Hinv
    if pad:
        idx = torch.arange(cols, cols_pad, device=dev)
        Hinv_p[idx, idx] = 1.0
    perm_pad = torch.cat([perm, torch.arange(cols, cols_pad, device=dev)])

    dynamic = not lut and cfg.groupsize > 0 and not cfg.static_groups
    scales = zeros = None  # lut mode carries no grid state
    if not lut and cfg.groupsize <= 0:
        s0, z0 = _row_params(W, cfg)
        scales, zeros = s0[None].clone(), z0[None].clone()
    elif not lut and cfg.static_groups:
        scales, zeros = sg_scale, sg_zero
    elif not lut:
        scales = torch.ones((num_groups, rows), device=dev)
        zeros = torch.zeros((num_groups, rows), device=dev)
    # group index of every (padded, permuted) column position. With
    # act-order, lut mode fits alphas on the permuted groups but indexes
    # them by the original column's group, as the JAX package does:
    # pack_model recovers the signs against the same alphas
    if dynamic or not cfg.actorder or cfg.groupsize <= 0:
        pos = torch.arange(cols_pad)
    else:
        pos = perm_pad.cpu()
    group_of = torch.clamp(pos // g, max=num_groups - 1).tolist() \
        if cfg.groupsize > 0 else [0] * cols_pad

    Qs, Ls = [], []
    for b_idx in range(nb):
        i1 = b_idx * bs
        W1 = W_stale[:, i1:i1 + bs].clone()
        Hinv_b = Hinv_p[i1:i1 + bs]  # (bs, cols_pad)
        Q1 = torch.zeros_like(W1)
        L1 = torch.zeros_like(W1)
        E1 = torch.zeros_like(W1)
        for i in range(bs):
            idx = i1 + i
            w = W1[:, i].clone()  # W1 is updated in place below
            d = Hinv_b[i, idx]
            if dynamic and idx % g == 0 and idx < cols:
                # refit from the block-start weights (clamped like
                # lax.dynamic_slice when the group overhangs the pad)
                start = min(idx, cols_pad - g)
                s, z = _row_params(W_stale[:, start:start + g], cfg)
                gi = min(idx // g, num_groups - 1)
                scales[gi] = s
                zeros[gi] = z
            gi = group_of[idx]
            if lut:
                a = alpha0[:, gi, :]  # (rows, bits)
                B = bcq_mod.search_levels(w[:, None], order[:, gi],
                                          mids[:, gi])  # (rows, 1, bits)
                q = torch.einsum("rcb,rb->rc", B, a)[:, 0]
            else:
                q = _quantize_col(w, scales[gi], zeros[gi], maxq)
            err = (w - q) / d
            W1[:, i:] -= err[:, None] * Hinv_b[i, i1 + i:i1 + bs][None, :]
            Q1[:, i] = q
            L1[:, i] = (w - q) ** 2 / d ** 2
            E1[:, i] = err
        # trailing update; columns before i1 see zeros (Hinv is upper
        # triangular) and finished columns are never read again
        W_stale = W_stale - E1 @ Hinv_b
        Qs.append(Q1)
        Ls.append(L1)
    Q = torch.cat(Qs, dim=1)[:, :cols]
    loss = (torch.cat(Ls, dim=1) / 2)[:, :cols].sum()
    if cfg.actorder:
        Q = Q[:, invperm]
    out = {"Q": Q, "loss": loss, "perm": perm}
    if lut:
        out["alpha"] = alpha0
    else:
        out["scale"], out["zero"] = scales, zeros
    return out
