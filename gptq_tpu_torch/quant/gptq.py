"""Layer-wise second-order (GPTQ) quantization solver (port of
gptq_tpu/quant/gptq.py).

  * Hessian accumulation H = sum (2/n) x x^T with running rescale, one f32
    matmul per calibration batch (TF32 must be off on the card).
  * damped Cholesky -> inverse -> upper Cholesky factor of H^-1, with the
    JAX solver's dead-column and damping handling.
  * the blocked column-serial quantize + error-feedback loop: the JAX
    `lax.scan` over column blocks becomes a Python loop over blocks whose
    body loops over the in-block columns; the trailing update
    W[:, i2:] -= Err1 @ Hinv[i1:i2, :] is one matmul per block.

Four column quantizers, as in the JAX solver: `uniform` grids (act-order,
static groups, dynamic groups, sym, mse, trits); `lut`: APoT BCQ alphas
fit once per group on the (permuted) weight, each column taking the sign
code nearest to it among its group's sorted levels
(quant/bcq.search_levels); `columnwise`: APoT alphas re-fit on the next 8
columns of the in-block state every 8 columns (quant/bcq); `nonlinear`:
a non-uniform codebook grid (quant/nonlinear.py), fit on the weight
against the calibration mean input, per group, or once per static group.
TrueOBS variants: `sparse_outliers` keeps the weights whose squared error
exceeds a quarter of the squared grid step dense (uniform, whole-row
grids), `nearest` drops the error feedback.

`GPTQ` is the per-layer object of the reference's flow over linear,
Conv2d and HF Conv1D weights: add_batch, fasterquant and analyse.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.quant import bcq as bcq_mod
from gptq_tpu_torch.quant import conv as conv_mod
from gptq_tpu_torch.quant import nonlinear as nl_mod
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
    # BCQ / shift (lut, columnwise)
    bcq_rounds: int = 5
    use_bst: bool = True
    apot_nums: int = 2
    # non-linear
    hyperbits: int = 5
    explore_bits: int = 1
    explore_split: int = 20
    # TrueOBS variants
    sparse_outliers: bool = False  # keep (w-q)^2 > .25*scale^2 weights dense
    nearest: bool = False          # disable error feedback (RTN w/ same grid)

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

MODES = ("uniform", "lut", "columnwise", "nonlinear")


def gptq_quantize(W: torch.Tensor, H: torch.Tensor, cfg: SolverConfig,
                  mean_input=None) -> dict:
    """Quantize one linear's weight.

    W: (rows, cols) weight (rows = out features); H: (cols, cols) Hessian;
    mean_input: (cols,) scaled token mean (the non-linear mode's whole-row
    fit reads it). Returns a dict with Q (rows, cols) quantize-dequantized
    weight in the original column order, loss (sum of (w-q)^2 / (2 d^2)),
    perm (the act-order permutation), and by mode: scale/zero
    (num_groups, rows) grids (uniform; nonlinear with codebook
    (num_groups, 2^bits)), alpha (rows, num_groups, bits) BCQ magnitudes
    (lut), outlier_frac (sparse_outliers)."""
    mode = cfg.mode
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode}")
    rows, cols = W.shape
    dev = W.device
    W = W.to(torch.float32).clone()
    H = H.to(torch.float32).clone()
    maxq = cfg.maxq
    if mean_input is None:
        mean_input = torch.zeros(cols, dtype=torch.float32, device=dev)

    dead = torch.diag(H) == 0
    H = H + torch.diag(dead.to(H.dtype))
    W = W * (~dead)[None, :].to(W.dtype)

    g = cfg.groupsize if cfg.groupsize > 0 else cols
    num_groups = max(1, cols // g)
    hmaxq = (1 << cfg.hyperbits) - 1

    def nl_fit(x, inp=None):
        return nl_mod.nonlinear_find_params(
            x, cfg.bits, cfg.hyperbits, cfg.explore_bits, cfg.explore_split,
            inp=inp, use_input=inp is not None)

    # static per-group grids fit on the pre-permutation W
    static = None
    if cfg.static_groups and mode in ("uniform", "nonlinear"):
        Wg = W.reshape(rows, num_groups, g).permute(1, 0, 2)  # (ng, rows, g)
        fit = (lambda x: _row_params(x, cfg)) if mode == "uniform" else nl_fit
        fits = [fit(Wg[i]) for i in range(num_groups)]
        static = [torch.stack(f) for f in zip(*fits)]

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

    # mode-specific fits on the (possibly permuted) W
    whole_rows = not cfg.static_groups and cfg.groupsize <= 0
    outlier_thresh = None
    state = None  # uniform: [scales, zeros]; nonlinear: + books
    if mode == "uniform" and whole_rows:
        s0, z0 = _row_params(W, cfg)
        state = [s0[None].clone(), z0[None].clone()]
        if cfg.sparse_outliers:
            outlier_thresh = 0.25 * s0 ** 2
    elif mode == "nonlinear" and whole_rows:
        # the calibration mean in the weight's column order: under
        # act-order the JAX solver pairs the permuted weight with the
        # unpermuted mean (a fault in the reference, ROADMAP queue 3)
        s0, z0, b0 = nl_fit(W, mean_input.to(torch.float32)[perm])
        state = [s0[None], z0[None], b0[None]]
    elif static is not None:
        state = static
    elif mode in ("uniform", "nonlinear"):  # dynamic groups
        state = [torch.ones((num_groups, rows), device=dev),
                 torch.zeros((num_groups, rows), device=dev)]
        if mode == "nonlinear":
            state.append(torch.zeros((num_groups, 1 << cfg.bits),
                                     device=dev))
    tables = None
    if mode == "nonlinear":  # each group's snap table (quant/nonlinear.py)
        tables = [nl_mod._snap_table(b, hmaxq) for b in state[2]]
    if mode == "lut":  # APoT alphas per group of the (permuted) weight
        _, _, alpha0 = bcq_mod._fit(W, cfg.bits, cfg.bcq_rounds, cfg.groupsize,
                                    cfg.use_bst, cfg.apot_nums, apot=True)
        # each group's sorted levels once, for the per-column search
        order, mids = bcq_mod.sorted_levels(alpha0.reshape(-1, cfg.bits))
        order = order.reshape(rows, -1, order.shape[-1])
        mids = mids.reshape(rows, -1, mids.shape[-1])
    alpha = None  # columnwise: the alphas of the current 8 columns

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

    dynamic = (mode in ("uniform", "nonlinear") and cfg.groupsize > 0
               and not cfg.static_groups)
    # group index of every (padded, permuted) column position. With
    # act-order, static grids and lut alphas are fit on groups of one
    # column order and indexed by the original column's group, as the JAX
    # package does: pack_model recovers the codes against the same grids
    if dynamic or not cfg.actorder or cfg.groupsize <= 0:
        pos = torch.arange(cols_pad)
    else:
        pos = perm_pad.cpu()
    group_of = torch.clamp(pos // g, max=num_groups - 1).tolist() \
        if cfg.groupsize > 0 else [0] * cols_pad
    col_gs = cfg.groupsize if cfg.groupsize > 0 else -1

    n_out = torch.zeros((), dtype=torch.int64, device=dev)
    Qs, Es = [], []
    for b_idx in range(nb):
        i1 = b_idx * bs
        W1 = W_stale[:, i1:i1 + bs].clone()
        Hinv_b = Hinv_p[i1:i1 + bs]  # (bs, cols_pad)
        Q1 = torch.zeros_like(W1)
        E1 = torch.zeros_like(W1)
        for i in range(bs):
            idx = i1 + i
            # column i is read no more once quantized: the feedback below
            # updates the columns after it, so w stays a view
            w = W1[:, i]
            d = Hinv_b[i, idx]
            if dynamic and idx % g == 0 and idx < cols:
                # refit from the block-start weights (clamped like
                # lax.dynamic_slice when the group overhangs the pad)
                start = min(idx, cols_pad - g)
                sl = W_stale[:, start:start + g]
                gi = min(idx // g, num_groups - 1)
                fit = _row_params(sl, cfg) if mode == "uniform" else nl_fit(sl)
                for t, v in zip(state, fit):
                    t[gi] = v
                if mode == "nonlinear":
                    tables[gi] = nl_mod._snap_table(fit[2], hmaxq)
            gi = group_of[idx]
            if mode == "uniform":
                q = _quantize_col(w, state[0][gi], state[1][gi], maxq)
            elif mode == "nonlinear":
                # one (rows, 1) column: each row meets its own scale / zero
                q = nl_mod._snapped(w[:, None], state[0][gi], state[1][gi],
                                    tables[gi], hmaxq)[:, 0]
            elif mode == "lut":
                a = alpha0[:, gi, :]  # (rows, bits)
                B = bcq_mod.search_levels(w[:, None], order[:, gi],
                                          mids[:, gi])  # (rows, 1, bits)
                q = torch.einsum("rcb,rb->rc", B, a)[:, 0]
            else:  # columnwise: re-fit on the next 8 columns of W1
                if i % 8 == 0:
                    flat = W1[:, i:i + 8].reshape(1, rows * 8)
                    _, _, alpha = bcq_mod._fit(
                        flat, cfg.bits, cfg.bcq_rounds,
                        g * 8 if cfg.groupsize > 0 else -1, cfg.use_bst,
                        cfg.apot_nums, apot=True)
                q = bcq_mod.bcq_quantize(w[None], alpha, groupsize=col_gs,
                                         use_bst=cfg.use_bst)[0][0]
            if outlier_thresh is not None and idx < cols:
                # TrueOBS sparse outliers: keep large-error weights dense
                sel = (w - q) ** 2 > outlier_thresh
                q = torch.where(sel, w, q)
                n_out += sel.sum()
            err = (w - q) / d
            if not cfg.nearest:
                W1[:, i + 1:] -= (err[:, None]
                                  * Hinv_b[i, i1 + i + 1:i1 + bs][None, :])
            Q1[:, i] = q
            E1[:, i] = err
        # trailing update; columns before i1 see zeros (Hinv is upper
        # triangular) and finished columns are never read again
        if not cfg.nearest:
            W_stale = W_stale - E1 @ Hinv_b
        Qs.append(Q1)
        Es.append(E1)
    Q = torch.cat(Qs, dim=1)[:, :cols]
    # the proxy loss: each column's ((w - q) / d)^2, halved (the JAX
    # solver's (w - q)^2 / d^2 in another rounding order)
    loss = (torch.cat(Es, dim=1)[:, :cols] ** 2).sum() / 2
    if cfg.actorder:
        Q = Q[:, invperm]
    out = {"Q": Q, "loss": loss, "perm": perm}
    if outlier_thresh is not None:
        out["outlier_frac"] = n_out.to(torch.float32) / (rows * cols)
    if mode == "uniform":
        out["scale"], out["zero"] = state
    elif mode == "nonlinear":
        out["scale"], out["zero"], out["codebook"] = state
    elif mode == "lut":
        out["alpha"] = alpha0
    return out


# ---------------------------------------------------------------------------
# Driver-facing stateful wrapper
# ---------------------------------------------------------------------------

class GPTQ:
    """The reference's per-layer object flow: construct per linear, feed
    calibration activations, then solve. Transparent over layer kinds:
      kind="linear" — weight (out, in), activations (..., in)
      kind="conv2d" — weight (out, in, kh, kw); activations are NCHW
        images, unfolded into patch rows as torch.nn.Unfold does
        (stride / padding / dilation from conv_cfg); the solved Q takes
        the 4-d kernel layout again
      kind="conv1d" — HF transformers.Conv1D (in, out) transposed weight
    The Hessian lives on the weight's device."""

    def __init__(self, weight: torch.Tensor, kind: str = "linear",
                 conv_cfg: dict | None = None):
        self.kind = kind
        self.conv_cfg = conv_cfg or {}
        self.orig_shape = tuple(weight.shape)
        if kind == "conv2d":
            weight = conv_mod.conv2d_weight_matrix(weight)
        elif kind == "conv1d":
            weight = conv_mod.conv1d_weight_matrix(weight)
        elif kind != "linear":
            raise ValueError(f"unknown layer kind {kind}")
        self.weight = weight
        self.rows, self.columns = weight.shape
        self.state = hessian_init(self.columns, device=weight.device)

    @property
    def nsamples(self) -> int:
        return int(self.state[1])

    def add_batch(self, inp: torch.Tensor) -> None:
        if self.kind == "conv2d":
            inp = conv_mod.conv2d_patches(
                inp, self.conv_cfg.get("kernel_size", self.orig_shape[2:]),
                self.conv_cfg.get("stride", (1, 1)),
                self.conv_cfg.get("padding", (0, 0)),
                self.conv_cfg.get("dilation", (1, 1)))
        self.state = hessian_update(self.state, inp)

    def fasterquant(self, cfg: SolverConfig) -> dict:
        H, _, mean_input = self.state
        out = gptq_quantize(self.weight, H, cfg, mean_input)
        if self.kind == "conv2d":
            out["Q"] = conv_mod.conv2d_weight_from_matrix(out["Q"],
                                                          self.orig_shape)
        elif self.kind == "conv1d":
            out["Q"] = conv_mod.conv1d_weight_from_matrix(out["Q"])
        return out

    def analyse(self, percdamp: float = 0.01) -> dict:
        """Row / column statistics (max, min, mean, std with one degree of
        freedom taken) of W, W * mean input and W / diag(U), U the upper
        Cholesky factor of the damped H^-1."""
        W = self.weight.to(torch.float32)
        H, _, mean_input = self.state
        dead = torch.diag(H) == 0
        H = H + torch.diag(dead.to(H.dtype))
        W = W * (~dead)[None, :].to(W.dtype)
        damp = percdamp * torch.mean(torch.diag(H))
        H = H + damp * torch.eye(self.columns, dtype=H.dtype, device=H.device)
        U = _upper_cholesky_inverse(H)

        def stats(x, dim):
            return {"max": x.amax(dim=dim), "min": x.amin(dim=dim),
                    "mean": x.mean(dim=dim),
                    "std": x.std(dim=dim, correction=1)}

        wa = W * mean_input[None, :]
        wh = W / torch.diag(U)[None, :]
        return {
            "rowwise": {"w": stats(W, 1), "wa": stats(wa, 1),
                        "wh": stats(wh, 1)},
            "columnWise": {"w": stats(W, 0), "wa": stats(wa, 0),
                           "wh": stats(wh, 0)},
        }

    def free(self):
        self.state = None
        self.weight = None
