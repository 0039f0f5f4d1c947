"""Binary-coding quantization (BCQ) and its additive-power-of-2 "shift"
variant (port of gptq_tpu/quant/bcq.py).

W ~= sum_b alpha_b * B_b with B in {-1, +1}. A greedy residual-sign fit
seeds an alternating refinement: batched conjugate gradient for alpha,
then a sorted binary search for B. The JAX `lax.scan`s become Python
loops; every rounding point is kept (sums weighted by `wf = ones` as
`_fit` passes them, stable argsorts, half-to-even rounding), so sign
codes match the JAX package bit for bit.
"""

from __future__ import annotations

import functools

import torch


def binary_codebook(n_bits: int, device="cpu") -> torch.Tensor:
    """All 2^n sign vectors (2^n, n) f32: entry 0 = [+1..+1], entry
    2^n-1 = [-1..-1], the first coordinate varying slowest."""
    vecs = [[]]
    for _ in range(n_bits):
        vecs = [[1.0] + v for v in vecs] + [[-1.0] + v for v in vecs]
    return torch.tensor(vecs, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _codebook(n_bits: int, device: torch.device) -> torch.Tensor:
    """binary_codebook, made once per device: the GPTQ lut mode searches
    every column, and a fresh host-to-device copy each time would
    synchronize the card that often. Callers do not modify it."""
    return binary_codebook(n_bits, device)


def sorted_levels(alpha: torch.Tensor):
    """The 2^k reconstruction levels of each row of alpha (d1, k), sorted:
    (order (d1, 2^k) codebook rows by level, mids (d1, 2^k - 1) the
    midpoints between neighbouring sorted levels)."""
    v = alpha @ _codebook(alpha.shape[-1], alpha.device).T  # (d1, 2^k)
    order = torch.argsort(v, dim=1, stable=True)
    v_sorted = torch.gather(v, 1, order)
    return order, (v_sorted[:, :-1] + v_sorted[:, 1:]) / 2


def search_levels(w: torch.Tensor, order: torch.Tensor,
                  mids: torch.Tensor) -> torch.Tensor:
    """Signs B (d1, d2, k) of the level nearest each w (d1, d2), given
    sorted_levels of the rows' alphas. The JAX package runs a k-step
    binary search over the midpoints (w < mid goes left); the midpoints
    are non-decreasing, so its result is the number of midpoints <= w,
    which this counts directly."""
    k = order.shape[1].bit_length() - 1
    left = (w[:, :, None] >= mids[:, None, :]).sum(dim=2)  # (d1, d2)
    return _codebook(k, w.device)[torch.gather(order, 1, left)]


def find_b(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Sign assignment minimizing |w - B.alpha| elementwise: the nearest of
    the sorted 2^k reconstruction levels.

    w: (d1, d2); alpha: (d1, k) nonnegative. Returns B (d1, d2, k) in
    {-1, +1}. The sort is stable, as jnp.argsort is: alphas snapped to
    powers of two often give equal levels (alpha = (1, .5, .5)), and an
    unstable sort would pick another codebook row with the same level."""
    return search_levels(w, *sorted_levels(alpha))


def greedy_fit(w: torch.Tensor, n_bits: int, wf: torch.Tensor | None = None):
    """Greedy residual-sign initialization. Returns (w_hat, B (d1,d2,k),
    alpha (d1,k))."""
    r = w
    w_hat = torch.zeros_like(w)
    bs, alphas = [], []
    for _ in range(n_bits):
        b = torch.sign(r)
        if wf is not None:
            num = torch.sum(r.abs() * wf, dim=1)
            den = torch.sum(wf, dim=1)
            alpha = torch.where(den > 0, num / den, torch.zeros_like(num))
        else:
            alpha = torch.mean(r.abs(), dim=1)
        r = r - b * alpha[:, None]
        w_hat = w_hat + b * alpha[:, None]
        bs.append(b)
        alphas.append(alpha)
    return w_hat, torch.stack(bs, dim=-1), torch.stack(alphas, dim=-1)


def batch_cg(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Batched conjugate gradient, k iterations for (..., k, k) systems."""
    k = A.shape[-1]
    x = x0[..., None]
    r = b[..., None] - A @ x
    rtr = r.transpose(-1, -2) @ r
    p = r
    for _ in range(k):
        Ap = A @ p
        a = rtr / (p.transpose(-1, -2) @ Ap + 1e-6)
        x = x + a * p
        r = r - a * Ap
        rtr2 = r.transpose(-1, -2) @ r
        beta = rtr2 / (rtr + 1e-6)
        p = r + beta * p
        rtr = rtr2
    return x[..., 0]


def _greedy_signs(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Residual-sign assignment against fixed alphas (use_bst=False)."""
    r = w
    cols = []
    for i in range(alpha.shape[-1]):
        s = torch.sign(r)
        r = r - s * alpha[:, i:i + 1]
        cols.append(s)
    return torch.stack(cols, dim=-1)


def _refine(w, B, alpha, use_bst: bool, apot_nums: int | None, wf=None):
    """One alternating-refinement round. apot_nums=None gives plain BCQ
    alphas; otherwise they snap to sums of `apot_nums` signed powers of
    two."""
    Bt = B.transpose(-1, -2)  # (d1, k, d2)
    if wf is not None:
        Bt = Bt * wf[:, None, :]
    B_cov = Bt @ B  # (d1, k, k)
    Btw = (Bt @ w[..., None])[..., 0]  # (d1, k)
    alpha_new = batch_cg(B_cov, Btw, alpha)
    alpha_new = -torch.sort(-alpha_new.abs(), dim=-1).values  # descending
    if apot_nums is not None:
        alpha_new = additive_power_of_2(alpha_new, apot_nums)
    if use_bst:
        B_new = find_b(w, alpha_new)
        if wf is not None:
            B_new = B_new * (wf != 0.0)[..., None].to(B_new.dtype)
    else:
        B_new = _greedy_signs(w, alpha_new)
    w_hat = torch.einsum("ijl,il->ij", B_new, alpha_new)
    return w_hat, B_new, alpha_new


def round_power_of_2(x: torch.Tensor) -> torch.Tensor:
    """The nearest (in log space) signed power of two; 0 maps to 0
    (exp2(round(log2 0)) = 0). torch.round rounds half to even, as
    jnp.round does."""
    return torch.exp2(torch.round(torch.log2(x.abs()))) * torch.sign(x)


def additive_power_of_2(x: torch.Tensor, nums: int = 2) -> torch.Tensor:
    """Greedy decomposition into `nums` signed powers of two."""
    out = round_power_of_2(x)
    for _ in range(nums - 1):
        out = out + round_power_of_2(x - out)
    return out


def _fit(w, qbits, rounds, group_size, use_bst, apot_nums, apot):
    """Fit (ret, B (N, K/g, g, b), alpha (N, K/g, b)) to w (N, K)."""
    orig_shape = w.shape
    gs = group_size if group_size > 0 else orig_shape[-1]
    wg = w.reshape(-1, gs).to(torch.float32)
    wf = torch.ones_like(wg)
    ret, B, alpha = greedy_fit(wg, qbits, wf=wf)
    if rounds > 0 and qbits > 1:
        nums = apot_nums if apot else None
        for _ in range(rounds):
            ret, B, alpha = _refine(wg, B, alpha, use_bst=use_bst,
                                    apot_nums=nums, wf=wf)
    if apot:
        # the shift variant recomputes the reconstruction from (B, alpha)
        ret = torch.einsum("ijl,il->ij", B, alpha)
    ret = ret.reshape(orig_shape)
    B = B.reshape(orig_shape[0], orig_shape[1] // gs, gs, qbits)
    alpha = alpha.reshape(orig_shape[0], orig_shape[1] // gs, qbits)
    return ret, B, alpha


def quantize_shift(w: torch.Tensor, qbits: int, rounds: int = 15,
                   group_size: int = -1, use_bst: bool = True,
                   apot_nums: int = 1):
    """BCQ fit with additive-power-of-2 alphas. w: (N, K). Returns
    (ret, B (N, K/g, g, b), alpha (N, K/g, b))."""
    return _fit(w, qbits, rounds, group_size, use_bst, apot_nums, apot=True)


def bcq_fit(w: torch.Tensor, qbits: int, rounds: int = 15,
            group_size: int = -1, use_bst: bool = True):
    """Plain BCQ fit (unit weighting)."""
    return _fit(w, qbits, rounds, group_size, use_bst, apot_nums=1,
                apot=False)


def bcq_quantize(x: torch.Tensor, alpha: torch.Tensor, groupsize: int = -1,
                 use_bst: bool = True):
    """Quantize x (N, K) against fixed per-group alphas (N, K//g, b).
    Returns (ret (N, K), B (N, K//g, g, b))."""
    N, K = x.shape
    b = alpha.shape[-1]
    gs = groupsize if groupsize > 0 else K
    ng = K // gs
    xg = x.reshape(N * ng, gs).to(torch.float32)
    ag = alpha.reshape(N * ng, b).to(torch.float32)
    B = find_b(xg, ag) if use_bst else _greedy_signs(xg, ag)
    ret = torch.einsum("ijl,il->ij", B, ag).reshape(N, K)
    return ret, B.reshape(N, ng, gs, b)


class BCQuantizer:
    """Stateful wrapper: fit the alphas once, then quantize against them."""

    def __init__(self, shape, groupsize=-1, wbits=3, rounds=5, use_bst=True,
                 apot_nums=1):
        self.wbits = wbits
        self.groupsize = groupsize
        self.rounds = rounds
        self.use_bst = use_bst
        self.apot_nums = apot_nums
        _, K = shape
        self.num_groups = 1 if groupsize == -1 else K // groupsize
        self.alpha = None

    def find_params(self, x: torch.Tensor) -> torch.Tensor:
        _, _, self.alpha = quantize_shift(
            x, qbits=self.wbits, rounds=self.rounds,
            group_size=self.groupsize, use_bst=self.use_bst,
            apot_nums=self.apot_nums)
        return self.alpha

    def quantize(self, x: torch.Tensor):
        if not self.ready():
            self.find_params(x)
        return bcq_quantize(x, self.alpha, self.groupsize)

    def ready(self) -> bool:
        return self.alpha is not None
