"""Conv2d / Conv1D adaptation for the GPTQ solver (port of
gptq_tpu/quant/conv.py).

A Conv2d kernel is flattened to (out, in*kh*kw) and its input unfolded
into patch rows for the Hessian; an HF-style Conv1D (a transposed linear)
is transposed. `*_from_matrix` restores the original layout.
"""

from __future__ import annotations

import torch


def conv2d_weight_matrix(W: torch.Tensor) -> torch.Tensor:
    """(out, in, kh, kw) -> (out, in*kh*kw)."""
    return W.reshape(W.shape[0], -1)


def conv2d_weight_from_matrix(Q: torch.Tensor, shape) -> torch.Tensor:
    return Q.reshape(shape)


def conv2d_patches(x: torch.Tensor, kernel_size, stride=(1, 1),
                   padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """Unfold NCHW input into (batch, n_patches, in*kh*kw) patch rows (the
    columns of torch.nn.functional.unfold); they feed hessian_update
    directly."""
    patches = torch.nn.functional.unfold(
        x.to(torch.float32), tuple(kernel_size), dilation=tuple(dilation),
        padding=tuple(padding), stride=tuple(stride))  # (n, c*kh*kw, L)
    return patches.transpose(1, 2)


def conv1d_weight_matrix(W: torch.Tensor) -> torch.Tensor:
    """HF transformers.Conv1D stores (in, out); the solver wants (out, in)."""
    return W.T


def conv1d_weight_from_matrix(Q: torch.Tensor) -> torch.Tensor:
    return Q.T
