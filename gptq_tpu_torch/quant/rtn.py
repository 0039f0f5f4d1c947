"""Round-to-nearest baselines (port of gptq_tpu/quant/rtn.py): the two
Hessian-free quantization paths, which produce dense weights only.

  * uniform RTN per output channel (optionally per group): `--nearest`
  * whole-weight BCQ compress / decompress with APoT alphas: `--bcq`
"""

from __future__ import annotations

import torch

from gptq_tpu_torch.quant.bcq import quantize_shift
from gptq_tpu_torch.quant.uniform import find_params, quantize_uniform


def rtn_quantize_weight(W: torch.Tensor, bits: int, sym: bool = False,
                        mse: bool = False, groupsize: int = -1) -> torch.Tensor:
    """Per-channel uniform RTN of an (out, in) weight; with groupsize > 0
    each column group gets its own grid."""
    W32 = W.to(torch.float32)
    maxq = (1 << bits) - 1
    if groupsize <= 0:
        p = find_params(W32, bits=bits, perchannel=True, sym=sym, mse=mse,
                        weight=True)
        return quantize_uniform(W32, p.scale, p.zero, maxq).to(W.dtype)
    rows, cols = W.shape
    ng = cols // groupsize
    Wg = W32.reshape(rows, ng, groupsize).permute(1, 0, 2)  # (ng, rows, g)
    Qg = []
    for x in Wg:
        p = find_params(x, bits=bits, perchannel=True, sym=sym, mse=mse,
                        weight=True)
        Qg.append(quantize_uniform(x, p.scale, p.zero, maxq))
    return torch.stack(Qg).permute(1, 0, 2).reshape(rows, cols).to(W.dtype)


def bcq_rtn_weight(W: torch.Tensor, bits: int, rounds: int = 50,
                   groupsize: int = -1, apot_nums: int = 2,
                   use_bst: bool = True,
                   in_ch_wise: bool = False) -> torch.Tensor:
    """Whole-weight BCQ compress -> decompress with APoT alphas.
    `in_ch_wise` groups along input channels by transposing first."""
    x = W.T if in_ch_wise else W
    ret, _, _ = quantize_shift(x.to(torch.float32), qbits=bits, rounds=rounds,
                               group_size=groupsize, use_bst=use_bst,
                               apot_nums=apot_nums)
    ret = ret.T if in_ch_wise else ret
    return ret.to(W.dtype)
