"""BCQ bitplane matmul, the LUT-GEMM path (port of
gptq_tpu/ops/bcq_matmul.py).

    y[m,n] = sum_g sum_b alpha[g,b,n] * sum_{k in g} (2*bit_b[k,n] - 1) x[m,k]

`bcq_matmul` on a CUDA tensor launches the hand-written kernels that
are the counterpart of the Pallas `_bcq_kernel`, chosen by `bcq_route`
from the row count: csrc/bcq_matmul.cu's streamed single-row kernel
(csrc/gemv.cuh `bcq_gemv_kernel`, the design #1 shares) for one row
(decode), csrc/qmma.cu on the tensor cores (wgmma, sm_90a) for more
(batched decode, prefill, PPL eval), and csrc/bcq_matmul.cu's tiled loop
for the weights neither takes. On a CPU tensor
it runs `bcq_matmul_reference`, the plain PyTorch version (the JAX
package's `impl="xla"` path). There is no fallback from a kernel to the
plain version on the card: a launch that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from gptq_tpu_torch.ops import _build
from gptq_tpu_torch.ops.pack import PackedWeight, subblock, unpack_field
# the act-order gather, int8 activations, row scale and bias: as qmatmul
from gptq_tpu_torch.ops.qmatmul import (_X_KIND, _finish, _lib as _qlib,
                                        _mma_ready, _prepare, gemv_cut, mma_x)

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): csrc/bcq_matmul.cu (its single-row kernel and its tiled loop),
# csrc/qmma.cu's BCQ kernel
launches = 0
mma_launches = 0


def bcq_route(M: int, bits: int, groupsize: int, Np: int = 128) -> str:
    """The kernel of #13 for M rows against `bits` sign planes:
    "single_row" (M = 1: the streamed bcq_gemv_kernel of csrc/gemv.cuh
    where groups cover whole subblocks and Np % 4 == 0, else the
    CUDA-core loop), "mma" (M >= 2: csrc/qmma.cu; the
    grid is applied inside the dequantized weight, so groups of any
    multiple of 8 rows that divides or is divided by the kernel's 64-row
    stage; chip_smoke's crossover rows on an H100 find it faster than
    the loop from M = 2 up, PERF.md), or "shallow" (M >= 2 with
    other groups, more than 8 planes, a stage's alphas too many for
    shared memory, or an Np its 16-byte loads cannot take: the CUDA-core
    tiled kernel of bcq_matmul.cu). The activations' type does not
    matter: int8 x takes the bf16 form."""
    if M <= 1:
        return "single_row"
    g = groupsize if groupsize > 0 else 64
    if (g % 8 or (g % 64 and 64 % g) or Np % 4 or not 1 <= bits <= 8
            or (g < 64 and bits * (2 + 64 // g) > 42)):
        return "shallow"
    return "mma"


def _unpack_signs(words: torch.Tensor, groupsize: int = -1) -> torch.Tensor:
    """(bits, K//32, N) int32 -> (bits, K, N) f32 in {-1, +1}."""
    bits, Kw, _ = words.shape
    K = Kw * 32
    planes = torch.stack([unpack_field(words[b], 1, K, groupsize)
                          for b in range(bits)])
    return 2.0 * planes.to(torch.float32) - 1.0


def bcq_dequant_stored(pw: PackedWeight) -> torch.Tensor:
    """Materialize (Kp, Np) = sum_b alpha_b * B_b in f32 over the stored
    (padded) dims."""
    signs = _unpack_signs(pw.words[0], pw.groupsize)  # (bits, Kp, Np)
    g = pw.Kp // pw.alpha.shape[0]
    a = torch.repeat_interleave(pw.alpha, g, dim=0).permute(1, 0, 2)
    return torch.sum(signs * a, dim=0)


def bcq_dequant(pw: PackedWeight) -> torch.Tensor:
    """Materialize (K, N) = sum_b alpha_b * B_b in f32."""
    return bcq_dequant_stored(pw)[:pw.K, :pw.N]


def bcq_matmul_reference(x: torch.Tensor, pw: PackedWeight,
                         a8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of bcq_matmul: materialize the weight, one
    f32 matmul. With a8 the int8 activations feed the same matmul (the
    kernel is linear in x, so the row scale folds in afterwards)."""
    lead = x.shape[:-1]
    x2, sx = _prepare(x, pw, a8)
    y = torch.matmul(x2.to(torch.float32), bcq_dequant(pw))
    return _finish(y, sx, pw, lead, x.dtype)


def _bcq_mma(x2: torch.Tensor, pw: PackedWeight, words: torch.Tensor,
             alpha: torch.Tensor, ng: int) -> torch.Tensor:
    """Launch csrc/qmma.cu's BCQ kernel on x2 (M, Kp) -> (M, Np) f32: bf16
    x as it is, f32 x as split_bf16's halves, int8 x as bf16 (exact)."""
    global mma_launches
    if x2.dtype != torch.float32:
        x2 = x2.to(torch.bfloat16)
    xa, xb = mma_x(x2, pw.Kp, pw.groupsize, 1)
    M = x2.shape[0]
    out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
    err = _qlib("qmma").bcq_mma_launch(
        xa.data_ptr(), None if xb is None else xb.data_ptr(), M, pw.Kp,
        _mma_ready(words).data_ptr(), pw.bits,
        subblock(pw.Kp, pw.groupsize), _mma_ready(alpha).data_ptr(), ng,
        out.data_ptr(), pw.Np,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "bcq_mma_launch")
    mma_launches += 1
    return out


def _bcq_cuda(x2: torch.Tensor, pw: PackedWeight,
              route: str | None = None) -> torch.Tensor:
    """Launch #13 on x2 (M, K) -> (M, Np) f32: the kernel bcq_route picks
    (csrc/qmma.cu for "mma", csrc/bcq_matmul.cu otherwise), or the one
    `route` names (chip_smoke's crossover rows time both)."""
    global launches
    if pw.fmt != "bcq":
        raise ValueError(f"bcq_matmul: fmt={pw.fmt!r} is not a BCQ weight")
    if x2.dtype not in _X_KIND:
        x2 = x2.to(torch.float32)
    M = x2.shape[0]
    if pw.Kp != x2.shape[1]:
        x2 = torch.nn.functional.pad(x2, (0, pw.Kp - x2.shape[1]))
    x2 = x2.contiguous()
    words, alpha = pw.words[0].contiguous(), pw.alpha.contiguous()
    for t in (words, alpha):
        if not t.is_cuda or t.device != x2.device:
            raise ValueError("bcq_matmul: weight and activations must lie on "
                             "the same CUDA device")
    ng = alpha.shape[0]
    if (len(pw.words) != 1 or words.dtype != torch.int32
            or words.shape != (pw.bits, pw.Kp // 32, pw.Np)
            or alpha.dtype != torch.float32
            or alpha.shape != (ng, pw.bits, pw.Np) or pw.Kp % ng
            or not 1 <= pw.bits <= 8):
        raise ValueError(f"bcq_matmul: BCQ weight of K={pw.Kp} N={pw.Np} "
                         f"bits={pw.bits} has malformed planes or alphas")
    if route is None:
        route = bcq_route(M, pw.bits, pw.groupsize, pw.Np)
    if route == "mma":
        return _bcq_mma(x2, pw, words, alpha, ng)
    out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
    sb = subblock(pw.Kp, pw.groupsize)
    # the single-row kernel's 16-byte copies need x on a 16-byte boundary
    # (and the weight's tensors, which it checks: allocations are)
    x2 = _mma_ready(x2)
    err = _lib().bcq_launch(
        x2.data_ptr(), _X_KIND[x2.dtype], M, pw.Kp, words.data_ptr(),
        pw.bits, sb, alpha.data_ptr(), ng, out.data_ptr(), pw.Np,
        *gemv_cut(pw.Kp, pw.Np, sb, 1, x2.element_size(), x2.get_device()),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "bcq_launch")
    launches += 1
    return out


def _lib():
    lib = _build.load("bcq_matmul")
    f = lib.bcq_launch
    if f.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, i, i, i, vp, i, i, vp, i, vp, i, i, i, vp]
        f.restype = ctypes.c_int
    return lib


def bcq_matmul(x: torch.Tensor, pw: PackedWeight,
               a8: bool = False) -> torch.Tensor:
    """y = x @ bcq_dequant(pw) (+ bias), with the act-order permutation
    applied. x: (..., K) -> (..., N) in x's dtype. a8=True quantizes the
    activations to int8 per row first. A CUDA tensor goes through the
    CUDA kernel, a CPU tensor through bcq_matmul_reference."""
    if not x.is_cuda:
        return bcq_matmul_reference(x, pw, a8=a8)
    lead = x.shape[:-1]
    x2, sx = _prepare(x, pw, a8)
    y = _bcq_cuda(x2, pw)[:, :pw.N]
    return _finish(y, sx, pw, lead, x.dtype)
