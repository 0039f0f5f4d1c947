"""Fused dequantize + matmul for uniform-grid packed weights (port of
gptq_tpu/ops/qmatmul.py: dequant, quantize_acts_int8, _matmul_streamed,
dequant_matmul, and the expert-bank functions dequant_experts,
expert_dequant_matmul, expert_dequant_matmul_select).

`dequant_matmul` routes by GPTQ_TPU_MATMUL_IMPL, as in the JAX package:
  * `pallas` (the default): on a CUDA tensor the hand-written kernel in
    csrc/qmatmul.cu (the counterpart of the Pallas `_qmm_kernel`);
  * `streamed`: single-field (2/4/8-bit) weights take csrc/qstream.cu
    (the counterpart of `_stream_kernel`), which walks K itself; a 3-bit
    weight takes the `pallas` route;
  * `xla`: the plain version, `dequant_matmul_reference`, because the
    caller asked for it;
  * `staged`: the resident serving mode, not ported (ROADMAP item 17).
A CPU tensor always runs the plain version. There is no fallback from a
kernel to the plain version on the card: a launch that fails raises.

Both compute y[m,n] = sum_k x[m,k] * (scale[g(k),n] * c[k,n] - zoff[g(k),n]).

The expert-bank functions serve a PackedExperts bank (models/moe.py):
`expert_dequant_matmul` runs every expert's matmul in one launch of
csrc/qexpert.cu's batched kernel (#8), `expert_dequant_matmul_select` one
selected expert's, whose index the kernel reads from device memory (#9).
A CPU tensor runs their plain versions; `xla` runs the batched plain
version on the card too (the select has no `xla` form of its own: the
MoE layer then serves each selection through dequant_matmul).
"""

from __future__ import annotations

import ctypes
import os

import torch

from gptq_tpu_torch.ops import _build
from gptq_tpu_torch.ops.pack import (FIELD_SPLITS, PackedExperts,
                                     PackedWeight, subblock, unpack_codes)

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): csrc/qmatmul.cu, csrc/qstream.cu and csrc/qexpert.cu's two
launches = 0
stream_launches = 0
expert_launches = 0
select_launches = 0


def dequant(pw: PackedWeight) -> torch.Tensor:
    """Materialize the dequantized (K, N) f32 weight."""
    codes = unpack_codes(pw.words, pw.bits, pw.groupsize).to(torch.float32)
    g = pw.Kp // pw.scale.shape[0]
    s = torch.repeat_interleave(pw.scale, g, dim=0)
    z = torch.repeat_interleave(pw.zoff, g, dim=0)
    return (codes * s - z)[:pw.K, :pw.N]


def quantize_acts_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic int8 quantization over the last dim: (xq int8, scale f32
    with the last dim kept as 1). scale = absmax / 127 in IEEE division,
    as the JAX package computes it; the division is between tensors,
    because on CUDA PyTorch divides by a Python number as a product with
    its reciprocal, one ulp off, which moves a code sitting on a .5 tie.
    torch.round rounds half to even, as jnp.round does. It prepares the
    int8 inputs of #1, #7, #8, #9 and #13 (kernel and plain version
    alike), those of the plain versions of #4-#6 and #12, and the int8 KV
    cache rows (models/common._quantize_kv)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = amax / torch.full_like(amax, 127.0) + 1e-12
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def _prepare(x: torch.Tensor, pw: PackedWeight, a8: bool):
    x2 = x.reshape(-1, x.shape[-1])
    if pw.perm is not None:
        x2 = x2.index_select(1, pw.perm)
    sx = None
    if a8:
        x2, sx = quantize_acts_int8(x2)
    return x2, sx


def _finish(y, sx, pw, lead, dtype):
    if sx is not None:
        y = y * sx  # (M, 1) per-row activation scale
    if pw.bias is not None:
        y = y + pw.bias
    return y.reshape(*lead, pw.N).to(dtype)


def dequant_matmul_reference(x: torch.Tensor, pw: PackedWeight,
                             a8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of dequant_matmul (the `impl="xla"` path of
    the JAX package): materialize the weight, one f32 matmul. With a8 the
    int8 activations feed the same matmul (the kernel epilogue is linear
    in x)."""
    lead = x.shape[:-1]
    x2, sx = _prepare(x, pw, a8)
    y = torch.matmul(x2.to(torch.float32), dequant(pw))
    return _finish(y, sx, pw, lead, x.dtype)


_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _qmm_cuda(x2: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Launch csrc/qmatmul.cu on x2 (M, K) -> (M, Np) f32."""
    global launches
    if pw.fmt != "uniform":
        raise ValueError(f"dequant_matmul: fmt={pw.fmt!r} weights are served "
                         f"by ops.bcq_matmul")
    if x2.dtype not in _X_KIND:
        x2 = x2.to(torch.float32)
    M = x2.shape[0]
    if pw.Kp != x2.shape[1]:
        x2 = torch.nn.functional.pad(x2, (0, pw.Kp - x2.shape[1]))
    x2 = x2.contiguous()
    words = [w.contiguous() for w in pw.words]
    scale, zoff = pw.scale.contiguous(), pw.zoff.contiguous()
    for t in (*words, scale, zoff):
        if not t.is_cuda or t.device != x2.device:
            raise ValueError("dequant_matmul: weight and activations must "
                             "lie on the same CUDA device")
    if scale.dtype != torch.float32 or zoff.dtype != torch.float32:
        raise ValueError("dequant_matmul: scale/zoff must be float32")
    fields = FIELD_SPLITS[pw.bits]
    ng = scale.shape[0]
    if (zoff.shape != scale.shape or scale.shape[1] != pw.Np or pw.Kp % ng
            or len(words) != len(fields)
            or any(w.dtype != torch.int32 or w.shape != (pw.Kp * fb // 32, pw.Np)
                   for (fb, _), w in zip(fields, words))):
        raise ValueError(f"dequant_matmul: packed weight of K={pw.Kp} "
                         f"N={pw.Np} bits={pw.bits} has malformed fields")
    out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
    lib = _lib()
    (fb0, sh0), w0 = fields[0], words[0]
    fb1, sh1, w1 = (fields[1][0], fields[1][1], words[1].data_ptr()) \
        if len(fields) > 1 else (0, 0, None)
    err = lib.qmm_launch(
        x2.data_ptr(), _X_KIND[x2.dtype], M, pw.Kp, w0.data_ptr(), fb0, sh0,
        w1, fb1, sh1, subblock(pw.Kp, pw.groupsize),
        scale.data_ptr(), zoff.data_ptr(), ng, out.data_ptr(), pw.Np,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "qmm_launch")
    launches += 1
    return out


def _lib(name="qmatmul"):
    lib = _build.load(name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "qmatmul":
        f, types = lib.qmm_launch, [vp, i, i, i, vp, i, i, vp, i, i, i, vp,
                                    vp, i, vp, i, vp]
    elif name == "qexpert":
        for f, types in ((lib.qexpert_launch,
                          [vp, i, i, i, i, i, vp, vp, i, i, vp, vp, i, vp, i,
                           vp]),
                         (lib.qselect_launch,
                          [vp, i, i, i, vp, vp, i, i, vp, vp, i, vp, i, vp, i,
                           vp])):
            if f.argtypes is None:
                f.argtypes = types
                f.restype = ctypes.c_int
        return lib
    else:
        f, types = lib.qstream_launch, [vp, i, i, i, vp, i, i, i, i, vp, vp,
                                        i, vp, i, vp]
    if f.argtypes is None:
        f.argtypes = types
        f.restype = ctypes.c_int
    return lib


def _pick_tile(dim: int, prefer: int, minimum: int = 128) -> int:
    """Largest power-of-two-ish tile <= prefer that divides dim."""
    t = min(prefer, dim)
    while t >= minimum:
        if dim % t == 0:
            return t
        t //= 2
    return dim  # fall back to the whole dimension


def stream_chunks(pw: PackedWeight) -> tuple[int, int]:
    """(tk, seg) of the streamed kernel for pw: K rows per chunk, chosen
    as the JAX package's `_matmul_streamed` chooses them, and the rows
    one group grid covers inside a chunk, min(group, tk). Raises where
    the JAX package raises."""
    if pw.fmt != "uniform" or len(pw.words) != 1:
        raise ValueError("the streamed kernel takes single-field formats "
                         "(2/4/8-bit) only")
    K = pw.Kp
    sb = subblock(K, pw.groupsize)
    tk = min(2048, K)
    tk = _pick_tile(K, tk) if K % tk else tk
    tk = max(tk, sb)
    g = K // pw.scale.shape[0]
    if not (tk % g == 0 or g % tk == 0) or (g < tk and g < 128):
        raise ValueError("streamed kernel needs group-aligned chunks")
    return tk, min(g, tk)


def _stream_cuda(x2: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Launch csrc/qstream.cu on x2 (M, Kp) -> (M, Np) f32."""
    global stream_launches
    tk, seg = stream_chunks(pw)
    if x2.dtype not in _X_KIND:
        x2 = x2.to(torch.float32)
    x2 = x2.contiguous()
    w, scale, zoff = (pw.words[0].contiguous(), pw.scale.contiguous(),
                      pw.zoff.contiguous())
    for t in (w, scale, zoff):
        if not t.is_cuda or t.device != x2.device:
            raise ValueError("dequant_matmul: weight and activations must "
                             "lie on the same CUDA device")
    fb = FIELD_SPLITS[pw.bits][0][0]
    ng = scale.shape[0]
    if (x2.shape[1] != pw.Kp or w.dtype != torch.int32
            or w.shape != (pw.Kp * fb // 32, pw.Np) or w.data_ptr() % 16
            or scale.dtype != torch.float32 or zoff.dtype != torch.float32
            or scale.shape != (ng, pw.Np) or zoff.shape != scale.shape):
        raise ValueError(f"streamed dequant_matmul: packed weight of "
                         f"K={pw.Kp} N={pw.Np} bits={pw.bits} is malformed")
    M = x2.shape[0]
    out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
    err = _lib("qstream").qstream_launch(
        x2.data_ptr(), _X_KIND[x2.dtype], M, pw.Kp, w.data_ptr(), fb,
        subblock(pw.Kp, pw.groupsize), tk, seg, scale.data_ptr(),
        zoff.data_ptr(), ng, out.data_ptr(), pw.Np,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "qstream_launch")
    stream_launches += 1
    return out


def _matmul_streamed(x2: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """The streamed route on x2 (M, Kp), padded: single-field formats only
    (ValueError otherwise, and for chunks that split a group as the JAX
    package refuses them). Returns (M, Np) f32: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    stream_chunks(pw)
    if not x2.is_cuda:
        return torch.matmul(x2.to(torch.float32),
                            torch.nn.functional.pad(
                                dequant(pw),
                                (0, pw.Np - pw.N, 0, pw.Kp - pw.K)))
    return _stream_cuda(x2, pw)


def matmul_impl() -> str:
    """GPTQ_TPU_MATMUL_IMPL (default `pallas`), checked."""
    impl = os.environ.get("GPTQ_TPU_MATMUL_IMPL", "pallas")
    if impl not in ("pallas", "streamed", "staged", "xla"):
        raise ValueError(f"GPTQ_TPU_MATMUL_IMPL={impl!r}: expected "
                         f"pallas/streamed/staged/xla")
    if impl == "staged":
        raise NotImplementedError(
            "GPTQ_TPU_MATMUL_IMPL=staged: the resident serving mode is not "
            "ported (ROADMAP item 17)")
    return impl


def dequant_matmul(x: torch.Tensor, pw: PackedWeight,
                   a8: bool = False) -> torch.Tensor:
    """y = x @ dequant(pw) (+ bias), with the act-order permutation applied.

    x: (..., K). Returns (..., N) in x's dtype. With a8=True activations
    quantize to int8 per row first (the --faster-kernel serving path).
    The route follows GPTQ_TPU_MATMUL_IMPL (module docstring); a CPU
    tensor runs the plain version on every route but `streamed`, whose
    entry rules it still applies."""
    impl = matmul_impl()
    if impl == "xla" or (impl == "pallas" and not x.is_cuda):
        return dequant_matmul_reference(x, pw, a8=a8)
    lead = x.shape[:-1]
    x2, sx = _prepare(x, pw, a8)
    if impl == "streamed" and len(pw.words) == 1:
        if pw.Kp != x2.shape[1]:
            x2 = torch.nn.functional.pad(x2, (0, pw.Kp - x2.shape[1]))
        y = _matmul_streamed(x2, pw)[:, :pw.N]
    elif not x.is_cuda:  # a 3-bit weight on the streamed route
        return dequant_matmul_reference(x, pw, a8=a8)
    else:
        y = _qmm_cuda(x2, pw)[:, :pw.N]
    return _finish(y, sx, pw, lead, x.dtype)


# ---------------------------------------------------------------------------
# expert banks (PackedExperts)
# ---------------------------------------------------------------------------

def dequant_experts(pe: PackedExperts) -> torch.Tensor:
    """Materialize the dequantized (E, K, N) f32 bank (plain version)."""
    return torch.stack([dequant(pe.expert(e)) for e in range(pe.E)])


def _check_bank(x: torch.Tensor, pe: PackedExperts, what: str):
    """The bank's tensors, contiguous, after the checks every expert
    kernel needs; raises on what csrc/qexpert.cu does not take."""
    words = [w.contiguous() for w in pe.words]
    scale, zoff = pe.scale.contiguous(), pe.zoff.contiguous()
    for t in (*words, scale, zoff):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: bank and activations must lie on the "
                             f"same CUDA device")
    fields = FIELD_SPLITS.get(pe.bits)
    if fields is None or pe.bits == 1:
        raise ValueError(f"{what}: bits={pe.bits} not in (2, 3, 4, 8)")
    E, Kp, Np = pe.E, pe.Kp, pe.Np
    ng = scale.shape[1]
    if (scale.dtype != torch.float32 or zoff.dtype != torch.float32
            or scale.shape != (E, ng, Np) or zoff.shape != scale.shape
            or len(words) != len(fields) or Kp % ng
            or any(w.dtype != torch.int32 or w.shape != (E, Kp * fb // 32, Np)
                   for (fb, _), w in zip(fields, words))):
        raise ValueError(f"{what}: bank of E={E} K={Kp} N={Np} "
                         f"bits={pe.bits} has malformed fields")
    sb = subblock(Kp, pe.groupsize)
    if (Kp // ng) % sb:
        raise ValueError(f"{what}: groups of {Kp // ng} rows do not cover "
                         f"whole {sb}-row subblocks")
    return words, scale, zoff, ng, sb


def _kernel_x(x: torch.Tensor, Kp: int) -> torch.Tensor:
    """x in a dtype the kernels take, K padded to the stored Kp."""
    if x.dtype not in _X_KIND:
        x = x.to(torch.float32)
    if x.shape[-1] != Kp:
        x = torch.nn.functional.pad(x, (0, Kp - x.shape[-1]))
    return x.contiguous()


def _expert_cuda(x: torch.Tensor, pe: PackedExperts) -> torch.Tensor:
    """Launch #8 on x (M, K) or (E, M, K) -> (E, M, Np) f32."""
    global expert_launches
    what = "expert_dequant_matmul"
    per_x = x.dim() == 3
    E, M = pe.E, x.shape[-2]
    if (per_x and x.shape[0] != E) or x.dim() not in (2, 3) \
            or x.shape[-1] not in (pe.K, pe.Kp):
        raise ValueError(f"{what}: x of shape {tuple(x.shape)} does not "
                         f"meet a bank of E={E} K={pe.K}")
    if not 1 <= M <= 32:
        raise ValueError(f"{what}: the batched kernel takes 1..32 rows, "
                         f"got {M}")
    x = _kernel_x(x, pe.Kp)
    words, scale, zoff, ng, sb = _check_bank(x, pe, what)
    out = torch.empty((E, M, pe.Np), dtype=torch.float32, device=x.device)
    err = _lib("qexpert").qexpert_launch(
        x.data_ptr(), _X_KIND[x.dtype], int(per_x), E, M, pe.Kp,
        words[0].data_ptr(), words[1].data_ptr() if len(words) > 1 else None,
        pe.bits, sb, scale.data_ptr(), zoff.data_ptr(), ng, out.data_ptr(),
        pe.Np, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qexpert_launch")
    expert_launches += 1
    return out


def expert_dequant_matmul_reference(x: torch.Tensor,
                                    pe: PackedExperts) -> torch.Tensor:
    """Plain version of expert_dequant_matmul: the dequantized bank, one
    f32 batched product."""
    w = dequant_experts(pe)  # (E, K, N)
    eq = "emk,ekn->emn" if x.dim() == 3 else "mk,ekn->emn"
    return torch.einsum(eq, x.to(torch.float32), w)


def expert_dequant_matmul(x: torch.Tensor, pe: PackedExperts) -> torch.Tensor:
    """y[e] = x[e] @ dequant(pe.expert(e)) for the whole bank in ONE kernel
    launch (#8). x: (M, K) shared by the experts (gate / up) or (E, M, K)
    one per expert (down); M <= 32 on the card. Returns (E, M, N) f32."""
    impl = matmul_impl()
    if impl == "xla" or not x.is_cuda:
        return expert_dequant_matmul_reference(x, pe)
    return _expert_cuda(x, pe)[..., :pe.N]


def _select_cuda(x: torch.Tensor, pe: PackedExperts,
                 e_idx: torch.Tensor) -> torch.Tensor:
    """Launch #9 on x (M, K) with a device int32 expert index -> (M, Np)."""
    global select_launches
    what = "expert_dequant_matmul_select"
    if x.dim() != 2 or x.shape[-1] not in (pe.K, pe.Kp):
        raise ValueError(f"{what}: x of shape {tuple(x.shape)} does not "
                         f"meet a bank of K={pe.K}")
    if (not e_idx.is_cuda or e_idx.device != x.device
            or e_idx.dtype != torch.int32 or e_idx.numel() != 1):
        raise ValueError(f"{what}: the expert index must be one int32 on "
                         f"the activations' CUDA device")
    x = _kernel_x(x, pe.Kp)
    words, scale, zoff, ng, sb = _check_bank(x, pe, what)
    e_idx = e_idx.contiguous()
    M = x.shape[0]
    out = torch.empty((M, pe.Np), dtype=torch.float32, device=x.device)
    err = _lib("qexpert").qselect_launch(
        x.data_ptr(), _X_KIND[x.dtype], M, pe.Kp, words[0].data_ptr(),
        words[1].data_ptr() if len(words) > 1 else None, pe.bits, sb,
        scale.data_ptr(), zoff.data_ptr(), ng, e_idx.data_ptr(), pe.E,
        out.data_ptr(), pe.Np, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qselect_launch")
    select_launches += 1
    return out


def expert_dequant_matmul_select_reference(
        x: torch.Tensor, pe: PackedExperts,
        e_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of expert_dequant_matmul_select."""
    return torch.matmul(x.to(torch.float32), dequant(pe.expert(e_idx)))


def expert_dequant_matmul_select(x: torch.Tensor, pe: PackedExperts,
                                 e_idx: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(pe.expert(e_idx)) with the expert chosen INSIDE the
    kernel (#9): e_idx is a one-element int32 tensor on x's device, read
    by the kernel, so the host never waits for the routing and only the
    chosen expert's words are read. x: (M, K). Returns (M, N) f32."""
    if not x.is_cuda:
        return expert_dequant_matmul_select_reference(x, pe, e_idx)
    return _select_cuda(x, pe, e_idx)[:, :pe.N]
