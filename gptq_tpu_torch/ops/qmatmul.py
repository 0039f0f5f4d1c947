"""Fused dequantize + matmul for uniform-grid packed weights (port of
gptq_tpu/ops/qmatmul.py: dequant, quantize_acts_int8, _matmul_streamed,
dequant_matmul, and the expert-bank functions dequant_experts,
expert_dequant_matmul, expert_dequant_matmul_select).

`dequant_matmul` routes by GPTQ_TPU_MATMUL_IMPL, as in the JAX package:
  * `pallas` (the default): on a CUDA tensor the hand-written kernels
    that are the counterpart of the Pallas `_qmm_kernel`, chosen by
    `qmm_route` from the row count: csrc/qmatmul.cu's streamed
    single-row kernel (csrc/gemv.cuh `qgemv_kernel`) for one row
    (decode), csrc/qmma.cu on the tensor cores (wgmma, sm_90a) for more
    (batched decode, prefill, PPL eval), and csrc/qmatmul.cu's loop for
    the weights neither takes;
  * `streamed`: single-field (2/4/8-bit) weights take csrc/qstream.cu
    (the counterpart of `_stream_kernel`), which walks K itself, and at
    one row launches the single-row stream of csrc/gemv.cuh
    (`qgemv_kernel`) where that takes the weight; a 3-bit weight takes
    the `pallas` route;
  * `xla`: the plain version, `dequant_matmul_reference`, because the
    caller asked for it;
  * `staged`: the resident serving mode, not ported (ROADMAP item 17).
A CPU tensor always runs the plain version. There is no fallback from a
kernel to the plain version on the card: a launch that fails raises.

Both compute y[m,n] = sum_k x[m,k] * (scale[g(k),n] * c[k,n] - zoff[g(k),n]).

The expert-bank functions serve a PackedExperts bank (models/moe.py):
`expert_dequant_matmul` runs every expert's matmul in one launch of #8,
`expert_dequant_matmul_select` one selected expert's, whose index the
kernel reads from device memory (#9, csrc/qexpert.cu). #8's kernel is
chosen by `expert_route`: csrc/qexpert_mma.cu on the tensor cores where
the bank's subblocks hold a stage window, csrc/qexpert.cu's CUDA-core
loop otherwise.
A CPU tensor runs their plain versions; `xla` runs the batched plain
version on the card too (the select has no `xla` form of its own: the
MoE layer then serves each selection through dequant_matmul).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from gptq_tpu_torch.ops import _build
from gptq_tpu_torch.ops.pack import (FIELD_SPLITS, PackedExperts,
                                     PackedWeight, subblock, unpack_codes)

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): csrc/qmatmul.cu (its single-row kernel and its loop),
# csrc/qmma.cu's uniform kernel, csrc/qstream.cu, csrc/qexpert.cu's two
# and csrc/qexpert_mma.cu
launches = 0
mma_launches = 0
stream_launches = 0
expert_launches = 0
select_launches = 0
expert_mma_launches = 0


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


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (f32) -> (x_hi, x_lo) in bf16: x_hi = bf16(x), x_lo = bf16(x -
    x_hi), so |x - x_hi - x_lo| <= 2^-17 |x|. The tensor-core kernels
    (csrc/qmma.cu) take an f32 x as these two bf16 operands, both against
    the same exact codes: f32 accuracy at the bf16 rate (TF32 keeps 2^-11)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def group_sums(x2: torch.Tensor, ng: int) -> torch.Tensor:
    """x2 (M, Kp) summed over each of ng equal groups of K -> (M, ng) f32
    (int8 rows summed exactly in int32)."""
    g = x2.reshape(x2.shape[0], ng, x2.shape[1] // ng)
    if x2.dtype == torch.int8:
        return g.sum(-1, dtype=torch.int32).to(torch.float32)
    return g.sum(-1, dtype=torch.float32)


def mma_stage_rows(dtype: torch.dtype) -> int:
    """K rows of one stage of the tensor-core kernel: 128 bytes of x a
    row, 128 int8 or 64 bf16 (an f32 x goes in as two bf16 halves)."""
    return 128 if dtype == torch.int8 else 64


@functools.lru_cache(maxsize=64)
def _row_order(Kp: int, sb: int, fbmin: int, stage: int,
               device: torch.device):
    if sb <= stage:
        return None
    J = stage * fbmin // 32           # finest field's words a stage, a plane
    quarter = sb * fbmin // 8         # rows a plane of a subblock
    kt = torch.arange(Kp // stage, device=device).view(-1, 1)
    p = torch.arange(stage, device=device).view(1, -1)
    s, j0 = kt // (sb // stage), (kt % (sb // stage)) * J
    e, q = p // (4 * J), p % (4 * J)
    return (s * sb + e * quarter + 4 * j0 + q).reshape(-1)


def mma_row_order(Kp: int, sb: int, fbmin: int, stage: int,
                  device="cpu") -> torch.Tensor | None:
    """The K order in which the tensor-core kernel (csrc/qmma.cu) takes x's
    columns, or None for the natural order. A stage of `stage` K rows reads
    every code of the words it loads: where a subblock of `sb` rows is
    deeper than a stage, stage kt of subblock s is the word window [j0, j0
    + J) in each of the finest field's E = 8 / fbmin sub-byte planes, so
    its K-slot e * 4J + q is row s * sb + e * (sb * fbmin / 8) + 4 * j0 +
    q. The wrapper gathers x's columns in this order, so the kernel loads
    each stage of x as one contiguous box."""
    return _row_order(Kp, sb, fbmin, stage, torch.device(device))


GEMV_COLS = 128       # csrc/gemv.cuh: columns of a chunk (CC)
GEMV_WARP_ROWS = 4    # ... a consumer warp's word rows of a stage (GRW)
GEMV_MAX_SPLITS = 8   # ... pieces of a chunk: a portable cluster (GMAXS)
GEMV_X_ROOM = 64 * 1024  # most bytes of x a piece stages


def gemv_unit(sb: int, fbmin: int) -> int:
    """K rows of the single-row kernel's unit of a cut: whole subblocks of
    `sb` rows, and in the finest field (`fbmin` bits) whole runs of a
    consumer warp's 4 word rows, so that a piece starts on a subblock and
    on such a run in every field."""
    return max(sb, GEMV_WARP_ROWS * 32 // fbmin)


def gemv_splits(Kp: int, Np: int, sb: int, fbmin: int, x_bytes: int,
                sms: int) -> int:
    """Pieces of each 128-column chunk of the single-row kernel
    (csrc/gemv.cuh), one block and one cluster rank each: as many as keep
    the chunks times the pieces within two blocks an SM (all resident at
    once, each the same share of the weight), at most 8 (a portable
    cluster) and the units of K; more where a piece's staged x row
    (x_bytes an element) would pass 64 KB. The launch takes fewer where
    the card cannot keep that many clusters resident at once (its
    cudaOccupancyMaxActiveClusters)."""
    unit = gemv_unit(sb, fbmin)
    units = -(-Kp // unit)
    top = min(GEMV_MAX_SPLITS, units)
    s = max(1, min(top, 2 * sms // -(-Np // GEMV_COLS)))
    while s < top and -(-units // s) * unit * x_bytes > GEMV_X_ROOM:
        s += 1
    return s


@functools.lru_cache(maxsize=256)
def gemv_cut(Kp: int, Np: int, sb: int, fbmin: int, x_bytes: int,
             device: int) -> tuple[int, int]:
    """(splits, unit) of the single-row kernel on CUDA device `device`."""
    return (gemv_splits(Kp, Np, sb, fbmin, x_bytes, _build.sm_count(device)),
            gemv_unit(sb, fbmin))


def gemv_pieces(Kp: int, unit: int, splits: int) -> list:
    """The single-row kernel's cut of K: piece p takes the K rows [k0,
    k1), whole units (csrc/gemv.cuh gemv_piece)."""
    units = -(-Kp // unit)
    return [(min(Kp, p * units // splits * unit),
             min(Kp, (p + 1) * units // splits * unit))
            for p in range(splits)]


def qmm_route(M: int, bits: int, groupsize: int, dtype: torch.dtype,
              a8: bool = False, Np: int = 128) -> str:
    """The kernel of #1 for an (M, K) x of `dtype` (int8 with a8) against
    a uniform weight of `bits` and `groupsize` (-1: one group):
      * "single_row": M = 1, decode: csrc/qmatmul.cu's qmm_launch, which
        takes the streamed single-row kernel (csrc/gemv.cuh
        qgemv_kernel) where groups cover whole subblocks and Np % 4 == 0,
        and the CUDA-core loop for other weights;
      * "mma": M >= 2: the tensor-core kernel of csrc/qmma.cu. chip_smoke's
        crossover rows (4096x12288 w4 g-1) on an H100 find it faster than
        the CUDA-core loop from M = 2 up for bf16, f32 and int8 x
        (PERF.md);
      * "shallow": M >= 2, but groups shallower than an MMA stage (a
        multiple of 64 K rows at a16, 128 at a8), or an Np that its
        16-byte loads cannot take: the CUDA-core loop of qmatmul.cu."""
    if M <= 1:
        return "single_row"
    stage = mma_stage_rows(torch.int8 if a8 else dtype)
    if ((groupsize > 0 and groupsize % stage) or Np % 4
            or bits not in (2, 3, 4, 8)):
        return "shallow"
    return "mma"


def _mma_ready(t: torch.Tensor) -> torch.Tensor:
    """t contiguous on a 16-byte boundary, as the tensor-core kernels'
    16-byte copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mma_x(x2: torch.Tensor, Kp: int, groupsize: int, fbmin: int):
    """x2 (M, Kp) in the tensor-core kernel's K order (mma_row_order), as
    the operands it takes: (x_a, x_b), x_b the low half of a split f32 x
    or None. A group covers whole subblocks, so the order keeps every
    group's columns together (group_sums is the same before and after)."""
    order = mma_row_order(Kp, subblock(Kp, groupsize), fbmin,
                          mma_stage_rows(x2.dtype), x2.device)
    if order is not None:
        x2 = x2.index_select(1, order)
    if x2.dtype == torch.float32:
        xa, xb = split_bf16(x2)
    else:
        xa, xb = x2, None
    return _mma_ready(xa), None if xb is None else _mma_ready(xb)


def _qmm_mma(x2: torch.Tensor, pw: PackedWeight, words, scale, zoff,
             ng: int) -> torch.Tensor:
    """Launch csrc/qmma.cu's uniform kernel on x2 (M, Kp) f32 / bf16 /
    int8 -> (M, Np) f32."""
    global mma_launches
    M = x2.shape[0]
    xsum = group_sums(x2, ng)
    xa, xb = mma_x(x2, pw.Kp, pw.groupsize, 1 if pw.bits == 3 else pw.bits)
    words = [_mma_ready(w) for w in words]
    out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
    err = _lib("qmma").qmma_launch(
        xa.data_ptr(), None if xb is None else xb.data_ptr(),
        2 if xa.dtype == torch.int8 else 1, M, pw.Kp, words[0].data_ptr(),
        words[1].data_ptr() if len(words) > 1 else None, pw.bits,
        subblock(pw.Kp, pw.groupsize), _mma_ready(scale).data_ptr(),
        _mma_ready(zoff).data_ptr(), xsum.data_ptr(), ng, out.data_ptr(),
        pw.Np, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "qmma_launch")
    mma_launches += 1
    return out


def _qmm_cuda(x2: torch.Tensor, pw: PackedWeight,
              route: str | None = None) -> torch.Tensor:
    """Launch #1 on x2 (M, K) -> (M, Np) f32: the kernel qmm_route picks
    (csrc/qmma.cu for "mma", csrc/qmatmul.cu otherwise), or the one
    `route` names (chip_smoke's crossover rows time both)."""
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
    if route is None:
        route = qmm_route(M, pw.bits, pw.groupsize, x2.dtype, Np=pw.Np)
    if route == "mma":
        return _qmm_mma(x2, pw, words, scale, zoff, ng)
    out = _qmm_launch(x2, pw, words, scale, zoff, ng)
    launches += 1
    return out


def _qmm_launch(x2, pw, words, scale, zoff, ng) -> torch.Tensor:
    """csrc/qmatmul.cu's qmm_launch on checked operands: at one row the
    single-row stream of csrc/gemv.cuh where it takes the weight, else
    qmm_kernel. Counts nothing (its callers do)."""
    fields = FIELD_SPLITS[pw.bits]
    out = torch.empty((x2.shape[0], pw.Np), dtype=torch.float32,
                      device=x2.device)
    sb = subblock(pw.Kp, pw.groupsize)
    # the single-row kernel's 16-byte copies need x on a 16-byte boundary
    # (and the weight's tensors, which it checks: allocations are)
    x2 = _mma_ready(x2)
    splits, unit = gemv_cut(pw.Kp, pw.Np, sb, _fbmin(pw.bits),
                            x2.element_size(), x2.get_device())
    (fb0, sh0), w0 = fields[0], words[0]
    fb1, sh1, w1 = (fields[1][0], fields[1][1], words[1].data_ptr()) \
        if len(fields) > 1 else (0, 0, None)
    err = _lib().qmm_launch(
        x2.data_ptr(), _X_KIND[x2.dtype], x2.shape[0], pw.Kp, w0.data_ptr(),
        fb0, sh0, w1, fb1, sh1, sb, scale.data_ptr(), zoff.data_ptr(), ng,
        out.data_ptr(), pw.Np, splits, unit,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "qmm_launch")
    return out


def _lib(name="qmatmul"):
    lib = _build.load(name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "qmatmul":
        f, types = lib.qmm_launch, [vp, i, i, i, vp, i, i, vp, i, i, i, vp,
                                    vp, i, vp, i, i, i, vp]
    elif name == "qmma":
        for f, types in ((lib.qmma_launch,
                          [vp, vp, i, i, i, vp, vp, i, i, vp, vp, vp, i, vp,
                           i, vp]),
                         (lib.bcq_mma_launch,
                          [vp, vp, i, i, vp, i, i, vp, i, vp, i, vp])):
            if f.argtypes is None:
                f.argtypes = types
                f.restype = ctypes.c_int
        return lib
    elif name == "qexpert_mma":
        f, types = lib.qexpert_mma_launch, [vp, i, vp, vp, vp, i, i, i, i, vp,
                                            vp, i, i, vp, vp, i, i, i, vp, vp,
                                            vp, i, vp]
    elif name == "qexpert":
        for f, types in ((lib.qexpert_launch,
                          [vp, i, i, i, i, i, vp, vp, i, i, vp, vp, i, vp, i,
                           vp]),
                         (lib.qselect_launch,
                          [vp, i, i, i, vp, vp, i, i, vp, vp, i, vp, i, vp, i,
                           i, i, vp])):
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


def _stream_cuda(x2: torch.Tensor, pw: PackedWeight,
                 route: str | None = None) -> torch.Tensor:
    """The streamed route's launch on x2 (M, Kp) -> (M, Np) f32: at one row
    (where groups cover whole subblocks and Np % 4 == 0) #1's single-row
    stream of csrc/gemv.cuh (qmatmul.cu's launch, the same kernel and cut
    as `_qmm_cuda`), else csrc/qstream.cu's qstream_kernel; route="tiles"
    forces qstream_kernel (chip_smoke times both at one row). Either
    counts in stream_launches."""
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
    sb = subblock(pw.Kp, pw.groupsize)
    if (M == 1 and route != "tiles" and (pw.Kp // ng) % sb == 0
            and pw.Np % 4 == 0):
        out = _qmm_launch(x2, pw, [w], scale, zoff, ng)
    else:
        out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
        err = _lib("qstream").qstream_launch(
            x2.data_ptr(), _X_KIND[x2.dtype], M, pw.Kp, w.data_ptr(), fb, sb,
            tk, seg, scale.data_ptr(), zoff.data_ptr(), ng, out.data_ptr(),
            pw.Np, torch.cuda.current_stream(x2.device).cuda_stream)
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


EXPERT_BN = 128  # csrc/qexpert_mma.cu: output columns a block


def _fbmin(bits: int) -> int:
    """The finest field of a uniform weight (a 3-bit one's 1-bit field)."""
    return 1 if bits == 3 else bits


def expert_window(bits: int, sb: int) -> int:
    """J, the word rows of the finest field that one stage of the
    tensor-core #8 takes from each of its planes: 16, or 8 where a
    subblock's plane holds fewer words or the weight is 3-bit (three
    windows of words a stage, and eight planes of x)."""
    return 16 if bits != 3 and (sb * _fbmin(bits) // 32) % 16 == 0 else 8


def expert_route(M: int, bits: int, groupsize: int, dtype: torch.dtype,
                 Kp: int = 4096, Np: int = 128) -> str:
    """The kernel of #8 for M rows of x of `dtype` against a bank of
    `bits` and `groupsize` (-1: one group) stored as Kp x Np:
      * "mma": csrc/qexpert_mma.cu on the tensor cores, where a subblock's
        plane of the finest field holds at least 8 word rows (a stage
        window) and Np % 4 == 0; every x dtype alike (f32 as two bf16
        halves, bf16, int8), as a stage is counted in words, not in x's
        bytes;
      * "shallow": csrc/qexpert.cu's CUDA-core kernel (2-bit groups under
        128 rows, 3-bit groups under 256, 4-bit under 64).
    M must lie in 1..32 (the MoE layer serves more rows per expert with
    #1)."""
    if not 1 <= M <= 32:
        raise ValueError(f"#8 takes 1..32 rows, got {M}")
    if (bits not in (2, 3, 4, 8) or Np % 4
            or subblock(Kp, groupsize) * _fbmin(bits) < 256):
        return "shallow"
    return "mma"


def expert_splits(E: int, Np: int, nk: int, sms: int) -> int:
    """K splits of the tensor-core #8 over its nk stages: one while the
    (column tile, expert) blocks number at least two an SM, else as many
    as make them do (the down bank's 8 x 32 tiles), each keeping 4 stages."""
    base = E * -(-Np // EXPERT_BN)
    if base >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // base), nk // 4))


_TICKETS: dict = {}


def _tickets(device, n: int) -> torch.Tensor:
    """n int32 zeros on `device` for the split-K tickets of
    csrc/qexpert_mma.cu, which leaves them zero after each launch: one
    buffer a device, kept."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _expert_mma(x: torch.Tensor, pe: PackedExperts, words, scale, zoff,
                ng: int, sb: int) -> torch.Tensor:
    """Launch csrc/qexpert_mma.cu on x (M, Kp) or (E, M, Kp) -> (E, M, Np)
    f32: its pass over x (the stage sums, an f32 x's bf16 halves), then the
    tensor-core kernel."""
    global expert_mma_launches
    per_x = x.dim() == 3
    E, M, Kp, Np = pe.E, x.shape[-2], pe.Kp, pe.Np
    J = expert_window(pe.bits, sb)
    nk = Kp * _fbmin(pe.bits) // (32 * J)
    x = _mma_ready(x)
    dev = x.device
    hi = lo = None
    if x.dtype == torch.float32:  # the halves of the split
        hi = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
        lo = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    xst = torch.empty((E if per_x else 1, nk, -(-M // 8) * 8),
                      dtype=torch.float32, device=dev)
    words = [_mma_ready(w) for w in words]
    ks = expert_splits(E, Np, nk, _build.sm_count(dev))
    ws = cnt = None
    if ks > 1:
        ws = torch.empty((ks, E, M, Np), dtype=torch.float32, device=dev)
        cnt = _tickets(dev, E * -(-Np // EXPERT_BN))
    out = torch.empty((E, M, Np), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib("qexpert_mma").qexpert_mma_launch(
        x.data_ptr(), _X_KIND[x.dtype], ptr(hi), ptr(lo), xst.data_ptr(),
        int(per_x), E, M, Kp, words[0].data_ptr(),
        words[1].data_ptr() if len(words) > 1 else None, pe.bits, sb,
        _mma_ready(scale).data_ptr(), _mma_ready(zoff).data_ptr(), ng, J, ks,
        ptr(ws), ptr(cnt), out.data_ptr(), Np,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "qexpert_mma_launch")
    expert_mma_launches += 1
    return out


def _expert_cuda(x: torch.Tensor, pe: PackedExperts,
                 route: str | None = None) -> torch.Tensor:
    """Launch #8 on x (M, K) or (E, M, K) -> (E, M, Np) f32: the kernel
    expert_route picks (csrc/qexpert_mma.cu for "mma", csrc/qexpert.cu
    otherwise), or the one `route` names (chip_smoke times both)."""
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
    if route is None:
        route = expert_route(M, pe.bits, pe.groupsize, x.dtype, pe.Kp, pe.Np)
    if route == "mma":
        return _expert_mma(x, pe, words, scale, zoff, ng, sb)
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


def select_route(M: int, Np: int) -> str:
    """The kernel of #9 for M rows of x against a bank of stored width Np:
      * "single_row": M = 1 (the MoE decode, the only row count the model
        selects at) and Np % 4 == 0: csrc/gemv.cuh's qsel_gemv_kernel,
        #1's single-row design over the selected expert;
      * "rows": csrc/qmv.cuh's qsel_kernel, a block row a row of x.
    Both need groups covering whole subblocks (_check_bank)."""
    return "single_row" if M == 1 and Np % 4 == 0 else "rows"


def _select_cuda(x: torch.Tensor, pe: PackedExperts, e_idx: torch.Tensor,
                 route: str | None = None) -> torch.Tensor:
    """Launch #9 on x (M, K) with a device int32 expert index -> (M, Np):
    the kernel select_route picks, or the one `route` names (chip_smoke
    times both at one row)."""
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
    if route is None:
        route = select_route(M, pe.Np)
    splits = unit = 0  # "rows": qsel_kernel
    if route == "single_row":  # the cut of one expert's Kp x Np
        x = _mma_ready(x)  # its bulk copies need a 16-byte boundary
        splits, unit = gemv_cut(pe.Kp, pe.Np, sb, _fbmin(pe.bits),
                                x.element_size(), x.get_device())
    out = torch.empty((M, pe.Np), dtype=torch.float32, device=x.device)
    err = _lib("qexpert").qselect_launch(
        x.data_ptr(), _X_KIND[x.dtype], M, pe.Kp, words[0].data_ptr(),
        words[1].data_ptr() if len(words) > 1 else None, pe.bits, sb,
        scale.data_ptr(), zoff.data_ptr(), ng, e_idx.data_ptr(), pe.E,
        out.data_ptr(), pe.Np, splits, unit,
        torch.cuda.current_stream(x.device).cuda_stream)
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
