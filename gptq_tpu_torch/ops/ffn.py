"""Fused serving kernels: whole phases of a decoder layer in one launch
(port of gptq_tpu/ops/ffn.py).

  norm_qkv_fused:  y = norm(x) @ dequant(W) (+ b)        ln1 + fused q|k|v,
                                                         or final_ln + lm_head
  attn_mlp_fused:  r2 = xres + o(attn) (+ b_o); n = norm(r2);
                   y = r2 + down(act(gate n) * up n)     (llama, glu=True)
                   y = r2 + fc2(act(fc1 n))              (OPT-style, glu=False)
  ffn_fused:       y = down(act(gate m) * up m)

On a CUDA tensor each wrapper launches its hand-written kernel in
csrc/ffn.cu (the counterparts of the Pallas `_norm_qkv_kernel`,
`_attn_mlp_kernel` and `_ffn_kernel`); on a CPU tensor it runs the plain
PyTorch version beside it (`*_reference`). There is no fallback from a
kernel to its plain version on the card: a launch that fails raises.
attn_mlp and ffn at one row on uniform weights (decode) take the weight
stream of the whole-layer kernel (`mlp_route`: csrc/ffn.cu
mlp_stream_kernel, device code in csrc/layer_stream.cuh). norm_qkv at one
row on uniform weights takes the single-row stream of #1 with the norm in
front (`norm_qkv_route`: csrc/gemv.cuh norm_qkv_gemv_kernel, launched from
csrc/ffn.cu). Rows 2 .. 32 (batched decode) on uniform weights take the
tensor-core kernels norm_qkv_rows_kernel / mlp_rows_kernel (csrc/
ffn_rows.cu, device code in csrc/rows.cuh: rows prepared once a phase,
each word streamed once onto mma.sync); BCQ sign planes and the weights
those refuse take the tiled norm_qkv_kernel / mlp_kernel.

The plain versions keep the JAX kernels' rounding points, which differ
from the unfused path: norm_qkv casts x to bf16 at entry and rounds the
norm to bf16; attn_mlp casts xres to bf16 and rounds r2, the norm and the
activation to bf16, and returns down + r2 in f32; ffn reads m as f32.
Every a8 phase quantizes its own whole input row (quantize_acts_int8);
every a16 phase rounds its input to bf16. A weight is uniform-grid codes
or BCQ sign planes (the TPU kernels' BCQ branch); the plain versions
dequantize either over the stored dims, the kernels take either through
the one descriptor.

The fusability gates are written exactly as the JAX package's, so both
packages route the same weights the same way: uniform grids, no act-order
perm, no baked bias, a lane-aligned stored width, and grouped grids only
in groups of at least 128 rows that are multiples of 128.
"""

from __future__ import annotations

import ctypes

import torch

from gptq_tpu_torch.ops import _build
from gptq_tpu_torch.ops.bcq_matmul import bcq_dequant_stored
from gptq_tpu_torch.ops.pack import FIELD_SPLITS, PackedWeight, subblock, unpack_codes
from gptq_tpu_torch.ops.qmatmul import (_fbmin, _mma_ready, gemv_cut,
                                        quantize_acts_int8)

# kernel launches since the last reset, one count per wrapper
# (chip_smoke.py reads and resets them)
norm_qkv_launches = 0
attn_mlp_launches = 0
ffn_launches = 0
# launches of the rows kernels (route "rows") among them
norm_qkv_rows_launches = 0
mlp_rows_launches = 0

MAX_ROWS = 32  # the kernels serve at most this many activation rows
_NORMS = {"rmsnorm": 0, "rmsnorm1p": 1, "layernorm": 2}
_ACTS = {"silu": 0, "gelu": 1, "gelu_tanh": 2, "relu": 3}

# csrc/layer_stream.cuh: a consumer warp's word rows of a stage, a block's
# shared memory, a ring stage's bytes
STREAM_WARP_ROWS = 2
STREAM_SMEM = 232448
STREAM_STAGE = 16384


# csrc/rows.cuh: K rows of an x segment, the most stages of the ring, a
# block's shared memory (the rows kernels, M 2 .. 32)
ROWS_SEGK = 128
ROWS_MAX_STAGES = 8
ROWS_SMEM = 232448
ROWS_STAMPS = 13  # a block's %globaltimer readings (csrc/rows.cuh RSTAMPS)


def rows_ok(pw) -> bool:
    """Does the rows kernel (csrc/rows.cuh) take this weight? Uniform 2, 3,
    4 or 8 bits, a stored width that 128 divides, K and groups in whole
    128-row segments, subblocks of at least 128 rows (csrc/ffn_rows.cu
    rows_weight_ok)."""
    if (pw.fmt != "uniform" or pw.bits not in (2, 3, 4, 8) or pw.Np % 128
            or pw.Kp % ROWS_SEGK):
        return False
    ng = pw.scale.shape[0]
    return (pw.Kp % ng == 0 and (pw.Kp // ng) % ROWS_SEGK == 0
            and subblock(pw.Kp, pw.groupsize) >= ROWS_SEGK)


def _rows_smem(M: int, a8: bool, ws) -> int:
    """The rows kernel's shared-memory bytes for M rows over the weights
    ws, or 0 where no ring of two stages fits (csrc/ffn_rows.cu
    rows_layout)."""
    MP = -(-M // 8) * 8
    kmax = max(pw.Kp for pw in ws)
    fbmin = min(_fbmin(pw.bits) for pw in ws)
    xseg = MP * 128 * (1 if a8 else 2)
    slot = -(-(STREAM_STAGE + 32 * 32 // fbmin // ROWS_SEGK * xseg)
             // 1024) * 1024
    ngmax = max(pw.scale.shape[0] for pw in ws)
    uni = max(2 * MP * 128 * 4 + (MP + MP * ngmax) * 4,
              kmax * 4 + kmax // 16 * 4 + 32)
    uni = -(-uni // 16) * 16
    rest = 1024 + uni + (3 * ROWS_MAX_STAGES + 4) * 8
    ns = min(ROWS_MAX_STAGES, (ROWS_SMEM - rest) // slot)
    return 0 if ns < 2 else rest + ns * slot


def mlp_route(M: int, o, gu, dn, a8: bool = True) -> str:
    """The kernel of #5 (with o) / #6 (o None) for M activation rows:
      * "stream": M = 1 (decode) and every weight uniform, of a stored
        width that 128 divides, in groups of whole runs of the stream's
        consumer-warp word rows (every groupsize the gates pass), K short
        enough that the staged rows leave room for a ring of two stages:
        csrc/ffn.cu mlp_stream_kernel, #12's weight phases;
      * "rows": M = 2 .. 32 (batched decode) and every weight one the rows
        kernel takes (rows_ok), its shared memory fitting: csrc/ffn_rows.cu
        mlp_rows_kernel, on the tensor cores;
      * "tiles": BCQ sign planes and the weights the others refuse, one
        row or more: csrc/ffn.cu mlp_kernel."""
    ws = [pw for pw in (o, gu, dn) if pw is not None]
    if 2 <= M <= MAX_ROWS:
        fits = all(rows_ok(pw) for pw in ws) and _rows_smem(M, a8, ws) > 0
        return "rows" if fits else "tiles"
    if M != 1 or any(pw.fmt != "uniform" or pw.Np % 128 for pw in ws):
        return "tiles"
    for pw in ws:
        ng = pw.scale.shape[0]
        fbmin = 1 if pw.bits == 3 else pw.bits
        if ng > 1 and (pw.Kp // ng) * fbmin // 32 % STREAM_WARP_ROWS:
            return "tiles"
    kmax = max(pw.Kp for pw in ws)
    rows = kmax * (4 + (1 if a8 else 2)) + 16 * 1024  # staged rows, the rest
    return "tiles" if rows + 2 * STREAM_STAGE > STREAM_SMEM else "stream"


def norm_qkv_route(M: int, pw, a8: bool = True) -> str:
    """The kernel of #4 for M activation rows:
      * "stream": M = 1 (decode) and a uniform weight of 2, 3, 4 or 8
        bits, of a stored width that 128 divides, in groups that cover
        whole subblocks: csrc/gemv.cuh norm_qkv_gemv_kernel, #1's
        single-row stream with the norm in front;
      * "rows": M = 2 .. 32 (batched decode) and a weight the rows kernel
        takes (rows_ok), its shared memory fitting: csrc/ffn_rows.cu
        norm_qkv_rows_kernel, on the tensor cores;
      * "tiles": BCQ sign planes and the weights the others refuse:
        csrc/ffn.cu norm_qkv_kernel."""
    if 2 <= M <= MAX_ROWS:
        fits = rows_ok(pw) and _rows_smem(M, a8, [pw]) > 0
        return "rows" if fits else "tiles"
    if (M != 1 or pw.fmt != "uniform" or pw.Np % 128
            or pw.bits not in (2, 3, 4, 8)):
        return "tiles"
    ng = pw.scale.shape[0]
    if pw.Kp % ng or (pw.Kp // ng) % subblock(pw.Kp, pw.groupsize):
        return "tiles"
    return "stream"


# ---------------------------------------------------------------------------
# fusability gates (as gptq_tpu/ops/ffn.py)
# ---------------------------------------------------------------------------

def _pick_chunk(N: int, prefer: int) -> int | None:
    """Largest chunk width <= prefer that divides N, lane-aligned (128)."""
    nc = prefer
    while nc >= 128:
        if N % nc == 0:
            return nc
        nc //= 2
    return None


def _streamable(pw: PackedWeight) -> bool:
    if (pw.fmt not in ("uniform", "bcq") or pw.perm is not None
            or pw.bias is not None or _pick_chunk(pw.Np, 512) is None):
        return False
    ng = (pw.alpha if pw.fmt == "bcq" else pw.scale).shape[0]
    if ng == 1:
        return True
    # grouped grids: groups must tile K in >= 128-row slices
    g = pw.Kp // ng
    return pw.Kp % ng == 0 and g >= 128 and g % 128 == 0


def ffn_fusable(gu: PackedWeight, dn: PackedWeight, glu: bool = True) -> bool:
    if not (_streamable(gu) and _streamable(dn)):
        return False
    if glu:  # stored gate half must feed down's stored K
        return gu.Np == 2 * dn.Kp
    return gu.Np == dn.Kp  # OPT-style fc1 -> fc2


def attn_mlp_fusable(o: PackedWeight, gu: PackedWeight, dn: PackedWeight,
                     glu: bool = True) -> bool:
    if not _streamable(o) or o.Kp != o.K:
        return False
    # stored == logical widths so the residual / norm lanes line up exactly
    if o.Np != o.N or dn.Np != dn.N or o.Np != gu.Kp or dn.N != o.N:
        return False
    return ffn_fusable(gu, dn, glu=glu)


def norm_qkv_fusable(pw: PackedWeight) -> bool:
    return _streamable(pw) and pw.Kp == pw.K


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (a rounding point of the kernels)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dequant_stored(pw: PackedWeight) -> torch.Tensor:
    """The dequantized (Kp, Np) f32 weight over the STORED dims: codes *
    scale - zoff, or for BCQ sum_b alpha[g(k), b, n] * (2 B_b[k, n] - 1)."""
    if pw.fmt == "bcq":
        return bcq_dequant_stored(pw)
    codes = unpack_codes(pw.words, pw.bits, pw.groupsize).to(torch.float32)
    g = pw.Kp // pw.scale.shape[0]
    s = torch.repeat_interleave(pw.scale, g, dim=0)
    z = torch.repeat_interleave(pw.zoff, g, dim=0)
    return codes * s - z


def _phase(x: torch.Tensor, pw: PackedWeight, a8: bool, bias=None):
    """One streamed dequant-matmul phase: x (M, Kp) f32 -> (M, Np) f32.
    a8 quantizes each whole row to int8, a16 rounds it to bf16."""
    w = _dequant_stored(pw)
    if a8:
        xq, sx = quantize_acts_int8(x)
        y = torch.matmul(xq.to(torch.float32), w) * sx
    else:
        y = torch.matmul(_bf16(x), w)
    if bias is not None:
        y = y + _vec(bias, pw.Np)
    return y


def _vec(b: torch.Tensor, n: int) -> torch.Tensor:
    """A bias / norm vector as f32, zero-padded to n entries."""
    b = b.reshape(-1).to(torch.float32)
    return torch.nn.functional.pad(b, (0, n - b.shape[0])) if b.shape[0] < n else b


def _norm(x: torch.Tensor, w: torch.Tensor, b, kind: str, eps: float):
    """x (M, K) f32 -> normalized, scaled (and shifted, layernorm) values
    rounded to bf16 (gptq_tpu/ops/ffn.py:_apply_norm)."""
    w = w.to(torch.float32)[None, :]
    if kind == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + eps) * w
        if b is not None:
            y = y + b.to(torch.float32)[None, :]
    else:
        if kind == "rmsnorm1p":
            w = 1.0 + w
        var = (x * x).mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * w
    return _bf16(y)


def _act(kind: str, g: torch.Tensor, u=None) -> torch.Tensor:
    """act(g) (* u), rounded to bf16 (gptq_tpu/ops/ffn.py:_apply_act)."""
    if kind == "relu":
        a = torch.clamp_min(g, 0.0)
    elif kind == "gelu":
        a = torch.nn.functional.gelu(g, approximate="none")
    elif kind == "gelu_tanh":
        a = torch.nn.functional.gelu(g, approximate="tanh")
    elif kind == "silu":
        a = g * torch.sigmoid(g)
    else:
        raise ValueError(f"activation {kind!r}")
    if u is not None:
        a = a * u
    return _bf16(a)


def _rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., K) -> (M, width) f32, zero-padded on the right to width."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if x2.shape[1] < width:
        x2 = torch.nn.functional.pad(x2, (0, width - x2.shape[1]))
    return x2


def norm_qkv_fused_reference(x, w1, pw: PackedWeight, norm: str = "rmsnorm",
                             eps: float = 1e-5, a8: bool = True, b_ln=None,
                             b_qkv=None) -> torch.Tensor:
    """Plain version of norm_qkv_fused: (..., K) -> (..., Np) in x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).to(torch.float32)
    h = _norm(x2, w1, b_ln, norm, eps)
    y = _phase(h, pw, a8, b_qkv)
    return y.reshape(*lead, pw.Np).to(x.dtype)


def ffn_fused_reference(m, gu: PackedWeight, dn: PackedWeight,
                        act: str = "silu", a8: bool = True) -> torch.Tensor:
    """Plain version of ffn_fused: (..., hidden) -> (..., dn.N)."""
    lead = m.shape[:-1]
    y = _phase(_rows(m, gu.Kp), gu, a8)
    half = gu.Np // 2
    inner = _act(act, y[:, :half], y[:, half:])
    out = _phase(inner, dn, a8)
    return out[:, :dn.N].reshape(*lead, dn.N).to(m.dtype)


def attn_mlp_fused_reference(attn, xres, w2, o: PackedWeight,
                             gu: PackedWeight, dn: PackedWeight,
                             act: str = "silu", norm: str = "rmsnorm",
                             eps: float = 1e-5, glu: bool = True,
                             a8: bool = True, b_ln=None, b_o=None, b_g=None,
                             b_d=None) -> torch.Tensor:
    """Plain version of attn_mlp_fused: (..., K_o) -> (..., dn.N) in attn's
    dtype."""
    lead = attn.shape[:-1]
    a2 = attn.reshape(-1, attn.shape[-1]).to(torch.float32)
    x2 = xres.reshape(-1, xres.shape[-1]).to(torch.bfloat16).to(torch.float32)
    r2 = _bf16(x2 + _phase(a2, o, a8, b_o))
    n = _norm(r2, w2, b_ln, norm, eps)
    y = _phase(n, gu, a8, b_g)
    if glu:
        half = gu.Np // 2
        inner = _act(act, y[:, :half], y[:, half:])
    else:
        inner = _act(act, y)
    out = _phase(inner, dn, a8, b_d) + r2
    return out[:, :dn.N].reshape(*lead, dn.N).to(attn.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class _WeightDesc(ctypes.Structure):
    """Mirror of `WeightDesc` in csrc/ffn.cu."""

    _fields_ = [("w0", ctypes.c_void_p), ("w1", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("zoff", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("bits", ctypes.c_int),
                ("Kp", ctypes.c_int), ("Np", ctypes.c_int),
                ("ng", ctypes.c_int), ("SB", ctypes.c_int),
                ("alpha", ctypes.c_void_p), ("fmt", ctypes.c_int)]


_FMTS = {"uniform": 0, "bcq": 1}  # WeightDesc.fmt (csrc/fused.cuh)


def _desc(pw: PackedWeight, bias, device, keep: list) -> _WeightDesc:
    """Validate a packed weight for the fused kernels and describe it;
    every tensor the kernel reads is appended to `keep`."""
    if pw.fmt not in _FMTS:
        raise ValueError(f"fused kernels: fmt={pw.fmt!r}")
    if pw.perm is not None or pw.bias is not None:
        raise ValueError("fused kernels take no act-order perm and no baked "
                         "bias (see _streamable)")
    sb = subblock(pw.Kp, pw.groupsize)
    if pw.fmt == "bcq":
        words = [w.contiguous() for w in pw.words]
        grids = [pw.alpha.contiguous()]
        ng = grids[0].shape[0]
        bad = (len(words) != 1 or not 1 <= pw.bits <= 8
               or words[0].dtype != torch.int32
               or words[0].shape != (pw.bits, pw.Kp // 32, pw.Np)
               or grids[0].dtype != torch.float32
               or grids[0].shape != (ng, pw.bits, pw.Np))
    else:
        fields = FIELD_SPLITS[pw.bits]
        words = [w.contiguous() for w in pw.words]
        grids = [pw.scale.contiguous(), pw.zoff.contiguous()]
        ng = grids[0].shape[0]
        bad = (len(words) != len(fields)
               or any(g.dtype != torch.float32 or g.shape != (ng, pw.Np)
                      for g in grids)
               or any(w.dtype != torch.int32
                      or w.shape != (pw.Kp * fb // 32, pw.Np)
                      for (fb, _), w in zip(fields, words)))
    if bad or pw.Kp % ng or (pw.Kp // ng) % sb or pw.Np % 32:
        raise ValueError(f"fused kernels: {pw.fmt} packed weight of K={pw.Kp} "
                         f"N={pw.Np} bits={pw.bits} has malformed fields")
    b = None if bias is None else _vec(bias, pw.Np).contiguous()
    for t in (*words, *grids, b):
        if t is not None and t.device != device:
            raise ValueError("fused kernels: weights and activations must lie "
                             "on the same CUDA device")
    keep.extend(t for t in (*words, *grids, b) if t is not None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    bcq = pw.fmt == "bcq"
    return _WeightDesc(
        words[0].data_ptr(), ptr(words[1]) if len(words) > 1 else None,
        None if bcq else grids[0].data_ptr(),
        None if bcq else grids[1].data_ptr(), ptr(b), pw.bits, pw.Kp, pw.Np,
        ng, sb, grids[0].data_ptr() if bcq else None, _FMTS[pw.fmt])


def _norm_vecs(w, b, kind: str, K: int, device, keep: list):
    if kind not in _NORMS:
        raise ValueError(f"norm {kind!r}")
    nw = _mma_ready(w.reshape(-1).to(device=device, dtype=torch.float32))
    if nw.shape[0] != K:
        raise ValueError(f"norm weight of {nw.shape[0]} entries for width {K}")
    nb = None
    if kind == "layernorm":
        nb = (torch.zeros(K, dtype=torch.float32, device=device) if b is None
              else _mma_ready(b.reshape(-1).to(device=device,
                                                dtype=torch.float32)))
    keep.extend(t for t in (nw, nb) if t is not None)
    return nw.data_ptr(), None if nb is None else nb.data_ptr()


def _check_rows(M: int, what: str) -> None:
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"{what}: {M} rows; the kernel serves 1..{MAX_ROWS}")


def _lib():
    lib = _build.load("ffn")
    if lib.norm_qkv_launch.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dp = ctypes.POINTER(_WeightDesc)
        lib.norm_qkv_launch.argtypes = [vp, i, i, vp, vp, i, f, i, dp, vp, i,
                                        i, vp]
        lib.norm_qkv_launch.restype = ctypes.c_int
        lib.mlp_launch.argtypes = [vp, vp, vp, vp, i, f, i, i, i, i, dp, dp, dp,
                                   vp, vp, vp, vp]
        lib.mlp_launch.restype = ctypes.c_int
        lib.mlp_stream_launch.argtypes = [vp, vp, vp, vp, i, f, i, i, i, dp,
                                          dp, dp, vp, vp, vp, vp, vp, vp, vp,
                                          vp, i, i, i, vp, vp, vp, vp, vp, vp,
                                          vp]
        lib.mlp_stream_launch.restype = ctypes.c_int
    return lib


def _rows_lib():
    lib = _build.load("ffn_rows")
    if lib.rows_launch.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dp = ctypes.POINTER(_WeightDesc)
        lib.rows_launch.argtypes = [i, vp, vp, vp, vp, i, f, i, i, i, i, dp,
                                    dp, dp, dp, vp, vp, i, vp, vp, vp, vp, vp,
                                    vp, vp,
                                    vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                    vp]
        lib.rows_launch.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_rows_cuts = {}  # (shapes, device): the plan's chunks cut in K


def rows_cuts(items) -> tuple:
    """The chunks a plan (ops/layer_fused.layer_plan, (n, ITEM) int32) cuts
    in K, which the rows kernels finish after a grid barrier: (table,
    offsets) with table (n, 3) int32 rows (chunk, first piece slot,
    pieces), weight w's from row offsets[w], in (weight, chunk) order."""
    cut = {}
    for head, c, _, _, _, first, *_ in items.tolist():
        if head >> 8 > 1:
            cut[head & 3, c] = (c, first, head >> 8)
    keys = sorted(cut)
    offsets = [sum(1 for w2, _ in keys if w2 < w) for w in range(5)]
    table = torch.tensor([cut[k] for k in keys] or [[0, 0, 0]],
                         dtype=torch.int32)
    return table, offsets


def _rows_cuda(x2, xres2, w, b_ln, norm, eps, act, glu, a8, weights,
               biases, stamps=None) -> torch.Tensor:
    """Launch a rows kernel (csrc/ffn_rows.cu) on x2 (M, K) f32, M 2 ..
    32: weights (q|k|v, o, gate|up, down) with None where absent; only
    q|k|v: #4 (norm_qkv_rows_kernel, norm w / b_ln over x2); else #5 (with
    o: x2 the attention rows, xres2 the residual, the norm over r2) or #6
    (mlp_rows_kernel). The plan is the weight stream's (ops/layer_fused
    layer_plan by shapes, glu off: gate|up is written out before the
    activation) and its chunks cut in K (rows_cuts), the barrier words the
    stream kernels' of this stream, the scratch one allocation. stamps: a
    (blocks, ROWS_STAMPS) int64 tensor the kernel fills with %globaltimer
    readings (rows_timeline reads them), or None. Returns (M, last Np)
    f32."""
    from gptq_tpu_torch.ops import layer_fused as lf

    dev = x2.device
    M = x2.shape[0]
    kind = 0 if weights[0] is not None else 1
    shapes = tuple(None if pw is None else (pw.bits, pw.Kp, pw.Np)
                   for pw in weights)
    plan = lf._device_plan(shapes, dev, False)
    key = (shapes, dev)
    if key not in _rows_cuts:
        table, offsets = rows_cuts(lf.layer_plan(shapes, plan["blocks"],
                                                 False)["items"])
        _rows_cuts[key] = (table.to(dev), (ctypes.c_int * 5)(*offsets))
    cuts, cut_off = _rows_cuts[key]
    stream = _stream(dev)
    sync = lf._sync_words(2, dev, stream)
    keep = [_mma_ready(x2)]
    if xres2 is not None:
        keep.append(xres2.contiguous())
    descs = [None if pw is None else _desc(pw, b, dev, keep)
             for pw, b in zip(weights, biases)]
    nw = nb = None
    if w is not None:  # #4's ln1, #5's ln2
        K = weights[0].Kp if kind == 0 else weights[2].Kp
        nw, nb = _norm_vecs(w, b_ln, norm, K, dev, keep)
    es = 1 if a8 else 2
    sizes = [("sx", 4 * M * 4)]
    for i, pw in enumerate(weights):
        if pw is not None:
            sizes += [(f"xq{i}", M * pw.Kp * es),
                      (f"xs{i}", M * pw.scale.shape[0] * 4)]
    last = weights[0] if kind == 0 else weights[3]
    if weights[1] is not None:
        sizes.append(("r2", M * weights[1].Np * 4))
    if kind == 1:
        sizes.append(("gu", M * weights[2].Np * 4))
    sizes += [("out", M * last.Np * 4),
              ("part", max(1, plan["pieces"]) * M * 128 * 4)]
    offsets, end = {}, 0
    for name, n in sizes:  # 128-byte boundaries (TMA reads the rows)
        offsets[name] = end
        end += -(-n // 128) * 128
    buf = torch.empty(end, dtype=torch.uint8, device=dev)

    def ptr(name):
        return buf.data_ptr() + offsets[name] if name in offsets else None

    err = _rows_lib().rows_launch(
        kind, keep[0].data_ptr(),
        None if xres2 is None else keep[1].data_ptr(), nw, nb,
        _NORMS.get(norm, 0), float(eps), _ACTS.get(act, 0), int(glu),
        int(a8), M, *(None if d is None else ctypes.byref(d) for d in descs),
        plan["items"].data_ptr(), plan["first"].data_ptr(), plan["blocks"],
        cuts.data_ptr(), cut_off, *(ptr(f"xq{i}") for i in range(4)),
        ptr("sx"),
        *(ptr(f"xs{i}") for i in range(4)), ptr("r2"), ptr("gu"),
        ptr("out"), ptr("part"), sync.data_ptr(),
        None if stamps is None else stamps.data_ptr(), stream)
    if err != 0:  # a failed launch may leave a barrier count set
        lf._retire_sync_words(dev, stream)
    _build.check(err, "rows_launch")
    o = offsets["out"]
    return buf[o:o + M * last.Np * 4].view(torch.float32).reshape(M, last.Np)


def rows_timeline(stamps: torch.Tensor, phases: int) -> list:
    """A rows launch's %globaltimer stamps (csrc/rows.cuh RSTAMPS per
    block) as µs from the earliest block's start, the latest block at
    each point: per phase its barrier before the preparation ("wait"), the
    preparation's end ("prep"), the barrier after it ("ready") and the
    product's end ("done")."""
    s = stamps.to(torch.float64).cpu()
    t0 = s[:, 0].min()
    return [{name: float((s[:, 1 + 4 * p + i].max() - t0) / 1e3)
             for i, name in enumerate(("wait", "prep", "ready", "done"))}
            for p in range(phases)]


def _norm_qkv_cuda(x2, w1, pw: PackedWeight, norm, eps, a8, b_ln, b_qkv,
                   route: str | None = None):
    """Launch #4 on x2 (M, K) f32 -> (M, Np) f32: the kernel
    norm_qkv_route picks, or the one `route` names (chip_smoke times them
    against each other): "stream" (M = 1: csrc/gemv.cuh
    norm_qkv_gemv_kernel, with the single-row cut of qmatmul.gemv_cut),
    "rows" (M 2 .. 32: csrc/ffn_rows.cu norm_qkv_rows_kernel) or "tiles"
    (norm_qkv_kernel)."""
    global norm_qkv_rows_launches
    M, K = x2.shape
    _check_rows(M, "norm_qkv_fused")
    if K != pw.Kp:
        raise ValueError(f"norm_qkv_fused: width {K} for a weight of K={pw.Kp}")
    if route is None:
        route = norm_qkv_route(M, pw, a8)
    if route == "rows":
        if norm not in _NORMS:
            raise ValueError(f"norm {norm!r}")
        out = _rows_cuda(x2, None, w1, b_ln, norm, eps, "silu", False, a8,
                         [pw, None, None, None], [b_qkv, None, None, None])
        norm_qkv_rows_launches += 1
        return out
    x2 = _mma_ready(x2)  # the stream reads x as 16-byte vectors
    keep = [x2]
    desc = _desc(pw, b_qkv, x2.device, keep)
    nw, nb = _norm_vecs(w1, b_ln, norm, K, x2.device, keep)
    splits = unit = 0  # "tiles"
    if route == "stream":
        splits, unit = gemv_cut(pw.Kp, pw.Np, desc.SB, _fbmin(pw.bits),
                                1 if a8 else 2, x2.get_device())
    out = torch.empty((M, pw.Np), dtype=torch.float32, device=x2.device)
    err = _lib().norm_qkv_launch(x2.data_ptr(), M, K, nw, nb, _NORMS[norm],
                                 float(eps), int(a8), ctypes.byref(desc),
                                 out.data_ptr(), splits, unit,
                                 _stream(x2.device))
    _build.check(err, "norm_qkv_launch")
    return out


def norm_qkv_fused(x, w1, pw: PackedWeight, norm: str = "rmsnorm",
                   eps: float = 1e-5, a8: bool = True, b_ln=None,
                   b_qkv=None) -> torch.Tensor:
    """y = norm(x) @ dequant(pw) (+ b_qkv) in one launch: (..., K) ->
    (..., Np) in x's dtype. norm is rmsnorm / rmsnorm1p / layernorm (with
    b_ln). A CUDA tensor goes through csrc/ffn.cu, a CPU tensor through
    norm_qkv_fused_reference."""
    global norm_qkv_launches
    if not x.is_cuda:
        return norm_qkv_fused_reference(x, w1, pw, norm=norm, eps=eps, a8=a8,
                                        b_ln=b_ln, b_qkv=b_qkv)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16).to(torch.float32).contiguous()
    out = _norm_qkv_cuda(x2, w1, pw, norm, eps, a8, b_ln, b_qkv)
    norm_qkv_launches += 1
    return out.reshape(*lead, pw.Np).to(x.dtype)


def _mlp_stream(x2, xres2, w2, o, gu, dn, act, norm, eps, glu, a8, b_ln,
                b_o, b_g, b_d) -> torch.Tensor:
    """Launch csrc/ffn.cu's single-row MLP kernel (mlp_route's "stream")
    on x2 (1, K): the plan, barrier / ticket words and weight entries of
    the whole-layer kernel's wrapper (ops/layer_fused: a plan by shapes,
    words by (device, stream), each weight's descriptor and TMA maps
    cached on its tensors). Returns (1, dn.Np) f32."""
    from gptq_tpu_torch.ops import layer_fused as lf

    dev = x2.device
    ents = [None if pw is None else lf._weight_entry(pw, dev)
            for pw in (None, o, gu, dn)]
    shapes = tuple(None if e is None else e[2] for e in ents)
    plan = lf._device_plan(shapes, dev, glu)
    stream = _stream(dev)
    sync = lf._sync_words(2 + plan["tickets"], dev, stream)
    keep = [_mma_ready(x2)]
    biases = []
    for pw, b in ((o, b_o), (gu, b_g), (dn, b_d)):
        if b is not None:
            b = _vec(b, pw.Np).contiguous()
            if b.device != dev:
                raise ValueError("fused kernels: weights and activations "
                                 "must lie on the same CUDA device")
            keep.append(b)
        biases.append(None if b is None else b.data_ptr())
    nw = nb = None
    if o is not None:
        nw, nb = _norm_vecs(w2, b_ln, norm, gu.Kp, dev, keep)
    # the f32 scratch rows in one allocation, each 16-byte aligned
    offsets, end = {}, 0
    for name, n in (("r2", gu.Kp), ("gu", gu.Np), ("inner", dn.Kp),
                    ("out", dn.Np), ("part", max(1, plan["pieces"]) * 128)):
        offsets[name] = end
        end += -(-n // 4) * 4
    buf = torch.empty(end, dtype=torch.float32, device=dev)
    ptr = {k: buf.data_ptr() + 4 * v for k, v in offsets.items()}
    err = _lib().mlp_stream_launch(
        keep[0].data_ptr(), None if xres2 is None else xres2.data_ptr(), nw,
        nb, _NORMS.get(norm, 0), float(eps), _ACTS[act], int(glu), int(a8),
        *(None if e is None else ctypes.byref(e[0]) for e in ents[1:]),
        *(None if e is None else e[1] for e in ents[1:]), *biases,
        plan["items"].data_ptr(), plan["first"].data_ptr(), plan["blocks"],
        plan["max_items"], plan["max_cut"], ptr["r2"], ptr["gu"],
        ptr["inner"], ptr["out"], ptr["part"], sync.data_ptr(), stream)
    if err != 0:  # a failed launch may leave a count or a ticket set
        lf._retire_sync_words(dev, stream)
    _build.check(err, "mlp_stream_launch")
    out = offsets["out"]
    return buf[out:out + dn.Np].reshape(1, dn.Np)


def _mlp_cuda(x2, xres2, w2, o, gu, dn, act, norm, eps, glu, a8, b_ln, b_o,
              b_g, b_d, route: str | None = None) -> torch.Tensor:
    """Launch #5 (with `o`: the whole attn_mlp) or #6 (without it: gate|up,
    act, down) on the kernel mlp_route picks, or the one `route` names
    (chip_smoke times them against each other): "stream" (M = 1: csrc/
    ffn.cu mlp_stream_kernel), "rows" (M 2 .. 32: csrc/ffn_rows.cu
    mlp_rows_kernel) or "tiles" (the cooperative mlp_kernel). Returns (M,
    dn.Np) f32."""
    global mlp_rows_launches
    dev = x2.device
    M = x2.shape[0]
    if act not in _ACTS:
        raise ValueError(f"activation {act!r}")
    if route is None:
        route = mlp_route(M, o, gu, dn, a8)
    if route == "stream":
        return _mlp_stream(x2, xres2, w2, o, gu, dn, act, norm, eps, glu, a8,
                           b_ln, b_o, b_g, b_d)
    if route == "rows":
        if o is not None and norm not in _NORMS:
            raise ValueError(f"norm {norm!r}")
        out = _rows_cuda(x2, xres2, w2 if o is not None else None, b_ln,
                         norm, eps, act, glu, a8, [None, o, gu, dn],
                         [None, b_o, b_g, b_d])
        mlp_rows_launches += 1
        return out
    keep = [x2]
    od = None if o is None else _desc(o, b_o, dev, keep)
    gd = _desc(gu, b_g, dev, keep)
    dd = _desc(dn, b_d, dev, keep)
    nw = nb = r2 = None
    if o is not None:  # ln2 over r2, the (M, hidden) scratch of phase 1
        keep.append(xres2)
        nw, nb = _norm_vecs(w2, b_ln, norm, gu.Kp, dev, keep)
        r2 = torch.empty((M, gu.Kp), dtype=torch.float32, device=dev)
    inner = torch.empty((M, gu.Np // 2 if glu else gu.Np), dtype=torch.float32,
                        device=dev)
    out = torch.empty((M, dn.Np), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().mlp_launch(
        x2.data_ptr(), ptr(xres2), nw, nb, _NORMS.get(norm, 0), float(eps),
        _ACTS[act], int(glu), int(a8), M,
        None if od is None else ctypes.byref(od), ctypes.byref(gd),
        ctypes.byref(dd), ptr(r2), inner.data_ptr(), out.data_ptr(),
        _stream(dev))
    _build.check(err, "mlp_launch")
    return out


def ffn_fused(m, gu: PackedWeight, dn: PackedWeight, act: str = "silu",
              a8: bool = True) -> torch.Tensor:
    """y = down(act(gate(m)) * up(m)) in one launch: (..., hidden) ->
    (..., dn.N) in m's dtype. gu: the fused gate|up weight. A CUDA tensor
    goes through csrc/ffn.cu, a CPU tensor through ffn_fused_reference."""
    global ffn_launches
    if not m.is_cuda:
        return ffn_fused_reference(m, gu, dn, act=act, a8=a8)
    lead = m.shape[:-1]
    x2 = _rows(m, gu.Kp).contiguous()
    _check_rows(x2.shape[0], "ffn_fused")
    if m.shape[-1] > gu.Kp or gu.Np != 2 * dn.Kp:
        raise ValueError("ffn_fused: gate|up and down widths do not chain")
    out = _mlp_cuda(x2, None, None, None, gu, dn, act, "rmsnorm", 0.0, True,
                    a8, None, None, None, None)
    ffn_launches += 1
    return out[:, :dn.N].reshape(*lead, dn.N).to(m.dtype)


def attn_mlp_fused(attn, xres, w2, o: PackedWeight, gu: PackedWeight,
                   dn: PackedWeight, act: str = "silu", norm: str = "rmsnorm",
                   eps: float = 1e-5, glu: bool = True, a8: bool = True,
                   b_ln=None, b_o=None, b_g=None, b_d=None) -> torch.Tensor:
    """The whole post-attention half of a decoder block in one launch:
    y = r2 + down(act(gate n) * up n) (glu) or r2 + fc2(act(fc1 n)), with
    n = norm(r2), r2 = xres + o(attn) (+ b_o). (..., K_o) -> (..., dn.N) in
    attn's dtype. A CUDA tensor goes through csrc/ffn.cu, a CPU tensor
    through attn_mlp_fused_reference."""
    global attn_mlp_launches
    if not attn.is_cuda:
        return attn_mlp_fused_reference(
            attn, xres, w2, o, gu, dn, act=act, norm=norm, eps=eps, glu=glu,
            a8=a8, b_ln=b_ln, b_o=b_o, b_g=b_g, b_d=b_d)
    lead = attn.shape[:-1]
    a2 = attn.reshape(-1, attn.shape[-1]).to(torch.float32).contiguous()
    x2 = (xres.reshape(-1, xres.shape[-1]).to(torch.bfloat16)
          .to(torch.float32).contiguous())
    _check_rows(a2.shape[0], "attn_mlp_fused")
    if (a2.shape[1] != o.Kp or x2.shape != (a2.shape[0], o.Np)
            or o.Np != gu.Kp or gu.Np != (2 if glu else 1) * dn.Kp
            or dn.Np != o.Np):
        raise ValueError("attn_mlp_fused: o, gate|up and down widths do not "
                         "chain (see attn_mlp_fusable)")
    out = _mlp_cuda(a2, x2, w2, o, gu, dn, act, norm, eps, glu, a8, b_ln, b_o,
                    b_g, b_d)
    attn_mlp_launches += 1
    return out[:, :dn.N].reshape(*lead, dn.N).to(attn.dtype)
