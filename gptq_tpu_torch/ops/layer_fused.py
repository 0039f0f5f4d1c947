"""The whole llama decoder layer at decode time in one launch (port of
gptq_tpu/ops/layer_fused.py).

    ln1 -> q|k|v -> rope(q, k) -> attention over the cache + the fresh row
        -> o -> + residual -> ln2 -> gate|up -> act -> down -> + residual

for one token (B = T = 1, llama family: pre-norm rmsnorm, rope, GLU MLP,
no biases). On CUDA tensors `decode_layer_fused` launches the cooperative
kernel of csrc/layer_fused.cu (the counterpart of the Pallas
`_layer_kernel`); on CPU tensors it runs `decode_layer_fused_reference`,
the plain PyTorch version. There is no fallback from the kernel to the
plain version on the card.

The plain version keeps the JAX kernel's rounding points: ln1's output
rounded to bf16, q|k|v in f32, rope in f32 (rotate-half) with q scaled
by sm_scale, the fresh k / v rows rounded to the CACHE dtype before the
token's own score and value use them, masked slots at NEG_INF, then
o, r2 = bf16(x + o), ln2, gate|up, act, down and y = down + r2, each
matmul's input quantized as an a8 / a16 phase of ops/ffn.py.

The fresh rows are written into the cache at slot `length`, in place
(the JAX kernel returns them for a dynamic_update_slice; the resulting
cache is the same). `length` may be a device int32 tensor, which the
kernel reads from device memory, so a CUDA graph can capture the launch.
A full cache (length >= S) gets no write, where the JAX update would
clamp to slot S - 1.
"""

from __future__ import annotations

import ctypes

import torch

from gptq_tpu_torch.ops import _build
from gptq_tpu_torch.ops import ffn as _ffn
from gptq_tpu_torch.ops.pack import PackedWeight

NEG_INF = -1e9

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

_CACHE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"rmsnorm": 0, "rmsnorm1p": 1}


def layer_fusable(qkv: PackedWeight, splits, o: PackedWeight,
                  gu: PackedWeight, dn: PackedWeight, hidden: int,
                  n_heads: int, n_kv_heads: int,
                  head_dim: int | None = None) -> bool:
    """Can decode_layer_fused serve this block? As the JAX gate: exact
    stored widths on every q|k|v part, uniform streamable weights, o reads
    exactly H*hd, o and down project to exactly `hidden` stored columns,
    even hd, and ffn_fusable(gu, dn)."""
    hd = head_dim or hidden // n_heads
    kvw = n_kv_heads * hd
    if any(ns != nl for ns, nl in splits.parts):
        return False
    if tuple(nl for _, nl in splits.parts) != (n_heads * hd, kvw, kvw):
        return False
    for pw in (qkv, o, gu, dn):
        if pw.fmt != "uniform" or not _ffn._streamable(pw):
            return False
    if qkv.Kp != qkv.K or o.Np != o.N or dn.Np != dn.N:
        return False
    if o.Kp != o.K or o.K != n_heads * hd or o.Np != hidden:
        return False
    if dn.Np != hidden:
        return False
    if hd % 2:
        return False
    return _ffn.ffn_fusable(gu, dn, glu=True)


def _length(length, device) -> torch.Tensor:
    """length (int or tensor) -> a 0-dim int64 tensor on `device`."""
    if isinstance(length, torch.Tensor):
        return length.reshape(()).to(device=device, dtype=torch.int64)
    return torch.tensor(int(length), dtype=torch.int64, device=device)


def _layer_cache(k_cache, v_cache, layer):
    """The (S, Hkv, hd) views of this layer's cache (B = 1)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    if k_cache.dim() != 4 or k_cache.shape[0] != 1 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_layer_fused: cache of shape "
                         f"{tuple(k_cache.shape)} (layer={layer}); B must be 1")
    return k_cache[0], v_cache[0]


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half rope of (n, hd) rows by (hd,) tables, in f32, computed as
    models.common.apply_rope does (the kernel rounds the same products)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[:, half:], x[:, :half]], dim=-1)
    return x * cos + rot * sin


def decode_layer_fused_reference(
        x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2,
        qkv: PackedWeight, o: PackedWeight, gu: PackedWeight,
        dn: PackedWeight, n_heads: int, n_kv_heads: int,
        head_dim: int | None = None, act: str = "silu",
        norm: str = "rmsnorm", eps: float = 1e-5, sm_scale: float = 1.0,
        a8: bool = True, layer: int | None = None) -> torch.Tensor:
    """Plain version of decode_layer_fused: y (1, 1, hidden) f32; writes
    the fresh rows into the cache at slot `length` in place."""
    kc, vc = _layer_cache(k_cache, v_cache, layer)
    hidden = x.shape[-1]
    H, Hkv = n_heads, n_kv_heads
    hd = head_dim or hidden // H
    kvw = Hkv * hd
    S = kc.shape[0]
    pos = _length(length, x.device)
    cs = cos.reshape(-1).to(torch.float32)
    sn = sin.reshape(-1).to(torch.float32)

    x2 = x.reshape(1, hidden).to(torch.float32)
    h1 = _ffn._norm(x2, w_ln1, None, norm, eps)
    row = _ffn._phase(h1, qkv, a8)[0]
    q = rope_rows(row[:H * hd].reshape(H, hd), cs, sn) * sm_scale
    k = rope_rows(row[H * hd:H * hd + kvw].reshape(Hkv, hd), cs, sn)
    v = row[H * hd + kvw:H * hd + 2 * kvw].reshape(Hkv, hd)
    # the fresh rows as the cache holds them (a bf16 rounding point)
    kf = _ffn._bf16(k) if kc.dtype == torch.bfloat16 else k.to(kc.dtype)
    vf = _ffn._bf16(v) if vc.dtype == torch.bfloat16 else v.to(vc.dtype)

    # attention over slots < length (the cache before the write) and the
    # fresh column
    G = H // Hkv
    qg = q.reshape(Hkv, G, hd)
    sc = torch.einsum("hgd,shd->hgs", qg, kc.to(torch.float32))
    valid = torch.arange(S, device=x.device) < pos
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    sf = torch.einsum("hgd,hd->hg", qg, kf.to(torch.float32))
    p = torch.softmax(torch.cat([sc, sf[..., None]], dim=-1), dim=-1)
    attn = (torch.einsum("hgs,shd->hgd", p[..., :S], vc.to(torch.float32))
            + p[..., S:] * vf.to(torch.float32)[:, None, :])

    # the write at slot length (none when the cache is full)
    slot = pos.clamp(max=S - 1).reshape(1)
    full = pos >= S
    for buf, fresh in ((kc, kf), (vc, vf)):
        old = buf.index_select(0, slot)
        buf.index_copy_(0, slot, torch.where(full, old, fresh.to(buf.dtype)[None]))

    o_out = _ffn._phase(attn.reshape(1, H * hd), o, a8)
    r2 = _ffn._bf16(x2 + o_out)
    m2 = _ffn._norm(r2, w_ln2, None, norm, eps)
    g = _ffn._phase(m2, gu, a8)
    half = gu.Np // 2
    inner = _ffn._act(act, g[:, :half], g[:, half:])
    y = _ffn._phase(inner, dn, a8) + r2
    return y[:, :hidden].reshape(1, 1, hidden)


def _lib():
    lib = _build.load("layer_fused")
    f = lib.layer_launch
    if f.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dp = ctypes.POINTER(_ffn._WeightDesc)
        f.argtypes = [vp, vp, vp, i, fl, vp, vp, vp, vp, vp, i, i, i, i, i,
                      fl, i, i, dp, dp, dp, dp, vp, vp, vp, i, vp, vp, vp, vp,
                      vp]
        f.restype = ctypes.c_int
    return lib


def _layer_cuda(x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2, qkv,
                o, gu, dn, n_heads, n_kv_heads, head_dim, act, norm, eps,
                sm_scale, a8, layer):
    """Launch the layer kernel. Returns (y (1, 1, hidden) f32, the
    kernel's f32 scratch rows: {"qkv": the q|k|v row before rope, "attn":
    the attention row, "r2": the residual, "inner": the GLU output})."""
    dev = x.device
    kc, vc = _layer_cache(k_cache, v_cache, layer)
    hidden = x.shape[-1]
    H, Hkv = n_heads, n_kv_heads
    hd = head_dim or hidden // H
    S = kc.shape[0]
    if x.numel() != hidden:
        raise ValueError(f"decode_layer_fused: x of shape {tuple(x.shape)}; "
                         f"the kernel serves one token of one sequence")
    if kc.dtype not in _CACHE_KIND or vc.dtype != kc.dtype:
        raise ValueError(f"decode_layer_fused: cache dtype {kc.dtype} (bf16 "
                         f"or f32; an int8 cache keeps its own route)")
    if kc.shape[1:] != (Hkv, hd) or not (kc.is_contiguous()
                                          and vc.is_contiguous()):
        raise ValueError("decode_layer_fused: the cache must be contiguous "
                         f"(S, {Hkv}, {hd}) rows")
    if norm not in _NORMS or act not in _ffn._ACTS:
        raise ValueError(f"decode_layer_fused: norm {norm!r} / act {act!r}")
    if H % Hkv or hd not in (64, 128, 256):
        raise ValueError(f"decode_layer_fused: H={H} Hkv={Hkv} hd={hd} not "
                         f"supported (hd in 64 / 128 / 256)")
    if (qkv.Kp != hidden or qkv.Np < (H + 2 * Hkv) * hd or o.Kp != H * hd
            or o.Np != hidden or gu.Kp != hidden or gu.Np != 2 * dn.Kp
            or dn.Np != hidden):
        raise ValueError("decode_layer_fused: q|k|v, o, gate|up and down "
                         "widths do not chain (see layer_fusable)")
    if isinstance(length, torch.Tensor):
        if length.device != dev or length.numel() != 1:
            raise ValueError("decode_layer_fused: a tensor length must be "
                             "one value on the activations' device")
        lens = length.reshape(1).to(torch.int32)
    else:
        if not 0 <= int(length) < S:
            raise ValueError(f"decode_layer_fused: length {length} outside "
                             f"[0, {S})")
        lens = torch.full((1,), int(length), dtype=torch.int32, device=dev)
    for t in (kc, vc, cos, sin):
        if t.device != dev:
            raise ValueError("decode_layer_fused: every tensor must lie on "
                             "the activations' CUDA device")
    keep = [lens]
    descs = [_ffn._desc(pw, None, dev, keep) for pw in (qkv, o, gu, dn)]
    n1, _ = _ffn._norm_vecs(w_ln1, None, norm, hidden, dev, keep)
    n2, _ = _ffn._norm_vecs(w_ln2, None, norm, hidden, dev, keep)
    x1 = x.reshape(hidden).to(torch.float32).contiguous()
    cs = cos.reshape(-1).to(torch.float32).contiguous()
    sn = sin.reshape(-1).to(torch.float32).contiguous()
    if cs.numel() != hd or sn.numel() != hd:
        raise ValueError(f"decode_layer_fused: rope tables of {cs.numel()} "
                         f"entries for hd={hd}")
    G = H // Hkv
    nsplit = max(1, min(S, _build.sm_count(dev) // Hkv))

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    qkvo, attn, r2, out = f32(qkv.Np), f32(H * hd), f32(hidden), f32(hidden)
    pml, pacc = f32(Hkv * nsplit * G * 2), f32(Hkv * nsplit * G * hd)
    inner = f32(gu.Np // 2)
    err = _lib().layer_launch(
        x1.data_ptr(), n1, n2, _NORMS[norm], float(eps), cs.data_ptr(),
        sn.data_ptr(), lens.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        _CACHE_KIND[kc.dtype], S, H, Hkv, hd, float(sm_scale),
        _ffn._ACTS[act], int(a8), *(ctypes.byref(d) for d in descs),
        qkvo.data_ptr(), pml.data_ptr(), pacc.data_ptr(), nsplit,
        attn.data_ptr(), r2.data_ptr(), inner.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "layer_launch")
    return out.reshape(1, 1, hidden), {"qkv": qkvo, "attn": attn, "r2": r2,
                                       "inner": inner}


def decode_layer_fused(
        x: torch.Tensor,        # (1, 1, hidden) block input (pre-norm)
        k_cache: torch.Tensor,  # (1, S, Hkv, hd) bf16 / f32, or (L, 1, ...)
        v_cache: torch.Tensor,  # with `layer`
        length,                 # int or device int32 tensor: slots cached
        cos: torch.Tensor,      # (..., hd) rope tables of position `length`
        sin: torch.Tensor,
        w_ln1: torch.Tensor, w_ln2: torch.Tensor,
        qkv: PackedWeight, o: PackedWeight, gu: PackedWeight,
        dn: PackedWeight, n_heads: int, n_kv_heads: int,
        head_dim: int | None = None, act: str = "silu",
        norm: str = "rmsnorm", eps: float = 1e-5, sm_scale: float = 1.0,
        a8: bool = True, layer: int | None = None) -> torch.Tensor:
    """One decoder layer for one token in one launch: returns y (1, 1,
    hidden) f32 and writes the fresh k / v rows into the cache at slot
    `length` in place. CUDA tensors go through csrc/layer_fused.cu, CPU
    tensors through decode_layer_fused_reference."""
    global launches
    if not x.is_cuda:
        return decode_layer_fused_reference(
            x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2, qkv, o, gu,
            dn, n_heads, n_kv_heads, head_dim=head_dim, act=act, norm=norm,
            eps=eps, sm_scale=sm_scale, a8=a8, layer=layer)
    y, _ = _layer_cuda(x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2,
                       qkv, o, gu, dn, n_heads, n_kv_heads, head_dim, act,
                       norm, eps, sm_scale, a8, layer)
    launches += 1
    return y
