"""Single-token decode attention straight off the KV cache (port of
gptq_tpu/ops/attention.py: decode_attention, decode_attention_int8 and
decode_attention_wide, whose Pallas kernels compute one function).

`decode_attention` on CUDA tensors launches csrc/attention.cu; on CPU
tensors it runs `decode_attention_reference`, the plain PyTorch version.

    scores[b, hq, t] = sm_scale * ks[b, t, h] * (q[b, hq] . k[b, t, h])
    out[b, hq]       = softmax(scores masked to t < length[b]) @ (vs * v)

with kv head h = hq // G (GQA), and, when given, the current token's own
(not yet written) fresh_k / fresh_v merged as one more softmax column —
the deferred cache write of models.common.model_forward. A row with
length 0 and no fresh pair attends to nothing: its output is zeros (the
JAX package's Pallas kernel and its XLA path disagree there; the port
picks zeros for both its kernel and its plain version).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gptq_tpu_torch.ops import _build

NEG_INF = -1e9

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def _select_layer(layer, k, v, k_scale, v_scale):
    if layer is None:
        return k, v, k_scale, v_scale
    return (k[layer], v[layer],
            None if k_scale is None else k_scale[layer],
            None if v_scale is None else v_scale[layer])


def _lens(length, B: int, device) -> torch.Tensor:
    """scalar or (B,) length -> (B,) int32 on `device`."""
    if isinstance(length, torch.Tensor):
        return length.to(device=device, dtype=torch.int32).expand(B).contiguous()
    return torch.full((B,), int(length), dtype=torch.int32, device=device)


def decode_attention_reference(q, k, v, length, sm_scale: float,
                               k_scale=None, v_scale=None, fresh_k=None,
                               fresh_v=None, layer=None) -> torch.Tensor:
    """Plain PyTorch version of decode_attention (f32 math throughout)."""
    k, v, k_scale, v_scale = _select_layer(layer, k, v, k_scale, v_scale)
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    qf = q.to(torch.float32).reshape(B, Hkv, G, hd)
    sc = torch.einsum("bhgd,bshd->bhgs", qf, kf) * sm_scale
    lens = _lens(length, B, q.device)
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    if fresh_k is not None:
        sf = torch.einsum("bhgd,bhd->bhg", qf,
                          fresh_k.to(torch.float32)) * sm_scale
        sc = torch.cat([sc, sf[..., None]], dim=-1)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p[..., :S], vf)
    if fresh_k is not None:
        out = out + p[..., S:] * fresh_v.to(torch.float32)[:, :, None, :]
    else:  # a row with nothing to attend gives zeros
        out = out * (lens > 0).to(out.dtype)[:, None, None, None]
    return out.reshape(B, H, hd)


_CACHE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_TILE = 64  # cache slots: the unit a split's length is counted in


def _lib():
    lib = _build.load("attention")
    f = lib.attn_launch
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp, vp, vp, i, ll, vp, vp, ll, vp, vp, vp, i, i, i, i,
                      i, ctypes.c_float, i, i, vp, vp, vp, vp]
        f.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(B: int, Hkv: int, S: int, device) -> tuple[int, int]:
    """(nsplit, chunk): cut the S cache slots into runs of `chunk` (a
    multiple of _TILE) so that B * Hkv * nsplit blocks give every SM about
    two, and no run is shorter than a tile."""
    tiles = -(-S // _TILE)
    want = -(-2 * _sm_count(device) // (B * Hkv))
    chunk = -(-tiles // max(1, min(want, tiles))) * _TILE
    return -(-S // chunk), chunk


def _attention_cuda(q, k, v, length, sm_scale, k_scale, v_scale, fresh_k,
                    fresh_v, layer) -> torch.Tensor:
    global launches
    stacked = layer is not None
    if k.dim() != (5 if stacked else 4):
        raise ValueError(f"decode_attention: cache of shape {tuple(k.shape)} "
                         f"with layer={layer}")
    B, H, hd = q.shape
    S, Hkv = k.shape[-3], k.shape[-2]
    if k.dtype not in _CACHE_KIND or v.dtype != k.dtype:
        raise ValueError(f"decode_attention: cache dtype {k.dtype}")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("decode_attention: an int8 cache needs its scale "
                         "planes (and only an int8 cache takes them)")
    if H % Hkv or H // Hkv > 8 or hd not in (64, 128, 256):
        raise ValueError(f"decode_attention: H={H} Hkv={Hkv} hd={hd} not "
                         f"supported (G <= 8, hd in 64 / 128 / 256)")
    if k.shape[-4] != B or v.shape != k.shape:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} / "
                         f"{tuple(v.shape)} for {B} query rows")
    for t in (k, v, k_scale, v_scale, fresh_k, fresh_v):
        if t is not None and t.device != q.device:
            raise ValueError("decode_attention: every tensor must lie on "
                             "the queries' CUDA device")
    for t in (k, v, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("decode_attention: cache tensors must be "
                             "contiguous")
    layer_off = int(layer) * B * S * Hkv * hd if stacked else 0
    scale_off = int(layer) * B * S * Hkv if stacked else 0
    qf = q.to(torch.float32).contiguous()
    fk = fv = None
    if fresh_k is not None:
        fk = fresh_k.to(torch.float32).contiguous()
        fv = fresh_v.to(torch.float32).contiguous()
    lens = _lens(length, B, q.device)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    nsplit, chunk = _splits(B, Hkv, S, q.device)
    # each split's (m, l) and unnormalised output per query head
    pml = torch.empty((B * H * nsplit * 2,), dtype=torch.float32,
                      device=q.device)
    pacc = torch.empty((B * H * nsplit * hd,), dtype=torch.float32,
                       device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().attn_launch(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), _CACHE_KIND[k.dtype],
        layer_off, ptr(k_scale), ptr(v_scale), scale_off, ptr(fk), ptr(fv),
        lens.data_ptr(), B, S, H, Hkv, hd, float(sm_scale), nsplit, chunk,
        pml.data_ptr(), pacc.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_launch")
    launches += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, H, hd) queries for ONE token
    k: torch.Tensor,  # (B, S, Hkv, hd), or (L, B, S, Hkv, hd) with `layer`
    v: torch.Tensor,  # int8 (with scales) or bf16 / f32
    length,           # int or (B,): attend to cache slots < length
    sm_scale: float,
    k_scale: torch.Tensor | None = None,  # (B, S, Hkv) [/ (L, ...)] f32
    v_scale: torch.Tensor | None = None,
    fresh_k: torch.Tensor | None = None,  # (B, Hkv, hd) current token's own
    fresh_v: torch.Tensor | None = None,  # k/v, NOT yet in the cache
    layer: int | None = None,             # index into a stacked cache
) -> torch.Tensor:
    """Returns the (B, H, hd) f32 attention output. CUDA tensors go
    through the CUDA kernel, CPU tensors through the plain version."""
    if not q.is_cuda:
        return decode_attention_reference(
            q, k, v, length, sm_scale, k_scale=k_scale, v_scale=v_scale,
            fresh_k=fresh_k, fresh_v=fresh_v, layer=layer)
    return _attention_cuda(q, k, v, length, sm_scale, k_scale, v_scale,
                           fresh_k, fresh_v, layer)


def decode_attention_int8(q, k, v, k_scale, v_scale, length,
                          sm_scale: float) -> torch.Tensor:
    """int8-cache decode attention (see decode_attention)."""
    return decode_attention(q, k, v, length, sm_scale, k_scale=k_scale,
                            v_scale=v_scale)
