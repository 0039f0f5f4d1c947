"""Single-token decode attention straight off the KV cache (port of
gptq_tpu/ops/attention.py: decode_attention, decode_attention_int8 and
decode_attention_wide, whose Pallas kernels compute one function).

`decode_attention` on CUDA tensors launches csrc/attention_partial.cu in
its decode mode (the partial entries' slot-parallel tiles over the slots
below each row's length, the fresh column merged and the output
normalised in the same launch); on CPU tensors it runs
`decode_attention_reference`, the plain PyTorch version.

    scores[b, hq, t] = sm_scale * ks[b, t, h] * (q[b, hq] . k[b, t, h])
    out[b, hq]       = softmax(scores masked to t < length[b]) @ (vs * v)

with kv head h = hq // G (GQA), and, when given, the current token's own
(not yet written) fresh_k / fresh_v merged as one more softmax column —
the deferred cache write of models.common.model_forward. A row with
length 0 and no fresh pair attends to nothing: its output is zeros (the
JAX package's Pallas kernel and its XLA path disagree there; the port
picks zeros for both its kernel and its plain version).

The partial entries of sequence-parallel decode (port of
decode_attention_partial_wide and decode_attention_partial, kernels #10
and #11) return the unnormalised online-softmax state of one token over a
cache shard whose slots carry global positions `pos` (-1 = empty):

    s[b, hq, t] = sm_scale * ks[b, t, h] * (q[b, hq] . k[b, t, h])
                  [+ slopes[hq] * pos[t]]                   (alibi)
    m = max_t s,  l = sum_t exp(s - m),  acc = sum_t exp(s - m) vs v

over the slots with pos[t] >= 0, in f32. A row with no valid slot gives
m = -inf, l = 0 and acc = 0, in the kernel and in the plain version
alike (the JAX kernels give m = -1e9 there, the JAX package's jnp path
-inf; the combine's max(m, -1e30) shift makes either exact). On CUDA
tensors both entries launch csrc/attention_partial.cu, on CPU tensors
they run the plain version. As in the JAX package, decode_attention_
partial refuses alibi slopes with GQA (G != 1) while the wide entry takes
them; that is the entries' contract, not a limit of the one kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gptq_tpu_torch.ops import _build

NEG_INF = -1e9

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): decode_attention, decode_attention_partial (#11's entry) and
# decode_attention_partial_wide (#10's entry)
launches = 0
partial_launches = 0
partial_wide_launches = 0


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


def _check_cache(what, q, k, v, k_scale, v_scale):
    """The cache layouts csrc/attention_partial.cu takes: one layer's
    contiguous (B, S, Hkv, hd) K and V planes of one dtype (int8 with its
    (B, S, Hkv) scale planes), G <= 8 query heads a kv head, hd 64 / 128 /
    256, every tensor on the queries' device."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.dtype not in _CACHE_KIND or v.dtype != k.dtype:
        raise ValueError(f"{what}: cache dtype {k.dtype}")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError(f"{what}: an int8 cache needs its scale planes (and "
                         f"only an int8 cache takes them)")
    if H % Hkv or H // Hkv > 8 or hd not in (64, 128, 256):
        raise ValueError(f"{what}: H={H} Hkv={Hkv} hd={hd} not supported "
                         f"(G <= 8, hd in 64 / 128 / 256)")
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"{what}: cache {tuple(k.shape)} / {tuple(v.shape)} "
                         f"for {B} query rows")
    for t in (k, v, k_scale, v_scale):
        if t is not None and t.device != q.device:
            raise ValueError(f"{what}: every tensor must lie on the queries' "
                             f"CUDA device")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: cache tensors must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the
    decode mode reads q and the fresh pair by 16-byte cp.async)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _attention_cuda(q, k, v, length, sm_scale, k_scale, v_scale, fresh_k,
                    fresh_v, layer) -> torch.Tensor:
    """One launch of csrc/attention_partial.cu in its decode mode (the
    slots below each row's length, the fresh column merged by the
    cluster's rank 0, the output normalised); a stacked cache's layer is
    a view of it (a base pointer, no copy)."""
    global launches
    if k.dim() != (5 if layer is not None else 4):
        raise ValueError(f"decode_attention: cache of shape {tuple(k.shape)} "
                         f"with layer={layer}")
    k, v, k_scale, v_scale = _select_layer(layer, k, v, k_scale, v_scale)
    _check_cache("decode_attention", q, k, v, k_scale, v_scale)
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    fk = fv = None
    if fresh_k is not None:
        if fresh_k.shape != (B, Hkv, hd) or fresh_v.shape != (B, Hkv, hd):
            raise ValueError(f"decode_attention: fresh pair of shapes "
                             f"{tuple(fresh_k.shape)}, "
                             f"{tuple(fresh_v.shape)}")
        if fresh_k.device != q.device or fresh_v.device != q.device:
            raise ValueError("decode_attention: every tensor must lie on the "
                             "queries' CUDA device")
        fk = _aligned(fresh_k.to(torch.float32).contiguous())
        fv = _aligned(fresh_v.to(torch.float32).contiguous())
    qf = _aligned(q.to(torch.float32).contiguous())
    lens = _lens(length, B, q.device)
    gh, nsplit = partial_grid(B, Hkv, H // Hkv, S, _build.sm_count(q.device))
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    err = _partial_lib().attnd_launch(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), _CACHE_KIND[k.dtype],
        _ptr(k_scale), _ptr(v_scale), lens.data_ptr(), _ptr(fk), _ptr(fv), B,
        S, H, Hkv, gh, hd, float(sm_scale), nsplit, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attnd_launch")
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


# ---------------------------------------------------------------------------
# partial (unnormalised) attention for sequence-parallel decode
# ---------------------------------------------------------------------------

def decode_attention_partial_wide_reference(q, k, v, pos, sm_scale: float,
                                            k_scale=None, v_scale=None,
                                            slopes=None, layer=None):
    """Plain PyTorch version of the partial entries, in f32 (the jnp body
    of the JAX package's parallel/sp.py _sp_partial). Returns (m (B, H),
    l (B, H), acc (B, H, hd))."""
    k, v, k_scale, v_scale = _select_layer(layer, k, v, k_scale, v_scale)
    H = q.shape[1]
    G = H // k.shape[2]
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    if G > 1:
        kf = torch.repeat_interleave(kf, G, dim=2)
        vf = torch.repeat_interleave(vf, G, dim=2)
    qf = q.to(torch.float32) * sm_scale
    sc = torch.einsum("bhd,bshd->bhs", qf, kf)
    pos = pos.to(device=q.device, dtype=torch.int32)
    valid = (pos >= 0)[None, None]
    if slopes is not None:  # HF BLOOM: slope * key_pos (the query position
        # cancels in the softmax)
        sc = sc + slopes.to(torch.float32)[:, None] * pos.to(torch.float32)
    sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    m = sc.amax(dim=-1)
    shift = torch.clamp_min(m, -1e30)
    p = torch.where(valid, torch.exp(sc - shift[..., None]),
                    torch.zeros_like(sc))
    return m, p.sum(dim=-1), torch.einsum("bhs,bshd->bhd", p, vf)


def _check_partial_slopes(q, k, slopes) -> None:
    if slopes is not None and q.shape[1] != k.shape[-2]:
        raise ValueError(f"alibi slopes need G=1 (got H={q.shape[1]}, "
                         f"Hkv={k.shape[-2]})")


def decode_attention_partial_reference(q, k, v, pos, sm_scale: float,
                                       k_scale=None, v_scale=None,
                                       slopes=None, layer=None):
    """Plain version of decode_attention_partial (alibi slopes need G=1)."""
    _check_partial_slopes(q, k, slopes)
    return decode_attention_partial_wide_reference(
        q, k, v, pos, sm_scale, k_scale=k_scale, v_scale=v_scale,
        slopes=slopes, layer=layer)


def _partial_lib():
    lib = _build.load("attention_partial")
    if lib.attnp_launch.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attnp_launch.argtypes = [vp, vp, vp, i, vp, vp, vp, vp, i, i, i,
                                     i, i, i, fl, i, vp, vp, vp, vp]
        lib.attnp_launch.restype = ctypes.c_int
        lib.attnd_launch.argtypes = [vp, vp, vp, i, vp, vp, vp, vp, vp, i, i,
                                     i, i, i, i, fl, i, vp, vp]
        lib.attnd_launch.restype = ctypes.c_int
    return lib


PARTIAL_TILE = 32    # csrc/attention_partial.cu: slots of a shard tile
PARTIAL_SPLITS = 8   # splits at most: one thread block cluster


def partial_grid(B: int, Hkv: int, G: int, S: int, sms: int):
    """(gh, nsplit) of the partial kernel over a shard of S slots: each
    block takes gh of a kv head's G query heads and one of nsplit splits
    of the shard. Splits come first, enough that the B * Hkv * nsplit
    blocks give every SM one, at most PARTIAL_SPLITS (the splits of a
    (batch row, kv head, head group) are one cluster, which merges their
    states in shared memory) and no more than the shard's 32-slot tiles
    (split j takes tiles j, j + nsplit, ...: the SP shard fills its slots
    from the front, so striding keeps the valid ones spread). Then the
    heads split while the blocks still number at most one an SM: shorter
    chains for a block at the cost of rereading the same K and V rows
    from L2."""
    tiles = -(-S // PARTIAL_TILE)
    nsplit = max(1, min(-(-sms // (B * Hkv)), PARTIAL_SPLITS, tiles))
    gh = G
    while gh % 2 == 0 and B * Hkv * (2 * G // gh) * nsplit <= sms:
        gh //= 2
    return gh, nsplit


def _partial_cuda(q, k, v, pos, sm_scale, k_scale, v_scale, slopes, layer):
    """(m, l, acc) from csrc/attention_partial.cu; a stacked cache's layer
    is a view of it (a base pointer, no copy)."""
    if k.dim() != (5 if layer is not None else 4):
        raise ValueError(f"decode_attention_partial: cache of shape "
                         f"{tuple(k.shape)} with layer={layer}")
    k, v, k_scale, v_scale = _select_layer(layer, k, v, k_scale, v_scale)
    _check_cache("decode_attention_partial", q, k, v, k_scale, v_scale)
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if pos.shape != (S,) or pos.device != q.device:
        raise ValueError(f"decode_attention_partial: pos of shape "
                         f"{tuple(pos.shape)} on {pos.device} for {S} slots")
    if slopes is not None and (slopes.shape != (H,)
                               or slopes.device != q.device):
        raise ValueError(f"decode_attention_partial: slopes of shape "
                         f"{tuple(slopes.shape)} for {H} heads")
    qf = q.to(torch.float32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    sl = None if slopes is None else slopes.to(torch.float32).contiguous()
    gh, nsplit = partial_grid(B, Hkv, H // Hkv, S,
                              _build.sm_count(q.device))
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    err = _partial_lib().attnp_launch(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), _CACHE_KIND[k.dtype],
        _ptr(k_scale), _ptr(v_scale), pos.data_ptr(), _ptr(sl), B, S, H, Hkv,
        gh, hd, float(sm_scale), nsplit, m.data_ptr(), l.data_ptr(),
        acc.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attnp_launch")
    return m, l, acc


def decode_attention_partial_wide(
    q: torch.Tensor,  # (B, H, hd) queries for ONE token
    k: torch.Tensor,  # (B, S, Hkv, hd), or (L, B, S, Hkv, hd) with `layer`
    v: torch.Tensor,  # int8 (with scales) or bf16 / f32
    pos: torch.Tensor,  # (S,) int32 global position per slot, -1 = empty
    sm_scale: float,
    k_scale: torch.Tensor | None = None,  # (B, S, Hkv) [/ (L, ...)] f32
    v_scale: torch.Tensor | None = None,
    slopes: torch.Tensor | None = None,   # (H,) alibi slopes (GQA allowed)
    layer: int | None = None,             # index into a stacked cache
):
    """(m (B, H), l (B, H), acc (B, H, hd)) in f32 over the slots with
    pos >= 0 (kernel #10's entry). CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    global partial_wide_launches
    if not q.is_cuda:
        return decode_attention_partial_wide_reference(
            q, k, v, pos, sm_scale, k_scale=k_scale, v_scale=v_scale,
            slopes=slopes, layer=layer)
    out = _partial_cuda(q, k, v, pos, sm_scale, k_scale, v_scale, slopes,
                        layer)
    partial_wide_launches += 1
    return out


def decode_attention_partial(
    q: torch.Tensor,  # (B, H, hd) queries for ONE token
    k: torch.Tensor,  # (B, S, Hkv, hd), or (L, B, S, Hkv, hd) with `layer`
    v: torch.Tensor,
    pos: torch.Tensor,  # (S,) int32 global position per slot, -1 = empty
    sm_scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    slopes: torch.Tensor | None = None,   # (H,) alibi slopes, G = 1 only
    layer: int | None = None,
):
    """decode_attention_partial_wide's function under the narrow entry's
    contract (kernel #11's entry): alibi slopes need H == Hkv."""
    global partial_launches
    _check_partial_slopes(q, k, slopes)
    if not q.is_cuda:
        return decode_attention_partial_wide_reference(
            q, k, v, pos, sm_scale, k_scale=k_scale, v_scale=v_scale,
            slopes=slopes, layer=layer)
    out = _partial_cuda(q, k, v, pos, sm_scale, k_scale, v_scale, slopes,
                        layer)
    partial_launches += 1
    return out
