"""Sequence (context) parallelism on torch.distributed (port of the sp = 1
.. N, tp = 1 half of gptq_tpu/parallel/sp.py): the ring-attention
prefill, the SPCache that stays sharded over the sp ranks for the whole
serving lifetime, and its decode step.

Each rank of the process group holds one contiguous chunk of the prompt
and runs every positionwise stage on it (weights replicated); attention
runs as a ring: a rank attends its query chunk to the key / value chunk
it holds, passes that chunk to rank (r + 1) % sp with
`dist.batch_isend_irecv`, and takes the next from rank (r - 1) % sp, sp
hops in all, with an online softmax over the hops (Liu et al., "Ring
Attention with Blockwise Transformers", 2023). GQA chunks travel
unexpanded.

The sharded cache (SPCache) keeps each rank's slots local: the rank's
first Tc slots hold its prompt chunk, the rest fill round-robin with
decoded tokens (decode step t lands on rank t mod sp), and a position
plane `pos` (-1 = empty) masks attention by content. A decode step
computes, per layer, this rank's unnormalised online-softmax state over
its slots through the partial-attention kernels (ops/attention.py:
decode_attention_partial_wide, #10, for hd % 128 == 0, else
decode_attention_partial, #11), merges the token's own k / v pair on the
rank whose turn it is, and combines the ranks exactly with one
all_reduce(MAX) and one all_reduce(SUM) of a packed (l, acc) buffer. The
combine always goes through the process group, at sp = 1 too. All
layers' fresh rows land in ONE deferred write after the layer loop (the
slot and `pos` update in place).

A cache length may be a host int or a 0-dim int32 device tensor (the
chained loop of engine/serving.py, which a CUDA graph replays); the
slot, the turn and the writes then stay on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.models.common import (ArchSpec, KVCache, _quantize_kv,
                                          alibi_slopes, block_forward,
                                          embed_forward, head_forward,
                                          rope_tables)
from gptq_tpu_torch.ops.attention import (decode_attention_partial,
                                          decode_attention_partial_wide)


def group_layout(group=None) -> tuple[int, int]:
    """(sp, rank) of this process in `group` (None: the default group)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "sequence parallelism needs an initialised torch.distributed "
            "process group (init_process_group; one rank per sp shard)")
    return dist.get_world_size(group), dist.get_rank(group)


def _peer(group, r: int) -> int:
    """The global rank of group rank r (P2P ops take global ranks)."""
    if group is None or group is dist.GroupMember.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _where(cond, a, b):
    """torch.where for a 0-dim bool tensor condition, plain choice for a
    host bool."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def _slopes(spec: ArchSpec, device):
    if spec.pos != "alibi":
        return None
    return torch.as_tensor(alibi_slopes(spec.n_heads), device=device)


def _ring_attention(spec: ArchSpec, q, k, v, my_chunk: int, sp: int, group,
                    slopes=None) -> torch.Tensor:
    """Online-softmax attention of the local query chunk against all sp
    key / value chunks in ring order (at hop r this rank holds chunk
    (my_chunk - r) mod sp). Future chunks are computed and masked to zero
    probability. Returns (B, Tc, H*hd) like attention()."""
    B, Tc, H, hd = q.shape
    rep = H // k.shape[2]  # GQA: expand inside each hop, move kvh heads
    dev = q.device
    qf = q.to(torch.float32) * spec.scale
    q_pos = (my_chunk * Tc + torch.arange(Tc, device=dev))[:, None]
    m = torch.full((B, H, Tc), float("-inf"), device=dev)
    l = torch.zeros((B, H, Tc), device=dev)
    acc = torch.zeros((B, H, Tc, hd), device=dev)
    kc, vc = k.contiguous(), v.contiguous()
    nxt, prv = _peer(group, (my_chunk + 1) % sp), _peer(group, (my_chunk - 1) % sp)
    # gloo's send / recv hand a CUDA tensor's device pointer to a socket
    # (the process aborts): its hops stage through host copies
    staged = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    for r in range(sp):
        reqs = None
        if r < sp - 1:  # start the next hop's exchange before this one's math
            ks, vs = (kc.cpu(), vc.cpu()) if staged else (kc, vc)
            kn, vn = torch.empty_like(ks), torch.empty_like(vs)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, ks, nxt, group),
                dist.P2POp(dist.irecv, kn, prv, group),
                dist.P2POp(dist.isend, vs, nxt, group),
                dist.P2POp(dist.irecv, vn, prv, group)])
        j = (my_chunk - r) % sp  # the chunk held at this hop
        kr = torch.repeat_interleave(kc, rep, dim=2) if rep > 1 else kc
        vr = torch.repeat_interleave(vc, rep, dim=2) if rep > 1 else vc
        scores = torch.einsum("bthd,bshd->bhts", qf, kr.to(torch.float32))
        k_pos = (j * Tc + torch.arange(Tc, device=dev))[None, :]
        allowed = (k_pos <= q_pos)[None, None]
        if slopes is not None:  # HF BLOOM: slope * (kpos - qpos)
            scores = scores + (slopes[:, None, None]
                               * (k_pos - q_pos).to(torch.float32)[None])
        # explicit zeroing of masked probabilities: an additive -inf under
        # a running max would let a fully masked chunk contribute exp(0)
        scores = torch.where(allowed, scores,
                             torch.full_like(scores, float("-inf")))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        shift = torch.clamp_min(m_new, -1e30)  # finite: never inf - inf
        p = torch.where(allowed, torch.exp(scores - shift[..., None]),
                        torch.zeros_like(scores))
        alpha = torch.exp(torch.clamp_min(m, -1e30) - shift)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, vr.to(torch.float32))
        m = m_new
        if reqs is not None:
            for req in reqs:
                req.wait()
            kc, vc = (kn.to(dev), vn.to(dev)) if staged else (kn, vn)
    out = acc / l[..., None]  # every row has >= 1 allowed key (itself)
    return out.transpose(1, 2).reshape(B, Tc, H * hd).to(q.dtype)


@torch.no_grad()
def _sp_prefill_parts(spec: ArchSpec, params: dict, ids_local, my_chunk: int,
                      sp: int, group):
    """The ring prefill of this rank's (B, Tc) chunk: (logits (B, Tc,
    vocab), ks, vs (L, B, Tc, kvh, hd), the roped keys and values as
    attention saw them, GQA unexpanded)."""
    B, Tc = ids_local.shape
    dev = ids_local.device
    positions = (my_chunk * Tc + torch.arange(Tc, device=dev)).expand(B, Tc)
    rope = rope_tables(spec, positions) if spec.pos == "rope" else None
    slopes = _slopes(spec, dev)
    cell = {}

    def ring_attn(spec_, q, k, v, mask):
        cell["kv"] = (k, v)
        return _ring_attention(spec_, q, k, v, my_chunk, sp, group, slopes)

    h = embed_forward(spec, params, ids_local, positions)
    ks, vs = [], []
    for lp in params["layers"]:
        out, _, _ = block_forward(spec, lp, h, positions=positions, mask=None,
                                  rope=rope, attn_fn=ring_attn)
        h = out.to(h.dtype)
        k, v = cell.pop("kv")
        ks.append(k)
        vs.append(v)
    return head_forward(spec, params, h), torch.stack(ks), torch.stack(vs)


def _gather(x: torch.Tensor, dim: int, sp: int, group) -> torch.Tensor:
    """The ranks' chunks of x, in rank order, concatenated along `dim`."""
    parts = [torch.empty_like(x) for _ in range(sp)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _check_prompt(T: int, sp: int, max_pos: int) -> int:
    if T % sp:
        raise ValueError(f"prompt length {T} must divide by sp={sp}")
    if T > max_pos:
        raise ValueError(f"prompt length {T} > max_pos={max_pos}")
    return T // sp


def make_sp_prefill(spec: ArchSpec, params: dict, group=None,
                    cache_dtype=torch.bfloat16, max_len: int | None = None,
                    device="cuda"):
    """prefill(ids) -> (logits (B, T, vocab), KVCache filled to length T),
    both gathered over the ranks: the full (B, T) prompt arrives on every
    rank (T divisible by sp), each rank runs its chunk, and the returned
    cache (L, B, max_len, kvh, hd) serves models.common.model_forward.
    max_len defaults to spec.max_pos, so decode appends have room."""
    dev = resolve_device(device)
    sp, rank = group_layout(group)

    def prefill(ids):
        ids = torch.as_tensor(ids, device=dev)
        B, T = ids.shape
        Tc = _check_prompt(T, sp, spec.max_pos)
        ml = spec.max_pos if max_len is None else max_len
        if ml < T:
            raise ValueError(f"max_len={ml} < prompt length {T}")
        logits, ks, vs = _sp_prefill_parts(
            spec, params, ids[:, rank * Tc:(rank + 1) * Tc], rank, sp, group)
        logits = _gather(logits, 1, sp, group)
        ks = _gather(ks.to(cache_dtype), 2, sp, group)
        vs = _gather(vs.to(cache_dtype), 2, sp, group)
        pad = (0, 0, 0, 0, 0, ml - T)  # room for decode appends
        return logits, KVCache(k=torch.nn.functional.pad(ks, pad),
                               v=torch.nn.functional.pad(vs, pad), length=T)

    return prefill


# ---------------------------------------------------------------------------
# the sharded cache and its decode step
# ---------------------------------------------------------------------------

@dataclass
class SPCache:
    """This rank's shard of a KV cache that is never gathered. Slots are
    chunk-major: of the global (sp * ml) slot axis, rank d holds
    [d * ml, (d + 1) * ml); its first Tc slots hold prompt positions
    [d * Tc, (d + 1) * Tc) and the rest fill round-robin during decode.

    k / v: (L, B, ml, kvh, hd), int8 (with k_scale / v_scale (L, B, ml,
    kvh) f32 per-token-head scales), bf16 or f32.
    pos: (ml,) int32, the global position of each local slot, -1 = empty.
    length: tokens written on all ranks together (prompt + decoded), a
    host int or a 0-dim int32 tensor on the cache's device.
    meta: (Tc, ml). A decode step writes the buffers and `pos` in place
    and returns a new SPCache over them."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: int | torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    meta: tuple = (0, 0)


def _scatter_one(x: torch.Tensor, ml: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's (L, B, Tc, ...) chunk -> its (L, B, ml, ...) slots: the
    chunk first, zeros after (written into `out` when given)."""
    shape = (*x.shape[:2], ml, *x.shape[3:])
    if out is None:
        out = x.new_zeros(shape)
    elif tuple(out.shape) != shape or out.dtype != x.dtype:
        raise ValueError(f"cache buffer {tuple(out.shape)} {out.dtype} does "
                         f"not fit {shape} {x.dtype}")
    else:
        out[:, :, x.shape[2]:].zero_()
    out[:, :, :x.shape[2]] = x
    return out


def _chunk_positions(T: int, sp: int, ml: int, rank: int) -> np.ndarray:
    """Global position of each of rank `rank`'s ml slots; -1 = empty."""
    Tc = T // sp
    pos = np.full((ml,), -1, np.int32)
    pos[:Tc] = np.arange(rank * Tc, (rank + 1) * Tc, dtype=np.int32)
    return pos


def make_sp_cache_prefill(spec: ArchSpec, params: dict, group=None,
                          cache_dtype=torch.bfloat16,
                          max_len: int | None = None, device="cuda"):
    """prefill(ids, out=None) -> (logits (B, T, vocab) gathered over the
    ranks, this rank's SPCache). The cache stays sharded: per-rank cache
    memory is S / sp for the whole serving lifetime. The capacity
    (max_len, default spec.max_pos) rounds up to a multiple of sp.
    cache_dtype int8 stores dynamically quantized rows with per-token-head
    scales. `out`, an SPCache of this capacity and batch, receives the
    rows and positions in its own buffers (which the returned cache then
    shares), so that no second cache is allocated."""
    dev = resolve_device(device)
    sp, rank = group_layout(group)
    int8 = cache_dtype == torch.int8
    ml_total = spec.max_pos if max_len is None else max_len
    ml = -(-ml_total // sp)

    @torch.no_grad()
    def prefill(ids, out: SPCache | None = None):
        ids = torch.as_tensor(ids, device=dev)
        B, T = ids.shape
        if T % sp:
            raise ValueError(f"prompt length {T} must divide by sp={sp}")
        Tc = T // sp
        if Tc > ml:
            raise ValueError(f"prompt chunk {Tc} > per-rank capacity {ml}")
        logits, ks, vs = _sp_prefill_parts(
            spec, params, ids[:, rank * Tc:(rank + 1) * Tc], rank, sp, group)
        ksc = vsc = None

        def into(x, name):
            return _scatter_one(x, ml, None if out is None
                                else getattr(out, name))

        if int8:
            ks, k_s = _quantize_kv(ks)
            vs, v_s = _quantize_kv(vs)
            ksc, vsc = into(k_s, "k_scale"), into(v_s, "v_scale")
        else:
            ks, vs = ks.to(cache_dtype), vs.to(cache_dtype)
        pos = torch.as_tensor(_chunk_positions(T, sp, ml, rank), device=dev)
        if out is not None:
            pos = out.pos.copy_(pos)
        cache = SPCache(k=into(ks, "k"), v=into(vs, "v"), pos=pos, length=T,
                        k_scale=ksc, v_scale=vsc, meta=(Tc, ml))
        return _gather(logits, 1, sp, group), cache

    return prefill


def _sp_partial(spec: ArchSpec, q, ck, cv, ksc, vsc, pos, slopes,
                layer: int):
    """This rank's (m, l, acc) for one query step against its slots of
    one layer, read in place from the stacked (L, B, ml, kvh, hd) cache:
    kernel #10's entry for hd % 128 == 0 (and for alibi slopes with GQA,
    which the narrow entry refuses), #11's otherwise."""
    B, T, H, hd = q.shape  # T == 1
    wide = hd % 128 == 0 or (slopes is not None and H != ck.shape[3])
    fn = decode_attention_partial_wide if wide else decode_attention_partial
    return fn(q[:, 0], ck, cv, pos, spec.scale, k_scale=ksc, v_scale=vsc,
              slopes=slopes, layer=layer)


def _sp_fresh_combine(spec: ArchSpec, q, k, v, parts, my_turn, length,
                      slopes, group) -> torch.Tensor:
    """Merge the token's own (not yet written) k / v pair into the state
    of the rank whose turn it is, then combine the ranks exactly:
    all_reduce(MAX) of m, all_reduce(SUM) of (w * l, w * acc) packed in
    one buffer. Returns the attention output (B, 1, H*hd)."""
    m, l, acc = parts  # (B, H), (B, H), (B, H, hd)
    B, T, H, hd = q.shape  # T == 1
    rep = H // k.shape[2]
    qf = q[:, 0].to(torch.float32) * spec.scale
    kf = k[:, 0].to(torch.float32)
    vf = v[:, 0].to(torch.float32)
    if rep > 1:
        kf = torch.repeat_interleave(kf, rep, dim=1)
        vf = torch.repeat_interleave(vf, rep, dim=1)
    sf = (qf * kf).sum(dim=-1)  # (B, H) score of the fresh pair
    if slopes is not None:  # the fresh key's position is `length`
        sf = sf + slopes[None, :] * torch.as_tensor(
            length, dtype=torch.float32, device=sf.device)
    sf = _where(my_turn, sf, torch.full_like(sf, float("-inf")))
    m2 = torch.maximum(m, sf)
    shift = torch.clamp_min(m2, -1e30)
    a_old = torch.exp(torch.clamp_min(m, -1e30) - shift)
    p_f = _where(my_turn, torch.exp(sf - shift), torch.zeros_like(sf))
    l2 = l * a_old + p_f
    acc2 = acc * a_old[..., None] + p_f[..., None] * vf
    M = m2.clone()
    dist.all_reduce(M, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(shift - torch.clamp_min(M, -1e30))
    packed = torch.cat([(w * l2)[..., None], w[..., None] * acc2], dim=-1)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    out = packed[..., 1:] / packed[..., :1]
    return out.reshape(B, 1, H * hd).to(q.dtype)


def _write_slot(buf: torch.Tensor, rows: torch.Tensor, my_turn, slot,
                dim: int) -> None:
    """buf[..., slot, ...] = rows along `dim` on the rank whose turn it
    is, in place; the other ranks keep their row. A tensor slot / turn is
    read on the device."""
    rows = rows.to(buf.dtype)
    if isinstance(slot, torch.Tensor):
        old = buf.index_select(dim, slot)
        buf.index_copy_(dim, slot, torch.where(my_turn, rows, old))
    elif my_turn:
        buf.narrow(dim, slot, 1).copy_(rows)


def _sp_write_fresh(cache: SPCache, fresh: list, my_turn, slot,
                    int8: bool) -> None:
    """ONE deferred write of all layers' fresh rows at the owning rank's
    slot (quantized for an int8 cache), and that slot's position."""
    fk = torch.stack([f[0] for f in fresh])  # (L, B, 1, kvh, hd)
    fv = torch.stack([f[1] for f in fresh])
    if int8:
        kq, ksn = _quantize_kv(fk)
        vq, vsn = _quantize_kv(fv)
        writes = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ksn),
                  (cache.v_scale, vsn))
    else:
        writes = ((cache.k, fk), (cache.v, fv))
    for buf, rows in writes:
        _write_slot(buf, rows, my_turn, slot, 2)
    length = torch.as_tensor(cache.length, dtype=torch.int32,
                             device=cache.pos.device).reshape(1)
    _write_slot(cache.pos, length, my_turn, slot, 0)


def make_sp_decode_step(spec: ArchSpec, params: dict, meta: tuple,
                        group=None, int8_cache: bool = False):
    """step(cache: SPCache, token (B, 1)) -> (last logits (B, vocab), the
    SPCache one token longer). Every rank calls it with the same token;
    the token's k / v land on rank t mod sp (t = the decode index). The
    host guards check the scale planes against int8_cache, the meta, and
    (reading the length on the host) the owning rank's room. step.inner
    is the unguarded step (the chained loop's),
    step.weights the params it serves, step.capacity(cache) the total
    slot count."""
    sp, rank = group_layout(group)
    Tc, ml = meta

    @torch.no_grad()
    def _inner(cache: SPCache, token: torch.Tensor):
        B, T = token.shape  # T == 1
        length = cache.length
        t_dec = length - Tc * sp  # decode index
        my_turn = (t_dec % sp) == rank
        slot = Tc + t_dec // sp  # local write slot on the owning rank
        dev = token.device
        if isinstance(length, torch.Tensor):
            slot = slot.reshape(1).to(torch.int64)
            positions = length.reshape(1, 1).expand(B, 1).to(torch.int64)
        else:
            positions = torch.full((B, 1), length, dtype=torch.int64,
                                   device=dev)
        rope = rope_tables(spec, positions) if spec.pos == "rope" else None
        slopes = _slopes(spec, dev)
        ksL = cache.k_scale if int8_cache else None
        vsL = cache.v_scale if int8_cache else None
        fresh = []
        h = embed_forward(spec, params, token, positions)
        for i, lp in enumerate(params["layers"]):
            def decode_attn(spec_, q, k, v, mask, i=i):
                # mask with the OLD pos plane: the fresh token is not in
                # the slots yet (deferred write); it enters once, here
                parts = _sp_partial(spec_, q, cache.k, cache.v, ksL, vsL,
                                    cache.pos, slopes, i)
                fresh.append((k, v))
                return _sp_fresh_combine(spec_, q, k, v, parts, my_turn,
                                         length, slopes, group)

            out, _, _ = block_forward(spec, lp, h, positions=positions,
                                      mask=None, rope=rope,
                                      attn_fn=decode_attn)
            h = out.to(h.dtype)
        logits = head_forward(spec, params, h)
        _sp_write_fresh(cache, fresh, my_turn, slot, int8_cache)
        return logits[:, -1], SPCache(
            k=cache.k, v=cache.v, pos=cache.pos, length=length + 1,
            k_scale=cache.k_scale, v_scale=cache.v_scale, meta=cache.meta)

    def step(cache: SPCache, token: torch.Tensor):
        if int8_cache != (cache.k_scale is not None):
            raise ValueError(
                f"int8_cache={int8_cache} but the cache "
                f"{'has' if cache.k_scale is not None else 'lacks'} scale "
                f"planes: build the step with int8_cache matching the "
                f"prefill's cache_dtype")
        if tuple(cache.meta) != tuple(meta):
            raise ValueError(f"cache.meta {cache.meta} != step meta {meta}")
        # the owning rank's slot would run past its ml slots
        t_dec = int(cache.length) - Tc * sp
        if t_dec >= (ml - Tc) * sp:
            raise ValueError(
                f"SPCache full: {int(cache.length)} tokens stored, "
                f"capacity {Tc * sp + (ml - Tc) * sp} "
                f"(prompt {Tc * sp} + headroom {(ml - Tc) * sp})")
        return _inner(cache, token)

    step.inner = _inner
    step.weights = params
    step.capacity = lambda cache: Tc * sp + (ml - Tc) * sp
    return step
