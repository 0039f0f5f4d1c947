"""Tensor-parallel serving on torch.distributed (port of
gptq_tpu/parallel/tp.py).

The Megatron pattern of the JAX package: q / k / v / gate / up / fc1 (and
BLOOM's qkv) are column-sharded, o / down / fc2 row-sharded, activations
replicated, and one all_reduce sums each residual projection's partial
products (models/common._row_linear). Where the JAX package hands
shard_map the whole params with a PartitionSpec tree, each rank here
builds its own local params (`tp_local_view`): the slices that those
specs cut, with every PackedWeight's dims rewritten to the shard's
stored dims. A rank runs each packed linear through dequant_matmul /
bcq_matmul on its shard (the fused routes stand down under tp) and
attention on its local heads.

Constraints, checked with the JAX package's errors: heads and kv heads
divide tp; a PackedWeight's shards start on subblock boundaries (pack
with pack_quantized(..., tp=) / pack_model(..., tp=)); a row shard
carries no baked-in bias; globally fused weights cannot be sliced
(`fuse=True` builds the shard-interleaved fusion, ops/pack.fuse_packed).
An act-order row shard holds its slice of the permutation padded to the
stored K: the pad entries gather x[..., 0] into zero-scale pad rows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gptq_tpu_torch.models.common import (ArchSpec, FusedSplits, KVCache,
                                          ServeFlags, ShardGroup,
                                          model_forward, same_actq)
from gptq_tpu_torch.ops.pack import (PackedExperts, PackedWeight,
                                     fuse_packed, subblock)
from gptq_tpu_torch.parallel.mesh import sharding_rules


def shard_group(group=None) -> ShardGroup:
    """The ShardGroup of this process in `group` (None: the default group;
    a process without an initialised group is the one rank of tp = 1)."""
    if not dist.is_initialized():
        if group is not None:
            raise RuntimeError("shard_group: torch.distributed is not "
                               "initialised")
        return ShardGroup()
    size = dist.get_world_size(group)
    return ShardGroup(group=group if size > 1 else None, size=size,
                      rank=dist.get_rank(group))


def move_params(tree, device):
    """A params tree (dicts, lists, tensors, PackedWeight / PackedExperts)
    on `device`; other leaves (flags, splits) as they are."""
    if isinstance(tree, (torch.Tensor, PackedWeight, PackedExperts)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: move_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [move_params(v, device) for v in tree]
    return tree


def _part(t: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    """The rank's 1/tp slice of t along dim, contiguous."""
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def _check_packed(pw: PackedWeight, kind: str, tp: int, name: str) -> None:
    if kind == "row" and pw.bias is not None:
        # a bias baked into a row shard would be added on every rank and
        # counted tp times in the sum
        raise ValueError(
            f"{name}: row-sharded PackedWeight must not carry a baked-in "
            f"bias (it would be added tp times after the psum); keep the "
            f"bias in the layer dict's 'b' entry instead")
    if kind == "col":
        if pw.Np % tp:
            raise ValueError(f"{name}: stored N {pw.Np} % tp {tp} != 0")
        if pw.fmt != "bcq" and pw.scale.shape[1] % tp:
            raise ValueError(f"{name}: scale cols not divisible by tp")
    else:
        sb = subblock(pw.Kp, pw.groupsize)
        kl = pw.Kp // tp
        if pw.Kp % tp or kl % sb or subblock(kl, pw.groupsize) != sb:
            raise ValueError(
                f"{name}: stored K {pw.Kp} does not split into tp={tp} "
                f"subblock-aligned shards (sb={sb}); pack with "
                f"pack_quantized(..., tp={tp}) to pad for this mesh")
        ng = (pw.scale if pw.fmt != "bcq" else pw.alpha).shape[0]
        if ng > 1 and ng % tp:
            raise ValueError(f"{name}: groups {ng} % tp {tp} != 0")


def _packed_local(pw: PackedWeight, kind: str, tp: int,
                  rank: int) -> PackedWeight:
    """The rank's shard of pw: a column shard splits the stored N (words,
    grids, a baked-in bias; the permutation stays whole, since x is
    replicated), a row shard the stored K (words; grids of several
    groups, while one per-tensor grid replicates; the permutation padded
    to Kp). Logical dims are the shard's stored ones: pad rows and
    columns compute exact zeros."""
    if kind == "col":
        d = -1
        alpha = None if pw.alpha is None else _part(pw.alpha, -1, tp, rank)
        scale = None if pw.scale is None else _part(pw.scale, -1, tp, rank)
        zoff = None if pw.zoff is None else _part(pw.zoff, -1, tp, rank)
        bias = None if pw.bias is None else _part(pw.bias, 0, tp, rank)
        return dataclasses.replace(
            pw, words=tuple(_part(w, d, tp, rank) for w in pw.words),
            scale=scale, zoff=zoff, alpha=alpha, bias=bias, N=pw.Np // tp)
    d = 1 if pw.fmt == "bcq" else 0  # the word axis that follows K
    grid = pw.alpha if pw.fmt == "bcq" else pw.scale

    def g(t):
        if t is None:
            return None
        return _part(t, 0, tp, rank) if grid.shape[0] > 1 else t

    perm = pw.perm
    if perm is not None:
        perm = torch.cat([perm.to(torch.int32),
                          perm.new_zeros(pw.Kp - perm.shape[0],
                                         dtype=torch.int32)])
        perm = _part(perm, 0, tp, rank)
    return dataclasses.replace(
        pw, words=tuple(_part(w, d, tp, rank) for w in pw.words),
        scale=g(pw.scale), zoff=g(pw.zoff), alpha=g(pw.alpha), perm=perm,
        K=pw.Kp // tp, N=pw.Np)


def tp_local_view(spec: ArchSpec, params: dict, tp: int, rank: int,
                  fuse: bool = False, a8: bool = False) -> dict:
    """Rank `rank`'s local params of a tp-way split (on the params'
    device): the slices the JAX package's tp_local_view partition specs
    cut. Column linears keep their rank's output features, row linears
    their input features (biases replicate there), a dense head its vocab
    slice (ServeFlags.vocab_tp) when tp divides the vocab; norms,
    embeddings, routers, expert stacks and a packed head stay whole.
    fuse=True builds the q|k|v (and llama / Gemma gate|up) fusion in the
    shard-interleaved layout, so each rank's slice is a standard fused
    weight of its own column shards; a8=True marks every packed linear
    for dynamic int8 activations (the --faster-kernel path)."""
    if spec.n_heads % tp or spec.kv_heads % tp:
        raise ValueError(
            f"heads ({spec.n_heads}/{spec.kv_heads}) must divide tp={tp}")
    rules = sharding_rules(spec)

    def with_flags(entry, w):
        if a8 and isinstance(w, PackedWeight):
            entry["serve"] = ServeFlags(a8=True)
        return entry

    def lin_view(lin: dict, kind: str, name: str) -> dict:
        w = lin["w"]
        if isinstance(w, PackedWeight):
            _check_packed(w, kind, tp, name)
            lw = _packed_local(w, kind, tp, rank)
        else:
            lw = _part(w, 0 if kind == "col" else 1, tp, rank)
        out = {"w": lw}
        if "b" in lin:
            b = lin["b"]
            out["b"] = (_part(b, 0, tp, rank)
                        if b is not None and kind == "col" else b)
        if "act_q" in lin:
            out["act_q"] = lin["act_q"]
        return with_flags(out, lw)

    def try_fuse_tp(bp, names, li):
        lins = [bp.get(n) for n in names]
        if any(lin is None or not isinstance(lin.get("w"), PackedWeight)
               for lin in lins):
            return None
        ws = [lin["w"] for lin in lins]
        aqs = [lin.get("act_q") for lin in lins]
        if not all(same_actq(aqs[0], aq) for aq in aqs[1:]):
            return None
        if any(w.Np != w.N for w in ws):
            # pad columns would come out as logical outputs after the
            # per-rank split (the splits say stored == logical)
            return None
        for w, n in zip(ws, names):
            _check_packed(w, "col", tp, f"layer{li}.{n}")
        fused = fuse_packed(ws, tp=tp)
        if fused is None:
            return None
        local_w = _packed_local(fused, "col", tp, rank)
        entry = {"w": local_w,
                 "splits": FusedSplits(tuple((w.Np // tp, w.Np // tp)
                                             for w in ws)),
                 "b_parts": [None if lin.get("b") is None else
                             _part(lin["b"], 0, tp, rank) for lin in lins],
                 "act_q": aqs[0]}
        return with_flags(entry, local_w)

    layers = []
    for li, bp in enumerate(params["layers"]):
        if "qkv_fused" in bp or "gateup_fused" in bp:
            raise ValueError(
                "shard_map TP cannot slice a globally-fused weight (its N "
                "concatenates parts); pass unfused params and use "
                "tp_local_view(fuse=True) for the shard-interleaved fusion")
        lp, handled = {}, set()
        if fuse:
            groups = []
            if spec.arch != "bloom":
                groups.append((("q", "k", "v"), "qkv_fused"))
            if spec.arch in ("llama", "gemma"):
                groups.append((("gate", "up"), "gateup_fused"))
            for names, fkey in groups:
                entry = try_fuse_tp(bp, names, li)
                if entry is not None:
                    lp[fkey] = entry
                    handled.update(names)
        for key, val in bp.items():
            if key in handled:
                continue
            lp[key] = (lin_view(val, rules[key], f"layer{li}.{key}")
                       if key in rules else val)
        layers.append(lp)

    lm = params.get("lm_head")
    if (lm is not None and not isinstance(lm.get("w"), PackedWeight)
            and lm["w"].shape[0] % tp == 0):
        # a dense head shards its vocab; head_forward gathers the logits
        lm = {**lm, "w": _part(lm["w"], 0, tp, rank),
              "serve": ServeFlags(vocab_tp=True)}
        if lm.get("b") is not None:
            lm["b"] = _part(lm["b"], 0, tp, rank)
    return {**params, "layers": layers, "lm_head": lm}


def cache_shard(cache: KVCache, tp: int, rank: int) -> KVCache:
    """The rank's slice of a whole KV cache (the JAX package's cache_pspec:
    kv heads split over tp, and with them an int8 cache's scale planes)."""
    def part(t):
        return None if t is None else _part(t, 3, tp, rank)

    return KVCache(k=part(cache.k), v=part(cache.v), length=cache.length,
                   k_scale=part(cache.k_scale), v_scale=part(cache.v_scale))


def local_cache(spec: ArchSpec, tp: int, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> KVCache:
    """An empty cache of one rank: kv_heads / tp heads."""
    local = dataclasses.replace(spec, n_kv_heads=spec.kv_heads // tp)
    return KVCache.init(local, batch, max_len, dtype, device)


def decode_step(spec: ArchSpec, local: dict, tp=None, ep=None):
    """step(cache, token) -> (last-position logits, cache) of a rank's
    local params over its groups (ShardGroups); T > 1 prefills."""
    @torch.no_grad()
    def step(cache: KVCache, token: torch.Tensor):
        logits, cache = model_forward(spec, local, token, cache, tp=tp, ep=ep)
        return logits[:, -1], cache

    return step


def forward(spec: ArchSpec, local: dict, tp=None, ep=None):
    """fwd(ids) -> logits, the cache-less forward (the PPL eval path) of
    a rank's local params over its groups."""
    @torch.no_grad()
    def fwd(ids: torch.Tensor):
        return model_forward(spec, local, ids, tp=tp, ep=ep)[0]

    return fwd


def _tp_local(spec, params, group, fuse, a8, device):
    g = shard_group(group)
    local = tp_local_view(spec, params, g.size, g.rank, fuse=fuse, a8=a8)
    return g, local if device is None else move_params(local, device)


def make_tp_decode_step(spec: ArchSpec, params: dict, group=None,
                        fuse: bool = False, a8: bool = False, device=None):
    """(local_params, step): step(cache, token) -> (last-position logits,
    cache) with every packed matmul on the rank's shard and one
    all_reduce per residual projection over `group` (None: the default
    group). The cache is the rank's (local_cache, or cache_shard of a
    whole one); a token block of T > 1 prefills. fuse / a8 as
    tp_local_view's. `device`, given, receives the local params."""
    g, local = _tp_local(spec, params, group, fuse, a8, device)
    return local, decode_step(spec, local, tp=g)


def make_tp_forward(spec: ArchSpec, params: dict, group=None,
                    fuse: bool = False, a8: bool = False, device=None):
    """(local_params, fwd): fwd(ids) -> logits, the cache-less forward (the
    PPL eval path) under tensor parallelism."""
    g, local = _tp_local(spec, params, group, fuse, a8, device)
    return local, forward(spec, local, tp=g)
