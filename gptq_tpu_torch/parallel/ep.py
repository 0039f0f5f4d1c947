"""Expert-parallel serving on torch.distributed (port of
gptq_tpu/parallel/ep.py): the expert stacks of an MoE model split over
the ranks of an "ep" group, E / ep experts each.

Activations stay replicated, as under tensor parallelism: every rank
runs the whole router over all tokens, keeps its experts' routing weights
(or its slice of the dispatch / combine tensors), runs its local bank and
one all_reduce over the group sums the outputs (models/moe.moe_ffn). No
all-to-all is needed. Two compositions, as in the JAX package:

* `make_ep_forward` / `make_ep_decode_step`: an ep-only group, every
  other weight whole on every rank;
* `make_ep_tp_forward` / `make_ep_tp_decode_step`: an (ep, tp) layout of
  the world (parallel/mesh.make_layout): attention linears split over the
  rank's tp group (parallel/tp.tp_local_view, the KV cache's heads with
  them), expert stacks over its ep group; the router weight stays whole
  (route() scores every expert).
"""

from __future__ import annotations

from gptq_tpu_torch.models.common import ArchSpec, ShardGroup
from gptq_tpu_torch.ops.pack import PackedExperts
from gptq_tpu_torch.parallel.mesh import Layout
from gptq_tpu_torch.parallel.tp import (decode_step, forward, move_params,
                                        shard_group, tp_local_view)


def _check(spec: ArchSpec, ep: int) -> None:
    if not spec.n_experts:
        raise ValueError("spec has no experts (n_experts == 0)")
    if spec.n_experts % ep:
        raise ValueError(f"n_experts {spec.n_experts} % ep {ep} != 0")


def _expert_slice(val, ep: int, rank: int):
    """Rank `rank`'s E / ep experts of a stack: a PackedExperts bank, a
    dense (E, out, in) stack or an int8 stack's (E, rows) scales."""
    if isinstance(val, PackedExperts):
        el = val.E // ep
        lo = rank * el

        def part(t):
            return t[lo:lo + el].contiguous()

        return PackedExperts(words=tuple(part(w) for w in val.words),
                             scale=part(val.scale), zoff=part(val.zoff),
                             bits=val.bits, K=val.K, N=val.N,
                             groupsize=val.groupsize)
    el = val.shape[0] // ep
    return val[rank * el:(rank + 1) * el].contiguous()


def ep_specs(params: dict, ep: int, rank: int) -> dict:
    """Rank `rank`'s params of an ep-way split: every layer's expert stacks
    sliced on their expert dim (the JAX package's ep_specs: P(axis) on
    dim 0), everything else whole and shared."""
    layers = []
    for bp in params["layers"]:
        if "experts" in bp:
            bp = {**bp, "experts": {k: _expert_slice(v, ep, rank)
                                    for k, v in bp["experts"].items()}}
        layers.append(bp)
    return {**params, "layers": layers}


def _groups(layout: Layout) -> tuple[ShardGroup, ShardGroup]:
    return (ShardGroup(layout.outer_group, layout.outer, layout.outer_rank),
            ShardGroup(layout.tp_group, layout.tp, layout.tp_rank))


def ep_tp_local(spec: ArchSpec, params: dict, layout: Layout,
                fuse: bool = False, a8: bool = False) -> dict:
    """The rank's params on an (ep, tp) layout: tp_local_view over its tp
    group, then its slice of the expert stacks over its ep group."""
    _check(spec, layout.outer)
    local = tp_local_view(spec, params, layout.tp, layout.tp_rank,
                          fuse=fuse, a8=a8)
    return ep_specs(local, layout.outer, layout.outer_rank)


def make_ep_forward(spec: ArchSpec, params: dict, group=None, device=None):
    """(local_params, fwd): fwd(ids) -> logits with the expert stacks split
    over `group` (None: the default group)."""
    g = shard_group(group)
    _check(spec, g.size)
    local = ep_specs(params, g.size, g.rank)
    if device is not None:
        local = move_params(local, device)
    return local, forward(spec, local, ep=g)


def make_ep_decode_step(spec: ArchSpec, params: dict, group=None,
                        device=None):
    """(local_params, step): step(cache, token) -> (last-position logits,
    cache), single-token decode (T > 1 prefills) with the KV cache whole
    on every rank (attention is dense) and only the expert FFN split."""
    g = shard_group(group)
    _check(spec, g.size)
    local = ep_specs(params, g.size, g.rank)
    if device is not None:
        local = move_params(local, device)
    return local, decode_step(spec, local, ep=g)


def make_ep_tp_forward(spec: ArchSpec, params: dict, layout: Layout,
                       device=None):
    """(local_params, fwd) on an (ep, tp) layout (module doc)."""
    local = ep_tp_local(spec, params, layout)
    if device is not None:
        local = move_params(local, device)
    ep, tp = _groups(layout)
    return local, forward(spec, local, tp=tp, ep=ep)


def make_ep_tp_decode_step(spec: ArchSpec, params: dict, layout: Layout,
                           fuse: bool = False, a8: bool = False, device=None):
    """(local_params, step) of MoE serving on an (ep, tp) layout: attention
    linears over the tp group (packed / fused / a8 as tp_local_view's;
    the cache holds the rank's kv heads, parallel/tp.local_cache), expert
    stacks over the ep group, the router whole."""
    local = ep_tp_local(spec, params, layout, fuse=fuse, a8=a8)
    if device is not None:
        local = move_params(local, device)
    ep, tp = _groups(layout)
    return local, decode_step(spec, local, tp=tp, ep=ep)
