"""Tensor-parallel sharding rules and the rank layout of a torch.distributed
world (port of gptq_tpu/parallel/mesh.py's rules).

q / k / v / gate / up / fc1 and BLOOM's qkv split their output features
over the tp ranks ("col"), o / down / fc2 their input features ("row"),
as the JAX package's `sharding_rules`. The JAX package places whole
parameter trees on a device mesh (`param_specs` / `shard_params`, GSPMD)
and lets XLA insert the collectives; torch has no counterpart. Here one
process is one rank: each rank builds its own local parameters
(parallel/tp.tp_local_view, parallel/ep.ep_specs) and the model core
calls torch.distributed on explicit groups, which `make_layout` forms.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


def sharding_rules(spec) -> dict:
    """Linear key -> "col" (output features split) or "row" (input)."""
    if spec.arch == "bloom":
        return {"qkv": "col", "o": "row", "fc1": "col", "fc2": "row"}
    if spec.arch in ("llama", "gemma"):
        return {"q": "col", "k": "col", "v": "col", "o": "row",
                "gate": "col", "up": "col", "down": "row"}
    return {"q": "col", "k": "col", "v": "col", "o": "row",
            "fc1": "col", "fc2": "row"}


@dataclass(frozen=True)
class Layout:
    """This rank's place in an (outer, tp) grid of the world: world rank
    r sits at outer index r // tp and tp index r % tp (the tp ranks of one
    outer index are neighbours, as a JAX mesh of shape (outer, tp) lays
    its devices out). `tp_group` / `outer_group` are the process groups
    of this rank's row and column of the grid; None where that size is 1
    (no collective runs over it) or the group is the whole world (the
    default group, which collectives take for None; a reference to it
    kept past destroy_process_group would outlive it to the interpreter's
    exit)."""

    outer: int
    tp: int
    outer_rank: int
    tp_rank: int
    outer_group: object = None
    tp_group: object = None


def make_layout(outer: int, tp: int) -> Layout:
    """The (outer, tp) layout of the initialised default group (outer is
    ep or dp). Every rank calls it with the same sizes: `dist.new_group`
    is collective, so all ranks form every group, in one order."""
    if not dist.is_initialized():
        raise RuntimeError("make_layout needs an initialised torch.distributed "
                           "process group (parallel/distributed.py)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if outer * tp != world:
        raise ValueError(f"layout {outer} x {tp} needs {outer * tp} ranks, "
                         f"the world has {world}")
    tp_group = outer_group = None
    if tp > 1 and outer > 1:
        for i in range(outer):
            g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
            if i == rank // tp:
                tp_group = g
        for j in range(tp):
            g = dist.new_group(list(range(j, world, tp)))
            if j == rank % tp:
                outer_group = g
    return Layout(outer=outer, tp=tp, outer_rank=rank // tp,
                  tp_rank=rank % tp, outer_group=outer_group,
                  tp_group=tp_group)
