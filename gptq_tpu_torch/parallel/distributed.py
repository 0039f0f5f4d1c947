"""Process-group start-up under torchrun (port of
gptq_tpu/parallel/distributed.py's init_distributed).

`torchrun --nproc-per-node N` starts one process per rank and sets
WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. On CUDA, rank
r runs on cuda:(LOCAL_RANK % device_count): a card of its own where the
host has one per rank, else ranks share cards. NCCL needs a card per
rank (it refuses two ranks on one device), so the group is NCCL only
when every local rank has a card of its own, and gloo otherwise and on
the CPU. Gloo moves CUDA tensors through host copies, and a CUDA graph
cannot capture its collectives (`graph_capable`). Rank 0 prints the
backend and the device of every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(device="cuda", log=print) -> torch.device:
    """This rank's device; joins the default process group if none is up.
    `device` names the kind ("cuda" or "cpu"); a CUDA device is made
    current."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA asked for, but no "
                               "CUDA device is available")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
        devices = [f"cuda:{r % cards}" for r in range(local_world)]
    else:
        backend = "gloo"
        devices = ["cpu"] * local_world
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    backend = dist.get_backend()
    if dist.get_rank() == 0:
        shared = " (ranks share a card)" if (
            device.type == "cuda" and len(set(devices)) < len(devices)) else ""
        log(f"distributed: world {dist.get_world_size()}, backend {backend}, "
            f"local ranks -> devices {', '.join(devices)}{shared}")
    return device


def graph_capable(group=None) -> bool:
    """Whether a CUDA graph can capture the collectives of `group` (the
    default group when None): NCCL's can, gloo's cannot."""
    return dist.get_backend(group) == "nccl"
