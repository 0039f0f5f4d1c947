"""Packed-checkpoint save / load (port of gptq_tpu/io.py:save_checkpoint
and load_checkpoint).

The format is the JAX package's: one .npz of flat key -> array pairs plus
a JSON `__header__` with the ArchSpec, the QuantConfig, per-packed-weight
metadata and `pack_format: 2` (byteplane word order). bfloat16 leaves
travel as uint16 bit views listed in `bf16_keys`; they are read back with
`torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)`, so neither
side needs ml_dtypes. An MoE expert bank (PackedExperts) is stored as the
JAX package stores it: meta {"experts": true, bits, K, N, groupsize,
n_words} and leaves words{i}, scale, zoff. A file written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from gptq_tpu_torch.config import QuantConfig, resolve_device
from gptq_tpu_torch.models.common import ArchSpec
from gptq_tpu_torch.ops.pack import PackedExperts, PackedWeight

PACK_FORMAT = 2


def _np(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """tensor -> (numpy array, was_bf16); bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _flatten(tree, prefix="", out=None, meta=None, bf16=None):
    if tree is None:
        return
    if isinstance(tree, PackedWeight):
        meta[prefix] = {
            "packed": True, "bits": tree.bits, "K": tree.K, "N": tree.N,
            "groupsize": tree.groupsize, "fmt": tree.fmt,
            "n_words": len(tree.words),
        }
        leaves = {f"words{i}": w for i, w in enumerate(tree.words)}
        for f in ("scale", "zoff", "alpha", "bias", "perm"):
            if getattr(tree, f) is not None:
                leaves[f] = getattr(tree, f)
        for name, t in leaves.items():
            _flatten(t, f"{prefix}.{name}", out, meta, bf16)
        return
    if isinstance(tree, PackedExperts):
        meta[prefix] = {
            "packed": True, "experts": True, "bits": tree.bits, "K": tree.K,
            "N": tree.N, "groupsize": tree.groupsize,
            "n_words": len(tree.words),
        }
        leaves = {f"words{i}": w for i, w in enumerate(tree.words)}
        leaves.update(scale=tree.scale, zoff=tree.zoff)
        for name, t in leaves.items():
            _flatten(t, f"{prefix}.{name}", out, meta, bf16)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else k, out, meta, bf16)
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}", out, meta, bf16)
        return
    a, was_bf16 = _np(tree) if isinstance(tree, torch.Tensor) \
        else (np.asarray(tree), False)
    out[prefix] = a
    if was_bf16:
        bf16.append(prefix)


def save_checkpoint(path: str, spec: ArchSpec, params: dict,
                    cfg: QuantConfig | None = None) -> None:
    flat, meta, bf16 = {}, {}, []
    _flatten(params, "", flat, meta, bf16)
    header = {
        "pack_format": PACK_FORMAT,
        "spec": dataclasses.asdict(spec),
        "config": dataclasses.asdict(cfg) if cfg else None,
        "packed": meta,
        "keys": sorted(flat.keys()),
        "bf16_keys": sorted(bf16),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz",
             __header__=np.frombuffer(json.dumps(header).encode(),
                                      dtype=np.uint8),
             **flat)


def load_checkpoint(path: str, device="cuda"):
    """Returns (spec, params, cfg | None) with tensors on `device`."""
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        fmt = header.get("pack_format", 1)
        if fmt != PACK_FORMAT and header["packed"]:
            raise ValueError(
                f"checkpoint {path} uses packed-word layout v{fmt}; this "
                f"build reads v{PACK_FORMAT} (byteplane order)")
        spec = ArchSpec(**header["spec"])
        cfg = QuantConfig(**header["config"]) if header["config"] else None
        bf16_keys = set(header.get("bf16_keys", []))

        def arr(k):
            a = z[k]
            if k in bf16_keys:
                return torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16).to(dev)
            return torch.from_numpy(a).to(dev)

        packed_meta = header["packed"]
        packed_fields: dict[str, dict] = {p: {} for p in packed_meta}
        plain: dict[str, torch.Tensor] = {}
        for k in header["keys"]:
            owner = next((p for p in packed_meta if k.startswith(p + ".")),
                         None)
            if owner is not None:
                packed_fields[owner][k[len(owner) + 1:]] = arr(k)
            else:
                plain[k] = arr(k)

    n_layers = spec.n_layers
    params: dict = {"embed": {}, "layers": [dict() for _ in range(n_layers)],
                    "final_ln": None, "lm_head": None}

    def node_for(parts):
        node = params
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            else:
                if node.get(p) is None:
                    node[p] = {}
                node = node[p]
        return node, (int(parts[-1]) if isinstance(node, list) else parts[-1])

    for k, v in plain.items():
        node, key = node_for(k.split("."))
        node[key] = v
    for prefix, m in packed_meta.items():
        f = packed_fields[prefix]
        node, key = node_for(prefix.split("."))
        words = tuple(f[f"words{i}"] for i in range(m["n_words"]))
        if m.get("experts"):
            node[key] = PackedExperts(
                words=words, scale=f["scale"], zoff=f["zoff"], bits=m["bits"],
                K=m["K"], N=m["N"], groupsize=m["groupsize"])
            continue
        node[key] = PackedWeight(
            words=words, scale=f.get("scale"), zoff=f.get("zoff"),
            alpha=f.get("alpha"), bias=f.get("bias"), perm=f.get("perm"),
            bits=m["bits"], K=m["K"], N=m["N"], groupsize=m["groupsize"],
            fmt=m["fmt"])

    def add_b(node):
        # every {"w": ...} linear carries a "b" key (None when absent)
        if isinstance(node, dict):
            if "w" in node and "b" not in node:
                node["b"] = None
            for v in node.values():
                add_b(v)
        elif isinstance(node, list):
            for v in node:
                add_b(v)

    add_b(params)
    if not params.get("final_ln"):
        params["final_ln"] = None
    if not params.get("lm_head"):
        params["lm_head"] = None
    return spec, params, cfg
