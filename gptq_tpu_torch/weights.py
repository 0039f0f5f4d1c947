"""Parameter trees from the JAX package's layout, as plain numpy.

`params_from_jax` takes the JAX package's params already converted to
numpy (a dict / list tree whose leaves are numpy arrays or None, where a
packed weight arrives as a dict of its dataclass fields: words, scale,
zoff, alpha, bias, perm, bits, K, N, groupsize, fmt; an MoE expert bank
as the dict of words, scale, zoff, bits, K, N, groupsize) and returns the
port's tree of torch tensors, PackedWeights and PackedExperts on
`device`. It imports nothing of the JAX package; the tests use it to run
both packages on the same weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.ops.pack import PackedExperts, PackedWeight

_PACKED_FIELDS = ("words", "scale", "zoff", "alpha", "bias", "perm", "bits",
                  "K", "N", "groupsize", "fmt")
_EXPERT_FIELDS = frozenset(("words", "scale", "zoff", "bits", "K", "N",
                            "groupsize"))


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device`; a bfloat16 array (ml_dtypes)
    travels through its int16 bits, so ml_dtypes is never imported."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_packed(node) -> bool:
    return isinstance(node, dict) and "words" in node and "fmt" in node


def _is_experts(node) -> bool:
    """A PackedExperts' field dict: exactly its fields (it has no fmt)."""
    return isinstance(node, dict) and set(node) == _EXPERT_FIELDS


def to_numpy_tree(tree):
    """Any tree of dicts / lists / dataclasses whose leaves are array-likes
    (`__array__`) -> the same tree of numpy arrays, a dataclass becoming
    the dict of its fields. This is how a JAX params tree (a PackedWeight
    among it) reaches params_from_jax without this package knowing JAX."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy_tree(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return np.asarray(tree)


def params_from_jax(tree, device="cuda"):
    """Convert a numpy tree in the JAX package's layout (see module doc)."""
    dev = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        if _is_experts(node):
            return PackedExperts(
                words=tuple(tensor_from_numpy(w, dev) for w in node["words"]),
                scale=tensor_from_numpy(node["scale"], dev),
                zoff=tensor_from_numpy(node["zoff"], dev),
                bits=int(node["bits"]), K=int(node["K"]), N=int(node["N"]),
                groupsize=int(node["groupsize"]))
        if _is_packed(node):
            extra = set(node) - set(_PACKED_FIELDS)
            if extra:
                raise ValueError(f"unknown packed-weight fields {sorted(extra)}")

            def opt(name):
                v = node.get(name)
                return None if v is None else tensor_from_numpy(v, dev)

            return PackedWeight(
                words=tuple(tensor_from_numpy(w, dev) for w in node["words"]),
                scale=opt("scale"), zoff=opt("zoff"), alpha=opt("alpha"),
                bias=opt("bias"), perm=opt("perm"), bits=int(node["bits"]),
                K=int(node["K"]), N=int(node["N"]),
                groupsize=int(node["groupsize"]), fmt=str(node["fmt"]))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return tensor_from_numpy(node, dev)

    return conv(tree)
