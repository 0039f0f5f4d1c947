"""HF checkpoint directory -> the port's params (port of the llama /
Mixtral half of gptq_tpu/models/convert.py).

Sources: a live transformers *ForCausalLM instance (params_from_hf_torch),
a state dict (params_from_state_dict), or a directory holding
`config.json` and `*.safetensors` or `pytorch_model*.bin` shards
(params_from_dir). The directory path needs neither transformers nor the
safetensors package: `config.json` is read with json into a namespace for
registry.spec_from_hf_config, and safetensors files with this module's
own reader (read_safetensors). Every floating leaf is widened to f32
exactly (f16 / bf16 sources), as the JAX package's `_np` widens them, so
both packages convert a directory to the same numbers. Mixtral's
per-expert weights stack on a leading E axis (models/moe.py).

OPT / BLOOM state dicts, Meta `params.json` + `consolidated.*.pth`
checkpoints and raw Gemma `.ckpt` files are refused with
NotImplementedError (ROADMAP queue 1, item 13), never mis-converted.
"""

from __future__ import annotations

import glob
import json
import os
import types

import numpy as np
import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.models.common import ArchSpec
from gptq_tpu_torch.models.registry import spec_from_hf_config

_ITEM13 = "ROADMAP queue 1, item 13"

# safetensors dtype -> numpy dtype of the stored bytes (BF16 as its bits)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str) -> dict:
    """{name: numpy array} of one .safetensors file: an 8-byte
    little-endian header length, a JSON header of dtype / shape /
    data_offsets per tensor, then the raw bytes. F16 and BF16 tensors are
    widened to f32 exactly; the other dtypes keep theirs."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             f"take")
        dt = np.dtype(_ST_DTYPES[info["dtype"]])
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dt.itemsize:
            raise ValueError(f"{path}: tensor {name} holds {end - begin} "
                             f"bytes for shape {shape} {info['dtype']}")
        a = np.fromfile(path, dtype=dt.newbyteorder("<"), count=count,
                        offset=base + begin).reshape(shape)
        if info["dtype"] == "BF16":  # the high half of an f32
            a = (a.astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] == "F16":
            a = a.astype(np.float32)
        out[name] = a
    return out


def load_state_dict_dir(path: str) -> dict:
    """Raw tensors of a checkpoint directory (safetensors preferred):
    numpy arrays from *.safetensors, else torch tensors from
    pytorch_model*.bin (torch.load with weights_only=True)."""
    sd: dict = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
        return sd
    for f in sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))):
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    return sd


def resolve_model_path(path: str) -> str:
    """Map a hub model id to a local checkpoint directory when
    GPTQ_TPU_CKPT_DIR is set: $GPTQ_TPU_CKPT_DIR/<org>/<name> wins, then
    $GPTQ_TPU_CKPT_DIR/<name>; otherwise the path passes through."""
    root = os.environ.get("GPTQ_TPU_CKPT_DIR")
    if not root or os.path.exists(path):
        return path
    for cand in (os.path.join(root, path),
                 os.path.join(root, path.split("/")[-1])):
        if os.path.isdir(cand):
            return cand
    return path


def hf_config(path: str) -> types.SimpleNamespace:
    """A directory's config.json as a namespace of its keys."""
    with open(os.path.join(path, "config.json")) as f:
        return types.SimpleNamespace(**json.load(f))


def params_from_hf_torch(model, dtype=torch.float32,
                         device="cuda") -> tuple[ArchSpec, dict]:
    """Convert a live transformers *ForCausalLM model."""
    spec = spec_from_hf_config(model.config)
    return spec, params_from_state_dict(dict(model.state_dict()), spec,
                                        dtype, device)


def params_from_dir(path: str, dtype=torch.float32,
                    device="cuda") -> tuple[ArchSpec, dict]:
    """An HF checkpoint directory (llama / Mixtral) -> (spec, params) on
    `device`."""
    path = resolve_model_path(path)
    if os.path.isfile(path) and path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: raw Gemma checkpoints are not ported ({_ITEM13})")
    if (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "params.json"))
            and glob.glob(os.path.join(path, "consolidated.*.pth"))):
        raise NotImplementedError(
            f"{path}: Meta-format llama checkpoints are not ported "
            f"({_ITEM13})")
    if not os.path.isfile(os.path.join(path, "config.json")):
        raise FileNotFoundError(f"{path}: no config.json (the port converts "
                                f"local HF checkpoint directories)")
    spec = spec_from_hf_config(hf_config(path))
    return spec, params_from_state_dict(load_state_dict_dir(path), spec,
                                        dtype, device)


def params_from_state_dict(sd: dict, spec: ArchSpec, dtype=torch.float32,
                           device="cuda") -> dict:
    """HF parameter names -> the port's params (llama and Mixtral)."""
    if spec.arch != "llama":
        raise NotImplementedError(
            f"arch {spec.arch!r}: its state dicts are not ported ({_ITEM13})")
    return _convert_llama(sd, spec, dtype, resolve_device(device))


def _t(v, dtype, device) -> torch.Tensor:
    """A numpy array or torch tensor -> a tensor of `dtype` on `device`
    (f16 / bf16 widen exactly)."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.detach().to(device=device, dtype=dtype)


def _lin(sd, prefix, dtype, device) -> dict:
    b = sd.get(prefix + ".bias")
    return {"w": _t(sd[prefix + ".weight"], dtype, device),
            "b": None if b is None else _t(b, dtype, device)}


def _norm(sd, prefix, dtype, device) -> dict:
    return {"w": _t(sd[prefix + ".weight"], dtype, device)}


def _convert_llama(sd, spec, dtype, device) -> dict:
    pre = "model."
    layers = []
    for i in range(spec.n_layers):
        lp = f"{pre}layers.{i}."
        layer = {
            "q": _lin(sd, lp + "self_attn.q_proj", dtype, device),
            "k": _lin(sd, lp + "self_attn.k_proj", dtype, device),
            "v": _lin(sd, lp + "self_attn.v_proj", dtype, device),
            "o": _lin(sd, lp + "self_attn.o_proj", dtype, device),
            "ln1": _norm(sd, lp + "input_layernorm", dtype, device),
            "ln2": _norm(sd, lp + "post_attention_layernorm", dtype, device),
        }
        moe = lp + "block_sparse_moe."
        if moe + "gate.weight" in sd:
            # Mixtral routed MoE: w1 = gate (F, D), w3 = up (F, D),
            # w2 = down (D, F), stacked on a leading E axis (on the host,
            # then moved once); router (E, D)
            layer["router"] = {"w": _t(sd[moe + "gate.weight"], dtype,
                                       device)}
            layer["experts"] = {
                dst: torch.stack([
                    _t(sd[f"{moe}experts.{e}.{src}.weight"], dtype, "cpu")
                    for e in range(spec.n_experts)]).to(device)
                for src, dst in (("w1", "gate"), ("w3", "up"),
                                 ("w2", "down"))}
        else:
            layer["gate"] = _lin(sd, lp + "mlp.gate_proj", dtype, device)
            layer["up"] = _lin(sd, lp + "mlp.up_proj", dtype, device)
            layer["down"] = _lin(sd, lp + "mlp.down_proj", dtype, device)
        layers.append(layer)
    lm = None
    if "lm_head.weight" in sd and not spec.tie_embeddings:
        lm = {"w": _t(sd["lm_head.weight"], dtype, device), "b": None}
    return {"embed": {"tokens": _t(sd[pre + "embed_tokens.weight"], dtype,
                                   device)},
            "layers": layers,
            "final_ln": _norm(sd, pre + "norm", dtype, device),
            "lm_head": lm}
