"""HF checkpoint directory -> the port's params (port of
gptq_tpu/models/convert.py: OPT, BLOOM, llama with Mixtral's experts, and
Gemma through the llama converter).

Sources: a live transformers *ForCausalLM instance (params_from_hf_torch),
a state dict (params_from_state_dict), or a directory holding
`config.json` and `*.safetensors` or `pytorch_model*.bin` shards
(params_from_dir). The directory path needs neither transformers nor the
safetensors package: `config.json` is read with json into a namespace for
registry.spec_from_hf_config, and safetensors files with this module's
own lazy reader (scan_safetensors: each tensor's bytes are mapped, and
read and widened only when that tensor is converted). Every floating
leaf is widened to f32 exactly (f16 / bf16 sources), as the JAX package's
`_np` widens them, so both packages convert a directory to the same
numbers. Mixtral's per-expert weights stack on a leading E axis
(models/moe.py). params_from_dir(host=True) keeps the blocks' linear
weights in CPU memory for the layer-streamed quantize (the JAX package's
`_arr` under host_params). A directory of Meta `params.json` +
`consolidated.*.pth` shards and a raw Gemma `.ckpt` file go through
models/convert_meta.py.
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

# safetensors dtype -> numpy dtype of the stored bytes (BF16 as its bits)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


class LazyTensor:
    """One tensor of a safetensors file, mapped and not read: `numpy()`
    maps its bytes (np.memmap at its offset) and widens F16 / BF16 to f32
    exactly; the other dtypes keep theirs. Converting one tensor at a time
    keeps one widened copy of the model in host memory, never the raw
    bytes of every shard beside it."""

    def __init__(self, path: str, name: str, info: dict, base: int):
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             f"take")
        self.path, self.name, self.st_dtype = path, name, info["dtype"]
        self.shape = tuple(info["shape"])
        dt = np.dtype(_ST_DTYPES[self.st_dtype])
        begin, end = info["data_offsets"]
        count = int(np.prod(self.shape, dtype=np.int64))
        if end - begin != count * dt.itemsize:
            raise ValueError(f"{path}: tensor {name} holds {end - begin} "
                             f"bytes for shape {self.shape} {self.st_dtype}")
        self.offset, self.np_dtype = base + begin, dt.newbyteorder("<")

    def numpy(self) -> np.ndarray:
        if 0 in self.shape:
            a = np.zeros(self.shape, self.np_dtype)
        else:
            a = np.memmap(self.path, dtype=self.np_dtype, mode="r",
                          offset=self.offset, shape=self.shape)
        if self.st_dtype == "BF16":  # the high half of an f32
            return (a.astype(np.uint32) << 16).view(np.float32)
        if self.st_dtype == "F16":
            return a.astype(np.float32)
        return np.array(a)


def scan_safetensors(path: str) -> dict:
    """{name: LazyTensor} of one .safetensors file: an 8-byte
    little-endian header length, a JSON header of dtype / shape /
    data_offsets per tensor, then the raw bytes (read only when a tensor
    is converted)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    return {name: LazyTensor(path, name, info, 8 + n)
            for name, info in header.items() if name != "__metadata__"}


def read_safetensors(path: str) -> dict:
    """{name: numpy array} of one .safetensors file, every tensor read:
    F16 and BF16 widened to f32 exactly, the other dtypes kept."""
    return {name: t.numpy() for name, t in scan_safetensors(path).items()}


def load_state_dict_dir(path: str) -> dict:
    """Raw tensors of a checkpoint directory (safetensors preferred):
    LazyTensors of *.safetensors (read as each is converted), else torch
    tensors from pytorch_model*.bin (torch.load with weights_only=True)."""
    sd: dict = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(scan_safetensors(f))
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


def params_from_dir(path: str, dtype=torch.float32, device="cuda",
                    host: bool = False) -> tuple[ArchSpec, dict]:
    """An HF checkpoint directory (OPT, BLOOM, llama / Mixtral, Gemma), a
    Meta-format llama directory (params.json + consolidated.*.pth) or a
    raw Gemma .ckpt file -> (spec, params) on `device`. host=True keeps
    each block's linear weights in CPU memory and puts everything else on
    `device` (Mixtral's expert stacks too), so that
    pipeline.quantize_model streams a model larger than the card's memory
    one layer at a time (the Meta formats convert on `device`, as the
    JAX package converts them whatever host says)."""
    path = resolve_model_path(path)
    if os.path.isfile(path) and path.endswith(".ckpt"):
        from gptq_tpu_torch.models.convert_meta import params_from_gemma_ckpt

        return params_from_gemma_ckpt(path, dtype, device)
    if (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "params.json"))
            and glob.glob(os.path.join(path, "consolidated.*.pth"))):
        from gptq_tpu_torch.models.convert_meta import params_from_meta_llama

        return params_from_meta_llama(path, dtype, device)
    if not os.path.isfile(os.path.join(path, "config.json")):
        raise FileNotFoundError(f"{path}: no config.json (the port converts "
                                f"local HF checkpoint directories)")
    spec = spec_from_hf_config(hf_config(path))
    return spec, params_from_state_dict(load_state_dict_dir(path), spec,
                                        dtype, device, host=host)


def params_from_state_dict(sd: dict, spec: ArchSpec, dtype=torch.float32,
                           device="cuda", host: bool = False) -> dict:
    """HF parameter names -> the port's params; host as params_from_dir's
    (llama and Gemma share names)."""
    conv = {"opt": _convert_opt, "bloom": _convert_bloom}.get(spec.arch,
                                                            _convert_llama)
    return conv(sd, spec, dtype, resolve_device(device),
                "cpu" if host else None)


def _t(v, dtype, device) -> torch.Tensor:
    """A LazyTensor, numpy array or torch tensor -> a tensor of `dtype` on
    `device` (f16 / bf16 widen exactly)."""
    if isinstance(v, LazyTensor):
        v = v.numpy()
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.detach().to(device=device, dtype=dtype)


def _lin(sd, prefix, dtype, device, w_device=None) -> dict:
    """A linear: its weight on `w_device` (the host of an offloaded
    block) or `device`, its bias on `device`."""
    b = sd.get(prefix + ".bias")
    return {"w": _t(sd[prefix + ".weight"], dtype, w_device or device),
            "b": None if b is None else _t(b, dtype, device)}


def _norm(sd, prefix, dtype, device, has_bias=False) -> dict:
    """A norm's weight, and (layernorm: has_bias) its bias where present."""
    p = {"w": _t(sd[prefix + ".weight"], dtype, device)}
    if has_bias and prefix + ".bias" in sd:
        p["b"] = _t(sd[prefix + ".bias"], dtype, device)
    return p


def _convert_opt(sd, spec, dtype, device, host=None) -> dict:
    """OPT: learned positions, optional project_in / project_out, layernorm
    with biases, fc1 / fc2; the final layernorm only where present (OPT-
    350m has none), lm_head where the state dict holds one."""
    pre = "model.decoder."

    def opt_lin(name):
        return (_lin(sd, pre + name, dtype, device)
                if pre + name + ".weight" in sd else None)

    embed = {"tokens": _t(sd[pre + "embed_tokens.weight"], dtype, device),
             "positions": _t(sd[pre + "embed_positions.weight"], dtype,
                             device),
             "project_in": opt_lin("project_in"),
             "project_out": opt_lin("project_out")}
    layers = []
    for i in range(spec.n_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "q": _lin(sd, lp + "self_attn.q_proj", dtype, device, host),
            "k": _lin(sd, lp + "self_attn.k_proj", dtype, device, host),
            "v": _lin(sd, lp + "self_attn.v_proj", dtype, device, host),
            "o": _lin(sd, lp + "self_attn.out_proj", dtype, device, host),
            "fc1": _lin(sd, lp + "fc1", dtype, device, host),
            "fc2": _lin(sd, lp + "fc2", dtype, device, host),
            "ln1": _norm(sd, lp + "self_attn_layer_norm", dtype, device,
                         True),
            "ln2": _norm(sd, lp + "final_layer_norm", dtype, device, True),
        })
    final_ln = (_norm(sd, pre + "final_layer_norm", dtype, device, True)
                if pre + "final_layer_norm.weight" in sd else None)
    lm = None
    if "lm_head.weight" in sd:
        lm = {"w": _t(sd["lm_head.weight"], dtype, device), "b": None}
    return {"embed": embed, "layers": layers, "final_ln": final_ln,
            "lm_head": lm}


def _convert_bloom(sd, spec, dtype, device, host=None) -> dict:
    """BLOOM: the word-embedding layernorm, one fused q|k|v linear, fc1 /
    fc2 (dense_h_to_4h / dense_4h_to_h), a tied head."""
    pre = "transformer."
    layers = []
    for i in range(spec.n_layers):
        lp = f"{pre}h.{i}."
        layers.append({
            "qkv": _lin(sd, lp + "self_attention.query_key_value", dtype,
                        device, host),
            "o": _lin(sd, lp + "self_attention.dense", dtype, device, host),
            "fc1": _lin(sd, lp + "mlp.dense_h_to_4h", dtype, device, host),
            "fc2": _lin(sd, lp + "mlp.dense_4h_to_h", dtype, device, host),
            "ln1": _norm(sd, lp + "input_layernorm", dtype, device, True),
            "ln2": _norm(sd, lp + "post_attention_layernorm", dtype, device,
                         True),
        })
    return {"embed": {"tokens": _t(sd[pre + "word_embeddings.weight"], dtype,
                                   device),
                      "ln": _norm(sd, pre + "word_embeddings_layernorm",
                                  dtype, device, True)},
            "layers": layers,
            "final_ln": _norm(sd, pre + "ln_f", dtype, device, True),
            "lm_head": None}  # tied


def _convert_llama(sd, spec, dtype, device, host=None) -> dict:
    """`host`: the device of the blocks' linear weights when they stay
    off `device` (params_from_dir's host=True), else None."""
    pre = "model."
    layers = []
    for i in range(spec.n_layers):
        lp = f"{pre}layers.{i}."
        layer = {
            "q": _lin(sd, lp + "self_attn.q_proj", dtype, device, host),
            "k": _lin(sd, lp + "self_attn.k_proj", dtype, device, host),
            "v": _lin(sd, lp + "self_attn.v_proj", dtype, device, host),
            "o": _lin(sd, lp + "self_attn.o_proj", dtype, device, host),
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
            layer["gate"] = _lin(sd, lp + "mlp.gate_proj", dtype, device,
                                 host)
            layer["up"] = _lin(sd, lp + "mlp.up_proj", dtype, device, host)
            layer["down"] = _lin(sd, lp + "mlp.down_proj", dtype, device,
                                 host)
        layers.append(layer)
    lm = None
    if "lm_head.weight" in sd and not spec.tie_embeddings:
        lm = {"w": _t(sd["lm_head.weight"], dtype, device), "b": None}
    return {"embed": {"tokens": _t(sd[pre + "embed_tokens.weight"], dtype,
                                   device)},
            "layers": layers,
            "final_ln": _norm(sd, pre + "norm", dtype, device),
            "lm_head": lm}
