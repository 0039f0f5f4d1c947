"""Meta-format checkpoints -> the port's params (port of
gptq_tpu/models/convert_meta.py): a Meta LLaMa directory (params.json +
consolidated.*.pth shards) and a raw Gemma .ckpt file, each read with
torch.load(weights_only=True) and converted straight into the params
tree, with no HF directory in between. The interleaved rotary layout of
Meta's q / k is permuted to the rotate-half layout apply_rope takes.
"""

from __future__ import annotations

import glob
import json
import os

import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.models.common import ArchSpec


def _permute_rotary(w: torch.Tensor, n_heads: int, dim1: int,
                    dim2: int) -> torch.Tensor:
    """Interleaved rotary rows -> HF's sliced rotate-half rows."""
    return (w.reshape(n_heads, dim1 // n_heads // 2, 2, dim2)
            .transpose(1, 2).reshape(dim1, dim2))


def llama_spec_from_params_json(pj: dict, vocab: int) -> ArchSpec:
    """The ArchSpec of a Meta params.json (ffn from dim, ffn_dim_multiplier
    and multiple_of, as Meta's model code sizes it)."""
    dim = pj["dim"]
    n_heads = pj["n_heads"]
    multiple_of = pj.get("multiple_of", 256)
    ffn_mult = pj.get("ffn_dim_multiplier", 1.0) or 1.0
    hidden = int(8 * dim / 3 * ffn_mult)
    ffn = multiple_of * ((hidden + multiple_of - 1) // multiple_of)
    return ArchSpec(
        arch="llama", n_layers=pj["n_layers"], hidden=dim, n_heads=n_heads,
        n_kv_heads=pj.get("n_kv_heads", n_heads), ffn=ffn, vocab=vocab,
        max_pos=pj.get("max_seq_len", 2048), norm_eps=pj.get("norm_eps", 1e-5),
        act="silu", pos="rope", norm_type="rmsnorm", linear_bias=False,
        tie_embeddings=False, rope_theta=pj.get("rope_theta", 10000.0))


def params_from_meta_llama(path: str, dtype=torch.float32, device="cuda"):
    """A Meta LLaMa directory -> (spec, params) on `device`. Shards split
    the weights along Megatron's conventions: column-parallel ones (wq,
    wk, wv, w1, w3, output) on dim 0, row-parallel ones (wo, w2) and the
    token embedding on dim 1; norms are replicated."""
    dev = resolve_device(device)
    with open(os.path.join(path, "params.json")) as f:
        pj = json.load(f)
    shards = sorted(glob.glob(os.path.join(path, "consolidated.*.pth")))
    loaded = [torch.load(s, map_location="cpu", weights_only=True)
              for s in shards]

    def cat(key, dim):
        ts = [sd[key] for sd in loaded]
        return (ts[0] if len(ts) == 1 else torch.cat(ts, dim=dim)).float()

    def put(t):
        return t.to(device=dev, dtype=dtype)

    def lin(t):
        return {"w": put(t), "b": None}

    def norm(key):
        return {"w": put(loaded[0][key].float())}

    tok = cat("tok_embeddings.weight", 1)
    spec = llama_spec_from_params_json(pj, tok.shape[0])
    dim, n_heads, n_kv = spec.hidden, spec.n_heads, spec.kv_heads
    kv_dim = dim * n_kv // n_heads
    layers = []
    for i in range(spec.n_layers):
        pre = f"layers.{i}."
        layers.append({
            "q": lin(_permute_rotary(cat(pre + "attention.wq.weight", 0),
                                     n_heads, dim, dim)),
            "k": lin(_permute_rotary(cat(pre + "attention.wk.weight", 0),
                                     n_kv, kv_dim, dim)),
            "v": lin(cat(pre + "attention.wv.weight", 0)),
            "o": lin(cat(pre + "attention.wo.weight", 1)),
            "gate": lin(cat(pre + "feed_forward.w1.weight", 0)),
            "down": lin(cat(pre + "feed_forward.w2.weight", 1)),
            "up": lin(cat(pre + "feed_forward.w3.weight", 0)),
            "ln1": norm(pre + "attention_norm.weight"),
            "ln2": norm(pre + "ffn_norm.weight"),
        })
    params = {"embed": {"tokens": put(tok)}, "layers": layers,
              "final_ln": norm("norm.weight"),
              "lm_head": lin(cat("output.weight", 0))}
    return spec, params


def params_from_gemma_ckpt(path: str, dtype=torch.float32, device="cuda"):
    """A raw Gemma checkpoint (one .ckpt, its q|k|v fused per layer) ->
    (spec, params) on `device`; sizes inferred from the tensors (head dim
    256 at hidden 2048 / 3072, as Gemma-2B / 7B have it)."""
    dev = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob)

    def put(t):
        return t.float().to(device=dev, dtype=dtype)

    emb = sd["embedder.weight"]
    vocab, dim = emb.shape
    n_layers = max(int(k.split(".")[2]) for k in sd
                   if k.startswith("model.layers.")) + 1
    qkv0 = sd["model.layers.0.self_attn.qkv_proj.weight"]
    q_out = sd["model.layers.0.self_attn.o_proj.weight"].shape[1]
    kv_out = (qkv0.shape[0] - q_out) // 2
    hd = 256 if dim in (2048, 3072) else dim // 8
    spec = ArchSpec(
        arch="gemma", n_layers=n_layers, hidden=dim, n_heads=q_out // hd,
        n_kv_heads=kv_out // hd, head_dim=hd,
        ffn=sd["model.layers.0.mlp.gate_proj.weight"].shape[0], vocab=vocab,
        max_pos=8192, norm_eps=1e-6, act="gelu_tanh", pos="rope",
        norm_type="rmsnorm1p", linear_bias=False, tie_embeddings=True,
        embed_scale=float(dim) ** 0.5)
    layers = []
    for i in range(n_layers):
        pre = f"model.layers.{i}."
        qkv = sd[pre + "self_attn.qkv_proj.weight"]
        layers.append({
            "q": {"w": put(qkv[:q_out]), "b": None},
            "k": {"w": put(qkv[q_out:q_out + kv_out]), "b": None},
            "v": {"w": put(qkv[q_out + kv_out:]), "b": None},
            **{key: {"w": put(sd[pre + name + ".weight"]), "b": None}
               for key, name in (("o", "self_attn.o_proj"),
                                 ("gate", "mlp.gate_proj"),
                                 ("up", "mlp.up_proj"),
                                 ("down", "mlp.down_proj"))},
            "ln1": {"w": put(sd[pre + "input_layernorm.weight"])},
            "ln2": {"w": put(sd[pre + "post_attention_layernorm.weight"])},
        })
    params = {"embed": {"tokens": put(emb)}, "layers": layers,
              "final_ln": {"w": put(sd["model.norm.weight"])},
              "lm_head": None}
    return spec, params
