"""Architecture registry: per-block linear names, true-sequential groups
and the HF config mapping of the four families, OPT, BLOOM, llama (with
its Mixtral branch: llama attention plus routed GLU experts) and Gemma
(port of gptq_tpu/models/registry.py)."""

from __future__ import annotations

from dataclasses import dataclass

from gptq_tpu_torch.models.common import ArchSpec


@dataclass(frozen=True)
class ArchInfo:
    # ArchSpec fields every model of the family shares
    spec_defaults: dict
    # capture / linear name -> param key in the block dict
    linears: dict
    # true-sequential ordering: groups of linear names
    seq_groups: tuple
    hf_prefix: str


ARCHS = {
    "opt": ArchInfo(
        spec_defaults=dict(arch="opt", act="relu", pos="learned",
                           norm_type="layernorm", linear_bias=True),
        linears={
            "self_attn.k_proj": "k",
            "self_attn.v_proj": "v",
            "self_attn.q_proj": "q",
            "self_attn.out_proj": "o",
            "fc1": "fc1",
            "fc2": "fc2",
        },
        seq_groups=(
            ("self_attn.k_proj", "self_attn.v_proj", "self_attn.q_proj"),
            ("self_attn.out_proj",),
            ("fc1",),
            ("fc2",),
        ),
        hf_prefix="model.decoder.layers",
    ),
    "bloom": ArchInfo(
        spec_defaults=dict(arch="bloom", act="gelu_tanh", pos="alibi",
                           norm_type="layernorm", linear_bias=True,
                           tie_embeddings=True),
        linears={
            "self_attention.query_key_value": "qkv",
            "self_attention.dense": "o",
            "mlp.dense_h_to_4h": "fc1",
            "mlp.dense_4h_to_h": "fc2",
        },
        seq_groups=(
            ("self_attention.query_key_value",),
            ("self_attention.dense",),
            ("mlp.dense_h_to_4h",),
            ("mlp.dense_4h_to_h",),
        ),
        hf_prefix="transformer.h",
    ),
    "llama": ArchInfo(
        spec_defaults=dict(arch="llama", act="silu", pos="rope",
                           norm_type="rmsnorm", linear_bias=False),
        linears={
            "self_attn.q_proj": "q",
            "self_attn.k_proj": "k",
            "self_attn.v_proj": "v",
            "self_attn.o_proj": "o",
            "mlp.gate_proj": "gate",
            "mlp.up_proj": "up",
            "mlp.down_proj": "down",
        },
        seq_groups=(
            ("self_attn.k_proj", "self_attn.v_proj", "self_attn.q_proj"),
            ("self_attn.o_proj",),
            ("mlp.up_proj", "mlp.gate_proj"),
            ("mlp.down_proj",),
        ),
        hf_prefix="model.layers",
    ),
    "gemma": ArchInfo(
        spec_defaults=dict(arch="gemma", act="gelu_tanh", pos="rope",
                           norm_type="rmsnorm1p", linear_bias=False,
                           tie_embeddings=True),
        linears={
            "self_attn.q_proj": "q",
            "self_attn.k_proj": "k",
            "self_attn.v_proj": "v",
            "self_attn.o_proj": "o",
            "mlp.gate_proj": "gate",
            "mlp.up_proj": "up",
            "mlp.down_proj": "down",
        },
        seq_groups=(
            ("self_attn.k_proj", "self_attn.v_proj", "self_attn.q_proj"),
            ("self_attn.o_proj",),
            ("mlp.up_proj", "mlp.gate_proj"),
            ("mlp.down_proj",),
        ),
        hf_prefix="model.layers",
    ),
}


def get_arch(name: str) -> ArchInfo:
    return ARCHS[name]


def arch_of_hf_config(config) -> str:
    """The family of an HF config's model_type, as the JAX package maps it
    (mixtral and every unknown type -> llama)."""
    mt = getattr(config, "model_type", "")
    if mt in ARCHS:
        return mt
    for fam in ("opt", "bloom", "gemma"):
        if fam in mt:
            return fam
    return "llama"  # incl. mixtral (llama attention + routed GLU experts)


def spec_from_hf_config(config) -> ArchSpec:
    """An ArchSpec from an HF config: any object with the config's
    attributes (a transformers PretrainedConfig or a SimpleNamespace). A
    Mixtral config (num_local_experts > 0) gets expert_capacity = E / k,
    the dropless capacity its inference has; Gemma scales its embedding by
    sqrt(hidden)."""
    arch = arch_of_hf_config(config)
    d = dict(ARCHS[arch].spec_defaults)
    if arch == "opt":
        d.update(
            n_layers=config.num_hidden_layers,
            hidden=config.hidden_size,
            n_heads=config.num_attention_heads,
            ffn=config.ffn_dim,
            vocab=config.vocab_size,
            max_pos=config.max_position_embeddings,
            word_embed_dim=config.word_embed_proj_dim,
            do_layer_norm_before=config.do_layer_norm_before,
            norm_eps=1e-5,
        )
        return ArchSpec(**d)
    if arch == "bloom":
        d.update(
            n_layers=config.n_layer,
            hidden=config.hidden_size,
            n_heads=config.n_head,
            ffn=4 * config.hidden_size,
            vocab=config.vocab_size,
            max_pos=2048,
            norm_eps=config.layer_norm_epsilon,
        )
        return ArchSpec(**d)
    d.update(  # llama / gemma
        n_layers=config.num_hidden_layers,
        hidden=config.hidden_size,
        n_heads=config.num_attention_heads,
        n_kv_heads=getattr(config, "num_key_value_heads",
                           config.num_attention_heads),
        head_dim=getattr(config, "head_dim", -1) or -1,
        ffn=config.intermediate_size,
        vocab=config.vocab_size,
        max_pos=config.max_position_embeddings,
        norm_eps=config.rms_norm_eps,
        rope_theta=getattr(config, "rope_theta", 10000.0),
        tie_embeddings=bool(getattr(config, "tie_word_embeddings",
                                    arch == "gemma")),
        n_experts=getattr(config, "num_local_experts", 0) or 0,
        expert_top_k=getattr(config, "num_experts_per_tok", 2) or 2,
    )
    if d["n_experts"]:
        # HF Mixtral inference drops no assignment: capacity E / k gives
        # C = ceil(k * N * (E / k) / E) = N slots per expert
        d["expert_capacity"] = d["n_experts"] / d["expert_top_k"]
    if arch == "gemma":
        d["embed_scale"] = float(config.hidden_size) ** 0.5
        if getattr(config, "hidden_activation", None) in (
                "gelu_pytorch_tanh", None):
            d["act"] = "gelu_tanh"
    return ArchSpec(**d)
