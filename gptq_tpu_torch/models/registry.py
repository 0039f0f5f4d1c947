"""Architecture registry: per-block linear names, true-sequential groups
and the HF config mapping (port of the llama entry of
gptq_tpu/models/registry.py, with its Mixtral branch: llama attention plus
routed GLU experts; the other families wait, ROADMAP queue 1 item 13)."""

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
}


def get_arch(name: str) -> ArchInfo:
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported (ROADMAP queue 1, item 13)")
    return ARCHS[name]


def arch_of_hf_config(config) -> str:
    """The family of an HF config's model_type, as the JAX package maps it
    (mixtral and every unknown type -> llama)."""
    mt = getattr(config, "model_type", "")
    for fam in ("opt", "bloom", "gemma"):
        if fam in mt:
            return fam
    return "llama"  # incl. mixtral (llama attention + routed GLU experts)


def spec_from_hf_config(config) -> ArchSpec:
    """An ArchSpec from an HF config: any object with the config's
    attributes (a transformers PretrainedConfig or a SimpleNamespace).
    Llama and Mixtral only; a Mixtral config (num_local_experts > 0) gets
    expert_capacity = E / k, the dropless capacity its inference has."""
    arch = arch_of_hf_config(config)
    if arch != "llama":
        raise NotImplementedError(
            f"model_type {getattr(config, 'model_type', '')!r} ({arch}) is "
            f"not ported (ROADMAP queue 1, item 13)")
    d = dict(ARCHS[arch].spec_defaults)
    d.update(
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
        tie_embeddings=bool(getattr(config, "tie_word_embeddings", False)),
        n_experts=getattr(config, "num_local_experts", 0) or 0,
        expert_top_k=getattr(config, "num_experts_per_tok", 2) or 2,
    )
    if d["n_experts"]:
        # HF Mixtral inference drops no assignment: capacity E / k gives
        # C = ceil(k * N * (E / k) / E) = N slots per expert
        d["expert_capacity"] = d["n_experts"] / d["expert_top_k"]
    return ArchSpec(**d)
