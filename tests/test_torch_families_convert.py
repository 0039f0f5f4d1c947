"""The OPT, BLOOM and Gemma converters of the port against gptq_tpu's on
the same tiny HF directories (OPT pre-norm, OPT-350m-style post-norm with
project_in / project_out, BLOOM, Gemma with one KV head; safetensors):
leaves bit for bit, the forward against transformers' within 1e-4 (f32
on both sides, other op order), the lazy host reader; the Meta formats
(a llama of two consolidated.*.pth shards, a raw Gemma .ckpt) against
gptq_tpu.models.convert_meta; and one tiny OPT directory through both
CLIs (quantize, pack, save, PPL), each checkpoint loading in both, then
served by the port's CLI."""

import json

import numpy as np
import pytest
import torch

from gptq_tpu.models import convert as jconv
from gptq_tpu.models import convert_meta as jmeta
from gptq_tpu_torch import cli as tcli
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.models import convert as tconv
from gptq_tpu_torch.models import convert_meta as tmeta
from test_torch_cli_quantize import (VOCAB, _both_loaded, _check_logs,
                                     _codes_agree, _run_both, offline)
from test_torch_convert import _leaves
from torch_threads import torch_threads  # noqa: F401 (autouse)

RTOL = 1e-4  # of max |logit|
assert offline  # the fixture, imported for the CLI test


def _opt(post_norm=False):
    from transformers import OPTConfig, OPTForCausalLM

    torch.manual_seed(21)
    cfg = OPTConfig(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
                    ffn_dim=128, num_attention_heads=4,
                    max_position_embeddings=32,
                    word_embed_proj_dim=32 if post_norm else 64,
                    do_layer_norm_before=not post_norm,
                    activation_function="relu")
    return OPTForCausalLM(cfg).eval()


def _bloom():
    from transformers import BloomConfig, BloomForCausalLM

    torch.manual_seed(22)
    cfg = BloomConfig(vocab_size=VOCAB, hidden_size=64, n_layer=2, n_head=4)
    return BloomForCausalLM(cfg).eval()


def _gemma():
    from transformers import GemmaConfig, GemmaForCausalLM

    torch.manual_seed(23)
    cfg = GemmaConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=1, head_dim=32,
                      max_position_embeddings=32)
    return GemmaForCausalLM(cfg).eval()


def _nudge(model):
    """Move every norm weight and bias off its init value (ones / zeros),
    so that a dropped or misplaced one shows in the logits."""
    g = torch.Generator().manual_seed(24)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return model


MODELS = {"opt": _opt, "opt350": lambda: _opt(post_norm=True),
          "bloom": _bloom, "gemma": _gemma}


def _same_leaves(jp, tp):
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, v in jl.items():
        if v is None:
            assert tl[k] is None, k
            continue
        assert tl[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_params_from_dir_match_jax_and_hf(name, tmp_path):
    model = _nudge(MODELS[name]())
    d = str(tmp_path / "m")
    model.save_pretrained(d, safe_serialization=True)
    jspec, jp = jconv.params_from_dir(d)
    tspec, tp = tconv.params_from_dir(d, device="cpu")
    assert tspec == tc.ArchSpec(**vars(jspec))
    _same_leaves(jp, tp)
    # the lazy host reader converts to the same numbers
    _, th = tconv.params_from_dir(d, device="cpu", host=True)
    _same_leaves(jp, th)
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(2, 12))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.numpy()
        got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= RTOL, err


def _inverse_permute(w, n_heads, dim1, dim2):
    """HF's rotate-half rows -> Meta's interleaved rotary rows."""
    return (w.view(n_heads, 2, dim1 // n_heads // 2, dim2)
            .transpose(1, 2).reshape(dim1, dim2))


def test_meta_llama_two_shards_match_jax(tmp_path):
    """A Meta llama directory of two consolidated shards (column-parallel
    weights split on dim 0, row-parallel ones and the token embedding on
    dim 1, norms replicated) from a tiny HF llama: both packages convert
    it to the same leaves, and the port's logits match HF's."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(25)
    dim, heads, kv = 64, 4, 2
    cfg = LlamaConfig(vocab_size=67, hidden_size=dim, intermediate_size=192,
                      num_hidden_layers=2, num_attention_heads=heads,
                      num_key_value_heads=kv, max_position_embeddings=32,
                      tie_word_embeddings=False)
    model = _nudge(LlamaForCausalLM(cfg).eval())
    sd = model.state_dict()
    meta = {"tok_embeddings.weight": (sd["model.embed_tokens.weight"], 1),
            "norm.weight": (sd["model.norm.weight"], None),
            "output.weight": (sd["lm_head.weight"], 0)}
    for i in range(2):
        h, m = f"model.layers.{i}.", f"layers.{i}."
        meta.update({
            m + "attention.wq.weight": (_inverse_permute(
                sd[h + "self_attn.q_proj.weight"], heads, dim, dim), 0),
            m + "attention.wk.weight": (_inverse_permute(
                sd[h + "self_attn.k_proj.weight"], kv, dim * kv // heads,
                dim), 0),
            m + "attention.wv.weight": (sd[h + "self_attn.v_proj.weight"], 0),
            m + "attention.wo.weight": (sd[h + "self_attn.o_proj.weight"], 1),
            m + "feed_forward.w1.weight": (sd[h + "mlp.gate_proj.weight"], 0),
            m + "feed_forward.w2.weight": (sd[h + "mlp.down_proj.weight"], 1),
            m + "feed_forward.w3.weight": (sd[h + "mlp.up_proj.weight"], 0),
            m + "attention_norm.weight": (sd[h + "input_layernorm.weight"],
                                          None),
            m + "ffn_norm.weight": (sd[h + "post_attention_layernorm.weight"],
                                    None)})
    for s in range(2):
        torch.save({k: (t if d is None else t.chunk(2, dim=d)[s]).clone()
                    for k, (t, d) in meta.items()},
                   tmp_path / f"consolidated.{s:02d}.pth")
    with open(tmp_path / "params.json", "w") as f:
        json.dump({"dim": dim, "n_layers": 2, "n_heads": heads,
                   "n_kv_heads": kv, "norm_eps": cfg.rms_norm_eps,
                   "multiple_of": 64, "ffn_dim_multiplier": 192 / (8 * dim / 3),
                   "max_seq_len": 32}, f)
    jspec, jp = jmeta.params_from_meta_llama(str(tmp_path))
    tspec, tp = tconv.params_from_dir(str(tmp_path), device="cpu")
    assert tspec == tc.ArchSpec(**vars(jspec)) and tspec.ffn == 192
    _same_leaves(jp, tp)
    ids = np.random.default_rng(1).integers(0, 67, size=(1, 10))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.numpy()
        got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= RTOL, err


def test_gemma_ckpt_matches_jax(tmp_path):
    """A raw Gemma .ckpt (q|k|v fused per layer, under model_state_dict;
    hidden 2048: head dim 256, as Gemma-2B) converts to the same spec and
    leaves in both packages."""
    g = torch.Generator().manual_seed(26)
    dim, hd, heads, kv, ffn, vocab = 2048, 256, 8, 1, 64, 40

    def rand(*shape):
        return torch.randn(shape, generator=g) * 0.02

    sd = {"embedder.weight": rand(vocab, dim),
          "model.norm.weight": rand(dim)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.qkv_proj.weight": rand((heads + 2 * kv) * hd,
                                                         dim),
                   p + "self_attn.o_proj.weight": rand(dim, heads * hd),
                   p + "mlp.gate_proj.weight": rand(ffn, dim),
                   p + "mlp.up_proj.weight": rand(ffn, dim),
                   p + "mlp.down_proj.weight": rand(dim, ffn),
                   p + "input_layernorm.weight": rand(dim),
                   p + "post_attention_layernorm.weight": rand(dim)})
    path = str(tmp_path / "gemma.ckpt")
    torch.save({"model_state_dict": sd}, path)
    jspec, jp = jmeta.params_from_gemma_ckpt(path)
    tspec, tp = tconv.params_from_dir(path, device="cpu")
    assert tspec == tc.ArchSpec(**vars(jspec))
    assert (tspec.head_dim, tspec.n_heads, tspec.kv_heads) == (256, 8, 1)
    _same_leaves(jp, tp)
    spec2, tp2 = tmeta.params_from_gemma_ckpt(path, device="cpu")
    assert spec2 == tspec
    _same_leaves(jp, tp2)


def test_opt_cli_round_trip(offline, tmp_path):
    """A tiny OPT directory through both CLIs (w4 g32 act-order true-
    sequential, --new-eval): the log lines agree up to the number, each
    checkpoint loads in both packages, at least 99.5% of each linear's
    codes are equal; then the port's checkpoint serves through the port's
    CLI with --quant_lm_head 8, which packs OPT's tied head."""
    d = str(tmp_path / "opt")
    _nudge(_opt()).save_pretrained(d, safe_serialization=True)
    out = _run_both(d, tmp_path, ["--wbits", "4", "--groupsize", "32",
                                  "--act-order", "--true-sequential",
                                  "--new-eval"])
    _check_logs(out)
    assert "dataset = c4-new" in out["port"][1][2]
    (spec, jp, _), (_, tp, _) = _both_loaded(out)
    assert spec.arch == "opt" and jp["lm_head"] is None
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for k in ("q", "k", "v", "o", "fc1", "fc2"):
            _codes_agree(jl[k]["w"], tl[k]["w"])
            np.testing.assert_array_equal(jl[k]["b"].numpy(),
                                          tl[k]["b"].numpy())
    assert tcli.main(["dummy", "c4", "--load", out["port"][0],
                      "--benchmark", "6", "--faster-kernel", "--int8_kv",
                      "--quant_lm_head", "8", "--device", "cpu"]) == 0
