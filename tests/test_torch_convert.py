"""gptq_tpu_torch.models.convert against gptq_tpu.models.convert on the same
HF checkpoint directories (tiny random llama with GQA and Mixtral, saved
with save_pretrained as safetensors and as pytorch_model.bin): the port's
leaves equal the JAX package's bit for bit, and the port's forward on them
matches the transformers forward within 1e-4 (f32 on both sides, other op
order; tests/test_models.py holds the JAX forward to 5e-4). The port's own
safetensors reader against safetensors.torch.load_file on a bf16 file,
and the refusals of the formats it does not convert."""

import json
import os

import numpy as np
import pytest
import torch

from gptq_tpu.models import convert as jconv
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.models import convert as tconv
from torch_threads import torch_threads  # noqa: F401 (autouse)

RTOL = 1e-4  # of max |logit|


def _llama(kv_heads=2):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(11)
    cfg = LlamaConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=kv_heads,
                      max_position_embeddings=64, tie_word_embeddings=False)
    return LlamaForCausalLM(cfg).eval()


def _mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(12)
    cfg = MixtralConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=64,
                        rms_norm_eps=1e-5, num_local_experts=4,
                        num_experts_per_tok=2, tie_word_embeddings=False)
    return MixtralForCausalLM(cfg).eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("make", [_llama, _mixtral],
                         ids=["llama_gqa", "mixtral"])
def test_params_from_dir_match_jax_and_hf(make, safe, tmp_path):
    model = make()
    d = str(tmp_path / "m")
    model.save_pretrained(d, safe_serialization=safe)
    assert any(f.endswith(".safetensors" if safe else ".bin")
               for f in os.listdir(d))
    jspec, jp = jconv.params_from_dir(d)
    tspec, tp = tconv.params_from_dir(d, device="cpu")
    assert tspec.n_experts == jspec.n_experts and tspec.vocab == 99
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, v in jl.items():
        if v is None:
            assert tl[k] is None, k
            continue
        assert tl[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(v), err_msg=k)
    ids = np.random.default_rng(0).integers(0, 99, size=(2, 12))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.numpy()
        got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= RTOL, err


def test_reader_matches_safetensors_on_bf16_and_f16(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(3)
    tensors = {"a.bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
               "b.f16": torch.randn(3, 64, generator=g).to(torch.float16),
               "c.f32": torch.randn(4, generator=g),
               "d.i64": torch.arange(6).reshape(2, 3)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tconv.read_safetensors(path)
    want = load_file(path)
    assert got.keys() == want.keys()
    for k, v in want.items():
        g_ = got[k]
        wf = v.to(torch.float32) if v.is_floating_point() else v
        assert g_.dtype == (np.float32 if v.is_floating_point()
                            else np.int64), k
        np.testing.assert_array_equal(g_, wf.numpy(), err_msg=k)


def test_refuses_formats_it_does_not_convert(tmp_path):
    # the Meta formats and OPT / BLOOM / Gemma convert now
    # (tests/test_torch_families_convert.py); what holds no checkpoint is
    # refused, never converted to something
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        tconv.params_from_dir(str(empty), device="cpu")
    opt = tmp_path / "opt"
    opt.mkdir()
    (opt / "config.json").write_text(json.dumps({
        "model_type": "opt", "num_hidden_layers": 1, "hidden_size": 8,
        "num_attention_heads": 2, "ffn_dim": 16, "vocab_size": 10,
        "max_position_embeddings": 8, "word_embed_proj_dim": 8,
        "do_layer_norm_before": True}))
    with pytest.raises(FileNotFoundError, match="no checkpoint shards"):
        tconv.params_from_dir(str(opt), device="cpu")
    meta = tmp_path / "meta"
    meta.mkdir()
    (meta / "params.json").write_text("{}")
    (meta / "consolidated.00.pth").write_bytes(b"")
    with pytest.raises(EOFError):  # an empty shard is no checkpoint
        tconv.params_from_dir(str(meta), device="cpu")


def test_ckpt_dir_maps_a_hub_id(tmp_path, monkeypatch):
    d = tmp_path / "org" / "name"
    d.mkdir(parents=True)
    monkeypatch.setenv("GPTQ_TPU_CKPT_DIR", str(tmp_path))
    assert tconv.resolve_model_path("org/name") == str(d)
    assert tconv.resolve_model_path("other/x") == "other/x"
    assert (tconv.resolve_model_path("org/name")
            == jconv.resolve_model_path("org/name"))
