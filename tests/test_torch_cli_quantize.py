"""The port's quantize CLI against the JAX package's on the same tiny HF
llama directory, seed and offline data (a fake `datasets` module and a
toy tokenizer, as tests/test_cli_e2e.py stands them in): convert ->
calibrate -> quantize -> pack -> save -> PPL. Each package's checkpoint
loads in both; per linear at least 99.5% of the codes (or BCQ sign bits)
are equal, the solver's bound (ROADMAP); the result-log lines agree up to
the number and the PPLs within 1% (tests/test_torch_pipeline.py's bound).
The same for a tiny Mixtral directory under --quant_experts (codes per
expert); also the resume journal against an uninterrupted run, and the
refusals of flags not ported (--task; the mixed-precision,
analysis and quantizer flags: tests/test_torch_mixed.py)."""

import os
import sys
import types

import numpy as np
import pytest
import torch

from gptq_tpu import cli as jcli
from gptq_tpu import io as jio
from gptq_tpu_torch import cli as tcli
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.config import QuantConfig
from gptq_tpu_torch.data import synthetic_stream
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops.bcq_matmul import _unpack_signs
from gptq_tpu_torch.pipeline import quantize_model
from torch_threads import torch_threads  # noqa: F401 (autouse)

VOCAB = 99
LINEARS = ("q", "k", "v", "o", "gate", "up", "down")


class FakeTokenizer:
    """Text -> deterministic synthetic ids (offline stand-in)."""

    def __call__(self, text, **kw):
        n = max(64, min(len(text) // 3, 3000))
        return types.SimpleNamespace(
            input_ids=synthetic_stream(VOCAB, n, seed=len(text) % 97).tolist())


class FakeSplit:
    def __init__(self, rows, key):
        self.rows, self.key = rows, key

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.rows
        return {self.key: self.rows[i]}


@pytest.fixture()
def offline(monkeypatch):
    """Both packages' loaders and tokenizer calls, stood in (transformers
    is imported first: it probes the real datasets package)."""
    import transformers

    rows = [" ".join(f"w{i}_{j}" for j in range(30)) for i in range(50)]
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=lambda *a, **k: FakeSplit(
            rows, "sentence" if a[0] == "ptb_text_only" else "text")))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **k: FakeTokenizer()))


def _llama_dir(path, seed=5):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = LlamaConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=32,
                      tie_word_embeddings=False)
    LlamaForCausalLM(cfg).save_pretrained(path)
    return str(path)


def _run_both(model_dir, tmp_path, flags):
    """Run both CLIs with `flags`, each saving its own checkpoint and log.
    Returns {pkg: (checkpoint path, log lines)}."""
    out = {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        ck, log = str(tmp_path / f"{pkg}.npz"), str(tmp_path / f"{pkg}.txt")
        assert main([model_dir, "wikitext2", "--seed", "3", "--nsamples", "4",
                     "--save", ck, "--results_log", log, *flags,
                     *extra]) == 0
        with open(log) as f:
            out[pkg] = ck, f.read().strip().splitlines()
    return out


def _check_logs(out):
    jl, tl = out["jax"][1], out["port"][1]
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        (head_a, rest_a), (head_b, rest_b) = (x.split("   :   ") for x in (a, b))
        num_a, *tail_a = rest_a.split("  ||  ", 1)
        num_b, *tail_b = rest_b.split("  ||  ", 1)
        assert (head_a, tail_a) == (head_b, tail_b)
        assert abs(float(num_b) / float(num_a) - 1) < 0.01, (a, b)


def _both_loaded(out):
    """Each checkpoint loads in both packages; returns the port's view of
    (the JAX checkpoint, the port's)."""
    for ck, _ in out.values():
        jio.load_checkpoint(ck)
    return [tio.load_checkpoint(out[p][0], device="cpu")
            for p in ("jax", "port")]


def _codes_agree(jw, tw):
    """At least 99.5% of the codes of one uniform weight equal."""
    jc = tpack.unpack_codes(jw.words, jw.bits, jw.groupsize).numpy()
    tcodes = tpack.unpack_codes(tw.words, tw.bits, tw.groupsize).numpy()
    assert np.mean(jc == tcodes) >= 0.995


def test_quantize_cli_matches_jax(offline, tmp_path):
    d = _llama_dir(tmp_path / "llama")
    out = _run_both(d, tmp_path, ["--wbits", "4", "--groupsize", "32",
                                  "--act-order", "--true-sequential",
                                  "--quant_lm_head", "8"])
    _check_logs(out)
    (_, jp, jcfg), (_, tp, tcfg) = _both_loaded(out)
    assert jcfg.replace(save=None) == tcfg.replace(save=None)
    pairs = [(jp["lm_head"]["w"], tp["lm_head"]["w"])]
    pairs += [(jl[k]["w"], tl[k]["w"]) for jl, tl in zip(jp["layers"],
                                                         tp["layers"])
              for k in LINEARS]
    for jw, tw in pairs:
        assert isinstance(tw, tpack.PackedWeight) and tw.fmt == "uniform"
        _codes_agree(jw, tw)


def test_lut_eval_cli_matches_jax(offline, tmp_path):
    d = _llama_dir(tmp_path / "llama", seed=6)
    out = _run_both(d, tmp_path, ["--wbits", "3", "--groupsize", "32",
                                  "--lut_eval", "--eval_pack", "--new-eval"])
    _check_logs(out)
    assert "lut = True" in out["port"][1][0]
    assert "dataset = c4-new" in out["port"][1][2]
    (_, jp, _), (_, tp, _) = _both_loaded(out)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for k in LINEARS:
            jw, tw = jl[k]["w"], tl[k]["w"]
            assert tw.fmt == "bcq" and tw.bits == 3
            js = _unpack_signs(jw.words[0], jw.groupsize).numpy()
            ts = _unpack_signs(tw.words[0], tw.groupsize).numpy()
            assert np.mean(js == ts) >= 0.995, k


def test_mixtral_packed_experts_cycle(offline, tmp_path, capsys):
    """--quant_experts gptq --expert_bits 4 through both CLIs: per-expert
    Hessian GPTQ, sub-byte PackedExperts banks; per expert and per dense
    linear >= 99.5% of the codes equal, the log lines as for llama, and
    the port's checkpoint served again through --load."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(4)
    cfg = MixtralConfig(vocab_size=VOCAB, hidden_size=32,
                        num_hidden_layers=2, intermediate_size=64,
                        num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=32, num_local_experts=4,
                        num_experts_per_tok=2)
    d = tmp_path / "tiny-mixtral"
    MixtralForCausalLM(cfg).save_pretrained(d)
    # 8 samples: with 2, the Hessian of layer 1's expert 0 has rank 14 of
    # 32 and turns f32 summation-order differences (1e-7 relative) into
    # 0.4% of gate's codes and, through them, 2.3% of down's
    out = _run_both(str(d), tmp_path, ["--wbits", "4", "--nsamples", "8",
                                       "--quant_experts", "gptq",
                                       "--expert_bits", "4"])
    assert capsys.readouterr().out.count(
        "expert stacks packed (gptq -> 4-bit byteplane banks)") == 2
    _check_logs(out)
    (_, jp, jcfg), (_, tp, tcfg) = _both_loaded(out)
    assert jcfg.replace(save=None) == tcfg.replace(save=None)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for k in ("q", "k", "v", "o"):
            assert isinstance(tl[k]["w"], tpack.PackedWeight)
            _codes_agree(jl[k]["w"], tl[k]["w"])
        for k in ("gate", "up", "down"):
            jb, tb = jl["experts"][k], tl["experts"][k]
            assert isinstance(tb, tpack.PackedExperts) and tb.bits == 4
            assert tb.E == jb.E == 4
            for e in range(tb.E):
                _codes_agree(*(types.SimpleNamespace(
                    words=tuple(w[e] for w in b.words), bits=b.bits,
                    groupsize=b.groupsize) for b in (jb, tb)))
    ckpt, log = out["port"][0], str(tmp_path / "port.txt")
    ppl0 = float(out["port"][1][0].split(":")[-1])
    assert tcli.main([str(d), "wikitext2", "--load", ckpt, "--results_log",
                      log, "--device", "cpu"]) == 0
    with open(log) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 6 and "wbits = 4" in lines[-1]
    ppl1 = float(lines[3].split(":")[-1])  # wikitext2 of the reload
    assert abs(ppl1 - ppl0) / ppl0 < 0.05


def test_resume_matches_uninterrupted(tmp_path):
    spec = tc.ArchSpec(arch="llama", n_layers=3, hidden=32, n_heads=4,
                       n_kv_heads=4, ffn=64, vocab=61, max_pos=64, act="silu",
                       pos="rope", norm_type="rmsnorm", linear_bias=False)
    calib = torch.from_numpy(
        np.random.default_rng(0).integers(0, 61, size=(4, 16)))
    cfg = QuantConfig(wbits=4, nsamples=4, act_order=True)

    def fresh():
        return tc.init_params(spec, seed=0, device="cpu")

    full = fresh()
    want = quantize_model(spec, full, calib, cfg, log=lambda s: None)
    part = fresh()
    seen = []

    def interrupt(msg):  # stop as layer 1 finishes, before its journal
        if msg.startswith("layer") and "done" in msg:
            seen.append(msg)
            if len(seen) == 2:
                raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        quantize_model(spec, part, calib, cfg, log=interrupt,
                       resume_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["layer_0.npz"]
    resumed = fresh()
    msgs = []
    got = quantize_model(spec, resumed, calib, cfg, log=msgs.append,
                         resume_dir=str(tmp_path))
    assert msgs[0] == "resumed: layers 0..0 already quantized"
    assert len(got.quantizers) == 3 * 7
    assert got.losses == pytest.approx(want.losses, rel=1e-6)
    for name, q in want.quantizers.items():
        for f, v in q.items():
            g = got.quantizers[name][f]
            if isinstance(v, torch.Tensor):
                assert torch.equal(g, v), (name, f)
            else:
                assert g == v, (name, f)
    for lw, lr in zip(full["layers"], resumed["layers"]):
        for k in LINEARS:
            assert torch.equal(lw[k]["w"], lr[k]["w"]), k
    assert sorted(os.listdir(tmp_path)) == [f"layer_{i}.npz" for i in range(3)]


@pytest.mark.parametrize("flags,item", [
    (["--task", "piqa"], "item 14")])
def test_refuses_flags_not_ported(flags, item):
    with pytest.raises(SystemExit, match=f"not ported yet \\(ROADMAP {item}"):
        tcli.main(["dummy", "c4", "--wbits", "4", "--device", "cpu", *flags])


def test_benchmark_run_goes_on_without_a_tokenizer(monkeypatch, capsys):
    import transformers

    def missing(cls, *a, **k):
        assert k.get("local_files_only") is True  # never the hub
        raise OSError("no tokenizer files")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(missing))
    assert tcli.load_tokenizer("dummy", required=False) is None
    assert "PPL evals skipped" in capsys.readouterr().out
    with pytest.raises(OSError):
        tcli.load_tokenizer("dummy")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_fine_tuned_overlay(fmt, tmp_path):
    """--load_safetensor / --load_weights replace the directory's weights
    with a fine-tuned state dict, as the JAX CLI's overlay does."""
    import argparse

    from gptq_tpu.models import convert as jconv

    d = _llama_dir(tmp_path / "llama", seed=7)
    sd = {k: v + 0.5 for k, v in _llama_state(d).items()}
    src = str(tmp_path / f"ft.{fmt}")
    if fmt == "bin":
        torch.save(sd, src)
    else:
        from safetensors.torch import save_file

        save_file(sd, src)
    args = argparse.Namespace(model=d, load_safetensor=src if fmt != "bin"
                              else "", load_weights=src if fmt == "bin"
                              else "")
    spec, params = tcli._convert(args, torch.device("cpu"))
    jspec, _ = jconv.params_from_dir(d)
    want = jconv.params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jspec)
    np.testing.assert_array_equal(params["layers"][1]["down"]["w"].numpy(),
                                  np.asarray(want["layers"][1]["down"]["w"]))
    np.testing.assert_array_equal(params["lm_head"]["w"].numpy(),
                                  np.asarray(want["lm_head"]["w"]))


def _llama_state(model_dir):
    from safetensors.torch import load_file

    return load_file(os.path.join(model_dir, "model.safetensors"))
