"""Mixed precision in the port against gptq_tpu on the CPU: MixedPrecision
on the repository's tables and on a per-module config, quantize_model
(mixed=) on a tiny llama and a tiny OPT (bits and codes per linear),
which q / k / v and gate / up fuse_serving fuses at mixed bits, fused-route
decode logits and greedy tokens at mixed bits, the plain #5 / #6 / #12
with a different bit width per weight against the JAX Pallas kernels in
interpret mode, and both CLIs under --linearmix, --layermix,
--quant_config, --analyse, --non_linear and --columnwise.

A fault of the reference: gptq_tpu/config.py MixedPrecision.bits_for /
columnwise_for match a --quant_config key by string suffix, so layer 1
takes layer 11's entry when that entry is listed first. The port matches
whole path components (the intended behaviour);
test_mixed_precision_suffix_fault asserts both results."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu import pipeline as jpipe
from gptq_tpu.config import MixedPrecision as JMixed
from gptq_tpu.config import QuantConfig as JQuantConfig
from gptq_tpu.models import common as jc
from gptq_tpu.ops import ffn as jf
from gptq_tpu.ops import layer_fused as jl
from gptq_tpu.ops import pack as jpack
from gptq_tpu_torch import cli as tcli
from gptq_tpu_torch import data as tdata
from gptq_tpu_torch import pipeline as tpipe
from gptq_tpu_torch.config import MixedPrecision as TMixed
from gptq_tpu_torch.config import QuantConfig
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.models.registry import get_arch
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import layer_fused as tl
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from test_torch_cli_quantize import (_both_loaded, _check_logs, _codes_agree,
                                     _llama_dir, _run_both, offline)  # noqa: F401
from test_torch_ffn import _check, _jt, _x, fused_pair, packed_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_NAMES = {arch: tuple(get_arch(arch).linears)
              for arch in ("llama", "opt", "bloom")}


def _table(name):
    with open(os.path.join(ROOT, "configs", name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# MixedPrecision
# ---------------------------------------------------------------------------

def test_mixed_precision_layerwise_table():
    for model, bits in _table("layerwise.json").items():
        jm, tm = JMixed(layer_bits=bits), TMixed(layer_bits=bits)
        for i in range(len(bits)):
            for name in ARCH_NAMES["opt"]:
                assert tm.bits_for(i, name, 16) == jm.bits_for(i, name, 16) \
                    == bits[i], (model, i, name)
                assert tm.columnwise_for(i, name, True) is True


def test_mixed_precision_linearwise_table():
    table = _table("linearwise.json")
    jm, tm = JMixed(linear_bits=table), TMixed(linear_bits=table)
    for arch, names in ARCH_NAMES.items():
        for name in names:
            want = jm.bits_for(0, name, 16)
            assert tm.bits_for(0, name, 16) == want, (arch, name)
            assert want == table.get(name.split(".")[-1], 16)
    assert tm.bits_for(0, "self_attn.v_proj", 16) == 3
    assert tm.bits_for(0, "mlp.gate_proj", 16) == 4


def test_mixed_precision_module_config_in_layer_order():
    """A derived config (analysis.derive_quant_config's keys, listed in
    layer order): the port decides every module as JAX does."""
    cfg = {f"model.layers.{i}.{name}": {"bits": 2 + (i + j) % 3,
                                        "columnwise": (i * j) % 2 == 1}
           for i in range(12) for j, name in enumerate(ARCH_NAMES["llama"])}
    jm, tm = JMixed(module_config=cfg), TMixed(module_config=cfg)
    for i in range(12):
        for name in ARCH_NAMES["llama"]:
            assert tm.bits_for(i, name, 16) == jm.bits_for(i, name, 16)
            assert tm.columnwise_for(i, name, False) == jm.columnwise_for(
                i, name, False)
            # the short name matches too
            short = name.split(".")[-1]
            assert tm.bits_for(i, short, 16) == jm.bits_for(i, short, 16)
    # a module the config does not name falls back to the default
    assert tm.bits_for(12, "self_attn.q_proj", 16) == 16


def test_mixed_precision_suffix_fault():
    """gptq_tpu matches by string suffix: layer 1 takes layer 11's entry,
    listed first. The port matches whole path components."""
    cfg = {"model.layers.11.self_attn.q_proj": {"bits": 2,
                                                "columnwise": True},
           "model.layers.1.self_attn.q_proj": {"bits": 4,
                                               "columnwise": False}}
    jm, tm = JMixed(module_config=cfg), TMixed(module_config=cfg)
    assert jm.bits_for(1, "self_attn.q_proj", 3) == 2  # the fault
    assert jm.columnwise_for(1, "self_attn.q_proj", False) is True
    assert tm.bits_for(1, "self_attn.q_proj", 3) == 4  # intended
    assert tm.columnwise_for(1, "self_attn.q_proj", True) is False
    assert tm.bits_for(11, "self_attn.q_proj", 3) == 2
    assert tm.bits_for(11, "q_proj", 3) == jm.bits_for(11, "q_proj", 3) == 3


# ---------------------------------------------------------------------------
# quantize_model(mixed=) and pack_model
# ---------------------------------------------------------------------------

TINY = {
    "llama": dict(arch="llama", n_layers=2, hidden=64, n_heads=4,
                  n_kv_heads=2, ffn=128, vocab=128, max_pos=32, act="silu",
                  pos="rope", norm_type="rmsnorm", linear_bias=False),
    "opt": dict(arch="opt", n_layers=2, hidden=64, n_heads=4, ffn=128,
                vocab=128, max_pos=32, act="relu", pos="learned",
                norm_type="layernorm", linear_bias=True,
                tie_embeddings=False),
}
MIXES = {
    "llama": dict(linear_bits=_table("linearwise.json")),
    "opt": dict(module_config={
        "model.decoder.layers.0.self_attn.q_proj": {"bits": 2},
        "model.decoder.layers.0.fc1": {"bits": 4, "columnwise": True},
        "model.decoder.layers.1.fc2": {"bits": 8}},
        layer_bits=[3, 4]),
}


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_quantize_model_mixed_matches(arch):
    jspec, tspec = jc.ArchSpec(**TINY[arch]), tc.ArchSpec(**TINY[arch])
    jp = jc.init_params(jspec, jax.random.PRNGKey(3))
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    calib = tdata.synthetic_stream(128, 4 * 32, seed=2).reshape(4, 32)
    qkw = dict(wbits=4, groupsize=32, nsamples=4, linearmix=arch == "llama")
    jres = jpipe.quantize_model(jspec, jp, jnp.asarray(calib),
                                JQuantConfig(**qkw),
                                mixed=JMixed(**MIXES[arch]),
                                log=lambda s: None)
    tres = tpipe.quantize_model(tspec, tp, torch.from_numpy(calib).long(),
                                QuantConfig(**qkw),
                                mixed=TMixed(**MIXES[arch]),
                                log=lambda s: None)
    assert set(tres.quantizers) == set(jres.quantizers)
    bits_seen, modes = set(), set()
    for name, jq in jres.quantizers.items():
        tq = tres.quantizers[name]
        assert (tq["mode"], tq["bits"]) == (jq["mode"], jq["bits"]), name
        bits_seen.add(tq["bits"])
        modes.add(tq["mode"])
        jl_, tl_ = jres.losses[name], tres.losses[name]
        assert abs(jl_ - tl_) <= 0.01 * abs(jl_) + 1e-6, (name, jl_, tl_)
    assert len(bits_seen) >= 2
    if arch == "opt":
        assert modes == {"uniform", "columnwise"}
    jpipe.pack_model(jspec, jp, jres.quantizers, JQuantConfig(**qkw))
    tpipe.pack_model(tspec, tp, tres.quantizers, QuantConfig(**qkw))
    arch_ = get_arch(arch)
    for i, (jlp, tlp) in enumerate(zip(jp["layers"], tp["layers"])):
        for name, key in arch_.linears.items():
            q = tres.quantizers[f"{arch_.hf_prefix}.{i}.{name}"]
            jw, tw = jlp[key]["w"], tlp[key]["w"]
            if q["mode"] == "uniform":
                assert isinstance(tw, tpack.PackedWeight)
                assert tw.bits == jw.bits == q["bits"]
                jcodes = np.asarray(jpack.unpack_codes(jw.words, jw.bits,
                                                       jw.groupsize))
                tcodes = tpack.unpack_codes(tw.words, tw.bits,
                                            tw.groupsize).numpy()
                assert np.mean(jcodes == tcodes) >= 0.995, (i, name)
            else:  # columnwise stays dense
                assert not isinstance(tw, tpack.PackedWeight)
                close = np.abs(tw.numpy() - np.asarray(jw)) <= 1e-5
                assert close.mean() >= 0.995


# ---------------------------------------------------------------------------
# serving at mixed bits
# ---------------------------------------------------------------------------

SERVE = dict(arch="llama", n_layers=2, hidden=256, n_heads=4, n_kv_heads=2,
             ffn=512, vocab=384, max_pos=128, act="silu", pos="rope",
             norm_type="rmsnorm", linear_bias=False)
LINEARWISE = {"q": 4, "k": 4, "v": 3, "o": 3, "gate": 4, "up": 4, "down": 3}


def _mixed_pair(seed, bits_of):
    """(jspec, jax params, tspec, port params): random packed weights,
    linear `key` of layer i at bits_of(i, key), and an 8-bit head."""
    jspec, tspec = jc.ArchSpec(**SERVE), tc.ArchSpec(**SERVE)
    jp = jc.init_params(jspec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for i, lp in enumerate(jp["layers"]):
        for key in LINEARWISE:
            N, K = lp[key]["w"].shape
            jw, _ = packed_pair(rng, K, N, bits_of(i, key), -1)
            lp[key] = {"w": jw, "b": None}
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    assert jpipe.quantize_lm_head(jspec, jp, bits=8)
    assert tpipe.quantize_lm_head(tspec, tp, bits=8)
    return jspec, jp, tspec, tp


@pytest.fixture
def fusion(monkeypatch):
    monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", "interpret")


def test_fuse_serving_keeps_mixed_parts_apart(fusion):
    jspec, jp, tspec, tp = _mixed_pair(0, lambda i, k: (LINEARWISE[k] if i
                                                        else 3))
    for a8 in (True, False):
        js, ts = jc.fuse_serving(jspec, jp, a8=a8), tc.fuse_serving(
            tspec, tp, a8=a8)
        for jlp, tlp in zip(js["layers"], ts["layers"]):
            assert set(tlp) == set(jlp)
        # layer 0 all 3 bits: q|k|v and gate|up fuse; layer 1 (linearwise):
        # q / k at 4 and v at 3 stay apart, gate|up at 4 fuse
        assert {"qkv_fused", "gateup_fused"} <= set(ts["layers"][0])
        assert {"q", "k", "v", "gateup_fused"} <= set(ts["layers"][1])
        assert ts["layers"][0]["qkv_fused"]["w"].bits == 3
        for n in (1, 4, 33):
            for i in range(2):
                jlp, tlp = js["layers"][i], ts["layers"][i]
                assert (tc._norm_qkv_ok(tspec, tlp, None, n, "cpu")
                        == jc._norm_qkv_ok(jspec, jlp, None, None, n))
                assert (tc._attn_mlp_ok(tspec, tlp, None, n, "cpu")
                        == jc._attn_mlp_ok(jspec, jlp, None, None, n))
        assert tc._norm_qkv_ok(tspec, ts["layers"][1], None, 1, "cpu") is None
        assert tc._attn_mlp_ok(tspec, ts["layers"][1], None, 1, "cpu") == a8


@pytest.mark.parametrize("mix", ["linearwise", "layerwise"])
def test_fused_decode_at_mixed_bits_matches(fusion, mix):
    bits_of = ((lambda i, k: LINEARWISE[k]) if mix == "linearwise"
               else (lambda i, k: (3, 4)[i]))
    jspec, jp, tspec, tp = _mixed_pair(1, bits_of)
    js, ts = jc.fuse_serving(jspec, jp, a8=True), tc.fuse_serving(
        tspec, tp, a8=True)
    ids = np.random.default_rng(2).integers(0, 384, size=(1, 6))
    out = []
    for fwd, spec, params, cache, x, to_np in (
            (jc.model_forward, jspec, js, jc.KVCache.init(jspec, 1, 16,
                                                          jnp.int8),
             jnp.asarray(ids), np.asarray),
            (tc.model_forward, tspec, ts,
             tc.KVCache.init(tspec, 1, 16, torch.int8, device="cpu"),
             torch.from_numpy(ids), lambda t: t.numpy())):
        logits = []
        for t in range(ids.shape[1]):
            lg, cache = fwd(spec, params, x[:, t:t + 1], cache)
            logits.append(to_np(lg[:, -1]))
        out.append(np.stack(logits).astype(np.float64))
    want, got = out
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1.6e-2, err  # chip_smoke's TOL["logits_a8"]
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if mix != "linearwise":
        return
    from gptq_tpu.engine import decode as jdec
    from gptq_tpu_torch.engine import decode as tdec

    prompt = np.random.default_rng(4).integers(0, 384, size=(1, 8))
    jeng = jdec.DecodeEngine(jspec, jp, max_len=32, cache_dtype=jnp.int8,
                             a8=True)
    teng = tdec.DecodeEngine(tspec, tp, max_len=32, cache_dtype=torch.int8,
                             a8=True)
    np.testing.assert_array_equal(teng.generate(prompt, 5),
                                  jeng.generate(prompt, 5))


H, F = 256, 512  # the kernel cases' hidden and ffn widths


@pytest.mark.parametrize("bits,a8,M", [
    ((3, 4, 3), True, 1), ((3, 4, 3), False, 4), ((4, 3, 8), True, 4),
    ((2, 4, 3), False, 1)])
def test_attn_mlp_plain_at_mixed_bits_matches_jax(bits, a8, M, monkeypatch):
    """#5 with o, gate|up and down at their own bits (linearwise.json: o 3,
    gate|up 4, down 3)."""
    rng = np.random.default_rng(sum(bits) + a8 + M)
    bo, bg, bd = bits
    jo, to = packed_pair(rng, H, H, bo, -1)
    jg, tg = fused_pair(rng, H, F, bg, -1)
    jd, td = packed_pair(rng, F, H, bd, -1)
    assert jf.attn_mlp_fusable(jo, jg, jd) and tf.attn_mlp_fusable(to, tg, td)
    ja, ta = _jt(_x(rng, 1, M, H))
    jr, tr = _jt(_x(rng, 1, M, H))
    jw2, tw2 = _jt((rng.random(H) + 0.5).astype(np.float32))
    want = jf.attn_mlp_fused(ja, jr, jw2, jo, jg, jd, a8=a8, interpret=True)

    def port():
        return tf.attn_mlp_fused(ta, tr, tw2, to, tg, td, a8=a8).numpy()

    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("bits,a8,M", [((4, 3), True, 1), ((4, 3), False, 4),
                                       ((3, 8), True, 4)])
def test_ffn_plain_at_mixed_bits_matches_jax(bits, a8, M, monkeypatch):
    """#6 with gate|up and down at their own bits."""
    rng = np.random.default_rng(sum(bits) * 3 + a8 + M)
    jg, tg = fused_pair(rng, H, F, bits[0], -1)
    jd, td = packed_pair(rng, F, H, bits[1], -1)
    jm, tm = _jt(_x(rng, 1, M, H))
    want = jf.ffn_fused(jm, jg, jd, act="silu", a8=a8, interpret=True)

    def port():
        return tf.ffn_fused(tm, tg, td, act="silu", a8=a8).numpy()

    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("bits,a8", [((4, 3, 4, 3), True),
                                     ((4, 3, 4, 3), False),
                                     ((3, 3, 3, 3), True)])
def test_layer_plain_at_mixed_bits_matches_jax(bits, a8, monkeypatch):
    """#12 with q|k|v, o, gate|up and down at their own bits, one token."""
    S, length, Hkv, hd = 16, 3, 2, H // 4
    rng = np.random.default_rng(sum(bits) + a8)
    bq, bo, bg, bd = bits
    parts = [packed_pair(rng, H, n, bq, -1) for n in (H, Hkv * hd, Hkv * hd)]
    L = [(jpack.fuse_packed([j for j, _ in parts]),
          tpack.fuse_packed([t for _, t in parts])),
         packed_pair(rng, H, H, bo, -1), fused_pair(rng, H, F, bg, -1),
         packed_pair(rng, F, H, bd, -1)]
    x = (rng.normal(size=(1, 1, H)) * 0.5).astype(np.float32)
    kv = rng.normal(size=(2, 1, S, Hkv, hd)).astype(np.float32)
    w1, w2 = ((rng.random(H) + 0.5).astype(np.float32) for _ in range(2))

    class _Spec:
        rope_theta = 10000.0
        hd = H // 4

    cos, sin = (np.array(t) for t in
                jc.rope_tables(_Spec, jnp.asarray([[length]])))
    kw = dict(n_heads=4, n_kv_heads=Hkv, sm_scale=hd ** -0.5, a8=a8)
    jy, _, _ = jl.decode_layer_fused(
        jnp.asarray(x), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jnp.asarray(length), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(w1), jnp.asarray(w2), *(j for j, _ in L),
        interpret=True, **kw)

    def port():
        tk, tv = (torch.from_numpy(c.copy()) for c in kv)
        return tl.decode_layer_fused(
            torch.from_numpy(x), tk, tv, torch.tensor(length),
            torch.from_numpy(cos), torch.from_numpy(sin),
            torch.from_numpy(w1), torch.from_numpy(w2),
            *(t for _, t in L), **kw).numpy()

    _check(port, np.asarray(jy), a8, monkeypatch)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _opt_dir(path, seed=5):
    from transformers import OPTConfig, OPTForCausalLM

    torch.manual_seed(seed)
    cfg = OPTConfig(vocab_size=99, hidden_size=64, ffn_dim=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=32, word_embed_proj_dim=64,
                    do_layer_norm_before=True)
    OPTForCausalLM(cfg).save_pretrained(path)
    return str(path)


def _bits(params, keys):
    return [[lp[k]["w"].bits if isinstance(lp[k]["w"], tpack.PackedWeight)
             else None for k in keys] for lp in params["layers"]]


def test_cli_linearmix_matches_jax(offline, tmp_path):
    d = _llama_dir(tmp_path / "llama", seed=8)
    out = _run_both(d, tmp_path, ["--wbits", "4", "--groupsize", "32",
                                  "--linearmix"])
    _check_logs(out)
    (_, jp, _), (_, tp, _) = _both_loaded(out)
    keys = ("q", "k", "v", "o", "gate", "up", "down")
    assert _bits(tp, keys) == [[4, 4, 3, 3, 4, 4, 3]] * 2 == _bits(jp, keys)
    for jlp, tlp in zip(jp["layers"], tp["layers"]):
        for k in keys:
            _codes_agree(jlp[k]["w"], tlp[k]["w"])


def test_cli_layermix_matches_jax(offline, tmp_path, monkeypatch):
    """--layermix reads the model's row of layerwise.json: a local
    quant_bit/ comes first, as in the JAX CLI; a model the table lacks
    exits with the names it has."""
    d = _opt_dir(tmp_path / "tiny-opt")
    monkeypatch.chdir(tmp_path)
    os.makedirs("quant_bit")
    with open("quant_bit/layerwise.json", "w") as f:
        json.dump({"tiny-opt": [3, 4]}, f)
    out = _run_both(d, tmp_path, ["--wbits", "4", "--layermix"])
    _check_logs(out)
    (_, jp, _), (_, tp, _) = _both_loaded(out)
    keys = ("q", "k", "v", "o", "fc1", "fc2")
    assert _bits(tp, keys) == [[3] * 6, [4] * 6] == _bits(jp, keys)
    for jlp, tlp in zip(jp["layers"], tp["layers"]):
        for k in keys:
            _codes_agree(jlp[k]["w"], tlp[k]["w"])
    with open("quant_bit/layerwise.json", "w") as f:
        json.dump({"opt-125m": [3] * 12}, f)
    with pytest.raises(SystemExit, match="'tiny-opt'.*opt-125m"):
        tcli.main([d, "wikitext2", "--wbits", "4", "--layermix",
                   "--nsamples", "2", "--device", "cpu"])


def test_cli_analyse_then_quant_config_matches_jax(offline, tmp_path,
                                                   monkeypatch, capsys):
    """--analyse writes results/quant_config.json under the working
    directory in both CLIs, the same JSON; --quant_config then quantizes
    each module at its bits, columnwise where the config says so."""
    from gptq_tpu import cli as jcli

    d = _llama_dir(tmp_path / "llama", seed=9)
    written = {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        assert main([d, "wikitext2", "--wbits", "3", "--nsamples", "4",
                     "--analyse", *extra]) == 0
        with open("results/quant_config.json") as f:
            written[pkg] = json.load(f)
    assert written["port"] == written["jax"]
    assert len(written["port"]) == 14
    cfg = dict(written["port"])
    # one module at 4 bits and one columnwise, whatever the rule decided
    cfg["model.layers.0.mlp.up_proj"] = {"bits": 4, "columnwise": False}
    cfg["model.layers.1.self_attn.o_proj"] = {"bits": 3, "columnwise": True}
    qc = str(tmp_path / "qc.json")
    with open(qc, "w") as f:
        json.dump(cfg, f)
    monkeypatch.chdir(tmp_path)
    out = _run_both(d, tmp_path, ["--groupsize", "32", "--wbits", "4",
                                  "--quant_config", qc])
    _check_logs(out)
    (_, jp, _), (_, tp, _) = _both_loaded(out)
    keys = ("q", "k", "v", "o", "gate", "up", "down")
    names = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
             "mlp.down_proj")
    for i, (jlp, tlp) in enumerate(zip(jp["layers"], tp["layers"])):
        for k, name in zip(keys, names):
            c = cfg[f"model.layers.{i}.{name}"]
            jw, tw = jlp[k]["w"], tlp[k]["w"]
            if c["columnwise"]:
                assert not isinstance(tw, tpack.PackedWeight)
                close = np.abs(tw.numpy() - np.asarray(jw)) <= 1e-5
                assert close.mean() >= 0.995, (i, k)
            else:
                assert tw.bits == jw.bits == c["bits"]
                _codes_agree(jw, tw)


@pytest.mark.parametrize("flags", [
    ["--wbits", "3", "--non_linear", "--exploreSplit", "8"],
    ["--wbits", "3", "--columnwise", "--bcq_round", "3"]],
    ids=["non_linear", "columnwise"])
def test_cli_dense_modes_match_jax(offline, tmp_path, flags):
    """--non_linear and --columnwise write dense quantize-dequantized
    weights; the result lines carry their fields, the PPLs within 1%."""
    d = _llama_dir(tmp_path / "llama", seed=10)
    out = _run_both(d, tmp_path, flags)
    _check_logs(out)
    line = out["port"][1][0]
    assert ("nonLinear = True" in line) == ("--non_linear" in flags)
    assert ("columnwise = True" in line) == ("--columnwise" in flags)
    (_, jp, _), (_, tp, _) = _both_loaded(out)
    for jlp, tlp in zip(jp["layers"], tp["layers"]):
        for k in ("q", "v", "down"):
            tw = tlp[k]["w"]
            assert not isinstance(tw, tpack.PackedWeight)
            close = np.abs(tw.numpy() - np.asarray(jlp[k]["w"])) <= 1e-5
            assert close.mean() >= 0.99, (k, close.mean())
