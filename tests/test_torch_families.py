"""The OPT, BLOOM and Gemma families of the port against gptq_tpu on the
same numpy weights (CPU): OPT pre-norm, OPT-350m-style post-norm with
project_in / project_out, BLOOM (alibi, natively fused q|k|v) and Gemma
with one KV head (rmsnorm1p, gelu_tanh, H hd != hidden). Block and model
logits in f32, w4a8 and int8-KV logits under test_torch_model.py's
bounds, the fused serving gates, greedy tokens per-token and chained with
the fused route's plain versions (the layernorm, bias, no-GLU and gelu
branches of #4-#6) against the JAX Pallas kernels in interpret mode,
quantize + pack of tiny OPT and BLOOM models within the solver's bounds,
and checkpoints read and written both ways."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu import io as jio
from gptq_tpu import pipeline as jpipe
from gptq_tpu.config import QuantConfig as JQuantConfig
from gptq_tpu.engine import decode as jdec
from gptq_tpu.models import common as jc
from gptq_tpu.models import registry as jreg
from gptq_tpu.ops import pack as jpack
from gptq_tpu.quant import uniform as ju
from gptq_tpu_torch import io as tio
from gptq_tpu_torch import pipeline as tpipe
from gptq_tpu_torch.config import QuantConfig
from gptq_tpu_torch.engine import decode as tdec
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.models import registry as treg
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from test_torch_ffn import packed_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

# vocab 480: the packed head's stored width is padded to 512 (Np != N), as
# OPT's 50,272 is to 50,688
BASE = dict(n_layers=2, hidden=256, n_heads=4, ffn=512, vocab=480,
            max_pos=64)
FAMILIES = {
    "opt": dict(arch="opt", act="relu", pos="learned",
                norm_type="layernorm", linear_bias=True),
    "opt350": dict(arch="opt", act="relu", pos="learned",
                   norm_type="layernorm", linear_bias=True,
                   do_layer_norm_before=False, word_embed_dim=128),
    "bloom": dict(arch="bloom", act="gelu_tanh", pos="alibi",
                  norm_type="layernorm", linear_bias=True,
                  tie_embeddings=True),
    "gemma": dict(arch="gemma", act="gelu_tanh", pos="rope",
                  norm_type="rmsnorm1p", linear_bias=False,
                  tie_embeddings=True, n_kv_heads=1, head_dim=128,
                  embed_scale=16.0),
}
LINEARS = {"opt": ("q", "k", "v", "o", "fc1", "fc2"),
           "bloom": ("qkv", "o", "fc1", "fc2"),
           "gemma": ("q", "k", "v", "o", "gate", "up", "down")}
RTOL = 1e-5  # f32 on both sides, relative to max |logit|


def _specs(name, **kw):
    d = {**BASE, **FAMILIES[name], **kw}
    return jc.ArchSpec(**d), tc.ArchSpec(**d)


def _numpy_params(name, seed, **kw):
    """Seeded f32 params of family `name` as a numpy tree in the JAX
    layout: JAX's init_params with every leaf moved off its init value
    (norm weights, biases), and for opt350 an embedding of width 128
    behind project_in / project_out, no final layernorm and a tied head,
    as OPT-350m has them."""
    jspec, _ = _specs(name, **kw)
    tree = to_numpy_tree(jc.init_params(jspec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def jitter(node):
        if isinstance(node, dict):
            return {k: jitter(v) for k, v in node.items()}
        if isinstance(node, list):
            return [jitter(v) for v in node]
        if node is None:
            return None
        return (node + rng.normal(size=node.shape).astype(np.float32)
                * (0.1 if node.ndim == 1 else 0.01)).astype(np.float32)

    tree = jitter(tree)
    if name == "opt350":
        wed, h = jspec.word_embed_dim, jspec.hidden
        emb = tree["embed"]
        emb["tokens"] = rng.normal(size=(jspec.vocab, wed)).astype(
            np.float32) * 0.02
        emb["project_in"] = {"w": rng.normal(size=(h, wed)).astype(
            np.float32) / np.sqrt(wed), "b": None}
        emb["project_out"] = {"w": rng.normal(size=(wed, h)).astype(
            np.float32) / np.sqrt(h), "b": None}
        tree["final_ln"] = tree["lm_head"] = None
    return tree


def _pair(name, seed=0, **kw):
    """(jspec, JAX params, tspec, port params) on the same weights."""
    jspec, tspec = _specs(name, **kw)
    tree = _numpy_params(name, seed, **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    return jspec, jp, tspec, params_from_jax(tree, device="cpu")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= rtol, err
    return err


def _ids(seed, B, T, vocab=480):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T))


# ---------------------------------------------------------------------------
# specs and the model core
# ---------------------------------------------------------------------------

# the published configs of the widths chip_smoke serves, as transformers
# reads them (OPT-350m: the post-norm, projected variant)
HF_CONFIGS = {
    "opt-6.7b": dict(model_type="opt", num_hidden_layers=32, hidden_size=4096,
                     num_attention_heads=32, ffn_dim=16384, vocab_size=50272,
                     max_position_embeddings=2048, word_embed_proj_dim=4096,
                     do_layer_norm_before=True),
    "opt-350m": dict(model_type="opt", num_hidden_layers=24, hidden_size=1024,
                     num_attention_heads=16, ffn_dim=4096, vocab_size=50272,
                     max_position_embeddings=2048, word_embed_proj_dim=512,
                     do_layer_norm_before=False),
    "bloom-7b1": dict(model_type="bloom", n_layer=30, hidden_size=4096,
                      n_head=32, vocab_size=250880, layer_norm_epsilon=1e-5),
    "gemma-7b": dict(model_type="gemma", num_hidden_layers=28,
                     hidden_size=3072, num_attention_heads=16,
                     num_key_value_heads=16, head_dim=256,
                     intermediate_size=24576, vocab_size=256000,
                     max_position_embeddings=8192, rms_norm_eps=1e-6,
                     rope_theta=10000.0, hidden_activation=None),
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_spec_from_hf_config_matches_jax(name):
    cfg = SimpleNamespace(**HF_CONFIGS[name])
    assert treg.arch_of_hf_config(cfg) == jreg.arch_of_hf_config(cfg)
    tspec = treg.spec_from_hf_config(cfg)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(
        jreg.spec_from_hf_config(cfg))
    assert dataclasses.asdict(treg.get_arch(tspec.arch)) == \
        dataclasses.asdict(jreg.get_arch(tspec.arch))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_block_and_model_logits_match_f32(name):
    jspec, jp, tspec, tp = _pair(name, seed=1)
    ids = _ids(2, 2, 9)
    # one block with its calibration captures
    T = 9
    x = np.random.default_rng(3).normal(size=(1, T, 256)).astype(np.float32)
    pos = np.arange(T)[None]
    jout, _, jcaps = jc.block_forward(
        jspec, jp["layers"][0], jnp.asarray(x), positions=jnp.asarray(pos),
        mask=jc.build_mask(jspec, T, T), capture=True)
    tout, _, tcaps = tc.block_forward(
        tspec, tp["layers"][0], torch.from_numpy(x),
        positions=torch.from_numpy(pos), mask=tc.build_mask(tspec, T, T),
        capture=True)
    _close(tout.numpy(), jout)
    assert sorted(tcaps) == sorted(jcaps)
    for k in jcaps:
        _close(tcaps[k].numpy(), jcaps[k])
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    assert got.shape == (2, 9, 480)
    _close(got.numpy(), want)
    # f32 cache: a prompt of 5, then 4 single-token steps
    jcache = jc.KVCache.init(jspec, 2, 16, jnp.float32)
    tcache = tc.KVCache.init(tspec, 2, 16, torch.float32, device="cpu")
    for chunk in [ids[:, :5]] + [ids[:, i:i + 1] for i in range(5, 9)]:
        want, jcache = jc.model_forward(jspec, jp, jnp.asarray(chunk), jcache)
        got, tcache = tc.model_forward(tspec, tp, torch.from_numpy(chunk),
                                       tcache)
        _close(got.numpy(), want)


def _pack_rtn(jp, name):
    """RTN-pack every block linear of the JAX params (4-bit, groupsize -1)
    with the JAX package's quantizer; biases stay beside the packed
    weight."""
    fam = "opt" if name == "opt350" else name
    for lp in jp["layers"]:
        for key in LINEARS[fam]:
            W = lp[key]["w"]
            p = ju.find_params(W, bits=4)
            Q = ju.quantize_uniform(W, p.scale, p.zero, 15)
            lp[key] = {"w": jpack.pack_quantized(Q, p.scale.reshape(1, -1),
                                                 p.zero.reshape(1, -1), 4),
                       "b": lp[key]["b"]}
    return jp


def _packed_pair(name, seed):
    jspec, tspec = _specs(name)
    jp = _pack_rtn(jax.tree.map(jnp.asarray, _numpy_params(name, seed)),
                   name)
    return jspec, jp, tspec, params_from_jax(to_numpy_tree(jp), device="cpu")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_packed_logits_match_w4a8_and_int8_kv(name):
    jspec, jp, tspec, tp = _packed_pair(name, seed=4)
    ids = _ids(5, 2, 10)
    # w4a8: int8 activation ties flip the odd element (test_torch_model.py)
    js, ts = jc.fuse_serving(jspec, jp, a8=True), tc.fuse_serving(tspec, tp,
                                                                  a8=True)
    want, _ = jc.model_forward(jspec, js, jnp.asarray(ids))
    got, _ = tc.model_forward(tspec, ts, torch.from_numpy(ids))
    _close(got.numpy(), want, 5e-2)
    # w4a16 on an int8 cache: prefill then the deferred-write decode
    jcache = jc.KVCache.init(jspec, 2, 16, jnp.int8)
    tcache = tc.KVCache.init(tspec, 2, 16, torch.int8, device="cpu")
    for chunk in [ids[:, :6]] + [ids[:, i:i + 1] for i in range(6, 10)]:
        want, jcache = jc.model_forward(jspec, jp, jnp.asarray(chunk), jcache)
        got, tcache = tc.model_forward(tspec, tp, torch.from_numpy(chunk),
                                       tcache)
        _close(got.numpy(), want, 5e-3)


# ---------------------------------------------------------------------------
# the fused serving route (#4-#6's family branches)
# ---------------------------------------------------------------------------

@pytest.fixture
def fusion(monkeypatch):
    """The fused route in both packages: JAX runs its Pallas kernels in
    interpret mode, the port its plain versions on the CPU."""
    monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", "interpret")


def _served_pair(name, seed, a8=True):
    """Random packed weights (test_torch_ffn.packed_pair, 4-bit g-1, with
    the family's biases), an 8-bit head (a tied head from the embedding
    table in both), fuse_serving in both packages."""
    jspec, tspec = _specs(name)
    tree = _numpy_params(name, seed)
    rng = np.random.default_rng(seed)
    fam = "opt" if name == "opt350" else name
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, device="cpu")
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for key in LINEARS[fam]:
            N, K = jl[key]["w"].shape
            jw, tw = packed_pair(rng, K, N, 4, -1)
            jl[key] = {"w": jw, "b": jl[key]["b"]}
            tl[key] = {"w": tw, "b": tl[key]["b"]}
    if name != "opt350":  # OPT-350m's head sits behind project_out
        for p in (jp, tp):
            if p["lm_head"] is None:
                p["lm_head"] = {"w": p["embed"]["tokens"], "b": None}
        assert jpipe.quantize_lm_head(jspec, jp, bits=8)
        assert tpipe.quantize_lm_head(tspec, tp, bits=8)
    return (jspec, jc.fuse_serving(jspec, jp, a8=a8), tspec,
            tc.fuse_serving(tspec, tp, a8=a8))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_fused_gates_decide_as_jax(fusion, name):
    jspec, js, tspec, ts = _served_pair(name, seed=6)
    fused = name != "opt350"  # post-norm and project_out keep them off
    for n in (1, 32, 33):
        want = [jc._norm_qkv_ok(jspec, js["layers"][0], None, None, n),
                jc._attn_mlp_ok(jspec, js["layers"][0], None, None, n),
                jc._head_fusion_ok(jspec, js, None, n)]
        got = [tc._norm_qkv_ok(tspec, ts["layers"][0], None, n, "cpu"),
               tc._attn_mlp_ok(tspec, ts["layers"][0], None, n, "cpu"),
               tc._head_fusion_ok(tspec, ts, n, "cpu")]
        assert got == want
        assert got == ([True] * 3 if fused and n <= 32 else [None] * 3)
    if fused:
        lm = ts["lm_head"]["w"]
        assert (lm.N, lm.Np) == (480, 512)
    if name in ("opt", "bloom"):
        # the MLP biases fold in only at stored == logical widths, as JAX
        lp = dict(ts["layers"][0])
        fc1 = lp["fc1"]["w"]
        lp["fc1"] = {**lp["fc1"], "w": dataclasses.replace(fc1, N=fc1.N - 1)}
        assert tc._attn_mlp_ok(tspec, lp, None, 1, "cpu") is None


def _teacher_forced(model_forward, spec, params, cache, ids, to_np):
    out = []
    for t in range(ids.shape[1]):
        logits, cache = model_forward(spec, params, ids[:, t:t + 1], cache)
        out.append(to_np(logits[:, -1]))
    return np.stack(out)


# Greedy tokens on the fused route (int8 cache, w4a8, 8-bit head): the
# port's plain versions of #4-#6 against the JAX Pallas kernels in
# interpret mode, per token and chained. The kernels round to bf16 /
# int8 at the same points in both packages; a rounding tie that lands
# the other way moves a logit by ~1e-3 of the range (as
# test_torch_fused_serving.py's 1.6e-2 bound reads on llama), so where
# the tokens part, the JAX logits at that step must show a near tie of
# the two tokens (within 1.6e-2 of the logit range), as test_torch_ffn.
# _check puts a larger difference down to near-tie flips.
@pytest.mark.parametrize("name", list(FAMILIES))
def test_fused_greedy_tokens_match(fusion, name):
    jspec, js, tspec, ts = _served_pair(name, seed=7)
    prompt = _ids(8, 1, 6)
    jeng = jdec.DecodeEngine(jspec, js, max_len=32, cache_dtype=jnp.int8)
    teng = tdec.DecodeEngine(tspec, ts, max_len=32, cache_dtype=torch.int8)
    before = (tf.norm_qkv_launches, tf.attn_mlp_launches)
    want = jeng.generate(prompt, 6)
    for got in (teng.generate(prompt, 6),
                teng.generate_chained(prompt, 6, chunk=4)):
        assert (tf.norm_qkv_launches, tf.attn_mlp_launches) == before
        if np.array_equal(got, want):
            continue
        i = int(np.argmax(got[0] != want[0]))
        seq = np.concatenate([prompt, want[:, :i]], axis=1)
        logits = _teacher_forced(
            jc.model_forward, jspec, js, jc.KVCache.init(jspec, 1, 32,
                                                         jnp.int8),
            jnp.asarray(seq), np.asarray)[-1, 0]
        gap = abs(logits[want[0, i]] - logits[got[0, i]])
        assert gap <= 1.6e-2 * np.abs(logits).max(), (name, i, got, want)


# ---------------------------------------------------------------------------
# quantize + pack, checkpoints
# ---------------------------------------------------------------------------

SMALL = dict(n_layers=2, hidden=64, n_heads=4, ffn=128, vocab=99, max_pos=32)


@pytest.mark.parametrize("name", ["opt", "bloom"])
def test_quantize_and_pack_match(name):
    """GPTQ (4-bit, groupsize 32, act-order, true-sequential) of a tiny
    model in both packages from the same weights and calibration ids:
    per linear at least 99.5% of the codes equal, no code more than one
    step off (1.5 grid steps: the solver's bound), the proxy losses within
    1%; the quantized models' logits agree."""
    jspec, tspec = _specs(name, **SMALL)
    tree = _numpy_params(name, 9, **SMALL)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, device="cpu")
    calib = np.random.default_rng(10).integers(0, 99, size=(4, 32))
    kw = dict(wbits=4, groupsize=32, act_order=True, true_sequential=True)
    jres = jpipe.quantize_model(jspec, jp, jnp.asarray(calib),
                                JQuantConfig(**kw), log=lambda s: None)
    tres = tpipe.quantize_model(tspec, tp, torch.from_numpy(calib),
                                QuantConfig(**kw), log=lambda s: None)
    assert sorted(tres.quantizers) == sorted(jres.quantizers)
    for k, jl in jres.losses.items():
        assert abs(tres.losses[k] / jl - 1) < 0.01, k
    jpipe.pack_model(jspec, jp, jres.quantizers, JQuantConfig(**kw))
    tpipe.pack_model(tspec, tp, tres.quantizers, QuantConfig(**kw))
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for key in LINEARS[name]:
            jw, tw = jl[key]["w"], tl[key]["w"]
            assert isinstance(tw, tpack.PackedWeight) and tw.Np == jw.Np
            jcodes = tpack.unpack_codes(
                tuple(torch.from_numpy(np.asarray(w)) for w in jw.words),
                jw.bits, jw.groupsize).numpy()
            tcodes = tpack.unpack_codes(tw.words, tw.bits,
                                        tw.groupsize).numpy()
            assert np.mean(jcodes == tcodes) >= 0.995, key
            assert np.abs(jcodes - tcodes).max() <= 1, key
    ids = _ids(11, 1, 12, vocab=99)
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    _close(got.numpy(), want, 1e-2)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_checkpoints_both_ways(name, tmp_path):
    jspec, jp, tspec, tp = _packed_pair(name, seed=12)
    jp["embed"]["tokens"] = jp["embed"]["tokens"].astype(jnp.bfloat16)
    tp["embed"]["tokens"] = tp["embed"]["tokens"].to(torch.bfloat16)
    ids = _ids(13, 1, 7)
    want, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    jio.save_checkpoint(str(tmp_path / "j.npz"), jspec, jp)
    spec2, tp2, _ = tio.load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    assert spec2 == tspec
    got, _ = tc.model_forward(spec2, tp2, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    tio.save_checkpoint(str(tmp_path / "t.npz"), tspec, tp)
    spec3, jp3, _ = jio.load_checkpoint(str(tmp_path / "t.npz"))
    assert dataclasses.asdict(spec3) == dataclasses.asdict(tspec)
    jwant, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    jgot, _ = jc.model_forward(spec3, jp3, jnp.asarray(ids))
    np.testing.assert_array_equal(np.asarray(jgot), np.asarray(jwant))


def test_quantize_lm_head_packs_a_tied_head():
    """A tied head (BLOOM's) is a no-op in the JAX package; the port packs
    the embedding table as the head, the same codes JAX packs from an
    explicit head of the same table, and keeps the embedding dense."""
    jspec, jp, tspec, tp = _pair("bloom", seed=14)
    assert tp["lm_head"] is None
    assert not jpipe.quantize_lm_head(jspec, jp)
    assert tpipe.quantize_lm_head(tspec, tp, bits=8)
    jp["lm_head"] = {"w": jp["embed"]["tokens"], "b": None}
    assert jpipe.quantize_lm_head(jspec, jp, bits=8)
    jw, tw = jp["lm_head"]["w"], tp["lm_head"]["w"]
    for a, b in zip(jw.words, tw.words):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tp["embed"]["tokens"].dtype == torch.float32  # kept dense
