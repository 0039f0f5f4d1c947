"""The ported MoE path against gptq_tpu on the same numpy inputs (CPU):
PackedExperts packing, the expert-bank matmuls (plain versions against the
JAX package's Pallas kernels in interpret mode), routing, moe_ffn over
dense / int8 / packed stacks in each regime, gptq_quantize_experts, the
Mixtral spec from an HF config, whole-model MoE logits and tokens, and
checkpoint interchange of expert banks in both directions."""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu import io as jio
from gptq_tpu.config import QuantConfig as JQuantConfig
from gptq_tpu.engine import decode as jdec
from gptq_tpu.models import common as jc
from gptq_tpu.models import moe as jm
from gptq_tpu.models import registry as jreg
from gptq_tpu.ops import pack as jpack
from gptq_tpu.ops import qmatmul as jq
from gptq_tpu.quant import uniform as ju
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.config import QuantConfig
from gptq_tpu_torch.engine import decode as tdec
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.models import moe as tm
from gptq_tpu_torch.models import registry as treg
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from torch_threads import torch_threads  # noqa: F401 (autouse)

# hidden 48 pads the gate / up banks' K to 64 (pack_expert_stack's
# multiple of 32); capacity E / k = 2.0 makes the model dropless
KW = dict(arch="llama", n_layers=2, hidden=48, n_heads=4, n_kv_heads=2,
          ffn=96, vocab=89, max_pos=64, act="silu", pos="rope",
          norm_type="rmsnorm", linear_bias=False, tie_embeddings=False,
          n_experts=4, expert_top_k=2, expert_capacity=2.0)
RTOL = 1e-4  # whole-model f32 logits, relative to max |logit|


def _specs(**kw):
    return jc.ArchSpec(**{**KW, **kw}), tc.ArchSpec(**{**KW, **kw})


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)
    assert err <= rtol, err


def _bank_pair(E=4, F=96, D=64, bits=4, groupsize=-1, seed=0):
    """The same RTN-gridded (E, F, D) stack packed by both packages."""
    W = (np.random.default_rng(seed).normal(size=(E, F, D)) * 0.2
         ).astype(np.float32)
    js, jz = jm._rtn_expert_grids(jnp.asarray(W), bits, groupsize)
    ts, tz = tm._rtn_expert_grids(_t(W), bits, groupsize)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jpe = jpack.pack_expert_stack(jnp.asarray(W), js, jz, bits, groupsize)
    tpe = tpack.pack_expert_stack(_t(W), ts, tz, bits, groupsize)
    return jpe, tpe


@pytest.mark.parametrize("bits,groupsize,D", [
    (4, -1, 64), (3, -1, 64), (2, 32, 64), (8, -1, 64), (4, 16, 48),
    (3, 32, 96)])
def test_pack_expert_stack_bit_exact(bits, groupsize, D):
    jpe, tpe = _bank_pair(bits=bits, groupsize=groupsize, D=D, seed=bits)
    assert (tpe.E, tpe.K, tpe.N, tpe.Kp, tpe.Np) == \
        (jpe.E, jpe.K, jpe.N, jpe.Kp, jpe.Np)
    assert len(tpe.words) == len(jpe.words)
    for tw, jw in zip(tpe.words, jpe.words):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tpe.scale.numpy(), np.asarray(jpe.scale))
    np.testing.assert_array_equal(tpe.zoff.numpy(), np.asarray(jpe.zoff))


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (3, 32), (8, -1)])
def test_dequant_experts_and_expert_view_match(bits, groupsize):
    jpe, tpe = _bank_pair(bits=bits, groupsize=groupsize, seed=7)
    want = np.asarray(jq.dequant_experts(jpe))
    got = tq.dequant_experts(tpe).numpy()
    assert got.shape == want.shape == (4, 64, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # one expert, by int and by a 0-d index tensor (no host read)
    for e in (0, torch.tensor(2, dtype=torch.int32)):
        np.testing.assert_allclose(tq.dequant(tpe.expert(e)).numpy(),
                                   want[int(e)], rtol=0, atol=1e-6)


@pytest.mark.parametrize("per_x", [False, True])
@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 32), (2, 32),
                                            (3, -1)])
def test_expert_matmul_plain_matches_jax_kernel(per_x, bits, groupsize):
    jpe, tpe = _bank_pair(bits=bits, groupsize=groupsize, seed=11)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3, 64) if per_x else (3, 64)).astype(np.float32)
    want = jq.expert_dequant_matmul(jnp.asarray(x), jpe, impl="pallas",
                                    interpret=True)
    got = tq.expert_dequant_matmul(_t(x), tpe)
    assert got.shape == (4, 3, 96) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)
    _close(tq.expert_dequant_matmul_reference(_t(x), tpe).numpy(), want,
           1e-4)


@pytest.mark.parametrize("groupsize", [-1, 32])
def test_expert_select_plain_matches_jax_kernel(groupsize):
    jpe, tpe = _bank_pair(groupsize=groupsize, seed=13)
    x = np.random.default_rng(9).normal(size=(3, 64)).astype(np.float32)
    for e in (0, 2, 3):
        want = jq.expert_dequant_matmul_select(jnp.asarray(x), jpe,
                                               jnp.asarray(e), interpret=True)
        got = tq.expert_dequant_matmul_select(
            _t(x), tpe, torch.tensor([e], dtype=torch.int32))
        assert got.shape == (3, 96) and got.dtype == torch.float32
        _close(got.numpy(), want, 1e-4)


def _router_input(seed, N=24, D=48, E=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, D)).astype(np.float32) * 0.3,
            rng.normal(size=(N, D)).astype(np.float32))


@pytest.mark.parametrize("capacity", [1.0, 1.25, 2.0])
def test_route_matches(capacity):
    jspec, tspec = _specs(expert_capacity=capacity)
    rw, x = _router_input(3)
    jd, jcb, ja = jm.route(jspec, jnp.asarray(rw), jnp.asarray(x))
    td, tcb, ta = tm.route(tspec, _t(rw), _t(x))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


def test_route_weights_match():
    jspec, tspec = _specs()
    rw, x = _router_input(4)
    jw, ja = jm.route_weights(jspec, jnp.asarray(rw), jnp.asarray(x))
    tw, ta = tm.route_weights(tspec, _t(rw), _t(x))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


def test_router_tie_picks_the_lower_index():
    # experts 1, 2 and 3 score equal; top-2 must be {1, 2} (jax.lax.top_k
    # order), on the dropless and the capacity path, and in the decode
    # selection over the routing weights
    jspec, tspec = _specs()
    rw, x = _router_input(5, N=6)
    rw[2] = rw[1]
    rw[3] = rw[1]
    rw[0] = -rw[1]
    x = np.abs(x) * np.sign(rw[1])  # expert 1's row scores highest
    tw, _ = tm.route_weights(tspec, _t(rw), _t(x))
    jw, _ = jm.route_weights(jspec, jnp.asarray(rw), jnp.asarray(x))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)
    assert (tw[:, 1] > 0).all() and (tw[:, 2] > 0).all()
    assert (tw[:, 0] == 0).all() and (tw[:, 3] == 0).all()
    td, _, _ = tm.route(tspec, _t(rw), _t(x))
    assert (td[:, 3].sum() == 0) and (td[:, 1].sum(dim=-1) == 1).all()
    vals, idx = tm.select_top_k(torch.tensor([0.5, 0.25, 0.5, 0.25]), 3)
    assert idx.tolist() == [0, 2, 1] and vals.tolist() == [0.5, 0.5, 0.25]


def _moe_layer(kind, seed=0, bits=4, groupsize=-1):
    """One MoE layer's params for both packages: dense f32 stacks, int8
    RTN codes (quantize_experts) or packed banks (pack_experts)."""
    jspec, _ = _specs()
    jp = jm.init_moe_params(jspec, jax.random.PRNGKey(seed))
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    jt, tt = {"layers": [jp]}, {"layers": [tp]}
    if kind == "int8":
        jm.quantize_experts(jt, bits=8)
        tm.quantize_experts(tt, bits=8)
        for name in ("gate", "up", "down"):
            np.testing.assert_array_equal(tp["experts"][name].numpy(),
                                          np.asarray(jp["experts"][name]))
            np.testing.assert_allclose(
                tp["experts"][name + "_scale"].numpy(),
                np.asarray(jp["experts"][name + "_scale"]), rtol=1e-6)
    elif kind == "packed":
        jm.pack_experts(jt, bits=bits, groupsize=groupsize)
        tm.pack_experts(tt, bits=bits, groupsize=groupsize)
        for name in ("gate", "up", "down"):
            for tw, jw in zip(tp["experts"][name].words,
                              jp["experts"][name].words):
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    return jp, tp


@pytest.mark.parametrize("T", [1, 16, 48])
@pytest.mark.parametrize("kind", ["dense", "int8", "packed"])
def test_moe_ffn_matches(kind, T):
    """Packed: T = 1 takes the select path (#9), 16 the batched bank (#8),
    48 per-expert dequant_matmul; f32 on both sides."""
    jspec, tspec = _specs()
    jp, tp = _moe_layer(kind, seed=T)
    x = np.random.default_rng(T).normal(size=(1, T, 48)).astype(np.float32)
    jaux, taux = [], []
    want = jm.moe_ffn(jspec, jp, jnp.asarray(x), aux_out=jaux)
    got = tm.moe_ffn(tspec, tp, _t(x), aux_out=taux)
    assert got.shape == (1, T, 48) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    np.testing.assert_allclose(float(taux[0]), float(jaux[0]), atol=1e-6)


def test_moe_ffn_select_counts_and_xla_route(monkeypatch):
    """At T = 1 the packed path makes top_k selections per projection
    (the select wrapper, here its plain version); with
    GPTQ_TPU_MATMUL_IMPL=xla it serves each through dequant_matmul, as
    the JAX package does, with the same result."""
    jspec, tspec = _specs()
    jp, tp = _moe_layer("packed", seed=21, bits=3, groupsize=16)
    x = _t(np.random.default_rng(2).normal(size=(1, 1, 48)).astype(np.float32))
    calls = []
    real = tq.expert_dequant_matmul_select
    monkeypatch.setattr(tm, "expert_dequant_matmul_select",
                        lambda *a: calls.append(1) or real(*a))
    got = tm.moe_ffn(tspec, tp, x)
    assert len(calls) == 3 * tspec.expert_top_k
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "xla")
    got_xla = tm.moe_ffn(tspec, tp, x)
    assert len(calls) == 3 * tspec.expert_top_k
    want = jm.moe_ffn(jspec, jp, jnp.asarray(x.numpy()))
    _close(got.numpy(), want, 1e-5)
    _close(got_xla.numpy(), want, 1e-5)


@pytest.mark.parametrize("capacity,T", [(2.0, 16), (2.0, 1), (1.0, 8)])
def test_moe_ffn_computes_the_aux_loss_only_when_collected(monkeypatch,
                                                          capacity, T):
    """Without aux_out moe_ffn never calls _aux (its kernels would run for
    nothing on every decode step) and returns the same output; with it the
    loss is computed once (test_moe_ffn_matches holds it to JAX's), on the
    dropless and the capacity path."""
    _, tspec = _specs(expert_capacity=capacity)
    _, tp = _moe_layer("dense", seed=3)
    x = np.random.default_rng(T).normal(size=(1, T, 48)).astype(np.float32)
    calls = []
    real = tm._aux
    monkeypatch.setattr(tm, "_aux", lambda *a: calls.append(1) or real(*a))
    got = tm.moe_ffn(tspec, tp, _t(x))
    assert calls == []
    taux = []
    with_aux = tm.moe_ffn(tspec, tp, _t(x), aux_out=taux)
    assert len(calls) == 1 and len(taux) == 1
    assert torch.equal(got, with_aux)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_moe_ffn_capacity_path_matches(kind):
    # capacity 1.0: C = N / 2 slots per expert, so the GShard dispatch
    # path runs and drops assignments
    jspec, tspec = _specs(expert_capacity=1.0)
    jp, tp = _moe_layer(kind, seed=5)
    x = np.random.default_rng(6).normal(size=(2, 8, 48)).astype(np.float32)
    want = jm.moe_ffn(jspec, jp, jnp.asarray(x))
    got = tm.moe_ffn(tspec, tp, _t(x))
    _close(got.numpy(), want, 1e-5)


def test_moe_ffn_refusals():
    jspec, tspec = _specs(expert_capacity=1.0)
    _, tp = _moe_layer("packed", seed=8)
    x = torch.zeros((1, 8, 48))
    with pytest.raises(ValueError, match="dropless"):
        tm.moe_ffn(tspec, tp, x)
    with pytest.raises(ValueError, match="int8"):
        _, t8 = _moe_layer("int8", seed=8)
        tm.pack_experts({"layers": [t8]})


# ---------------------------------------------------------------------------
# GPTQ of the expert stacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quantized_experts():
    jspec, tspec = _specs()
    jp = jc.init_params(jspec, jax.random.PRNGKey(2))
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    calib = np.random.default_rng(3).integers(0, KW["vocab"], size=(4, 16))
    qkw = dict(wbits=4, nsamples=4)
    jl = jm.gptq_quantize_experts(jspec, jp, jnp.asarray(calib),
                                  JQuantConfig(**qkw), keep_grids=True)
    tl = tm.gptq_quantize_experts(tspec, tp, torch.from_numpy(calib),
                                  QuantConfig(**qkw), keep_grids=True)
    return jspec, jp, jl, tspec, tp, tl


def test_gptq_quantize_experts_matches(quantized_experts):
    """Codes and losses per expert within the solver tolerances of
    tests/test_reference_parity.py:18-23 (>= 99.5% of entries equal, none
    off by more than 1.5 grid steps, losses within 1%)."""
    jspec, jp, jl, tspec, tp, tl = quantized_experts
    assert set(tl) == set(jl) and len(tl) == 2 * 3 * KW["n_experts"]
    for name, jloss in jl.items():
        assert abs(tl[name] - jloss) <= 0.01 * abs(jloss) + 1e-6, \
            (name, jloss, tl[name])
    for i in range(KW["n_layers"]):
        jex, tex = jp["layers"][i]["experts"], tp["layers"][i]["experts"]
        for proj in ("gate", "up", "down"):
            jQ, tQ = np.asarray(jex[proj]), tex[proj].numpy()
            step = np.asarray(jex["_grids"][proj]["scale"]).max()
            for e in range(KW["n_experts"]):
                exact = np.mean(np.abs(jQ[e] - tQ[e]) <= 1e-5)
                assert exact >= 0.995, (i, proj, e, exact)
                assert np.abs(jQ[e] - tQ[e]).max() <= 1.5 * step + 1e-6
            np.testing.assert_allclose(
                tex["_grids"][proj]["scale"].numpy(),
                np.asarray(jex["_grids"][proj]["scale"]), rtol=1e-3)


def test_pack_experts_reuses_the_solver_grids(quantized_experts):
    """pack_experts packs with the stashed grids: the bank decodes to the
    fake-quantized dense values (the same codes)."""
    _, _, _, tspec, tp, _ = quantized_experts
    tp = copy.deepcopy(tp)
    dense = [lp["experts"]["gate"].clone() for lp in tp["layers"]]
    tm.pack_experts(tp, bits=4)
    for lp, d in zip(tp["layers"], dense):
        assert "_grids" not in lp["experts"]
        got = tq.dequant_experts(lp["experts"]["gate"]).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), d.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_quantize_model_skips_the_expert_linears():
    from gptq_tpu_torch.pipeline import pack_model, quantize_model

    _, tspec = _specs(hidden=64)  # pack_quantized takes K % 32 == 0
    tp = tc.init_params(tspec, seed=4, device="cpu")
    calib = torch.from_numpy(
        np.random.default_rng(4).integers(0, KW["vocab"], size=(2, 16)))
    cfg = QuantConfig(wbits=4, nsamples=2, true_sequential=True)
    res = quantize_model(tspec, tp, calib, cfg, log=lambda s: None)
    assert {k.rsplit(".", 1)[-1] for k in res.quantizers} == \
        {"q_proj", "k_proj", "v_proj", "o_proj"}
    pack_model(tspec, tp, res.quantizers, cfg)
    lp = tp["layers"][1]
    assert isinstance(lp["o"]["w"], tpack.PackedWeight)
    assert lp["experts"]["gate"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the spec, the whole model, checkpoints
# ---------------------------------------------------------------------------

MIXTRAL_8X7B = dict(
    model_type="mixtral", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    vocab_size=32000, max_position_embeddings=32768, rope_theta=1e6,
    rms_norm_eps=1e-5, tie_word_embeddings=False, num_local_experts=8,
    num_experts_per_tok=2)


def test_spec_from_hf_config_matches_on_mixtral():
    cfg = SimpleNamespace(**MIXTRAL_8X7B)
    jspec = jreg.spec_from_hf_config(cfg)
    tspec = treg.spec_from_hf_config(cfg)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.expert_capacity == 4.0 and tspec.kv_heads == 8
    assert tm.expert_capacity(tspec, 16) == 16  # dropless
    llama = SimpleNamespace(**{**{k: v for k, v in MIXTRAL_8X7B.items()
                                  if "expert" not in k},
                               "model_type": "llama"})
    assert dataclasses.asdict(treg.spec_from_hf_config(llama)) == \
        dataclasses.asdict(jreg.spec_from_hf_config(llama))
    # OPT is ported: its spec is JAX's (tests/test_torch_families.py)
    opt = SimpleNamespace(model_type="opt", num_hidden_layers=2,
                          hidden_size=64, num_attention_heads=4, ffn_dim=128,
                          vocab_size=99, max_position_embeddings=32,
                          word_embed_proj_dim=64, do_layer_norm_before=True)
    assert dataclasses.asdict(treg.spec_from_hf_config(opt)) == \
        dataclasses.asdict(jreg.spec_from_hf_config(opt))


def _model_pair(seed=0, pack=None, attn_bits=None):
    """Whole-model MoE params for both packages (f32), the experts packed
    at `pack` bits and the attention linears RTN-packed at attn_bits
    (then at hidden 64: pack_quantized takes K % 32 == 0)."""
    jspec, tspec = _specs(**({"hidden": 64} if attn_bits else {}))
    jp = jc.init_params(jspec, jax.random.PRNGKey(seed))
    if pack:
        jm.pack_experts(jp, bits=pack)
    if attn_bits:
        for lp in jp["layers"]:
            for key in ("q", "k", "v", "o"):
                W = lp[key]["w"]
                p = ju.find_params(W, bits=attn_bits)
                Q = ju.quantize_uniform(W, p.scale, p.zero,
                                        (1 << attn_bits) - 1)
                lp[key] = {"w": jpack.pack_quantized(
                    Q, p.scale.reshape(1, -1), p.zero.reshape(1, -1),
                    attn_bits), "b": None}
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    return jspec, jp, tspec, tp


def test_init_params_and_refusals_lifted():
    jspec, jp, tspec, _ = _model_pair()
    tp = tc.init_params(tspec, seed=1, device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda a: tuple(a.shape), tree)

    assert shapes(tp) == shapes(jp)
    logits, _ = tc.model_forward(tspec, tp, torch.zeros((1, 5),
                                                        dtype=torch.long))
    assert logits.shape == (1, 5, KW["vocab"])
    # experts serve a GLU FFN: llama and Gemma only, as in the JAX package
    with pytest.raises(ValueError, match="n_experts"):
        tc.init_params(dataclasses.replace(tspec, arch="opt"), device="cpu")


def test_params_from_jax_carries_packed_experts():
    _, jp, _, tp = _model_pair(pack=3)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for name in ("gate", "up", "down"):
            jpe, tpe = jl["experts"][name], tl["experts"][name]
            assert isinstance(tpe, tpack.PackedExperts)
            assert (tpe.bits, tpe.K, tpe.N, tpe.groupsize) == \
                (jpe.bits, jpe.K, jpe.N, jpe.groupsize)
            for tw, jw in zip(tpe.words, jpe.words):
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(tpe.zoff.numpy(),
                                          np.asarray(jpe.zoff))


@pytest.mark.parametrize("T", [1, 16, 48])
@pytest.mark.parametrize("pack", [None, 4])
def test_model_logits_match(pack, T):
    jspec, jp, tspec, tp = _model_pair(seed=T, pack=pack)
    ids = np.random.default_rng(T).integers(0, KW["vocab"], size=(1, T))
    jaux, taux = [], []
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids), moe_aux=jaux)
    got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids), moe_aux=taux)
    _close(got.numpy(), want, RTOL)
    assert len(taux) == KW["n_layers"]
    np.testing.assert_allclose([float(a) for a in taux],
                               [float(a) for a in jaux], atol=1e-6)


def test_cached_decode_logits_match():
    jspec, jp, tspec, tp = _model_pair(seed=3, pack=4)
    ids = np.random.default_rng(3).integers(0, KW["vocab"], size=(1, 12))
    jcache = jc.KVCache.init(jspec, 1, 16, jnp.float32)
    tcache = tc.KVCache.init(tspec, 1, 16, torch.float32, device="cpu")
    for chunk in [ids[:, :8]] + [ids[:, i:i + 1] for i in range(8, 12)]:
        want, jcache = jc.model_forward(jspec, jp, jnp.asarray(chunk), jcache)
        got, tcache = tc.model_forward(tspec, tp, torch.from_numpy(chunk),
                                       tcache)
        _close(got.numpy(), want, RTOL)


def test_greedy_tokens_match():
    jspec, jp, tspec, tp = _model_pair(seed=4, pack=4)
    prompt = np.random.default_rng(4).integers(0, KW["vocab"], size=(1, 10))
    want = jdec.DecodeEngine(jspec, jp, max_len=32,
                             cache_dtype=jnp.float32).generate(prompt, 16)
    got = tdec.DecodeEngine(tspec, tp, max_len=32,
                            cache_dtype=torch.float32).generate(prompt, 16)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_forward():
    """gptq_tpu's model_forward compiled whole by jax.jit (the spec
    static): one XLA program a call shape, where the eager calls compile
    every primitive of the model on its own."""
    return jax.jit(jc.model_forward, static_argnums=0)


def test_w4a8_int8kv_decode_matches(jax_forward):
    """The serving flags' route (--faster-kernel --int8_kv) on an MoE model
    whose attention linears and experts are 4-bit packed. The bounds are
    ROADMAP section 3's: int8 rounding ties of the two frameworks' ~1e-7
    f32 differences land a step apart (5e-2 of the logit range with int8
    activations, 5e-3 with the int8 cache); the greedy tokens agree."""
    jspec, jp, tspec, tp = _model_pair(seed=6, pack=4, attn_bits=4)
    jf = jc.fuse_serving(jspec, jp, a8=True)
    tf = tc.fuse_serving(tspec, tp, a8=True)
    assert "router" in tf["layers"][0] and "qkv_fused" in tf["layers"][0]
    ids = np.random.default_rng(6).integers(0, KW["vocab"], size=(1, 12))
    want, _ = jax_forward(jspec, jf, jnp.asarray(ids))
    got, _ = tc.model_forward(tspec, tf, torch.from_numpy(ids))
    _close(got.numpy(), want, 5e-2)
    jcache = jc.KVCache.init(jspec, 1, 16, jnp.int8)
    tcache = tc.KVCache.init(tspec, 1, 16, torch.int8, device="cpu")
    for chunk in [ids[:, :8]] + [ids[:, i:i + 1] for i in range(8, 12)]:
        want, jcache = jax_forward(jspec, jp, jnp.asarray(chunk), jcache)
        got, tcache = tc.model_forward(tspec, tp, torch.from_numpy(chunk),
                                       tcache)
        _close(got.numpy(), want, 5e-3)
    prompt = ids[:, :6]
    jtok = jdec.DecodeEngine(jspec, jp, max_len=32, cache_dtype=jnp.int8,
                             a8=True).generate(prompt, 12)
    ttok = tdec.DecodeEngine(tspec, tp, max_len=32, cache_dtype=torch.int8,
                             a8=True).generate(prompt, 12)
    np.testing.assert_array_equal(ttok, jtok)


def test_checkpoint_jax_to_port(tmp_path):
    jspec, jp, tspec, _ = _model_pair(seed=7, pack=3, attn_bits=4)
    path = str(tmp_path / "j.npz")
    jio.save_checkpoint(path, jspec, jp)
    spec2, tp, _ = tio.load_checkpoint(path, device="cpu")
    assert spec2 == tspec
    pe = tp["layers"][1]["experts"]["down"]
    assert isinstance(pe, tpack.PackedExperts) and pe.bits == 3
    ids = np.random.default_rng(7).integers(0, KW["vocab"], size=(1, 12))
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    got, _ = tc.model_forward(spec2, tp, torch.from_numpy(ids))
    _close(got.numpy(), want, RTOL)


def test_checkpoint_port_to_jax(tmp_path):
    jspec, jp, tspec, tp = _model_pair(seed=8, pack=2)
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, tspec, tp)
    spec3, jp3, _ = jio.load_checkpoint(path)
    assert spec3 == jspec
    for jl, tl in zip(jp3["layers"], tp["layers"]):
        for name in ("gate", "up", "down"):
            jpe, tpe = jl["experts"][name], tl["experts"][name]
            assert isinstance(jpe, jpack.PackedExperts) and jpe.bits == 2
            for tw, jw in zip(tpe.words, jpe.words):
                np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
            np.testing.assert_array_equal(np.asarray(jpe.scale),
                                          tpe.scale.numpy())
    ids = np.random.default_rng(8).integers(0, KW["vocab"], size=(1, 9))
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    got, _ = jc.model_forward(spec3, jp3, jnp.asarray(ids))
    _close(np.asarray(got), want, 1e-6)
