"""The port's fused serving route against gptq_tpu's on the CPU: the
routing gates decide the same on the same weights, whole-model decode
with fusion `on` in the port and `interpret` in JAX gives the same
teacher-forced logits (within a stated bound) and greedy tokens, and
quantize_lm_head packs the same codes and grids. The JAX side runs its
Pallas kernels in interpret mode, the port its plain versions."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu import pipeline as jpipe
from gptq_tpu.engine import decode as jdec
from gptq_tpu.models import common as jc
from gptq_tpu_torch import pipeline as tpipe
from gptq_tpu_torch.engine import decode as tdec
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import qmatmul as tq
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from test_torch_ffn import packed_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

# per-layer packing: (bits, groupsize, act-order)
LAYERS = ((4, -1, False), (3, 128, False), (4, 128, True), (4, 64, False))
DECODE = ((4, -1, False), (4, -1, False))  # one kernel shape: one compile


def _spec(n_layers, **kw):
    base = dict(arch="llama", n_layers=n_layers, hidden=256, n_heads=4,
                n_kv_heads=2, ffn=512, vocab=384, max_pos=128, act="silu",
                pos="rope", norm_type="rmsnorm", linear_bias=False)
    base.update(kw)
    return jc.ArchSpec(**base), tc.ArchSpec(**base)


def _pair(layers, seed=0, lm_bits=0, **kw):
    """(jspec, jax params, tspec, port params) with layer i's linears
    random packed weights of layers[i]; lm_bits packs the head with each
    package's quantize_lm_head."""
    jspec, tspec = _spec(len(layers), **kw)
    jp = jc.init_params(jspec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for lp, (bits, gs, actorder) in zip(jp["layers"], layers):
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            N, K = lp[key]["w"].shape
            jw, _ = packed_pair(rng, K, N, bits, gs, perm=actorder)
            lp[key] = {"w": jw, "b": None}
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    if lm_bits:
        assert jpipe.quantize_lm_head(jspec, jp, bits=lm_bits)
        assert tpipe.quantize_lm_head(tspec, tp, bits=lm_bits)
    return jspec, jp, tspec, tp


def _served(jspec, jp, tspec, tp, a8):
    return jc.fuse_serving(jspec, jp, a8=a8), tc.fuse_serving(tspec, tp, a8=a8)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= rtol, err
    return err


@pytest.fixture
def fusion(monkeypatch):
    """Fused route in both packages: `interpret` (JAX, Pallas kernels in
    interpret mode) and `on` (port, plain versions on the CPU) read the
    same variable; the port also takes `interpret`."""

    def set_mode(mode):
        monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", mode)

    set_mode("interpret")
    return set_mode


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def test_gates_decide_as_jax(fusion):
    jspec, jp, tspec, tp = _pair(LAYERS, lm_bits=8)
    decided = []
    for a8 in (True, False):
        js, ts = _served(jspec, jp, tspec, tp, a8)
        # mismatched a8 flags: the down projection alone serves a16
        for served in (js, ts):
            lp = served["layers"][0]
            flags = type(lp["o"]["serve"]) if a8 else None
            if a8:
                served["layers"][0] = {**lp, "down": {**lp["down"],
                                                      "serve": flags(a8=False)}}
        for i, (jl, tl) in enumerate(zip(js["layers"], ts["layers"])):
            for n in (1, 32, 33):
                pairs = [
                    (jc._norm_qkv_ok(jspec, jl, None, None, n),
                     tc._norm_qkv_ok(tspec, tl, None, n, "cpu")),
                    (jc._attn_mlp_ok(jspec, jl, None, None, n),
                     tc._attn_mlp_ok(tspec, tl, None, n, "cpu")),
                    (jc._ffn_fusion_entry(jl, None, None),
                     tc._ffn_fusion_entry(tl, None, "cpu")),
                    (jc._head_fusion_ok(jspec, js, None, n),
                     tc._head_fusion_ok(tspec, ts, n, "cpu")),
                ]
                for want, got in pairs:
                    assert got == want, (a8, i, n, pairs)
                    decided.append(got)
                # captures (calibration) always take the unfused route
                assert tc._norm_qkv_ok(tspec, tl, {}, n, "cpu") is None
    # every outcome occurs: a8, a16 and not fusable
    assert {True, False, None} <= set(decided)


def test_fusion_mode_switch(fusion):
    fusion("auto")
    assert not tc._ffn_fusion_impl("cpu")
    assert tc._ffn_fusion_impl("cuda")
    fusion("off")
    assert not tc._ffn_fusion_impl("cuda")
    fusion("on")
    assert tc._ffn_fusion_impl("cpu")
    fusion("sometimes")
    with pytest.raises(ValueError, match="GPTQ_TPU_FFN_FUSION"):
        tc._ffn_fusion_impl("cpu")


# ---------------------------------------------------------------------------
# whole-model decode
# ---------------------------------------------------------------------------

def _teacher_forced(model_forward, spec, params, cache, ids, to_np):
    out = []
    for t in range(ids.shape[1]):
        logits, cache = model_forward(spec, params, ids[:, t:t + 1], cache)
        out.append(to_np(logits[:, -1]))
    return np.stack(out)


# Teacher-forced logits over 2 fused layers. a16: the kernels round r2,
# the norms and the activations to bf16 at the same points in both
# packages; a value whose f32 straddles a bf16 boundary lands one bf16
# step (2^-8 relative) apart and moves the next layer's inputs by about
# that much (measured 1.55e-3 of the logit range here). a8 adds int8
# activation ties, as in test_torch_model.py (measured 8.0e-3). Each
# fused kernel alone holds 1e-4 / 1e-3, and test_torch_ffn.py shows each
# larger difference there to be such a tie. The bounds are about twice
# the measured readings: the inputs are seeded, so the reading moves only
# when a BLAS or XLA build sums in another order and flips other ties.
@pytest.mark.parametrize("a8,rtol", [(True, 1.6e-2), (False, 3e-3)])
def test_fused_decode_logits_and_tokens_match(fusion, a8, rtol):
    jspec, jp, tspec, tp = _pair(DECODE, seed=1, lm_bits=8)
    js, ts = _served(jspec, jp, tspec, tp, a8)
    assert tc._norm_qkv_ok(tspec, ts["layers"][0], None, 1, "cpu") == a8
    assert tc._attn_mlp_ok(tspec, ts["layers"][1], None, 1, "cpu") == a8
    assert tc._head_fusion_ok(tspec, ts, 1, "cpu") == a8
    ids = np.random.default_rng(2).integers(0, 384, size=(1, 6))
    before = (tf.norm_qkv_launches, tq.launches)
    jcache = jc.KVCache.init(jspec, 1, 16, jnp.int8)
    tcache = tc.KVCache.init(tspec, 1, 16, torch.int8, device="cpu")
    want = _teacher_forced(jc.model_forward, jspec, js, jcache,
                           jnp.asarray(ids), np.asarray)
    got = _teacher_forced(tc.model_forward, tspec, ts, tcache,
                          torch.from_numpy(ids), lambda t: t.numpy())
    # the CPU runs the plain versions: no kernel was launched
    assert (tf.norm_qkv_launches, tq.launches) == before
    _close(got, want, rtol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fused_greedy_tokens_match(fusion):
    jspec, jp, tspec, tp = _pair(DECODE, seed=3, lm_bits=8)
    prompt = np.random.default_rng(4).integers(0, 384, size=(1, 10))
    jeng = jdec.DecodeEngine(jspec, jp, max_len=32, cache_dtype=jnp.int8,
                             a8=True)
    teng = tdec.DecodeEngine(tspec, tp, max_len=32, cache_dtype=torch.int8,
                             a8=True)
    np.testing.assert_array_equal(teng.generate(prompt, 6),
                                  jeng.generate(prompt, 6))


def test_fused_route_matches_unfused_route(fusion):
    # the port's own two routes on the same weights: the fused route rounds
    # the activations to bf16 where the unfused one keeps f32 (measured
    # 7.8e-3 of the logit range)
    _, _, tspec, tp = _pair(LAYERS[:1], seed=5, lm_bits=8)
    ts = tc.fuse_serving(tspec, tp, a8=False)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 384, (1, 5)))

    def run():
        cache = tc.KVCache.init(tspec, 1, 16, torch.float32, device="cpu")
        return _teacher_forced(tc.model_forward, tspec, ts, cache, ids,
                               lambda t: t.numpy())

    fused = run()
    fusion("off")
    _close(fused, run(), 2e-2)


# ---------------------------------------------------------------------------
# quantize_lm_head and the fused head
# ---------------------------------------------------------------------------

def test_quantize_lm_head_matches_jax():
    jspec, jp, tspec, tp = _pair(LAYERS[:1], seed=7, lm_bits=8)
    jw, tw = jp["lm_head"]["w"], tp["lm_head"]["w"]
    assert (tw.bits, tw.K, tw.N, tw.groupsize, tw.Np) == \
        (jw.bits, jw.K, jw.N, jw.groupsize, jw.Np)
    for a, b in zip(jw.words, tw.words):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jw.scale), tw.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jw.zoff), tw.zoff.numpy())
    # already packed: a no-op in both packages
    assert not tpipe.quantize_lm_head(tspec, tp)
    # a tied head: the port packs the embedding table (the JAX package
    # leaves it dense), as JAX packs an explicit head of that table
    tied = {**tp, "lm_head": None}
    assert tpipe.quantize_lm_head(tspec, tied, bits=8)
    jp["lm_head"] = {"w": jp["embed"]["tokens"], "b": None}
    assert jpipe.quantize_lm_head(jspec, jp, bits=8)
    for a, b in zip(jp["lm_head"]["w"].words, tied["lm_head"]["w"].words):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("a8", [True, False])
def test_fused_head_logits_match(fusion, a8):
    jspec, jp, tspec, tp = _pair(LAYERS[:1], seed=8, lm_bits=8)
    js, ts = _served(jspec, jp, tspec, tp, a8)
    h = np.random.default_rng(9).normal(size=(2, 3, 256)).astype(np.float32)
    want = jc.head_forward(jspec, js, jnp.asarray(h))
    got = tc.head_forward(tspec, ts, torch.from_numpy(h))
    assert got.shape == (2, 3, 384)
    _close(got.numpy(), want, 1e-3 if a8 else 1e-4)
