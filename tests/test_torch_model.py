"""The ported llama model core against gptq_tpu on the same weights (CPU,
f32): dense, packed a16, packed a8 (w4a8) and int8-KV decode logits,
greedy tokens, checkpoint interchange in both directions, and the
package's rules (no JAX / gptq_tpu imports, CUDA by default)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu import io as jio
from gptq_tpu.engine import decode as jdec
from gptq_tpu.models import common as jc
from gptq_tpu.ops import pack as jpack
from gptq_tpu.quant import uniform as ju
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.engine import decode as tdec
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4  # relative to max |logit|: f32 on both sides, other op order


def _spec(kv_heads):
    kw = dict(arch="llama", n_layers=2, hidden=256, n_heads=4,
              n_kv_heads=kv_heads, ffn=512, vocab=384, max_pos=128,
              act="silu", pos="rope", norm_type="rmsnorm", linear_bias=False)
    return jc.ArchSpec(**kw), tc.ArchSpec(**kw)


def _pack_jax(params, groupsize, seed=0):
    """RTN-pack every block linear in the JAX params (4-bit; with groups,
    an act-order permutation so the served x[:, perm] gather is exercised)."""
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            W = np.asarray(lp[key]["w"], np.float32)
            rows, cols = W.shape
            if groupsize <= 0:
                p = ju.find_params(jnp.asarray(W), bits=4)
                Q = ju.quantize_uniform(jnp.asarray(W), p.scale, p.zero, 15)
                pw = jpack.pack_quantized(Q, p.scale.reshape(1, -1),
                                          p.zero.reshape(1, -1), 4)
            else:
                perm = rng.permutation(cols).astype(np.int32)
                Wp = W[:, perm]
                scales, zeros, Qp = [], [], []
                for g0 in range(0, cols, groupsize):
                    blk = jnp.asarray(Wp[:, g0:g0 + groupsize])
                    p = ju.find_params(blk, bits=4)
                    Qp.append(np.asarray(ju.quantize_uniform(
                        blk, p.scale, p.zero, 15)))
                    scales.append(np.asarray(p.scale).reshape(-1))
                    zeros.append(np.asarray(p.zero).reshape(-1))
                Q = np.concatenate(Qp, axis=1)[:, np.argsort(perm)]
                pw = jpack.pack_quantized(
                    jnp.asarray(Q), jnp.asarray(np.stack(scales)),
                    jnp.asarray(np.stack(zeros)), 4, groupsize,
                    perm=jnp.asarray(perm), actorder=True)
            lp[key] = {"w": pw, "b": None}
    return params


def _pair(kv_heads=4, packed=None, a8=False):
    jspec, tspec = _spec(kv_heads)
    jp = jc.init_params(jspec, jax.random.PRNGKey(kv_heads))
    if packed is not None:
        jp = _pack_jax(jp, packed)
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    if a8:
        jp = jc.fuse_serving(jspec, jp, a8=True)
        tp = tc.fuse_serving(tspec, tp, a8=True)
    return jspec, jp, tspec, tp


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= rtol, err


def _ids(seed, B, T, vocab=384):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T))


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("variant", ["dense", "w4a16", "w4g64a16", "w4a8"])
def test_logits_match(kv_heads, variant):
    packed = {"dense": None, "w4a16": -1, "w4g64a16": 64, "w4a8": -1}[variant]
    jspec, jp, tspec, tp = _pair(kv_heads, packed, a8=variant == "w4a8")
    ids = _ids(kv_heads, 2, 12)
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    got, cache = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    assert cache is None and got.shape == (2, 12, 384)
    # w4a8: each linear matches to 1e-6 on equal inputs
    # (test_torch_qmatmul.py), but the two frameworks' ~1e-7 f32
    # differences ahead of a dynamic int8 activation quantizer flip the
    # odd element lying on a rounding tie by one int8 step, and one flip
    # moves the next layer's inputs by ~1e-3 (measured: up to 1.1e-2 of
    # the logit range at this size). Greedy tokens still agree
    # (test_greedy_tokens_match_w4a8_int8kv).
    _close(got.numpy(), want, rtol=5e-2 if variant == "w4a8" else RTOL)


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("cache_dtype", ["int8", "f32"])
def test_cached_decode_logits_match(kv_heads, cache_dtype):
    jspec, jp, tspec, tp = _pair(kv_heads, -1)
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "f32": (jnp.float32, torch.float32)}[cache_dtype]
    jcache = jc.KVCache.init(jspec, 2, 32, jdt)
    tcache = tc.KVCache.init(tspec, 2, 32, tdt, device="cpu")
    ids = _ids(7, 2, 12)
    # prefill 8 tokens, then 4 single-token steps (the deferred-write path)
    steps = [ids[:, :8]] + [ids[:, i:i + 1] for i in range(8, 12)]
    # an int8 cache rounds k/v per token: as with int8 activations, the
    # odd element on a rounding tie lands one step apart (measured 5e-4
    # of the logit range); the f32 cache holds to RTOL
    rtol = 5e-3 if cache_dtype == "int8" else RTOL
    for chunk in steps:
        want, jcache = jc.model_forward(jspec, jp, jnp.asarray(chunk), jcache)
        got, tcache = tc.model_forward(tspec, tp, torch.from_numpy(chunk),
                                       tcache)
        _close(got.numpy(), want, rtol=rtol)
    assert tcache.length == int(jcache.length) == 12
    tk, jk = tcache.k[:, :, :12].numpy(), np.asarray(jcache.k[:, :, :12])
    if cache_dtype == "int8":
        # one tie landing a step apart in layer 0 moves layer 1's k/v by
        # ~2e-4, so a few of layer 1's rows round differently too
        assert np.mean(tk == jk) >= 0.99
        assert np.abs(tk.astype(int) - jk.astype(int)).max() <= 2
        _close(tcache.k_scale[:, :, :12].numpy(),
               np.asarray(jcache.k_scale[:, :, :12]), rtol=1e-3)
    else:
        _close(tk, jk, rtol=1e-5)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_greedy_tokens_match_w4a8_int8kv(kv_heads):
    jspec, jp, tspec, tp = _pair(kv_heads, 64)
    prompt = _ids(3, 1, 10)
    jeng = jdec.DecodeEngine(jspec, jp, max_len=32, cache_dtype=jnp.int8,
                             a8=True)
    teng = tdec.DecodeEngine(tspec, tp, max_len=32, cache_dtype=torch.int8,
                             a8=True)
    want = jeng.generate(prompt, 16)
    got = teng.generate(prompt, 16)
    np.testing.assert_array_equal(got, want)


def test_sample_token_matches():
    logits = np.random.default_rng(4).normal(size=(3, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tdec.sample_token(torch.from_numpy(logits)).numpy(),
        np.asarray(jdec.sample_token(jnp.asarray(logits), None)))
    # the frameworks draw different random bits: hold the port's samples
    # to the support JAX's top-k filter keeps
    top = np.argsort(-logits, axis=-1)[:, :5]
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tdec.sample_token(torch.from_numpy(logits), gen,
                                temperature=0.7, top_k=5).numpy()
        assert tok.shape == (3,)
        assert all(tok[i] in top[i] for i in range(3))


def test_init_params_matches_jax_layout():
    _, jp, tspec, _ = _pair(2)
    tp = tc.init_params(tspec, seed=3, device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda a: tuple(a.shape), tree)

    assert shapes(tp) == shapes(jp)
    logits, _ = tc.model_forward(tspec, tp, torch.from_numpy(_ids(0, 1, 6)))
    assert logits.shape == (1, 6, 384) and torch.isfinite(logits).all()


def _bf16_embed(jp):
    jp["embed"]["tokens"] = jp["embed"]["tokens"].astype(jnp.bfloat16)
    return jp


def test_checkpoint_jax_to_port(tmp_path):
    jspec, jp, tspec, _ = _pair(2, 64)
    jp = _bf16_embed(jp)
    path = str(tmp_path / "j.npz")
    jio.save_checkpoint(path, jspec, jp)
    spec2, tp, cfg = tio.load_checkpoint(path, device="cpu")
    assert spec2 == tspec and cfg is None
    assert tp["embed"]["tokens"].dtype == torch.bfloat16
    ids = _ids(1, 1, 9)
    want, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    got, _ = tc.model_forward(spec2, tp, torch.from_numpy(ids))
    _close(got.float().numpy(), np.asarray(want, np.float32))


def test_checkpoint_port_to_jax(tmp_path):
    from gptq_tpu_torch.config import QuantConfig

    jspec, jp, tspec, _ = _pair(4, -1)
    jp = _bf16_embed(jp)
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, tspec, tp, QuantConfig(wbits=4))
    spec2, jp2, cfg = jio.load_checkpoint(path)
    assert spec2 == jspec and cfg.wbits == 4
    ids = _ids(2, 1, 9)
    want, _ = jc.model_forward(spec2, jp2, jnp.asarray(ids))
    got, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    _close(got.float().numpy(), np.asarray(want, np.float32))
    for a, b in zip(jax.tree.leaves(jp2["layers"][0]["q"]["w"].words),
                    tp["layers"][0]["q"]["w"].words):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(ROOT, "gptq_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_never_imports_jax_or_gptq_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gptq_tpu|ml_dtypes)"
                     r"(\.|\s|$)", re.M)
    offenders = [p for p in _port_sources() if pat.search(open(p).read())]
    assert not offenders, offenders


def test_every_module_imports_with_jax_blocked():
    mods = []
    pkg = os.path.join(ROOT, "gptq_tpu_torch")
    for p in _port_sources():
        if p.startswith(pkg):
            rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
            mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                        else rel)
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['gptq_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "import chip_smoke\nprint('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, _, tspec, tp = _pair(4, -1)
    path = str(tmp_path / "c.npz")
    tio.save_checkpoint(path, tspec, tp)
    with pytest.raises(RuntimeError, match="cuda"):
        tio.load_checkpoint(path)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        tc.init_params(tspec)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.KVCache.init(tspec, 1, 8)
    from gptq_tpu_torch.quant.gptq import hessian_init

    with pytest.raises(RuntimeError, match="cuda"):
        hessian_init(8)
    from gptq_tpu_torch import cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["dummy", "c4", "--load", path, "--benchmark", "2"])
