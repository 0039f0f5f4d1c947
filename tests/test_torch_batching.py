"""The port's continuous batcher (gptq_tpu_torch.engine.batching) against
gptq_tpu's on the CPU: the tiny SPEC of tests/test_batching.py, the JAX
weights carried across with params_from_jax, the same seeded prompts.
Greedy tokens are equal on f32 caches; on the int8 cache equal, or parted
only at a near tie (NEAR_TIE). Also the JAX batcher's own cases (bar the
dp mesh, which the port refuses), the per-slot write-first block_forward
against JAX's, and model_forward's per-slot decode against one slot at a
time."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu.engine.batching import ContinuousBatcher as JBatcher
from gptq_tpu.models import common as jc
from gptq_tpu_torch.engine.batching import ContinuousBatcher
from gptq_tpu_torch.engine.decode import DecodeEngine
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree

KW = dict(arch="llama", n_layers=2, hidden=32, n_heads=4, n_kv_heads=2,
          ffn=64, vocab=61, max_pos=128, act="silu", pos="rope",
          norm_type="rmsnorm", linear_bias=False, tie_embeddings=False)
JSPEC, TSPEC = jc.ArchSpec(**KW), tc.ArchSpec(**KW)
DT = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
# two decodings part only where the JAX logits of the two tokens lie
# within this share of max |logit| (an int8 cache rounds a k/v element on
# a tie one code apart under the frameworks' ~1e-7 f32 differences)
NEAR_TIE = 1e-3


def _params(seed):
    jp = jc.init_params(JSPEC, jax.random.PRNGKey(seed))
    return jp, params_from_jax(to_numpy_tree(jp), device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 61, size=(n,)) for n in lens]


def _serve(make, prompts, max_new, window=1, **kw):
    cb = make(**kw)
    uids = [cb.submit(p, max_new_tokens=max_new) for p in prompts]
    res = cb.run(window=window)
    assert [r.uid for r in res] == uids
    return [r.output for r in res], cb


def _both(jp, tp, dtype, **kw):
    jdt, tdt = DT[dtype]
    return (lambda **k: JBatcher(JSPEC, jp, cache_dtype=jdt, **{**kw, **k}),
            lambda **k: ContinuousBatcher(TSPEC, tp, cache_dtype=tdt,
                                          **{**kw, **k}))


def _jax_logits(jp, ids):
    logits, _ = jc.model_forward(JSPEC, jp, jnp.asarray(ids)[None])
    return np.asarray(logits[0, -1])


def _agree(jp, prompts, want, got):
    """Equal token lists, or each pair parting first at a near tie of the
    JAX model's logits on the common prefix."""
    for p, w, g in zip(prompts, want, got):
        if w == g:
            continue
        i = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        lg = _jax_logits(jp, np.concatenate([p, np.asarray(w[:i], np.int64)]))
        gap = abs(lg[w[i]] - lg[g[i]]) / np.abs(lg).max()
        assert gap <= NEAR_TIE, (i, w, g, gap)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_matches_jax_batcher(dtype):
    jp, tp = _params(0)
    prompts = _prompts(0, (4, 7, 5, 9, 3, 12, 6))
    mj, mt = _both(jp, tp, dtype, batch_slots=3, max_len=64,
                   prefill_buckets=(4, 8, 16))
    want, _ = _serve(mj, prompts, 6)
    got, _ = _serve(mt, prompts, 6)
    if dtype == "f32":
        assert got == want
    else:
        _agree(jp, prompts, want, got)


def test_matches_sequential():
    jp, tp = _params(0)
    prompts = _prompts(0, (4, 7, 5, 9, 3))
    eng = DecodeEngine(TSPEC, tp, max_len=64, cache_dtype=torch.float32)
    want = [eng.generate(p[None], max_new_tokens=6)[0].tolist()
            for p in prompts]
    _, mt = _both(jp, tp, "f32", batch_slots=2, max_len=64,
                  prefill_buckets=(4, 8, 16))
    got, _ = _serve(mt, prompts, 6)
    assert got == want


def test_int8_cache_close_to_f32():
    jp, tp = _params(2)
    prompts = _prompts(2, (5, 7))
    outs = [_serve(_both(jp, tp, d, batch_slots=2, max_len=64,
                         prefill_buckets=(8, 16))[1], prompts, 5)[0]
            for d in ("f32", "int8")]
    _agree(jp, prompts, *outs)


def test_more_requests_than_slots_all_complete():
    jp, tp = _params(1)
    prompts = _prompts(1, (5,) * 7)
    mj, mt = _both(jp, tp, "f32", batch_slots=3, max_len=64,
                   prefill_buckets=(8,))
    got, _ = _serve(mt, prompts, 4)
    assert len(got) == 7 and all(len(o) == 4 for o in got)
    assert got == _serve(mj, prompts, 4)[0]


def test_one_prefill_dispatch_per_bucket():
    jp, tp = _params(3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 61, size=(5,)) for _ in range(8)]
    mj, mt = _both(jp, tp, "f32", batch_slots=4, max_len=64,
                   prefill_buckets=(8,))
    got, cb = _serve(mt, prompts, 4)
    assert cb.prefill_calls == 2, cb.prefill_calls
    assert got == _serve(mj, prompts, 4)[0]
    # mixed buckets in one wave: one dispatch per bucket
    mixed = [rng.integers(1, 61, size=(n,)) for n in (3, 4, 9, 12)]
    mj, mt = _both(jp, tp, "f32", batch_slots=4, max_len=64,
                   prefill_buckets=(4, 16))
    got, cb = _serve(mt, mixed, 3)
    assert cb.prefill_calls == 2, cb.prefill_calls
    assert got == _serve(mj, mixed, 3)[0]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_window_matches_stepwise(dtype):
    """Mid-window finishes and refills included (max_new 6, window 4)."""
    _, tp = _params(5)
    prompts = _prompts(5, (4, 6, 5, 7, 3))
    _, mt = _both(None, tp, dtype, batch_slots=2, max_len=64,
                  prefill_buckets=(8,))
    assert (_serve(mt, prompts, 6, window=4)[0]
            == _serve(mt, prompts, 6, window=1)[0])


def test_submit_refuses_overlong_request():
    _, tp = _params(4)
    cb = ContinuousBatcher(TSPEC, tp, batch_slots=2, max_len=16,
                           cache_dtype=torch.float32, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="max_len"):
        cb.submit(np.arange(1, 15), max_new_tokens=8)
    cb.submit(np.arange(1, 9), max_new_tokens=4)  # fits: 8 + 4 <= 16


def test_mesh_refused():
    _, tp = _params(4)
    with pytest.raises(NotImplementedError, match="item 18"):
        ContinuousBatcher(TSPEC, tp, batch_slots=2, max_len=16,
                          mesh=object())


@pytest.mark.parametrize("cap,calls,rows", [(None, 1, 4), (2, 2, 2),
                                            (3, 2, 2)])
def test_prefill_group_splits_dispatches(cap, calls, rows, monkeypatch):
    """prefill_group caps the rows of a dispatch; 3 rounds down to 2 (the
    JAX batcher would pad to 3 rows). Outputs equal the uncapped run."""
    jp, tp = _params(9)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 61, size=(5,)) for _ in range(4)]
    mj, mt = _both(jp, tp, "f32", batch_slots=4, max_len=64,
                   prefill_buckets=(8,))
    seen = []
    real = ContinuousBatcher._prefill
    monkeypatch.setattr(ContinuousBatcher, "_prefill",
                        lambda self, ids, c: (seen.append(ids.shape[0]),
                                              real(self, ids, c)))
    got, cb = _serve(mt, prompts, 4, prefill_group=cap)
    assert cb.prefill_calls == calls and set(seen) == {rows}, seen
    assert got == _serve(mj, prompts, 4)[0]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_per_slot_write_first_block_matches_jax(dtype):
    """block_forward write-first at T = 3 with a (B,) cache_len: each row
    writes at its own offset and attends under the caller's mask."""
    jp, tp = _params(7)
    jdt, tdt = DT[dtype]
    B, T, S = 3, 3, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, KW["hidden"])).astype(np.float32)
    lens = np.array([0, 5, 9], np.int32)
    pos = lens[:, None] + np.arange(T)
    mask = np.where(np.arange(S)[None, None] <= pos[:, :, None], 0.0,
                    -1e9).astype(np.float32)[:, None]
    shape = (B, S, JSPEC.kv_heads, JSPEC.hd)
    if dtype == "f32":
        ck = rng.standard_normal(shape).astype(np.float32)
        cv = rng.standard_normal(shape).astype(np.float32)
        planes = [ck, cv]
    else:
        planes = [rng.integers(-127, 128, size=shape).astype(np.int8),
                  rng.integers(-127, 128, size=shape).astype(np.int8),
                  rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32),
                  rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)]
    jout, jkv, _ = jc.block_forward(
        JSPEC, jp["layers"][0], jnp.asarray(x), positions=jnp.asarray(pos),
        mask=jnp.asarray(mask), cache=tuple(jnp.asarray(p) for p in planes),
        cache_len=jnp.asarray(lens))
    tplanes = [torch.from_numpy(p.copy()) for p in planes]
    if dtype == "f32":
        tplanes += [None, None]
    tout, _, _ = tc.block_forward(
        TSPEC, tp["layers"][0], torch.from_numpy(x),
        positions=torch.from_numpy(pos).long(), mask=torch.from_numpy(mask),
        cache=tuple(tplanes), cache_len=torch.from_numpy(lens))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    for tpl, jpl, p in zip(tplanes, jkv, planes):
        jpl = np.asarray(jpl)
        got = tpl.numpy()
        if dtype == "int8" and tpl.dtype == torch.int8:
            assert np.mean(got == jpl) >= 0.999  # a tie a code apart
        else:
            np.testing.assert_allclose(got, jpl, rtol=1e-5, atol=1e-6)
        for b in range(B):  # rows outside [len, len + T) untouched
            keep = np.ones(S, bool)
            keep[lens[b]:lens[b] + T] = False
            np.testing.assert_array_equal(got[b][keep], p[b][keep])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_per_slot_decode_step_equals_one_slot_at_a_time(dtype):
    """model_forward over a (B,) length: each slot's logits and its
    written rows equal a one-slot decode at that slot's scalar length."""
    _, tp = _params(8)
    tdt = DT[dtype][1]
    B, S = 3, 32
    lens = torch.tensor([4, 0, 11], dtype=torch.int32)
    tok = torch.tensor([[5], [17], [33]])
    cache = tc.KVCache.init(TSPEC, B, S, tdt, "cpu")
    g = torch.Generator().manual_seed(8)
    for p in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if p is not None:
            p.copy_(torch.randint(-127, 128, p.shape, generator=g)
                    if p.dtype == torch.int8 else
                    torch.rand(p.shape, generator=g) * 0.02
                    if dtype == "int8" else torch.randn(p.shape, generator=g))
    singles = [tc.KVCache(k=cache.k[:, b:b + 1].clone(),
                          v=cache.v[:, b:b + 1].clone(),
                          length=int(lens[b]),
                          k_scale=None if cache.k_scale is None
                          else cache.k_scale[:, b:b + 1].clone(),
                          v_scale=None if cache.v_scale is None
                          else cache.v_scale[:, b:b + 1].clone())
               for b in range(B)]
    logits, new = tc.model_forward(TSPEC, tp, tok, tc.KVCache(
        k=cache.k, v=cache.v, length=lens, k_scale=cache.k_scale,
        v_scale=cache.v_scale))
    assert torch.equal(new.length, lens + 1)
    for b in range(B):
        want, one = tc.model_forward(TSPEC, tp, tok[b:b + 1], singles[b])
        torch.testing.assert_close(logits[b], want[0], rtol=1e-5, atol=1e-6)
        for a, w in ((cache.k, one.k), (cache.v, one.v),
                     (cache.k_scale, one.k_scale),
                     (cache.v_scale, one.v_scale)):
            if a is None:
                continue
            if a.dtype == torch.int8:  # a code apart at a rounding tie
                d = (a[:, b:b + 1].int() - w.int()).abs()
                assert int(d.max()) <= 1 and float((d > 0).float().mean()) \
                    <= 1e-2, b
            else:  # one row of a batched product against a one-row one
                torch.testing.assert_close(a[:, b:b + 1], w, rtol=1e-5,
                                           atol=1e-6)
