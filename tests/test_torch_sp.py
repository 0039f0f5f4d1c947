"""Sequence-parallel serving of the port (parallel/sp.py, engine/
serving.py, cli --sp) and the partial-attention plain versions against
gptq_tpu on the CPU.

The partial plain versions meet the JAX Pallas kernels in interpret mode
and the jnp body of gptq_tpu's _sp_partial. The ring prefill and the
SPCache decode run at sp = 1 in this process on a one-rank gloo group,
and at sp = 2 in two gloo processes (tests/torch_sp_worker.py) against
the JAX package's sp = 2 on the 8-device CPU mesh."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

from gptq_tpu.engine import serving as jserve
from gptq_tpu.models import common as jc
from gptq_tpu.ops import attention as ja
from gptq_tpu.parallel import sp as jsp
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.ops import attention as ta
from gptq_tpu_torch.parallel import sp as tsp
from gptq_tpu_torch.weights import (params_from_jax, sp_cache_from_jax,
                                    to_numpy_tree)
from test_torch_model import _close, _pack_jax
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_sp.py's sizes (3 layers, GQA 4 / 2, head dim 12)
KW = dict(arch="llama", n_layers=3, hidden=48, n_heads=4, n_kv_heads=2,
          ffn=96, vocab=89, max_pos=64, norm_eps=1e-5, act="silu",
          pos="rope", norm_type="rmsnorm", linear_bias=False,
          tie_embeddings=False)
JSPEC, TSPEC = jc.ArchSpec(**KW), tc.ArchSpec(**KW)
# the packed model of the sp = 2 run: widths that pack in 4-bit words
PKW = {**KW, "n_layers": 2, "hidden": 64, "ffn": 128, "vocab": 96}
F32_TOL = 2e-4  # f32 cache logits (tests/test_sp.py:197)
INT8_RTOL = 5e-3  # int8 cache, relative to max |logit| (test_torch_model)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo process group in this process (sp = 1)."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", world_size=1, rank=0,
                                init_method=f"tcp://localhost:{_free_port()}")
    yield None
    if own:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the partial-attention plain versions
# ---------------------------------------------------------------------------

def _partial_case(seed, kind, B, S, H, Hkv, hd, L=None, valid="sparse"):
    """Seeded inputs: q, k, v, scales (int8), pos (`sparse`: valid slots
    that are not contiguous; `full`; `empty`: no valid slot), slopes."""
    rng = np.random.default_rng(seed)
    lead = (L, B) if L else (B,)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    ks = vs = None
    if kind == "int8":
        k = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        ks = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
        v = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
    pos = np.full((S,), -1, np.int32)
    if valid == "sparse":  # half the slots hold positions, with holes
        pos[:S // 2] = 2 * np.arange(S // 2) + 1
        pos[:S // 2:3] = -1
    elif valid == "full":
        pos[:] = np.arange(S)
    slopes = np.asarray(jc.alibi_slopes(H))
    return q, k, v, ks, vs, pos, slopes


def _to_jax(a, kind):
    if a is None:
        return None
    if kind == "bf16" and a.dtype == np.float32 and a.ndim >= 4:
        return jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(a)


def _to_torch(a, kind):
    if a is None:
        return None
    t = torch.from_numpy(a)
    if kind == "bf16" and a.dtype == np.float32 and a.ndim >= 4:
        return t.to(torch.bfloat16)
    return t


def _check_state(got, want, tol):
    """(m, l, acc) against (m, l, acc): m only where l > 0."""
    gm, gl, ga = (np.asarray(x, np.float64) for x in got)
    wm, wl, wa = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_allclose(gl, wl, rtol=tol, atol=tol)
    np.testing.assert_allclose(ga, wa, rtol=tol, atol=tol)
    live = wl > 0
    np.testing.assert_allclose(gm[live], wm[live], rtol=tol, atol=tol)
    assert (gm[~live] == -np.inf).all()  # the port's empty-shard m


# (entry, cache, B, S, H, Hkv, hd, layers, slopes, valid)
CASES = [
    ("narrow", "int8", 2, 32, 4, 4, 64, None, False, "sparse"),
    ("narrow", "bf16", 1, 64, 4, 2, 64, 2, False, "sparse"),
    ("narrow", "f32", 1, 32, 4, 4, 64, None, True, "full"),
    ("narrow", "int8", 1, 32, 8, 2, 64, None, False, "empty"),
    ("wide", "int8", 1, 32, 4, 2, 128, 2, True, "sparse"),
    ("wide", "bf16", 2, 32, 2, 2, 128, None, False, "full"),
    ("wide", "f32", 1, 64, 8, 2, 128, 2, False, "sparse"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_partial_plain_versions_match_jax(case, monkeypatch):
    entry, kind, B, S, H, Hkv, hd, L, use_slopes, valid = case
    q, k, v, ks, vs, pos, slopes = _partial_case(7, kind, B, S, H, Hkv, hd,
                                                 L, valid)
    slopes = slopes if use_slopes else None
    layer = 1 if L else None
    sm = 1.0 / np.sqrt(hd)
    tfn = (ta.decode_attention_partial_wide if entry == "wide"
           else ta.decode_attention_partial)
    tt = {n: _to_torch(a, kind) for n, a in
          dict(q=q, k=k, v=v, ks=ks, vs=vs, pos=pos, slopes=slopes).items()}
    got = tfn(tt["q"], tt["k"], tt["v"], tt["pos"], sm, k_scale=tt["ks"],
              v_scale=tt["vs"], slopes=tt["slopes"], layer=layer)
    jj = {n: _to_jax(a, kind) for n, a in
          dict(q=q, k=k, v=v, ks=ks, vs=vs, pos=pos, slopes=slopes).items()}
    if entry == "wide":
        # the wide Pallas kernel rounds k, v, q * scale and p to bf16
        # (the tolerance of tests/test_sp.py:535)
        want = ja.decode_attention_partial_wide(
            jj["q"], jj["k"], jj["v"], jj["pos"], float(sm),
            k_scale=jj["ks"], v_scale=jj["vs"], slopes=jj["slopes"],
            layer=layer, interpret=True)
        _check_state(got, want, 2e-2)
    else:
        sel = (lambda a: a) if L is None else (lambda a: None if a is None
                                               else a[layer])
        want = ja.decode_attention_partial(
            jj["q"], sel(jj["k"]), sel(jj["v"]), jj["pos"], float(sm),
            k_scale=sel(jj["ks"]), v_scale=sel(jj["vs"]),
            slopes=jj["slopes"], interpret=True)
        _check_state(got, want, 1e-5)
    # the jnp body of _sp_partial (the JAX package's CPU path), exact f32
    monkeypatch.setenv("GPTQ_TPU_ATTN_IMPL", "xla")
    stack = (lambda a: a) if L else (lambda a: None if a is None else a[None])
    spec = jc.ArchSpec(arch="llama", n_layers=1, hidden=H * hd, n_heads=H,
                       n_kv_heads=Hkv, ffn=8, vocab=8, max_pos=S,
                       qk_scale=float(sm))
    oracle = jsp._sp_partial(spec, jj["q"][:, None], stack(jj["k"]),
                             stack(jj["v"]), stack(jj["ks"]), stack(jj["vs"]),
                             jj["pos"], jj["slopes"], layer or 0)
    _check_state(got, oracle, 1e-5)


def test_partial_narrow_refuses_slopes_with_gqa():
    q, k, v, _, _, pos, slopes = _partial_case(1, "f32", 1, 16, 4, 2, 64)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pos), 0.125)
    with pytest.raises(ValueError, match="G=1"):
        ta.decode_attention_partial(*args, slopes=torch.from_numpy(slopes))
    with pytest.raises(ValueError, match="G=1"):
        ja.decode_attention_partial(*(jnp.asarray(a) for a in args[:4]),
                                    0.125, slopes=jnp.asarray(slopes))
    m, l, acc = ta.decode_attention_partial_wide(
        *args, slopes=torch.from_numpy(slopes))  # the wide entry takes them
    assert m.shape == l.shape == (1, 4) and acc.shape == (1, 4, 64)


def _merge(states):
    """Online-softmax states (m, l, acc) merged in order, weight exp(m_s -
    M) (0 where M = -inf)."""
    M = torch.stack([st[0] for st in states]).amax(dim=0)
    w = [torch.where(M == float("-inf"), torch.zeros_like(M),
                     torch.exp(st[0] - M)) for st in states]
    return (M, sum(wi * st[1] for wi, st in zip(w, states)),
            sum(wi[..., None] * st[2] for wi, st in zip(w, states)))


def partial_tiles(q, k, v, pos, sm, ks=None, vs=None, slopes=None,
                  nsplit=1):
    """csrc/attention_partial.cu's algorithm in torch (f32): split j of a
    (batch row, kv head) lists the valid slots of the 32-slot shard tiles
    j, j + nsplit, ... in slot order and walks them in compute tiles of N
    slots (32 / 64 / 128: K and V rows within 36 KB); in each tile the
    slots fall into 16 / gp runs (gp: G up to a power of two), each run
    keeping its own online state per head (a whole-row dot per slot, one
    max and one sum a tile); the runs' states merge into the split's, the
    splits' states into the output."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    gp = 1 << (G - 1).bit_length()
    nsub = 16 // gp
    rs = hd * k.element_size() + 16
    fit = 36 * 1024 // (2 * rs)
    N = 128 if fit >= 128 else 64 if fit >= 64 else 32
    T = ta.PARTIAL_TILE
    kf, vf = k.float(), v.float()
    m_out = torch.empty((B, H))
    l_out = torch.empty((B, H))
    acc_out = torch.empty((B, H, hd))
    for b in range(B):
        for h in range(Hkv):
            qs = q[b, h * G:(h + 1) * G].float() * sm  # (G, hd)
            sl = (slopes[h * G:(h + 1) * G].float() if slopes is not None
                  else torch.zeros(G))
            splits = []
            for j in range(nsplit):
                slots = [t for a in range(j, -(-S // T), nsplit)
                         for t in range(a * T, min(S, a * T + T))
                         if pos[t] >= 0]
                runs = [(torch.full((G,), float("-inf")), torch.zeros(G),
                         torch.zeros((G, hd))) for _ in range(nsub)]
                for u in range(0, len(slots), N):
                    tile = slots[u:u + N]
                    run = -(-len(tile) // nsub)
                    for r in range(nsub):
                        mine = tile[r * run:(r + 1) * run]
                        if not mine:
                            continue
                        idx = torch.tensor(mine)
                        s = qs @ kf[b, idx, h].T  # (G, n): a row a slot
                        if ks is not None:
                            s = s * ks[b, idx, h]
                        s = s + sl[:, None] * pos[idx].float()
                        m, l, acc = runs[r]
                        m_new = torch.maximum(m, s.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        pv = p * (vs[b, idx, h] if vs is not None else 1.0)
                        runs[r] = (m_new, l * alpha + p.sum(dim=1),
                                   acc * alpha[:, None] + pv @ vf[b, idx, h])
                splits.append(_merge(runs))
            M, L, A = _merge(splits)
            sel = slice(h * G, (h + 1) * G)
            m_out[b, sel], l_out[b, sel], acc_out[b, sel] = M, L, A
    return m_out, l_out, acc_out


# (entry, cache, S, H, Hkv, hd, slopes, valid, nsplit): G = 1, 4, 8;
# `sparse` leaves whole tiles empty, `empty` the whole shard
TILE_CASES = [
    ("narrow", "int8", 200, 4, 4, 64, True, "sparse", 3),
    ("narrow", "bf16", 96, 8, 1, 64, False, "full", 2),
    ("narrow", "f32", 64, 4, 4, 128, False, "empty", 2),
    ("wide", "int8", 160, 8, 2, 128, True, "sparse", 4),
    ("wide", "f32", 96, 8, 1, 128, False, "sparse", 1),
    ("wide", "bf16", 128, 4, 1, 64, True, "full", 3),
]


@pytest.mark.parametrize("case", TILE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_partial_tile_algorithm_matches_jax(case):
    entry, kind, S, H, Hkv, hd, use_slopes, valid, nsplit = case
    q, k, v, ks, vs, pos, slopes = _partial_case(5, kind, 1, S, H, Hkv, hd,
                                                 valid=valid)
    if valid == "sparse":  # and a whole empty tile in the front half
        pos[32:64] = -1
    slopes = slopes if use_slopes else None
    sm = 1.0 / np.sqrt(hd)
    tt = {n: _to_torch(a, kind) for n, a in
          dict(q=q, k=k, v=v, ks=ks, vs=vs, pos=pos, slopes=slopes).items()}
    got = partial_tiles(tt["q"], tt["k"], tt["v"], tt["pos"], sm,
                        tt["ks"], tt["vs"], tt["slopes"], nsplit)
    jj = {n: _to_jax(a, kind) for n, a in
          dict(q=q, k=k, v=v, ks=ks, vs=vs, pos=pos, slopes=slopes).items()}
    if entry == "wide":  # the wide Pallas kernel rounds to bf16
        want = ja.decode_attention_partial_wide(
            jj["q"], jj["k"], jj["v"], jj["pos"], float(sm), k_scale=jj["ks"],
            v_scale=jj["vs"], slopes=jj["slopes"], interpret=True)
        _check_state(got, want, 2e-2)
    else:
        want = ja.decode_attention_partial(
            jj["q"], jj["k"], jj["v"], jj["pos"], float(sm), k_scale=jj["ks"],
            v_scale=jj["vs"], slopes=jj["slopes"], interpret=True)
        _check_state(got, want, 1e-5)
    # and the plain version the card's kernel is held to
    _check_state(got, ta.decode_attention_partial_wide_reference(
        tt["q"], tt["k"], tt["v"], tt["pos"], sm, k_scale=tt["ks"],
        v_scale=tt["vs"], slopes=tt["slopes"]), 1e-5)


@pytest.mark.parametrize("B,Hkv,G,S,sms,grid", [
    (1, 32, 1, 2048, 132, (1, 5)),  # llama-7B: a block an SM
    (1, 4, 8, 2048, 132, (2, 8)),   # TinyLlama: a cluster of 8, 4 head groups
    (1, 8, 4, 2048, 132, (2, 8)),   # Mixtral GQA 4
    (1, 1, 1, 64, 132, (1, 2)),     # a short shard: a split a tile
    (4, 32, 1, 8192, 132, (1, 2)),
    (8, 32, 4, 2048, 132, (4, 1)),  # 256 (row, kv head) blocks: no split
])
def test_partial_grid(B, Hkv, G, S, sms, grid):
    gh, nsplit = ta.partial_grid(B, Hkv, G, S, sms)
    assert (gh, nsplit) == grid and G % gh == 0 and 1 <= nsplit <= 8


# ---------------------------------------------------------------------------
# sp = 1 in this process
# ---------------------------------------------------------------------------

def _dense_pair(seed):
    jp = jc.init_params(JSPEC, jax.random.PRNGKey(seed))
    return jp, params_from_jax(to_numpy_tree(jp), device="cpu")


def test_sp1_gathering_prefill_matches_jax(group):
    jp, tp = _dense_pair(1)
    ids = np.random.default_rng(0).integers(0, KW["vocab"], size=(2, 16))
    jpre, _ = jsp.make_sp_prefill(JSPEC, jp, jsp.make_sp_mesh(1),
                                  cache_dtype=jnp.float32, max_len=24)
    want, jcache = jpre(jnp.asarray(ids))
    tpre = tsp.make_sp_prefill(TSPEC, tp, cache_dtype=torch.float32,
                               max_len=24, device="cpu")
    got, tcache = tpre(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    assert tcache.length == int(jcache.length) == 16
    assert tcache.k.shape == jcache.k.shape == (3, 2, 24, 2, 12)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_sp1_cache_decode_matches_jax(group, cache):
    """Ring prefill + SPCache decode at sp = 1 against gptq_tpu's, step
    for step; the int8 cache holds the int8-KV rule of
    tests/test_torch_model.py."""
    int8 = cache == "int8"
    jdt, tdt = ((jnp.int8, torch.int8) if int8
                else (jnp.float32, torch.float32))
    jp, tp = _dense_pair(11)
    ids = np.random.default_rng(12).integers(0, KW["vocab"], size=(2, 8))
    mesh = jsp.make_sp_mesh(1)
    jl, jcache = jsp.make_sp_cache_prefill(JSPEC, jp, mesh, cache_dtype=jdt,
                                           max_len=16)(jnp.asarray(ids))
    tl, tcache = tsp.make_sp_cache_prefill(TSPEC, tp, cache_dtype=tdt,
                                           max_len=16,
                                           device="cpu")(torch.from_numpy(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)  # prefill is unquantized
    assert tcache.meta == jcache.meta == (8, 16)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    jstep = jsp.make_sp_decode_step(JSPEC, jp, mesh, jcache.meta,
                                    int8_cache=int8)
    tstep = tsp.make_sp_decode_step(TSPEC, tp, tcache.meta, int8_cache=int8)
    for t in (3, 7, 11, 2, 5):
        want, jcache = jstep(jcache, jnp.asarray([[t], [t]]))
        got, tcache = tstep(tcache, torch.tensor([[t], [t]]))
        if int8:
            _close(got.numpy(), want, rtol=INT8_RTOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=F32_TOL, atol=F32_TOL)
    assert tcache.length == int(jcache.length) == 13
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    # the decode guards: a mismatched cache flag, a full cache
    with pytest.raises(ValueError, match="int8_cache"):
        tsp.make_sp_decode_step(TSPEC, tp, tcache.meta,
                                int8_cache=not int8)(tcache, torch.tensor([[1], [1]]))
    full = tsp.SPCache(**{**tcache.__dict__, "length": 16})
    with pytest.raises(ValueError, match="SPCache full"):
        tstep(full, torch.tensor([[1], [1]]))


def test_decode_continues_from_jax_prefill_cache(group):
    """sp_cache_from_jax: the port's decode starts from the JAX package's
    prefill cache and matches its next logits."""
    jp, tp = _dense_pair(3)
    ids = np.random.default_rng(4).integers(0, KW["vocab"], size=(1, 8))
    mesh = jsp.make_sp_mesh(1)
    _, jcache = jsp.make_sp_cache_prefill(JSPEC, jp, mesh,
                                          cache_dtype=jnp.float32,
                                          max_len=12)(jnp.asarray(ids))
    tcache = sp_cache_from_jax(to_numpy_tree(jcache), rank=0, device="cpu")
    assert tcache.meta == (8, 12) and tcache.length == 8
    jstep = jsp.make_sp_decode_step(JSPEC, jp, mesh, jcache.meta)
    tstep = tsp.make_sp_decode_step(TSPEC, tp, tcache.meta)
    for t in (5, 9):
        want, jcache = jstep(jcache, jnp.asarray([[t]]))
        got, tcache = tstep(tcache, torch.tensor([[t]]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_spengine_sp1_generate_and_benchmark(group):
    """SPEngine at sp = 1: generate's chained chunks equal step-by-step
    greedy decoding, and benchmark_chained reports the JAX keys."""
    from gptq_tpu_torch.engine.serving import SPEngine

    _, tp = _dense_pair(5)
    eng = SPEngine(TSPEC, tp, sp=1, max_len=32, device="cpu")
    assert eng.max_len == 128 and eng.cache_dtype == torch.bfloat16
    prompt = np.random.default_rng(6).integers(0, KW["vocab"], size=(1, 7))
    got = eng.generate(prompt, 9, chunk=4)
    logits, cache = eng.prefill(torch.from_numpy(prompt))
    want = []
    for _ in range(9):
        tok = logits.argmax(-1)[:, None]
        want.append(int(tok))
        logits, cache = eng.step(cache, tok)
    assert got.tolist() == [want]
    r = eng.benchmark_chained(prompt.reshape(-1)[:6], check=True,
                              warmup=1, reps=1, log=lambda s: None)
    assert {"per_token_s", "tokens_per_s", "full_run_s", "half_run_s",
            "n_tokens", "below_noise_floor", "sp", "tp", "cache_dtype",
            "max_len", "ppl"} <= set(r)
    assert r["n_tokens"] == 4 and r["sp"] == 1 and np.isfinite(r["ppl"])
    with pytest.raises(NotImplementedError, match="item 18"):
        SPEngine(TSPEC, tp, sp=1, tp=2, device="cpu")
    with pytest.raises(ValueError, match="sp=2"):
        SPEngine(TSPEC, tp, sp=2, device="cpu")


def _eager_ppl(eng, ids) -> float:
    """benchmark_chained's PPL step by step: the first sp ids prefill, each
    later id feeds one guarded step, whose NLL of the next id counts."""
    logits, cache = eng.prefill(torch.from_numpy(ids[None, :eng.sp]))
    nll = []
    for i in range(eng.sp, len(ids) - 1):
        logits, cache = eng.step(cache, torch.tensor([[int(ids[i])]]))
        lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
        nll.append(-float(lp[int(ids[i + 1])]))
    return float(np.exp(np.mean(nll)))


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_spengine_one_cache_and_repeated_benchmarks(group, cache_dtype):
    """The engine's prefill fills its one cache for the batch in place,
    equal to a fresh cache from make_sp_cache_prefill (a shorter prompt
    after a longer one leaves zeros past its chunk), and a second
    benchmark_chained on other ids reports their own PPL."""
    from gptq_tpu_torch.engine.serving import SPEngine

    _, tp = _dense_pair(7)
    eng = SPEngine(TSPEC, tp, sp=1, max_len=32, cache_dtype=cache_dtype,
                   device="cpu")
    fresh = tsp.make_sp_cache_prefill(TSPEC, eng.params,
                                      cache_dtype=cache_dtype,
                                      max_len=eng.max_len, device="cpu")
    rng = np.random.default_rng(8)
    first = None
    for T in (12, 5):
        ids = torch.from_numpy(rng.integers(0, KW["vocab"], size=(1, T)))
        logits, cache = eng.prefill(ids)
        want_logits, want = fresh(ids)
        first = cache if first is None else first
        assert cache.k is first.k and cache.pos is first.pos
        assert cache.meta == want.meta and cache.length == want.length == T
        torch.testing.assert_close(logits, want_logits[:, -1], rtol=0, atol=0)
        for a, b in ((cache.k, want.k), (cache.v, want.v),
                     (cache.pos, want.pos), (cache.k_scale, want.k_scale),
                     (cache.v_scale, want.v_scale)):
            assert a is None and b is None or torch.equal(a, b)
    for seed in (9, 10):
        ids = np.random.default_rng(seed).integers(0, KW["vocab"], size=14)
        r = eng.benchmark_chained(ids, check=True, warmup=1, reps=1,
                                  log=lambda s: None)
        np.testing.assert_allclose(r["ppl"], _eager_ppl(eng, ids), rtol=1e-5)


# ---------------------------------------------------------------------------
# sp = 2: two gloo processes against the JAX package's sp = 2
# ---------------------------------------------------------------------------

def test_sp2_two_processes_match_jax(tmp_path):
    """Two port processes on a gloo group: the ring prefill and SPCache
    decode over 5 > 2 * sp steps (the round-robin append wraps both
    ranks), decode from the JAX package's sp = 2 prefill cache,
    SPEngine.generate on packed fused a8 weights, and the CLI's --sp 2;
    against gptq_tpu at sp = 2 on the CPU mesh."""
    jp, tp = _dense_pair(11)
    pspec = jc.ArchSpec(**PKW)
    jpk = _pack_jax(jc.init_params(pspec, jax.random.PRNGKey(2)), -1)
    dense_path, packed_path = str(tmp_path / "d.npz"), str(tmp_path / "p.npz")
    tio.save_checkpoint(dense_path, TSPEC, tp)
    tio.save_checkpoint(packed_path, tc.ArchSpec(**PKW),
                        params_from_jax(to_numpy_tree(jpk), device="cpu"))
    rng = np.random.default_rng(12)
    ids = rng.integers(0, KW["vocab"], size=(2, 8))
    toks = [3, 7, 11, 2, 5]
    prompt = rng.integers(0, PKW["vocab"], size=(1, 9))  # ragged at sp = 2
    mesh = jsp.make_sp_mesh(2)
    want_pre, jcache = jsp.make_sp_cache_prefill(
        JSPEC, jp, mesh, cache_dtype=jnp.float32, max_len=16)(jnp.asarray(ids))
    np.savez(str(tmp_path / "in.npz"), ids=ids, toks=np.asarray(toks),
             prompt=prompt,
             **{f"jcache_{k}": v for k, v in to_numpy_tree(jcache).items()
                if k in ("k", "v", "pos", "length", "meta")})

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    env.update(WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    worker = os.path.join(os.path.dirname(__file__), "torch_sp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(tmp_path), dense_path,
         packed_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in range(2)]

    # the JAX package's side while the workers run
    jstep = jsp.make_sp_decode_step(JSPEC, jp, mesh, jcache.meta)
    wants, carry = [], []
    for t in toks:
        w, jcache = jstep(jcache, jnp.asarray([[t], [t]]))
        wants.append(np.asarray(w))
    jeng = jserve.SPEngine(pspec, jpk, sp=2, max_len=32, fuse=True, a8=True)
    want_gen = np.asarray(jeng.generate(prompt, 8, chunk=4))

    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert "SP_OK" in out, out[-2000:]
    for r in range(2):
        got = np.load(str(tmp_path / f"out{r}.npz"))
        np.testing.assert_allclose(got["prefill"], np.asarray(want_pre),
                                   rtol=F32_TOL, atol=F32_TOL)
        for g, w in zip(got["steps"], wants):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got["carry"], wants[0], rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_array_equal(got["generate"], want_gen)
    # the CLI: rank 0 prints the result line, rank 1 none
    lines = [[ln for ln in out.splitlines() if ln.startswith('{"benchmark"')]
             for out in outs]
    assert len(lines[0]) == 1 and not lines[1]
    res = json.loads(lines[0][0])
    assert res["protocol"] == "chained-sp2" and res["device"] == "cpu"
    assert res["benchmark"]["sp"] == 2 and res["benchmark"]["n_tokens"] == 13


def test_cli_sp_guards(tmp_path, monkeypatch):
    """--sp N needs WORLD_SIZE = N (torchrun --nproc-per-node N); --sp
    with --ep keeps the JAX CLI's refusal; --sp with --tp > 1 (sp x tp)
    is not ported."""
    from gptq_tpu_torch import cli

    base = ["dummy", "c4", "--load", str(tmp_path / "none.npz"),
            "--benchmark", "8", "--device", "cpu"]
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="WORLD_SIZE is 1"):
        cli.main(base + ["--sp", "2"])
    with pytest.raises(SystemExit, match="pick one"):
        cli.main(base + ["--sp", "2", "--ep", "2"])
    with pytest.raises(SystemExit, match="sp x tp serving is not ported"):
        cli.main(base + ["--sp", "2", "--tp", "2"])
