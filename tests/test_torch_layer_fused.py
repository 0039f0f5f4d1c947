"""Parity of gptq_tpu_torch.ops.layer_fused with gptq_tpu.ops.layer_fused
on the CPU: the plain whole-layer version against the JAX Pallas kernel
in interpret mode, the gates (layer_fusable, _layer_fusion_ok) against
the JAX gates on the same weights, and whole-model decode on the layer
route (GPTQ_TPU_LAYER_FUSION on in the port, interpret in JAX). The CUDA
kernel is held to the plain version in test_torch_cuda.py.

Tolerances: y within 1e-4 x max|y| (a16) and 1e-3 (a8), with the near-tie
rule of test_torch_ffn._check (the layer rounds to bf16 / int8 at the
same points as the fused kernels, and the fresh rows to the cache dtype).
The cache rows other than slot `length` stay bit for bit; the written row
is bit-exact with JAX's in a bf16 cache, where both round the same f32
value, and within 1e-5 of its max in an f32 cache, where the q|k|v
product's f32 sums run in another order and no rounding point follows."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu.models import common as jc
from gptq_tpu.ops import layer_fused as jl
from gptq_tpu.ops import pack as jpack
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.ops import layer_fused as tl
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from test_torch_bcq_matmul import _pair as bcq_pair
from test_torch_ffn import _check, fused_pair, packed_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

HIDDEN, H, FFN = 256, 4, 512
HD = HIDDEN // H


class _Splits:
    def __init__(self, parts):
        self.parts = parts


def _layer(rng, Hkv, bits=4, groupsize=-1):
    """One layer's four weights in both packages: {name: (jax, port)}."""
    kvw = Hkv * HD
    parts = [packed_pair(rng, HIDDEN, n, bits, groupsize)
             for n in (HIDDEN, kvw, kvw)]
    return {"qkv": (jpack.fuse_packed([j for j, _ in parts]),
                    tpack.fuse_packed([t for _, t in parts])),
            "o": packed_pair(rng, HIDDEN, HIDDEN, bits, groupsize),
            "gu": fused_pair(rng, HIDDEN, FFN, bits, groupsize),
            "dn": packed_pair(rng, FFN, HIDDEN, bits, groupsize)}


@pytest.mark.parametrize("cache", ["bf16", "f32"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("a8", [False, True])
def test_plain_matches_jax_kernel(a8, G, cache, monkeypatch):
    S, length = 32, 5
    Hkv = H // G
    rng = np.random.default_rng(10 * G + a8 + 3 * (cache == "f32"))
    L = _layer(rng, Hkv)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cache == "bf16"
                else (jnp.float32, torch.float32))
    x = (rng.normal(size=(1, 1, HIDDEN)) * 0.5).astype(np.float32)
    kv = rng.normal(size=(2, 1, S, Hkv, HD)).astype(np.float32)
    kv[:, :, length + 1:] = 37.0  # slots past the write must not count
    w1, w2 = ((rng.random(HIDDEN) + 0.5).astype(np.float32) for _ in range(2))

    class _Spec:
        rope_theta = 10000.0
        hd = HD

    cos, sin = (np.array(t) for t in
                jc.rope_tables(_Spec, jnp.asarray([[length]])))
    kw = dict(n_heads=H, n_kv_heads=Hkv, sm_scale=HD ** -0.5, a8=a8)
    jy, jk, jv = jl.decode_layer_fused(
        jnp.asarray(x), jnp.asarray(kv[0], jdt), jnp.asarray(kv[1], jdt),
        jnp.asarray(length), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(w1), jnp.asarray(w2), *(L[n][0] for n in L),
        interpret=True, **kw)
    want_cache = [np.asarray(c.astype(jnp.float32)) for c in (jk, jv)]
    tk, tv = (torch.from_numpy(c).to(tdt) for c in kv)
    before = [tk.clone(), tv.clone()]

    def port():
        return tl.decode_layer_fused(
            torch.from_numpy(x), tk, tv, torch.tensor(length, dtype=torch.int32),
            torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(w1),
            torch.from_numpy(w2), *(L[n][1] for n in L), **kw).numpy()

    launches = tl.launches
    assert port().shape == (1, 1, HIDDEN)
    assert tl.launches == launches  # a CPU tensor runs the plain version
    for got, old, want in zip((tk, tv), before, want_cache):
        rest = torch.ones(S, dtype=torch.bool)
        rest[length] = False
        assert torch.equal(got[:, rest], old[:, rest])
        row, wrow = got[0, length].float().numpy(), want[0, length]
        if cache == "bf16":
            np.testing.assert_array_equal(row, wrow)
        else:
            assert np.abs(row - wrow).max() <= 1e-5 * np.abs(wrow).max()
    _check(port, np.asarray(jy), a8, monkeypatch)


def _gate_layers(rng):
    """(name, jax layer, port layer, Hkv, hd): weights that pass or fail
    each rule of layer_fusable."""
    out = []
    for name, Hkv in (("mha", 4), ("gqa", 2)):
        L = _layer(rng, Hkv)
        out.append((name, L, Hkv, HD))
    L = _layer(rng, 4, groupsize=128)
    out.append(("g128", L, 4, HD))
    L = _layer(rng, 4, groupsize=64)  # groups under 128 rows stream badly
    out.append(("g64", L, 4, HD))
    L = _layer(rng, 4)
    L["o"] = packed_pair(rng, HIDDEN, HIDDEN, 4, 128, perm=True)  # act-order
    out.append(("act-order o", L, 4, HD))
    L = _layer(rng, 4)
    L["dn"] = packed_pair(rng, FFN, HIDDEN, 4, -1, bias=True)  # baked bias
    out.append(("bias", L, 4, HD))
    L = _layer(rng, 4)
    L["o"] = bcq_pair(rng, HIDDEN, HIDDEN, -1, 3)  # BCQ keeps its kernel
    out.append(("bcq o", L, 4, HD))
    return out


def test_layer_fusable_decides_as_jax():
    rng = np.random.default_rng(3)
    seen = set()
    for name, L, Hkv, hd in _gate_layers(rng):
        kvw = Hkv * hd
        for splits in (((HIDDEN, HIDDEN), (kvw, kvw), (kvw, kvw)),
                       ((HIDDEN + 128, HIDDEN), (kvw, kvw), (kvw, kvw)),
                       ((HIDDEN, HIDDEN), (kvw, kvw), (kvw, kvw - 64))):
            for heads, hdim in ((H, None), (H, hd), (8, 33)):  # odd hd
                args = (_Splits(splits),)
                want = jl.layer_fusable(L["qkv"][0], *args, L["o"][0],
                                        L["gu"][0], L["dn"][0], HIDDEN, heads,
                                        Hkv, head_dim=hdim)
                got = tl.layer_fusable(L["qkv"][1], *args, L["o"][1],
                                       L["gu"][1], L["dn"][1], HIDDEN, heads,
                                       Hkv, head_dim=hdim)
                assert got == want, (name, splits, heads, hdim)
                seen.add(got)
    assert seen == {True, False}


def _spec(n_layers, **kw):
    base = dict(arch="llama", n_layers=n_layers, hidden=HIDDEN, n_heads=H,
                n_kv_heads=2, ffn=FFN, vocab=96, max_pos=64, act="silu",
                pos="rope", norm_type="rmsnorm", linear_bias=False)
    base.update(kw)
    return jc.ArchSpec(**base), tc.ArchSpec(**base)


@pytest.fixture
def layer_route(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", mode)

    set_mode("interpret")
    return set_mode


def _served_layer(pkg, L, i, Hkv, a8):
    """L's weights (package i: 0 JAX, 1 port) as fuse_serving leaves a
    llama layer: q|k|v and gate|up fused, every entry marked a8 or not."""
    ones = jnp.ones if pkg is jc else torch.ones
    kvw = Hkv * HD
    p = {"ln1": {"w": ones(HIDDEN)}, "ln2": {"w": ones(HIDDEN)},
         "qkv_fused": {"w": L["qkv"][i], "b_parts": [None] * 3,
                       "splits": pkg.FusedSplits(((HIDDEN, HIDDEN),
                                                  (kvw, kvw), (kvw, kvw)))},
         "o": {"w": L["o"][i], "b": None},
         "gateup_fused": {"w": L["gu"][i], "b_parts": [None] * 2,
                          "splits": pkg.FusedSplits(((FFN, FFN), (FFN, FFN)))},
         "down": {"w": L["dn"][i], "b": None}}
    spec = _spec(1, n_kv_heads=Hkv)[i]
    return spec, pkg.fuse_serving(spec, {"layers": [p]}, a8=a8)["layers"][0]


def test_layer_fusion_ok_decides_as_jax(layer_route):
    rng = np.random.default_rng(5)
    seen = []
    for name, L, Hkv, _ in _gate_layers(rng):
        for a8 in (True, False):
            js, jlp = _served_layer(jc, L, 0, Hkv, a8)
            ts, tlp = _served_layer(tc, L, 1, Hkv, a8)
            for B, T, cdt, length in ((1, 1, "bf16", 3), (1, 1, "f32", 0),
                                      (2, 1, "bf16", 3), (1, 2, "bf16", 3),
                                      (1, 1, "int8", 3), (1, 1, "bf16", None)):
                jdt = getattr(jnp, {"bf16": "bfloat16", "f32": "float32",
                                    "int8": "int8"}[cdt])
                tdt = getattr(torch, {"bf16": "bfloat16", "f32": "float32",
                                      "int8": "int8"}[cdt])
                sc = cdt == "int8"
                jcache = ((jnp.zeros((B, 8, Hkv, HD), jdt),) * 2
                          + ((jnp.zeros((B, 8, Hkv)),) * 2 if sc
                             else (None, None)))
                tcache = ((torch.zeros((B, 8, Hkv, HD), dtype=tdt),) * 2
                          + ((torch.zeros((B, 8, Hkv)),) * 2 if sc
                             else (None, None)))
                want = jc._layer_fusion_ok(
                    js, jlp, None, None, B, T, jcache,
                    None if length is None else jnp.asarray(length))
                got = tc._layer_fusion_ok(
                    ts, tlp, None, B, T, tcache,
                    None if length is None else torch.tensor(length))
                assert got == want, (name, a8, B, T, cdt, length)
                seen.append(got)
            bf16 = (torch.zeros((1, 8, Hkv, HD), dtype=torch.bfloat16),) * 2
            # captures (calibration) never take the layer route
            assert tc._layer_fusion_ok(ts, tlp, {}, 1, 1, bf16 + (None, None),
                                       3) is None
    assert {True, False, None} <= set(seen)
    # a mixed a8 layer (down alone at a16) keeps the other routes
    ts, tlp = _served_layer(tc, _gate_layers(rng)[0][1], 1, 4, True)
    mixed = {**tlp, "down": {**tlp["down"], "serve": tc.ServeFlags(a8=False)}}
    cache = (torch.zeros((1, 8, 4, HD)),) * 2 + (None, None)
    assert tc._layer_fusion_ok(ts, tlp, None, 1, 1, cache, 3) is True
    assert tc._layer_fusion_ok(ts, mixed, None, 1, 1, cache, 3) is None


def test_layer_fusion_mode_switch(layer_route):
    layer_route("off")
    assert not tc._layer_fusion_impl()
    for mode in ("on", "interpret"):
        layer_route(mode)
        assert tc._layer_fusion_impl()
    layer_route("sometimes")
    with pytest.raises(ValueError, match="GPTQ_TPU_LAYER_FUSION"):
        tc._layer_fusion_impl()


@pytest.mark.parametrize("a8", [False, True])
def test_model_decode_on_the_layer_route_matches_jax(a8, layer_route,
                                                     monkeypatch):
    """A 2-layer model quantized and packed by gptq_tpu, carried by
    params_from_jax: four greedy tokens equal and the logits within the
    JAX test's bounds (tests/test_layer_fused.py: 0.02 a16, 0.05 a8 of
    max|logit|), with every layer through the whole-layer route."""
    from gptq_tpu.config import QuantConfig
    from gptq_tpu.pipeline import pack_model, quantize_model

    jspec, tspec = _spec(2, hidden=512, ffn=512, max_pos=32)
    jp = jc.init_params(jspec, jax.random.PRNGKey(30))
    calib = jnp.asarray(np.random.default_rng(30).integers(0, 96, size=(2, 16)))
    cfg = QuantConfig(wbits=4, nsamples=2)
    res = quantize_model(jspec, jp, calib, cfg, log=lambda s: None)
    pack_model(jspec, jp, res.quantizers, cfg)
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    js = jc.fuse_serving(jspec, jp, a8=a8)
    ts = tc.fuse_serving(tspec, tp, a8=a8)
    calls = []
    fused = tc.decode_layer_fused
    monkeypatch.setattr(tc, "decode_layer_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))

    def decode(forward, spec, params, cache, to_np, as_tok):
        toks, logits_all = [], []
        tok = as_tok([[7]])
        for _ in range(4):
            logits, cache = forward(spec, params, tok, cache)
            toks.append(int(logits[0, -1].argmax()))
            tok = as_tok([[toks[-1]]])
            logits_all.append(to_np(logits[:, -1]))
        return toks, np.stack(logits_all)

    jt, jlog = decode(jc.model_forward, jspec, js,
                      jc.KVCache.init(jspec, 1, 8, jnp.float32), np.asarray,
                      jnp.asarray)
    tt, tlog = decode(tc.model_forward, tspec, ts,
                      tc.KVCache.init(tspec, 1, 8, torch.float32, device="cpu"),
                      lambda t: t.numpy(), torch.tensor)
    assert len(calls) == 4 * 2  # every layer of every step took the route
    assert tt == jt
    rel = np.abs(tlog - jlog).max() / np.abs(jlog).max()
    assert rel < (0.05 if a8 else 0.02), rel



# ---------------------------------------------------------------------------
# the card kernel's static plan (layer_plan) and its K-split arithmetic
# ---------------------------------------------------------------------------

LLAMA7B = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096)]


@pytest.mark.parametrize("bits,blocks", [
    (4, 132), (3, 132), (8, 132), (4, 7),
    # mixed bits per weight (q|k|v, o, gate|up, down): linearwise.json's
    # o 3 / gate|up 4 / down 3 beside a 4-bit q|k|v, and other mixes
    ((4, 3, 4, 3), 132), ((4, 3, 4, 3), 7), ((3, 8, 2, 4), 132)])
def test_layer_plan_covers_every_word_once(bits, blocks):
    """Every field's word rows of every chunk are streamed exactly once,
    in pieces whose slots run in row order; at llama-7B widths on an
    H100's 132 SMs each block streams within 2% of the mean bytes. A
    tuple of bits gives each weight its own."""
    wbits = bits if isinstance(bits, tuple) else (bits,) * 4
    shapes = tuple((b, K, N) for b, (K, N) in zip(wbits, LLAMA7B))
    plan = tl.layer_plan(shapes, blocks)
    items = plan["items"].tolist()
    first = plan["first"].tolist()
    assert first[0] == 0 and first[-1] == len(items)
    seen, pieces, tickets = {}, {}, set()
    for b in range(blocks):
        its = items[first[b]:first[b + 1]]
        assert [it[0] & 3 for it in its] == sorted(it[0] & 3 for it in its)
        for it in its:
            head, c, r0, r1, slot, pc0, ticket, pair = it
            w, f = head & 3, head >> 2 & 1
            assert r0 % tl.STAGE_ROWS == 0 and r0 < r1
            seen.setdefault((w, f, c), []).append((r0, r1))
            pieces.setdefault((w, c), set()).add(slot)
            tickets.add((w, ticket))
        assert sum((it[3] - it[2]) * tl.CHUNK * 4 for it in its) == plan["bytes"][b]
    for w, (b_, K, N) in enumerate(shapes):
        for c in range(N // tl.CHUNK):
            for f, (fb, _) in enumerate(tpack.FIELD_SPLITS[b_]):
                spans = sorted(seen[w, f, c])
                assert spans[0][0] == 0 and spans[-1][1] == K * fb // 32
                assert all(a[1] == b2[0] for a, b2 in zip(spans, spans[1:]))
            slots = sorted(pieces[w, c])
            assert slots == list(range(slots[0], slots[0] + len(slots)))
    assert len({t for _, t in tickets}) == plan["tickets"]
    # the pieces each block lists in a phase, counted as the kernel's
    # consume does (a gate|up pair's pieces together), fit its list
    listed = max(
        sum(1 for it in items[first[b]:first[b + 1]]
            if it[0] & 3 == w and it[0] & 16
            and (it[0] >> 8) + (it[7] >> 20 if it[0] & 32 else 0) > 1)
        for b in range(blocks) for w in range(4))
    assert plan["max_cut"] == listed <= tl.MAX_PIECES
    if blocks == 132:
        # one width: within 2% of the mean (1.08% at 4 bits, 1.79% at 3);
        # mixed widths cut stages of other sizes: 2.00% at 4/3/4/3, 2.16%
        # at 3/8/2/4, held to 2.5%
        mean = sum(plan["bytes"]) / blocks
        bound = 0.025 if isinstance(bits, tuple) else 0.02
        assert max(abs(v - mean) for v in plan["bytes"]) <= bound * mean


@pytest.mark.parametrize("blocks", [132, 7])
def test_layer_plan_refuses_a_long_piece_list(blocks, monkeypatch):
    """A plan whose block would list more pieces of cut chunks in one phase
    than the kernel's list holds is refused on the host."""
    shapes = tuple((4, K, N) for K, N in LLAMA7B)
    need = tl.layer_plan(shapes, blocks)["max_cut"]
    monkeypatch.setattr(tl, "MAX_PIECES", need - 1)
    with pytest.raises(ValueError, match="pieces of cut chunks"):
        tl.layer_plan(shapes, blocks)


def _split_phase(plan, weights):
    """ops/ffn._phase as the card kernel computes it: the staged row (int8
    codes or bf16), each word row's codes against its staged elements
    (qdot.cuh's byteplane order) times its group's scale (a field's shift
    folded in), each piece of a chunk summed over its rows, the pieces in
    piece order, then the zero points through the staged row's group sums
    and the int8 scale."""
    items = plan["items"].tolist()
    which = {id(pw): w for w, pw in enumerate(weights)}

    def phase(x, pw, a8, bias=None):
        w = which[id(pw)]
        if a8:
            xq, sx = tl._ffn.quantize_acts_int8(x)
            xs, sx = xq.to(torch.float32)[0], sx.reshape(-1)[0]
        else:
            xs, sx = tl._ffn._bf16(x)[0], 1.0
        Kp, Np = pw.Kp, pw.Np
        ng = pw.scale.shape[0]
        SB = tpack.subblock(Kp, pw.groupsize)
        contrib = []  # per field: (word rows, Np) its rows' products
        for (fb, sh), words in zip(tpack.FIELD_SPLITS[pw.bits], pw.words):
            codes = tpack.unpack_field(words, fb, Kp, pw.groupsize).float()
            E, wsb = 8 // fb, SB * fb // 32
            gr = torch.arange(Kp * fb // 32)
            s, j = gr // wsb, gr % wsb
            lane = (torch.arange(E)[:, None] * (SB // E)
                    + torch.arange(4)[None]).reshape(-1)
            k = (s * SB + 4 * j)[:, None] + lane[None]  # (rows, 32 / fb)
            dots = (xs[k][..., None] * codes[k]).sum(dim=1)
            contrib.append(dots * pw.scale[(s * SB) // (Kp // ng)] * 2.0 ** sh)
        v = torch.zeros(Np)
        part = {}
        for it in items:
            if it[0] & 3 != w:
                continue
            f, c = it[0] >> 2 & 1, it[1]
            cols = slice(c * tl.CHUNK, (c + 1) * tl.CHUNK)
            seg = contrib[f][it[2]:it[3], cols].sum(dim=0)
            part[it[4]] = part.get(it[4], 0) + seg
            part.setdefault(("chunk", it[4]), c)
        for slot in sorted(k for k in part if not isinstance(k, tuple)):
            c = part["chunk", slot]
            v[c * tl.CHUNK:(c + 1) * tl.CHUNK] += part[slot]
        groups = xs.reshape(ng, Kp // ng).sum(dim=1)
        y = (v - (pw.zoff * groups[:, None]).sum(dim=0)) * sx
        return y[None]

    return phase


@pytest.mark.parametrize("bits,groupsize,blocks,a8", [
    (3, 128, 3, True), (4, -1, 8, False)])
def test_k_split_replay_matches_jax_kernel(bits, groupsize, blocks, a8,
                                           monkeypatch):
    """The card kernel's K-split phases (layer_plan's pieces over `blocks`
    blocks: down is cut in K at these widths, and o too where 3-bit
    weights make two stages of it) inside the plain layer, held to the JAX
    kernel in interpret mode with the near-tie rule of
    test_torch_ffn._check."""
    S, length, G = 32, 9, 2
    Hkv = H // G
    rng = np.random.default_rng(40 + bits + blocks)
    L = _layer(rng, Hkv, bits=bits, groupsize=groupsize)
    ws = [L[n][1] for n in ("qkv", "o", "gu", "dn")]
    plan = tl.layer_plan(tuple((pw.bits, pw.Kp, pw.Np) for pw in ws), blocks)
    cuts = {(it[0] & 3, it[1]) for it in plan["items"].tolist()
            if it[0] >> 8 > 1}
    # down cut in K (and, 3-bit: o, whose two fields make two stages)
    assert {w for w, _ in cuts} >= ({1, 3} if bits == 3 else {3})
    x = (rng.normal(size=(1, 1, HIDDEN)) * 0.5).astype(np.float32)
    kv = rng.normal(size=(2, 1, S, Hkv, HD)).astype(np.float32)
    w1, w2 = ((rng.random(HIDDEN) + 0.5).astype(np.float32) for _ in range(2))

    class _Spec:
        rope_theta = 10000.0
        hd = HD

    cos, sin = (np.array(t) for t in
                jc.rope_tables(_Spec, jnp.asarray([[length]])))
    kw = dict(n_heads=H, n_kv_heads=Hkv, sm_scale=HD ** -0.5, a8=a8)
    jy, _, _ = jl.decode_layer_fused(
        jnp.asarray(x), jnp.asarray(kv[0], jnp.bfloat16),
        jnp.asarray(kv[1], jnp.bfloat16), jnp.asarray(length),
        jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(w1), jnp.asarray(w2),
        *(L[n][0] for n in ("qkv", "o", "gu", "dn")), interpret=True, **kw)
    monkeypatch.setattr(tl._ffn, "_phase", _split_phase(plan, ws))

    def port():
        tk, tv = (torch.from_numpy(c).to(torch.bfloat16) for c in kv)
        return tl.decode_layer_fused_reference(
            torch.from_numpy(x), tk, tv, torch.tensor(length),
            torch.from_numpy(cos), torch.from_numpy(sin),
            torch.from_numpy(w1), torch.from_numpy(w2), *ws, **kw).numpy()

    _check(port, np.asarray(jy), a8, monkeypatch)


def test_retired_sync_words_start_fresh(monkeypatch):
    """A stream whose launch failed gets fresh zero barrier and ticket
    words for its next launch; the old ones stay alive (a CUDA graph may
    hold their address) and out of sync_clean's check."""
    monkeypatch.setattr(tl, "_syncs", {})
    monkeypatch.setattr(tl, "_retired", [])
    monkeypatch.setattr(tl, "_index", lambda dev: 0)
    dev = torch.device("cpu")
    old = tl._sync_words(8, dev, 5)
    assert tl._sync_words(8, dev, 5) is old  # one buffer a stream
    old[0] = 3  # a barrier count a failed launch left behind
    assert not tl.sync_clean()
    tl._retire_sync_words(dev, 5)
    new = tl._sync_words(8, dev, 5)
    assert new is not old and not bool(new.any()) and tl.sync_clean()
    assert any(t is old for bufs in tl._retired for t in bufs)
