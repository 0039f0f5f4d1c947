"""The arithmetic of the single-row kernels of #5 / #6 (csrc/ffn.cu's
mlp_stream_kernel, on the whole-layer kernel's weight stream) and of #9
(csrc/gemv.cuh's qsel_gemv_kernel), on the CPU.

The kernels run only on an sm_90a card (tests/test_torch_cuda.py holds them
to the plain versions there). Here their plans and their sums are written
out in torch and held to gptq_tpu on the same numpy inputs, the Pallas
kernels in interpret mode:
  * #5 / #6: ops/layer_fused.layer_plan over o, gate|up and down (#6:
    gate|up and down) streams every word row of every chunk exactly once;
    each phase stages its whole input row (int8 codes with the absmax / 127
    scale, or bf16), a consumer warp takes two word rows of a stage in one
    group (the group's scale, a 3-bit weight's 1-bit field at 4 x scale),
    the pieces of a chunk cut in K are summed in piece order, then the zero
    points through the staged row's group sums, the int8 scale and the
    bias. The replay stands in for ops/ffn._phase inside the plain
    versions, which round r2, the norm and the activation where the kernel
    does. Within 1e-4 (a16) / 1e-3 (a8) of max |reference|, with the
    near-tie rule of test_torch_ffn._check.
  * #9: test_torch_gemv's replay of the single-row kernel over one expert
    of a bank, its fields and grids found at the kernel's offsets into the
    bank's flat storage (e (Kp fb / 32) Np words a field, e ng Np grid
    entries), within 1e-4 of JAX's expert_dequant_matmul_select.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import ffn as jf
from gptq_tpu.ops import qmatmul as jq
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import layer_fused as tl
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq
from test_torch_ffn import _check, _jt, _x, fused_pair, packed_pair
from test_torch_gemv import RTOL, _rel, gemv_replay, row_dots
from test_torch_moe import _bank_pair

NCW, RW = 16, 2  # csrc/layer_stream.cuh: consumer warps, a warp's word rows
CHUNK, RR = tl.CHUNK, tl.STAGE_ROWS
LLAMA7B = {"o": (4096, 4096), "gu": (4096, 22528), "dn": (11264, 4096)}

_WEIGHTS = {"w4g-1": (4, -1), "w4g128": (4, 128), "w3g128": (3, 128)}


def _plan_shapes(kind, bits, sizes, glu=True):
    """layer_plan's shapes for #5 ("attn_mlp": o, gate|up, down) or #6
    ("ffn": gate|up, down); sizes: {name: (K, N)} of the weights."""
    o = None if kind == "ffn" else (bits, *sizes["o"])
    return (None, o, (bits, *sizes["gu"]), (bits, *sizes["dn"]))


@pytest.mark.parametrize("kind,bits,glu,blocks", [
    ("attn_mlp", 4, True, 132), ("attn_mlp", 3, True, 132),
    ("ffn", 4, True, 132), ("attn_mlp", 8, False, 132),
    ("attn_mlp", 4, True, 7), ("ffn", 3, True, 114)])
def test_mlp_plan_covers_every_word_once(kind, bits, glu, blocks):
    """Every field's word rows of every chunk of the streamed weights are
    streamed exactly once, in pieces whose slots run in row order, by
    blocks that take the phases in order; q|k|v (and #6's o) is not
    streamed; the tickets count each chunk (a gate|up pair: once) and the
    piece lists fit the kernel's. At llama-7B widths on an H100's 132 SMs
    each block streams within one stage of the mean bytes."""
    sizes = dict(LLAMA7B)
    if not glu:  # fc1 -> fc2: gate|up is fc1 alone
        sizes["gu"] = (4096, 11264)
    shapes = _plan_shapes(kind, bits, sizes, glu)
    plan = tl.layer_plan(shapes, blocks, glu)
    items, first = plan["items"].tolist(), plan["first"].tolist()
    assert first[0] == 0 and first[-1] == len(items)
    seen, pieces, tickets = {}, {}, set()
    for b in range(blocks):
        its = items[first[b]:first[b + 1]]
        assert [it[0] & 3 for it in its] == sorted(it[0] & 3 for it in its)
        for head, c, r0, r1, slot, _, ticket, _ in its:
            w, f = head & 3, head >> 2 & 1
            assert shapes[w] is not None and r0 % RR == 0 and r0 < r1
            assert bool(head & 32) == (glu and w == 2)  # gate|up pairs
            seen.setdefault((w, f, c), []).append((r0, r1))
            pieces.setdefault((w, c), set()).add(slot)
            tickets.add(ticket)
    for w, shape in enumerate(shapes):
        if shape is None:
            continue
        _, K, N = shape
        for c in range(N // CHUNK):
            for f, (fb, _) in enumerate(tpack.FIELD_SPLITS[bits]):
                spans = sorted(seen[w, f, c])
                assert spans[0][0] == 0 and spans[-1][1] == K * fb // 32
                assert all(a[1] == b2[0] for a, b2 in zip(spans, spans[1:]))
            slots = sorted(pieces[w, c])
            assert slots == list(range(slots[0], slots[0] + len(slots)))
    assert len(tickets) == plan["tickets"] == sum(
        (s[2] // 2 if glu and w == 2 else s[2]) // CHUNK
        for w, s in enumerate(shapes) if s is not None)
    assert plan["max_cut"] <= tl.MAX_PIECES
    if blocks == 132:
        mean = sum(plan["bytes"]) / blocks
        assert max(abs(v - mean) for v in plan["bytes"]) <= RR * CHUNK * 4


def stream_phase(plan, weights):
    """ops/ffn._phase as mlp_stream_kernel computes it at one row: the
    staged row (int8 codes or bf16, through the port's own rounding
    functions, which test_torch_ffn._check flips at near ties), each plan
    item's stages, a consumer warp's run of RW word rows of one group
    times the group's scale (a field's shift folded in), the pieces of a
    chunk summed in piece order, then the zero points through the staged
    row's group sums, the int8 scale and the bias. Sums in f64 (a8: the
    products exact)."""
    items = plan["items"].tolist()
    which = {id(pw): w for w, pw in enumerate(weights) if pw is not None}

    def phase(x, pw, a8, bias=None):
        w = which[id(pw)]
        if a8:
            xq, sx = tf.quantize_acts_int8(x)
            xs, sx = xq[0], float(sx.reshape(-1)[0])
        else:
            xs, sx = tf._bf16(x)[0], 1.0
        Kp, Np, ng = pw.Kp, pw.Np, pw.scale.shape[0]
        G, sb = Kp // ng, tpack.subblock(pw.Kp, pw.groupsize)
        fields = tpack.FIELD_SPLITS[pw.bits]
        dots = [row_dots(xs, words, fb, sb).double()
                for (fb, _), words in zip(fields, pw.words)]
        scale = pw.scale.double()
        seen, part = set(), {}
        for head, c, r0, r1, slot, *_ in items:
            if head & 3 != w:
                continue
            f = head >> 2 & 1
            fb, sh = fields[f]
            gw = G * fb // 32
            cols = slice(c * CHUNK, (c + 1) * CHUNK)
            acc = part.setdefault(slot, [c, torch.zeros(CHUNK,
                                                        dtype=torch.float64)])
            for r in range(r0, r1, RR):  # a stage
                for warp in range(NCW):
                    gr0 = r + RW * warp
                    nr = min(RW, r1 - gr0)
                    if nr <= 0:
                        continue
                    g = 0 if ng == 1 else gr0 // gw
                    assert ng == 1 or (gr0 + nr - 1) // gw == g  # one group
                    rows = {(f, c, q) for q in range(gr0, gr0 + nr)}
                    assert not rows & seen
                    seen |= rows
                    acc[1] += (dots[f][gr0:gr0 + nr, cols].sum(0)
                               * scale[g, cols] * 2.0 ** sh)
        assert seen == {(f, c, q) for f, (fb, _) in enumerate(fields)
                        for c in range(Np // CHUNK)
                        for q in range(Kp * fb // 32)}
        v = torch.zeros(Np, dtype=torch.float64)
        for slot in sorted(part):  # piece order
            c, p = part[slot]
            v[c * CHUNK:(c + 1) * CHUNK] += p
        xg = xs.double().reshape(ng, G).sum(dim=1)
        y = (v - (pw.zoff.double() * xg[:, None]).sum(dim=0)) * sx
        if bias is not None:
            y = y + tf._vec(bias, Np).double()
        return y.float()[None]

    return phase


H, F, BLOCKS = 512, 1024, 5  # o and down cut in K over 5 blocks


@pytest.mark.parametrize("tag,a8,act,norm,glu", [
    ("w4g-1", True, "silu", "rmsnorm", True),
    ("w4g-1", False, "silu", "rmsnorm", True),
    ("w4g128", False, "gelu", "rmsnorm1p", True),
    ("w3g128", True, "gelu_tanh", "rmsnorm", True),
    ("w4g128", True, "relu", "layernorm", False),  # OPT-style, biases
])
def test_attn_mlp_stream_replay_matches_jax(tag, a8, act, norm, glu,
                                            monkeypatch):
    bits, gs = _WEIGHTS[tag]
    rng = np.random.default_rng(bits * 17 + a8 + 5 * glu)
    jo, to = packed_pair(rng, H, H, bits, gs)
    jg, tg = (fused_pair(rng, H, F, bits, gs) if glu
              else packed_pair(rng, H, F, bits, gs))
    jd, td = packed_pair(rng, F, H, bits, gs)
    assert tf.attn_mlp_fusable(to, tg, td, glu=glu)
    assert tf.mlp_route(1, to, tg, td, a8) == "stream"
    plan = tl.layer_plan((None, *((pw.bits, pw.Kp, pw.Np)
                                  for pw in (to, tg, td))), BLOCKS, glu)
    cut = {it[0] & 3 for it in plan["items"].tolist() if it[0] >> 8 > 1}
    assert {1, 3} <= cut  # o and down are cut in K
    ja, ta = _jt(_x(rng, 1, 1, H))
    jr, tr = _jt(_x(rng, 1, 1, H))
    jw2, tw2 = _jt((rng.random(H) + 0.5).astype(np.float32))
    biases = {"b_ln": H if norm == "layernorm" else 0, "b_o": H,
              "b_g": 0 if glu else F, "b_d": 0 if glu else H}
    jb, tb = {}, {}
    for name, n in biases.items():
        jb[name], tb[name] = _jt(_x(rng, n) * 0.1 if n else None)
    want = jf.attn_mlp_fused(ja, jr, jw2, jo, jg, jd, act=act, norm=norm,
                             eps=1e-5, glu=glu, a8=a8, interpret=True, **jb)
    monkeypatch.setattr(tf, "_phase", stream_phase(plan, [None, to, tg, td]))

    def port():
        return tf.attn_mlp_fused_reference(
            ta, tr, tw2, to, tg, td, act=act, norm=norm, eps=1e-5, glu=glu,
            a8=a8, **tb).numpy()

    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("tag,a8", [("w4g-1", True), ("w4g128", False),
                                    ("w3g128", True)])
def test_ffn_stream_replay_matches_jax(tag, a8, monkeypatch):
    bits, gs = _WEIGHTS[tag]
    rng = np.random.default_rng(bits * 19 + a8)
    jg, tg = fused_pair(rng, H, F, bits, gs)
    jd, td = packed_pair(rng, F, H, bits, gs)
    assert tf.mlp_route(1, None, tg, td, a8) == "stream"
    plan = tl.layer_plan((None, None, *((pw.bits, pw.Kp, pw.Np)
                                        for pw in (tg, td))), BLOCKS)
    assert not any(it[0] & 3 < 2 for it in plan["items"].tolist())
    jm, tm = _jt(_x(rng, 1, 1, H))
    want = jf.ffn_fused(jm, jg, jd, act="silu", a8=a8, interpret=True)
    monkeypatch.setattr(tf, "_phase", stream_phase(plan, [None, None, tg, td]))

    def port():
        return tf.ffn_fused_reference(tm, tg, td, act="silu", a8=a8).numpy()

    _check(port, np.asarray(want), a8, monkeypatch)


def test_mlp_route_takes_the_stream_at_one_row():
    """One row on uniform weights of a stored width that 128 divides takes
    the stream; rows 2-32 take the rows kernel (test_torch_ffn_rows);
    BCQ sign planes and a width the stream's chunks do not divide take
    the tiled kernel."""
    rng = np.random.default_rng(3)
    _, o = packed_pair(rng, H, H, 4, 128)
    _, gu = fused_pair(rng, H, F, 3, 128)
    _, dn = packed_pair(rng, F, H, 4, -1)
    assert tf.mlp_route(1, o, gu, dn) == "stream"
    assert tf.mlp_route(1, None, gu, dn, a8=False) == "stream"
    assert tf.mlp_route(2, o, gu, dn) == tf.mlp_route(32, None, gu, dn) \
        == "rows"
    _, bcq = fused_pair(rng, H, F, 3, 128, fmt="bcq")
    assert tf.mlp_route(1, o, bcq, dn) == "tiles"
    _, narrow = packed_pair(rng, H, 96, 4, -1)  # Np = 96 + pad
    assert (narrow.Np % 128 != 0) == (tf.mlp_route(1, None, gu, narrow)
                                      == "tiles")


def _expert_at(pe, e):
    """Expert e's fields (rows, Np) and grids (ng, Np), found as the kernel
    finds them: at e (Kp fb / 32) Np words into each field's flat storage
    and e ng Np entries into the grids'."""
    words = []
    for (fb, _), w in zip(tpack.FIELD_SPLITS[pe.bits], pe.words):
        n = pe.Kp * fb // 32 * pe.Np
        words.append(w.reshape(-1)[e * n:(e + 1) * n].reshape(-1, pe.Np))
    ng = pe.scale.shape[1]
    grids = [g.reshape(-1)[e * ng * pe.Np:(e + 1) * ng * pe.Np]
             .reshape(ng, pe.Np) for g in (pe.scale, pe.zoff)]
    return words, grids


@pytest.mark.parametrize("bits,gs", [(4, -1), (3, -1), (8, -1), (4, 128),
                                     (3, 128)])
@pytest.mark.parametrize("act", ["bf16", "f32"])
def test_select_gemv_replay_matches_jax(bits, gs, act):
    E, K, N = 3, 1024, 136
    jpe, tpe = _bank_pair(E=E, F=N, D=K, bits=bits, groupsize=gs,
                          seed=bits * 7 + (gs > 0))
    assert tq.select_route(1, tpe.Np) == "single_row"
    assert tq.select_route(2, tpe.Np) == "rows"
    x = np.random.default_rng(bits + len(act)).normal(size=(1, K)).astype(
        np.float32)
    if act == "bf16":  # the same bf16 values on both sides
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    xk = torch.from_numpy(x)[0]
    xk = xk.to(torch.bfloat16) if act == "bf16" else xk
    sb = tpack.subblock(tpe.Kp, gs)
    fbmin = 1 if bits == 3 else bits
    unit = tq.gemv_unit(sb, fbmin)
    splits = tq.gemv_splits(tpe.Kp, tpe.Np, sb, fbmin, xk.element_size(), 132)
    assert splits > 1  # the chunks are cut in K
    for e in (0, E - 1):
        want = np.asarray(jq.expert_dequant_matmul_select(
            jnp.asarray(x), jpe, jnp.asarray(e), interpret=True))[0]
        words, (scale, zoff) = _expert_at(tpe, e)
        got = gemv_replay(xk, words, scale, zoff, bits, sb, splits, unit,
                          False)
        assert _rel(got.numpy()[:N], want) <= RTOL
