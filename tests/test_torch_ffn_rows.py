"""The arithmetic of the batched-decode kernels of #4 and #5 / #6 (csrc/
rows.cuh's norm_qkv_rows_kernel and mlp_rows_kernel: 2 .. 32 rows on the
tensor cores) and their routes, on the CPU.

The kernels run only on an sm_90a card (tests/test_torch_cuda.py holds them
to the plain versions there). Here their plan and their sums are written
out in torch and held to gptq_tpu's norm_qkv_fused / attn_mlp_fused /
ffn_fused (the Pallas kernels in interpret mode) on the same numpy inputs:
  * each phase's rows prepared once (the plain version's norm and
    quantize_acts_int8, so that test_torch_ffn._check can flip a near tie:
    int8 codes with the absmax / 127 scale, or bf16), and their group sums;
  * ops/layer_fused.layer_plan (glu off) over the phase's weights, each
    stage's K segments and, per k-step (32 K rows a8, 16 a16), the word row
    and shift of each four-row quad as rows.cuh's Geo finds them; the codes
    the MMA sees (a8: mul c, or the 8-bit field's stored byte c - 128; a16:
    mul (2^fb + c), or c for 8 bits), a k-step's partial folded with its
    group's scale when the group changes and at an item's end;
  * the pieces of a chunk summed in piece order, then the zero points
    through the group sums with the codes' offset, the int8 scale and the
    bias.
Sums in f64, where every partial is exact. Within 1e-4 (a16) / 1e-3 (a8)
of max |reference|, with test_torch_ffn._check's near-tie rule applied to
each row on its own (_check_rows: a row depends on its own inputs only,
and at 32 rows the nearest ties of all rows crowd out the one row that
needs a flip). The replay of a row is the same bits at M = 4 and M = 32,
as the kernel's must be.
"""

import math

import numpy as np
import pytest
import torch

from gptq_tpu.ops import ffn as jf
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import layer_fused as tl
from gptq_tpu_torch.ops import pack as tpack
from test_torch_ffn import (CANDIDATES, MAX_FLIPS, TOL, _jt, _Ties, _x,
                            fused_pair, packed_pair)
from torch_threads import torch_threads  # noqa: F401 (autouse)

CHUNK, RR, SEGK = tl.CHUNK, tl.STAGE_ROWS, tf.ROWS_SEGK
H, F, BLOCKS = 512, 1024, 5  # o and down cut in K over 5 blocks

_WEIGHTS = {"w4g-1": (4, -1), "w4g128": (4, 128), "w3g128": (3, 128),
            "w3g-1": (3, -1), "w8g-1": (8, -1), "w2g128": (2, 128),
            "w2g-1": (2, -1)}


def _offset(bits, a8):
    """OFF of the finish: the offset of the codes the MMA multiplies."""
    if a8:
        return -128.0 if bits == 8 else 0.0
    return 0.0 if bits == 8 else 12.0 if bits == 3 else float(1 << bits)


def stage_steps(pw, f, r0, nr, a8):
    """rows.cuh's Geo over a stage: word rows [r0, r0 + nr) of field f.
    Yields per k-step its first K row and, per quad q, the stage row and
    shift of the word holding K rows k + 4 q .. k + 4 q + 3."""
    fb = tpack.FIELD_SPLITS[pw.bits][f][0]
    SB = tpack.subblock(pw.Kp, pw.groupsize)
    lsb, wsb = SB.bit_length() - 1, SB * fb // 32
    lq = lsb + fb.bit_length() - 1 - 3
    nseg = nr * 32 // fb // SEGK
    assert nseg >= 1 and nr * 32 // fb % SEGK == 0
    if wsb >= RR:
        kbase, step = (r0 // wsb) * SB + 4 * (r0 % wsb), 1 << lq
    else:
        kbase, step = (r0 // wsb) * SB, SEGK
    KS = 32 if a8 else 16
    for t in range(nseg):
        for i in range(SEGK // KS):
            k = kbase + t * step + KS * i
            quads = []
            for q in range(KS // 4):
                kq = k + 4 * q
                s, r = kq >> lsb, kq & (SB - 1)
                e, j = r >> lq, (r & ((1 << lq) - 1)) >> 2
                quads.append((s * wsb + j - r0, fb * e))
            yield k, quads


def _codes(pw, f, row, sh, c, a8):
    """The four codes (bytes 0..3) of word row `row` of field f at shift
    sh over chunk c, as the MMA multiplies them: (4, CHUNK) f64."""
    fb, fsh = tpack.FIELD_SPLITS[pw.bits][f]
    mul = 2.0 ** fsh
    words = pw.words[f][row, c * CHUNK:(c + 1) * CHUNK].to(torch.int64)
    words = words & 0xFFFFFFFF
    out = []
    for b in range(4):
        code = ((words >> (8 * b + sh)) & ((1 << fb) - 1)).double()
        if fb == 8:  # the stored byte is c ^ 0x80: as s8, c - 128
            code = (code.long() ^ 0x80).double()
            code = code - 128.0 if a8 else code
        elif not a8:
            code = code + 2.0 ** fb
        out.append(code * mul)
    return torch.stack(out)


def _weight_steps(pw, items, w, a8):
    """Per plan item of weight w: (chunk, piece slot, first, last, [(K rows,
    group, codes (KS, CHUNK))] per k-step in the kernel's order), built
    once per weight; checks that every K row of every chunk meets each
    field exactly once, in one group a k-step, and that a k-step's quads
    lie on distinct stage rows mod 8 (bank-conflict-free loads)."""
    G = pw.Kp // pw.scale.shape[0]
    seen = {}
    out = []
    for head, c, r0, r1, slot, *_ in items:
        if head & 3 != w:
            continue
        f = head >> 2 & 1
        steps = []
        for r in range(r0, r1, RR):
            nr = min(RR, r1 - r)
            for k, quads in stage_steps(pw, f, r, nr, a8):
                assert k // G == (k + len(quads) * 4 - 1) // G
                assert len({sr % 8 for sr, _ in quads[:4]}) == 4
                codes = []
                for q, (sr, sh) in enumerate(quads):
                    assert 0 <= sr < nr
                    codes.append(_codes(pw, f, r + sr, sh, c, a8))
                rows = torch.arange(k, k + 4 * len(quads))
                for kr in rows.tolist():
                    assert (f, c, kr) not in seen
                    seen[f, c, kr] = True
                steps.append((rows, k // G, torch.cat(codes)))
        out.append((c, slot, bool(head & 8), bool(head & 16), steps))
    n_fields = len(tpack.FIELD_SPLITS[pw.bits])
    assert len(seen) == n_fields * (pw.Np // CHUNK) * pw.Kp
    return out


def rows_phase(plan, weights):
    """ops/ffn._phase as the rows kernels compute it over M rows (module
    docstring); weights: (q|k|v, o, gate|up, down), None where absent."""
    items = plan["items"].tolist()
    which = {id(pw): w for w, pw in enumerate(weights) if pw is not None}
    steps_of = {}  # (weight, a8): _weight_steps, built once

    def phase(x, pw, a8, bias=None):
        w = which[id(pw)]
        M = x.shape[0]
        if (w, a8) not in steps_of:
            steps_of[w, a8] = _weight_steps(pw, items, w, a8)
        if a8:
            xq, sx = tf.quantize_acts_int8(x)
            xs, sx = xq.double(), sx.double().reshape(M, 1)
        else:
            xs, sx = tf._bf16(x).double(), torch.ones(M, 1,
                                                      dtype=torch.float64)
        ng = pw.scale.shape[0]
        scale = pw.scale.double()
        part = {}
        for c, slot, first, last, steps in steps_of[w, a8]:
            cols = slice(c * CHUNK, (c + 1) * CHUNK)
            if first:
                part[slot] = [c, torch.zeros(M, CHUNK, dtype=torch.float64)]
            acc = part[slot][1]
            gcur, p = -1, None
            for rows, g, codes in steps:
                if g != gcur:
                    if gcur >= 0:
                        acc += p * scale[gcur, cols]
                    gcur, p = g, torch.zeros(M, CHUNK, dtype=torch.float64)
                p += xs[:, rows] @ codes
            if gcur >= 0:
                acc += p * scale[gcur, cols]
        v = torch.zeros(M, pw.Np, dtype=torch.float64)
        for slot in sorted(part):  # piece order
            c, p = part[slot]
            v[:, c * CHUNK:(c + 1) * CHUNK] += p
        G = pw.Kp // ng
        xg = xs.reshape(M, ng, G).sum(dim=2)
        zeff = pw.zoff.double() + _offset(pw.bits, a8) * scale
        y = (v - xg @ zeff) * sx
        if bias is not None:
            y = y + tf._vec(bias, pw.Np).double()
        return y.float()

    return phase


class _RowTies(_Ties):
    """test_torch_ffn._Ties, recording each rounding point's row width
    (every point rounds an (M, width) tensor)."""

    def __init__(self, mp, flip=frozenset()):
        self.width = {}
        super().__init__(mp, flip)

    def _round(self, v, r, other):
        self.width[self.n] = v.shape[-1]
        return super()._round(v, r, other)


def _check_rows(run_port, want, a8, monkeypatch):
    """test_torch_ffn._check's rule row by row: a row over TOL[a8] of
    max|want| passes only if rounding at most MAX_FLIPS of its own near
    ties the other way (chosen greedily among its CANDIDATES nearest)
    brings it within TOL[a8]. run_port(rows) replays the rows `rows` (all
    where None). A row's flips are searched on a replay of that row alone:
    a row's output depends on its own inputs only (test_rows_replay_row_
    independent), and its near ties keep their rounding points, their
    distances and their order, their indices shifted to row 0."""
    tol, want = TOL[a8], np.asarray(want, np.float64)
    scale = np.max(np.abs(want))

    def row_err(got_row, m):
        return np.max(np.abs(np.asarray(got_row, np.float64) - want[m])) / scale

    with monkeypatch.context() as mp:
        ties = _RowTies(mp)
        got = run_port(None)
    for m in range(want.shape[0]):
        err, flips = row_err(got[m], m), frozenset()
        # row m's near ties, keyed as the replay of row m alone meets them
        cands = [(p, e - m * ties.width[p]) for _, (p, e) in sorted(ties.near)
                 if e // ties.width[p] == m][:CANDIDATES]
        while err > tol and len(flips) < MAX_FLIPS:
            best = None
            for key in cands:
                if key in flips:
                    continue
                with monkeypatch.context() as mp:
                    _RowTies(mp, flips | {key})
                    e = row_err(run_port([m])[0], m)
                if best is None or e < best[0]:
                    best = (e, flips | {key})
            if best is None or best[0] >= err:
                break
            err, flips = best
        assert err <= tol, (f"row {m}: err {err:.3g} > {tol} with "
                            f"{len(flips)} near-tie flips")


def _plan(weights):
    return tl.layer_plan(tuple(None if pw is None else (pw.bits, pw.Kp, pw.Np)
                               for pw in weights), BLOCKS, False)


@pytest.mark.parametrize("tag,a8,M", [
    ("w4g-1", True, 2), ("w4g-1", False, 32), ("w3g128", True, 4),
    ("w3g-1", False, 2), ("w8g-1", True, 32), ("w8g-1", False, 4),
    ("w2g128", True, 32), ("w2g-1", False, 4)])
def test_norm_qkv_rows_replay_matches_jax(tag, a8, M, monkeypatch):
    bits, gs = _WEIGHTS[tag]
    rng = np.random.default_rng(bits * 23 + a8 + M)
    jp, tp = fused_pair(rng, H, H // 2, bits, gs, parts=3)
    assert tf.norm_qkv_route(M, tp, a8) == "rows"
    jx, tx = _jt(_x(rng, M, H))
    jw, tw = _jt((rng.random(H) + 0.5).astype(np.float32))
    want = jf.norm_qkv_fused(jx, jw, jp, norm="rmsnorm", eps=1e-5, a8=a8,
                             interpret=True)
    weights = [tp, None, None, None]
    monkeypatch.setattr(tf, "_phase", rows_phase(_plan(weights), weights))

    def port(rows):
        x = tx if rows is None else tx[rows]
        return tf.norm_qkv_fused_reference(x, tw, tp, norm="rmsnorm",
                                           eps=1e-5, a8=a8).numpy()

    _check_rows(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("tag,a8,act,norm,glu,M", [
    ("w4g-1", True, "silu", "rmsnorm", True, 32),
    ("w4g-1", False, "silu", "rmsnorm", True, 4),
    ("w4g128", False, "gelu", "rmsnorm1p", True, 2),
    ("w3g128", True, "gelu_tanh", "rmsnorm", True, 4),
    ("w4g128", True, "relu", "layernorm", False, 2),  # OPT-style, biases
    ("w8g-1", False, "silu", "rmsnorm", True, 2),
    ("w2g-1", True, "silu", "rmsnorm", True, 4),
])
def test_attn_mlp_rows_replay_matches_jax(tag, a8, act, norm, glu, M,
                                          monkeypatch):
    bits, gs = _WEIGHTS[tag]
    rng = np.random.default_rng(bits * 17 + a8 + 5 * glu + M)
    jo, to = packed_pair(rng, H, H, bits, gs)
    jg, tg = (fused_pair(rng, H, F, bits, gs) if glu
              else packed_pair(rng, H, F, bits, gs))
    jd, td = packed_pair(rng, F, H, bits, gs)
    assert tf.attn_mlp_fusable(to, tg, td, glu=glu)
    assert tf.mlp_route(M, to, tg, td, a8) == "rows"
    weights = [None, to, tg, td]
    plan = _plan(weights)
    cut = {it[0] & 3 for it in plan["items"].tolist() if it[0] >> 8 > 1}
    # down is cut in K, and o where a chunk of it is more than one stage
    assert 3 in cut and (1 in cut or bits < 3)
    ja, ta = _jt(_x(rng, M, H))
    jr, tr = _jt(_x(rng, M, H))
    jw2, tw2 = _jt((rng.random(H) + 0.5).astype(np.float32))
    biases = {"b_ln": H if norm == "layernorm" else 0, "b_o": H,
              "b_g": 0 if glu else F, "b_d": 0 if glu else H}
    jb, tb = {}, {}
    for name, n in biases.items():
        jb[name], tb[name] = _jt(_x(rng, n) * 0.1 if n else None)
    want = jf.attn_mlp_fused(ja, jr, jw2, jo, jg, jd, act=act, norm=norm,
                             eps=1e-5, glu=glu, a8=a8, interpret=True, **jb)
    monkeypatch.setattr(tf, "_phase", rows_phase(plan, weights))

    def port(rows):
        a, r = (ta, tr) if rows is None else (ta[rows], tr[rows])
        return tf.attn_mlp_fused_reference(
            a, r, tw2, to, tg, td, act=act, norm=norm, eps=1e-5, glu=glu,
            a8=a8, **tb).numpy()

    _check_rows(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("tag,a8,M", [("w4g-1", True, 4),
                                      ("w4g128", False, 32),
                                      ("w3g128", True, 2)])
def test_ffn_rows_replay_matches_jax(tag, a8, M, monkeypatch):
    bits, gs = _WEIGHTS[tag]
    rng = np.random.default_rng(bits * 19 + a8 + M)
    jg, tg = fused_pair(rng, H, F, bits, gs)
    jd, td = packed_pair(rng, F, H, bits, gs)
    assert tf.mlp_route(M, None, tg, td, a8) == "rows"
    weights = [None, None, tg, td]
    plan = _plan(weights)
    assert not any(it[0] & 3 < 2 for it in plan["items"].tolist())
    jm, tm = _jt(_x(rng, M, H))
    want = jf.ffn_fused(jm, jg, jd, act="silu", a8=a8, interpret=True)
    monkeypatch.setattr(tf, "_phase", rows_phase(plan, weights))

    def port(rows):
        m = tm if rows is None else tm[rows]
        return tf.ffn_fused_reference(m, tg, td, act="silu", a8=a8).numpy()

    _check_rows(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("a8", [True, False])
def test_rows_replay_row_independent(a8, monkeypatch):
    """A row's replayed output is the same bits at M = 4 and M = 32, in
    other slots: the plan, the k-steps, the folds and the piece order are
    the weights' alone, and a row's preparation is its own."""
    rng = np.random.default_rng(7 + a8)
    _, to = packed_pair(rng, H, H, 4, 128)
    _, tg = fused_pair(rng, H, F, 4, 128)
    _, td = packed_pair(rng, F, H, 4, 128)
    _, tq = fused_pair(rng, H, H // 2, 4, -1, parts=3)
    weights = [tq, to, tg, td]
    monkeypatch.setattr(tf, "_phase", rows_phase(_plan(weights), weights))
    attn = torch.from_numpy(_x(rng, 32, H))
    xres = torch.from_numpy(_x(rng, 32, H))
    w2 = torch.from_numpy((rng.random(H) + 0.5).astype(np.float32))
    idx = torch.tensor([5, 17, 30, 0])
    for run in (lambda a, r: tf.attn_mlp_fused_reference(
                    a, r, w2, to, tg, td, a8=a8),
                lambda a, r: tf.norm_qkv_fused_reference(a, w2, tq, a8=a8)):
        full, part = run(attn, xres), run(attn[idx], xres[idx])
        assert torch.equal(full[idx], part)


def test_rows_routes():
    """Rows 2 .. 32 on weights rows_ok takes go to the rows kernels, one
    row to the single-row streams as before; BCQ sign planes, groups or
    stored widths the kernels' 128-row segments and chunks do not tile,
    and more than 32 rows take the tiled kernels."""
    rng = np.random.default_rng(11)
    _, o = packed_pair(rng, H, H, 4, 128)
    _, gu = fused_pair(rng, H, F, 3, 128)
    _, dn = packed_pair(rng, F, H, 4, -1)
    _, qkv = fused_pair(rng, H, H // 2, 8, -1, parts=3)
    for M in (2, 3, 4, 8, 16, 32):
        for a8 in (True, False):
            assert tf.mlp_route(M, o, gu, dn, a8) == "rows"
            assert tf.mlp_route(M, None, gu, dn, a8) == "rows"
            assert tf.norm_qkv_route(M, qkv, a8) == "rows"
    assert tf.mlp_route(1, o, gu, dn) == "stream"
    assert tf.norm_qkv_route(1, qkv) == "stream"
    assert tf.mlp_route(33, o, gu, dn) == tf.norm_qkv_route(33, qkv) == "tiles"
    _, bcq = fused_pair(rng, H, F, 3, 128, fmt="bcq")
    assert tf.mlp_route(4, o, bcq, dn) == "tiles"
    _, bq = fused_pair(rng, H, H // 2, 3, 128, parts=3, fmt="bcq")
    assert tf.norm_qkv_route(4, bq) == "tiles"
    _, g64 = packed_pair(rng, H, H, 4, 64)  # groups shallower than a segment
    assert not tf.rows_ok(g64) and tf.norm_qkv_route(4, g64) == "tiles"
    _, narrow = packed_pair(rng, H, 96, 4, -1)  # Np = 96 + pad
    assert (narrow.Np % 128 != 0) == (tf.norm_qkv_route(8, narrow) == "tiles")
    assert all(tf.rows_ok(pw) for pw in (o, gu, dn, qkv))


def test_rows_smem_layout():
    """The rows kernel's shared memory (csrc/ffn_rows.cu rows_layout) at
    llama-7B widths: a ring of at least two stages beside the prepared
    row (11264 f32) for every weight kind at 2 and 32 rows, within the
    232,448 bytes of a block; a stage's x segments grow with the rows and
    with the finest field (a 3-bit weight's 1-bit field: 8 segments)."""
    def weight(K, N, bits):
        return tpack.PackedWeight(
            words=[torch.zeros(K * fb // 32, N, dtype=torch.int32)
                   for fb, _ in tpack.FIELD_SPLITS[bits]],
            scale=torch.zeros(1, N), zoff=torch.zeros(1, N), bias=None,
            perm=None, bits=bits, K=K, N=N, groupsize=-1)

    for bits in (2, 3, 4, 8):
        ws = [weight(4096, 4096, bits), weight(4096, 22528, bits),
              weight(11264, 4096, bits)]
        for M in (2, 32):
            for a8 in (True, False):
                smem = tf._rows_smem(M, a8, ws)
                assert 0 < smem <= tf.ROWS_SMEM
                assert tf.mlp_route(M, *ws, a8) == "rows"
    big = [weight(65536, 4096, 3)]  # the prepared row alone outgrows it
    assert tf._rows_smem(32, False, big) == 0
    assert tf.norm_qkv_route(32, big[0], False) == "tiles"
    assert math.isclose(tf.ROWS_SMEM, 232448)
