"""The arithmetic of the single-row kernels of #1 and #13 (csrc/gemv.cuh),
on the CPU.

The kernels run only on an sm_90a card (tests/test_torch_cuda.py holds them
to the plain versions there). Here their plan and their sums are written
out in torch and held to gptq_tpu on the same numpy inputs, within the
card's limit of 1e-4 of max |reference|:
  * the cut: each 128-column chunk's K rows split into pieces of whole
    units (ops/qmatmul.gemv_pieces), each piece streamed as stages of 32
    word rows of every field (uniform) or sign plane (BCQ), a consumer
    warp taking 4 rows of each stage;
  * each warp's exact partial of a run of rows in one group (int64 for
    int8 x) times the group's grid (uniform: scale, 4 x scale on a 3-bit
    weight's 1-bit field; BCQ: 2 alpha), the warps summed in warp order;
  * the zero-point term (uniform: xsum_g zoff[g]; BCQ: xsum_g alpha[g, b]
    on every plane) added by the run that holds a group's first row in the
    piece, from the piece's group sums of x;
  * the pieces summed in piece order, the zero-point term subtracted once
    after.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import pack as jpack
from gptq_tpu.ops import qmatmul as jq
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq

jbm = importlib.import_module("gptq_tpu.ops.bcq_matmul")

RTOL = 1e-4  # the card's limit for #1 and #13 against their references
CC, RR, GW, GRW = 128, 32, 8, 4  # csrc/gemv.cuh: chunk, stage, warps, rows


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


def fields_of(words, bits, bcq):
    """(words (rows, Np), fb, mul, grid row of group g, adds zero points)
    for each field of a uniform weight or each sign plane of a BCQ one."""
    if bcq:
        return [(words[0][b], 1, 2.0, (lambda g, b=b: g * bits + b), True)
                for b in range(bits)]
    splits = tpack.FIELD_SPLITS[bits]
    return [(w, fb, float(1 << sh), (lambda g: g), f == 0)
            for f, (w, (fb, sh)) in enumerate(zip(words, splits))]


def row_dots(x, words, fb, sb):
    """(rows, Np): each word row's dot with x over every code in it: word
    row s Wsb + j, byte b of plane e holds K row s SB + e quarter + 4 j + b
    (an 8-bit field stores code - 128). Exact in int64 for int8 x."""
    rows = words.shape[0]
    wsb, quarter = sb * fb // 32, sb * fb // 8
    gr = torch.arange(rows)
    e = torch.arange(8 // fb)
    b = torch.arange(4)
    krow = ((gr // wsb)[:, None, None] * sb + e[None, :, None] * quarter
            + 4 * (gr % wsb)[:, None, None] + b[None, None, :])
    w = words.to(torch.int64) & 0xFFFFFFFF
    code = (w[:, None, None, :] >> (8 * b[None, None, :, None]
                                    + fb * e[None, :, None, None])) \
        & ((1 << fb) - 1)
    if fb == 8:
        code = code ^ 0x80
    xv = x.to(torch.int64) if x.dtype == torch.int8 else x.double()
    return torch.einsum("reb,rebn->rn", xv[krow], code.to(xv.dtype))


def gemv_replay(x, words, grid, zoff, bits, sb, splits, unit, bcq):
    """out (Np,) f64 as csrc/gemv.cuh computes it, x (Kp,) f32 / bf16 /
    int8. grid: uniform scale (ng, Np) or BCQ alpha (ng * bits, Np)."""
    fields = fields_of(words, bits, bcq)
    Kp, Np = x.shape[0], fields[0][0].shape[1]
    ng = grid.shape[0] // (bits if bcq else 1)
    G = Kp // ng
    grid, zoff = grid.double(), None if zoff is None else zoff.double()
    dots = [row_dots(x, w, fb, sb) for w, fb, *_ in fields]
    out = torch.zeros(Np, dtype=torch.float64)
    for c0 in range(0, Np, CC):
        cols = slice(c0, min(Np, c0 + CC))
        D = Z = 0.0
        for k0, k1 in tq.gemv_pieces(Kp, unit, splits):
            gA = k0 // G
            xg = [x[max(k0, g * G):min(k1, (g + 1) * G)].double().sum()
                  for g in range(gA, (k1 - 1) // G + 1)]
            d = torch.zeros((GW, cols.stop - c0), dtype=torch.float64)
            z = torch.zeros_like(d)
            for (_, fb, mul, srow, zero), dot in zip(fields, dots):
                r0, r1, gw = k0 * fb // 32, k1 * fb // 32, G * fb // 32
                for r in range(r0, r1, RR):
                    for w in range(GW):
                        gr0 = r + GRW * w
                        nr = min(GRW, r1 - gr0)
                        if nr <= 0:  # past the piece's last row
                            continue
                        # one run where groups are whole runs of the
                        # warp's rows, else a run a row
                        runs = ([(gr0, gr0 + nr)] if gw % GRW == 0 else
                                [(q, q + 1) for q in range(gr0, gr0 + nr)])
                        for a, e in runs:
                            g = a // gw
                            part = dot[a:e, cols].sum(0).double()  # exact
                            d[w] += part * (grid[srow(g), cols] * mul)
                            if zero and a == max(g * gw, r0):
                                zs = grid[srow(g), cols] if bcq \
                                    else zoff[g, cols]
                                z[w] += xg[g - gA] * zs
            D = D + d.sum(0)  # warps in warp order, pieces in piece order
            Z = Z + z.sum(0)
        out[cols] = D - Z
    return out


def _x(rng, K, act):
    x = rng.normal(size=(1, K)).astype(np.float32)
    if act == "bf16":  # the same bf16 values on both sides
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _kernel_x(x, act):
    """x as the kernel takes it, and the int8 row scale (a8)."""
    xt = torch.from_numpy(x)
    if act == "a8":
        return tq.quantize_acts_int8(xt)
    return (xt.to(torch.bfloat16) if act == "bf16" else xt), None


UNIFORM = [(4, -1, 2560, 200, 3), (4, 128, 1024, 200, 4),
           (3, 128, 2048, 136, 3), (3, -1, 2048, 136, 2),
           (2, -1, 1536, 72, 3), (2, 128, 1024, 72, 8),
           (8, -1, 1024, 136, 2), (8, 128, 1024, 136, 8),
           (3, 32, 1024, 72, 5), (3, 96, 1536, 72, 5)]


@pytest.mark.parametrize("bits,gs,K,N,splits", UNIFORM)
@pytest.mark.parametrize("act", ["a8", "bf16", "f32"])
def test_uniform_gemv_replay_matches_jax(bits, gs, K, N, splits, act):
    rng = np.random.default_rng(bits * 100 + K + N + len(act))
    Kp, Np = jpack.pad_dim(K, gs), jpack.pad_dim(N)
    ng = Kp // gs if gs > 0 else 1
    codes = rng.integers(0, 1 << bits, size=(Kp, Np)).astype(np.int32)
    scale = (rng.random((ng, Np)) * 0.02 + 0.005).astype(np.float32)
    zoff = (scale * rng.integers(0, 1 << bits, size=(ng, Np))).astype(
        np.float32)
    jp = jpack.PackedWeight(
        words=jpack.pack_codes(jnp.asarray(codes), bits, gs),
        scale=jnp.asarray(scale), zoff=jnp.asarray(zoff), bits=bits, K=K,
        N=N, groupsize=gs)
    x = _x(rng, K, act)
    want = np.asarray(jq.dequant_matmul(jnp.asarray(x), jp, impl="xla",
                                        a8=act == "a8"))[0]
    words = tpack.pack_codes(torch.from_numpy(codes), bits, gs)
    sb = tpack.subblock(Kp, gs)
    unit = tq.gemv_unit(sb, 1 if bits == 3 else bits)
    assert splits <= -(-Kp // unit)
    xk, sx = _kernel_x(x, act)
    got = gemv_replay(xk[0], words, torch.from_numpy(scale),
                      torch.from_numpy(zoff), bits, sb, splits, unit, False)
    if sx is not None:
        got = got * sx.double()[0]
    assert _rel(got.numpy()[:N], want) <= RTOL


BCQ = [(2, -1, 2048, 200, 3), (3, 128, 2048, 136, 4), (4, 128, 1024, 72, 8),
       (3, 32, 1024, 72, 5), (3, 96, 1536, 72, 5)]


@pytest.mark.parametrize("bits,gs,K,N,splits", BCQ)
@pytest.mark.parametrize("act", ["a8", "bf16", "f32"])
def test_bcq_gemv_replay_matches_jax(bits, gs, K, N, splits, act):
    rng = np.random.default_rng(bits * 300 + K + N + len(act))
    ng = 1 if gs <= 0 else K // gs
    g = K if gs <= 0 else gs
    B = np.where(rng.normal(size=(N, ng, g, bits)) > 0, 1.0, -1.0).astype(
        np.float32)
    alpha = (np.abs(rng.normal(size=(N, ng, bits))) * 0.05).astype(np.float32)
    jp = jpack.pack_bcq(jnp.asarray(B), jnp.asarray(alpha), groupsize=gs)
    tp = tpack.pack_bcq(torch.from_numpy(B), torch.from_numpy(alpha),
                        groupsize=gs)
    x = _x(rng, K, act)
    want = np.asarray(jbm.bcq_matmul(jnp.asarray(x), jp, impl="xla",
                                     a8=act == "a8"))[0]
    sb = tpack.subblock(tp.Kp, gs)
    unit = tq.gemv_unit(sb, 1)
    assert splits <= -(-tp.Kp // unit)
    xk, sx = _kernel_x(x, act)
    got = gemv_replay(torch.nn.functional.pad(xk[0], (0, tp.Kp - K)),
                      tp.words, tp.alpha.reshape(-1, tp.Np), None, bits, sb,
                      splits, unit, True)
    if sx is not None:
        got = got * sx.double()[0]
    assert _rel(got.numpy()[:N], want) <= RTOL


def stage_plan(Kp, Np, bits, sb, splits, unit, bcq):
    """Every (chunk, field, word row) the kernel's consumer warps take,
    with the K range its piece stages, as csrc/gemv.cuh walks them."""
    fbs = [1] * bits if bcq else [fb for fb, _ in tpack.FIELD_SPLITS[bits]]
    taken, staged = [], []
    for c in range(-(-Np // CC)):
        for k0, k1 in tq.gemv_pieces(Kp, unit, splits):
            staged.append((c, k0, k1))
            for f, fb in enumerate(fbs):
                r0, r1 = k0 * fb // 32, k1 * fb // 32
                assert r0 % GRW == 0  # a warp's rows start a run
                for r in range(r0, r1, RR):
                    for w in range(GW):
                        gr0 = r + GRW * w
                        taken += [(c, f, q) for q in
                                  range(gr0, min(gr0 + GRW, r1))]
    return fbs, taken, staged


@pytest.mark.parametrize("Kp,Np,bits,gs,bcq", [
    (4096, 12288, 4, -1, False), (4096, 4096, 4, -1, False),
    (11264, 4096, 4, -1, False), (11264, 4096, 3, 128, False),
    (4096, 22528, 3, 128, True), (11264, 4096, 3, 128, True),
    (2560, 200, 8, -1, False), (1536, 72, 3, 96, False),
    (12800, 96, 4, -1, False), (1024, 72, 4, 32, True)])
def test_gemv_plan_reads_every_word_row_once(Kp, Np, bits, gs, bcq):
    sb = tpack.subblock(Kp, gs)
    fbmin = 1 if bcq or bits == 3 else bits
    unit = tq.gemv_unit(sb, fbmin)
    assert unit % sb == 0 and unit % (GRW * 32 // fbmin) == 0
    units = -(-Kp // unit)
    for x_bytes in (1, 2, 4):
        s_max = tq.gemv_splits(Kp, Np, sb, fbmin, x_bytes, 132)
        assert 1 <= s_max <= min(8, units)
        for splits in sorted({1, s_max, min(8, units)}):
            fbs, taken, staged = stage_plan(Kp, Np, bits, sb, splits, unit,
                                            bcq)
            want = [(c, f, q) for c in range(-(-Np // CC))
                    for f, fb in enumerate(fbs) for q in range(Kp * fb // 32)]
            assert sorted(taken) == want  # every word row exactly once
            for c in range(-(-Np // CC)):  # the pieces tile K in order
                cuts = [(k0, k1) for cc, k0, k1 in staged if cc == c]
                assert cuts[0][0] == 0 and cuts[-1][1] == Kp
                assert all(k1 > k0 and k0 % sb == 0 for k0, k1 in cuts)
                assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
            if splits == s_max < min(8, units):  # the staged x fits
                assert x_bytes * max(k1 - k0 for _, k0, k1 in staged) \
                    <= 64 * 1024


def test_gemv_splits_fill_the_card():
    # a llama-7B layer's linears on 132 SMs: as many pieces as keep two
    # blocks an SM at most, within a portable cluster of 8
    sms = 132
    assert tq.gemv_splits(4096, 4096, 512, 4, 1, sms) == 8
    assert tq.gemv_splits(4096, 12288, 512, 4, 1, sms) == 2
    assert tq.gemv_splits(4096, 22528, 512, 4, 1, sms) == 1
    assert tq.gemv_splits(11264, 4096, 512, 4, 1, sms) == 8
    # a narrow weight with few units takes no more pieces than units
    assert tq.gemv_splits(1024, 128, 512, 4, 1, sms) == 2
    # a wide f32 row at one chunk: pieces keep the staged x within 64 KB
    s = tq.gemv_splits(65536, 128, 512, 4, 4, sms)
    assert -(-65536 // 512 // s) * 512 * 4 <= 64 * 1024
