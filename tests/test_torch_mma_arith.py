"""The arithmetic of the tensor-core kernels (csrc/qmma.cu), on the CPU.

The kernels run only on an sm_90a card (tests/test_torch_cuda.py holds them
to the plain versions there). Here their algebra is written out in torch
and held to gptq_tpu on the same numpy inputs, within the card's limit of
1e-4 of max |reference|:
  * #1: exact code products per group, folded as P * scale - xsum *
    (zoff + OFF * scale), with the bf16 code offset OFF = 2^bits, the
    int8 (a8) partials exact in int64 and the 8-bit field's stored
    code - 128 (OFF = -128), and an f32 x split into two bf16 halves;
  * #13: the per-plane identity x . (2B - 1) = 2 (x . B) - sum(x) of the
    one-row kernel, and the tensor-core form x . w_hi + x . w_lo (f32 x:
    x_hi . w_hi + x_hi . w_lo + x_lo . w_hi);
  * the stage row map: a stage's K rows and the word slot and bit shift of
    each, which the kernel's x loader and unpack share, decode the packed
    words into the codes pack_codes stored;
  * split_bf16's residual, and the route each row count takes.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import pack as jpack
from gptq_tpu.ops import qmatmul as jq
from gptq_tpu_torch.ops import bcq_matmul as tbm
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq
from torch_threads import torch_threads  # noqa: F401 (autouse)

jbm = importlib.import_module("gptq_tpu.ops.bcq_matmul")

RTOL = 1e-4  # the card's limit for #1 and #13 against their references


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


def _bf(t):
    """bf16-valued tensor as f64 (exact)."""
    return t.to(torch.float64)


def _uniform(rng, bits, gs, K, N):
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
    return jp, codes, scale, zoff


def qmm_algebra(x, codes, scale, zoff, bits, a8):
    """y = sum_g P_g * scale_g - xsum_g * (zoff_g + OFF * scale_g), P_g the
    MMA partial of x_g against the codes as the kernel's B tile holds
    them. x: (M, Kp) f32, or int8 with a8 (the row scale applied after)."""
    Kp = codes.shape[0]
    ng = scale.shape[0]
    G = Kp // ng
    c = torch.from_numpy(codes).to(torch.int64)
    if a8:
        # s8 x s8: the 8-bit field's stored byte is code - 128 as s8
        b, off = (c - 128, -128.0) if bits == 8 else (c, 0.0)
        parts = [(x[:, g * G:(g + 1) * G].to(torch.int64)
                  @ b[g * G:(g + 1) * G]).to(torch.float64)
                 for g in range(ng)]
        xs = x.to(torch.int64).reshape(x.shape[0], ng, G).sum(-1).double()
    else:
        # bf16 B tile: 2^bits + c (sub-8-bit) or c (8-bit), exact in bf16
        off = 0.0 if bits == 8 else float(1 << bits)
        b = (c.double() + off).to(torch.bfloat16)
        assert torch.equal(_bf(b), c.double() + off)  # exact
        hi, lo = tq.split_bf16(x)
        parts = [_bf(hi[:, g * G:(g + 1) * G]) @ _bf(b[g * G:(g + 1) * G])
                 + _bf(lo[:, g * G:(g + 1) * G]) @ _bf(b[g * G:(g + 1) * G])
                 for g in range(ng)]
        xs = x.double().reshape(x.shape[0], ng, G).sum(-1)
    s = torch.from_numpy(scale).double()
    z = torch.from_numpy(zoff).double()
    y = 0
    for g in range(ng):
        y = y + parts[g] * s[g] - xs[:, g:g + 1] * (z[g] + off * s[g])
    return y


@pytest.mark.parametrize("bits,gs", [(4, -1), (4, 128), (3, 128), (2, -1),
                                     (8, -1), (8, 128)])
@pytest.mark.parametrize("a8", [False, True])
def test_qmm_algebra_matches_jax(bits, gs, a8):
    rng = np.random.default_rng(17 * bits + gs + a8)
    K, N, M = 512, 64, 5
    jp, codes, scale, zoff = _uniform(rng, bits, gs, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = np.asarray(jq.dequant_matmul(jnp.asarray(x), jp, impl="xla",
                                        a8=a8))
    xt = torch.from_numpy(x)
    if a8:
        xq, sx = tq.quantize_acts_int8(xt)
        got = qmm_algebra(xq, codes, scale, zoff, bits, True) * sx.double()
    else:
        got = qmm_algebra(xt, codes, scale, zoff, bits, False)
    assert _rel(got.numpy()[:, :N], want) <= RTOL


def bcq_algebra(x, signs, alpha, a8):
    """The tensor-core form: w = sum_b alpha_b (2B_b - 1) in f32, split as
    w_hi + w_lo; bf16 / int8 x meets both, an f32 x's halves meet them as
    x_hi . w_hi + x_hi . w_lo + x_lo . w_hi. signs (bits, Kp, Np) in
    {-1, +1}, alpha (ng, bits, Np)."""
    bits, Kp, _ = signs.shape
    G = Kp // alpha.shape[0]
    a = torch.repeat_interleave(alpha, G, dim=0).permute(1, 0, 2)
    w = (signs * a).sum(0).to(torch.float32)
    w_hi, w_lo = tq.split_bf16(w)
    if a8 or x.dtype == torch.bfloat16:
        xb = x.to(torch.bfloat16)
        assert torch.equal(_bf(xb), x.double())  # int8 and bf16 x: exact
        return _bf(xb) @ _bf(w_hi) + _bf(xb) @ _bf(w_lo)
    x_hi, x_lo = tq.split_bf16(x)
    return (_bf(x_hi) @ _bf(w_hi) + _bf(x_hi) @ _bf(w_lo)
            + _bf(x_lo) @ _bf(w_hi))


def bcq_planes(x, planes, alpha):
    """The one-row kernel's per-plane identity: sum_g sum_b alpha[g,b] *
    (2 x_g . B_b - sum x_g), B_b in {0, 1}; exact in int64 for int8 x."""
    bits, Kp, _ = planes.shape
    ng = alpha.shape[0]
    G = Kp // ng
    exact = x.dtype == torch.int8
    xv = x.to(torch.int64) if exact else x.double()
    y = 0
    for g in range(ng):
        xg = xv[:, g * G:(g + 1) * G]
        xs = xg.sum(-1, keepdim=True)
        for b in range(bits):
            pb = planes[b, g * G:(g + 1) * G].to(xv.dtype)
            y = y + alpha[g, b].double() * (2 * (xg @ pb) - xs).double()
    return y


@pytest.mark.parametrize("bits,gs", [(3, 128), (2, -1), (4, 64), (3, 16)])
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_bcq_algebra_matches_jax(bits, gs, act):
    rng = np.random.default_rng(31 * bits + gs + len(act))
    N, K, M = 64, 512, 5
    ng = 1 if gs <= 0 else K // gs
    g = K if gs <= 0 else gs
    B = np.where(rng.normal(size=(N, ng, g, bits)) > 0, 1.0, -1.0).astype(
        np.float32)
    alpha = (np.abs(rng.normal(size=(N, ng, bits))) * 0.05).astype(np.float32)
    jp = jpack.pack_bcq(jnp.asarray(B), jnp.asarray(alpha), groupsize=gs)
    tp = tpack.pack_bcq(torch.from_numpy(B), torch.from_numpy(alpha),
                        groupsize=gs)
    x = rng.normal(size=(M, K)).astype(np.float32)
    if act == "bf16":  # the same bf16 values on both sides
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    a8 = act == "a8"
    want = np.asarray(jbm.bcq_matmul(jnp.asarray(x), jp, impl="xla", a8=a8))
    xt = torch.from_numpy(x)
    sx = None
    if a8:
        xt, sx = tq.quantize_acts_int8(xt)
    elif act == "bf16":
        xt = xt.to(torch.bfloat16)
    signs = tbm._unpack_signs(tp.words[0], gs)  # (bits, Kp, Np)
    planes = (signs > 0).to(torch.int64)
    for got in (bcq_algebra(xt, signs.double(), tp.alpha.double(), a8),
                bcq_planes(xt, planes, tp.alpha)):
        if sx is not None:
            got = got * sx.double()
        assert _rel(got.numpy()[:, :N], want) <= RTOL


# --- the stage row map of csrc/qmma.cu (struct Geo), written out ---------

def stage_rows(kt, BK, SB, fbmin):
    """The K rows of stage kt, by K-slot. Regime A (SB > BK): the word
    window [j0, j0 + J) of subblock s in every plane of the finest field;
    regime B: rows [kt*BK, kt*BK + BK)."""
    if SB <= BK:
        return [kt * BK + p for p in range(BK)]
    J = BK * fbmin // 32
    per = SB // BK
    s, j0 = kt // per, (kt % per) * J
    quarter = SB * fbmin // 8
    return [s * SB + (p // (4 * J)) * quarter + 4 * j0 + p % (4 * J)
            for p in range(BK)]


def word_loc(kt, BK, SB, fbmin, fb, q4):
    """(word row, bit shift) of K-slots 4*q4 .. 4*q4 + 3 in a field of
    width fb, through the stage's slot (Geo::loc and Geo::wrow)."""
    p = 4 * q4
    if SB <= BK:
        k = kt * BK + p
        s, r = divmod(k, SB)
        quarter = SB * fb // 8
        slot = s * (SB * fb // 32) + (r % quarter) // 4 - kt * BK * fb // 32
        return kt * BK * fb // 32 + slot, fb * (r // quarter)
    J = BK * fbmin // 32
    per = SB // BK
    s, j0 = kt // per, (kt % per) * J
    ratio = fb // fbmin
    e, q = divmod(p, 4 * J)
    slot = (e % ratio) * J + q // 4
    assert 0 <= slot < BK * fb // 32  # a field's stage holds BK*fb/32 rows
    row = s * (SB * fb // 32) + (slot // J) * (SB * fbmin // 32) + j0 \
        + slot % J
    return row, fb * (e // ratio)


@pytest.mark.parametrize("bits,gs,K", [(4, -1, 4096), (4, 128, 1024),
                                       (3, 128, 1024), (3, -1, 4096),
                                       (2, -1, 2048), (8, -1, 2048),
                                       (4, -1, 480), (3, 32, 256)])
@pytest.mark.parametrize("BK", [64, 128])
def test_stage_row_map_decodes_the_packed_codes(bits, gs, K, BK):
    rng = np.random.default_rng(bits * 1000 + K + BK)
    N = 8
    codes = rng.integers(0, 1 << bits, size=(K, N))
    words = [w.numpy().astype(np.int64) & 0xFFFFFFFF for w in
             tpack.pack_codes(torch.from_numpy(codes), bits, gs)]
    SB = tpack.subblock(K, gs)
    fields = tpack.FIELD_SPLITS[bits]
    fbmin = min(fb for fb, _ in fields)
    order = tq.mma_row_order(K, SB, fbmin, BK)  # the wrapper's x gather
    natural = order is None
    order = torch.arange(K) if natural else order
    assert natural == (SB <= BK) and sorted(order.tolist()) == list(range(K))
    for kt in range(-(-K // BK)):
        rows = stage_rows(kt, BK, SB, fbmin)
        np.testing.assert_array_equal(
            order[kt * BK:(kt + 1) * BK].numpy(), [k for k in rows if k < K])
        got = np.zeros((BK, N), np.int64)
        for (fb, sh), w in zip(fields, words):
            used = set()
            for q4 in range(BK // 4):
                row, shift = word_loc(kt, BK, SB, fbmin, fb, q4)
                if row >= w.shape[0]:  # past Kp: the kernel loads zeros
                    continue
                used.add(row)
                for b in range(4):
                    part = (w[row] >> (shift + 8 * b)) & ((1 << fb) - 1)
                    if fb == 8:
                        part ^= 0x80
                    got[4 * q4 + b] += part << sh
            # every code of every word the stage loads is used
            assert len(used) * (32 // fb) == sum(r < K for r in rows)
        for p, k in enumerate(rows):
            if k < K:
                np.testing.assert_array_equal(got[p], codes[k])
        assert len(set(rows)) == BK
        # a stage never splits a group (groups cover whole subblocks)
        G = K if gs <= 0 else gs
        if gs <= 0 or G % max(BK, SB) == 0:
            assert len({k // G for k in rows if k < K}) == 1


def test_split_bf16_residual():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=200_000) * np.exp(rng.normal(size=200_000) * 4)
         ).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = tq.split_bf16(xt)
    assert hi.dtype == lo.dtype == torch.bfloat16
    res = (xt.double() - _bf(hi) - _bf(lo)).abs()
    # x_hi is within 2^-8 |x|, and x_lo within 2^-9 of that ulp: 2^-17
    assert bool((res <= 2.0 ** -17 * xt.double().abs()).all())
    assert torch.equal(hi, xt.to(torch.bfloat16))


@pytest.mark.parametrize("M,bits,gs,dtype,a8,Np,route", [
    (1, 4, -1, torch.bfloat16, False, 4096, "single_row"),
    (1, 3, 128, torch.float32, True, 4096, "single_row"),
    (2, 4, 128, torch.bfloat16, False, 4096, "mma"),
    (4, 4, -1, torch.float32, True, 4096, "mma"),
    (7, 4, -1, torch.bfloat16, False, 4096, "mma"),
    (8, 3, 128, torch.float32, False, 4096, "mma"),
    (2, 4, 64, torch.float32, True, 4096, "shallow"),
    (2048, 8, -1, torch.float32, True, 32000, "mma"),
    (2048, 4, 128, torch.int8, False, 4096, "mma"),
    (2048, 4, 64, torch.float32, False, 4096, "mma"),
    (2048, 4, 64, torch.float32, True, 4096, "shallow"),  # a8 stage: 128
    (2048, 2, 16, torch.bfloat16, False, 4096, "shallow"),
    (2048, 4, 32, torch.bfloat16, False, 4096, "shallow"),
    (2048, 4, -1, torch.bfloat16, False, 202, "shallow"),
])
def test_qmm_route(M, bits, gs, dtype, a8, Np, route):
    assert tq.qmm_route(M, bits, gs, dtype, a8=a8, Np=Np) == route


@pytest.mark.parametrize("M,bits,gs,Np,route", [
    (1, 3, 128, 4096, "single_row"),
    (2, 3, 128, 4096, "mma"),
    (7, 3, -1, 4096, "mma"),
    (8, 3, 128, 4096, "mma"),
    (2, 3, 128, 202, "shallow"),
    (512, 2, 16, 4096, "mma"),  # the grid is inside w: any group of 8k rows
    (512, 9, 128, 4096, "shallow"),
    (512, 3, 128, 202, "shallow"),
])
def test_bcq_route(M, bits, gs, Np, route):
    assert tbm.bcq_route(M, bits, gs, Np) == route
