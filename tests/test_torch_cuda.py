"""The port's CUDA kernels against their plain PyTorch twins on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The file
imports neither JAX nor gptq_tpu (the plain twins are held to gptq_tpu on
the CPU by test_torch_qmatmul.py, test_torch_attention.py and
test_torch_ffn.py), so on the
GPU machine, which has no JAX, it runs without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.models import moe as tm
from gptq_tpu_torch.ops import attention as ta
from gptq_tpu_torch.ops import bcq_matmul as tbm
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)
    print(f"rel err {err:.3g} (limit {rtol})")  # shown by pytest -rP
    assert err <= rtol, err


def _packed(rng, bits, groupsize, K, N):
    """Random packed weight with an act-order perm and a bias; K and N pad
    like pack_quantized pads them, pad columns carry zero grids."""
    Kp, Np = tpack.pad_dim(K, groupsize), tpack.pad_dim(N)
    ng = Kp // groupsize if groupsize > 0 else 1
    codes = rng.integers(0, 1 << bits, size=(Kp, Np)).astype(np.int32)
    scale = (rng.random((ng, Np)) * 0.02 + 0.005).astype(np.float32)
    zoff = (scale * rng.integers(0, 1 << bits, size=(ng, Np))).astype(np.float32)
    scale[:, N:] = 0
    zoff[:, N:] = 0
    return tpack.PackedWeight(
        words=tpack.pack_codes(torch.from_numpy(codes), bits, groupsize),
        scale=torch.from_numpy(scale), zoff=torch.from_numpy(zoff),
        bias=torch.from_numpy(rng.normal(size=N).astype(np.float32)),
        perm=torch.from_numpy(rng.permutation(K).astype(np.int32)),
        bits=bits, K=K, N=N, groupsize=groupsize)


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (3, 128),
                                            (8, -1), (2, 16)])
@pytest.mark.parametrize("M", [1, 3, 70])
@pytest.mark.parametrize("a8", [False, True])
def test_qmm_kernel_matches_plain(cuda, bits, groupsize, M, a8):
    rng = np.random.default_rng(M + bits)
    pw = _packed(rng, bits, groupsize, 480, 200).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, 480)).astype(np.float32)).to(cuda)
    before = tq.launches
    got = tq.dequant_matmul(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert tq.launches == before + 1
    want = tq.dequant_matmul_reference(x, pw, a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("a8", [False, True])
def test_qmm_single_row_past_48kb(cuda, a8):
    # a 12800-wide f32 row needs more than 48 KB of shared memory, so the
    # single-row kernel runs on memory it opts into
    rng = np.random.default_rng(12800)
    pw = _packed(rng, 4, -1, 12800, 96).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, 12800)).astype(np.float32)).to(cuda)
    got = tq.dequant_matmul(x, pw, a8=a8)
    want = tq.dequant_matmul_reference(x, pw, a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


def _bcq(rng, bits, groupsize, K, N):
    """Random BCQ weight packed by pack_bcq (K and N pad as it pads)."""
    ng = 1 if groupsize <= 0 else K // groupsize
    g = K if groupsize <= 0 else groupsize
    B = np.where(rng.normal(size=(N, ng, g, bits)) > 0, 1.0, -1.0)
    alpha = np.abs(rng.normal(size=(N, ng, bits))) * 0.05
    pw = tpack.pack_bcq(torch.from_numpy(B.astype(np.float32)),
                        torch.from_numpy(alpha.astype(np.float32)),
                        bias=torch.from_numpy(rng.normal(size=N).astype(
                            np.float32)), groupsize=groupsize)
    pw.perm = torch.from_numpy(rng.permutation(K).astype(np.int32))
    return pw


# #13: sums of f32 products in another order (a8: exact int32 partials in
# the single-row kernel, f32 in the tiled one); bf16 outputs may round
# one bf16 step apart
@pytest.mark.parametrize("bits,groupsize", [(2, -1), (3, 128), (4, 128),
                                            (3, 32), (3, 64), (2, 16)])
@pytest.mark.parametrize("M", [1, 3, 70])
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_bcq_kernel_matches_plain(cuda, bits, groupsize, M, act):
    rng = np.random.default_rng(M * 7 + bits + groupsize)
    pw = _bcq(rng, bits, groupsize, 512, 200).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32)).to(cuda)
    if act == "bf16":
        x = x.to(torch.bfloat16)
    a8 = act == "a8"
    before = tbm.launches
    got = tbm.bcq_matmul(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert tbm.launches == before + 1
    want = tbm.bcq_matmul_reference(x, pw, a8=a8)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if act == "bf16":
        bound = 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= bound)
    else:
        _close(got, want, rtol=1e-4)


@pytest.mark.parametrize("a8", [False, True])
def test_bcq_single_row_past_48kb(cuda, a8):
    rng = np.random.default_rng(12800)
    pw = _bcq(rng, 3, 128, 12800, 96).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, 12800)).astype(np.float32)).to(cuda)
    got = tbm.bcq_matmul(x, pw, a8=a8)
    want = tbm.bcq_matmul_reference(x, pw, a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


# #7: the streamed route against the plain version, single-field weights
@pytest.mark.parametrize("bits,groupsize,K", [(4, -1, 480), (4, 128, 1024),
                                              (2, 256, 4096), (8, -1, 4096),
                                              (4, 128, 11264)])
@pytest.mark.parametrize("M", [1, 3, 8, 13])
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_streamed_kernel_matches_plain(cuda, monkeypatch, bits, groupsize, K,
                                       M, act):
    rng = np.random.default_rng(M + bits + K)
    pw = _packed(rng, bits, groupsize, K, 200).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda)
    if act == "bf16":
        x = x.to(torch.bfloat16)
    a8 = act == "a8"
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "streamed")
    before = (tq.launches, tq.stream_launches)
    got = tq.dequant_matmul(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert (tq.launches, tq.stream_launches) == (before[0], before[1] + 1)
    want = tq.dequant_matmul_reference(x, pw, a8=a8)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if act == "bf16":
        bound = 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= bound)
    else:
        _close(got, want, rtol=1e-4)


def test_streamed_route_takes_qmm_for_3_bits(cuda, monkeypatch):
    rng = np.random.default_rng(3)
    pw = _packed(rng, 3, 128, 512, 96).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, 512)).astype(np.float32)).to(cuda)
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "streamed")
    before = (tq.launches, tq.stream_launches)
    tq.dequant_matmul(x, pw)
    assert (tq.launches, tq.stream_launches) == (before[0] + 1, before[1])


def _cache(rng, lead, S, Hkv, hd, int8):
    if int8:
        k = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        ks = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
        return k, v, ks, vs
    k = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
    return k, v, None, None


@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("Hkv", [8, 2, 1])  # G = 1, 4, 8
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_attention_kernel_matches_plain(cuda, cache, Hkv, stacked, hd):
    B, S, H = 3, 200, 8
    rng = np.random.default_rng(Hkv * hd)
    k, v, ks, vs = _cache(rng, (2, B) if stacked else (B,), S, Hkv, hd,
                          cache == "int8")
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    fk = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    fv = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    q_, fk_, fv_, lens_ = (torch.from_numpy(a).to(cuda)
                           for a in (q, fk, fv, lens))
    dt = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}[cache]
    k_, v_ = (torch.from_numpy(a).to(cuda).to(dt) for a in (k, v))
    ks_, vs_ = (None if a is None else torch.from_numpy(a).to(cuda)
                for a in (ks, vs))
    kw = dict(k_scale=ks_, v_scale=vs_, fresh_k=fk_, fresh_v=fv_,
              layer=1 if stacked else None)
    before = ta.launches
    got = ta.decode_attention(q_, k_, v_, lens_, 0.09, **kw)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    want = ta.decode_attention_reference(q_, k_, v_, lens_, 0.09, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("S,lens", [(2048, [2048, 700, 1]), (64, [0, 5, 64])])
def test_attention_kernel_splits_and_empty_rows(cuda, S, lens, fresh):
    # a long cache cut into several splits, and rows whose splits are all
    # empty (length 0: only the fresh pair is attended, or, without it,
    # nothing: zeros)
    B, H, Hkv, hd = 3, 4, 4, 128
    rng = np.random.default_rng(S)
    k, v, ks, vs = _cache(rng, (B,), S, Hkv, hd, True)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(size=(B, H, hd)).astype(np.float32), k, v, ks, vs,
        rng.normal(size=(B, Hkv, hd)).astype(np.float32),
        rng.normal(size=(B, Hkv, hd)).astype(np.float32),
        np.array(lens, np.int32))]
    q_, k_, v_, ks_, vs_, fk_, fv_, lens_ = args
    kw = dict(k_scale=ks_, v_scale=vs_, fresh_k=fk_ if fresh else None,
              fresh_v=fv_ if fresh else None)
    got = ta.decode_attention(q_, k_, v_, lens_, 0.09, **kw)
    want = ta.decode_attention_reference(q_, k_, v_, lens_, 0.09, **kw)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


# Fused kernels against their plain versions: both round r2, the norms
# and the activations to bf16 and (a8) quantize every phase's input to
# int8; their f32 sums run in other orders, so an element on a rounding
# boundary can land one bf16 or one int8 step apart. Hence 3e-3 of
# max|want|, not the 1e-4 of a single packed matmul. In a8 attn_mlp over
# several rows, one r2 element that rounds the other way can flip an
# int8 code of the norm output, which moves its row by up to about 1e-2
# of max|want| at these widths (test_torch_ffn.py shows one such flip's
# size); those cases hold FLIP_RTOL. The residual r2, which neither limit
# can see where the down phase dwarfs it, is held on its own.
FUSED_RTOL = 3e-3
FLIP_RTOL = 1.5e-2


def _fusable(rng, bits, groupsize, K, N, parts=1):
    ws = []
    for _ in range(parts):
        codes = rng.integers(0, 1 << bits, size=(K, N)).astype(np.int32)
        ng = K // groupsize if groupsize > 0 else 1
        scale = (rng.random((ng, N)) * 0.02 + 0.01).astype(np.float32)
        zoff = (scale * (1 << (bits - 1))).astype(np.float32)
        ws.append(tpack.PackedWeight(
            words=tpack.pack_codes(torch.from_numpy(codes), bits, groupsize),
            scale=torch.from_numpy(scale), zoff=torch.from_numpy(zoff),
            bits=bits, K=K, N=N, groupsize=groupsize))
    return ws[0] if parts == 1 else tpack.fuse_packed(ws)


def _vec(rng, n, cuda, base=0.0):
    return torch.from_numpy((rng.normal(size=n) * 0.1 + base)
                            .astype(np.float32)).to(cuda)


@pytest.mark.parametrize("norm,bits,groupsize", [
    ("rmsnorm", 4, -1), ("rmsnorm1p", 3, 128), ("layernorm", 8, 128)])
@pytest.mark.parametrize("M", [1, 5, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_norm_qkv_kernel_matches_plain(cuda, norm, bits, groupsize, M, a8):
    rng = np.random.default_rng(M * 10 + bits)
    pw = _fusable(rng, bits, groupsize, 512, 256, parts=3).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32)).to(cuda)
    kw = dict(norm=norm, eps=1e-5, a8=a8, b_qkv=_vec(rng, pw.Np, cuda),
              b_ln=_vec(rng, 512, cuda) if norm == "layernorm" else None)
    w1 = _vec(rng, 512, cuda, base=1.0)
    before = tf.norm_qkv_launches
    got = tf.norm_qkv_fused(x, w1, pw, **kw)
    torch.cuda.synchronize()
    assert tf.norm_qkv_launches == before + 1
    want = tf.norm_qkv_fused_reference(x, w1, pw, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)


@pytest.mark.parametrize("act,norm,glu,bits,groupsize", [
    ("silu", "rmsnorm", True, 4, -1), ("gelu", "rmsnorm1p", True, 4, 128),
    ("gelu_tanh", "rmsnorm", True, 3, 128), ("relu", "layernorm", False, 8, -1)])
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_attn_mlp_kernel_matches_plain(cuda, act, norm, glu, bits, groupsize,
                                       M, a8):
    rng = np.random.default_rng(M * 10 + bits + glu)
    H, F = 512, 1536
    o = _fusable(rng, bits, groupsize, H, H).to(cuda)
    gu = _fusable(rng, bits, groupsize, H, F, parts=2 if glu else 1).to(cuda)
    dn = _fusable(rng, bits, groupsize, F, H).to(cuda)
    attn, xres = (torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
                  .to(cuda) for _ in range(2))
    kw = dict(act=act, norm=norm, eps=1e-5, glu=glu, a8=a8,
              b_ln=_vec(rng, H, cuda) if norm == "layernorm" else None,
              b_o=_vec(rng, H, cuda), b_g=None if glu else _vec(rng, F, cuda),
              b_d=None if glu else _vec(rng, H, cuda))
    w2 = _vec(rng, H, cuda, base=1.0)
    before = tf.attn_mlp_launches
    got = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn, **kw)
    torch.cuda.synchronize()
    assert tf.attn_mlp_launches == before + 1
    want = tf.attn_mlp_fused_reference(attn, xres, w2, o, gu, dn, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(),
           rtol=FLIP_RTOL if a8 and M > 1 else FUSED_RTOL)
    # the residual r2 on its own, which the check above cannot see where
    # the down phase's output dwarfs it: with down's grid zeroed the output
    # is r2, which both sides round to bf16 (one bf16 step, 2^-7 of an
    # element, apart at most; an element near 0 by its f32 sum's rounding)
    dn0 = dataclasses.replace(dn, scale=torch.zeros_like(dn.scale),
                              zoff=torch.zeros_like(dn.zoff))
    kw0 = {**kw, "b_d": None}
    got0 = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn0, **kw0).cpu()
    want0 = tf.attn_mlp_fused_reference(attn, xres, w2, o, gu, dn0, **kw0).cpu()
    bound = 2.0**-7 * want0.abs() + 1e-5 * want0.abs().max()
    assert bool(((got0 - want0).abs() <= bound).all())
    assert not bool((want0.abs() <= bound).all())  # a residual left out fails


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (3, 128), (8, 128)])
@pytest.mark.parametrize("M", [1, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_ffn_kernel_matches_plain(cuda, bits, groupsize, M, a8):
    rng = np.random.default_rng(M + bits)
    gu = _fusable(rng, bits, groupsize, 512, 1536, parts=2).to(cuda)
    dn = _fusable(rng, bits, groupsize, 1536, 512).to(cuda)
    m = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32)).to(cuda)
    before = tf.ffn_launches
    got = tf.ffn_fused(m, gu, dn, act="silu", a8=a8)
    torch.cuda.synchronize()
    assert tf.ffn_launches == before + 1
    want = tf.ffn_fused_reference(m, gu, dn, act="silu", a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)


def test_fused_kernels_refuse_what_they_cannot_serve(cuda):
    rng = np.random.default_rng(0)
    pw = _fusable(rng, 4, -1, 512, 256).to(cuda)
    x = torch.zeros((33, 512), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        tf.norm_qkv_fused(x, torch.ones(512, device=cuda), pw)
    with pytest.raises(ValueError, match="width"):
        tf.norm_qkv_fused(x[:1, :256], torch.ones(256, device=cuda), pw)


def _bank(rng, bits, groupsize, K, N, E=4):
    """A random RTN-gridded (E, N, K) expert stack packed by
    pack_expert_stack (K and N pad as it pads them)."""
    W = torch.from_numpy((rng.normal(size=(E, N, K)) * 0.2).astype(np.float32))
    s, z = tm._rtn_expert_grids(W, bits, groupsize)
    return tpack.pack_expert_stack(W, s, z, bits, groupsize)


def _acts(rng, shape, act, cuda):
    if act == "int8":
        return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
            np.int8)).to(cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    return x.to(torch.bfloat16) if act == "bf16" else x


# #8 and #9: f32 sums in another order (int8 x: exact int32 partials),
# f32 outputs on both sides
@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (3, 128),
                                            (2, -1), (8, -1)])
@pytest.mark.parametrize("M", [1, 2, 16, 32])
@pytest.mark.parametrize("per_x", [False, True])
@pytest.mark.parametrize("act", ["f32", "bf16", "int8"])
def test_expert_kernel_matches_plain(cuda, bits, groupsize, M, per_x, act):
    rng = np.random.default_rng(M * 11 + bits + groupsize)
    K = 480 if groupsize < 0 else 512  # 480: stored padded to 512
    pe = _bank(rng, bits, groupsize, K, 200).to(cuda)
    x = _acts(rng, (4, M, K) if per_x else (M, K), act, cuda)
    before = tq.expert_launches
    got = tq.expert_dequant_matmul(x, pe)
    torch.cuda.synchronize()
    assert tq.expert_launches == before + 1
    assert got.shape == (4, M, 200) and got.dtype == torch.float32
    want = tq.expert_dequant_matmul_reference(x, pe)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (3, 128),
                                            (2, -1), (8, -1)])
@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("act", ["f32", "bf16", "int8"])
def test_expert_select_kernel_matches_plain(cuda, bits, groupsize, M, act):
    rng = np.random.default_rng(M * 13 + bits + groupsize)
    K = 480 if groupsize < 0 else 512
    pe = _bank(rng, bits, groupsize, K, 200).to(cuda)
    x = _acts(rng, (M, K), act, cuda)
    for e in (0, 3, 1):
        idx = torch.tensor([e], dtype=torch.int32, device=cuda)
        before = tq.select_launches
        got = tq.expert_dequant_matmul_select(x, pe, idx)
        torch.cuda.synchronize()
        assert tq.select_launches == before + 1
        want = tq.expert_dequant_matmul_select_reference(x, pe, idx)
        _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


def test_expert_select_past_48kb_and_bad_index(cuda):
    # a 14336-wide f32 row (Mixtral's down projection) needs more than
    # 48 KB of shared memory; an index outside the bank gives NaN
    rng = np.random.default_rng(14336)
    pe = _bank(rng, 4, -1, 14336, 96, E=3).to(cuda)
    x = _acts(rng, (1, 14336), "f32", cuda)
    idx = torch.tensor([2], dtype=torch.int32, device=cuda)
    _close(tq.expert_dequant_matmul_select(x, pe, idx).cpu().numpy(),
           tq.expert_dequant_matmul_select_reference(x, pe, idx).cpu().numpy(),
           rtol=1e-4)
    bad = torch.tensor([3], dtype=torch.int32, device=cuda)
    assert torch.isnan(tq.expert_dequant_matmul_select(x, pe, bad)).all()


def test_expert_kernels_refuse_what_they_cannot_serve(cuda):
    rng = np.random.default_rng(1)
    pe = _bank(rng, 4, 16, 512, 64).to(cuda)  # 16-row groups < a subblock
    x = torch.zeros((2, 512), device=cuda)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="subblocks"):
        tq.expert_dequant_matmul(x, pe)
    with pytest.raises(ValueError, match="subblocks"):
        tq.expert_dequant_matmul_select(x, pe, idx)
    pe = _bank(rng, 4, -1, 512, 64).to(cuda)
    with pytest.raises(ValueError, match="rows"):
        tq.expert_dequant_matmul(torch.zeros((33, 512), device=cuda), pe)
    with pytest.raises(ValueError, match="int32"):
        tq.expert_dequant_matmul_select(x, pe, idx.cpu())


def test_moe_decode_selects_without_a_host_sync(cuda):
    """moe_ffn at one token: routing, the top-k selections and the six
    select launches run with no host sync (the index never leaves the
    card), and the output equals the plain versions'."""
    spec = tc.ArchSpec(arch="llama", n_layers=1, hidden=512, n_heads=4,
                       ffn=1024, vocab=64, max_pos=64, act="silu",
                       pos="rope", norm_type="rmsnorm", linear_bias=False,
                       n_experts=8, expert_top_k=2, expert_capacity=4.0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    p = tm.init_moe_params(spec, gen, device=cuda)
    tm.pack_experts({"layers": [p]}, bits=4)
    x = torch.randn((1, 1, 512), generator=gen, device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    before = tq.select_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tm.moe_ffn(spec, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tq.select_launches == before + 6
    cpu = {"router": {"w": p["router"]["w"].cpu()},
           "experts": {k: v.to("cpu") for k, v in p["experts"].items()}}
    want = tm.moe_ffn(spec, cpu, x.cpu())
    # bf16 output, and a bf16 GLU inner on both sides: an element whose f32
    # sum lands by a rounding boundary comes out one bf16 step (2^-8 of
    # itself) apart, which the down product carries
    _close(got.float().cpu().numpy(), want.float().numpy(), rtol=1e-2)
