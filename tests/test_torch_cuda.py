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


def tie_rows(n_rows=8, width=256, seed=0) -> np.ndarray:
    """f32 rows whose entries sit on exact .5 ties of x / (absmax / 127)
    in IEEE division, each row's absmax (its first entry) chosen so that
    the product absmax * fl(1 / 127) is one ulp off absmax / 127: a
    quantizer that divides by the Python number 127.0 on CUDA (a product
    with the reciprocal there) rounds some of these codes the other way."""
    f = np.float32
    rng = np.random.default_rng(seed)
    rows = []
    while len(rows) < n_rows:
        a = f(rng.uniform(1.0, 2.0))
        s = a / f(127)
        if s == a * (f(1) / f(127)):
            continue
        j = rng.integers(-126, 126, size=4 * width) + 0.5
        x = (j * s).astype(f)
        x = x[(x / s) == j.astype(f)][:width - 1]  # exact ties only
        if len(x) == width - 1:
            rows.append(np.concatenate([[a], x]).astype(f))
    return np.stack(rows)


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
def test_int8_quantizer_ties_match_the_cpu(cuda):
    """The shared int8 quantizer (every a8 input and the int8 KV rows)
    gives the CPU's codes and scales bit for bit on rows of exact .5 ties
    (the CPU's are held to gptq_tpu's in test_torch_qmatmul.py)."""
    x = torch.from_numpy(tie_rows())
    q_cpu, s_cpu = tq.quantize_acts_int8(x)
    q_gpu, s_gpu = tq.quantize_acts_int8(x.to(cuda))
    assert torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
    kq_cpu, ks_cpu = tc._quantize_kv(x.reshape(8, 4, 64))
    kq_gpu, ks_gpu = tc._quantize_kv(x.reshape(8, 4, 64).to(cuda))
    assert torch.equal(kq_gpu.cpu(), kq_cpu)
    assert torch.equal(ks_gpu.cpu(), ks_cpu)


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


def _partial_check(got, want):
    """(m, l, acc) against the plain version: m where l > 0, -inf else."""
    gm, gl, ga = (t.cpu().numpy() for t in got)
    wm, wl, wa = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(gl, wl, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ga, wa, rtol=1e-3, atol=1e-3)
    live = wl > 0
    np.testing.assert_allclose(gm[live], wm[live], rtol=1e-3, atol=1e-3)
    assert (gm[~live] == -np.inf).all() and (wm[~live] == -np.inf).all()


@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("Hkv", [8, 2, 1])  # G = 1, 4, 8
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("wide", [False, True])
def test_partial_attention_kernel_matches_plain(cuda, cache, Hkv, hd, wide):
    """#10 / #11 (one kernel) on a stacked cache whose valid slots are not
    contiguous, with alibi slopes where the entry takes them."""
    B, S, H = 2, 700, 8
    rng = np.random.default_rng(Hkv * hd + wide)
    k, v, ks, vs = _cache(rng, (2, B), S, Hkv, hd, cache == "int8")
    pos = np.where(rng.random(S) < 0.6, rng.permutation(S), -1).astype(np.int32)
    pos[S // 2:S // 2 + 300] = -1  # a whole split with nothing valid
    dt = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}[cache]
    q_ = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32)).to(cuda)
    k_, v_ = (torch.from_numpy(a).to(cuda).to(dt) for a in (k, v))
    ks_, vs_ = (None if a is None else torch.from_numpy(a).to(cuda)
                for a in (ks, vs))
    slopes = (torch.from_numpy(np.asarray(tc.alibi_slopes(H))).to(cuda)
              if wide or Hkv == H else None)
    kw = dict(k_scale=ks_, v_scale=vs_, slopes=slopes, layer=1)
    pos_ = torch.from_numpy(pos).to(cuda)
    fn = ta.decode_attention_partial_wide if wide else ta.decode_attention_partial
    before = (ta.partial_launches, ta.partial_wide_launches)
    got = fn(q_, k_, v_, pos_, 0.09, **kw)
    torch.cuda.synchronize()
    assert (ta.partial_launches, ta.partial_wide_launches) == (
        before[0] + (not wide), before[1] + wide)
    _partial_check(got, ta.decode_attention_partial_wide_reference(
        q_, k_, v_, pos_, 0.09, **kw))


def test_partial_attention_kernel_empty_shard(cuda):
    """A shard with no valid slot: m = -inf, l = 0, acc = 0."""
    rng = np.random.default_rng(3)
    k, v, ks, vs = _cache(rng, (1,), 256, 4, 128, True)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(size=(1, 4, 128)).astype(np.float32), k, v,
        np.full(256, -1, np.int32))]
    m, l, acc = ta.decode_attention_partial_wide(
        *args, 0.09, k_scale=torch.from_numpy(ks).to(cuda),
        v_scale=torch.from_numpy(vs).to(cuda))
    assert bool((m == float("-inf")).all()) and bool((l == 0).all())
    assert bool((acc == 0).all())


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


def _fusable_bcq(rng, bits, groupsize, K, N, parts=1):
    ws = [dataclasses.replace(_bcq(rng, bits, groupsize, K, N), bias=None,
                              perm=None) for _ in range(parts)]
    return ws[0] if parts == 1 else tpack.fuse_packed(ws)


# the BCQ branch of the three kernels: the same limits as the uniform one
@pytest.mark.parametrize("bits,groupsize", [(2, -1), (3, 128)])
@pytest.mark.parametrize("M", [1, 5, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_norm_qkv_bcq_kernel_matches_plain(cuda, bits, groupsize, M, a8):
    rng = np.random.default_rng(M * 10 + bits + 500)
    pw = _fusable_bcq(rng, bits, groupsize, 512, 256, parts=3).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32)).to(cuda)
    w1 = _vec(rng, 512, cuda, base=1.0)
    kw = dict(eps=1e-5, a8=a8, b_qkv=_vec(rng, pw.Np, cuda))
    before = tf.norm_qkv_launches
    got = tf.norm_qkv_fused(x, w1, pw, **kw)
    torch.cuda.synchronize()
    assert tf.norm_qkv_launches == before + 1
    want = tf.norm_qkv_fused_reference(x, w1, pw, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)


@pytest.mark.parametrize("bits,groupsize", [(2, -1), (3, 128)])
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_attn_mlp_bcq_kernel_matches_plain(cuda, bits, groupsize, M, a8):
    rng = np.random.default_rng(M * 10 + bits + 600)
    H, F = 512, 1536
    o = _fusable_bcq(rng, bits, groupsize, H, H).to(cuda)
    gu = _fusable_bcq(rng, bits, groupsize, H, F, parts=2).to(cuda)
    dn = _fusable_bcq(rng, bits, groupsize, F, H).to(cuda)
    attn, xres = (torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
                  .to(cuda) for _ in range(2))
    kw = dict(eps=1e-5, a8=a8, b_o=_vec(rng, H, cuda))
    w2 = _vec(rng, H, cuda, base=1.0)
    before = tf.attn_mlp_launches
    got = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn, **kw)
    torch.cuda.synchronize()
    assert tf.attn_mlp_launches == before + 1
    want = tf.attn_mlp_fused_reference(attn, xres, w2, o, gu, dn, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(),
           rtol=FLIP_RTOL if a8 and M > 1 else FUSED_RTOL)
    # the residual on its own: down's alphas zeroed, the output is r2
    dn0 = dataclasses.replace(dn, alpha=torch.zeros_like(dn.alpha))
    got0 = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn0, **kw).cpu()
    want0 = tf.attn_mlp_fused_reference(attn, xres, w2, o, gu, dn0, **kw).cpu()
    bound = 2.0**-7 * want0.abs() + 1e-5 * want0.abs().max()
    assert bool(((got0 - want0).abs() <= bound).all())
    assert not bool((want0.abs() <= bound).all())


@pytest.mark.parametrize("bits,groupsize", [(2, -1), (3, 128)])
@pytest.mark.parametrize("M", [1, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_ffn_bcq_kernel_matches_plain(cuda, bits, groupsize, M, a8):
    rng = np.random.default_rng(M + bits + 700)
    gu = _fusable_bcq(rng, bits, groupsize, 512, 1536, parts=2).to(cuda)
    dn = _fusable_bcq(rng, bits, groupsize, 1536, 512).to(cuda)
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
    bcq = _fusable_bcq(rng, 3, 128, 512, 256).to(cuda)
    short = dataclasses.replace(bcq, alpha=bcq.alpha[:, :2])  # 2 of 3 planes
    with pytest.raises(ValueError, match="malformed"):
        tf.norm_qkv_fused(x[:1], torch.ones(512, device=cuda), short)


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


# ---------------------------------------------------------------------------
# the whole-layer kernel (#12) and the chained decode's CUDA graphs
# ---------------------------------------------------------------------------

def _layer_weights(rng, cuda, hidden, Hkv, hd, F):
    """q|k|v (hidden x (hidden + 2 Hkv hd)), o, gate|up and down, 4-bit g-1."""
    kvw = Hkv * hd
    qkv = tpack.fuse_packed([_fusable(rng, 4, -1, hidden, n)
                             for n in (hidden, kvw, kvw)])
    return [w.to(cuda) for w in (qkv, _fusable(rng, 4, -1, hidden, hidden),
                                 _fusable(rng, 4, -1, hidden, F, parts=2),
                                 _fusable(rng, 4, -1, F, hidden))]


@pytest.mark.parametrize("cache", ["bf16", "f32"])
@pytest.mark.parametrize("G", [1, 2, 4])  # 4: Mixtral's ratio
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("hd,S,length", [(128, 64, 37), (64, 512, 300)])
def test_layer_kernel_matches_plain(cuda, hd, S, length, a8, G, cache):
    from gptq_tpu_torch.ops import layer_fused as tl

    H, F = 8, 1024
    Hkv, hidden = H // G, H * hd
    rng = np.random.default_rng(hd + 10 * G + a8)
    ws = _layer_weights(rng, cuda, hidden, Hkv, hd, F)
    spec = tc.ArchSpec(arch="llama", n_layers=2, hidden=hidden, n_heads=H,
                       n_kv_heads=Hkv, ffn=F, vocab=8, max_pos=S, pos="rope")
    lens = torch.tensor(length, dtype=torch.int32, device=cuda)
    cos, sin = tc.rope_tables(spec, lens.reshape(1, 1))
    x = torch.from_numpy(rng.normal(size=(1, 1, hidden)).astype(np.float32)
                         ).to(cuda)
    w1, w2 = _vec(rng, hidden, cuda, base=1.0), _vec(rng, hidden, cuda, base=1.0)
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    kv0 = [torch.from_numpy(rng.normal(size=(2, 1, S, Hkv, hd)).astype(
        np.float32)).to(cuda).to(dt) for _ in range(2)]
    kw = dict(n_heads=H, n_kv_heads=Hkv, sm_scale=hd ** -0.5, a8=a8, layer=1)
    args = (cos, sin, w1, w2, *ws)
    plain = [c.clone() for c in kv0]
    tl.decode_layer_fused_reference(x, *plain, lens, *args, **kw)
    kern = [c.clone() for c in kv0]
    before = tl.launches
    got = tl.decode_layer_fused(x, *kern, lens, *args, **kw)
    torch.cuda.synchronize()
    assert tl.launches == before + 1
    # FUSED_RTOL, or the few bf16 / int8 near-tie flips of the plain
    # version that explain a larger difference (chip_smoke.tie_check, the
    # rule of test_torch_ffn._check)
    import chip_smoke

    again = [c.clone() for c in kv0]
    err, rel, flips = chip_smoke.tie_check(
        "layer", got, lambda: tl.decode_layer_fused_reference(
            x, *again, lens, *args, **kw), FUSED_RTOL)
    print(f"rel err {rel:.3g} after {flips} near-tie flips")
    # the kernel's own q|k|v row, roped and rounded as the plain rope does
    own = [c.clone() for c in kv0]
    _, scratch = tl._layer_cuda(x, *own, lens, cos, sin, w1, w2, *ws, H, Hkv, hd,
                             "silu", "rmsnorm", 1e-5, hd ** -0.5, a8, 1)
    torch.cuda.synchronize()
    kvw = Hkv * hd
    qkvo = scratch["qkv"]
    rows = [tl.rope_rows(qkvo[hidden:hidden + kvw].reshape(Hkv, hd),
                         cos.reshape(-1), sin.reshape(-1)).to(dt),
            qkvo[hidden + kvw:hidden + 2 * kvw].reshape(Hkv, hd).to(dt)]
    rest = torch.ones(S, dtype=torch.bool, device=cuda)
    rest[length] = False
    for k_or_v in range(2):
        got_c, own_c, plain_c = kern[k_or_v], own[k_or_v], plain[k_or_v]
        assert torch.equal(got_c, own_c)  # the same launch twice
        assert torch.equal(got_c[0], kv0[k_or_v][0])  # the other layer
        assert torch.equal(got_c[1, :, rest], kv0[k_or_v][1, :, rest])
        assert torch.equal(got_c[1, 0, length], rows[k_or_v])  # bit-exact
        # against the plain version's row: its q|k|v sums run in another
        # order, so a bf16 element may round one step the other way, and
        # at a8 an int8 code of ln1's output on a tie moves every element
        # by up to a code's worth of the product (FUSED_RTOL of the max)
        d = (got_c[1, 0, length].float() - plain_c[1, 0, length].float()).abs()
        ref = plain_c[1, 0, length].float().abs()
        assert bool((d <= 2.0**-7 * ref + FUSED_RTOL * ref.max()).all())


def _serve_model(cuda, n_layers=2, hidden=1024, H=8, Hkv=4, F=1024,
                 vocab=512):
    """A small packed llama model on the card (4-bit g-1 linears, random)."""
    spec = tc.ArchSpec(arch="llama", n_layers=n_layers, hidden=hidden,
                       n_heads=H, n_kv_heads=Hkv, ffn=F, vocab=vocab,
                       max_pos=256, act="silu", pos="rope",
                       norm_type="rmsnorm", linear_bias=False)
    rng = np.random.default_rng(0)
    kvw = Hkv * (hidden // H)

    def lin(K, N):
        return {"w": _fusable(rng, 4, -1, K, N).to(cuda), "b": None}

    def ones():
        return {"w": torch.ones(hidden, device=cuda)}

    layers = [{"q": lin(hidden, hidden), "k": lin(hidden, kvw),
               "v": lin(hidden, kvw), "o": lin(hidden, hidden),
               "gate": lin(hidden, F), "up": lin(hidden, F),
               "down": lin(F, hidden), "ln1": ones(), "ln2": ones()}
              for _ in range(n_layers)]
    emb = torch.from_numpy((rng.normal(size=(vocab, hidden)) * 0.02).astype(
        np.float32)).to(cuda)
    return spec, {"embed": {"tokens": emb}, "layers": layers,
                  "final_ln": ones(), "lm_head": {"w": emb, "b": None}}


def _route(monkeypatch, route):
    monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", "on" if route == "layer"
                       else "off")
    return torch.bfloat16 if route == "layer" else torch.int8


@pytest.mark.parametrize("route", ["layer", "fused"])
def test_decode_step_captures_without_a_host_sync(cuda, monkeypatch, route):
    """One decode step with a device length, captured as a CUDA graph with
    torch.cuda.set_sync_debug_mode("error") on: the replay equals the
    eager step and writes the same cache."""
    from gptq_tpu_torch.ops import layer_fused as tl

    cache_dtype = _route(monkeypatch, route)
    spec, params = _serve_model(cuda)
    served = tc.fuse_serving(spec, params, a8=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, spec.vocab, size=(1, 5))).to(cuda)
    cache = tc.KVCache.init(spec, 1, 32, cache_dtype, device=cuda)
    logits, cache = tc.model_forward(spec, served, ids, cache)
    tok = logits[:, -1].argmax(-1)[:, None]

    def at5(c, clone):
        bufs = [None if t is None else (t.clone() if clone else t)
                for t in (c.k, c.v, c.k_scale, c.v_scale)]
        return tc.KVCache(bufs[0], bufs[1],
                          torch.tensor(5, dtype=torch.int32, device=cuda),
                          bufs[2], bufs[3])

    ref = at5(cache, clone=True)
    want, _ = tc.model_forward(spec, served, tok, ref)  # warms every kernel
    live = at5(cache, clone=False)
    torch.cuda.synchronize()
    before = (tl.launches, ta.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, new = tc.model_forward(spec, served, tok, live)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launched = (tl.launches - before[0], ta.launches - before[1])
    assert launched == ((2, 0) if route == "layer" else (0, 2))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(new.length) == 6
    for a, b in ((live.k, ref.k), (live.v, ref.v), (live.k_scale, ref.k_scale)):
        assert a is None and b is None or torch.equal(a, b)


@pytest.mark.parametrize("route,B", [("layer", 1), ("fused", 1), ("fused", 2)])
def test_generate_chained_replays_graphs(cuda, monkeypatch, route, B):
    """generate_chained's tokens equal generate's; a second call replays
    the captured chunks (no decode kernel launches from the host)."""
    from gptq_tpu_torch.engine.decode import DecodeEngine
    from gptq_tpu_torch.ops import layer_fused as tl

    cache_dtype = _route(monkeypatch, route)
    spec, params = _serve_model(cuda)
    eng = DecodeEngine(spec, params, max_len=64, batch=B,
                       cache_dtype=cache_dtype, a8=True)
    prompt = np.random.default_rng(2).integers(0, spec.vocab, size=(B, 6))
    want = eng.generate(prompt, 12)
    np.testing.assert_array_equal(eng.generate_chained(prompt, 12, chunk=5),
                                  want)
    before = (tl.launches, ta.launches)
    np.testing.assert_array_equal(eng.generate_chained(prompt, 12, chunk=5),
                                  want)
    assert (tl.launches, ta.launches) == before
    # sampling: a generator registered with the graphs, one seed twice
    draws = [eng.generate_chained(
        prompt, 9, chunk=4, temperature=0.8, top_k=8,
        generator=torch.Generator(device=cuda).manual_seed(3))
        for _ in range(2)]
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.fixture
def one_rank_group(cuda):
    """A one-rank NCCL process group (SPEngine at sp = 1)."""
    import socket

    import torch.distributed as dist

    own = not dist.is_initialized()
    if own:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    yield None
    if own:
        dist.destroy_process_group()


def _eager_ppl(eng, ids) -> float:
    """benchmark_chained's PPL step by step: the first sp ids prefill, each
    later id feeds one guarded step, whose NLL of the next id counts."""
    dev = eng.device
    logits, cache = eng.prefill(torch.as_tensor(ids[None, :eng.sp], device=dev))
    nll = []
    for i in range(eng.sp, len(ids) - 1):
        logits, cache = eng.step(cache, torch.tensor([[int(ids[i])]],
                                                     device=dev))
        lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
        nll.append(-float(lp[int(ids[i + 1])]))
    return float(np.exp(np.mean(nll)))


def test_sp_engine_graphs_replay_on_new_inputs(cuda, one_rank_group):
    """SPEngine's captured chains at sp = 1: generate's tokens equal step-
    by-step decoding, and a second benchmark_chained on other ids replays
    the first call's graphs (none is captured anew) and reports the PPL of
    its own ids, as an eager run gives it."""
    from gptq_tpu_torch.engine.serving import SPEngine

    spec, params = _serve_model(cuda)
    eng = SPEngine(spec, params, sp=1, max_len=128, cache_dtype=torch.int8,
                   fuse=True, a8=True, device=cuda)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, spec.vocab, size=(1, 7))
    got = eng.generate(prompt, 10, chunk=4)
    logits, cache = eng.prefill(torch.as_tensor(prompt, device=cuda))
    want = []
    for _ in range(10):
        tok = logits.argmax(-1)[:, None]
        want.append(int(tok))
        logits, cache = eng.step(cache, tok)
    assert got.tolist() == [want]
    n_graphs = None
    ppls = []
    for _ in range(2):
        ids = rng.integers(0, spec.vocab, size=24)
        r = eng.benchmark_chained(ids, check=True, warmup=1, reps=1,
                                  log=lambda s: None)
        if n_graphs is None:
            n_graphs = len(eng._graphs)
        assert len(eng._graphs) == n_graphs  # the second call replays
        eager = _eager_ppl(eng, ids)
        print(f"ppl chained {r['ppl']:.6g} eager {eager:.6g}")
        np.testing.assert_allclose(r["ppl"], eager, rtol=1e-4)
        ppls.append(eager)
    assert ppls[0] != ppls[1]
