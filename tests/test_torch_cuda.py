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


# the tensor cores from two rows up: the fewest, a whole 8-row MMA slab,
# and across one 128-row output tile
MMA_ROWS = [2, 8, 129, 300]


def _counted(module, mma):
    """The (CUDA-core, tensor-core) launch counts of #1 or #13 after one
    launch of the kernel named by `mma`, from the counts now."""
    before = (module.launches, module.mma_launches)
    return (before[0] + (not mma), before[1] + mma)


def _qmm_mma_expected(M, groupsize, a8):
    """#1 takes the tensor-core kernel from two rows up where its groups
    cover whole 128-byte stages (64 bf16 or 128 int8 K rows)."""
    stage = 128 if a8 else 64
    return M >= 2 and (groupsize == -1 or groupsize % stage == 0)


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (3, 128),
                                            (8, -1), (2, 16)])
@pytest.mark.parametrize("M", [1, 3, 70] + MMA_ROWS)
@pytest.mark.parametrize("a8", [False, True])
def test_qmm_kernel_matches_plain(cuda, bits, groupsize, M, a8):
    rng = np.random.default_rng(M + bits)
    pw = _packed(rng, bits, groupsize, 480, 200).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, 480)).astype(np.float32)).to(cuda)
    want_counts = _counted(tq, _qmm_mma_expected(M, groupsize, a8))
    got = tq.dequant_matmul(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert (tq.launches, tq.mma_launches) == want_counts
    want = tq.dequant_matmul_reference(x, pw, a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (3, 128), (8, -1)])
def test_qmm_mma_bf16_x(cuda, bits, groupsize):
    # bf16 x on the tensor cores: one MMA a k-step, the codes as 2^bits + c
    rng = np.random.default_rng(300 + bits)
    pw = _packed(rng, bits, groupsize, 1024, 384).to(cuda)
    x = torch.from_numpy(rng.normal(size=(300, 1024)).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    want_counts = _counted(tq, True)
    got = tq.dequant_matmul(x, pw)
    torch.cuda.synchronize()
    assert (tq.launches, tq.mma_launches) == want_counts
    want = tq.dequant_matmul_reference(x, pw)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    bound = 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("a8", [False, True])
def test_qmm_mma_k_past_the_last_stage(cuda, a8):
    # K = 544 is no multiple of a stage's 64 (a16) or 128 (a8) K rows: the
    # last stage loads zeros past Kp
    rng = np.random.default_rng(544)
    pw = _packed(rng, 4, -1, 544, 200).to(cuda)
    assert pw.Kp % 64 and pw.Kp % 128
    x = torch.from_numpy(rng.normal(size=(150, 544)).astype(np.float32)).to(
        cuda)
    want_counts = _counted(tq, True)
    got = tq.dequant_matmul(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert (tq.launches, tq.mma_launches) == want_counts
    want = tq.dequant_matmul_reference(x, pw, a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


def test_qmm_mma_8bit_a8(cuda):
    # the 8-bit field's stored code - 128 meets int8 x in the s8 MMA; the
    # fold adds 128 * xsum back
    rng = np.random.default_rng(8)
    pw = _packed(rng, 8, 128, 1024, 256).to(cuda)
    x = torch.from_numpy(rng.normal(size=(256, 1024)).astype(np.float32)).to(
        cuda)
    want_counts = _counted(tq, True)
    got = tq.dequant_matmul(x, pw, a8=True)
    torch.cuda.synchronize()
    assert (tq.launches, tq.mma_launches) == want_counts
    want = tq.dequant_matmul_reference(x, pw, a8=True)
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
@pytest.mark.parametrize("M", [1, 3, 70] + MMA_ROWS)
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_bcq_kernel_matches_plain(cuda, bits, groupsize, M, act):
    rng = np.random.default_rng(M * 7 + bits + groupsize)
    pw = _bcq(rng, bits, groupsize, 512, 200).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32)).to(cuda)
    if act == "bf16":
        x = x.to(torch.bfloat16)
    a8 = act == "a8"
    # #13's tensor-core kernel takes every group length here
    want_counts = _counted(tbm, M >= 2)
    got = tbm.bcq_matmul(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert (tbm.launches, tbm.mma_launches) == want_counts
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


# the single-row kernels of #1 and #13 (csrc/gemv.cuh): a chunk's K pieces
# are one cluster, summed in piece order by its rank 0
# w3g32: a 1-bit field's group of one word row, so a warp's rows of a
# stage span four groups (one grid row each)
_GEMV_WEIGHTS = {"w4g-1": (4, -1), "w3g128": (3, 128), "w8g-1": (8, -1),
                 "w3g32": (3, 32), "bcq3g128": (3, 128), "bcq2g-1": (2, -1)}


def _gemv_case(cuda, fmt, act, K, N, seed):
    """(module, wrapper, plain, weight, x, a8) of one single-row case."""
    rng = np.random.default_rng(seed)
    bits, gs = _GEMV_WEIGHTS[fmt]
    bcq = fmt.startswith("bcq")
    pw = (_bcq if bcq else _packed)(rng, bits, gs, K, N).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)).to(cuda)
    if act == "bf16":
        x = x.to(torch.bfloat16)
    if bcq:
        return tbm, tbm.bcq_matmul, tbm.bcq_matmul_reference, pw, x, act == "a8"
    return (tq, tq.dequant_matmul, tq.dequant_matmul_reference, pw, x,
            act == "a8")


def _near(got, want, act):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if act == "bf16":  # a bf16 output may round one bf16 step apart
        bound = 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= bound)
    else:
        _close(got, want, rtol=1e-4)


@pytest.mark.parametrize("fmt", list(_GEMV_WEIGHTS))
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_single_row_two_launches_bit_equal(cuda, fmt, act):
    # K = 11264 cut into pieces: two launches sum them in the same order
    mod, fn, plain, pw, x, a8 = _gemv_case(cuda, fmt, act, 11264, 512, 31)
    before = mod.launches
    first, second = fn(x, pw, a8=a8), fn(x, pw, a8=a8)
    torch.cuda.synchronize()
    assert mod.launches == before + 2
    assert torch.equal(first, second)
    _near(first, plain(x, pw, a8=a8), act)


@pytest.mark.parametrize("fmt", ["w4g-1", "w3g128", "bcq3g128"])
def test_single_row_narrow_weight(cuda, fmt):
    # 2 chunks of 128 columns: far fewer than the SMs, so each chunk is cut
    # into 8 pieces (a cluster of 8 blocks)
    mod, fn, plain, pw, x, a8 = _gemv_case(cuda, fmt, "a8", 4096, 256, 32)
    sb = tpack.subblock(pw.Kp, pw.groupsize)
    fbmin = 1 if pw.bits == 3 or mod is tbm else pw.bits
    assert tq.gemv_splits(pw.Kp, pw.Np, sb, fbmin, 1,
                          torch.cuda.get_device_properties(
                              cuda).multi_processor_count) == 8
    _near(fn(x, pw, a8=a8), plain(x, pw, a8=a8), "a8")


@pytest.mark.parametrize("fmt", ["w4g-1", "bcq3g128"])
@pytest.mark.parametrize("act", ["bf16", "a8"])
def test_single_row_replays_in_a_cuda_graph(cuda, fmt, act):
    # captured once, replayed on new x: the same bits as an eager launch
    mod, fn, plain, pw, x, a8 = _gemv_case(cuda, fmt, act, 4096, 4096, 33)
    fn(x, pw, a8=a8)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fn(x, pw, a8=a8)
    rng = np.random.default_rng(34)
    for _ in range(2):
        x.copy_(torch.from_numpy(rng.normal(size=(1, 4096)).astype(
            np.float32)).to(x.dtype))
        graph.replay()
        want = fn(x, pw, a8=a8)
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        _near(y, plain(x, pw, a8=a8), act)


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


@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_attention_kernel_lengths_on_tile_and_split_edges(cuda, cache):
    """#3's decode mode lists the slots t < len of each row's 32-slot tiles
    j, j + nsplit, ... (nsplit from ta.partial_grid: 5 here): lengths on
    and next to tile edges and whole split rounds, one row empty."""
    S, H, Hkv, hd = 512, 8, 4, 128
    lens = [1, 31, 32, 33, 160, 161, 512, 0]
    B = len(lens)
    assert ta.partial_grid(B, Hkv, H // Hkv, S, 132)[1] == 5
    rng = np.random.default_rng(61)
    k, v, ks, vs = _cache(rng, (B,), S, Hkv, hd, cache == "int8")
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    k_, v_ = (torch.from_numpy(a).to(cuda).to(dt) for a in (k, v))
    ks_, vs_ = (None if a is None else torch.from_numpy(a).to(cuda)
                for a in (ks, vs))
    q_, fk_, fv_ = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda) for shape in ((B, H, hd), (B, Hkv, hd),
                                            (B, Hkv, hd)))
    lens_ = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for fk, fv in ((fk_, fv_), (None, None)):
        kw = dict(k_scale=ks_, v_scale=vs_, fresh_k=fk, fresh_v=fv)
        got = ta.decode_attention(q_, k_, v_, lens_, 0.09, **kw)
        want = ta.decode_attention_reference(q_, k_, v_, lens_, 0.09, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)
        if fk is None:
            assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("B", [1, 4])
def test_attention_kernel_long_gqa4(cuda, B):
    """#3 at Mixtral's head layout (32 query heads on 8 kv heads: G = 4,
    the heads split over blocks) over a 2048-slot int8 cache."""
    S, H, Hkv, hd = 2048, 32, 8, 128
    rng = np.random.default_rng(62 + B)
    k, v, ks, vs = _cache(rng, (2, B), S, Hkv, hd, True)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(size=(B, H, hd)).astype(np.float32), k, v)]
    lens = torch.from_numpy(rng.integers(1000, S + 1, size=B).astype(
        np.int32)).to(cuda)
    kw = dict(k_scale=torch.from_numpy(ks).to(cuda),
              v_scale=torch.from_numpy(vs).to(cuda), layer=1,
              fresh_k=torch.from_numpy(rng.normal(size=(B, Hkv, hd)).astype(
                  np.float32)).to(cuda),
              fresh_v=torch.from_numpy(rng.normal(size=(B, Hkv, hd)).astype(
                  np.float32)).to(cuda))
    before = ta.launches
    got = ta.decode_attention(*args, lens, 0.088, **kw)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    want = ta.decode_attention_reference(*args, lens, 0.088, **kw)
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


@pytest.mark.parametrize("B,S,Hkv,valid", [
    (1, 2048, 32, 1100),   # llama-7B: 5 splits of <= 13 tiles
    (1, 8192, 8, 5000),    # 16 tiles a split
    (5, 300, 32, 300),     # 160 blocks: one split, no combine
])
def test_partial_attention_kernel_split_sizes(cuda, B, S, Hkv, valid):
    """The partial kernel over the grids partial_grid gives: many
    tiles a split, the most a split takes, and a single split."""
    rng = np.random.default_rng(S + B)
    H, hd = 32, 128
    k, v, ks, vs = _cache(rng, (B,), S, Hkv, hd, True)
    pos = np.full(S, -1, np.int32)
    pos[:valid] = np.arange(valid)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(size=(B, H, hd)).astype(np.float32), k, v, pos)]
    kw = dict(k_scale=torch.from_numpy(ks).to(cuda),
              v_scale=torch.from_numpy(vs).to(cuda))
    got = ta.decode_attention_partial_wide(*args, 0.09, **kw)
    torch.cuda.synchronize()
    _partial_check(got, ta.decode_attention_partial_wide_reference(
        *args, 0.09, **kw))


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
    mma = tq.expert_route(M, bits, groupsize, x.dtype, pe.Kp, pe.Np) == "mma"
    assert mma == (bits != 3)  # 3-bit g128: 128-row subblocks, "shallow"
    before = (tq.expert_launches, tq.expert_mma_launches)
    got = tq.expert_dequant_matmul(x, pe)
    torch.cuda.synchronize()
    assert (tq.expert_launches, tq.expert_mma_launches) == (
        before[0] + (not mma), before[1] + mma)
    assert got.shape == (4, M, 200) and got.dtype == torch.float32
    want = tq.expert_dequant_matmul_reference(x, pe)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("bits,groupsize,K,N", [(4, -1, 2048, 512),
                                                (4, 128, 2048, 512),
                                                (3, -1, 2048, 256),
                                                (8, 64, 1024, 256)])
@pytest.mark.parametrize("M", [2, 16, 32])
@pytest.mark.parametrize("act", ["f32", "bf16", "int8"])
def test_expert_kernels_both_routes_and_k_splits(cuda, bits, groupsize, K, N,
                                                 M, act):
    """The tensor-core #8 and the CUDA-core one on the same banks, per
    expert x (the down bank's form): few column tiles, so the tensor-core
    kernel splits K (ops/qmatmul.expert_splits) and the last split of a
    tile sums the partials; a second launch gives the same bits."""
    rng = np.random.default_rng(K + N + M + bits)
    pe = _bank(rng, bits, groupsize, K, N, E=8).to(cuda)
    x = _acts(rng, (8, M, K), act, cuda)
    sb = tpack.subblock(pe.Kp, groupsize)
    nk = pe.Kp * (1 if bits == 3 else bits) // (32 * tq.expert_window(bits, sb))
    assert tq.expert_splits(8, pe.Np, nk, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    want = tq.expert_dequant_matmul_reference(x, pe).cpu().numpy()
    got = tq._expert_cuda(x, pe, route="mma")
    again = tq._expert_cuda(x, pe, route="mma")
    loop = tq._expert_cuda(x, pe, route="shallow")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got[..., :pe.N].cpu().numpy(), want, rtol=1e-4)
    _close(loop[..., :pe.N].cpu().numpy(), want, rtol=1e-4)


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


# the single-row kernels of #5 / #6 (mlp_stream_kernel) and #9
# (qsel_gemv_kernel) against their plain versions and the kernels they
# replaced at one row (forced by route)
@pytest.mark.parametrize("kind,tag", [("attn_mlp", "w4g-1"),
                                      ("attn_mlp", "w4g128"),
                                      ("attn_mlp", "w3g128"),
                                      ("ffn", "w4g-1"), ("ffn", "w3g128")])
@pytest.mark.parametrize("a8", [False, True])
def test_mlp_stream_matches_plain_and_tiles(cuda, kind, tag, a8):
    """At one row the route takes the stream; it agrees with the plain
    version and with the tiled kernel, two launches give the same bits,
    and the barrier and ticket words are left clean."""
    from gptq_tpu_torch.ops import layer_fused as tl

    bits, groupsize = {"w4g-1": (4, -1), "w4g128": (4, 128),
                       "w3g128": (3, 128)}[tag]
    rng = np.random.default_rng(bits * 10 + a8 + len(kind))
    H, F = 1024, 2816  # gate|up's half: 22 chunks; o and down cut in K
    o = _fusable(rng, bits, groupsize, H, H).to(cuda)
    gu = _fusable(rng, bits, groupsize, H, F, parts=2).to(cuda)
    dn = _fusable(rng, bits, groupsize, F, H).to(cuda)
    attn, xres = (torch.from_numpy(rng.normal(size=(1, H)).astype(np.float32))
                  .to(cuda) for _ in range(2))
    w2 = _vec(rng, H, cuda, base=1.0)
    if kind == "attn_mlp":
        args = (attn, xres, w2, o, gu, dn)
        run, plain = tf.attn_mlp_fused, tf.attn_mlp_fused_reference
        kern = (attn, xres, w2, o, gu, dn, "silu", "rmsnorm", 1e-5, True, a8,
                None, None, None, None)
    else:
        args = (attn, gu, dn)
        run, plain = tf.ffn_fused, tf.ffn_fused_reference
        kern = (attn, None, None, None, gu, dn, "silu", "rmsnorm", 0.0, True,
                a8, None, None, None, None)
    assert tf.mlp_route(1, o if kind == "attn_mlp" else None, gu, dn,
                        a8) == "stream"
    count = "attn_mlp_launches" if kind == "attn_mlp" else "ffn_launches"
    before = getattr(tf, count)
    got = run(*args, a8=a8)
    torch.cuda.synchronize()
    assert getattr(tf, count) == before + 1
    want = plain(*args, a8=a8)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)
    tiles = tf._mlp_cuda(*kern, route="tiles")
    stream = tf._mlp_cuda(*kern, route="stream")
    again = tf._mlp_cuda(*kern, route="stream")
    torch.cuda.synchronize()
    _close(stream.cpu().numpy(), tiles.cpu().numpy(), rtol=FUSED_RTOL)
    assert torch.equal(stream, again) and tl.sync_clean(cuda)


# #4 at one row: norm_qkv_gemv_kernel (csrc/gemv.cuh) at the main path's
# shapes: llama-7B ln1 + q|k|v (w4 g-1 and g128), Mixtral's (8 KV heads)
# and the 8-bit head
@pytest.mark.parametrize("K,N,bits,groupsize", [
    (4096, 12288, 4, -1), (4096, 12288, 4, 128), (4096, 6144, 4, -1),
    (4096, 32256, 8, -1)])
@pytest.mark.parametrize("a8", [False, True])
def test_norm_qkv_stream_matches_plain_and_tiles(cuda, K, N, bits, groupsize,
                                                 a8):
    """At one row the route takes the stream; it agrees with the plain
    version and with the tiled kernel it replaced there (forced), and two
    launches give the same bits; the tiled kernel, forced at one row,
    still holds to the plain version."""
    rng = np.random.default_rng(N + bits + a8)
    pw = _fusable(rng, bits, groupsize, K, N).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)).to(cuda)
    w1 = _vec(rng, K, cuda, base=1.0)
    b = _vec(rng, pw.Np, cuda)
    assert tf.norm_qkv_route(1, pw) == "stream"
    assert tf.norm_qkv_route(2, pw) == "rows"
    before = tf.norm_qkv_launches
    got = tf.norm_qkv_fused(x, w1, pw, a8=a8, b_qkv=b)
    torch.cuda.synchronize()
    assert tf.norm_qkv_launches == before + 1
    want = tf.norm_qkv_fused_reference(x, w1, pw, a8=a8, b_qkv=b)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)
    x2 = x.to(torch.bfloat16).float()
    kern = (x2, w1, pw, "rmsnorm", 1e-5, a8, None, b)
    stream = tf._norm_qkv_cuda(*kern, route="stream")
    again = tf._norm_qkv_cuda(*kern, route="stream")
    tiles = tf._norm_qkv_cuda(*kern, route="tiles")
    torch.cuda.synchronize()
    assert torch.equal(stream, again)
    assert torch.equal(stream, got)
    _close(tiles.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)
    _close(stream.cpu().numpy(), tiles.cpu().numpy(), rtol=FUSED_RTOL)


@pytest.mark.parametrize("norm,bits,groupsize", [
    ("rmsnorm1p", 3, 128), ("layernorm", 8, 128), ("rmsnorm", 2, -1)])
@pytest.mark.parametrize("a8", [False, True])
def test_norm_qkv_stream_norms_and_narrow_weights(cuda, norm, bits, groupsize,
                                                  a8):
    """The stream's other norms (with b_ln), 3- and 2-bit weights and a
    stored width of one chunk; a CUDA graph replays it on new x."""
    rng = np.random.default_rng(bits * 5 + a8)
    pw = _fusable(rng, bits, groupsize, 1024, 128).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, 1024)).astype(np.float32)).to(
        cuda)
    kw = dict(norm=norm, eps=1e-5, a8=a8, b_qkv=_vec(rng, pw.Np, cuda),
              b_ln=_vec(rng, 1024, cuda) if norm == "layernorm" else None)
    w1 = _vec(rng, 1024, cuda, base=0.0 if norm == "rmsnorm1p" else 1.0)
    assert tf.norm_qkv_route(1, pw) == "stream"
    got = tf.norm_qkv_fused(x, w1, pw, **kw)
    want = tf.norm_qkv_fused_reference(x, w1, pw, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tf.norm_qkv_fused(x, w1, pw, **kw)
    x.copy_(torch.from_numpy(rng.normal(size=(1, 1024)).astype(np.float32)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tf.norm_qkv_fused(x, w1, pw, **kw))


# #7 at one row: the streamed route launches #1's single-row stream
@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (2, 256),
                                            (8, -1)])
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_streamed_single_row_takes_the_gemv_stream(cuda, monkeypatch, bits,
                                                   groupsize, act):
    """At M = 1 the streamed route gives #1's single-row bits (the same
    kernel and cut), at rows 2 .. 8 those of qstream_kernel forced, each
    within 1e-4 of the plain version (bf16 x: both outputs round to bf16,
    so within one bf16 step, 2^-7 of the value, and 1e-4 of the row's
    largest); a profiler trace of three calls
    names qgemv_kernel at one row and qstream_kernel at rows 2 .. 8."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(bits * 3 + groupsize + len(act))
    pw = _packed(rng, bits, groupsize, 4096, 4096).to(cuda)
    pw = dataclasses.replace(pw, perm=None, bias=None)
    a8 = act == "a8"
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "streamed")
    for M, new, old in ((1, "qgemv_kernel<", "qstream_kernel<"),
                        (3, "qstream_kernel<", "qgemv_kernel<"),
                        (8, "qstream_kernel<", "qgemv_kernel<")):
        x = torch.from_numpy(rng.normal(size=(M, 4096)).astype(
            np.float32)).to(cuda)
        if act == "bf16":
            x = x.to(torch.bfloat16)
        tq.dequant_matmul(x, pw, a8=a8)  # warm
        torch.cuda.synchronize()
        before = tq.stream_launches
        # three launches in the trace: CUPTI can drop one kernel record
        # (seen on an H100 at this test's bf16 4-bit g128 row: the trace
        # held an "Activity Buffer Request" and no qgemv_kernel, while the
        # counter rose by one)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                got = tq.dequant_matmul(x, pw, a8=a8)
            torch.cuda.synchronize()
        assert tq.stream_launches == before + 3
        names = " ".join(e.key for e in prof.key_averages())
        if "kernel" in names:  # the trace holds device events
            assert new in names and old not in names, names
        want = tq.dequant_matmul_reference(x, pw, a8=a8)
        if act == "bf16":
            w, g = want.float().cpu().numpy(), got.float().cpu().numpy()
            bound = 2.0 ** -7 * np.abs(w) + 1e-4 * np.abs(w).max()
            assert np.all(np.abs(g - w) <= bound)
        else:
            _close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
        x2, _ = tq._prepare(x, pw, a8)
        assert torch.equal(tq._stream_cuda(x2, pw),
                           tq._qmm_cuda(x2, pw) if M == 1
                           else tq._stream_cuda(x2, pw, route="tiles"))


def test_mlp_stream_failed_launch_retires_its_words(cuda, monkeypatch):
    """A stream launch whose check raises retires its stream's barrier and
    ticket words: the next launch takes fresh zero ones and gives the bits
    an eager launch on a clean stream gives."""
    from gptq_tpu_torch.ops import layer_fused as tl

    rng = np.random.default_rng(82)
    o = _fusable(rng, 4, -1, 1024, 1024).to(cuda)
    gu = _fusable(rng, 4, -1, 1024, 1536, parts=2).to(cuda)
    dn = _fusable(rng, 4, -1, 1536, 1024).to(cuda)
    attn, xres = (torch.from_numpy(rng.normal(size=(1, 1024)).astype(
        np.float32)).to(cuda) for _ in range(2))
    w2 = _vec(rng, 1024, cuda, base=1.0)
    want = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    old = tl._sync_words(1, cuda, stream)

    class Refused:  # a launch that CUDA refuses
        @staticmethod
        def mlp_stream_launch(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(tf, "_lib", lambda: Refused)
    with pytest.raises(RuntimeError, match="mlp_stream_launch"):
        tf.attn_mlp_fused(attn, xres, w2, o, gu, dn)
    monkeypatch.undo()
    got = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn)
    torch.cuda.synchronize()
    assert tl._sync_words(1, cuda, stream).data_ptr() != old.data_ptr()
    assert torch.equal(got, want) and tl.sync_clean(cuda)


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (3, 128),
                                            (8, -1)])
@pytest.mark.parametrize("act", ["f32", "bf16", "int8"])
def test_select_single_row_matches_plain_and_rows(cuda, bits, groupsize, act):
    """At one row #9 takes the single-row kernel over the selected expert
    (the first and the last of the bank, chunks cut in K): it agrees with
    the plain version and with the row kernel it replaced, two launches
    give the same bits, and a CUDA graph replays it on a new index."""
    rng = np.random.default_rng(bits * 31 + groupsize + len(act))
    E, K, N = 4, 2048, 520
    pe = _bank(rng, bits, groupsize, K, N, E=E).to(cuda)
    x = _acts(rng, (1, K), act, cuda)
    assert tq.select_route(1, pe.Np) == "single_row"
    for e in (0, E - 1):
        idx = torch.tensor([e], dtype=torch.int32, device=cuda)
        got = tq._select_cuda(x, pe, idx)
        again = tq._select_cuda(x, pe, idx)
        rows = tq._select_cuda(x, pe, idx, route="rows")
        torch.cuda.synchronize()
        want = tq.expert_dequant_matmul_select_reference(x, pe, idx)
        _close(got[:, :N].cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
        _close(got.cpu().numpy(), rows.cpu().numpy(), rtol=1e-4)
        assert torch.equal(got, again)
    idx = torch.tensor([0], dtype=torch.int32, device=cuda)
    tq._select_cuda(x, pe, idx)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq._select_cuda(x, pe, idx)
    idx.fill_(E - 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tq._select_cuda(x, pe, idx))
    idx.fill_(E)  # outside the bank: NaN, every cluster leaves cleanly
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isnan(out).all()


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

def _layer_weights(rng, cuda, hidden, Hkv, hd, F, bits=4, groupsize=-1):
    """q|k|v (hidden x (hidden + 2 Hkv hd)), o, gate|up and down."""
    kvw = Hkv * hd
    qkv = tpack.fuse_packed([_fusable(rng, bits, groupsize, hidden, n)
                             for n in (hidden, kvw, kvw)])
    return [w.to(cuda) for w in (
        qkv, _fusable(rng, bits, groupsize, hidden, hidden),
        _fusable(rng, bits, groupsize, hidden, F, parts=2),
        _fusable(rng, bits, groupsize, F, hidden))]


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


def _layer_case(cuda, rng, bits, groupsize, S, hidden=1024, H=8, Hkv=4,
                F=1536):
    """A layer the layer route admits (layer_fusable) and its inputs."""
    from gptq_tpu_torch.ops import layer_fused as tl

    hd = hidden // H
    ws = _layer_weights(rng, cuda, hidden, Hkv, hd, F, bits, groupsize)
    kvw = Hkv * hd

    class _Splits:
        parts = ((hidden, hidden), (kvw, kvw), (kvw, kvw))

    assert tl.layer_fusable(ws[0], _Splits, *ws[1:], hidden, H, Hkv)
    spec = tc.ArchSpec(arch="llama", n_layers=2, hidden=hidden, n_heads=H,
                       n_kv_heads=Hkv, ffn=F, vocab=8, max_pos=S, pos="rope")
    x = torch.from_numpy(rng.normal(size=(1, 1, hidden)).astype(np.float32)
                         ).to(cuda)
    w1, w2 = _vec(rng, hidden, cuda, base=1.0), _vec(rng, hidden, cuda,
                                                     base=1.0)
    kv0 = [torch.from_numpy(rng.normal(size=(2, 1, S, Hkv, hd)).astype(
        np.float32)).to(cuda).to(torch.bfloat16) for _ in range(2)]
    kw = dict(n_heads=H, n_kv_heads=Hkv, sm_scale=hd ** -0.5, layer=1)
    return spec, ws, x, w1, w2, kv0, kw


@pytest.mark.parametrize("bits,groupsize,F", [
    (3, -1, 1472),  # gate|up's half not a whole number of 128-column chunks
    (4, 128, 1536), (3, 128, 1536)])
@pytest.mark.parametrize("a8", [False, True])
def test_layer_kernel_3bit_and_grouped_long(cuda, bits, groupsize, F, a8):
    """#12 on the 3-bit (two fields) and g128 weights layer_fusable admits,
    over a 2048-slot bf16 cache with 1,100 filled; two launches on the
    same inputs give the same bits."""
    from gptq_tpu_torch.ops import layer_fused as tl
    import chip_smoke

    rng = np.random.default_rng(70 + bits + (groupsize > 0) + 5 * a8)
    S, length = 2048, 1100
    spec, ws, x, w1, w2, kv0, kw = _layer_case(cuda, rng, bits, groupsize, S,
                                               F=F)
    lens = torch.tensor(length, dtype=torch.int32, device=cuda)
    cos, sin = tc.rope_tables(spec, lens.reshape(1, 1))
    args = (cos, sin, w1, w2, *ws)
    runs = []
    for _ in range(2):
        kern = [c.clone() for c in kv0]
        runs.append((tl.decode_layer_fused(x, *kern, lens, *args, a8=a8, **kw),
                     kern))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    plain = [c.clone() for c in kv0]
    err, rel, flips = chip_smoke.tie_check(
        "layer", runs[0][0], lambda: tl.decode_layer_fused_reference(
            x, *plain, lens, *args, a8=a8, **kw), FUSED_RTOL)
    print(f"rel err {rel:.3g} after {flips} near-tie flips")
    rest = torch.ones(S, dtype=torch.bool, device=cuda)
    rest[length] = False
    for got_c, c0 in zip(runs[0][1], kv0):
        assert torch.equal(got_c[:, :, rest], c0[:, :, rest])


def test_layer_kernel_graph_replays_at_two_lengths(cuda):
    """#12 captured once in a CUDA graph over a device length: replays at
    two lengths equal eager launches (its barrier and ticket counters are
    never reset from the host) and write their own slot; the counters end
    at zero."""
    from gptq_tpu_torch.ops import layer_fused as tl

    rng = np.random.default_rng(80)
    S = 512
    spec, ws, x, w1, w2, kv0, kw = _layer_case(cuda, rng, 4, -1, S)
    lens = torch.tensor(100, dtype=torch.int32, device=cuda)
    cos, sin = tc.rope_tables(spec, lens.reshape(1, 1))
    args = (cos, sin, w1, w2, *ws)
    live = [c.clone() for c in kv0]
    tl.decode_layer_fused(x, *live, lens, *args, a8=True, **kw)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = tl.decode_layer_fused(x, *live, lens, *args, a8=True, **kw)
    for length in (137, 300):
        lens.fill_(length)
        for c, c0 in zip(live, kv0):
            c.copy_(c0)
        graph.replay()
        eager = [c.clone() for c in kv0]
        want = tl.decode_layer_fused(x, *eager, lens, *args, a8=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert all(torch.equal(a, b) for a, b in zip(live, eager))
        assert not torch.equal(live[0][1, 0, length], kv0[0][1, 0, length])
    # the replays and eager launches each left the barrier and ticket words
    # of their stream zero (but the barrier's generation)
    assert tl.sync_clean(cuda)


def test_layer_kernel_failed_launch_retires_its_words(cuda, monkeypatch):
    """A launch whose check raises retires its stream's barrier and ticket
    words: the next launch on that stream takes fresh zero ones and runs
    as an eager launch on a clean stream does."""
    from gptq_tpu_torch.ops import layer_fused as tl

    rng = np.random.default_rng(81)
    spec, ws, x, w1, w2, kv0, kw = _layer_case(cuda, rng, 4, -1, 256)
    lens = torch.tensor(60, dtype=torch.int32, device=cuda)
    cos, sin = tc.rope_tables(spec, lens.reshape(1, 1))
    args = (cos, sin, w1, w2, *ws)
    want = tl.decode_layer_fused(x, *[c.clone() for c in kv0], lens, *args,
                                 a8=True, **kw)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    old = tl._sync_words(1, cuda, stream)
    real = tl._lib()

    class Refused:  # a launch that the driver refuses
        layer_maps = real.layer_maps

        @staticmethod
        def layer_launch(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(tl, "_lib", lambda: Refused)
    with pytest.raises(RuntimeError, match="layer_launch"):
        tl.decode_layer_fused(x, *[c.clone() for c in kv0], lens, *args,
                              a8=True, **kw)
    monkeypatch.undo()
    got = tl.decode_layer_fused(x, *[c.clone() for c in kv0], lens, *args,
                                a8=True, **kw)
    torch.cuda.synchronize()
    assert tl._sync_words(1, cuda, stream).data_ptr() != old.data_ptr()
    assert torch.equal(got, want) and tl.sync_clean(cuda)


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


def _single_row_model(cuda, route):
    """A small model whose decode step launches #1 or #13 at one row (the
    unfused route's packed linears, BCQ's sign planes) or the MoE layer's
    selections (#9) beside #1 (its dense attention linears packed)."""
    if route != "moe":
        spec, params = _serve_model(cuda)
        if route == "bcq":
            rng = np.random.default_rng(5)
            for lp in params["layers"]:
                for k in ("q", "k", "v", "o", "gate", "up", "down"):
                    w = lp[k]["w"]
                    pw = _bcq(rng, 3, 128, w.K, w.N)
                    pw.perm, pw.bias = None, None
                    lp[k]["w"] = pw.to(cuda)
        return spec, params
    spec = tc.ArchSpec(arch="llama", n_layers=2, hidden=512, n_heads=4,
                       n_kv_heads=2, ffn=1024, vocab=128, max_pos=64,
                       act="silu", pos="rope", norm_type="rmsnorm",
                       linear_bias=False, n_experts=8, expert_top_k=2,
                       expert_capacity=4.0)
    params = tc.init_params(spec, seed=0, device=cuda)
    tm.pack_experts(params, bits=4)
    rng = np.random.default_rng(6)
    kvw = spec.kv_heads * spec.hd
    for lp in params["layers"]:
        for k, n in (("q", 512), ("k", kvw), ("v", kvw), ("o", 512)):
            lp[k] = {"w": _fusable(rng, 4, -1, 512, n).to(cuda), "b": None}
    return spec, params


@pytest.mark.parametrize("route", ["unfused", "bcq", "moe"])
def test_generate_chained_single_row_routes(cuda, monkeypatch, route):
    """generate_chained's tokens equal generate's where the step launches
    the single-row kernels (the MoE step: no host sync inside its
    captured graphs); a second call replays them, launching nothing."""
    from gptq_tpu_torch.engine.decode import DecodeEngine

    monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", "off")
    if route == "unfused":
        monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", "off")
    spec, params = _single_row_model(cuda, route)
    eng = DecodeEngine(spec, params, max_len=64, batch=1,
                       cache_dtype=torch.int8, a8=True)
    prompt = np.random.default_rng(2).integers(0, spec.vocab, size=(1, 6))
    want = eng.generate(prompt, 12)
    mod = tbm if route == "bcq" else tq
    before = mod.launches
    np.testing.assert_array_equal(eng.generate_chained(prompt, 12, chunk=5),
                                  want)
    assert mod.launches > before  # captured
    before = (tq.launches, tbm.launches, tq.select_launches)
    np.testing.assert_array_equal(eng.generate_chained(prompt, 12, chunk=5),
                                  want)
    assert (tq.launches, tbm.launches, tq.select_launches) == before


def test_generate_chained_takes_the_new_single_row_kernels(cuda, monkeypatch):
    """generate_chained equals generate on the fused route, whose decode
    step launches #5 on the weight stream, and on a 2-layer MoE model,
    whose step launches #9's single-row kernel: a profiler trace of one
    eager step names mlp_stream_kernel and qsel_gemv_kernel, and neither
    kernel they replaced at one row."""
    from torch.profiler import ProfilerActivity, profile

    from gptq_tpu_torch.engine.decode import DecodeEngine

    monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", "off")
    for route in ("fused", "moe"):
        if route == "fused":
            spec, params = _serve_model(cuda)
        else:
            spec, params = _single_row_model(cuda, "moe")
        eng = DecodeEngine(spec, params, max_len=64, batch=1,
                           cache_dtype=torch.int8, a8=True)
        prompt = np.random.default_rng(4).integers(0, spec.vocab, size=(1, 6))
        want = eng.generate(prompt, 10)
        np.testing.assert_array_equal(eng.generate_chained(prompt, 10,
                                                           chunk=4), want)
        logits, cache = eng.prefill(torch.as_tensor(prompt, device=cuda))
        tok = logits.argmax(-1)[:, None]
        eng.step(cache, tok)  # warm
        torch.cuda.synchronize()
        before = (tf.norm_qkv_launches, tf.attn_mlp_launches,
                  tq.select_launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.step(cache, tok)
            torch.cuda.synchronize()
        # the step's launches: ln1 + q|k|v a layer (the head is dense), and
        # the fused MLP a layer or top-2 x (gate, up, down) selections
        L = spec.n_layers
        assert (tf.norm_qkv_launches - before[0],
                tf.attn_mlp_launches - before[1],
                tq.select_launches - before[2]) == (
            (L, L, 0) if route == "fused" else (L, 0, 6 * L))
        names = " ".join(e.key for e in prof.key_averages())
        pairs = ([("mlp_stream_kernel<", "mlp_kernel<"),
                  ("norm_qkv_gemv_kernel<", "norm_qkv_kernel<")]
                 if route == "fused"
                 else [("qsel_gemv_kernel<", "qsel_kernel<")])
        if "kernel" in names:  # the trace holds device events
            for new, old in pairs:
                assert new in names and old not in names, names


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


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_batcher_window_graph_equals_stepwise(cuda, monkeypatch, cache_dtype):
    """ContinuousBatcher.run(window=4) (one CUDA graph of 4 lock-steps,
    replayed across refills) gives run(window=1)'s tokens, at 8 slots with
    mid-window finishes; the second batcher's windows replay one graph, so
    the decode kernels launch from the host only at its capture."""
    from gptq_tpu_torch.engine.batching import ContinuousBatcher
    from gptq_tpu_torch.ops import ffn as tf_

    monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", "off")
    spec, params = _serve_model(cuda)
    served = tc.fuse_serving(spec, params, a8=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, spec.vocab, size=(int(n),))
               for n in rng.integers(3, 30, size=13)]
    news = rng.integers(2, 11, size=13)

    def serve(window):
        cb = ContinuousBatcher(spec, served, batch_slots=8, max_len=64,
                               cache_dtype=cache_dtype,
                               prefill_buckets=(8, 16, 32))
        for p, n in zip(prompts, news):
            cb.submit(p, max_new_tokens=int(n))
        launches = tf_.norm_qkv_launches
        out = [r.output for r in cb.run(window=window)]
        return out, tf_.norm_qkv_launches - launches, cb

    want, _, _ = serve(1)
    got, n_launch, cb = serve(4)
    assert got == want
    assert list(cb._graphs) == [4]
    # the warm step and the capture: (L + 1) launches each, and none from
    # the replays; the prefills of <= 32 rows add theirs
    prefill_rows = n_launch - 2 * (spec.n_layers + 1)
    assert 0 <= prefill_rows <= cb.prefill_calls * (spec.n_layers + 1)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_per_slot_scatter_equals_its_plain_form(cuda, dtype):
    """_write_slots with a (B,) start on a stacked (L, B, S, kvh, hd)
    cache: one scatter, equal to writing each slot's row at its own length
    in a loop; captured in a CUDA graph, it replays at new lengths."""
    L, B, S, Hkv, hd = 3, 5, 16, 2, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    buf = (torch.randint(-127, 128, (L, B, S, Hkv, hd), generator=g,
                         device=cuda).to(dtype))
    lens = torch.tensor([0, 7, 15, 3, 7], dtype=torch.int32, device=cuda)

    def rows():
        return torch.randn((L, B, 1, Hkv, hd), generator=g,
                           device=cuda).to(dtype)

    def plain(b0, r, ln):
        want = b0.clone()
        for b in range(B):
            want[:, b, int(ln[b])] = r[:, b, 0]
        return want

    r = rows()
    want = plain(buf, r, lens)
    tc._write_slots(buf, r, lens, 2)
    assert torch.equal(buf, want)
    static_r = rows()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tc._write_slots(buf, static_r, lens, 2)
    for new in ([1, 2, 3, 4, 5], [15, 0, 9, 9, 2]):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        static_r.copy_(rows())
        want = plain(buf, static_r, lens)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(buf, want), new


# #4 and #5 / #6 at rows 2-32 on the tensor cores (csrc/ffn_rows.cu:
# norm_qkv_rows_kernel, mlp_rows_kernel) against their plain versions and
# the tiled kernels they replaced there (forced by route), with the
# limits of the tiled kernels' tests above
_ROWS_W = {"w4g-1": (4, -1), "w4g128": (4, 128), "w8g-1": (8, -1)}


@pytest.mark.parametrize("what", ["q|k|v w4g-1", "q|k|v w4g128",
                                  "head w8g-1"])
@pytest.mark.parametrize("M", [2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_norm_qkv_rows_matches_plain_and_tiles(cuda, what, M, a8):
    """Rows 2-32 take the rows kernel; it agrees with the plain version
    and with the tiled kernel forced, two launches give the same bits and
    the barrier and ticket words are left clean."""
    from gptq_tpu_torch.ops import layer_fused as tl

    bits, groupsize = _ROWS_W[what.split()[1]]
    rng = np.random.default_rng(M * 7 + bits + a8)
    K = 1024
    pw = (_fusable(rng, bits, groupsize, K, 512, parts=3) if "q|k|v" in what
          else _fusable(rng, bits, groupsize, K, 4096)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda)
    w1 = _vec(rng, K, cuda, base=1.0)
    b = _vec(rng, pw.Np, cuda)
    assert tf.norm_qkv_route(M, pw, a8) == "rows"
    before = (tf.norm_qkv_launches, tf.norm_qkv_rows_launches)
    got = tf.norm_qkv_fused(x, w1, pw, a8=a8, b_qkv=b)
    torch.cuda.synchronize()
    assert (tf.norm_qkv_launches, tf.norm_qkv_rows_launches) == (
        before[0] + 1, before[1] + 1)
    want = tf.norm_qkv_fused_reference(x, w1, pw, a8=a8, b_qkv=b)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)
    kern = (x.to(torch.bfloat16).float(), w1, pw, "rmsnorm", 1e-5, a8, None,
            b)
    rows = tf._norm_qkv_cuda(*kern, route="rows")
    tiles = tf._norm_qkv_cuda(*kern, route="tiles")
    torch.cuda.synchronize()
    assert torch.equal(rows, got) and tl.sync_clean(cuda)
    _close(rows.cpu().numpy(), tiles.cpu().numpy(), rtol=FUSED_RTOL)


@pytest.mark.parametrize("kind", ["attn_mlp", "ffn"])
@pytest.mark.parametrize("tag", ["w4g-1", "w4g128"])
@pytest.mark.parametrize("M", [2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_mlp_rows_matches_plain_and_tiles(cuda, kind, tag, M, a8):
    """Rows 2-32 take the rows kernel (#5 with o, #6 without); it agrees
    with the plain version and with the tiled kernel forced, two launches
    give the same bits and the sync words are left clean."""
    from gptq_tpu_torch.ops import layer_fused as tl

    bits, groupsize = _ROWS_W[tag]
    rng = np.random.default_rng(M * 11 + bits + a8 + len(kind))
    H, F = 1024, 2816
    o = _fusable(rng, bits, groupsize, H, H).to(cuda)
    gu = _fusable(rng, bits, groupsize, H, F, parts=2).to(cuda)
    dn = _fusable(rng, bits, groupsize, F, H).to(cuda)
    attn, xres = (torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
                  .to(cuda) for _ in range(2))
    w2 = _vec(rng, H, cuda, base=1.0)
    b_o = _vec(rng, H, cuda)
    if kind == "attn_mlp":
        run = lambda: tf.attn_mlp_fused(attn, xres, w2, o, gu, dn, a8=a8,
                                        b_o=b_o)
        want = tf.attn_mlp_fused_reference(attn, xres, w2, o, gu, dn, a8=a8,
                                           b_o=b_o)
        kern = (attn, xres.to(torch.bfloat16).float(), w2, o, gu, dn, "silu",
                "rmsnorm", 1e-5, True, a8, None, b_o, None, None)
        rtol = FLIP_RTOL if a8 else FUSED_RTOL
    else:
        run = lambda: tf.ffn_fused(attn, gu, dn, a8=a8)
        want = tf.ffn_fused_reference(attn, gu, dn, a8=a8)
        kern = (attn, None, None, None, gu, dn, "silu", "rmsnorm", 0.0, True,
                a8, None, None, None, None)
        rtol = FUSED_RTOL
    assert tf.mlp_route(M, o if kind == "attn_mlp" else None, gu, dn,
                        a8) == "rows"
    before = tf.mlp_rows_launches
    got = run()
    torch.cuda.synchronize()
    assert tf.mlp_rows_launches == before + 1
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol)
    rows = tf._mlp_cuda(*kern, route="rows")
    again = tf._mlp_cuda(*kern, route="rows")
    tiles = tf._mlp_cuda(*kern, route="tiles")
    torch.cuda.synchronize()
    assert torch.equal(rows, again) and tl.sync_clean(cuda)
    _close(rows.cpu().numpy(), tiles.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("a8", [False, True])
def test_rows_kernels_row_independent(cuda, a8):
    """A row's output is the same bits at M = 4 and at M = 32, in other
    slots (#4, #5, #6)."""
    rng = np.random.default_rng(44 + a8)
    H, F = 1024, 2816
    qkv = _fusable(rng, 4, -1, H, 512, parts=3).to(cuda)
    o = _fusable(rng, 4, 128, H, H).to(cuda)
    gu = _fusable(rng, 4, 128, H, F, parts=2).to(cuda)
    dn = _fusable(rng, 4, 128, F, H).to(cuda)
    x, xres = (torch.from_numpy(rng.normal(size=(32, H)).astype(np.float32))
               .to(cuda) for _ in range(2))
    w = _vec(rng, H, cuda, base=1.0)
    idx = torch.tensor([5, 17, 30, 0], device=cuda)
    for run in (lambda a, r: tf.norm_qkv_fused(a, w, qkv, a8=a8),
                lambda a, r: tf.attn_mlp_fused(a, r, w, o, gu, dn, a8=a8),
                lambda a, r: tf.ffn_fused(a, gu, dn, a8=a8)):
        full, part = run(x, xres), run(x[idx], xres[idx])
        torch.cuda.synchronize()
        assert torch.equal(full[idx], part)


def test_single_row_kernels_unchanged_beside_rows(cuda):
    """At one row #4 and #5 / #6 keep the single-row streams
    (norm_qkv_gemv_kernel, mlp_stream_kernel), whose outputs are the same
    bits before and after rows launches on the same stream (the kernels
    share its barrier and ticket words)."""
    rng = np.random.default_rng(45)
    H, F = 1024, 2816
    qkv = _fusable(rng, 4, -1, H, 512, parts=3).to(cuda)
    o = _fusable(rng, 4, -1, H, H).to(cuda)
    gu = _fusable(rng, 4, -1, H, F, parts=2).to(cuda)
    dn = _fusable(rng, 4, -1, F, H).to(cuda)
    x, xres = (torch.from_numpy(rng.normal(size=(8, H)).astype(np.float32))
               .to(cuda) for _ in range(2))
    w = _vec(rng, H, cuda, base=1.0)
    assert tf.norm_qkv_route(1, qkv) == tf.mlp_route(1, o, gu, dn) == "stream"

    def one_row():
        return (tf.norm_qkv_fused(x[:1], w, qkv),
                tf.attn_mlp_fused(x[:1], xres[:1], w, o, gu, dn),
                tf.ffn_fused(x[:1], gu, dn))

    first = one_row()
    tf.norm_qkv_fused(x, w, qkv)
    tf.attn_mlp_fused(x, xres, w, o, gu, dn)
    second = one_row()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_mlp_rows_graph_replays(cuda):
    """A CUDA graph of an mlp_rows_kernel launch (its grid barriers on the
    stream's generation counter), replayed twice on new inputs, equals
    the eager launch on them."""
    rng = np.random.default_rng(46)
    H, F = 1024, 2816
    o = _fusable(rng, 4, -1, H, H).to(cuda)
    gu = _fusable(rng, 4, -1, H, F, parts=2).to(cuda)
    dn = _fusable(rng, 4, -1, F, H).to(cuda)
    attn, xres = (torch.from_numpy(rng.normal(size=(8, H)).astype(np.float32))
                  .to(cuda) for _ in range(2))
    w2 = _vec(rng, H, cuda, base=1.0)
    tf.attn_mlp_fused(attn, xres, w2, o, gu, dn)  # warm: build, plan
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tf.attn_mlp_fused(attn, xres, w2, o, gu, dn)
    for _ in range(2):
        attn.copy_(torch.from_numpy(rng.normal(size=(8, H)).astype(
            np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tf.attn_mlp_fused(attn, xres, w2, o, gu, dn))


# ---------------------------------------------------------------------------
# the OPT, BLOOM and Gemma branches of #4-#6, #12 and #3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "gelu_tanh"])  # OPT, BLOOM
@pytest.mark.parametrize("M", [1, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_attn_mlp_no_glu_family_branches(cuda, act, M, a8):
    """#5 without GLU (fc1 -> act -> fc2), layernorm and o / fc1 / fc2
    biases: one row on the stream kernel, 32 on the rows kernel, held to
    the plain version with the near-tie rule (chip_smoke.tie_check)."""
    import chip_smoke

    rng = np.random.default_rng(90 + M + a8 + 3 * (act == "relu"))
    H, F = 512, 2048
    o = _fusable(rng, 4, -1, H, H).to(cuda)
    fc1 = _fusable(rng, 4, -1, H, F).to(cuda)
    fc2 = _fusable(rng, 4, -1, F, H).to(cuda)
    assert tf.mlp_route(M, o, fc1, fc2, a8) == ("stream" if M == 1
                                                else "rows")
    attn, xres = (torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
                  .to(cuda) for _ in range(2))
    kw = dict(act=act, norm="layernorm", eps=1e-5, glu=False, a8=a8,
              b_ln=_vec(rng, H, cuda), b_o=_vec(rng, H, cuda),
              b_g=_vec(rng, F, cuda), b_d=_vec(rng, H, cuda))
    w2 = _vec(rng, H, cuda, base=1.0)
    got = tf.attn_mlp_fused(attn, xres, w2, o, fc1, fc2, **kw)
    again = tf.attn_mlp_fused(attn, xres, w2, o, fc1, fc2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err, rel, flips = chip_smoke.tie_check(
        "attn_mlp", got, lambda: tf.attn_mlp_fused_reference(
            attn, xres, w2, o, fc1, fc2, **kw), FUSED_RTOL)
    print(f"rel err {rel:.3g} after {flips} near-tie flips")


@pytest.mark.parametrize("M", [1, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_norm_qkv_padded_head_matches_plain(cuda, M, a8):
    """#4 as a head after a final layernorm: an 8-bit weight whose stored
    width is padded (N 1,920 of Np 2,048, as OPT's 50,272 of 50,688); the
    padded columns come out zero."""
    rng = np.random.default_rng(95 + M + a8)
    K, N = 512, 1920
    codes = rng.integers(0, 256, size=(N, K)).astype(np.float32)
    scale = (rng.random(N) * 0.02 + 0.01).astype(np.float32)
    pw = tpack.pack_quantized(
        torch.from_numpy((codes - 128) * scale[:, None]),
        torch.from_numpy(scale)[None], torch.full((1, N), 128.0), 8).to(cuda)
    assert (pw.N, pw.Np) == (N, 2048) and tf.norm_qkv_fusable(pw)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda)
    kw = dict(norm="layernorm", eps=1e-5, a8=a8, b_ln=_vec(rng, K, cuda))
    w1 = _vec(rng, K, cuda, base=1.0)
    got = tf.norm_qkv_fused(x, w1, pw, **kw)
    torch.cuda.synchronize()
    want = tf.norm_qkv_fused_reference(x, w1, pw, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=FUSED_RTOL)
    assert bool((got[:, N:] == 0).all())


@pytest.mark.parametrize("cache", ["bf16", "f32"])
@pytest.mark.parametrize("a8", [False, True])
def test_layer_kernel_gemma_shape(cuda, cache, a8):
    """#12 at Gemma-7B's layer shape, narrowed: hd 256, MHA, H hd (1,024)
    != hidden (768), rmsnorm1p, gelu_tanh; the near-tie rule, and the
    written k / v rows bit for bit against the kernel's own q|k|v row."""
    from gptq_tpu_torch.ops import layer_fused as tl
    import chip_smoke

    H = Hkv = 4
    hd, hidden, F, S, length = 256, 768, 1536, 256, 131
    rng = np.random.default_rng(97 + a8)
    qkv = tpack.fuse_packed([_fusable(rng, 4, -1, hidden, H * hd)
                             for _ in range(3)]).to(cuda)
    ws = [qkv, _fusable(rng, 4, -1, H * hd, hidden).to(cuda),
          _fusable(rng, 4, -1, hidden, F, parts=2).to(cuda),
          _fusable(rng, 4, -1, F, hidden).to(cuda)]

    class _Splits:
        parts = ((H * hd, H * hd),) * 3

    assert tl.layer_fusable(ws[0], _Splits, *ws[1:], hidden, H, Hkv,
                            head_dim=hd)
    spec = tc.ArchSpec(arch="gemma", n_layers=2, hidden=hidden, n_heads=H,
                       n_kv_heads=Hkv, head_dim=hd, ffn=F, vocab=8,
                       max_pos=S, pos="rope", norm_type="rmsnorm1p",
                       act="gelu_tanh")
    lens = torch.tensor(length, dtype=torch.int32, device=cuda)
    cos, sin = tc.rope_tables(spec, lens.reshape(1, 1))
    x = torch.from_numpy(rng.normal(size=(1, 1, hidden)).astype(np.float32)
                         ).to(cuda)
    w1, w2 = _vec(rng, hidden, cuda), _vec(rng, hidden, cuda)
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    kv0 = [torch.from_numpy(rng.normal(size=(2, 1, S, Hkv, hd)).astype(
        np.float32)).to(cuda).to(dt) for _ in range(2)]
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, act="gelu_tanh",
              norm="rmsnorm1p", eps=1e-6, sm_scale=hd ** -0.5, a8=a8, layer=1)
    args = (cos, sin, w1, w2, *ws)
    kern = [c.clone() for c in kv0]
    got = tl.decode_layer_fused(x, *kern, lens, *args, **kw)
    torch.cuda.synchronize()
    plain = [c.clone() for c in kv0]
    err, rel, flips = chip_smoke.tie_check(
        "layer", got, lambda: tl.decode_layer_fused_reference(
            x, *plain, lens, *args, **kw), FUSED_RTOL)
    print(f"rel err {rel:.3g} after {flips} near-tie flips")
    own = [c.clone() for c in kv0]
    _, scratch = tl._layer_cuda(x, *own, lens, cos, sin, w1, w2, *ws, H, Hkv,
                                hd, "gelu_tanh", "rmsnorm1p", 1e-6,
                                hd ** -0.5, a8, 1)
    torch.cuda.synchronize()
    qd, kvw = H * hd, Hkv * hd
    row = scratch["qkv"]
    want_k = tl.rope_rows(row[qd:qd + kvw].reshape(Hkv, hd), cos.reshape(-1),
                          sin.reshape(-1)).to(dt)
    assert torch.equal(own[0][1, 0, length], want_k)
    assert torch.equal(own[1][1, 0, length],
                       row[qd + kvw:qd + 2 * kvw].reshape(Hkv, hd).to(dt))
    assert torch.equal(kern[0], own[0]) and torch.equal(kern[1], own[1])


_FAMILY_SPECS = {
    "opt": dict(arch="opt", act="relu", pos="learned", norm_type="layernorm",
                linear_bias=True),
    "bloom": dict(arch="bloom", act="gelu_tanh", pos="alibi",
                  norm_type="layernorm", linear_bias=True,
                  tie_embeddings=True),
    "gemma": dict(arch="gemma", act="gelu_tanh", pos="rope",
                  norm_type="rmsnorm1p", linear_bias=False,
                  tie_embeddings=True, n_kv_heads=2, head_dim=256,
                  embed_scale=512 ** 0.5),
}


@pytest.mark.parametrize("name", list(_FAMILY_SPECS))
def test_family_decode_kernels_match_plain(cuda, name):
    """A 2-layer model of each family (w4a8 g-1, an 8-bit head, int8
    cache) decodes through the fused kernels (per step: L + 1 #4, L #5, and
    #3 except under alibi) and, teacher-forced on the same tokens, its
    logits hold to the plain versions' within chip_smoke's logits_a8
    bound (int8 activation ties of a route summed in another order)."""
    from gptq_tpu_torch import pipeline as tpipe
    from gptq_tpu_torch.engine import decode as tdec
    from gptq_tpu_torch.ops import attention as tatt
    import chip_smoke

    spec = tc.ArchSpec(n_layers=2, hidden=512, n_heads=4, ffn=2048,
                       vocab=1000, max_pos=64, **_FAMILY_SPECS[name])
    params = tc.init_params(spec, seed=5, device=cuda)
    rng = np.random.default_rng(5)
    for lp in params["layers"]:
        for key, lin in list(lp.items()):
            if key.startswith("ln"):
                continue
            N, K = lin["w"].shape
            lp[key] = {"w": _fusable(rng, 4, -1, K, N).to(cuda),
                       "b": None if lin["b"] is None
                       else _vec(rng, N, cuda)}
    assert tpipe.quantize_lm_head(spec, params, bits=8)
    eng = tdec.DecodeEngine(spec, params, max_len=32, cache_dtype=torch.int8,
                            a8=True)
    ids = torch.from_numpy(rng.integers(0, 1000, size=(1, 12))).to(cuda)

    def forced():
        cache, out = eng.new_cache(), []
        for t in range(ids.shape[1]):
            logits, cache = eng.step(cache, ids[:, t:t + 1])
            out.append(logits.float().cpu())
        return torch.cat(out)

    counts = (tf.norm_qkv_launches, tf.attn_mlp_launches, tatt.launches)
    got = forced()
    torch.cuda.synchronize()
    n = ids.shape[1]
    assert (tf.norm_qkv_launches - counts[0], tf.attn_mlp_launches - counts[1],
            tatt.launches - counts[2]) == (3 * n, 2 * n,
                                           0 if name == "bloom" else 2 * n)
    with chip_smoke.plain_versions():
        want = forced()
    _close(got.numpy(), want.numpy(), rtol=chip_smoke.TOL["logits_a8"])


# mixed precision: #5 / #6 with o, gate|up and down at their own bits
# (configs/linearwise.json: o 3, gate|up 4, down 3) on each route, and #12
# with q|k|v, o, gate|up and down at their own bits, with the limits of
# the uniform cases above
@pytest.mark.parametrize("kind", ["attn_mlp", "ffn"])
@pytest.mark.parametrize("bits", [(3, 4, 3), (8, 2, 3)])
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("a8", [False, True])
def test_mlp_kernels_at_mixed_bits(cuda, kind, bits, M, a8):
    """The stream (M = 1) and rows (M 2-32) kernels on weights of three
    bit widths: against the plain version, two launches bit for bit, the
    sync words clean."""
    from gptq_tpu_torch.ops import layer_fused as tl

    rng = np.random.default_rng(sum(bits) * 13 + M + a8 + len(kind))
    H, F = 1024, 2816
    bo, bg, bd = bits
    o = _fusable(rng, bo, -1, H, H).to(cuda) if kind == "attn_mlp" else None
    gu = _fusable(rng, bg, -1, H, F, parts=2).to(cuda)
    dn = _fusable(rng, bd, -1, F, H).to(cuda)
    x, xres = (torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
               .to(cuda) for _ in range(2))
    w2 = _vec(rng, H, cuda, base=1.0)
    assert tf.mlp_route(M, o, gu, dn, a8) == ("stream" if M == 1 else "rows")
    if o is not None:
        got = tf.attn_mlp_fused(x, xres, w2, o, gu, dn, a8=a8)
        want = tf.attn_mlp_fused_reference(x, xres, w2, o, gu, dn, a8=a8)
        kern = (x, xres.to(torch.bfloat16).float(), w2, o, gu, dn, "silu",
                "rmsnorm", 1e-5, True, a8, None, None, None, None)
    else:
        got = tf.ffn_fused(x, gu, dn, a8=a8)
        want = tf.ffn_fused_reference(x, gu, dn, a8=a8)
        kern = (x, None, None, None, gu, dn, "silu", "rmsnorm", 0.0, True,
                a8, None, None, None, None)
    _close(got.cpu().numpy(), want.cpu().numpy(),
           rtol=FLIP_RTOL if a8 and M > 1 and o is not None else FUSED_RTOL)
    one, two = tf._mlp_cuda(*kern), tf._mlp_cuda(*kern)
    torch.cuda.synchronize()
    assert torch.equal(one, two) and tl.sync_clean(cuda)


@pytest.mark.parametrize("bits", [(4, 3, 4, 3), (3, 3, 3, 3), (3, 8, 2, 4)])
@pytest.mark.parametrize("a8", [False, True])
def test_layer_kernel_at_mixed_bits(cuda, bits, a8):
    """#12 on q|k|v, o, gate|up and down of their own bits over a bf16
    cache of 512 slots, 300 filled: against the plain version (the
    near-tie rule), two launches bit for bit."""
    from gptq_tpu_torch.ops import layer_fused as tl
    import chip_smoke

    rng = np.random.default_rng(sum(bits) + 7 * a8)
    hidden, H, Hkv, F, S, length = 1024, 8, 4, 1536, 512, 300
    hd, kvw = hidden // H, Hkv * hidden // H
    bq, bo, bg, bd = bits
    ws = [tpack.fuse_packed([_fusable(rng, bq, -1, hidden, n)
                             for n in (hidden, kvw, kvw)]),
          _fusable(rng, bo, -1, hidden, hidden),
          _fusable(rng, bg, -1, hidden, F, parts=2),
          _fusable(rng, bd, -1, F, hidden)]
    ws = [w.to(cuda) for w in ws]

    class _Splits:
        parts = ((hidden, hidden), (kvw, kvw), (kvw, kvw))

    assert tl.layer_fusable(ws[0], _Splits, *ws[1:], hidden, H, Hkv)
    spec = tc.ArchSpec(arch="llama", n_layers=2, hidden=hidden, n_heads=H,
                       n_kv_heads=Hkv, ffn=F, vocab=8, max_pos=S, pos="rope")
    lens = torch.tensor(length, dtype=torch.int32, device=cuda)
    cos, sin = tc.rope_tables(spec, lens.reshape(1, 1))
    x = torch.from_numpy(rng.normal(size=(1, 1, hidden)).astype(np.float32)
                         ).to(cuda)
    w1, w2 = _vec(rng, hidden, cuda, base=1.0), _vec(rng, hidden, cuda,
                                                     base=1.0)
    kv0 = [torch.from_numpy(rng.normal(size=(2, 1, S, Hkv, hd)).astype(
        np.float32)).to(cuda).to(torch.bfloat16) for _ in range(2)]
    kw = dict(n_heads=H, n_kv_heads=Hkv, sm_scale=hd ** -0.5, layer=1, a8=a8)
    args = (cos, sin, w1, w2, *ws)
    runs = []
    for _ in range(2):
        kern = [c.clone() for c in kv0]
        runs.append((tl.decode_layer_fused(x, *kern, lens, *args, **kw), kern))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    plain = [c.clone() for c in kv0]
    err, rel, flips = chip_smoke.tie_check(
        "layer", runs[0][0], lambda: tl.decode_layer_fused_reference(
            x, *plain, lens, *args, **kw), FUSED_RTOL)
    print(f"rel err {rel:.3g} after {flips} near-tie flips")
    assert tl.sync_clean(cuda)
