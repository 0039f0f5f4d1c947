"""Parity of gptq_tpu_torch.ops.qmatmul with gptq_tpu.ops.qmatmul on the
CPU (the plain PyTorch twin against the JAX oracle and one interpret-mode
Pallas case). The CUDA kernel is held to the twin in test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import pack as jpack
from gptq_tpu.ops import qmatmul as jq
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq
from test_torch_gemv import gemv_replay
from torch_threads import torch_threads  # noqa: F401 (autouse)

RTOL = 1e-5  # both sides f32 on the CPU; sums in another order


def _weights(rng, bits, groupsize, K, N, perm=False, bias=False):
    Kp, Np = jpack.pad_dim(K, groupsize), jpack.pad_dim(N)
    ng = Kp // groupsize if groupsize > 0 else 1
    codes = rng.integers(0, 1 << bits, size=(Kp, Np)).astype(np.int32)
    scale = (rng.random((ng, Np)) * 0.02 + 0.005).astype(np.float32)
    zoff = (scale * rng.integers(0, 1 << bits, size=(ng, Np))).astype(np.float32)
    scale[:, N:] = 0  # pad columns carry zero grids, as pack_quantized stores
    zoff[:, N:] = 0
    p = rng.permutation(K).astype(np.int32) if perm else None
    b = rng.normal(size=N).astype(np.float32) if bias else None
    jw = jpack.pack_codes(jnp.asarray(codes), bits, groupsize)
    tw = tpack.pack_codes(torch.from_numpy(codes), bits, groupsize)
    jp = jpack.PackedWeight(
        words=jw, scale=jnp.asarray(scale), zoff=jnp.asarray(zoff),
        bias=None if b is None else jnp.asarray(b),
        perm=None if p is None else jnp.asarray(p), bits=bits, K=K, N=N,
        groupsize=groupsize)
    tp = tpack.PackedWeight(
        words=tw, scale=torch.from_numpy(scale), zoff=torch.from_numpy(zoff),
        bias=None if b is None else torch.from_numpy(b),
        perm=None if p is None else torch.from_numpy(p), bits=bits, K=K, N=N,
        groupsize=groupsize)
    return jp, tp


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)
    assert err <= rtol, err


@pytest.mark.parametrize("bits,groupsize,perm,bias", [
    (4, -1, False, False),
    (4, 128, True, True),
    (3, 128, True, False),
    (2, 32, False, True),
    (8, -1, True, False),
])
@pytest.mark.parametrize("a8", [False, True])
def test_plain_matches_jax_oracle(bits, groupsize, perm, bias, a8):
    rng = np.random.default_rng(bits * 10 + groupsize + 7 * a8)
    K, N, M = 480, 96, 5  # K pads to 512
    jp, tp = _weights(rng, bits, groupsize, K, N, perm=perm, bias=bias)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = jq.dequant_matmul(jnp.asarray(x), jp, impl="xla", a8=a8)
    got = tq.dequant_matmul(torch.from_numpy(x), tp, a8=a8)
    assert got.shape == (M, N) and got.dtype == torch.float32
    _close(got.numpy(), want)
    np.testing.assert_allclose(tq.dequant(tp).numpy(), np.asarray(jq.dequant(jp)),
                               rtol=0, atol=0)


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    jp, tp = _weights(rng, 4, 128, 512, 256, perm=True)
    x = rng.normal(size=(2, 3, 512)).astype(np.float32)
    want = jq.dequant_matmul(jnp.asarray(x), jp, impl="pallas", interpret=True,
                             a8=True)
    got = tq.dequant_matmul(torch.from_numpy(x), tp, a8=True)
    assert got.shape == (2, 3, 256)
    _close(got.numpy(), want, rtol=1e-4)  # a8: f32 epilogue order differs


def test_quantize_acts_int8_rounds_half_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    jx, js = jq.quantize_acts_int8(jnp.asarray(x))
    tx, ts = tq.quantize_acts_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 300)).astype(np.float32)
    jx, js = jq.quantize_acts_int8(jnp.asarray(x))
    tx, ts = tq.quantize_acts_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


def test_quantize_acts_int8_tie_rows_match_jax():
    """Rows of exact .5 ties (test_torch_cuda.tie_rows): the port's codes
    equal gptq_tpu's bit for bit, and the rows do tell an IEEE absmax / 127
    from a product with fl(1 / 127), the rounding a division by the
    Python number 127.0 takes on CUDA."""
    from test_torch_cuda import tie_rows

    x = tie_rows()
    jx, js = jq.quantize_acts_int8(jnp.asarray(x))
    tx, ts = tq.quantize_acts_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    amax = np.abs(x).max(axis=1, keepdims=True)
    off = amax * (np.float32(1) / np.float32(127)) + np.float32(1e-12)
    moved = np.clip(np.round(x / off), -127, 127).astype(np.int8)
    assert (moved != tx.numpy()).any()


def test_cpu_tensor_never_launches_the_kernel():
    rng = np.random.default_rng(1)
    _, tp = _weights(rng, 4, -1, 256, 64)
    before = tq.launches
    tq.dequant_matmul(torch.zeros(1, 256), tp)
    assert tq.launches == before


# --- the streamed route (GPTQ_TPU_MATMUL_IMPL=streamed, kernel #7) ---------

@pytest.mark.parametrize("bits,groupsize", [(2, -1), (4, 128), (8, -1),
                                            (4, 256)])
@pytest.mark.parametrize("a8", [False, True])
def test_streamed_plain_matches_pallas_interpret(bits, groupsize, a8):
    rng = np.random.default_rng(bits + groupsize + 5 * a8)
    jp, tp = _weights(rng, bits, groupsize, 1024, 256)
    x = rng.normal(size=(8, 1024)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if a8:
        jx, _ = jq.quantize_acts_int8(jx)
        tx, _ = tq.quantize_acts_int8(tx)
    want = jq._matmul_streamed(jx, jp, interpret=True)
    got = tq._matmul_streamed(tx, tp)
    assert got.shape == (8, 256)
    _close(got.numpy(), want, rtol=1e-4 if a8 else RTOL)
    assert tq.stream_chunks(tp) == (1024, 1024 if groupsize < 0 else groupsize)


def test_streamed_entry_rules_match():
    rng = np.random.default_rng(2)
    # 64-row groups inside a 512-row chunk: both packages refuse them
    jp, tp = _weights(rng, 4, 64, 512, 128)
    x = np.zeros((8, 512), np.float32)
    with pytest.raises(ValueError, match="group-aligned"):
        jq._matmul_streamed(jnp.asarray(x), jp, interpret=True)
    with pytest.raises(ValueError, match="group-aligned"):
        tq._matmul_streamed(torch.from_numpy(x), tp)
    # 3-bit weights have two fields: the streamed kernel takes one
    _, tp3 = _weights(rng, 3, 128, 512, 128)
    with pytest.raises(ValueError, match="single-field"):
        tq._matmul_streamed(torch.from_numpy(x), tp3)


@pytest.mark.parametrize("bits,gs,K", [(4, 64, 512), (2, 32, 1024)])
def test_streamed_one_row_keeps_the_entry_rules(monkeypatch, bits, gs, K):
    """At one row, as at eight, the streamed route refuses the chunks that
    split a group, as gptq_tpu does, though the single-row kernel it
    launches there would take them."""
    rng = np.random.default_rng(bits + K)
    jp, tp = _weights(rng, bits, gs, K, 128)
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "streamed")
    for M in (1, 8):
        x = np.zeros((M, K), np.float32)
        with pytest.raises(ValueError, match="group-aligned"):
            jq._matmul_streamed(jnp.asarray(x), jp, interpret=True)
        with pytest.raises(ValueError, match="group-aligned"):
            tq._matmul_streamed(torch.from_numpy(x), tp)
        with pytest.raises(ValueError, match="group-aligned"):
            tq.dequant_matmul(torch.from_numpy(x), tp)


@pytest.mark.parametrize("bits,gs", [(2, -1), (4, 128), (8, 256)])
@pytest.mark.parametrize("a8", [False, True])
def test_streamed_one_row_matches_pallas_interpret(bits, gs, a8):
    """One row through the streamed route's plain version against the
    Pallas _stream_kernel in interpret mode, and the single-row replay of
    the kernel the card launches there (test_torch_gemv.gemv_replay, the
    cut of qmatmul.gemv_splits on 132 SMs) against both."""
    rng = np.random.default_rng(bits * 3 + gs + a8)
    jp, tp = _weights(rng, bits, gs, 1024, 256)
    x = rng.normal(size=(1, 1024)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    sx = None
    if a8:
        jx, _ = jq.quantize_acts_int8(jx)
        tx, sx = tq.quantize_acts_int8(tx)
    want = np.asarray(jq._matmul_streamed(jx, jp, interpret=True))
    got = tq._matmul_streamed(tx, tp).numpy()
    _close(got, want, rtol=1e-4)
    sb = tpack.subblock(tp.Kp, gs)
    unit = tq.gemv_unit(sb, bits)
    splits = tq.gemv_splits(tp.Kp, tp.Np, sb, bits, tx.element_size(), 132)
    assert splits > 1
    replay = gemv_replay(tx[0], tp.words, tp.scale, tp.zoff, bits, sb, splits,
                         unit, False).numpy()
    _close(replay, want[0], rtol=1e-4)


@pytest.mark.parametrize("impl", ["pallas", "streamed", "xla"])
@pytest.mark.parametrize("bits", [4, 3])
def test_matmul_impl_routes_agree_on_cpu(monkeypatch, impl, bits):
    rng = np.random.default_rng(bits)
    jp, tp = _weights(rng, bits, 128, 480, 96, perm=True, bias=True)
    x = rng.normal(size=(2, 3, 480)).astype(np.float32)
    want = jq.dequant_matmul(jnp.asarray(x), jp, impl="xla", a8=True)
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", impl)
    before = (tq.launches, tq.stream_launches)
    got = tq.dequant_matmul(torch.from_numpy(x), tp, a8=True)
    assert (tq.launches, tq.stream_launches) == before
    assert got.shape == (2, 3, 96)
    _close(got.numpy(), want, rtol=1e-4)


def test_matmul_impl_errors(monkeypatch):
    _, tp = _weights(np.random.default_rng(0), 4, -1, 256, 64)
    x = torch.zeros(1, 256)
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "staged")
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        tq.dequant_matmul(x, tp)
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "fast")
    with pytest.raises(ValueError, match="GPTQ_TPU_MATMUL_IMPL"):
        tq.dequant_matmul(x, tp)
    monkeypatch.setenv("GPTQ_TPU_MATMUL_IMPL", "pallas")
    with pytest.raises(ValueError, match="bcq"):
        tq._qmm_cuda(x, tpack.PackedWeight(words=tp.words, bits=4, K=256,
                                           N=64, fmt="bcq"))
