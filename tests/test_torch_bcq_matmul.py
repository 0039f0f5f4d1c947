"""Parity of gptq_tpu_torch's BCQ packing (ops/pack.pack_bcq, the BCQ
branch of fuse_packed) and bitplane matmul (ops/bcq_matmul.py) with
gptq_tpu on the CPU: the plain PyTorch version against the Pallas
`_bcq_kernel` in interpret mode and against the JAX `impl="xla"` oracle.
The CUDA kernel is held to the plain version in test_torch_cuda.py."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import pack as jpack
from gptq_tpu_torch.ops import bcq_matmul as tbm
from gptq_tpu_torch.ops import pack as tpack

# gptq_tpu.ops re-exports the function under the module's name
jbm = importlib.import_module("gptq_tpu.ops.bcq_matmul")

RTOL = 1e-5       # f32: both sides sum f32 products, in another order
A8_RTOL = 1e-4    # a8: exact int32 partials on the TPU side, f32 here
BF16_ULP = 2.0 ** -7  # a bf16 output may round one step the other way


def _signs(rng, N, K, gs, bits):
    ng = 1 if gs <= 0 else K // gs
    g = K if gs <= 0 else gs
    B = np.where(rng.normal(size=(N, ng, g, bits)) > 0, 1.0, -1.0)
    alpha = np.abs(rng.normal(size=(N, ng, bits))) * 0.05
    return B.astype(np.float32), alpha.astype(np.float32)


def _pair(rng, N, K, gs, bits, bias=False):
    B, alpha = _signs(rng, N, K, gs, bits)
    b = rng.normal(size=N).astype(np.float32) if bias else None
    jp = jpack.pack_bcq(jnp.asarray(B), jnp.asarray(alpha),
                        bias=None if b is None else jnp.asarray(b),
                        groupsize=gs)
    tp = tpack.pack_bcq(torch.from_numpy(B), torch.from_numpy(alpha),
                        bias=None if b is None else torch.from_numpy(b),
                        groupsize=gs)
    return jp, tp


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


@pytest.mark.parametrize("N,K,gs,bits", [
    (96, 480, -1, 3),     # K and N keep their natural size (pad > 12.5%)
    (480, 512, 128, 2),   # N pads to 512
    (64, 1024, 128, 4),
    (64, 256, 32, 3),     # subblock 32
    (48, 448, 64, 1),     # K pads to 512 with g 64
])
def test_pack_bcq_bit_exact(N, K, gs, bits):
    rng = np.random.default_rng(N + K + bits)
    jp, tp = _pair(rng, N, K, gs, bits)
    assert (tp.K, tp.N, tp.Kp, tp.Np, tp.bits, tp.groupsize, tp.fmt) == \
        (jp.K, jp.N, jp.Kp, jp.Np, jp.bits, jp.groupsize, jp.fmt)
    np.testing.assert_array_equal(tp.words[0].numpy(), np.asarray(jp.words[0]))
    np.testing.assert_array_equal(tp.alpha.numpy(), np.asarray(jp.alpha))
    np.testing.assert_array_equal(tbm.bcq_dequant(tp).numpy(),
                                  np.asarray(jbm.bcq_dequant(jp)))
    np.testing.assert_array_equal(
        tbm._unpack_signs(tp.words[0], tp.groupsize).numpy(),
        np.asarray(jbm._unpack_signs(jp.words[0], jp.groupsize)))


def test_fuse_packed_bcq_bit_exact():
    rng = np.random.default_rng(11)
    parts = [_pair(rng, N, 512, 128, 3) for N in (256, 96, 96)]
    jf = jpack.fuse_packed([j for j, _ in parts])
    tf = tpack.fuse_packed([t for _, t in parts])
    assert tf is not None and tf.fmt == "bcq" and tf.scale is None
    assert (tf.N, tf.Kp, tf.Np) == (jf.N, jf.Kp, jf.Np)
    np.testing.assert_array_equal(tf.words[0].numpy(), np.asarray(jf.words[0]))
    np.testing.assert_array_equal(tf.alpha.numpy(), np.asarray(jf.alpha))
    # a BCQ part does not fuse with a uniform one, nor across groupsizes
    assert tpack.fuse_packed([parts[0][1], _pair(rng, 64, 512, -1, 3)[1]]) \
        is None


@pytest.mark.parametrize("N,K,gs,bits", [(256, 512, 128, 3), (96, 480, -1, 2),
                                         (128, 1024, 256, 4),
                                         (64, 256, 32, 3)])
@pytest.mark.parametrize("act", ["f32", "bf16", "a8"])
def test_plain_matches_pallas_interpret(N, K, gs, bits, act):
    rng = np.random.default_rng(N * bits + K)
    jp, tp = _pair(rng, N, K, gs, bits, bias=True)
    x = rng.normal(size=(3, K)).astype(np.float32)
    a8 = act == "a8"
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if act == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jbm.bcq_matmul(jx, jp, impl="pallas", interpret=True, a8=a8)
    got = tbm.bcq_matmul(tx, tp, a8=a8)
    assert got.shape == (3, N) and got.dtype == tx.dtype
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if act == "bf16":
        bound = BF16_ULP * np.abs(want) + RTOL * np.abs(want).max()
        assert np.all(np.abs(got - want) <= bound)
    else:
        assert _rel(got, want) <= (A8_RTOL if a8 else RTOL)
    oracle = np.asarray(jbm.bcq_matmul(jnp.asarray(x), jp, impl="xla",
                                       a8=a8))
    assert _rel(tbm.bcq_matmul(torch.from_numpy(x), tp, a8=a8).numpy(),
                oracle) <= RTOL


def test_act_order_perm_applies():
    rng = np.random.default_rng(3)
    jp, tp = _pair(rng, 64, 256, 128, 2)
    perm = rng.permutation(256).astype(np.int32)
    jp.perm, tp.perm = jnp.asarray(perm), torch.from_numpy(perm)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    want = jbm.bcq_matmul(jnp.asarray(x), jp, impl="xla")
    got = tbm.bcq_matmul(torch.from_numpy(x), tp)
    assert got.shape == (2, 5, 64)
    assert _rel(got.numpy(), want) <= RTOL


def test_cpu_tensor_never_launches_the_kernel():
    rng = np.random.default_rng(1)
    _, tp = _pair(rng, 64, 256, -1, 3)
    before = tbm.launches
    tbm.bcq_matmul(torch.zeros(1, 256), tp, a8=True)
    assert tbm.launches == before
