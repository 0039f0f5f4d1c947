"""Parity of gptq_tpu_torch.ops.pack with gptq_tpu.ops.pack: the packed
words must match bit for bit (the .npz checkpoints interchange)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import pack as jpack
from gptq_tpu_torch.ops import pack as tpack
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("groupsize", [-1, 32, 128])
def test_pack_codes_bit_exact(bits, groupsize):
    rng = np.random.default_rng(bits * 1000 + groupsize)
    K, N = 384, 48
    codes = rng.integers(0, 1 << bits, size=(K, N)).astype(np.int32)
    # the top code in every column sets the words' top bits for 8-bit
    codes[-1] = (1 << bits) - 1
    jw = jpack.pack_codes(jnp.asarray(codes), bits, groupsize)
    tw = tpack.pack_codes(torch.from_numpy(codes), bits, groupsize)
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = tpack.unpack_codes(tw, bits, groupsize)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("bits,code", [(8, 0), (4, 15), (2, 3)])
def test_words_with_top_bit_set_roundtrip(bits, code):
    # 8-bit code 0 stores byte 0x80; 4-bit 15 / 2-bit 3 fill every bit:
    # every word is >= 2^31 as uint32, i.e. negative as int32
    codes = np.full((64, 4), code, np.int32)
    (w,) = tpack.pack_codes(torch.from_numpy(codes), bits)
    assert (w < 0).all()
    (jw,) = jpack.pack_codes(jnp.asarray(codes), bits)
    np.testing.assert_array_equal(np.asarray(jw), w.numpy())
    np.testing.assert_array_equal(tpack.unpack_codes((w,), bits).numpy(), codes)


@pytest.mark.parametrize("bits,groupsize,actorder,K", [
    (4, -1, False, 480),   # K pads 480 -> 512
    (4, 32, True, 480),
    (3, 128, True, 384),
    (8, -1, False, 256),
    (2, 32, False, 256),
])
def test_pack_quantized_matches(bits, groupsize, actorder, K):
    rng = np.random.default_rng(K + bits)
    N = 72
    ng = K // groupsize if groupsize > 0 else 1
    scale = (rng.random((ng, N)) * 0.05 + 0.01).astype(np.float32)
    zero = rng.integers(0, 1 << bits, size=(ng, N)).astype(np.float32)
    codes = rng.integers(0, 1 << bits, size=(N, K))
    g = K // ng
    Q = (scale.repeat(g, 0).T * (codes - zero.repeat(g, 0).T)).astype(np.float32)
    perm = rng.permutation(K).astype(np.int32) if actorder else None
    if perm is not None:
        # actorder stores K in permuted order: grids are per permuted group
        Q = Q[:, np.argsort(perm)]
    jp = jpack.pack_quantized(jnp.asarray(Q), jnp.asarray(scale),
                              jnp.asarray(zero), bits, groupsize,
                              perm=None if perm is None else jnp.asarray(perm),
                              actorder=actorder)
    tp = tpack.pack_quantized(torch.from_numpy(Q), torch.from_numpy(scale),
                              torch.from_numpy(zero), bits, groupsize,
                              perm=None if perm is None else torch.from_numpy(perm),
                              actorder=actorder)
    assert (tp.K, tp.N, tp.Kp, tp.Np) == (jp.K, jp.N, jp.Kp, jp.Np)
    for a, b in zip(jp.words, tp.words):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jp.zoff), tp.zoff.numpy())
    if actorder and groupsize > 0:
        np.testing.assert_array_equal(np.asarray(jp.perm), tp.perm.numpy())
    else:
        assert tp.perm is None and jp.perm is None


@pytest.mark.parametrize("dim,gs", [(11008, -1), (11008, 128), (4096, -1),
                                    (100, -1), (480, 32)])
def test_pad_dim_and_subblock_match(dim, gs):
    assert tpack.pad_dim(dim, gs) == jpack.pad_dim(dim, gs)
    Kp = tpack.pad_dim(dim, gs)
    if Kp % 32 == 0:
        assert tpack.subblock(Kp, gs) == jpack.subblock(Kp, gs)


def test_fuse_packed_matches():
    rng = np.random.default_rng(7)
    parts_j, parts_t = [], []
    for N in (64, 32, 32):
        codes = rng.integers(0, 16, size=(256, N)).astype(np.int32)
        scale = (rng.random((1, N)) * 0.1).astype(np.float32)
        zoff = (rng.random((1, N)) * 0.1).astype(np.float32)
        jw = jpack.pack_codes(jnp.asarray(codes), 4)
        tw = tpack.pack_codes(torch.from_numpy(codes), 4)
        parts_j.append(jpack.PackedWeight(words=jw, scale=jnp.asarray(scale),
                                          zoff=jnp.asarray(zoff), bits=4,
                                          K=256, N=N))
        parts_t.append(tpack.PackedWeight(words=tw,
                                          scale=torch.from_numpy(scale),
                                          zoff=torch.from_numpy(zoff), bits=4,
                                          K=256, N=N))
    fj = jpack.fuse_packed(parts_j)
    ft = tpack.fuse_packed(parts_t)
    assert ft.N == fj.N and ft.Np == fj.Np
    np.testing.assert_array_equal(np.asarray(fj.words[0]), ft.words[0].numpy())
    np.testing.assert_array_equal(np.asarray(fj.scale), ft.scale.numpy())
