"""Parity of gptq_tpu_torch.ops.attention with gptq_tpu.ops.attention on the
CPU (the plain PyTorch twin against the JAX Pallas kernels in interpret
mode). The CUDA kernel is held to the twin in test_torch_cuda.py.

hd 64 reaches the JAX head-loop kernel (_attn_kernel, f32 math); hd 128
reaches the wide kernel (_attn_kernel_wide), whose dots take bf16
operands, so the f32 plain version is held to it at bf16 precision and to
the head-loop kernel at hd 128 (GPTQ_TPU_ATTN_WIDE=0) at 1e-5."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu.ops import attention as ja
from gptq_tpu_torch.ops import attention as ta

# the head-loop kernel at any hd: the un-jitted body re-reads the env var
_jax_head_loop = jax.jit(ja.decode_attention.__wrapped__,
                         static_argnames=("sm_scale", "interpret"))


def _inputs(seed, B, S, H, Hkv, hd, int8, L=None):
    rng = np.random.default_rng(seed)
    lead = (B,) if L is None else (L, B)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        ks = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
        v = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
        ks = vs = None
    fk = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    fv = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    return q, k, v, ks, vs, fk, fv, lens


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _port(q, k, v, lens, sm, ks, vs, fk, fv, layer=None):
    return ta.decode_attention(_t(q), _t(k), _t(v), _t(lens), sm,
                               k_scale=_t(ks), v_scale=_t(vs), fresh_k=_t(fk),
                               fresh_v=_t(fv), layer=layer).numpy()


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("Hkv", [4, 2])  # MHA and GQA (G = 2)
@pytest.mark.parametrize("fresh", [True, False])
def test_head_loop_kernel_hd64(int8, Hkv, fresh):
    B, S, H, hd = 3, 64, 4, 64
    q, k, v, ks, vs, fk, fv, lens = _inputs(Hkv + 2 * int8, B, S, H, Hkv, hd,
                                            int8)
    if not fresh:
        fk = fv = None
    sm = 1.0 / np.sqrt(hd)
    want = ja.decode_attention(_j(q), _j(k), _j(v), _j(lens), sm,
                               k_scale=_j(ks), v_scale=_j(vs), fresh_k=_j(fk),
                               fresh_v=_j(fv), interpret=True)
    got = _port(q, k, v, lens, sm, ks, vs, fk, fv)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("Hkv", [2, 1])
def test_hd128_stacked_layer(int8, Hkv, monkeypatch):
    B, S, H, hd, L, layer = 2, 256, 2, 128, 3, 1
    q, k, v, ks, vs, fk, fv, lens = _inputs(5 + Hkv, B, S, H, Hkv, hd, int8,
                                            L=L)
    sm = 1.0 / np.sqrt(hd)
    got = _port(q, k, v, lens, sm, ks, vs, fk, fv, layer=layer)
    # the wide kernel (the JAX hd % 128 == 0 path, stacked cache + layer):
    # bf16 dot operands -> bf16-level agreement
    wide = ja.decode_attention_wide(
        _j(q), _j(k), _j(v), _j(lens), sm, k_scale=_j(ks), v_scale=_j(vs),
        fresh_k=_j(fk), fresh_v=_j(fv), layer=layer, interpret=True)
    np.testing.assert_allclose(got, np.asarray(wide), rtol=2e-2, atol=2e-2)
    # the same function through the f32 head-loop kernel on layer `layer`
    monkeypatch.setenv("GPTQ_TPU_ATTN_WIDE", "0")
    sel = (lambda a: None if a is None else a[layer])
    want = _jax_head_loop(_j(q), _j(sel(k)), _j(sel(v)), _j(lens), sm,
                          k_scale=_j(sel(ks)), v_scale=_j(sel(vs)),
                          fresh_k=_j(fk), fresh_v=_j(fv), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_scalar_length_and_int8_wrapper():
    B, S, H, hd = 2, 32, 4, 64
    q, k, v, ks, vs, _, _, _ = _inputs(11, B, S, H, 4, hd, True)
    sm = 0.125
    want = ja.decode_attention_int8(_j(q), _j(k), _j(v), _j(ks), _j(vs),
                                    jnp.asarray(21), sm, interpret=True)
    got = ta.decode_attention_int8(_t(q), _t(k), _t(v), _t(ks), _t(vs), 21,
                                   sm).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_never_launches_the_kernel():
    q, k, v, ks, vs, fk, fv, lens = _inputs(0, 1, 32, 2, 2, 64, True)
    before = ta.launches
    _port(q, k, v, lens, 0.1, ks, vs, fk, fv)
    assert ta.launches == before


def test_length_zero_without_fresh_pair_gives_zeros():
    # a row with nothing to attend: zeros (the port's one meaning for its
    # kernel and its plain version); the other rows are unchanged
    q, k, v, ks, vs, _, _, _ = _inputs(13, 3, 32, 4, 2, 64, True)
    lens = np.array([0, 7, 0], np.int32)
    got = _port(q, k, v, lens, 0.125, ks, vs, None, None)
    assert np.all(got[[0, 2]] == 0) and np.all(np.isfinite(got))
    want = ja.decode_attention(_j(q), _j(k), _j(v), _j(lens), 0.125,
                               k_scale=_j(ks), v_scale=_j(vs), interpret=True)
    np.testing.assert_allclose(got[1], np.asarray(want)[1], rtol=1e-5,
                               atol=1e-5)
