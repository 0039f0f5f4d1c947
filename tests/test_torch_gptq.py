"""Parity of the ported GPTQ solver and uniform quantizer with gptq_tpu.

Tolerances are those of tests/test_reference_parity.py: both sides run
f32 on the CPU but factorize the Hessian with different LAPACK kernels,
so the error-feedback recurrence sees ~1e-6 input differences and a
weight within that distance of a rounding boundary may flip one grid
step. Asserts: >= 99.5% of entries match (1e-5), none is off by more than
1.5 grid steps, proxy losses within 1%."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.quant import gptq as jg
from gptq_tpu.quant import uniform as ju
from gptq_tpu_torch.quant import gptq as tg
from gptq_tpu_torch.quant import uniform as tu
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _hessian(rng, cols, nbatch=4, tokens=64):
    jstate = jg.hessian_init(cols)
    tstate = tg.hessian_init(cols, device="cpu")
    for _ in range(nbatch):
        x = rng.normal(size=(1, tokens, cols)).astype(np.float32)
        x[..., 3] = 0.0  # a dead input column
        jstate = jg.hessian_update(jstate, jnp.asarray(x))
        tstate = tg.hessian_update(tstate, torch.from_numpy(x))
    return jstate, tstate


def test_hessian_update_matches():
    rng = np.random.default_rng(0)
    (jH, jn, jm), (tH, tn, tm) = _hessian(rng, 96)
    assert int(jn) == tn == 4
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(bits=4),
    dict(bits=3, sym=True),
    dict(bits=4, mse=True),
    dict(bits=2, trits=True),
    dict(bits=8, perchannel=False),
])
def test_find_params_matches(kw):
    # the port computes `/ maxq` as the compiled JAX code does (XLA folds it
    # into `* (1/maxq)`), so the min-max grids agree bit for bit; the mse
    # search's shrink factors come from another scan, and its rows and
    # quantize_uniform's x / scale may still differ on an exact tie
    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, 400)).astype(np.float32)
    jp = ju.find_params(jnp.asarray(x), **kw)
    tp = tu.find_params(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(tp.scale.numpy(), np.asarray(jp.scale),
                               rtol=1e-6)
    if not kw.get("mse"):
        np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(tp.zero.numpy(), np.asarray(jp.zero))
    maxq = -1 if kw.get("trits") else (1 << kw["bits"]) - 1
    tq = tu.quantize_uniform(torch.from_numpy(x), tp.scale, tp.zero,
                             maxq).numpy()
    jq = np.asarray(ju.quantize_uniform(jnp.asarray(x), jp.scale, jp.zero,
                                        maxq))
    assert np.mean(np.abs(tq - jq) <= 1e-6) >= 0.995
    assert np.all(np.abs(tq - jq) <= 1.5 * np.abs(np.asarray(jp.scale)) + 1e-6)


@pytest.mark.parametrize("shape,perchannel", [
    ((24, 40), True), ((3, 8, 20), True), ((3, 8, 20), False),
    ((2, 6, 5, 5), True),
])
def test_find_params_activation_layouts_match(shape, perchannel):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jp = ju.find_params(jnp.asarray(x), bits=4, perchannel=perchannel,
                        weight=False)
    tp = tu.find_params(torch.from_numpy(x), bits=4, perchannel=perchannel,
                        weight=False)
    assert tp.scale.shape == jp.scale.shape
    np.testing.assert_allclose(tp.scale.numpy(), np.asarray(jp.scale),
                               rtol=1e-6)
    np.testing.assert_array_equal(tp.zero.numpy(), np.asarray(jp.zero))


def test_uniform_quantizer_matches():
    x = np.random.default_rng(6).normal(size=(16, 64)).astype(np.float32)
    jqz = ju.UniformQuantizer(bits=3, sym=True)
    tqz = tu.UniformQuantizer(bits=3, sym=True)
    tx = torch.from_numpy(x)
    assert not tqz.ready() and tqz.quantize(tx) is tx
    jqz.find_params(jnp.asarray(x))
    tqz.find_params(tx)
    assert tqz.ready() and tqz.maxq == jqz.maxq == 7
    jq, tq = np.asarray(jqz.quantize(jnp.asarray(x))), tqz.quantize(tx).numpy()
    # the tie caveat of test_find_params_matches applies
    assert np.mean(np.abs(tq - jq) <= 1e-6) >= 0.995
    assert np.all(np.abs(tq - jq) <= 1.5 * np.asarray(jqz.params.scale) + 1e-6)


@pytest.mark.parametrize("cfg", [
    dict(bits=4),
    dict(bits=4, groupsize=32),
    dict(bits=4, groupsize=32, actorder=True, static_groups=True),
    dict(bits=3, groupsize=32, actorder=True),
    dict(bits=4, sym=True, mse=True, blocksize=32),
    dict(bits=2, trits=True),
])
def test_gptq_quantize_matches(cfg):
    rng = np.random.default_rng(2)
    rows, cols = 48, 160  # 160 columns: a padded last block at blocksize 128
    W = (rng.normal(size=(rows, cols)) * 0.1).astype(np.float32)
    (jH, _, _), (tH, _, _) = _hessian(rng, cols)
    jout = jg.gptq_quantize(jnp.asarray(W), jH, jg.SolverConfig(**cfg))
    tout = tg.gptq_quantize(torch.from_numpy(W), tH, tg.SolverConfig(**cfg))
    jQ, tQ = np.asarray(jout["Q"]), tout["Q"].numpy()
    exact = np.mean(np.abs(jQ - tQ) <= 1e-5)
    assert exact >= 0.995, exact
    # one grid step: the largest per-row scale (trits: the level spacing)
    step = np.abs(np.asarray(jout["scale"])).max(axis=0)[:, None]
    assert np.all(np.abs(jQ - tQ) <= 1.5 * step + 1e-6)
    jl, tl = float(jout["loss"]), float(tout["loss"])
    assert abs(jl - tl) <= 0.01 * abs(jl) + 1e-9, (jl, tl)
    np.testing.assert_array_equal(np.asarray(jout["perm"]), tout["perm"].numpy())
    assert tout["scale"].shape == jout["scale"].shape


def test_other_solver_modes_raise():
    # the lut mode is ported (tests/test_torch_bcq.py); these wait
    for mode in ("columnwise", "nonlinear"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tg.gptq_quantize(torch.zeros(4, 8), torch.eye(8),
                             tg.SolverConfig(mode=mode))
