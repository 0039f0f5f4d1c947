"""Parity of gptq_tpu_torch's BCQ quantizer (quant/bcq.py, quant/rtn.py)
and the GPTQ solver's `lut` mode with gptq_tpu on the CPU, on the same
numpy inputs.

Sign codes and codebooks must match bit for bit. The fits that run
conjugate gradient in f32 are held to the solver tolerances of
tests/test_reference_parity.py:18-23: at least 99.5% of entries exact,
the rest within the proxy loss's 1%."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.quant import bcq as jb
from gptq_tpu.quant import gptq as jg
from gptq_tpu.quant import rtn as jr
from gptq_tpu_torch.quant import bcq as tb
from gptq_tpu_torch.quant import gptq as tg
from gptq_tpu_torch.quant import rtn as tr

EXACT = 0.995  # share of entries that must match exactly
LOSS_RTOL = 0.01


def _exact_share(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


def _rel_sq_err(ret, w):
    ret, w = np.asarray(ret, np.float64), np.asarray(w, np.float64)
    return float(np.sum((ret - w) ** 2) / np.sum(w ** 2))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_binary_codebook_bit_exact(n):
    np.testing.assert_array_equal(tb.binary_codebook(n).numpy(),
                                  jb.binary_codebook(n))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("tied", [False, True])
def test_find_b_bit_exact(k, tied):
    rng = np.random.default_rng(k + 10 * tied)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    alpha = -np.sort(-np.abs(rng.normal(size=(64, k))), axis=1)
    if tied:
        # APoT-snapped alphas: powers of two give equal levels, e.g.
        # alpha = (1, .5, .5) has 1 - .5 + .5 == 1 + .5 - .5
        alpha = np.array(jb.additive_power_of_2(jnp.asarray(alpha), 1))
        alpha[::3, 1:] = alpha[::3, 1:2]
        w = (w * 0.5).astype(np.float32)
    alpha = alpha.astype(np.float32)
    want = np.asarray(jb.find_b(jnp.asarray(w), jnp.asarray(alpha)))
    got = tb.find_b(torch.from_numpy(w), torch.from_numpy(alpha)).numpy()
    np.testing.assert_array_equal(got, want)


def test_power_of_2_snapping_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=200), [0.0, -0.0, 0.75, -1.5, 3.0,
                                                2.0 ** 0.5]]).astype(np.float32)
    np.testing.assert_array_equal(
        tb.round_power_of_2(torch.from_numpy(x)).numpy(),
        np.asarray(jb.round_power_of_2(jnp.asarray(x))))
    for nums in (1, 2, 3):
        np.testing.assert_array_equal(
            tb.additive_power_of_2(torch.from_numpy(x), nums).numpy(),
            np.asarray(jb.additive_power_of_2(jnp.asarray(x), nums)))


def test_greedy_fit_and_batch_cg_match():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(32, 128)).astype(np.float32)
    wf = np.ones_like(w)
    jw, jB, ja = jb.greedy_fit(jnp.asarray(w), 3, wf=jnp.asarray(wf))
    tw, tB, ta = tb.greedy_fit(torch.from_numpy(w), 3, wf=torch.from_numpy(wf))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    x0 = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tb.batch_cg(*map(torch.from_numpy, (A, b, x0))).numpy(),
        np.asarray(jb.batch_cg(*map(jnp.asarray, (A, b, x0)))), rtol=1e-4,
        atol=1e-5)


@pytest.mark.parametrize("bits,gs,rounds,apot,use_bst", [
    (3, 128, 5, 2, True),
    (2, -1, 5, 1, True),
    (4, 64, 3, 2, True),
    (3, 128, 5, 2, False),
])
def test_quantize_shift_matches(bits, gs, rounds, apot, use_bst):
    rng = np.random.default_rng(bits * 7 + rounds)
    w = rng.normal(size=(48, 256)).astype(np.float32) * 0.05
    jret, jB, ja = jb.quantize_shift(jnp.asarray(w), bits, rounds=rounds,
                                     group_size=gs, use_bst=use_bst,
                                     apot_nums=apot)
    tret, tB, ta = tb.quantize_shift(torch.from_numpy(w), bits, rounds=rounds,
                                     group_size=gs, use_bst=use_bst,
                                     apot_nums=apot)
    assert tB.shape == jB.shape and ta.shape == ja.shape
    assert _exact_share(tB.numpy(), jB) >= EXACT
    assert _exact_share(ta.numpy(), ja) >= EXACT
    assert _exact_share(tret.numpy(), jret) >= EXACT
    je, te = _rel_sq_err(jret, w), _rel_sq_err(tret.numpy(), w)
    assert abs(te - je) <= LOSS_RTOL * je, (te, je)


def test_bcq_fit_matches():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(32, 256)).astype(np.float32)
    jret, jB, ja = jb.bcq_fit(jnp.asarray(w), 3, rounds=4, group_size=128)
    tret, tB, ta = tb.bcq_fit(torch.from_numpy(w), 3, rounds=4, group_size=128)
    assert _exact_share(tB.numpy(), jB) >= EXACT
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4)
    je, te = _rel_sq_err(jret, w), _rel_sq_err(tret.numpy(), w)
    assert abs(te - je) <= LOSS_RTOL * je


@pytest.mark.parametrize("gs,use_bst", [(128, True), (-1, True), (64, False)])
def test_bcq_quantize_against_fixed_alphas_bit_exact(gs, use_bst):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(40, 256)).astype(np.float32)
    _, _, alpha = jb.quantize_shift(jnp.asarray(w), 3, rounds=3,
                                    group_size=gs, apot_nums=2)
    alpha = np.array(alpha)
    jret, jB = jb.bcq_quantize(jnp.asarray(w), jnp.asarray(alpha),
                               groupsize=gs, use_bst=use_bst)
    tret, tB = tb.bcq_quantize(torch.from_numpy(w), torch.from_numpy(alpha),
                               groupsize=gs, use_bst=use_bst)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(tret.numpy(), np.asarray(jret))


def test_bcquantizer_matches():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(32, 256)).astype(np.float32)
    jq = jb.BCQuantizer(w.shape, groupsize=128, wbits=3, rounds=3, apot_nums=2)
    tq = tb.BCQuantizer(w.shape, groupsize=128, wbits=3, rounds=3, apot_nums=2)
    assert not tq.ready() and tq.num_groups == jq.num_groups == 2
    jret, _ = jq.quantize(jnp.asarray(w))
    tret, _ = tq.quantize(torch.from_numpy(w))
    assert tq.ready()
    assert _exact_share(tret.numpy(), jret) >= EXACT


@pytest.mark.parametrize("gs", [128, -1])
def test_bcq_rtn_weight_matches(gs):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(64, 256)).astype(np.float32) * 0.02
    want = np.asarray(jr.bcq_rtn_weight(jnp.asarray(w), 3, rounds=8,
                                        groupsize=gs))
    got = tr.bcq_rtn_weight(torch.from_numpy(w), 3, rounds=8,
                            groupsize=gs).numpy()
    assert _exact_share(got, want) >= EXACT
    je, te = _rel_sq_err(want, w), _rel_sq_err(got, w)
    assert abs(te - je) <= LOSS_RTOL * je
    # in_ch_wise groups along the input channels of the transposed weight
    want = np.asarray(jr.bcq_rtn_weight(jnp.asarray(w), 2, rounds=4,
                                        groupsize=32, in_ch_wise=True))
    got = tr.bcq_rtn_weight(torch.from_numpy(w), 2, rounds=4, groupsize=32,
                            in_ch_wise=True).numpy()
    assert _exact_share(got, want) >= EXACT


@pytest.mark.parametrize("gs,sym", [(-1, False), (32, True)])
def test_rtn_quantize_weight_matches(gs, sym):
    rng = np.random.default_rng(8)
    w = rng.normal(size=(48, 128)).astype(np.float32)
    want = np.asarray(jr.rtn_quantize_weight(jnp.asarray(w), 4, sym=sym,
                                             groupsize=gs))
    got = tr.rtn_quantize_weight(torch.from_numpy(w), 4, sym=sym,
                                 groupsize=gs).numpy()
    assert _exact_share(got, want) >= EXACT
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _hessian(rng, cols, n=512):
    x = rng.normal(size=(n, cols)).astype(np.float32)
    x[:, ::7] *= 3.0  # uneven diagonal, so act-order permutes
    return (2.0 / n * x.T @ x).astype(np.float32)


# With act-order, the JAX package fits alphas on the permuted groups but
# indexes them by the original column's group (gptq.py group_of); the
# port keeps that as it is. It costs quality, not correctness: pack_model
# recovers the signs against the same alphas.
@pytest.mark.parametrize("gs,actorder,bits", [(128, False, 3), (-1, False, 2),
                                              (64, True, 3)])
def test_gptq_lut_mode_matches(gs, actorder, bits):
    rng = np.random.default_rng(abs(gs) + 3 * actorder + bits)
    rows, cols = 48, 256
    W = rng.normal(size=(rows, cols)).astype(np.float32) * 0.05
    H = _hessian(rng, cols)
    kw = dict(mode="lut", bits=bits, groupsize=gs, actorder=actorder,
              bcq_rounds=5, apot_nums=2)
    jout = jg.gptq_quantize(jnp.asarray(W), jnp.asarray(H),
                            jg.SolverConfig(**kw))
    tout = tg.gptq_quantize(torch.from_numpy(W), torch.from_numpy(H),
                            tg.SolverConfig(**kw))
    assert set(tout) == {"Q", "loss", "perm", "alpha"}
    assert tout["alpha"].shape == jout["alpha"].shape
    assert _exact_share(tout["alpha"].numpy(), jout["alpha"]) >= EXACT
    assert _exact_share(tout["Q"].numpy(), jout["Q"]) >= EXACT
    jl, tl = float(jout["loss"]), float(tout["loss"])
    assert abs(jl - tl) <= LOSS_RTOL * abs(jl) + 1e-9, (jl, tl)
    np.testing.assert_array_equal(tout["perm"].numpy(), np.asarray(jout["perm"]))
