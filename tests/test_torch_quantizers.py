"""The port's other quantizers against gptq_tpu on the same numpy inputs
(CPU, f32): the non-linear codebook grid (all_codebooks,
nonlinear_find_params, nonlinear_quantize), the solver's nonlinear,
columnwise, sparse_outliers and nearest modes, the GPTQ class (analyse,
the conv1d / conv2d reshapes, conv2d patches), analyse_model /
derive_quant_config, and the activation quantizers (add_actquant's
parameters, logits with act_q, the fused gates with act_q). Where the
reference has a fault (its act-order non-linear fit reads the unpermuted
calibration mean), test_nonlinear_actorder_mean_fault asserts both results.

Solver tolerances are those of tests/test_reference_parity.py:18-23:
both sides factorize the Hessian with different LAPACK kernels, so a
weight within ~1e-6 of a rounding boundary may flip; >= 99.5% of entries
equal to 1e-5 and proxy losses within 1%. The non-linear search's loss is
one f32 mean over the whole weight, so on a near tie the frameworks'
summation orders may pick different (codebook, scale) pairs: where they
do, the test states the tie (the two choices' losses within 1e-6
relative)."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu import analysis as janalysis
from gptq_tpu import pipeline as jpipe
from gptq_tpu.models import common as jc
from gptq_tpu.quant import conv as jconv
from gptq_tpu.quant import gptq as jg
from gptq_tpu.quant import nonlinear as jn
from gptq_tpu_torch import analysis as tanalysis
from gptq_tpu_torch import pipeline as tpipe
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.quant import conv as tconv
from gptq_tpu_torch.quant import gptq as tg
from gptq_tpu_torch.quant import nonlinear as tn
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the non-linear grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hyperbits,wbits", [(5, 3), (4, 2), (6, 3), (5, 1)])
def test_all_codebooks_match(hyperbits, wbits):
    np.testing.assert_array_equal(tn.all_codebooks(hyperbits, wbits),
                                  jn.all_codebooks(hyperbits, wbits))


def _nl_loss(x, scale, zero, book, hyperbits, inp=None):
    """The search's loss of one (codebook, scale) choice (the port's)."""
    dq = tn.nonlinear_quantize(x, scale, zero, book, hyperbits)
    if inp is None:
        return float(torch.mean((x - dq) ** 2))
    return float(torch.mean((x @ inp - dq @ inp) ** 2))


@pytest.mark.parametrize("use_input", [False, True])
@pytest.mark.parametrize("seed,wbits,hyperbits", [(0, 3, 5), (1, 2, 4)])
def test_nonlinear_find_params_matches(use_input, seed, wbits, hyperbits):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(24, 64)) * 0.1).astype(np.float32)
    inp = rng.normal(size=(64,)).astype(np.float32)
    js, jz, jb = jn.nonlinear_find_params(
        jnp.asarray(x), wbits, hyperbits, 1, 20, inp=jnp.asarray(inp),
        use_input=use_input)
    tx, tinp = torch.from_numpy(x), torch.from_numpy(inp)
    ts, tz, tb = tn.nonlinear_find_params(tx, wbits, hyperbits, 1, 20,
                                          inp=tinp, use_input=use_input)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-9)
    if np.array_equal(tb.numpy(), np.asarray(jb)) and np.allclose(
            ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-9):
        # the same choice: quantize against it the same
        np.testing.assert_allclose(
            tn.nonlinear_quantize(tx, ts, tz, tb, hyperbits).numpy(),
            np.asarray(jn.nonlinear_quantize(jnp.asarray(x), js, jz, jb,
                                             hyperbits)),
            rtol=1e-6, atol=1e-6)
    else:  # a near tie: both choices' losses within 1e-6 relative
        lj = _nl_loss(tx, torch.from_numpy(np.asarray(js)), tz,
                      torch.from_numpy(np.asarray(jb)), hyperbits,
                      tinp if use_input else None)
        lt = _nl_loss(tx, ts, tz, tb, hyperbits, tinp if use_input else None)
        assert abs(lt - lj) <= 1e-6 * abs(lj), (lt, lj)


def test_nonlinear_search_keeps_the_first_minimum():
    """A weight of all-equal rows: every scale gives one loss per codebook,
    so the first scale of the first best codebook wins, as the JAX scan's
    strict `<` keeps it."""
    x = torch.tensor([[0.5, -0.25, 0.0, 0.125]] * 4)
    s, z, b = tn.nonlinear_find_params(x, 2, 4, 1, 4)
    js, jz, jb = jn.nonlinear_find_params(jnp.asarray(x.numpy()), 2, 4, 1, 4)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


def test_nonlinear_quantizer_class():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(8, 32)) * 0.2).astype(np.float32))
    q = tn.NonLinearQuantizer(wbits=3, hyperbits=5)
    with pytest.raises(ValueError, match="not ready"):
        q.quantize(x)
    q.find_params(x)
    y = q.quantize(x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    # at most 2^wbits distinct values a row
    assert all(len(torch.unique(r)) <= 8 for r in y)


# ---------------------------------------------------------------------------
# the solver's other modes
# ---------------------------------------------------------------------------

def _hessian(rng, cols, nbatch=4, tokens=64):
    jstate = jg.hessian_init(cols)
    tstate = tg.hessian_init(cols, device="cpu")
    for _ in range(nbatch):
        x = rng.normal(size=(1, tokens, cols)).astype(np.float32)
        x[..., 3] = 0.0  # a dead input column
        jstate = jg.hessian_update(jstate, jnp.asarray(x))
        tstate = tg.hessian_update(tstate, torch.from_numpy(x))
    return jstate, tstate


SOLVER_CASES = [
    dict(mode="nonlinear", bits=3),
    dict(mode="nonlinear", bits=3, groupsize=32),
    dict(mode="nonlinear", bits=2, hyperbits=4, groupsize=32, actorder=True,
         static_groups=True),
    dict(mode="columnwise", bits=3, bcq_rounds=3),
    dict(mode="columnwise", bits=3, groupsize=16, apot_nums=1),
    dict(mode="uniform", bits=3, sparse_outliers=True, mse=True),
    dict(mode="uniform", bits=4, nearest=True),
    dict(mode="nonlinear", bits=3, nearest=True, blocksize=32),
]


@pytest.mark.parametrize("cfg", SOLVER_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_solver_mode_matches(cfg):
    rng = np.random.default_rng(5)
    rows, cols = 48, 160  # 160 columns: a padded last block at blocksize 128
    W = (rng.normal(size=(rows, cols)) * 0.1).astype(np.float32)
    W[rng.random(size=W.shape) < 0.02] *= 8  # outliers for sparse_outliers
    (jH, _, jmean), (tH, _, tmean) = _hessian(rng, cols)
    jout = jg.gptq_quantize(jnp.asarray(W), jH, jg.SolverConfig(**cfg), jmean)
    tout = tg.gptq_quantize(torch.from_numpy(W), tH, tg.SolverConfig(**cfg),
                            tmean)
    assert set(tout) == set(jout)
    jQ, tQ = np.asarray(jout["Q"]), tout["Q"].numpy()
    exact = np.mean(np.abs(jQ - tQ) <= 1e-5)
    assert exact >= 0.995, exact
    jl, tl = float(jout["loss"]), float(tout["loss"])
    assert abs(jl - tl) <= 0.01 * abs(jl) + 1e-9, (jl, tl)
    for k in ("scale", "zero", "codebook"):
        if k in jout:
            assert tout[k].shape == jout[k].shape
            close = np.isclose(_np(tout[k]), np.asarray(jout[k]), rtol=1e-5,
                               atol=1e-7)
            assert close.mean() >= 0.99, (k, close.mean())
    if cfg.get("sparse_outliers"):
        jf, tf = float(jout["outlier_frac"]), float(tout["outlier_frac"])
        assert 0 < tf < 0.2 and abs(tf - jf) <= 2.0 / (rows * cols), (tf, jf)
    if cfg.get("nearest") and cfg["mode"] == "uniform":
        from gptq_tpu_torch.quant.rtn import rtn_quantize_weight

        np.testing.assert_allclose(
            tQ, rtn_quantize_weight(torch.from_numpy(W) * (tH.diag() != 0),
                                    bits=4).numpy(), atol=1e-5)


def test_nonlinear_actorder_mean_fault():
    """Under act-order the whole-row non-linear fit scores the permuted
    weight against the calibration mean. gptq_tpu passes the mean in the
    original column order, so each column meets another column's mean
    (ROADMAP queue 3, "Known faults in the reference"); the port permutes
    the mean with the weight."""
    rng = np.random.default_rng(6)
    rows, cols = 24, 64
    W = (rng.normal(size=(rows, cols)) * 0.1).astype(np.float32)
    W[:, :8] *= 6  # eight wide columns, where the calibration mean sits
    mean = np.zeros(cols, np.float32)
    mean[:8] = 3.0
    # inputs of distinct spread: act-order moves those columns last
    x = (rng.normal(size=(1, 256, cols)) * np.linspace(0.2, 3.0, cols)
         + mean).astype(np.float32)
    jH, _, jmean = jg.hessian_update(jg.hessian_init(cols), jnp.asarray(x))
    tH, _, tmean = tg.hessian_update(tg.hessian_init(cols, device="cpu"),
                                     torch.from_numpy(x))
    cfg = dict(mode="nonlinear", bits=3, actorder=True)
    jout = jg.gptq_quantize(jnp.asarray(W), jH, jg.SolverConfig(**cfg), jmean)
    tout = tg.gptq_quantize(torch.from_numpy(W), tH, tg.SolverConfig(**cfg),
                            tmean)
    perm = tout["perm"].numpy()
    np.testing.assert_array_equal(perm, np.asarray(jout["perm"]))
    assert not np.array_equal(perm, np.arange(cols))
    nl = tg.SolverConfig(**cfg)
    Wp = torch.from_numpy(W[:, perm])
    fit = {name: tn.nonlinear_find_params(
        Wp, nl.bits, nl.hyperbits, nl.explore_bits, nl.explore_split,
        inp=inp, use_input=True)
        for name, inp in (("fault", torch.from_numpy(np.array(jmean))),
                          ("intended", tmean[torch.from_numpy(perm)]))}
    # the two fits differ on these inputs
    assert not (torch.equal(fit["fault"][2], fit["intended"][2])
                and torch.allclose(fit["fault"][0], fit["intended"][0]))
    # the JAX solver's grid is the fault's, the port's the intended one
    np.testing.assert_array_equal(np.asarray(jout["codebook"][0]),
                                  fit["fault"][2].numpy())
    np.testing.assert_allclose(np.asarray(jout["scale"][0]),
                               fit["fault"][0].numpy(), rtol=1e-6)
    assert torch.equal(tout["codebook"][0], fit["intended"][2])
    assert torch.equal(tout["scale"][0], fit["intended"][0])


def test_columnwise_refit_reads_the_next_eight_columns():
    """Columnwise alphas come from W1[:, i:i+8] flattened row-major: with
    error feedback off and 8 identical columns, every column of a chunk
    quantizes the same."""
    rng = np.random.default_rng(2)
    col = (rng.normal(size=(16, 1)) * 0.1).astype(np.float32)
    W = torch.from_numpy(np.tile(col, (1, 16)))
    out = tg.gptq_quantize(W, torch.eye(16),
                           tg.SolverConfig(mode="columnwise", bits=2,
                                           nearest=True, blocksize=16))
    Q = out["Q"]
    assert torch.equal(Q[:, :8], Q[:, :1].expand(-1, 8))
    assert "scale" not in out and "alpha" not in out


# ---------------------------------------------------------------------------
# the GPTQ class and conv layers
# ---------------------------------------------------------------------------

def test_conv2d_patches_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    for ks, st, pad, dil in [((3, 3), (1, 1), (0, 0), (1, 1)),
                             ((2, 2), (2, 2), (1, 1), (1, 1)),
                             ((3, 2), (1, 2), (1, 0), (2, 1))]:
        want = np.asarray(jconv.conv2d_patches(jnp.asarray(x), ks, st, pad,
                                               dil))
        got = tconv.conv2d_patches(torch.from_numpy(x), ks, st, pad,
                                   dil).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "conv1d", "conv2d"])
def test_gptq_class_matches(kind):
    rng = np.random.default_rng(11)
    if kind == "conv2d":
        W = (rng.normal(size=(8, 3, 3, 3)) * 0.3).astype(np.float32)
        xs = [rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
              for _ in range(3)]
        ccfg = {"padding": (1, 1)}
    else:
        W = (rng.normal(size=(24, 40) if kind == "linear" else (40, 24))
             * 0.3).astype(np.float32)
        xs = [rng.normal(size=(2, 16, 40)).astype(np.float32)
              for _ in range(3)]
        ccfg = None
    jgq = jg.GPTQ(jnp.asarray(W), kind=kind, conv_cfg=ccfg)
    tgq = tg.GPTQ(torch.from_numpy(W), kind=kind, conv_cfg=ccfg)
    for x in xs:
        jgq.add_batch(jnp.asarray(x))
        tgq.add_batch(torch.from_numpy(x))
    assert tgq.nsamples == jgq.nsamples
    np.testing.assert_allclose(tgq.state[0].numpy(), np.asarray(jgq.state[0]),
                               rtol=1e-5, atol=1e-5)
    cfg = dict(bits=4, blocksize=16)
    jout = jgq.fasterquant(jg.SolverConfig(**cfg))
    tout = tgq.fasterquant(tg.SolverConfig(**cfg))
    assert tuple(tout["Q"].shape) == W.shape
    exact = np.mean(np.abs(np.asarray(jout["Q"]) - tout["Q"].numpy()) <= 1e-5)
    assert exact >= 0.995, exact
    # analyse: the same statistics (std with one degree of freedom taken)
    ja, ta = jgq.analyse(), tgq.analyse()
    for axis in ("rowwise", "columnWise"):
        for what in ("w", "wa", "wh"):
            for stat in ("max", "min", "mean", "std"):
                want = np.asarray(ja[axis][what][stat])
                np.testing.assert_allclose(
                    ta[axis][what][stat].numpy(), want, rtol=1e-4,
                    atol=1e-4 * np.abs(want).max(), err_msg=(axis, what, stat))


def test_gptq_class_refuses_unknown_kind():
    with pytest.raises(ValueError, match="unknown layer kind"):
        tg.GPTQ(torch.zeros(4, 4), kind="conv3d")


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

OPT = dict(arch="opt", n_layers=2, hidden=32, n_heads=4, ffn=64, vocab=61,
           max_pos=64, act="relu", pos="learned", norm_type="layernorm",
           linear_bias=True, tie_embeddings=False)


def test_analyse_model_and_config_match(tmp_path):
    jspec, tspec = jc.ArchSpec(**OPT), tc.ArchSpec(**OPT)
    jp = jc.init_params(jspec, jax.random.PRNGKey(0))
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    calib = np.random.default_rng(0).integers(0, 61, size=(2, 16))
    jst = janalysis.analyse_model(jspec, jp, jnp.asarray(calib),
                                  log=lambda s: None)
    tst = tanalysis.analyse_model(tspec, tp, torch.from_numpy(calib),
                                  log=lambda s: None)
    assert set(tst) == set(jst) and len(tst) == 12
    for name in jst:
        for axis in ("rowwise", "columnWise"):
            for what in ("w", "wa", "wh"):
                for stat in ("max", "min", "mean", "std"):
                    want = np.asarray(jst[name][axis][what][stat])
                    # a mean of W * a cancels: 1e-4 of the largest entry
                    np.testing.assert_allclose(
                        tst[name][axis][what][stat], want, rtol=1e-4,
                        atol=1e-4 * np.abs(want).max())
    jcfg = janalysis.derive_quant_config(jst, bits=3,
                                         out_path=str(tmp_path / "j.json"))
    tcfg = tanalysis.derive_quant_config(tst, bits=3,
                                         out_path=str(tmp_path / "t.json"))
    assert tcfg == jcfg
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    assert {v["columnwise"] for v in tcfg.values()} == {True, False}


def test_sensitivity_logs_and_plots(tmp_path):
    losses = {f"model.decoder.layers.0.{n}": float(i)
              for i, n in enumerate(["self_attn.q_proj", "fc1", "fc2"])}
    janalysis.save_sensitivity_log(losses, str(tmp_path / "j.txt"))
    tanalysis.save_sensitivity_log(losses, str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    W = np.random.default_rng(0).normal(size=(130, 200))
    for name, ok in (
            ("s.png", tanalysis.plot_sensitivity(losses,
                                                 str(tmp_path / "s.png"))),
            ("d.png", tanalysis.plot_sensitivity_diff(
                losses, {k: v + 1 for k, v in losses.items()},
                str(tmp_path / "d.png"))),
            ("w2.png", tanalysis.plot_distribution2d(
                W, str(tmp_path / "w2.png"))),
            ("w3.png", tanalysis.plot_distribution3d(
                W, str(tmp_path / "w3.png"), max_cells=32))):
        # matplotlib is optional: without it the helpers return False
        assert ok == (tmp_path / name).exists()


# ---------------------------------------------------------------------------
# activation quantizers
# ---------------------------------------------------------------------------

LLAMA = dict(arch="llama", n_layers=2, hidden=128, n_heads=4, n_kv_heads=2,
             ffn=256, vocab=61, max_pos=64, act="silu", pos="rope",
             norm_type="rmsnorm", linear_bias=False)


def _actq_pair(arch_kw, bits=8):
    jspec, tspec = jc.ArchSpec(**arch_kw), tc.ArchSpec(**arch_kw)
    jp = jc.init_params(jspec, jax.random.PRNGKey(1))
    tp = params_from_jax(to_numpy_tree(jp), device="cpu")
    ids = np.random.default_rng(0).integers(0, arch_kw["vocab"],
                                            size=(2, 16))
    jpipe.add_actquant(jspec, jp, jnp.asarray(ids), bits=bits)
    tpipe.add_actquant(tspec, tp, torch.from_numpy(ids), bits=bits)
    return jspec, jp, tspec, tp, ids


@pytest.mark.parametrize("arch_kw", [LLAMA, OPT], ids=["llama", "opt"])
def test_add_actquant_matches(arch_kw):
    jspec, jp, tspec, tp, ids = _actq_pair(arch_kw)
    from gptq_tpu_torch.models.registry import get_arch

    keys = get_arch(tspec.arch).linears.values()
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for key in keys:
            ja, ta = jl[key]["act_q"], tl[key]["act_q"]
            assert ta["maxq"] == ja["maxq"] == 255
            # layer 1's inputs come through layer 0's fake quantization,
            # f32 on both sides in another order: grids within 1e-4, a zero
            # point at a rounding tie may move by one
            np.testing.assert_allclose(ta["scale"].numpy(),
                                       np.asarray(ja["scale"]), rtol=1e-4)
            dz = np.abs(ta["zero"].numpy() - np.asarray(ja["zero"]))
            assert dz.max() <= 1 and np.mean(dz == 0) >= 0.99
    # logits with act_q: the fake quantization of every linear's input
    x = torch.from_numpy(ids)
    jlog, _ = jc.model_forward(jspec, jp, jnp.asarray(ids))
    tlog, _ = tc.model_forward(tspec, tp, x)
    want = np.asarray(jlog)
    err = np.abs(tlog.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


def test_act_q_changes_logits_and_rides_fusion(monkeypatch):
    """act_q moves the logits a little at 8 bits; fuse_serving carries the
    shared quantizer of q / k / v onto the fused entry (as the JAX
    package does), and the fused kernels' gates stand down on it."""
    from test_torch_fused_serving import _pair

    jspec, jp, tspec, tp = _pair(((4, -1, False), (4, -1, False)))
    ids = np.random.default_rng(0).integers(0, 384, size=(1, 12))
    before, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    # fit on the packed model itself: calibration runs through #1
    tpipe.add_actquant(tspec, tp, torch.from_numpy(ids), bits=8)
    jpipe.add_actquant(jspec, jp, jnp.asarray(ids), bits=8)
    after, _ = tc.model_forward(tspec, tp, torch.from_numpy(ids))
    d = float((before - after).abs().max() / before.abs().max())
    assert 0 < d < 0.05, d
    monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", "interpret")
    js, ts = jc.fuse_serving(jspec, jp, a8=True), tc.fuse_serving(tspec, tp,
                                                                  a8=True)
    for jl, tl in zip(js["layers"], ts["layers"]):
        assert set(tl) == set(jl)  # q|k|v and gate|up fuse in both
        assert tl["qkv_fused"]["act_q"] is not None
        for n in (1, 4):
            assert tc._norm_qkv_ok(tspec, tl, None, n, "cpu") is None
            assert jc._norm_qkv_ok(jspec, jl, None, None, n) is None
            assert tc._attn_mlp_ok(tspec, tl, None, n, "cpu") is None
            assert jc._attn_mlp_ok(jspec, jl, None, None, n) is None
            assert tc._ffn_fusion_entry(tl, None, "cpu") is None
            assert jc._ffn_fusion_entry(jl, None, None) is None
    # served logits (unfused route, act_q on every linear) against JAX's
    jlog, _ = jc.model_forward(jspec, js, jnp.asarray(ids))
    tlog, _ = tc.model_forward(tspec, ts, torch.from_numpy(ids))
    want = np.asarray(jlog)
    err = np.abs(tlog.numpy() - want).max() / np.abs(want).max()
    assert err <= 5e-2, err  # the w4a8 bound of test_torch_model.py
    # quantizers that differ keep the parts apart
    tl0 = dict(tp["layers"][0])
    tl0["v"] = {**tl0["v"], "act_q": {**tl0["v"]["act_q"],
                                      "zero": tl0["v"]["act_q"]["zero"] + 1}}
    t2 = tc.fuse_serving(tspec, {**tp, "layers": [tl0]}, a8=False)
    assert "qkv_fused" not in t2["layers"][0]
    assert tc.same_actq(None, None) and not tc.same_actq(
        None, tl0["v"]["act_q"])
