"""Expert-parallel serving of the port (models/moe.py's ep slicing,
parallel/ep.py, engine/serving.EPEngine, cli --ep) against gptq_tpu on
the CPU.

Each rank's expert slice meets the JAX package's ep_specs bit for bit in
this process; ep = 2 runs in two gloo processes and ep x tp = 2 x 2 in
four (tests/torch_parallel_worker.py), against the JAX package's
shard_map on the 8-device CPU mesh."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gptq_tpu.engine import serving as jserve
from gptq_tpu.models import common as jc
from gptq_tpu.models import moe as jm
from gptq_tpu.parallel import ep as jep
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.parallel import ep as tep
from test_torch_tp import (A8_TOL, F32_TOL, finish, launch, packed_jax_model,
                           rel_err, to_port, _cut, _jax_tp_run)
from torch_threads import torch_threads  # noqa: F401 (autouse)

# tests/test_ep.py's MoE model (capacity 2.0 = E / k: dropless)
MOE = dict(arch="llama", n_layers=2, hidden=48, n_heads=4, n_kv_heads=2,
           ffn=64, vocab=89, max_pos=64, norm_eps=1e-5, act="silu",
           pos="rope", norm_type="rmsnorm", linear_bias=False,
           tie_embeddings=False, n_experts=4, expert_top_k=2,
           expert_capacity=2.0)
TIGHT = {**MOE, "expert_capacity": 0.75}  # capacity-bound: tokens drop
# Mixtral's shape in small: 8 experts, top 2, so that an ep = 2 rank's 4
# local experts take the select kernel's path at one token
PACKED = {**MOE, "n_experts": 8, "expert_capacity": 4.0}
# tests/test_ep.py's ep x tp model: packed attention at serving width
ATTN = dict(arch="llama", n_layers=1, hidden=1024, n_heads=4, n_kv_heads=4,
            ffn=256, vocab=96, max_pos=64, norm_eps=1e-5, act="silu",
            pos="rope", norm_type="rmsnorm", linear_bias=False,
            tie_embeddings=False, n_experts=4, expert_top_k=2,
            expert_capacity=2.0)


def _flat_greedy(jspec, jp, prompt, n):
    """The JAX package's single-device greedy stream (tests/test_serving)."""
    cache = jc.KVCache.init(jspec, 1, 16, jnp.float32)
    logits, cache = jc.model_forward(jspec, jp, jnp.asarray(prompt), cache)
    out = []
    for _ in range(n):
        t = int(jnp.argmax(logits[0, -1]))
        out.append(t)
        logits, cache = jc.model_forward(jspec, jp, jnp.asarray([[t]]), cache)
    return out


@pytest.mark.parametrize("kind", ["dense", "int8", "packed"])
def test_ep_specs_slices_match_jax(kind):
    """Both ranks' expert stacks equal the JAX ep_specs slices (P(axis) on
    the expert dim); every other leaf is the whole tensor, shared."""
    jspec = jc.ArchSpec(**MOE)
    jp = jc.init_params(jspec, jax.random.PRNGKey(7))
    if kind == "int8":
        jm.quantize_experts(jp)
    elif kind == "packed":
        jm.pack_experts(jp, bits=4)
    tparams = to_port(jp)
    specs = jep.ep_specs(jp)
    for rank in range(2):
        local = tep.ep_specs(tparams, 2, rank)
        for jl, sl, tl, tw in zip(jp["layers"], specs["layers"],
                                  local["layers"], tparams["layers"]):
            for name, val in jl["experts"].items():
                got = tl["experts"][name]
                spec = sl["experts"][name]
                if kind == "packed":
                    assert isinstance(got, tpack.PackedExperts)
                    assert got.E == 2 and got.N == val.N and got.K == val.K
                    for a, w in zip(got.words, val.words):
                        np.testing.assert_array_equal(
                            a.numpy(), _cut(w, spec, rank, 2))
                    for f in ("scale", "zoff"):
                        np.testing.assert_array_equal(
                            getattr(got, f).numpy(),
                            _cut(getattr(val, f), spec, rank, 2))
                else:
                    np.testing.assert_array_equal(got.numpy(),
                                                  _cut(val, spec, rank, 2))
            assert tl["router"] is tw["router"] and tl["q"] is tw["q"]
        assert local["lm_head"] is tparams["lm_head"]


def test_ep_refusals():
    tspec = tc.ArchSpec(**{**MOE, "n_experts": 0})
    with pytest.raises(ValueError, match="n_experts == 0"):
        tep._check(tspec, 2)
    with pytest.raises(ValueError, match="% ep 3"):
        tep._check(tc.ArchSpec(**MOE), 3)


def test_ep2_two_processes_match_jax(tmp_path):
    """Two port ranks on a gloo group against gptq_tpu's shard_map ep = 2:
    make_ep_forward (dense f32) and make_ep_decode_step on an int8 cache,
    the capacity-bound GShard forward (tokens drop on both sides alike);
    EPEngine.generate on 4-bit expert banks (8 experts, 4 a rank: the
    select path at one token) against the JAX package's single-device
    stream, its chained benchmark's PPL against the forced stream's and
    "graph": false off the card; the CLI's --ep 2 writes one result
    line."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("ep",))
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, 89, size=(1, 6))
    ids = rng.integers(0, 89, size=(2, 16))
    bench = rng.integers(0, 89, size=12)
    toks = [4, 9]
    np.savez(str(tmp_path / "in.npz"), prompt=prompt, ids=ids,
             toks=np.asarray(toks), bench=bench)
    jspec = jc.ArchSpec(**MOE)
    jp = jc.init_params(jspec, jax.random.PRNGKey(15))
    tio.save_checkpoint(str(tmp_path / "moe.npz"), tc.ArchSpec(**MOE),
                        to_port(jp))
    tspec_j = jc.ArchSpec(**TIGHT)
    jt = jc.init_params(tspec_j, jax.random.PRNGKey(16))
    tio.save_checkpoint(str(tmp_path / "moe_tight.npz"), tc.ArchSpec(**TIGHT),
                        to_port(jt))
    pspec = jc.ArchSpec(**PACKED)
    jpk = jc.init_params(pspec, jax.random.PRNGKey(17))
    jm.pack_experts(jpk, bits=4)
    tio.save_checkpoint(str(tmp_path / "moe_packed.npz"),
                        tc.ArchSpec(**PACKED), to_port(jpk))

    procs = launch("ep", 2, tmp_path)
    try:
        want = {}
        want["fwd"] = np.asarray(jep.make_ep_forward(jspec, jp, mesh)(
            jp, jnp.asarray(ids)))
        step = jep.make_ep_decode_step(jspec, jp, mesh, int8_cache=True)
        want["int8"], _ = _jax_tp_run(lambda p, c, t: step(p, c, t), jp,
                                      jspec, prompt, toks, jnp.int8)
        want["tight_fwd"] = np.asarray(jep.make_ep_forward(
            tspec_j, jt, mesh)(jt, jnp.asarray(ids)))
        want_gen = _flat_greedy(pspec, jpk, prompt, 5)
        cache = jc.KVCache.init(pspec, 1, 16, jnp.float32)
        nll = []
        for i in range(len(bench) - 1):
            lg, cache = jc.model_forward(pspec, jpk,
                                         jnp.asarray([[bench[i]]]), cache)
            lp = jax.nn.log_softmax(lg[0, -1].astype(jnp.float32))
            nll.append(-float(lp[bench[i + 1]]))
        want_ppl = float(np.exp(np.mean(nll)))
    finally:
        outs = finish("ep", procs)
    for r in range(2):
        got = np.load(str(tmp_path / f"ep{r}.npz"))
        for key in ("fwd", "int8", "tight_fwd"):
            assert rel_err(got[key], want[key]) < F32_TOL, key
        assert got["generate"][0].tolist() == want_gen
        assert abs(float(got["bench_ppl"]) - want_ppl) / want_ppl < 2e-3
        assert not bool(got["bench_graph"])
    lines = [[ln for ln in out.splitlines() if ln.startswith('{"benchmark"')]
             for out in outs]
    assert len(lines[0]) == 1 and not lines[1]
    res = json.loads(lines[0][0])
    assert res["protocol"] == "chained-ep2" and res["benchmark"]["ep"] == 2
    assert res["benchmark"]["graph"] is False
    log = (tmp_path / "ppl.txt").read_text().splitlines()
    assert len(log) == 1 and "protocol = chained-ep2" in log[0]


def test_ep_tp_four_processes_match_jax(tmp_path):
    """ep x tp = 2 x 2 in four gloo processes against gptq_tpu's
    make_ep_tp_decode_step on a (2, 2) mesh: packed fused a8 attention
    over tp, int8 expert stacks over ep, prefill + decode (TOL
    logits_a8, greedy tokens equal); and make_ep_tp_forward on the dense
    model (1e-4)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("ep", "tp"))
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, 89, size=(1, 6))
    ids = rng.integers(0, 89, size=(2, 16))
    toks = [3]
    np.savez(str(tmp_path / "in.npz"), prompt=prompt, ids=ids,
             toks=np.asarray(toks))
    aspec, ja = packed_jax_model(ATTN, seed=12, groupsize=128,
                                 act_order=True)
    jm.quantize_experts(ja)
    tio.save_checkpoint(str(tmp_path / "moe_attn.npz"), tc.ArchSpec(**ATTN),
                        to_port(ja))
    jspec = jc.ArchSpec(**MOE)
    jp = jc.init_params(jspec, jax.random.PRNGKey(18))
    tio.save_checkpoint(str(tmp_path / "moe.npz"), tc.ArchSpec(**MOE),
                        to_port(jp))

    procs = launch("eptp", 4, tmp_path)
    try:
        local, step = jep.make_ep_tp_decode_step(aspec, ja, mesh, fuse=True,
                                                 a8=True)
        want_a8, want_greedy = _jax_tp_run(step, local, aspec, prompt, toks,
                                           jnp.float32, greedy=3)
        local, fwd = jep.make_ep_tp_forward(jspec, jp, mesh)
        want_fwd = np.asarray(fwd(local, jnp.asarray(ids)))
    finally:
        finish("eptp", procs)
    for r in range(4):
        got = np.load(str(tmp_path / f"eptp{r}.npz"))
        assert rel_err(got["a8"], want_a8) < A8_TOL
        assert got["a8_greedy"].tolist() == want_greedy
        assert rel_err(got["fwd"], want_fwd) < F32_TOL


def test_ep_engine_refuses_a_dense_model():
    with pytest.raises(ValueError, match="n_experts == 0"):
        from gptq_tpu_torch.engine.serving import EPEngine

        EPEngine(tc.ArchSpec(**{**MOE, "n_experts": 0}), {}, ep=2,
                 device="cpu")
    assert jserve.EPEngine  # the JAX engine this one ports
