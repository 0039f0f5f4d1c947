"""Tensor-parallel serving of the port (ops/pack.py's tp padding and
shard-interleaved fusion, parallel/tp.py, models/common.py's tp hooks,
engine/decode.py and cli --tp) against gptq_tpu on the CPU.

Packing and each rank's local params meet the JAX package bit for bit
(the slices its tp_local_view partition specs cut). tp = 2 runs in two
gloo processes (tests/torch_parallel_worker.py) against the JAX
package's shard_map tp = 2 on the 8-device CPU mesh."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gptq_tpu import pipeline as jpipe
from gptq_tpu.models import common as jc
from gptq_tpu.models.registry import get_arch
from gptq_tpu.ops import pack as jpack
from gptq_tpu.parallel import tp as jtp
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.models import common as tc
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.parallel import tp as ttp
from gptq_tpu_torch.weights import params_from_jax, to_numpy_tree
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
F32_TOL = 1e-4  # f32 logits, relative to max |logit|
A8_TOL = 1.6e-2  # a8 logits (chip_smoke TOL["logits_a8"]), relative

# packed row shards need Kp / tp to hold whole 512-row subblocks: 1024
# wide at tp = 2 (tests/test_parallel.py's serving-scale sizes)
LLAMA = dict(arch="llama", n_layers=2, hidden=1024, n_heads=8, n_kv_heads=4,
             ffn=1024, vocab=96, max_pos=64, norm_eps=1e-5, act="silu",
             pos="rope", norm_type="rmsnorm", linear_bias=False,
             tie_embeddings=False)
FAMILIES = {
    "llama": LLAMA,
    "opt": dict(arch="opt", n_layers=1, hidden=1024, n_heads=8, ffn=1024,
                vocab=96, max_pos=64, act="relu", pos="learned",
                norm_type="layernorm"),
    "bloom": dict(arch="bloom", n_layers=1, hidden=1024, n_heads=8,
                  ffn=1024, vocab=96, max_pos=64, act="gelu_tanh",
                  pos="alibi", norm_type="layernorm", tie_embeddings=True),
    "gemma": dict(arch="gemma", n_layers=1, hidden=1024, n_heads=4,
                  n_kv_heads=2, head_dim=256, ffn=1024, vocab=96, max_pos=64,
                  act="gelu_tanh", pos="rope", norm_type="rmsnorm1p",
                  linear_bias=False, tie_embeddings=True,
                  embed_scale=32.0),
}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _grid(rng, N, K, bits, groupsize, act_order, perm=None):
    """A weight on a quantization grid: (W (N, K) f32, quantizer entry of
    the JAX pipeline's pack_model); act_order stores it permuted by
    `perm` (a random one if None)."""
    ng = K // groupsize if groupsize > 0 else 1
    codes = rng.integers(0, 1 << bits, size=(N, K))
    scale = rng.uniform(0.005, 0.02, size=(ng, N)).astype(np.float32)
    zero = rng.integers(0, 1 << bits, size=(ng, N)).astype(np.float32)
    g = np.arange(K) // (K // ng)
    Qp = (scale[g].T * (codes - zero[g].T)).astype(np.float32)
    if act_order and perm is None:
        perm = rng.permutation(K).astype(np.int32)
    elif not act_order:
        perm = None
    W = np.empty_like(Qp)
    if perm is None:
        W = Qp
    else:
        W[:, perm] = Qp
    q = {"mode": "uniform", "bits": bits, "scale": jnp.asarray(scale),
         "zero": jnp.asarray(zero), "groupsize": groupsize,
         "perm": None if perm is None else jnp.asarray(perm)}
    return W, q


def packed_jax_model(kw, seed, groupsize=-1, act_order=False, tp=2,
                     quant_head=False, bits=4):
    """(JAX spec, JAX params) of the family in `kw`, every linear packed
    from a random grid (act_order: stored permuted) with pack_model(tp=)."""
    spec = jc.ArchSpec(**kw)
    params = jc.init_params(spec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    arch = get_arch(spec.arch)
    quantizers = {}
    for i, bp in enumerate(params["layers"]):
        perms = {}  # one permutation a width: q / k / v and gate / up
        # share theirs (one Hessian), so they fuse as GPTQ's would
        for name, key in arch.linears.items():
            if key not in bp:
                continue
            N, K = bp[key]["w"].shape
            if K not in perms:
                perms[K] = rng.permutation(K).astype(np.int32)
            W, q = _grid(rng, N, K, bits, groupsize, act_order, perms[K])
            bp[key]["w"] = jnp.asarray(W)
            quantizers[f"{arch.hf_prefix}.{i}.{name}"] = q
    from gptq_tpu.config import QuantConfig

    jpipe.pack_model(spec, params, quantizers, QuantConfig(wbits=bits),
                     tp=tp)
    if quant_head:
        jpipe.quantize_lm_head(spec, params, bits=8, tp=tp)
    return spec, params


def to_port(jp):
    return params_from_jax(to_numpy_tree(jp), device="cpu")


# ---------------------------------------------------------------------------
# packing for tp, bit for bit
# ---------------------------------------------------------------------------

def _eq(t, a):
    if t is None or a is None:
        assert t is None and a is None
        return
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def _same_packed(tw, jw):
    assert (tw.K, tw.N, tw.bits, tw.groupsize, tw.fmt) == (
        jw.K, jw.N, jw.bits, jw.groupsize, jw.fmt)
    assert len(tw.words) == len(jw.words)
    for a, b in zip(tw.words, jw.words):
        _eq(a, b)
    for f in ("scale", "zoff", "alpha", "bias", "perm"):
        _eq(getattr(tw, f), getattr(jw, f))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("groupsize,act_order", [(-1, False), (128, True)])
def test_pack_quantized_tp_padding_matches_jax(tp, groupsize, act_order):
    """K pads to 2048 in units of 512 * tp; N 1000 to 1024 at tp 2 and
    stays at tp 4 (2048 would pad more than 12.5%)."""
    rng = np.random.default_rng(tp * 10 + groupsize)
    W, q = _grid(rng, 1000, 1900 if groupsize < 0 else 1920, 4, groupsize,
                 act_order)
    perm = q["perm"]
    jw = jpack.pack_quantized(jnp.asarray(W), q["scale"], q["zero"], 4,
                              groupsize=groupsize, perm=perm,
                              actorder=act_order, tp=tp)
    tw = tpack.pack_quantized(
        torch.from_numpy(W), torch.from_numpy(np.array(q["scale"])),
        torch.from_numpy(np.array(q["zero"])), 4, groupsize=groupsize,
        perm=None if perm is None else torch.from_numpy(np.array(perm)),
        actorder=act_order, tp=tp)
    assert tw.Kp == 2048
    _same_packed(tw, jw)


@pytest.mark.parametrize("groupsize", [-1, 128])
def test_pack_bcq_tp_padding_matches_jax(groupsize):
    rng = np.random.default_rng(3 + groupsize)
    N, K, bits = 1000, 1920, 3
    g = groupsize if groupsize > 0 else K
    B = np.where(rng.random((N, K // g, g, bits)) < 0.5, -1.0, 1.0)
    alpha = rng.uniform(0.01, 0.1, size=(N, K // g, bits))
    jw = jpack.pack_bcq(jnp.asarray(B, jnp.float32),
                        jnp.asarray(alpha, jnp.float32),
                        groupsize=groupsize, tp=2)
    tw = tpack.pack_bcq(torch.from_numpy(B).float(),
                        torch.from_numpy(alpha).float(),
                        groupsize=groupsize, tp=2)
    assert tw.Kp == 2048
    _same_packed(tw, jw)


@pytest.mark.parametrize("fmt", ["uniform", "bcq"])
def test_fuse_packed_tp_interleave_matches_jax(fmt):
    """fuse_packed(tp=2) orders N [q0 k0 v0 q1 k1 v1]: each half is the
    standard fusion of one rank's column shards."""
    rng = np.random.default_rng(5)
    js, ts = [], []
    for N in (1024, 512, 512):
        if fmt == "bcq":
            B = np.where(rng.random((N, 1, 1024, 2)) < 0.5, -1.0, 1.0)
            alpha = rng.uniform(0.01, 0.1, size=(N, 1, 2))
            js.append(jpack.pack_bcq(jnp.asarray(B, jnp.float32),
                                     jnp.asarray(alpha, jnp.float32), tp=2))
            ts.append(tpack.pack_bcq(torch.from_numpy(B).float(),
                                     torch.from_numpy(alpha).float(), tp=2))
        else:
            W, q = _grid(rng, N, 1024, 4, 128, False)
            js.append(jpack.pack_quantized(jnp.asarray(W), q["scale"],
                                           q["zero"], 4, groupsize=128,
                                           tp=2))
            ts.append(tpack.pack_quantized(
                torch.from_numpy(W), torch.from_numpy(np.array(q["scale"])),
                torch.from_numpy(np.array(q["zero"])), 4, groupsize=128,
                tp=2))
    jf, tf = jpack.fuse_packed(js, tp=2), tpack.fuse_packed(ts, tp=2)
    _same_packed(tf, jf)
    plain = tpack.fuse_packed(ts)
    half = tf.Np // 2
    for r in range(2):  # a rank's half = the fusion of its shards
        shards = [ttp._packed_local(t, "col", 2, r) for t in ts]
        want = tpack.fuse_packed(shards)
        got = ttp._packed_local(tf, "col", 2, r)
        assert got.N == half and torch.equal(got.words[0], want.words[0])
    assert not torch.equal(plain.words[0], tf.words[0])


# ---------------------------------------------------------------------------
# each rank's local params against the JAX package's partition specs
# ---------------------------------------------------------------------------

def _cut(a, pspec, rank, tp):
    a = np.asarray(a)
    for d, ax in enumerate(pspec):
        if ax is not None:
            n = a.shape[d] // tp
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=d)
    return a


def _same_view(jl, js, tl, rank, tp, path="params"):
    """Port local params tl == the JAX local params jl cut by specs js."""
    if jl is None:
        assert tl is None, path
    elif isinstance(jl, jpack.PackedWeight):
        assert isinstance(tl, tpack.PackedWeight), path
        assert (tl.K, tl.N, tl.bits, tl.groupsize, tl.fmt) == (
            jl.K, jl.N, jl.bits, jl.groupsize, jl.fmt), path
        for a, w, s in zip(tl.words, jl.words, js.words):
            np.testing.assert_array_equal(a.numpy(), _cut(w, s, rank, tp),
                                          err_msg=path)
        for f in ("scale", "zoff", "alpha", "bias", "perm"):
            j = getattr(jl, f)
            if j is None:
                assert getattr(tl, f) is None, (path, f)
            else:
                np.testing.assert_array_equal(
                    getattr(tl, f).numpy(), _cut(j, getattr(js, f), rank, tp),
                    err_msg=f"{path}.{f}")
    elif isinstance(jl, jc.ServeFlags):
        assert (tl.a8, tl.vocab_tp) == (jl.a8, jl.vocab_tp), path
    elif isinstance(jl, jc.FusedSplits):
        assert tuple(tl.parts) == tuple(jl.parts), path
    elif isinstance(jl, dict):
        assert set(tl) == set(jl), (path, set(tl) ^ set(jl))
        for k in jl:
            _same_view(jl[k], js[k], tl[k], rank, tp, f"{path}.{k}")
    elif isinstance(jl, (list, tuple)):
        assert len(tl) == len(jl), path
        for i, (a, b, c) in enumerate(zip(jl, js, tl)):
            _same_view(a, b, c, rank, tp, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(tl.numpy(), _cut(jl, js, rank, tp),
                                      err_msg=path)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_local_view_matches_jax_specs(family, fuse):
    """Both ranks' local params of each family (packed act-order g128
    linears, biases where the family has them, a dense or packed head)
    equal the slices the JAX tp_local_view's specs cut, statics, splits
    and serve flags included."""
    kw = FAMILIES[family]
    jspec, jp = packed_jax_model(kw, seed=len(family), groupsize=128,
                                 act_order=True,
                                 quant_head=family == "opt")
    tspec = tc.ArchSpec(**kw)
    tparams = to_port(jp)
    jl, js = jtp.tp_local_view(jspec, jp, 2, fuse=fuse, a8=fuse)
    for rank in range(2):
        tl = ttp.tp_local_view(tspec, tparams, 2, rank, fuse=fuse, a8=fuse)
        _same_view(jl, js, tl, rank, 2)
    if fuse and family in ("llama", "gemma"):
        assert "qkv_fused" in tl["layers"][0]
        assert "gateup_fused" in tl["layers"][0]


def test_tp_local_view_refusals():
    """The JAX package's errors: heads tp does not divide, K shards off
    subblock boundaries (packed without tp), globally fused weights."""
    jspec, jp = packed_jax_model(LLAMA, seed=1, tp=1)
    tspec, tparams = tc.ArchSpec(**LLAMA), to_port(jp)
    with pytest.raises(ValueError, match="must divide tp=3"):
        ttp.tp_local_view(tspec, tparams, 3, 0)
    with pytest.raises(ValueError, match="subblock-aligned"):
        ttp.tp_local_view(tspec, tparams, 4, 0)
    fused = tc.fuse_serving(tspec, tparams)
    with pytest.raises(ValueError, match="globally-fused"):
        ttp.tp_local_view(tspec, fused, 2, 0)
    bad = {**tparams, "layers": [dict(tparams["layers"][0])]}
    o = bad["layers"][0]["o"]
    bad["layers"][0]["o"] = {**o, "w": dataclasses.replace(
        o["w"], bias=torch.zeros(o["w"].N))}
    with pytest.raises(ValueError, match="baked-in bias"):
        ttp.tp_local_view(tspec, bad, 2, 0)


def test_tp1_view_matches_the_unsharded_model():
    """At tp = 1 (one process, no group) the local view runs the same
    logits as the plain forward, prefill and decode on an int8 cache."""
    spec = tc.ArchSpec(**{**LLAMA, "hidden": 64, "ffn": 128})
    params = tc.init_params(spec, seed=3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 96, (1, 6)))
    _, fwd = ttp.make_tp_forward(spec, params)
    torch.testing.assert_close(fwd(ids), tc.model_forward(spec, params, ids)[0],
                               rtol=0, atol=0)
    _, step = ttp.make_tp_decode_step(spec, params)
    c = ttp.local_cache(spec, 1, 1, 16, torch.int8, "cpu")
    w = tc.KVCache.init(spec, 1, 16, torch.int8, "cpu")
    for tok in (ids, torch.tensor([[5]]), torch.tensor([[9]])):
        got, c = step(c, tok)
        want, w = tc.model_forward(spec, params, tok, w)
        torch.testing.assert_close(got, want[:, -1], rtol=0, atol=0)


def test_cache_shard_matches_jax_cache_pspec():
    jspec = jc.ArchSpec(**LLAMA)
    c = jc.KVCache.init(jspec, 1, 8, jnp.int8)
    rng = np.random.default_rng(0)
    k = rng.integers(-127, 127, size=c.k.shape).astype(np.int8)
    s = rng.random(c.k_scale.shape).astype(np.float32)
    tcache = tc.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(k),
                        length=3, k_scale=torch.from_numpy(s),
                        v_scale=torch.from_numpy(s))
    spec = jtp.cache_pspec(int8=True)
    for r in range(2):
        got = ttp.cache_shard(tcache, 2, r)
        np.testing.assert_array_equal(got.k.numpy(), _cut(k, spec.k, r, 2))
        np.testing.assert_array_equal(got.k_scale.numpy(),
                                      _cut(s, spec.k_scale, r, 2))
        assert got.length == 3
    local = ttp.local_cache(tc.ArchSpec(**LLAMA), 2, 1, 8, torch.int8, "cpu")
    assert local.k.shape == got.k.shape
    assert local.k_scale.shape == got.k_scale.shape


# ---------------------------------------------------------------------------
# tp = 2 in two gloo processes against the JAX package's shard_map tp = 2
# ---------------------------------------------------------------------------

def launch(job: str, world: int, tmp_path) -> list:
    """Start tests/torch_parallel_worker.py `job` as `world` ranks of one
    gloo group (the environment torchrun sets); `finish` waits."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    env.update(WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, job, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in range(world)]


def finish(job: str, procs: list, timeout: int = 300) -> list:
    """The ranks' outputs, after asserting that every one finished."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"{job.upper()}_OK" in out, out[-2000:]
    return outs


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _jax_tp_run(step, local, jspec, prompt, toks, cache_dtype, greedy=0):
    """Prefill `prompt`, then feed `toks` (and `greedy` more argmax
    tokens); (logits of each call (n, vocab), greedy tokens)."""
    cache = jc.KVCache.init(jspec, 1, 16, cache_dtype)
    out, picked = [], []
    lg, cache = step(local, cache, jnp.asarray(prompt))
    out.append(np.asarray(lg[0]))
    for t in toks:
        lg, cache = step(local, cache, jnp.asarray([[t]]))
        out.append(np.asarray(lg[0]))
    for _ in range(greedy):
        t = int(jnp.argmax(lg[0]))
        picked.append(t)
        lg, cache = step(local, cache, jnp.asarray([[t]]))
        out.append(np.asarray(lg[0]))
    return np.stack(out), picked


def test_tp2_two_processes_match_jax(tmp_path):
    """Two port ranks on a gloo group against gptq_tpu's shard_map tp = 2:
    f32 dense prefill + decode with the vocab-sharded head (1e-4 of
    max |logit|) and the cache-less forward; packed act-order g128 at
    fused a8 on an int8 cache (TOL logits_a8, greedy tokens equal); the
    act-order row gather's forward; BLOOM's alibi decode; a BCQ forward
    (#13 on row-sharded bitplanes); DecodeEngine's chained generation over
    the group; and the CLI's --tp 2."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, 96, size=(1, 6))
    ids = rng.integers(0, 96, size=(2, 8))
    toks = [3, 7, 11]
    np.savez(str(tmp_path / "in.npz"), prompt=prompt, ids=ids,
             toks=np.asarray(toks))
    want = {}

    # f32 dense llama: vocab 96 % 2 == 0 shards the head
    jspec = jc.ArchSpec(**LLAMA)
    jp = jc.init_params(jspec, jax.random.PRNGKey(1))
    tio.save_checkpoint(str(tmp_path / "dense.npz"), tc.ArchSpec(**LLAMA),
                        to_port(jp))
    # packed act-order g128 llama with an 8-bit head, padded for tp = 2
    _, jq = packed_jax_model(LLAMA, seed=2, groupsize=128, act_order=True,
                             quant_head=True)
    tio.save_checkpoint(str(tmp_path / "packed.npz"), tc.ArchSpec(**LLAMA),
                        to_port(jq))
    bkw = {**FAMILIES["bloom"], "n_layers": 2, "tie_embeddings": False}
    bspec = jc.ArchSpec(**bkw)
    jb = jc.init_params(bspec, jax.random.PRNGKey(3))
    tio.save_checkpoint(str(tmp_path / "bloom.npz"), tc.ArchSpec(**bkw),
                        to_port(jb))
    jbcq = _bcq_model(jc.init_params(jspec, jax.random.PRNGKey(4)))
    tio.save_checkpoint(str(tmp_path / "bcq.npz"), tc.ArchSpec(**LLAMA),
                        to_port(jbcq))

    procs = launch("tp", 2, tmp_path)
    try:
        local, step = jtp.make_tp_decode_step(jspec, jp, mesh)
        want["dense"], _ = _jax_tp_run(step, local, jspec, prompt, toks,
                                       jnp.float32)
        local, fwd = jtp.make_tp_forward(jspec, jp, mesh)
        want["dense_fwd"] = np.asarray(fwd(local, jnp.asarray(ids)))
        local, step = jtp.make_tp_decode_step(jspec, jq, mesh, fuse=True,
                                              a8=True, int8_cache=True)
        want["a8"], want["a8_greedy"] = _jax_tp_run(
            step, local, jspec, prompt, toks, jnp.int8, greedy=4)
        local, fwd = jtp.make_tp_forward(jspec, jq, mesh)
        want["actorder_fwd"] = np.asarray(fwd(local, jnp.asarray(ids)))
        local, step = jtp.make_tp_decode_step(bspec, jb, mesh)
        want["bloom"], _ = _jax_tp_run(step, local, bspec, prompt, toks,
                                       jnp.float32)
        local, fwd = jtp.make_tp_forward(jspec, jbcq, mesh)
        want["bcq_fwd"] = np.asarray(fwd(local, jnp.asarray(ids)))
    finally:
        outs = finish("tp", procs)
    for r in range(2):
        got = np.load(str(tmp_path / f"tp{r}.npz"))
        for key in ("dense", "dense_fwd", "actorder_fwd", "bloom"):
            assert rel_err(got[key], want[key]) < F32_TOL, key
        assert rel_err(got["bcq_fwd"], want["bcq_fwd"]) < 1e-3
        assert rel_err(got["a8"], want["a8"]) < A8_TOL
        assert got["a8_greedy"].tolist() == want["a8_greedy"]
        assert got["vocab_tp"] and got["qkv_fused"]
        np.testing.assert_array_equal(got["chained"], got["generate"])
    # the CLI: rank 0 prints the result line, rank 1 none
    lines = [[ln for ln in out.splitlines() if ln.startswith('{"benchmark"')]
             for out in outs]
    assert len(lines[0]) == 1 and not lines[1]
    res = json.loads(lines[0][0])
    assert res["protocol"] == "per-token-tp2" and res["device"] == "cpu"
    assert res["benchmark"]["n_tokens"] == 12 and res["benchmark"]["ppl"] > 1
    assert "distributed: world 2, backend gloo" in outs[0]


def _bcq_model(jp):
    """jp with every linear of the rules a random BCQ weight (3 planes,
    groups of 128) packed with tp = 2."""
    rng = np.random.default_rng(9)
    for bp in jp["layers"]:
        for key in ("q", "k", "v", "o", "gate", "up", "down"):
            N, K = bp[key]["w"].shape
            B = np.where(rng.random((N, K // 128, 128, 3)) < 0.5, -1.0, 1.0)
            alpha = rng.uniform(0.005, 0.02, size=(N, K // 128, 3))
            bp[key]["w"] = jpack.pack_bcq(jnp.asarray(B, jnp.float32),
                                          jnp.asarray(alpha, jnp.float32),
                                          groupsize=128, tp=2)
    return jp


def test_cli_tp_ep_guards_and_pack_time_tp(monkeypatch, tmp_path):
    """--tp / --ep serving from --load needs WORLD_SIZE = tp * ep (the
    torchrun hint); without --load they serve nothing; a quantize run
    packs the model and its head padded for --tp (pack_model(tp=),
    quantize_lm_head(tp=)), as the JAX CLI does."""
    from types import SimpleNamespace

    from gptq_tpu_torch import cli, data, pipeline

    base = ["dummy", "c4", "--device", "cpu"]
    load = base + ["--load", str(tmp_path / "none.npz"), "--benchmark", "8"]
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="--tp 2 runs under torchrun "
                                         "--nproc-per-node 2: WORLD_SIZE is 1"):
        cli.main(load + ["--tp", "2"])
    with pytest.raises(SystemExit, match="--tp 2 --ep 2 runs under torchrun "
                                         "--nproc-per-node 4"):
        cli.main(load + ["--tp", "2", "--ep", "2"])
    with pytest.raises(SystemExit, match="serve a packed checkpoint"):
        cli.main(base + ["--ep", "2", "--benchmark", "8"])

    seen = {}
    monkeypatch.setattr(data, "get_loaders",
                        lambda *a, **k: (np.zeros((1, 8), np.int64), None))
    monkeypatch.setattr(pipeline, "quantize_model",
                        lambda *a, **k: SimpleNamespace(quantizers={}))
    monkeypatch.setattr(pipeline, "pack_model",
                        lambda *a, tp=1, **k: seen.setdefault("pack", tp))
    monkeypatch.setattr(pipeline, "quantize_lm_head",
                        lambda *a, tp=1, **k: seen.setdefault("head", tp))
    args = cli.build_parser().parse_args(
        base + ["--tp", "2", "--wbits", "4", "--save", "q.npz",
                "--quant_lm_head", "8"])
    spec = tc.ArchSpec(**{**LLAMA, "hidden": 64, "ffn": 128})
    cli._quantize(args, cli.config_from_args(args), spec,
                  tc.init_params(spec, device="cpu"), None, 8,
                  torch.device("cpu"))
    assert seen == {"pack": 2, "head": 2}


def test_fused_gates_stand_down_under_tp(monkeypatch):
    """Every fused-route gate decides as the JAX package's without tp and
    stands down under it (a ShardGroup of any size, as the JAX package's
    tp_axis), with the fused and the layer routes switched on. (The head
    stays unfused either way: 96 columns are no multiple of 128.)"""
    monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", "on")
    monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", "on")
    jspec, jp = packed_jax_model(LLAMA, seed=6, tp=1, quant_head=True)
    tspec = tc.ArchSpec(**LLAMA)
    js = jc.fuse_serving(jspec, jp, a8=True)
    ts = tc.fuse_serving(tspec, to_port(jp), a8=True)
    jl, tl = js["layers"][0], ts["layers"][0]
    cache = tuple(torch.zeros((1, 8, 4, 128)) for _ in range(2)) + (None,
                                                                     None)
    for tp_axis, tp in ((None, None), ("tp", tc.ShardGroup())):
        pairs = [
            (jc._norm_qkv_ok(jspec, jl, tp_axis, None, 1),
             tc._norm_qkv_ok(tspec, tl, None, 1, "cpu", tp)),
            (jc._attn_mlp_ok(jspec, jl, tp_axis, None, 1),
             tc._attn_mlp_ok(tspec, tl, None, 1, "cpu", tp)),
            (jc._ffn_fusion_entry(jl, tp_axis, None),
             tc._ffn_fusion_entry(tl, None, "cpu", tp)),
            (jc._head_fusion_ok(jspec, js, tp_axis, 1),
             tc._head_fusion_ok(tspec, ts, 1, "cpu", tp)),
            (jc._layer_fusion_ok(jspec, jl, tp_axis, None, 1, 1, cache, 3),
             tc._layer_fusion_ok(tspec, tl, None, 1, 1, cache, 3, tp))]
        for i, (want, got) in enumerate(pairs):
            assert got == want
            assert (got is None) == (tp is not None or i == 3)
