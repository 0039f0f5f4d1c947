"""The port's chained decode (engine/decode.py: generate_chained,
benchmark_decode_chained, measure_dispatch_rtt) and the device-side cache
length against gptq_tpu on the CPU, where the chained steps run eagerly
(on the card they are CUDA graphs: test_torch_cuda.py): chained tokens
equal JAX's generate_chained and the port's generate on f32 / bf16 /
int8 caches at batch 1 and 2, with and without bucketing; a tensor cache
length gives the same logits and cache as a host one on every route;
sampling from one seeded generator repeats and keeps to the top k; the
chained benchmark reports JAX's keys and benchmark_decode's PPL; and the
CLI's protocols."""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.engine import decode as jdec
from gptq_tpu_torch import cli
from gptq_tpu_torch import io as tio
from gptq_tpu_torch.engine import decode as tdec
from gptq_tpu_torch.models import common as tc
from test_torch_fused_serving import _pair as packed_model
from test_torch_model import _ids
from test_torch_model import _pair as dense_model
from torch_threads import torch_threads  # noqa: F401 (autouse)

CACHES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
PACKED = ((4, -1, False), (4, -1, False))  # 2 layers, 4-bit g-1


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_generate_chained_matches_jax_and_generate(cache, B):
    jspec, jp, tspec, tp = dense_model(2)
    jdt, tdt = CACHES[cache]
    prompt = _ids(B, B, 5)
    # max_len above JAX's 128-slot bucket floor: its chunks run on a prefix
    jeng = jdec.DecodeEngine(jspec, jp, max_len=256, batch=B, cache_dtype=jdt)
    teng = tdec.DecodeEngine(tspec, tp, max_len=256, batch=B, cache_dtype=tdt)
    want = jeng.generate_chained(prompt, 9, chunk=4)
    for bucketed in (True, False):
        got = teng.generate_chained(prompt, 9, chunk=4, bucketed=bucketed)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(teng.generate(prompt, 9), want)


def _route(monkeypatch, route):
    """The serving route: unfused, fused (norm_qkv + attn_mlp) or the
    whole-layer kernel; returns the cache dtype it serves."""
    monkeypatch.setenv("GPTQ_TPU_FFN_FUSION", "off" if route == "unfused"
                       else "on")
    monkeypatch.setenv("GPTQ_TPU_LAYER_FUSION", "on" if route == "layer"
                       else "off")
    return torch.bfloat16 if route == "layer" else torch.int8


@pytest.mark.parametrize("route", ["unfused", "fused", "layer"])
def test_tensor_length_matches_host_length(route, monkeypatch):
    cache_dtype = _route(monkeypatch, route)
    _, _, tspec, tp = packed_model(PACKED, seed=12, lm_bits=8)
    ts = tc.fuse_serving(tspec, tp, a8=True)
    ids = torch.from_numpy(_ids(12, 1, 8))
    runs = []
    for as_tensor in (False, True):
        cache = tc.KVCache.init(tspec, 1, 16, cache_dtype, device="cpu")
        logits, cache = tc.model_forward(tspec, ts, ids[:, :5], cache)
        out = [logits[:, -1]]
        for t in range(5, 8):
            if as_tensor:
                cache = tc.KVCache(cache.k, cache.v, torch.tensor(
                    int(cache.length), dtype=torch.int32), cache.k_scale,
                    cache.v_scale)
            logits, cache = tc.model_forward(tspec, ts, ids[:, t:t + 1],
                                             cache)
            out.append(logits[:, -1])
        assert int(cache.length) == 8
        runs.append((torch.stack(out), cache))
    (la, ca), (lb, cb) = runs
    assert isinstance(cb.length, torch.Tensor)
    assert torch.equal(la, lb)
    for a, b in ((ca.k, cb.k), (ca.v, cb.v), (ca.k_scale, cb.k_scale)):
        assert a is None and b is None or torch.equal(a, b)


def test_generate_chained_on_the_layer_route(monkeypatch):
    _route(monkeypatch, "layer")
    _, _, tspec, tp = packed_model(PACKED, seed=11, lm_bits=8)
    calls = []
    fused = tc.decode_layer_fused
    monkeypatch.setattr(tc, "decode_layer_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    eng = tdec.DecodeEngine(tspec, tp, max_len=32, batch=1,
                            cache_dtype=torch.bfloat16, a8=True)
    prompt = _ids(11, 1, 6)
    want = eng.generate(prompt, 7)
    assert len(calls) == 2 * 7  # each decode step, each layer
    got = eng.generate_chained(prompt, 7, chunk=3)
    assert len(calls) == 2 * 7 + 2 * 6  # the first token comes from prefill
    np.testing.assert_array_equal(got, want)


def test_sampled_chain_repeats_and_keeps_to_top_k():
    _, _, tspec, tp = dense_model(2)
    eng = tdec.DecodeEngine(tspec, tp, max_len=32, batch=2)
    prompt = _ids(4, 2, 5)

    def draw(seed):
        return eng.generate_chained(prompt, 8, chunk=3, temperature=0.9,
                                    top_k=4,
                                    generator=torch.Generator().manual_seed(seed))

    a = draw(7)
    np.testing.assert_array_equal(draw(7), a)
    assert not np.array_equal(draw(8), a)
    for i in range(a.shape[1]):
        logits, _ = eng.prefill(torch.from_numpy(
            np.concatenate([prompt, a[:, :i]], axis=1)))
        top = torch.topk(logits, 4, dim=-1).indices.numpy()
        assert all(a[b, i] in top[b] for b in range(2)), i


def test_benchmark_decode_chained_keys_and_ppl():
    jspec, jp, tspec, tp = dense_model(2)
    ids = _ids(3, 1, 12)
    quiet = dict(log=lambda s: None)
    want = jdec.benchmark_decode_chained(jspec, jp, ids, check=True, **quiet)
    got = tdec.benchmark_decode_chained(tspec, tp, ids, check=True, **quiet)
    assert set(got) == set(want)
    assert got["n_tokens"] == 12 and got["full_run_s"] > 0
    assert got["per_token_s"] > 0 and got["dispatch_rtt_s"] > 0
    # f32 on both sides, sums in another order
    assert abs(got["ppl"] - want["ppl"]) <= 1e-4 * want["ppl"]
    # the same steps as the per-token protocol, summed in its order
    per = tdec.benchmark_decode(tspec, tp, ids, check=True, warmup=1, **quiet)
    assert got["ppl"] == per["ppl"]
    assert tdec.measure_dispatch_rtt(device="cpu") > 0


@pytest.fixture(scope="module")
def packed_checkpoint(tmp_path_factory):
    """The protocols' 2-layer packed checkpoint, its params built (the JAX
    side's init and packing too) and saved once for the module."""
    _, _, tspec, tp = packed_model(PACKED, seed=13)
    path = str(tmp_path_factory.mktemp("protocols") / "m.npz")
    tio.save_checkpoint(path, tspec, tp)
    return path


@pytest.mark.parametrize("protocol", ["batch2", "per-token", "chained"])
def test_cli_protocols(protocol, packed_checkpoint, capsys, monkeypatch):
    path = packed_checkpoint
    flags = ["--benchmark_batch", "2"] if protocol == "batch2" else []
    if protocol == "chained":  # a link slower than 1 ms a round trip
        monkeypatch.setattr(tdec, "measure_dispatch_rtt",
                            lambda reps=5, device="cuda": 2e-3)
    assert cli.main(["dummy", "c4", "--load", path, "--benchmark", "6",
                     "--device", "cpu", "--faster-kernel", *flags]) == 0
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["protocol"] == protocol
    r = line["benchmark"]
    if protocol == "batch2":
        assert "batch 2:" in out and r["batch"] == 2 and r["tokens_per_s"] > 0
    elif protocol == "chained":
        assert "chained protocol" in out and r["n_tokens"] == 6
        assert {"per_token_s", "full_run_s", "half_run_s"} <= set(r)
    else:
        assert r["n_tokens"] == 6 and r["median_s"] > 0
