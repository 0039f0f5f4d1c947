"""Layer-streamed host offload for quantization (models/convert.py
params_from_dir(host=True), pipeline.quantize_model's offload branch and
pack_model one linear at a time) and the lazy safetensors reader, on the
CPU. Here the calibration device is the CPU too, so the offload branch is
forced (pipeline._host_block patched to say yes): each block is then
staged (a new block dict), quantized and its new weights written back to
the host block, as it would be on the card. The offload run must equal the plain run bit for bit, and the
port's host path must match gptq_tpu's params_from_dir(host=True) +
quantize_model under the solver tolerances of
tests/test_reference_parity.py:18-23."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu import pipeline as jpipe
from gptq_tpu.config import QuantConfig as JQuantConfig
from gptq_tpu.models import convert as jconv
from gptq_tpu_torch import pipeline as tpipe
from gptq_tpu_torch.config import QuantConfig
from gptq_tpu_torch.models import convert as tconv
from gptq_tpu_torch.ops.pack import PackedWeight
from torch_threads import torch_threads  # noqa: F401 (autouse)

LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
QKW = dict(wbits=4, groupsize=16, act_order=True, true_sequential=True,
           nsamples=4)
# against gptq_tpu act-order stays off, as in tests/test_torch_pipeline.py:
# layer 1's Hessian comes from a layer 0 quantized in the other framework,
# and act-order would let columns with nearly equal diagonals trade places
# (and the groups static, the calibration set wider than the widest
# input, 128, so that no Hessian is rank-deficient)
PARITY_QKW = {**QKW, "act_order": False, "static_groups": True,
              "nsamples": 8}
NAMES = {"self_attn.q_proj": "q", "self_attn.k_proj": "k",
         "self_attn.v_proj": "v", "self_attn.o_proj": "o",
         "mlp.gate_proj": "gate", "mlp.up_proj": "up",
         "mlp.down_proj": "down"}


def _llama_dir(tmp_path_factory, dtype):
    """A tiny 2-layer HF llama directory (GQA) in safetensors."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(21)
    cfg = LlamaConfig(vocab_size=99, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64,
                      tie_word_embeddings=False)
    d = str(tmp_path_factory.mktemp("hf") / "llama")
    LlamaForCausalLM(cfg).eval().to(dtype).save_pretrained(
        d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """F16, as chip_smoke writes its directories."""
    return _llama_dir(tmp_path_factory, torch.float16)


@pytest.fixture(scope="module")
def hf_dir32(tmp_path_factory):
    """F32 for the parity with gptq_tpu: F16 weights put many entries on
    exact rounding ties of the grid, which the two frameworks' ~1e-7
    differences then split (layer 1's down_proj 96% equal, on the
    device path as on the host one)."""
    return _llama_dir(tmp_path_factory, torch.float32)


def _calib(n=4):
    return np.random.default_rng(4).integers(0, 99, size=(n, 32))


def _force_offload(monkeypatch):
    """The offload branch on the CPU; returns the list of staged blocks."""
    staged = []
    real = tpipe._stage
    monkeypatch.setattr(tpipe, "_host_block", lambda bp, arch, dev: True)
    monkeypatch.setattr(tpipe, "_stage", lambda bp, arch, dev: (
        staged.append(bp), real(bp, arch, dev))[1])
    return staged


def _quantize(d, host, resume_dir=None, log=lambda s: None, qkw=QKW):
    spec, params = tconv.params_from_dir(d, device="cpu", host=host)
    res = tpipe.quantize_model(spec, params,
                               torch.from_numpy(_calib(qkw["nsamples"])).long(),
                               QuantConfig(**qkw), log=log,
                               resume_dir=resume_dir)
    return spec, params, res


def test_host_leaves_stay_on_the_host(hf_dir):
    """host=True: the blocks' linear weights are CPU tensors, every other
    leaf on `device` (meta here, so the two are told apart), the numbers
    those of host=False."""
    _, on_dev = tconv.params_from_dir(hf_dir, device="cpu")
    _, p = tconv.params_from_dir(hf_dir, device="meta", host=True)
    for i, lp in enumerate(p["layers"]):
        for key, leaf in lp.items():
            dev = "cpu" if key in LINEARS else "meta"
            assert leaf["w"].device.type == dev, (i, key)
            if key in LINEARS:
                assert torch.equal(leaf["w"], on_dev["layers"][i][key]["w"])
    assert p["embed"]["tokens"].device.type == "meta"
    assert p["lm_head"]["w"].device.type == "meta"


def test_offload_quantize_and_pack_equal_the_device_run(hf_dir, monkeypatch):
    spec, want, wres = _quantize(hf_dir, host=False)
    staged = _force_offload(monkeypatch)
    _, got, gres = _quantize(hf_dir, host=True)
    assert len(staged) == spec.n_layers
    assert gres.losses == wres.losses
    for name, q in wres.quantizers.items():
        for f, v in q.items():
            g = gres.quantizers[name][f]
            assert (torch.equal(g, v) if isinstance(v, torch.Tensor)
                    else g == v), (name, f)
    # the quantized weights were written back into the host blocks
    for i, (lw, lg) in enumerate(zip(want["layers"], got["layers"])):
        assert lg is staged[i]
        for k in LINEARS:
            assert torch.equal(lw[k]["w"], lg[k]["w"]), (i, k)
    for p in (want, got):
        tpipe.pack_model(spec, p, gres.quantizers, QuantConfig(**QKW))
    for lw, lg in zip(want["layers"], got["layers"]):
        for k in LINEARS:
            a, b = lw[k]["w"], lg[k]["w"]
            assert isinstance(b, PackedWeight), k
            assert all(torch.equal(x, y) for x, y in zip(a.words, b.words))
            assert torch.equal(a.scale, b.scale) and torch.equal(a.zoff,
                                                                 b.zoff)
            assert torch.equal(a.perm, b.perm)


def test_offload_matches_jax_host_path(hf_dir32, monkeypatch):
    jspec, jp = jconv.params_from_dir(hf_dir32, host=True)
    assert isinstance(jp["layers"][0]["q"]["w"], np.ndarray)
    jres = jpipe.quantize_model(jspec, jp, jnp.asarray(_calib(8)),
                                JQuantConfig(**PARITY_QKW),
                                log=lambda s: None)
    _force_offload(monkeypatch)
    _, tp, tres = _quantize(hf_dir32, host=True, qkw=PARITY_QKW)
    assert set(tres.quantizers) == set(jres.quantizers)
    for name, jq in jres.quantizers.items():
        jl, tl = jres.losses[name], tres.losses[name]
        assert abs(jl - tl) <= 0.01 * abs(jl) + 1e-6, (name, jl, tl)
        i, short = name.split(".")[2], ".".join(name.split(".")[3:])
        jQ = np.asarray(jp["layers"][int(i)][NAMES[short]]["w"])
        tQ = tp["layers"][int(i)][NAMES[short]]["w"].numpy()
        # solver tolerances (tests/test_reference_parity.py:18-23)
        assert np.mean(np.abs(jQ - tQ) <= 1e-5) >= 0.995, name
        step = np.asarray(jq["scale"]).max()
        assert np.abs(jQ - tQ).max() <= 1.5 * step + 1e-6, name


def test_resume_with_host_blocks(hf_dir, tmp_path, monkeypatch):
    """Interrupted after layer 1, before its journal: the resumed offload
    run restores layer 0 into the host block, replays it staged, and ends
    equal to an uninterrupted one."""
    staged = _force_offload(monkeypatch)
    _, full, want = _quantize(hf_dir, host=True)
    seen = []

    def interrupt(msg):
        if msg.startswith("layer") and "done" in msg:
            seen.append(msg)
            if len(seen) == 2:
                raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _quantize(hf_dir, host=True, resume_dir=str(tmp_path), log=interrupt)
    staged.clear()
    msgs = []
    _, resumed, got = _quantize(hf_dir, host=True, resume_dir=str(tmp_path),
                                log=msgs.append)
    assert msgs[0] == "resumed: layers 0..0 already quantized"
    assert len(staged) == 2  # layer 0 replayed, layer 1 quantized
    assert got.losses == pytest.approx(want.losses, rel=1e-6)
    for lw, lr in zip(full["layers"], resumed["layers"]):
        for k in LINEARS:
            assert lr[k]["w"].device.type == "cpu"
            assert torch.equal(lw[k]["w"], lr[k]["w"]), k


def test_lazy_reader_equals_the_eager_one(tmp_path, monkeypatch):
    """scan_safetensors reads nothing until a tensor is converted, then
    gives safetensors' own eager reader's numbers (F16 / BF16 widened)."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(5)
    tensors = {"a.bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
               "b.f16": torch.randn(3, 64, generator=g).to(torch.float16),
               "c.f32": torch.randn(4, generator=g),
               "d.i64": torch.arange(6).reshape(2, 3),
               "e.empty": torch.zeros(0, 3)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    reads = []
    real = tconv.LazyTensor.numpy
    monkeypatch.setattr(tconv.LazyTensor, "numpy",
                        lambda self: (reads.append(self.name), real(self))[1])
    sd = tconv.load_state_dict_dir(str(tmp_path))
    assert reads == [] and set(sd) == set(tensors)
    want = load_file(path)
    for k, v in want.items():
        got = sd[k].numpy()
        wf = v.to(torch.float32) if v.is_floating_point() else v
        assert got.dtype == (np.float32 if v.is_floating_point()
                             else np.int64), k
        assert got.shape == tuple(v.shape), k
        np.testing.assert_array_equal(got, wf.numpy(), err_msg=k)
    assert sorted(reads) == sorted(tensors)
