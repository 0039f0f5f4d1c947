"""The arithmetic of #4 at one row (csrc/gemv.cuh's norm_qkv_gemv_kernel:
ln1 + q|k|v or the head on #1's single-row stream) and its route, on the
CPU.

The kernel runs only on an sm_90a card (tests/test_torch_cuda.py holds it
to the plain version there). Here its plan and its sums are written out
in torch and held to gptq_tpu's norm_qkv_fused (the Pallas kernel in
interpret mode) on the same numpy inputs:
  * the whole row's statistics, norm and int8 scale, which every block
    computes alike (the plain version's _norm and quantize_acts_int8, so
    that test_torch_ffn._check can flip a near tie);
  * each 128-column chunk cut in K into pieces of whole units
    (ops/qmatmul.gemv_pieces), each piece staging only its K range of the
    staged row and that range's group sums (test_torch_gemv.gemv_replay);
  * the pieces summed in piece order, the zero-point term subtracted
    once, then the int8 scale and the bias.
Within 1e-4 (a16) / 1e-3 (a8) of max |reference|, with the near-tie rule
of test_torch_ffn._check: the replay rounds the norm to bf16 and the row
to int8 where the kernel does, and an element within a hair of such a
boundary may round the other way in JAX's f32.
"""

import numpy as np
import pytest
import torch

from gptq_tpu.ops import ffn as jf
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq
from test_torch_ffn import _check, _jt, _x, fused_pair, packed_pair
from test_torch_gemv import gemv_replay
from torch_threads import torch_threads  # noqa: F401 (autouse)


def stream_phase(splits):
    """ops/ffn._phase as norm_qkv_gemv_kernel computes it at one row, h the
    normed row: the whole row staged (int8 codes with the absmax / 127
    scale, or bf16) and cut into `splits` pieces of K, each piece's rows
    and group sums from its own range, the pieces summed in piece order,
    the zero points subtracted once, then sx and the bias. Sums in f64
    (a8: the products exact)."""

    def phase(h, pw, a8, bias=None):
        assert h.shape[0] == 1  # one row
        if a8:
            xq, sx = tf.quantize_acts_int8(h)
            xs, sx = xq[0], sx.double().reshape(-1)[0]
        else:
            xs, sx = tf._bf16(h)[0].to(torch.bfloat16), 1.0
        sb = tpack.subblock(pw.Kp, pw.groupsize)
        unit = tq.gemv_unit(sb, 1 if pw.bits == 3 else pw.bits)
        assert 2 <= splits <= -(-pw.Kp // unit)  # the chunks are cut in K
        y = gemv_replay(xs, pw.words, pw.scale, pw.zoff, pw.bits, sb, splits,
                        unit, False) * sx
        if bias is not None:
            y = y + tf._vec(bias, pw.Np).double()
        return y.float()[None]

    return phase


# (norm, bits, groupsize, K, N of each of q, k, v, pieces, a8, b_ln, b_qkv)
CASES = [
    ("rmsnorm", 4, -1, 384, 128, 3, True, False, True),
    ("rmsnorm", 4, 128, 512, 256, 4, False, False, False),
    ("rmsnorm", 8, -1, 384, 256, 2, True, False, False),
    ("rmsnorm1p", 3, 128, 512, 256, 4, True, False, False),
    ("rmsnorm1p", 3, -1, 384, 128, 3, False, False, True),
    ("layernorm", 8, 128, 256, 256, 2, True, True, True),
    ("layernorm", 8, -1, 384, 128, 3, False, True, False),
    ("layernorm", 4, 128, 512, 128, 4, True, True, True),
    ("layernorm", 3, 128, 256, 128, 2, False, True, True),
]


@pytest.mark.parametrize("norm,bits,gs,K,N,splits,a8,ln_bias,bias", CASES)
def test_norm_qkv_stream_replay_matches_jax(norm, bits, gs, K, N, splits, a8,
                                            ln_bias, bias, monkeypatch):
    rng = np.random.default_rng(bits * 13 + K + N + splits + 2 * a8)
    jw, tw = fused_pair(rng, K, N, bits, gs, parts=3)  # q|k|v
    assert tf.norm_qkv_fusable(tw) and 384 <= tw.Np <= 768
    assert tf.norm_qkv_route(1, tw) == "stream"
    jx, tx = _jt(_x(rng, 1, 1, K))
    w1 = (rng.random(K) + 0.5).astype(np.float32)
    if norm == "rmsnorm1p":  # weights around 0, as gemma stores them
        w1 -= 1.0
    jw1, tw1 = _jt(w1)
    jbl, tbl = _jt(_x(rng, K) * 0.1 if ln_bias else None)
    jbq, tbq = _jt(_x(rng, tw.Np) * 0.1 if bias else None)
    want = jf.norm_qkv_fused(jx, jw1, jw, norm=norm, eps=1e-5, a8=a8,
                             b_ln=jbl, b_qkv=jbq, interpret=True)
    monkeypatch.setattr(tf, "_phase", stream_phase(splits))

    def port():
        return tf.norm_qkv_fused_reference(tx, tw1, tw, norm=norm, eps=1e-5,
                                           a8=a8, b_ln=tbl,
                                           b_qkv=tbq).numpy()

    assert port().shape == (1, 1, tw.Np)
    _check(port, np.asarray(want), a8, monkeypatch)


def test_norm_qkv_stream_cut_at_the_main_path_shapes():
    """The 8-bit head (4096 x 32256) takes one piece a chunk on 132 SMs
    (252 chunks fill the card two blocks an SM); ln1 + q|k|v of llama-7B
    (4096 x 12288) two, and Mixtral's (4096 x 6144) five; a8 stages int8,
    a16 bf16, which gemv_cut takes as the staged row's bytes."""
    sms = 132
    assert tq.gemv_splits(4096, 32256, 512, 8, 1, sms) == 1
    assert tq.gemv_splits(4096, 12288, 512, 4, 1, sms) == 2
    assert tq.gemv_splits(4096, 12288, 512, 4, 2, sms) == 2
    assert tq.gemv_splits(4096, 6144, 512, 4, 1, sms) == 5


def test_norm_qkv_route_takes_the_stream_at_one_row():
    """One row on a uniform weight of 2, 3, 4 or 8 bits, a stored width
    that 128 divides and groups of whole subblocks takes the stream; rows
    2-32 take the rows kernel (test_torch_ffn_rows); BCQ sign planes,
    1-bit codes and other stored widths take the tiled kernel."""
    rng = np.random.default_rng(7)
    for bits, gs in ((4, -1), (4, 128), (3, 128), (8, -1), (2, 256)):
        _, pw = fused_pair(rng, 512, 128, bits, gs, parts=3)
        assert tf.norm_qkv_route(1, pw) == "stream"
        assert tf.norm_qkv_route(2, pw) == tf.norm_qkv_route(32, pw) \
            == "rows"
    _, bcq = fused_pair(rng, 512, 128, 3, 128, parts=3, fmt="bcq")
    assert tf.norm_qkv_route(1, bcq) == "tiles"
    _, narrow = packed_pair(rng, 512, 96, 4, -1)  # Np = 96 + pad
    assert (narrow.Np % 128 != 0) == (tf.norm_qkv_route(1, narrow)
                                      == "tiles")
    _, one = packed_pair(rng, 512, 128, 1, -1)
    assert tf.norm_qkv_route(1, one) == "tiles"


def test_cpu_norm_qkv_runs_the_plain_version_on_every_route():
    """A CPU tensor takes the plain version whatever the route says."""
    rng = np.random.default_rng(8)
    _, tw = fused_pair(rng, 256, 128, 4, -1, parts=3)
    assert tf.norm_qkv_route(1, tw) == "stream"
    x = torch.from_numpy(_x(rng, 1, 256))
    w1 = torch.ones(256)
    before = tf.norm_qkv_launches
    got = tf.norm_qkv_fused(x, w1, tw)
    assert tf.norm_qkv_launches == before
    assert torch.equal(got, tf.norm_qkv_fused_reference(x, w1, tw))
