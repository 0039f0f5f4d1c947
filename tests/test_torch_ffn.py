"""Parity of gptq_tpu_torch.ops.ffn with gptq_tpu.ops.ffn on the CPU: the
plain fused versions against the JAX Pallas kernels in interpret mode,
and the fusability gates against the JAX gates on the same weights. The
CUDA kernels are held to the plain versions in test_torch_cuda.py.

Tolerances: a16 within 1e-4 x max|want| (f32 on both sides, sums in
another order), a8 within 1e-3 x max|want|. Both kernels round their
intermediates to bf16 (and, a8, to int8) at the same points; where the
two frameworks' f32 values straddle such a rounding boundary the element
lands one step apart. `_check` allows a larger difference only when the
test shows that cause: it finds the elements of the port's own
intermediates that lie within a hair of a rounding boundary and requires
that rounding some of them the other way reproduces JAX's output within
the tolerance."""

import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import ffn as jf
from gptq_tpu.ops import pack as jpack
from gptq_tpu_torch.ops import ffn as tf
from gptq_tpu_torch.ops import pack as tpack
from torch_threads import torch_threads  # noqa: F401 (autouse)

TOL = {False: 1e-4, True: 1e-3}  # a8 -> tolerance relative to max|want|
NEAR = 2e-6  # a "near tie": within this relative distance of a boundary


def packed_pair(rng, K, N, bits, groupsize, perm=False, bias=False):
    """The same random packed weight in both packages (numpy codes)."""
    Kp, Np = jpack.pad_dim(K, groupsize), jpack.pad_dim(N)
    ng = Kp // groupsize if groupsize > 0 else 1
    codes = rng.integers(0, 1 << bits, size=(Kp, Np)).astype(np.int32)
    scale = (rng.random((ng, Np)) * 0.02 + 0.01).astype(np.float32)
    zoff = (scale * (2 ** (bits - 1) + rng.integers(-1, 2, size=(ng, Np)))
            ).astype(np.float32)
    scale[:, N:] = 0
    zoff[:, N:] = 0
    p = rng.permutation(K).astype(np.int32) if perm else None
    b = rng.normal(size=N).astype(np.float32) * 0.1 if bias else None
    jp = jpack.PackedWeight(
        words=jpack.pack_codes(jnp.asarray(codes), bits, groupsize),
        scale=jnp.asarray(scale), zoff=jnp.asarray(zoff),
        bias=None if b is None else jnp.asarray(b),
        perm=None if p is None else jnp.asarray(p), bits=bits, K=K, N=N,
        groupsize=groupsize)
    tp = tpack.PackedWeight(
        words=tpack.pack_codes(torch.from_numpy(codes), bits, groupsize),
        scale=torch.from_numpy(scale), zoff=torch.from_numpy(zoff),
        bias=None if b is None else torch.from_numpy(b),
        perm=None if p is None else torch.from_numpy(p), bits=bits, K=K, N=N,
        groupsize=groupsize)
    return jp, tp


def bcq_pair(rng, K, N, bits, groupsize):
    """The same random BCQ weight (sign planes and alphas) in both
    packages, packed by each package's pack_bcq."""
    g = K if groupsize <= 0 else groupsize
    B = np.where(rng.random((N, K // g, g, bits)) < 0.5, -1.0, 1.0
                 ).astype(np.float32)
    alpha = (rng.random((N, K // g, bits)) * 0.02 + 0.005).astype(np.float32)
    return (jpack.pack_bcq(jnp.asarray(B), jnp.asarray(alpha),
                           groupsize=groupsize),
            tpack.pack_bcq(torch.from_numpy(B), torch.from_numpy(alpha),
                           groupsize=groupsize))


def fused_pair(rng, K, N, bits, groupsize, parts=2, fmt="uniform"):
    """`parts` weights of one input fused along N in both packages."""
    make = bcq_pair if fmt == "bcq" else packed_pair
    pairs = [make(rng, K, N, bits, groupsize) for _ in range(parts)]
    return (jpack.fuse_packed([j for j, _ in pairs]),
            tpack.fuse_packed([t for _, t in pairs]))


class _Ties:
    """Records the port's rounding points (bf16 roundings and int8
    activation quantizations, in call order) and the elements whose
    pre-rounding value lies within NEAR x (row max) of a rounding
    boundary; an element the other framework's f32 value may put on the
    other side. Elements whose key (point, index) is in `flip` round the
    other way."""

    def __init__(self, mp, flip=frozenset()):
        self.near = []
        self.flip = flip
        self.n = 0
        self.quant = tf.quantize_acts_int8
        self.bf16 = tf._bf16
        mp.setattr(tf, "_bf16", self._bf16)
        mp.setattr(tf, "quantize_acts_int8", self._quant)

    def _round(self, v, r, other):
        """v: values before rounding, r: rounded, other: the neighbour of r
        on v's side. Returns r with the flipped elements set to other."""
        point = self.n
        self.n += 1
        rowmax = v.abs().amax(dim=-1, keepdim=True)
        dist = ((v - (r + other) / 2).abs() / rowmax).reshape(-1)
        near = (dist <= NEAR) & (v != r).reshape(-1)
        out = r.reshape(-1).clone()
        for e in near.nonzero().reshape(-1).tolist():
            self.near.append((float(dist[e]), (point, e)))
            if (point, e) in self.flip:
                out[e] = other.reshape(-1)[e]
        return out.reshape(r.shape)

    def _bf16(self, v):
        r = self.bf16(v)
        bits = r.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        step = torch.where(v.abs() > r.abs(), bits + 1, bits - 1)
        other = step.to(torch.int16).view(torch.bfloat16).to(torch.float32)
        return self._round(v, r, other)

    def _quant(self, x2):
        xq, sx = self.quant(x2)
        v = x2.to(torch.float32) / sx
        q = xq.to(torch.float32)
        other = torch.where(v > q, q + 1, q - 1).clamp(-127, 127)
        return self._round(v, q, other).to(torch.int8), sx


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


MAX_FLIPS = 4  # near-ties a larger difference may be put down to
CANDIDATES = 32  # the nearest ties searched


def _check(run_port, want, a8, monkeypatch):
    """Hold the port's output to JAX's within TOL[a8]; a larger difference
    passes only if rounding at most MAX_FLIPS near-tie elements the other
    way (chosen greedily, one at a time, among the CANDIDATES nearest to
    their rounding boundary) brings it within TOL[a8].
    Returns (err, flips needed)."""
    tol = TOL[a8]
    with monkeypatch.context() as mp:
        ties = _Ties(mp)
        got = run_port()
    err = _err(got, want)
    flips = frozenset()
    cands = [key for _, key in sorted(ties.near)[:CANDIDATES]]
    if err > tol:  # the reruns share the dequantized weights
        cache = {}
        dequant = tf._dequant_stored
        monkeypatch.setattr(tf, "_dequant_stored", lambda pw: cache.setdefault(
            id(pw), dequant(pw)))
    while err > tol and len(flips) < MAX_FLIPS:
        best = None
        for key in cands:
            if key in flips:
                continue
            with monkeypatch.context() as mp:
                _Ties(mp, flips | {key})
                e = _err(run_port(), want)
            if best is None or e < best[0]:
                best = (e, flips | {key})
        if best is None or best[0] >= err:
            break
        err, flips = best
    assert err <= tol, (
        f"err {err:.3g} > {tol} with {len(flips)} of {len(ties.near)} "
        f"near-tie flips")
    return err, len(flips)


def _launches():
    return tf.norm_qkv_launches, tf.attn_mlp_launches, tf.ffn_launches


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _jt(a):
    """numpy -> (jax array, torch tensor), None -> (None, None)."""
    return (None, None) if a is None else (jnp.asarray(a), torch.from_numpy(a))


H, F = 256, 512  # hidden and ffn width of the kernel cases


@pytest.mark.parametrize("norm,bits,groupsize,a8,bias", [
    ("rmsnorm", 4, -1, True, False),
    ("rmsnorm1p", 3, 128, False, False),
    ("layernorm", 8, 128, True, True),
    ("layernorm", 4, -1, False, True),
])
def test_norm_qkv_plain_matches_jax_kernel(norm, bits, groupsize, a8, bias,
                                           monkeypatch):
    rng = np.random.default_rng(bits * 7 + a8)
    jw, tw = fused_pair(rng, H, H, bits, groupsize, parts=3)  # q|k|v
    assert jf.norm_qkv_fusable(jw) and tf.norm_qkv_fusable(tw)
    jx, tx = _jt(_x(rng, 2, 3, H))
    jw1, tw1 = _jt((rng.random(H) + 0.5).astype(np.float32))
    jbl, tbl = _jt(_x(rng, H) * 0.1 if norm == "layernorm" else None)
    jbq, tbq = _jt(_x(rng, tw.Np) * 0.1 if bias else None)
    want = jf.norm_qkv_fused(jx, jw1, jw, norm=norm, eps=1e-5, a8=a8,
                             b_ln=jbl, b_qkv=jbq, interpret=True)

    def port():
        return tf.norm_qkv_fused(tx, tw1, tw, norm=norm, eps=1e-5, a8=a8,
                                 b_ln=tbl, b_qkv=tbq).numpy()

    before = _launches()
    assert port().shape == (2, 3, tw.Np)
    assert _launches() == before  # a CPU tensor runs the plain version
    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("act,norm,glu,a8,bits,groupsize", [
    ("silu", "rmsnorm", True, True, 4, -1),
    ("gelu", "rmsnorm1p", True, False, 4, 128),
    ("gelu_tanh", "rmsnorm", True, True, 3, 128),
    ("relu", "layernorm", False, True, 8, -1),  # OPT-style, with biases
    ("silu", "layernorm", False, False, 4, 128),
])
def test_attn_mlp_plain_matches_jax_kernel(act, norm, glu, a8, bits,
                                           groupsize, monkeypatch):
    rng = np.random.default_rng(bits * 11 + a8 + 3 * glu)
    jo, to = packed_pair(rng, H, H, bits, groupsize)
    if glu:
        jg, tg = fused_pair(rng, H, F, bits, groupsize)
    else:
        jg, tg = packed_pair(rng, H, F, bits, groupsize)
    jd, td = packed_pair(rng, F, H, bits, groupsize)
    assert jf.attn_mlp_fusable(jo, jg, jd, glu=glu)
    assert tf.attn_mlp_fusable(to, tg, td, glu=glu)
    ja, ta = _jt(_x(rng, 1, 4, H))
    jr, tr = _jt(_x(rng, 1, 4, H))
    jw2, tw2 = _jt((rng.random(H) + 0.5).astype(np.float32))
    biases = {"b_ln": H if norm == "layernorm" else 0, "b_o": H,
              "b_g": 0 if glu else F, "b_d": 0 if glu else H}
    jb, tb = {}, {}
    for name, n in biases.items():
        jb[name], tb[name] = _jt(_x(rng, n) * 0.1 if n else None)
    want = jf.attn_mlp_fused(ja, jr, jw2, jo, jg, jd, act=act, norm=norm,
                             eps=1e-5, glu=glu, a8=a8, interpret=True, **jb)

    def port():
        return tf.attn_mlp_fused(ta, tr, tw2, to, tg, td, act=act, norm=norm,
                                 eps=1e-5, glu=glu, a8=a8, **tb).numpy()

    before = _launches()
    assert port().shape == (1, 4, H)
    assert _launches() == before
    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("act,a8,bits,groupsize", [
    ("silu", True, 4, -1),
    ("gelu", False, 3, 128),
    ("relu", True, 8, 128),
])
def test_ffn_plain_matches_jax_kernel(act, a8, bits, groupsize, monkeypatch):
    rng = np.random.default_rng(bits * 13 + a8)
    jg, tg = fused_pair(rng, H, F, bits, groupsize)
    jd, td = packed_pair(rng, F, H, bits, groupsize)
    assert jf.ffn_fusable(jg, jd) and tf.ffn_fusable(tg, td)
    jm, tm = _jt(_x(rng, 1, 2, H))
    want = jf.ffn_fused(jm, jg, jd, act=act, a8=a8, interpret=True)

    def port():
        return tf.ffn_fused(tm, tg, td, act=act, a8=a8).numpy()

    before = _launches()
    assert port().shape == (1, 2, H)
    assert _launches() == before
    _check(port, np.asarray(want), a8, monkeypatch)


BCQ_CASES = [(2, -1, True), (3, 128, False), (3, -1, True), (2, 128, False),
             (3, 128, True)]  # bits, groupsize, a8


@pytest.mark.parametrize("bits,groupsize,a8", BCQ_CASES)
def test_norm_qkv_bcq_plain_matches_jax_kernel(bits, groupsize, a8,
                                               monkeypatch):
    # the BCQ branch of _norm_qkv_kernel (sign planes, per-plane DMA)
    rng = np.random.default_rng(100 + bits * 7 + a8)
    jw, tw = fused_pair(rng, H, H, bits, groupsize, parts=3, fmt="bcq")
    assert tw.fmt == "bcq" and tf.norm_qkv_fusable(tw)
    assert jf.norm_qkv_fusable(jw)
    jx, tx = _jt(_x(rng, 2, 3, H))
    jw1, tw1 = _jt((rng.random(H) + 0.5).astype(np.float32))
    want = jf.norm_qkv_fused(jx, jw1, jw, eps=1e-5, a8=a8, interpret=True)

    def port():
        return tf.norm_qkv_fused(tx, tw1, tw, eps=1e-5, a8=a8).numpy()

    before = _launches()
    assert port().shape == (2, 3, tw.Np)
    assert _launches() == before
    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("bits,groupsize,a8", BCQ_CASES)
def test_attn_mlp_bcq_plain_matches_jax_kernel(bits, groupsize, a8,
                                               monkeypatch):
    rng = np.random.default_rng(200 + bits * 11 + a8)
    jo, to = bcq_pair(rng, H, H, bits, groupsize)
    jg, tg = fused_pair(rng, H, F, bits, groupsize, fmt="bcq")
    jd, td = bcq_pair(rng, F, H, bits, groupsize)
    assert jf.attn_mlp_fusable(jo, jg, jd) and tf.attn_mlp_fusable(to, tg, td)
    ja, ta = _jt(_x(rng, 1, 4, H))
    jr, tr = _jt(_x(rng, 1, 4, H))
    jw2, tw2 = _jt((rng.random(H) + 0.5).astype(np.float32))
    jbo, tbo = _jt(_x(rng, H) * 0.1)
    want = jf.attn_mlp_fused(ja, jr, jw2, jo, jg, jd, eps=1e-5, a8=a8,
                             b_o=jbo, interpret=True)

    def port():
        return tf.attn_mlp_fused(ta, tr, tw2, to, tg, td, eps=1e-5, a8=a8,
                                 b_o=tbo).numpy()

    before = _launches()
    assert port().shape == (1, 4, H)
    assert _launches() == before
    _check(port, np.asarray(want), a8, monkeypatch)


@pytest.mark.parametrize("bits,groupsize,a8", BCQ_CASES)
def test_ffn_bcq_plain_matches_jax_kernel(bits, groupsize, a8, monkeypatch):
    rng = np.random.default_rng(300 + bits * 13 + a8)
    jg, tg = fused_pair(rng, H, F, bits, groupsize, fmt="bcq")
    jd, td = bcq_pair(rng, F, H, bits, groupsize)
    assert jf.ffn_fusable(jg, jd) and tf.ffn_fusable(tg, td)
    jm, tm = _jt(_x(rng, 1, 2, H))
    want = jf.ffn_fused(jm, jg, jd, a8=a8, interpret=True)

    def port():
        return tf.ffn_fused(tm, tg, td, a8=a8).numpy()

    before = _launches()
    assert port().shape == (1, 2, H)
    assert _launches() == before
    _check(port, np.asarray(want), a8, monkeypatch)


def test_one_int8_tie_flip_size_at_cuda_test_widths(monkeypatch):
    # test_torch_cuda.py holds a8 attn_mlp over several rows to FLIP_RTOL:
    # one int8 code of the norm output rounded the other way (a tie that a
    # one-ulp difference upstream can flip) moves the output by more than
    # FUSED_RTOL of max|want| at that test's widths, and within FLIP_RTOL
    from test_torch_cuda import FLIP_RTOL, FUSED_RTOL, _fusable, _vec

    cpu = torch.device("cpu")
    M, bits = 32, 4
    rng = np.random.default_rng(M * 10 + bits + 1)  # its silu case
    o = _fusable(rng, bits, -1, 512, 512)
    gu = _fusable(rng, bits, -1, 512, 1536, parts=2)
    dn = _fusable(rng, bits, -1, 1536, 512)
    attn, xres = (torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32))
                  for _ in range(2))
    b_o = _vec(rng, 512, cpu)
    w2 = _vec(rng, 512, cpu, base=1.0)

    def run():
        return tf.attn_mlp_fused_reference(attn, xres, w2, o, gu, dn,
                                           a8=True, b_o=b_o)

    want = run()
    quant = tf.quantize_acts_int8
    pick = np.random.default_rng(0)
    errs = []
    for _ in range(12):
        m, e = pick.integers(M), pick.integers(512)
        calls = []

        def flip_norm_code(x2):
            xq, sx = quant(x2)
            calls.append(None)
            if len(calls) == 2:  # the second phase's input: the norm of r2
                xq = xq.clone()
                xq[m, e] += 1 if xq[m, e] < 127 else -1
            return xq, sx

        with monkeypatch.context() as mp:
            mp.setattr(tf, "quantize_acts_int8", flip_norm_code)
            errs.append(_err(run().numpy(), want.numpy()))
    assert FUSED_RTOL < np.median(errs) and max(errs) < FLIP_RTOL, errs


def test_fusable_gates_decide_as_jax():
    rng = np.random.default_rng(21)
    single = [  # (jax, port) square weights, each fails or passes a rule
        packed_pair(rng, H, H, 4, -1),
        packed_pair(rng, H, H, 3, 128),
        packed_pair(rng, H, H, 4, 64),  # groups under 128 rows
        packed_pair(rng, H, H, 4, 128, perm=True),  # act-order
        packed_pair(rng, H, H, 4, -1, bias=True),  # baked bias
        packed_pair(rng, H, 96, 4, -1),  # stored width not lane-aligned
        packed_pair(rng, 480, H, 4, -1),  # K stored padded (512)
    ]
    gus = [fused_pair(rng, H, F, 4, -1), fused_pair(rng, H, F, 4, 64),
           fused_pair(rng, H, F, 8, 128), packed_pair(rng, H, F, 4, -1)]
    dns = [packed_pair(rng, F, H, 4, -1), packed_pair(rng, F, H, 4, 64),
           packed_pair(rng, F, 96, 4, -1), packed_pair(rng, 2 * F, H, 4, -1)]
    seen = set()
    for j, t in single:
        assert tf._streamable(t) == jf._streamable(j)
        assert tf.norm_qkv_fusable(t) == jf.norm_qkv_fusable(j)
        seen.add(tf.norm_qkv_fusable(t))
    for (gj, gt), (dj, dt), glu in itertools.product(gus, dns, (True, False)):
        assert tf.ffn_fusable(gt, dt, glu=glu) == jf.ffn_fusable(gj, dj, glu=glu)
        seen.add(("ffn", tf.ffn_fusable(gt, dt, glu=glu)))
        for oj, ot in single:
            got = tf.attn_mlp_fusable(ot, gt, dt, glu=glu)
            assert got == jf.attn_mlp_fusable(oj, gj, dj, glu=glu)
            seen.add(("attn_mlp", got))
    assert seen >= {True, False, ("ffn", True), ("ffn", False),
                    ("attn_mlp", True), ("attn_mlp", False)}
