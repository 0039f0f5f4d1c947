"""The tensor-core #8 (csrc/qexpert_mma.cu) written out in torch, on the CPU.

The kernel runs only on an sm_90a card (tests/test_torch_cuda.py holds it
to the plain version there). Here its data flow is replayed stage by
stage and held to gptq_tpu's Pallas kernel (`expert_dequant_matmul(...,
impl="pallas", interpret=True)`) on the same numpy inputs, within the
card's limit of 1e-4 of max |reference|:
  * a stage is a window of J word rows of one subblock in every plane of
    the finest field (a 3-bit bank's 2-bit field two windows), decoded as
    the kernel's unpack does (3-bit fields combined into one code), and
    every code of the bank is read exactly once;
  * the swapped operands: per expert, codes^T (the A side) times x^T,
    with the codes as the MMA takes them (bf16 2^bits + c, 8-bit c; a8:
    s8 codes, the 8-bit field's stored code - 128, exact int64 partials),
    and an f32 x as its two bf16 halves;
  * fold units: a group's stages inside a K split, folded as P * scale -
    xsum * (zoff + OFF * scale) with the per-stage x sums of the kernel's
    pass over x (`stage_sums`), shared x or one x per expert, and the
    splits summed in split order;
  * the route and the split count as pure functions of shapes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gptq_tpu.ops import pack as jpack
from gptq_tpu.ops import qmatmul as jq
from gptq_tpu_torch.ops import pack as tpack
from gptq_tpu_torch.ops import qmatmul as tq

RTOL = 1e-4  # the card's limit for #8 against its reference


def _bank(rng, E, bits, gs, K, N):
    """Random codes and grids packed by both packages (the same words)."""
    codes = rng.integers(0, 1 << bits, size=(E, K, N)).astype(np.int32)
    ng = K // gs if gs > 0 else 1
    scale = (rng.random((E, ng, N)) * 0.02 + 0.005).astype(np.float32)
    zoff = (scale * rng.integers(0, 1 << bits, size=(E, ng, N))).astype(
        np.float32)
    words = tuple(torch.stack(ws) for ws in zip(*[
        tpack.pack_codes(torch.from_numpy(codes[e]), bits, gs)
        for e in range(E)]))
    tpe = tpack.PackedExperts(words=words, scale=torch.from_numpy(scale),
                              zoff=torch.from_numpy(zoff), bits=bits, K=K,
                              N=N, groupsize=gs)
    jpe = jpack.PackedExperts(
        words=tuple(jnp.asarray(w.numpy()) for w in words),
        scale=jnp.asarray(scale), zoff=jnp.asarray(zoff), bits=bits, K=K,
        N=N, groupsize=gs)
    return tpe, jpe, codes


def stage_sums(x3, bits, sb, J, Mpad):
    """xprep_kernel's sums: x3 (Ex, M, Kp) over each stage's K rows (stage
    kt = s * (wsb / J) + w takes rows e * 4 wsb + 4 J w + [0, 4 J) of
    subblock s for every finest plane e) -> (Ex, nk, Mpad) f32, rows past
    M zero, int8 x summed exactly."""
    Ex, M, Kp = x3.shape
    fbmin = 1 if bits == 3 else bits
    wsb = sb * fbmin // 32
    v = x3.reshape(Ex, M, Kp // sb, 8 // fbmin, wsb // J, 4 * J)
    if x3.dtype == torch.int8:
        s = v.sum((3, 5), dtype=torch.int64).to(torch.float32)
    else:
        s = v.sum((3, 5), dtype=torch.float32)
    s = s.reshape(Ex, M, -1).transpose(1, 2)
    return torch.nn.functional.pad(s, (0, Mpad - M))


def stage_codes(pe, sb, J, kt):
    """Stage kt of the kernel: its K rows (in the kernel's slot order) and
    their codes (E, BK, Np), decoded from the stage's word windows."""
    bits = pe.bits
    fb0, fb1 = (2, 1) if bits == 3 else (bits, 0)
    fbmin = fb1 or fb0
    wsb = sb * fbmin // 32
    s, j0 = divmod(kt, wsb // J)
    j0 *= J
    words = [w.to(torch.int64) & 0xFFFFFFFF for w in pe.words]
    rows, codes = [], []
    for e1 in range(8 // fbmin):
        for r in range(J):
            if bits == 3:
                w0 = words[0][:, s * (sb * 2 // 32) + (e1 % 2) * wsb + j0 + r]
                w1 = words[1][:, s * (sb // 32) + j0 + r]
            else:
                w0 = words[0][:, s * wsb + j0 + r]
            for b in range(4):
                if bits == 3:
                    c = (((w0 >> (8 * b + 2 * (e1 // 2))) & 3)
                         | (((w1 >> (8 * b + e1)) & 1) << 2))
                elif bits == 8:
                    c = ((w0 >> (8 * b)) & 0xFF) ^ 0x80
                else:
                    c = (w0 >> (8 * b + bits * e1)) & ((1 << bits) - 1)
                rows.append(s * sb + e1 * 4 * wsb + 4 * (j0 + r) + b)
                codes.append(c)
    return torch.tensor(rows), torch.stack(codes, dim=1)


def kernel_algebra(x, pe, x_kind, ks):
    """csrc/qexpert_mma.cu's result, f64: x (M, Kp) or (E, M, Kp) f32
    (integer-valued for a8, bf16-valued for bf16)."""
    E, Kp, Np, bits = pe.E, pe.Kp, pe.Np, pe.bits
    sb = tpack.subblock(Kp, pe.groupsize)
    J = tq.expert_window(bits, sb)
    fbmin = 1 if bits == 3 else bits
    nk = Kp * fbmin // (32 * J)
    bk = Kp // nk
    ng = pe.scale.shape[1]
    spg = Kp // ng // bk
    x3 = x.reshape(-1, x.shape[-2], Kp)
    M = x3.shape[1]
    if x_kind == "a8":
        xq = x3.to(torch.int8)
        xst = stage_sums(xq, bits, sb, J, -(-M // 8) * 8)
        xv = xq.to(torch.int64)
        off = -128.0 if bits == 8 else 0.0
    else:
        xin = x3 if x_kind == "f32" else x3.to(torch.bfloat16)
        xst = stage_sums(xin, bits, sb, J, -(-M // 8) * 8)
        if x_kind == "f32":
            hi, lo = tq.split_bf16(x3)
            xv = hi.double() + lo.double()
        else:
            xv = xin.double()
        off = 0.0 if bits == 8 else float(1 << bits)
    scale, zoff = pe.scale.double(), pe.zoff.double()
    parts = []
    for split in range(ks):
        ka, kb = split * nk // ks, (split + 1) * nk // ks
        acc = torch.zeros((E, M, Np), dtype=torch.float64)
        kt = ka
        while kt < kb:
            gi = kt // spg
            kend = min(kb, (gi + 1) * spg)
            P = torch.zeros((E, M, Np), dtype=xv.dtype)
            xs = torch.zeros((xv.shape[0], M), dtype=torch.float64)
            for k in range(kt, kend):
                rows, c = stage_codes(pe, sb, J, k)
                if x_kind == "a8":
                    b = c - 128 if bits == 8 else c  # s8 codes
                else:
                    b = (c + off).double()  # exact in bf16
                # shared x (one row block) or one x per expert
                P = P + torch.einsum("emk,ekn->emn", xv[:, :, rows], b)
                xs = xs + xst[:, k, :M].double()
            acc += (P.double() * scale[:, gi, None, :]
                    - xs[:, :, None] * (zoff[:, gi] + off * scale[:, gi])
                    [:, None, :])
            kt = kend
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("bits,gs,K", [(4, -1, 512), (4, 128, 512),
                                       (2, -1, 512), (3, -1, 512),
                                       (8, 128, 256)])
def test_stages_read_every_code_once(bits, gs, K):
    tpe, _, codes = _bank(np.random.default_rng(bits), 2, bits, gs, K, 64)
    sb = tpack.subblock(K, gs)
    J = tq.expert_window(bits, sb)
    nk = K * (1 if bits == 3 else bits) // (32 * J)
    seen = []
    for kt in range(nk):
        rows, c = stage_codes(tpe, sb, J, kt)
        np.testing.assert_array_equal(c.numpy(), codes[:, rows.numpy()])
        seen.append(rows)
    assert sorted(torch.cat(seen).tolist()) == list(range(K))


# (bits, groupsize, E, K, N, M, per_x, x, K splits)
CASES = [
    (4, -1, 4, 512, 256, 16, False, "bf16", 1),
    (4, 128, 4, 512, 256, 32, True, "f32", 2),
    (4, -1, 2, 512, 128, 2, True, "a8", 2),
    (2, -1, 2, 512, 128, 16, False, "f32", 1),
    (3, -1, 2, 512, 128, 16, True, "bf16", 2),
    (8, 128, 2, 512, 128, 32, False, "a8", 3),
    (8, -1, 2, 512, 128, 2, True, "f32", 1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_expert_mma_algebra_matches_jax(case):
    bits, gs, E, K, N, M, per_x, x_kind, ks = case
    rng = np.random.default_rng(K + M + bits)
    tpe, jpe, _ = _bank(rng, E, bits, gs, K, N)
    shape = (E, M, K) if per_x else (M, K)
    if x_kind == "a8":
        x = rng.integers(-127, 128, size=shape).astype(np.float32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
        if x_kind == "bf16":
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert tq.expert_route(M, bits, gs, torch.float32, K, N) == "mma"
    got = kernel_algebra(torch.from_numpy(x), tpe, x_kind, ks)
    want = np.asarray(jq.expert_dequant_matmul(jnp.asarray(x), jpe,
                                               impl="pallas", interpret=True))
    got = got.numpy()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= RTOL, err


@pytest.mark.parametrize("M,bits,gs,Kp,Np,route", [
    (16, 4, -1, 4096, 14336, "mma"),     # Mixtral gate / up, g-1
    (16, 4, 128, 14336, 4096, "mma"),    # Mixtral down, g128
    (1, 4, -1, 4096, 14336, "mma"),
    (32, 8, 32, 4096, 256, "mma"),       # 8-bit: 8 words a 32-row subblock
    (16, 4, 32, 4096, 256, "shallow"),   # 4-bit g32: 4 words a plane
    (16, 2, 64, 4096, 256, "shallow"),   # 2-bit g64
    (16, 2, 128, 4096, 256, "mma"),
    (16, 3, 128, 4096, 256, "shallow"),  # 3-bit needs 256-row subblocks
    (16, 3, -1, 4096, 256, "mma"),
    (16, 4, -1, 4096, 202, "shallow"),   # Np % 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_expert_route(M, bits, gs, Kp, Np, route, dtype):
    assert tq.expert_route(M, bits, gs, dtype, Kp, Np) == route


def test_expert_route_refuses_rows_past_32():
    with pytest.raises(ValueError, match="1..32"):
        tq.expert_route(33, 4, -1, torch.float32)


@pytest.mark.parametrize("E,Np,nk,sms,ks", [
    (8, 14336, 32, 132, 1),   # gate / up: 896 blocks
    (8, 4096, 112, 132, 2),   # down: 256 blocks -> 512
    (2, 256, 8, 132, 2),      # few stages: each split keeps 4
    (2, 256, 4, 132, 1),
])
def test_expert_splits(E, Np, nk, sms, ks):
    assert tq.expert_splits(E, Np, nk, sms) == ks
