"""Parity of gptq_tpu_torch.ops.attention with gptq_tpu.ops.attention on the
CPU (the plain PyTorch twin against the JAX Pallas kernels in interpret
mode). The CUDA kernel is held to the twin in test_torch_cuda.py.

hd 64 reaches the JAX head-loop kernel (_attn_kernel, f32 math); hd 128
reaches the wide kernel (_attn_kernel_wide), whose dots take bf16
operands, so the f32 plain version is held to it at bf16 precision and to
the head-loop kernel at hd 128 (GPTQ_TPU_ATTN_WIDE=0) at 1e-5."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gptq_tpu.ops import attention as ja
from gptq_tpu_torch.ops import attention as ta
from torch_threads import torch_threads  # noqa: F401 (autouse)

# the head-loop kernel at any hd: the un-jitted body re-reads the env var
_jax_head_loop = jax.jit(ja.decode_attention.__wrapped__,
                         static_argnames=("sm_scale", "interpret"))


def _inputs(seed, B, S, H, Hkv, hd, int8, L=None):
    rng = np.random.default_rng(seed)
    lead = (B,) if L is None else (L, B)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, size=(*lead, S, Hkv, hd)).astype(np.int8)
        ks = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((*lead, S, Hkv)) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
        v = rng.normal(size=(*lead, S, Hkv, hd)).astype(np.float32)
        ks = vs = None
    fk = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    fv = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    return q, k, v, ks, vs, fk, fv, lens


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _port(q, k, v, lens, sm, ks, vs, fk, fv, layer=None):
    return ta.decode_attention(_t(q), _t(k), _t(v), _t(lens), sm,
                               k_scale=_t(ks), v_scale=_t(vs), fresh_k=_t(fk),
                               fresh_v=_t(fv), layer=layer).numpy()


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("Hkv", [4, 2])  # MHA and GQA (G = 2)
@pytest.mark.parametrize("fresh", [True, False])
def test_head_loop_kernel_hd64(int8, Hkv, fresh):
    B, S, H, hd = 3, 64, 4, 64
    q, k, v, ks, vs, fk, fv, lens = _inputs(Hkv + 2 * int8, B, S, H, Hkv, hd,
                                            int8)
    if not fresh:
        fk = fv = None
    sm = 1.0 / np.sqrt(hd)
    want = ja.decode_attention(_j(q), _j(k), _j(v), _j(lens), sm,
                               k_scale=_j(ks), v_scale=_j(vs), fresh_k=_j(fk),
                               fresh_v=_j(fv), interpret=True)
    got = _port(q, k, v, lens, sm, ks, vs, fk, fv)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("Hkv", [2, 1])
def test_hd128_stacked_layer(int8, Hkv, monkeypatch):
    B, S, H, hd, L, layer = 2, 256, 2, 128, 3, 1
    q, k, v, ks, vs, fk, fv, lens = _inputs(5 + Hkv, B, S, H, Hkv, hd, int8,
                                            L=L)
    sm = 1.0 / np.sqrt(hd)
    got = _port(q, k, v, lens, sm, ks, vs, fk, fv, layer=layer)
    # the wide kernel (the JAX hd % 128 == 0 path, stacked cache + layer):
    # bf16 dot operands -> bf16-level agreement
    wide = ja.decode_attention_wide(
        _j(q), _j(k), _j(v), _j(lens), sm, k_scale=_j(ks), v_scale=_j(vs),
        fresh_k=_j(fk), fresh_v=_j(fv), layer=layer, interpret=True)
    np.testing.assert_allclose(got, np.asarray(wide), rtol=2e-2, atol=2e-2)
    # the same function through the f32 head-loop kernel on layer `layer`
    monkeypatch.setenv("GPTQ_TPU_ATTN_WIDE", "0")
    sel = (lambda a: None if a is None else a[layer])
    want = _jax_head_loop(_j(q), _j(sel(k)), _j(sel(v)), _j(lens), sm,
                          k_scale=_j(sel(ks)), v_scale=_j(sel(vs)),
                          fresh_k=_j(fk), fresh_v=_j(fv), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_scalar_length_and_int8_wrapper():
    B, S, H, hd = 2, 32, 4, 64
    q, k, v, ks, vs, _, _, _ = _inputs(11, B, S, H, 4, hd, True)
    sm = 0.125
    want = ja.decode_attention_int8(_j(q), _j(k), _j(v), _j(ks), _j(vs),
                                    jnp.asarray(21), sm, interpret=True)
    got = ta.decode_attention_int8(_t(q), _t(k), _t(v), _t(ks), _t(vs), 21,
                                   sm).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_never_launches_the_kernel():
    q, k, v, ks, vs, fk, fv, lens = _inputs(0, 1, 32, 2, 2, 64, True)
    before = ta.launches
    _port(q, k, v, lens, 0.1, ks, vs, fk, fv)
    assert ta.launches == before


def test_length_zero_without_fresh_pair_gives_zeros():
    # a row with nothing to attend: zeros (the port's one meaning for its
    # kernel and its plain version); the other rows are unchanged
    q, k, v, ks, vs, _, _, _ = _inputs(13, 3, 32, 4, 2, 64, True)
    lens = np.array([0, 7, 0], np.int32)
    got = _port(q, k, v, lens, 0.125, ks, vs, None, None)
    assert np.all(got[[0, 2]] == 0) and np.all(np.isfinite(got))
    want = ja.decode_attention(_j(q), _j(k), _j(v), _j(lens), 0.125,
                               k_scale=_j(ks), v_scale=_j(vs), interpret=True)
    np.testing.assert_allclose(got[1], np.asarray(want)[1], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# csrc/attention_partial.cu's decode mode (the card's #2 / #3), replayed
# ---------------------------------------------------------------------------

def decode_tiles(q, k, v, lens, sm, ks=None, vs=None, fk=None, fv=None,
                 sms=132):
    """The decode mode's data flow in torch (f32): the grid of
    ta.partial_grid; split j of a (row, kv head) lists the slots t < len
    of the 32-slot tiles j, j + nsplit, ... in slot order and walks them
    in compute tiles of N slots (32 / 64 / 128: K and V rows within
    36 KB); in each tile the slots fall into 8 / gp runs (gp: G up to a
    power of two), each run keeping its own online state per head (a
    whole-row dot a slot, sm_scale on the score); the runs' states merge
    in run order into the split's, the splits' in split order, then the
    fresh column (q . fresh k), then out = acc / l, zeros where l = 0."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    gh, nsplit = ta.partial_grid(B, Hkv, G, S, sms)
    assert G % gh == 0
    gp = 1 << (G - 1).bit_length()
    nsub = 8 // gp
    rs = hd * k.element_size() + 16
    fit = 36 * 1024 // (2 * rs)
    N = 128 if fit >= 128 else 64 if fit >= 64 else 32
    T = ta.PARTIAL_TILE
    kf, vf = k.float(), v.float()
    out = torch.zeros((B, H, hd))
    inf = float("-inf")

    def merge(states):  # in order, an empty state (m = -inf) weighs 0
        M = torch.stack([s[0] for s in states]).amax(dim=0)
        w = [torch.where(s[0] == inf, torch.zeros_like(M),
                         torch.exp(s[0] - M)) for s in states]
        return (M, sum(wi * s[1] for wi, s in zip(w, states)),
                sum(wi[:, None] * s[2] for wi, s in zip(w, states)))

    for b in range(B):
        n = min(max(int(lens[b]), 0), S)
        for h in range(Hkv):
            qs = q[b, h * G:(h + 1) * G].float()
            splits = []
            for j in range(nsplit):
                slots = [t for a in range(j, -(-n // T), nsplit)
                         for t in range(a * T, min(n, a * T + T))]
                runs = [(torch.full((G,), inf), torch.zeros(G),
                         torch.zeros((G, hd))) for _ in range(nsub)]
                for u in range(0, len(slots), N):
                    tile = slots[u:u + N]
                    run = -(-len(tile) // nsub)
                    for r in range(nsub):
                        mine = tile[r * run:(r + 1) * run]
                        if not mine:
                            continue
                        idx = torch.tensor(mine)
                        s = qs @ kf[b, idx, h].T  # (G, n): a row a slot
                        if ks is not None:
                            s = s * ks[b, idx, h]
                        s = s * sm
                        m, l, acc = runs[r]
                        m_new = torch.maximum(m, s.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        pv = p * (vs[b, idx, h] if vs is not None else 1.0)
                        runs[r] = (m_new, l * alpha + p.sum(dim=1),
                                   acc * alpha[:, None] + pv @ vf[b, idx, h])
                splits.append(merge(runs))
            M, L, A = merge(splits)
            if fk is not None:  # the fresh column, merged by rank 0
                sf = (qs @ fk[b, h].float()) * sm
                fresh = fv[b, h].float()[None].expand(G, hd)
                M, L, A = merge([(M, L, A), (sf, torch.ones(G), fresh)])
            out[b, h * G:(h + 1) * G] = torch.where(
                L[:, None] > 0, A / L[:, None].clamp_min(1e-30), 0.0)
    return out


# (B, S, H, Hkv, hd, int8, fresh, lens): GQA 1 and 4, hd 64 / 128, ragged
# lengths with 0, a split of empty tiles, tile edges
DECODE_CASES = [
    (1, 96, 4, 4, 64, True, True, [70]),
    (3, 200, 4, 1, 128, True, True, [0, 33, 200]),
    (3, 160, 8, 2, 64, False, False, [64, 0, 129]),
    (3, 96, 4, 4, 128, False, True, [1, 32, 0]),
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c[:6])))
def test_decode_tile_algorithm_matches_jax(case, monkeypatch):
    B, S, H, Hkv, hd, int8, fresh, lens = case
    q, k, v, ks, vs, fk, fv, _ = _inputs(17 + S, B, S, H, Hkv, hd, int8)
    lens = np.asarray(lens, np.int32)
    if not fresh:
        fk = fv = None
    sm = 1.0 / np.sqrt(hd)
    got = decode_tiles(*(_t(a) for a in (q, k, v, lens)), sm, _t(ks), _t(vs),
                       _t(fk), _t(fv)).numpy()
    # the JAX head-loop kernel (f32 math) at any hd
    monkeypatch.setenv("GPTQ_TPU_ATTN_WIDE", "0")
    want = np.asarray(_jax_head_loop(
        _j(q), _j(k), _j(v), _j(lens), sm, k_scale=_j(ks), v_scale=_j(vs),
        fresh_k=_j(fk), fresh_v=_j(fv), interpret=True))
    # a row with nothing to attend: zeros (the port's meaning, see
    # ops/attention.py; JAX's kernel gives its own there)
    empty = (lens == 0) & (not fresh)
    assert np.all(got[empty] == 0)
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=1e-5,
                               atol=1e-5)
    # and the plain version the card's kernel is held to
    np.testing.assert_allclose(got, _port(q, k, v, lens, sm, ks, vs, fk, fv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,Hkv,G,S,sms,grid", [
    (1, 32, 1, 256, 132, (1, 5)),   # llama-7B decode: a split a 128-slot run
    (1, 8, 4, 2048, 132, (2, 8)),   # Mixtral GQA 4: heads split too
    (4, 32, 1, 256, 132, (1, 2)),   # batch 4
    (4, 8, 4, 2048, 132, (4, 5)),   # 160 blocks: the heads stay whole
    (3, 1, 4, 96, 132, (1, 3)),     # a short cache: a split a tile
])
def test_decode_grid_is_a_function_of_shapes(B, Hkv, G, S, sms, grid):
    """decode_attention's grid (ta.partial_grid): splits and head groups
    from the shapes alone, so a CUDA graph replays one launch at every
    length; at most 8 splits (a cluster), each at least one 32-slot tile."""
    gh, nsplit = ta.partial_grid(B, Hkv, G, S, sms)
    assert (gh, nsplit) == grid
    assert G % gh == 0 and 1 <= nsplit <= min(8, -(-S // ta.PARTIAL_TILE))
