"""The whole llama decoder layer at decode time in one launch (port of
gptq_tpu/ops/layer_fused.py).

    ln1 -> q|k|v -> rope(q, k) -> attention over the cache + the fresh row
        -> o -> + residual -> ln2 -> gate|up -> act -> down -> + residual

for one token (B = T = 1, llama family: pre-norm rmsnorm, rope, GLU MLP,
no biases). On CUDA tensors `decode_layer_fused` launches the cooperative
kernel of csrc/layer_fused.cu (the counterpart of the Pallas
`_layer_kernel`); on CPU tensors it runs `decode_layer_fused_reference`,
the plain PyTorch version. There is no fallback from the kernel to the
plain version on the card.

The plain version keeps the JAX kernel's rounding points: ln1's output
rounded to bf16, q|k|v in f32, rope in f32 (rotate-half) with q scaled
by sm_scale, the fresh k / v rows rounded to the CACHE dtype before the
token's own score and value use them, masked slots at NEG_INF, then
o, r2 = bf16(x + o), ln2, gate|up, act, down and y = down + r2, each
matmul's input quantized as an a8 / a16 phase of ops/ffn.py.

The fresh rows are written into the cache at slot `length`, in place
(the JAX kernel returns them for a dynamic_update_slice; the resulting
cache is the same). `length` may be a device int32 tensor, which the
kernel reads from device memory, so a CUDA graph can capture the launch.
A full cache (length >= S) gets no write, where the JAX update would
clamp to slot S - 1.
"""

from __future__ import annotations

import ctypes

import torch

from gptq_tpu_torch.ops import _build
from gptq_tpu_torch.ops import ffn as _ffn
from gptq_tpu_torch.ops.pack import PackedWeight

NEG_INF = -1e9

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

_CACHE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"rmsnorm": 0, "rmsnorm1p": 1}


def layer_fusable(qkv: PackedWeight, splits, o: PackedWeight,
                  gu: PackedWeight, dn: PackedWeight, hidden: int,
                  n_heads: int, n_kv_heads: int,
                  head_dim: int | None = None) -> bool:
    """Can decode_layer_fused serve this block? As the JAX gate: exact
    stored widths on every q|k|v part, uniform streamable weights, o reads
    exactly H*hd, o and down project to exactly `hidden` stored columns,
    even hd, and ffn_fusable(gu, dn)."""
    hd = head_dim or hidden // n_heads
    kvw = n_kv_heads * hd
    if any(ns != nl for ns, nl in splits.parts):
        return False
    if tuple(nl for _, nl in splits.parts) != (n_heads * hd, kvw, kvw):
        return False
    for pw in (qkv, o, gu, dn):
        if pw.fmt != "uniform" or not _ffn._streamable(pw):
            return False
    if qkv.Kp != qkv.K or o.Np != o.N or dn.Np != dn.N:
        return False
    if o.Kp != o.K or o.K != n_heads * hd or o.Np != hidden:
        return False
    if dn.Np != hidden:
        return False
    if hd % 2:
        return False
    return _ffn.ffn_fusable(gu, dn, glu=True)


def _length(length, device) -> torch.Tensor:
    """length (int or tensor) -> a 0-dim int64 tensor on `device`."""
    if isinstance(length, torch.Tensor):
        return length.reshape(()).to(device=device, dtype=torch.int64)
    return torch.tensor(int(length), dtype=torch.int64, device=device)


def _layer_cache(k_cache, v_cache, layer):
    """The (S, Hkv, hd) views of this layer's cache (B = 1)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    if k_cache.dim() != 4 or k_cache.shape[0] != 1 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_layer_fused: cache of shape "
                         f"{tuple(k_cache.shape)} (layer={layer}); B must be 1")
    return k_cache[0], v_cache[0]


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half rope of (n, hd) rows by (hd,) tables, in f32, computed as
    models.common.apply_rope does (the kernel rounds the same products)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[:, half:], x[:, :half]], dim=-1)
    return x * cos + rot * sin


def decode_layer_fused_reference(
        x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2,
        qkv: PackedWeight, o: PackedWeight, gu: PackedWeight,
        dn: PackedWeight, n_heads: int, n_kv_heads: int,
        head_dim: int | None = None, act: str = "silu",
        norm: str = "rmsnorm", eps: float = 1e-5, sm_scale: float = 1.0,
        a8: bool = True, layer: int | None = None) -> torch.Tensor:
    """Plain version of decode_layer_fused: y (1, 1, hidden) f32; writes
    the fresh rows into the cache at slot `length` in place."""
    kc, vc = _layer_cache(k_cache, v_cache, layer)
    hidden = x.shape[-1]
    H, Hkv = n_heads, n_kv_heads
    hd = head_dim or hidden // H
    kvw = Hkv * hd
    S = kc.shape[0]
    pos = _length(length, x.device)
    cs = cos.reshape(-1).to(torch.float32)
    sn = sin.reshape(-1).to(torch.float32)

    x2 = x.reshape(1, hidden).to(torch.float32)
    h1 = _ffn._norm(x2, w_ln1, None, norm, eps)
    row = _ffn._phase(h1, qkv, a8)[0]
    q = rope_rows(row[:H * hd].reshape(H, hd), cs, sn) * sm_scale
    k = rope_rows(row[H * hd:H * hd + kvw].reshape(Hkv, hd), cs, sn)
    v = row[H * hd + kvw:H * hd + 2 * kvw].reshape(Hkv, hd)
    # the fresh rows as the cache holds them (a bf16 rounding point)
    kf = _ffn._bf16(k) if kc.dtype == torch.bfloat16 else k.to(kc.dtype)
    vf = _ffn._bf16(v) if vc.dtype == torch.bfloat16 else v.to(vc.dtype)

    # attention over slots < length (the cache before the write) and the
    # fresh column
    G = H // Hkv
    qg = q.reshape(Hkv, G, hd)
    sc = torch.einsum("hgd,shd->hgs", qg, kc.to(torch.float32))
    valid = torch.arange(S, device=x.device) < pos
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    sf = torch.einsum("hgd,hd->hg", qg, kf.to(torch.float32))
    p = torch.softmax(torch.cat([sc, sf[..., None]], dim=-1), dim=-1)
    attn = (torch.einsum("hgs,shd->hgd", p[..., :S], vc.to(torch.float32))
            + p[..., S:] * vf.to(torch.float32)[:, None, :])

    # the write at slot length (none when the cache is full)
    slot = pos.clamp(max=S - 1).reshape(1)
    full = pos >= S
    for buf, fresh in ((kc, kf), (vc, vf)):
        old = buf.index_select(0, slot)
        buf.index_copy_(0, slot, torch.where(full, old, fresh.to(buf.dtype)[None]))

    o_out = _ffn._phase(attn.reshape(1, H * hd), o, a8)
    r2 = _ffn._bf16(x2 + o_out)
    m2 = _ffn._norm(r2, w_ln2, None, norm, eps)
    g = _ffn._phase(m2, gu, a8)
    half = gu.Np // 2
    inner = _ffn._act(act, g[:, :half], g[:, half:])
    y = _ffn._phase(inner, dn, a8) + r2
    return y[:, :hidden].reshape(1, 1, hidden)


# the weight stream of csrc/layer_stream.cuh: a chunk is CHUNK columns of
# a weight, a stage STAGE_ROWS word rows of one of its fields (a TMA box of
# CHUNK x STAGE_ROWS int32); an item is ITEM ints (see layer_plan)
CHUNK = 128
STAGE_ROWS = 32
ITEM = 8
MAX_PIECES = 32  # pieces of chunks cut in K a block lists in one phase


def layer_plan(shapes, blocks: int, glu: bool = True) -> dict:
    """The static plan of the layer kernel's weight stream: a pure function
    of the four weights' (bits, Kp, Np) (q|k|v, o, gate|up, down) and the
    number of blocks (one an SM). The single-row MLP kernel (csrc/ffn.cu
    mlp_stream_kernel, #5 / #6) streams by the same plan over the weights
    it has: a shape of None is a weight the kernel does not stream (#5:
    q|k|v; #6: q|k|v and o), and glu=False (fc1 -> fc2) pairs no gate|up
    chunks.

    Each weight's work is its chunks' stages in (chunk, field, row) order;
    it is cut into `blocks` contiguous runs of whole stages whose counts
    differ by at most one, and the runs go, largest first, to the blocks
    with the least bytes so far (ties: the lowest index), so that every
    block streams a near-equal share of the whole layer and every block
    streams in every phase: the narrow weights (o, down) are cut in K as
    well as in columns. The run of a chunk that falls to one block is a
    piece; a chunk's pieces are summed in piece order (the order of their
    rows) by the block that finishes the chunk last, so that two launches
    give the same bits. Where CHUNK divides half of gate|up, its chunks c
    and c + half are one ticket's pair, finished together (the GLU
    output) by the pair's last block. Returns {"items": (n, ITEM) int32,
    each a segment of one field's rows of one piece: [weight | field << 2
    | first << 3 | last << 4 | paired << 5 | pieces of the chunk (a pair:
    of the gate chunk) << 8, chunk, row0, row1, piece slot, the chunk's
    (the gate chunk's) first piece slot, ticket (over all weights), a
    pair's up chunk's first slot | its pieces << 20], "first": (blocks +
    1,) int32 item offsets of each block, "pieces": piece slots,
    "tickets": tickets, "bytes": (blocks,) weight bytes each block
    streams, "max_cut": the most pieces one block lists in one phase (the
    kernel's piece list holds MAX_PIECES)}."""
    from gptq_tpu_torch.ops.pack import FIELD_SPLITS

    per_block = [[] for _ in range(blocks)]
    load = [0] * blocks
    slot = ticket = 0
    for w, shape in enumerate(shapes):
        if shape is None:
            continue
        bits, Kp, Np = shape
        rows = [Kp * fb // 32 for fb, _ in FIELD_SPLITS[bits]]
        stages = [-(-r // STAGE_ROWS) for r in rows]
        uc = sum(stages)  # stages of a chunk
        U = (Np // CHUNK) * uc

        def unit(u):  # (chunk, field, first row, rows) of stage u
            c, loc = divmod(u, uc)
            f = 0 if loc < stages[0] else 1
            r0 = (loc - (stages[0] if f else 0)) * STAGE_ROWS
            return c, f, r0, min(STAGE_ROWS, rows[f] - r0)

        runs = [(b * U // blocks, (b + 1) * U // blocks)
                for b in range(blocks)]
        # the pieces of each chunk, in row order: (run index, first, end)
        pieces = {}
        for i, (lo, hi) in enumerate(runs):
            u = lo
            while u < hi:
                c = u // uc
                end = min(hi, (c + 1) * uc)
                pieces.setdefault(c, []).append((i, u, end))
                u = end
        # gate|up: chunk c and c + half are finished together (the GLU
        # output, by the pair's last block), where CHUNK divides the half
        half = (Np // 2 // CHUNK if w == 2 and glu and Np // 2 % CHUNK == 0
                else 0)
        first_slot, c_slot = {}, slot
        for c in sorted(pieces):
            first_slot[c] = c_slot
            c_slot += len(pieces[c])
        items = [[] for _ in runs]
        for c in sorted(pieces):
            cg = c % half if half else c  # the chunk (pair) its ticket counts
            up = c + half if c < half else c
            pair = first_slot[up] | len(pieces[up]) << 20 if half else 0
            for i, u0, u1 in pieces[c]:
                segs = []
                for u in range(u0, u1):
                    _, f, r0, n = unit(u)
                    if segs and segs[-1][0] == f:
                        segs[-1][2] = r0 + n
                    else:
                        segs.append([f, r0, r0 + n])
                for j, (f, r0, r1) in enumerate(segs):
                    head = (w | f << 2 | (j == 0) << 3
                            | (j == len(segs) - 1) << 4 | bool(half) << 5
                            | len(pieces[cg]) << 8)
                    items[i].append([head, c, r0, r1, slot, first_slot[cg],
                                     ticket + cg, pair])
                slot += 1
        ticket += half or Np // CHUNK
        nbytes = [sum((it[3] - it[2]) * CHUNK * 4 for it in items[i])
                  for i in range(blocks)]
        for i in sorted(range(blocks), key=lambda i: -nbytes[i]):
            b = min(range(blocks), key=lambda b: load[b])
            load[b] += nbytes[i]
            per_block[b].extend(items[i])
    # the pieces a block lists in a phase, as the kernel's consume does: the
    # last item of each piece of a chunk cut in K (a gate|up pair: of
    # either chunk, the pair's pieces counted together)
    def listed(it):
        return it[0] & 16 and ((it[0] >> 8)
                               + (it[7] >> 20 if it[0] & 32 else 0)) > 1

    max_cut = max(sum(1 for it in its if it[0] & 3 == w and listed(it))
                  for its in per_block for w in range(4))
    if max_cut > MAX_PIECES:
        raise ValueError(f"layer_plan: a block lists {max_cut} pieces of cut "
                         f"chunks in one phase (at most {MAX_PIECES})")
    first = [0]
    for its in per_block:
        first.append(first[-1] + len(its))
    flat = [it for its in per_block for it in its]
    return {"items": torch.tensor(flat, dtype=torch.int32).reshape(-1, ITEM),
            "first": torch.tensor(first, dtype=torch.int32),
            "pieces": slot, "tickets": ticket, "bytes": load,
            "max_cut": max_cut}


# the kernel's timeline: each block stamps %globaltimer (ns) at the start,
# at the end of each phase and at each grid barrier's exit
PHASES = ("qkv", "attention", "o", "gate_up", "down")
STAMPS = 2 * len(PHASES)


def timeline_split(stamps: torch.Tensor) -> dict:
    """Summarise (blocks, STAMPS) %globaltimer stamps (rows of blocks
    that never ran are all 0) in microseconds: for each phase, the work
    of the slowest and the median block (from its own phase start: the
    kernel's start or its exit of the barrier before), the tail (the
    slowest block's end after the median block's) and the barrier after
    it (the median block's exit after the slowest block's arrival)."""
    t = stamps[(stamps != 0).all(dim=1)].to(torch.float64)
    t = (t - t[:, 0].min()) / 1e3
    out = {"blocks": int(t.shape[0]), "total_us": float(t[:, -1].max())}
    for k, name in enumerate(PHASES):
        start, end = t[:, 2 * k], t[:, 2 * k + 1]
        work = end - start
        row = {"work_max_us": float(work.max()),
               "work_median_us": float(work.median()),
               "tail_us": float(end.max() - end.median()),
               "end_us": float(end.max())}
        if 2 * k + 2 < STAMPS:
            row["barrier_us"] = float(t[:, 2 * k + 2].median() - end.max())
        out[name] = row
    return out


def _lib():
    lib = _build.load("layer_fused")
    f = lib.layer_launch
    if f.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dp = ctypes.POINTER(_ffn._WeightDesc)
        f.argtypes = [vp, vp, vp, i, fl, vp, vp, vp, vp, vp, i, i, i, i, i,
                      fl, i, i, dp, dp, dp, dp, vp, vp, vp, vp, vp, vp, i, i,
                      i, vp, vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        f.restype = ctypes.c_int
        lib.layer_maps.argtypes = [dp, vp]
        lib.layer_maps.restype = ctypes.c_int
    return lib


# the plans by (weight shapes, device); the kernel's barrier and ticket
# words by (device, stream) (see _sync_words); each weight's descriptor and
# TMA maps by its tensors' storage (see _weight_entry)
_plans: dict = {}
_syncs: dict = {}
_retired: list = []  # the words of streams whose launch failed (a graph
# that holds their addresses keeps them alive)
_weights: dict = {}
MAX_WEIGHTS = 4096  # weights kept (past it the cache starts over)


def _device_plan(shapes, dev, glu: bool = True) -> dict:
    """The plan of `shapes` over one block an SM of `dev`, on `dev`."""
    key = (shapes, dev, glu)
    if key not in _plans:
        blocks = _build.sm_count(dev)
        plan = layer_plan(shapes, blocks, glu)
        _plans[key] = {"blocks": blocks,
                       "items": plan["items"].reshape(-1).to(dev),
                       "first": plan["first"].to(dev),
                       "max_items": int((plan["first"][1:]
                                         - plan["first"][:-1]).max()),
                       "max_cut": plan["max_cut"],
                       "pieces": plan["pieces"], "tickets": plan["tickets"]}
    return _plans[key]


def _sync_words(n: int, dev, stream: int) -> torch.Tensor:
    """The kernel's grid barrier count, barrier generation and tickets for
    launches on `stream` (a handle) of `dev`. Launches that share them
    must not overlap, hence one buffer per stream: a stream runs its
    launches one after another. Each launch that runs to its end leaves
    every word but the generation zero (the barrier's last arrival and
    each ticket's last holder reset theirs). A launch whose check raises
    retires its stream's words (_retire_sync_words): the next launch on
    that stream starts from fresh zero words. The words are never reset
    from the host, so a CUDA graph replays its launches on the buffer of
    the stream that captured them; a buffer that grows, or is retired,
    stays alive, since such a graph holds its address."""
    bufs = _syncs.setdefault((_index(dev), stream), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32, device=dev))
    return bufs[-1]


def _retire_sync_words(dev, stream: int) -> None:
    """Stop using the words of `stream`: a launch on it failed, and may
    have left a barrier count or a ticket set that would hang or misfinish
    the next launch. They are kept (a graph may hold them), not checked
    by sync_clean, and the next launch allocates fresh zero words."""
    _retired.append(_syncs.pop((_index(dev), stream), []))


def sync_clean(device=None) -> bool:
    """Are the barrier and ticket words of every stream of `device` (all
    devices: None) zero but the generations, as every launch that ran to
    its end leaves them (retired words aside)? A check for tests and
    chip_smoke.py; it reads the words back (a synchronisation)."""
    want = None if device is None else _index(torch.device(device))
    return all(bool((b[0] == 0) & (b[2:] == 0).all())
               for (dev, _), bufs in _syncs.items()
               if want is None or dev == want for b in bufs)


def _index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _weight_entry(pw: PackedWeight, dev) -> tuple:
    """(descriptor, TMA maps, (bits, Kp, Np)) of one weight of the stream
    kernels (the layer's, or #5 / #6's at one row): its kernel descriptor
    (ops/ffn._desc, which validates it) and its fields' TMA maps (csrc/
    layer_fused.cu layer_maps; ffn.cu's kernel takes the same). Both are
    functions of the weight's tensors' addresses, shapes and dtypes and of
    its format, bits and groupsize, which key the cache: a layer dict
    copied with one weight replaced, or a tensor freed and its memory
    reused, gets the entry of what it holds. A weight with a tensor that
    is not contiguous (its descriptor would point at a copy) is described
    anew at each call."""
    key = (pw.fmt, pw.bits, pw.groupsize, pw.perm is None, pw.bias is None,
           *((t.data_ptr(), t.shape, t.dtype, t.is_contiguous())
             for t in (*pw.words, pw.scale, pw.zoff) if t is not None))
    ent = _weights.get(key)
    if ent is not None and ent[3] == dev:
        return ent
    if pw.fmt != "uniform" or pw.Np % CHUNK:
        raise ValueError(f"weight stream: uniform weights of a stored "
                         f"width that {CHUNK} divides (see layer_fusable)")
    keep = []
    desc = _ffn._desc(pw, None, dev, keep)
    maps = ctypes.create_string_buffer(256)
    _build.check(_lib().layer_maps(ctypes.byref(desc), maps), "layer_maps")
    if not all(k[3] for k in key[5:]):  # keep the copies for this call
        return desc, maps, (pw.bits, pw.Kp, pw.Np), dev, keep
    # the weight's own tensors: the cache holds no reference to them
    ent = (desc, maps, (pw.bits, pw.Kp, pw.Np), dev, None)
    if len(_weights) >= MAX_WEIGHTS:
        _weights.clear()
    _weights[key] = ent
    return ent


class _Rows:
    """The kernel's f32 scratch rows, views of one allocation made on
    demand: rows[name]."""

    def __init__(self, buf, offsets):
        self.buf, self.offsets = buf, offsets

    def __getitem__(self, name):
        off, n = self.offsets[name]
        return self.buf[off:off + n]


def _layer_cuda(x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2, qkv,
                o, gu, dn, n_heads, n_kv_heads, head_dim, act, norm, eps,
                sm_scale, a8, layer, stamps=None):
    """Launch the layer kernel. Returns (y (1, 1, hidden) f32, the
    kernel's f32 scratch rows: {"qkv": the q|k|v row before rope, "attn":
    the attention row, "r2": the residual, "inner": the GLU output}).
    `stamps`, an int64 device tensor of (blocks, STAMPS), receives each
    block's %globaltimer at the phase boundaries (timeline_split).
    Launches on one stream share the kernel's barrier and ticket words
    (_sync_words): one stream runs them one at a time."""
    dev = x.device
    kc, vc = _layer_cache(k_cache, v_cache, layer)
    hidden = x.shape[-1]
    H, Hkv = n_heads, n_kv_heads
    hd = head_dim or hidden // H
    S = kc.shape[0]
    if x.numel() != hidden:
        raise ValueError(f"decode_layer_fused: x of shape {tuple(x.shape)}; "
                         f"the kernel serves one token of one sequence")
    if kc.dtype not in _CACHE_KIND or vc.dtype != kc.dtype:
        raise ValueError(f"decode_layer_fused: cache dtype {kc.dtype} (bf16 "
                         f"or f32; an int8 cache keeps its own route)")
    if kc.shape[1:] != (Hkv, hd) or not (kc.is_contiguous()
                                          and vc.is_contiguous()):
        raise ValueError("decode_layer_fused: the cache must be contiguous "
                         f"(S, {Hkv}, {hd}) rows")
    if norm not in _NORMS or act not in _ffn._ACTS:
        raise ValueError(f"decode_layer_fused: norm {norm!r} / act {act!r}")
    if H % Hkv or H // Hkv > 8 or hd not in (64, 128, 256):
        raise ValueError(f"decode_layer_fused: H={H} Hkv={Hkv} hd={hd} not "
                         f"supported (G <= 8, hd in 64 / 128 / 256)")
    ents = [_weight_entry(pw, dev) for pw in (qkv, o, gu, dn)]
    shapes = tuple(e[2] for e in ents)
    (_, qKp, qNp), (_, oKp, oNp), (_, gKp, gNp), (_, dKp, dNp) = shapes
    if (qKp != hidden or qNp < (H + 2 * Hkv) * hd or oKp != H * hd
            or oNp != hidden or gKp != hidden or gNp != 2 * dKp
            or dNp != hidden):
        raise ValueError("decode_layer_fused: q|k|v, o, gate|up and down "
                         "widths do not chain (see layer_fusable)")
    if isinstance(length, torch.Tensor):
        if length.device != dev or length.numel() != 1:
            raise ValueError("decode_layer_fused: a tensor length must be "
                             "one value on the activations' device")
        lens = length.reshape(1).to(torch.int32)
    else:
        if not 0 <= int(length) < S:
            raise ValueError(f"decode_layer_fused: length {length} outside "
                             f"[0, {S})")
        lens = torch.full((1,), int(length), dtype=torch.int32, device=dev)
    for t in (kc, vc, cos, sin):
        if t.device != dev:
            raise ValueError("decode_layer_fused: every tensor must lie on "
                             "the activations' CUDA device")
    keep = [lens]
    n1, _ = _ffn._norm_vecs(w_ln1, None, norm, hidden, dev, keep)
    n2, _ = _ffn._norm_vecs(w_ln2, None, norm, hidden, dev, keep)
    x1 = x.reshape(hidden).to(torch.float32).contiguous()
    if x1.data_ptr() % 16:  # the kernel reads it in vectors of 4
        x1 = x1.clone()
    cs = cos.reshape(-1).to(torch.float32).contiguous()
    sn = sin.reshape(-1).to(torch.float32).contiguous()
    if cs.numel() != hd or sn.numel() != hd:
        raise ValueError(f"decode_layer_fused: rope tables of {cs.numel()} "
                         f"entries for hd={hd}")
    G = H // Hkv
    plan = _device_plan(shapes, dev)
    blocks = plan["blocks"]
    nsplit = max(1, blocks // Hkv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sync = _sync_words(2 + Hkv + plan["tickets"], dev, stream)

    # the f32 scratch rows in one allocation, each 16-byte aligned (the
    # kernel reads them in vectors of 4)
    offsets, end = {}, 0
    for name, n in (("qkv", qNp), ("attn", H * hd), ("r2", hidden),
                    ("out", hidden), ("pml", Hkv * nsplit * G * 2),
                    ("pacc", Hkv * nsplit * G * hd), ("gu", gNp),
                    ("inner", dKp), ("part", max(1, plan["pieces"]) * CHUNK)):
        offsets[name] = (end, n)
        end += -(-n // 4) * 4
    buf = torch.empty(end, dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    ptr = {name: base + 4 * off for name, (off, _) in offsets.items()}
    if stamps is not None and stamps.shape != (blocks, STAMPS):
        raise ValueError(f"decode_layer_fused: stamps of shape "
                         f"{tuple(stamps.shape)}, not ({blocks}, {STAMPS})")
    err = _lib().layer_launch(
        x1.data_ptr(), n1, n2, _NORMS[norm], float(eps), cs.data_ptr(),
        sn.data_ptr(), lens.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        _CACHE_KIND[kc.dtype], S, H, Hkv, hd, float(sm_scale),
        _ffn._ACTS[act], int(a8), *(ctypes.byref(e[0]) for e in ents),
        *(e[1] for e in ents), plan["items"].data_ptr(),
        plan["first"].data_ptr(), blocks, plan["max_items"], plan["max_cut"],
        ptr["qkv"], ptr["pml"], ptr["pacc"], nsplit, ptr["attn"], ptr["r2"],
        ptr["gu"], ptr["inner"], ptr["out"], ptr["part"], sync.data_ptr(),
        None if stamps is None else stamps.data_ptr(), stream)
    if err != 0:
        _retire_sync_words(dev, stream)
    _build.check(err, "layer_launch")
    out = offsets["out"][0]
    return (buf[out:out + hidden].reshape(1, 1, hidden),
            _Rows(buf, offsets))


def decode_layer_fused(
        x: torch.Tensor,        # (1, 1, hidden) block input (pre-norm)
        k_cache: torch.Tensor,  # (1, S, Hkv, hd) bf16 / f32, or (L, 1, ...)
        v_cache: torch.Tensor,  # with `layer`
        length,                 # int or device int32 tensor: slots cached
        cos: torch.Tensor,      # (..., hd) rope tables of position `length`
        sin: torch.Tensor,
        w_ln1: torch.Tensor, w_ln2: torch.Tensor,
        qkv: PackedWeight, o: PackedWeight, gu: PackedWeight,
        dn: PackedWeight, n_heads: int, n_kv_heads: int,
        head_dim: int | None = None, act: str = "silu",
        norm: str = "rmsnorm", eps: float = 1e-5, sm_scale: float = 1.0,
        a8: bool = True, layer: int | None = None) -> torch.Tensor:
    """One decoder layer for one token in one launch: returns y (1, 1,
    hidden) f32 and writes the fresh k / v rows into the cache at slot
    `length` in place. CUDA tensors go through csrc/layer_fused.cu, CPU
    tensors through decode_layer_fused_reference."""
    global launches
    if not x.is_cuda:
        return decode_layer_fused_reference(
            x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2, qkv, o, gu,
            dn, n_heads, n_kv_heads, head_dim=head_dim, act=act, norm=norm,
            eps=eps, sm_scale=sm_scale, a8=a8, layer=layer)
    y, _ = _layer_cuda(x, k_cache, v_cache, length, cos, sin, w_ln1, w_ln2,
                       qkv, o, gu, dn, n_heads, n_kv_heads, head_dim, act,
                       norm, eps, sm_scale, a8, layer)
    launches += 1
    return y
