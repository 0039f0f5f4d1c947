"""Functional decoder core of the four families, OPT, BLOOM, llama (with
Mixtral-style routed experts) and Gemma (port of gptq_tpu/models/common.py).

Params are plain nested dicts of tensors; a "linear" is {"w": (out, in)
[, "b"]} and `linear_apply` serves PackedWeight low-bit weights through
ops.qmatmul.dequant_matmul (uniform grids) or ops.bcq_matmul.bcq_matmul
(BCQ sign planes), the CUDA kernels on the card. Every block
forward can return the calibration captures, the inputs seen by each
linear. Decode (T == 1 on a cache) attends through
ops.attention.decode_attention over the cache slots below the filled
length plus the token's own fresh k/v, and model_forward writes every
layer's fresh rows into the cache once per step, in place.

Serving routes (GPTQ_TPU_FFN_FUSION, as in the JAX package): on the
fused route a block of at most 32 rows runs ln1 + q|k|v as one
ops.ffn.norm_qkv_fused launch and o + residual + ln2 + gate|up + act +
down + residual as one attn_mlp_fused launch (ffn_fused where only the
MLP can fuse), and the head runs final_ln + a packed lm_head as one
norm_qkv_fused launch. `auto` (the default) takes the fused route for
CUDA tensors and the unfused one (one dequant_matmul per linear) on the
CPU; `on` / `interpret` fuse everywhere (on the CPU through the plain
versions), `off` never. A layer with a router (Mixtral-style MoE, spec
n_experts > 0) runs its FFN through models/moe.moe_ffn and keeps the
fused o + MLP route off. With GPTQ_TPU_LAYER_FUSION=on (default off, as
in the JAX package) a decode block at B = T = 1 over a bf16 / f32 cache
runs as ONE ops.layer_fused.decode_layer_fused launch, which writes its
own fresh cache rows; model_forward then keeps the write-first path for
the blocks that gate refuses. A cache's length may be a device tensor
(the chained decode loop of engine/decode.py): positions, the cache
writes and the kernels then read it on the device, so a CUDA graph can
replay a step. `attn_fn` replaces the attention of a block (the ring
prefill and the SPCache decode of parallel/sp.py); it keeps the whole-
layer route off. The families differ as in the JAX package: OPT has
learned positions (offset 2), optional project_in / project_out and the
post-norm block of OPT-350m (do_layer_norm_before False); BLOOM a natively
fused, biased q|k|v linear, a layernorm on the word embedding and alibi
attention (its decode attends the materialized cache with the token's own
k / v as one more softmax column, no decode kernel, as in the JAX package);
OPT / BLOOM an fc1 -> act -> fc2 MLP with biases, which the fused route
serves with glu=False; Gemma rmsnorm1p, gelu_tanh and an embedding scaled
by sqrt(hidden) in the embedding's dtype.

Tensor parallelism (`tp`, a ShardGroup: parallel/tp.py builds each rank's
local params): q / k / v / gate / up / fc1 are the rank's column shards
(its local heads and FFN columns), o / down / fc2 its row shards, whose
partial products all_reduce over the group (`_row_linear`, the bias added
once after the sum; an act-order row shard gathers the input over the
group first and takes its slice of the permutation). BLOOM's alibi
slopes are the rank's heads' (`_local_slopes`); a dense head sharded in
vocab (ServeFlags.vocab_tp) gathers its logits. Under tp every fused
route stands down, as in the JAX package, so each linear runs through
dequant_matmul / bcq_matmul on its shard. Expert parallelism (`ep`)
runs each rank's slice of the expert banks (models/moe.py). The
gathers are all_reduce calls (SUM over a zero-filled full-width buffer
into which each rank writes its slice): gloo takes them on CUDA tensors
(through host copies), and a CUDA graph captures NCCL's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.models.moe import init_moe_params, moe_ffn
from gptq_tpu_torch.ops.attention import decode_attention
from gptq_tpu_torch.ops.bcq_matmul import bcq_matmul
from gptq_tpu_torch.ops.ffn import (attn_mlp_fusable, attn_mlp_fused,
                                    ffn_fusable, ffn_fused, norm_qkv_fusable,
                                    norm_qkv_fused)
from gptq_tpu_torch.ops.layer_fused import decode_layer_fused, layer_fusable
from gptq_tpu_torch.ops.pack import PackedWeight, fuse_packed
from gptq_tpu_torch.ops.qmatmul import dequant_matmul, quantize_acts_int8

NEG_INF = -1e9


@dataclass(frozen=True)
class ArchSpec:
    """Static architecture description (same fields as the JAX package's
    ArchSpec, so checkpoint headers interchange)."""

    arch: str  # opt | bloom | llama | gemma
    n_layers: int
    hidden: int
    n_heads: int
    ffn: int
    vocab: int
    max_pos: int
    n_kv_heads: int = -1  # -1 -> = n_heads
    head_dim: int = -1  # -1 -> hidden // n_heads
    norm_eps: float = 1e-5
    act: str = "relu"  # relu | gelu | silu | gelu_tanh
    pos: str = "learned"  # learned | alibi | rope
    rope_theta: float = 10000.0
    norm_type: str = "layernorm"  # layernorm | rmsnorm | rmsnorm1p
    qk_scale: float = -1.0  # -1 -> 1/sqrt(head_dim)
    embed_scale: float = 1.0
    do_layer_norm_before: bool = True
    tie_embeddings: bool = False
    linear_bias: bool = True
    word_embed_dim: int = -1
    n_experts: int = 0
    expert_top_k: int = 2
    expert_capacity: float = 1.25

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads > 0 else self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.hidden // self.n_heads

    @property
    def scale(self) -> float:
        return self.qk_scale if self.qk_scale > 0 else 1.0 / float(math.sqrt(self.hd))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeFlags:
    """Serving-mode flags on a linear. a8: dynamic int8 activations
    (the --faster-kernel path). vocab_tp: the head is this tp rank's vocab
    slice; head_forward gathers the logits over the group."""

    a8: bool = False
    vocab_tp: bool = False


@dataclass(frozen=True)
class ShardGroup:
    """A rank's tensor- or expert-parallel group: the torch.distributed
    group (None: the default group; at size 1 no collective runs), its
    size and this rank's index in it. Passing one, of any size, marks the
    forward as sharded: the fused routes stand down (the JAX package's
    tp_axis)."""

    group: object = None
    size: int = 1
    rank: int = 0


def all_reduce_sum(x: torch.Tensor, g: ShardGroup) -> torch.Tensor:
    """Sum of x over the group's ranks (x itself at size 1)."""
    if g.size == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=g.group)
    return x


def all_gather_last(x: torch.Tensor, g: ShardGroup) -> torch.Tensor:
    """x (..., n) of every rank -> (..., size * n) in rank order: one
    all_reduce SUM of a zero-filled buffer holding this rank's slice
    (exact: every other term is 0)."""
    if g.size == 1:
        return x
    n = x.shape[-1]
    buf = x.new_zeros(*x.shape[:-1], g.size * n)
    buf[..., g.rank * n:(g.rank + 1) * n] = x
    dist.all_reduce(buf, group=g.group)
    return buf


@dataclass(frozen=True)
class FusedSplits:
    """(n_stored, n_logical) column extents of each part of a fused weight."""

    parts: tuple


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T in the promoted dtype of the two, as jnp.einsum promotes
    (rope's f32 tables turn bf16 activations into f32 after the first
    attention, so a bf16 head meets f32 activations)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.T.to(dt))


def linear_apply(lin: dict, x: torch.Tensor) -> torch.Tensor:
    aq = lin.get("act_q")
    if aq is not None:
        # activation quantization (pipeline.add_actquant): the input
        # fake-quantized on a per-feature grid, in f32, back in x's dtype
        q = torch.clamp(torch.round(x / aq["scale"]) + aq["zero"], 0,
                        aq["maxq"])
        x = (aq["scale"] * (q - aq["zero"])).to(x.dtype)
    w = lin["w"]
    if isinstance(w, PackedWeight):
        flags = lin.get("serve")
        a8 = bool(flags and flags.a8)
        if w.fmt == "bcq":
            y = bcq_matmul(x, w, a8=a8)
        else:
            y = dequant_matmul(x, w, a8=a8)
    else:
        y = _dense(x, w)
    if lin.get("b") is not None:
        y = y + lin["b"]
    return y


def norm_apply(spec: ArchSpec, p: dict, x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    if spec.norm_type == "layernorm":
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + spec.norm_eps)
        y = y * p["w"] + p["b"]
    else:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + spec.norm_eps)
        w = p["w"].to(torch.float32)
        y = y * (1.0 + w) if spec.norm_type == "rmsnorm1p" else y * w
    return y.to(x.dtype)


def activation(spec: ArchSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.act == "relu":
        return torch.relu(x)
    if spec.act == "gelu":
        return torch.nn.functional.gelu(x, approximate="none")
    if spec.act == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu(x)


def rope_tables(spec: ArchSpec, positions: torch.Tensor):
    """positions: (B, T) -> cos/sin (B, T, hd) in f32."""
    hd = spec.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv_freq = 1.0 / (spec.rope_theta ** exps)
    ang = positions[..., None].to(torch.float32) * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, T, H, hd); HF 'rotate_half' convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos[:, :, None, :] + rot * sin[:, :, None, :]


def alibi_slopes(n_heads: int) -> np.ndarray:
    """BLOOM alibi slopes (HF formula; a copy of the JAX package's)."""
    closest = 2 ** int(np.floor(np.log2(n_heads)))
    base = 2.0 ** (-(2.0 ** -(np.log2(closest) - 3)))
    slopes = base ** np.arange(1, closest + 1)
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(np.log2(2 * closest) - 3)))
        extra = extra_base ** np.arange(1, 2 * (n_heads - closest) + 1, 2)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


@dataclass
class KVCache:
    """Preallocated cache; `length` is the filled prefix: a host int, or a
    0-dim int32 tensor on the cache's device (the chained decode loop's,
    which a CUDA graph reads without a host sync).

    k/v: (L, B, max_len, kv_heads, hd). With dtype int8 the cache stores
    dynamically quantized rows with per-token-head absmax scales
    (L, B, max_len, kv_heads) in k_scale / v_scale. model_forward writes
    into the buffers in place and returns a new KVCache over the same
    buffers with the longer length."""

    k: torch.Tensor
    v: torch.Tensor
    length: int | torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def init(spec: ArchSpec, batch: int, max_len: int,
             dtype=torch.bfloat16, device="cuda") -> "KVCache":
        device = resolve_device(device)
        shape = (spec.n_layers, batch, max_len, spec.kv_heads, spec.hd)
        ks = vs = None
        if dtype == torch.int8:
            ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=0, k_scale=ks, v_scale=vs)


def _write_slots(buf: torch.Tensor, rows: torch.Tensor, start, dim: int):
    """buf[start:start + T] = rows along `dim` (T = rows.shape[dim]), in
    place. A tensor `start` is read on the device (index_copy_); a (B,)
    one holds a start per slot, the slots being dim - 1: buf[.., b,
    start[b] + t] = rows[.., b, t], one scatter (continuous batching)."""
    T = rows.shape[dim]
    rows = rows.to(buf.dtype)
    if getattr(start, "ndim", 0) == 1:
        dev = buf.device
        b = torch.arange(rows.shape[dim - 1], device=dev)[:, None]
        t = (start.to(device=dev, dtype=torch.int64)[:, None]
             + torch.arange(T, device=dev))
        buf[(slice(None),) * (dim - 1) + (b, t)] = rows
    elif isinstance(start, torch.Tensor):
        idx = (start.reshape(1).to(device=buf.device, dtype=torch.int64)
               + torch.arange(T, device=buf.device))
        buf.index_copy_(dim, idx, rows)
    else:
        buf.narrow(dim, start, T).copy_(rows)


def _quantize_kv(x: torch.Tensor):
    """(..., hd) -> int8 values + (...) per-token-head scales (the
    activation quantizer's rule: IEEE absmax / 127, round half to even)."""
    q, s = quantize_acts_int8(x)
    return q, s[..., 0]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(spec: ArchSpec, q, k, v, mask) -> torch.Tensor:
    """Dense softmax attention (prefill / calibration / eval). q: (B, T,
    H, hd); k/v: (B, S, kvh, hd); mask: (B|1, 1, T, S) additive."""
    B, T, H, hd = q.shape
    kvh = k.shape[2]
    if kvh != H:
        rep = H // kvh
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.to(torch.float32) * spec.scale
    scores = torch.einsum("bthd,bshd->bhts", qf, k.to(torch.float32))
    probs = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(torch.float32))
    return out.reshape(B, T, H * hd).to(q.dtype)


def _attention_with_self(spec: ArchSpec, q, k_all, v_all, mask, k_new,
                         v_new) -> torch.Tensor:
    """Decode attention over the cache slots under `mask` plus the token's
    own (not yet written) k / v as one more softmax column (the deferred
    write of an alibi model; the self column's alibi bias is slope * 0).
    q, k_new, v_new: (B, 1, H | kvh, hd); mask: (*, *, 1, S) additive,
    NEG_INF at and beyond the filled length."""
    B, T, H, hd = q.shape
    kvh = k_all.shape[2]
    if kvh != H:
        rep = H // kvh
        k_all = torch.repeat_interleave(k_all, rep, dim=2)
        v_all = torch.repeat_interleave(v_all, rep, dim=2)
        k_new = torch.repeat_interleave(k_new, rep, dim=2)
        v_new = torch.repeat_interleave(v_new, rep, dim=2)
    qf = q.to(torch.float32) * spec.scale
    sc = torch.einsum("bthd,bshd->bhts", qf, k_all.to(torch.float32)) + mask
    s_self = (qf * k_new.to(torch.float32)).sum(-1)  # (B, 1, H)
    full = torch.cat([sc, s_self.permute(0, 2, 1)[..., None]], dim=-1)
    p = torch.softmax(full, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p[..., :-1],
                       v_all.to(torch.float32))
    out = out + p[..., -1:].permute(0, 2, 1, 3) * v_new.to(torch.float32)
    return out.reshape(B, T, H * hd).to(q.dtype)


def causal_mask(T: int, S: int, device="cpu") -> torch.Tensor:
    """(1, 1, T, S) additive mask; queries are the last T of S positions."""
    q_pos = torch.arange(T, device=device)[:, None] + (S - T)
    k_pos = torch.arange(S, device=device)[None, :]
    m = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
    return m[None, None]


# (n_heads, tp size, tp rank, device) -> the alibi slopes on the device
_slopes: dict = {}


def _local_slopes(spec: ArchSpec, device, tp: ShardGroup | None = None):
    """The alibi slopes of this rank's heads (all of them without tp): the
    formula needs the global head count, and the rank's heads are the
    contiguous block rank * H / tp ... Copied to the device once (a CUDA
    graph of the chained decode cannot capture a copy from the host)."""
    size, rank = (1, 0) if tp is None else (tp.size, tp.rank)
    key = (spec.n_heads, size, rank, device)
    if key not in _slopes:
        lh = spec.n_heads // size
        _slopes[key] = torch.as_tensor(
            alibi_slopes(spec.n_heads)[rank * lh:(rank + 1) * lh],
            device=device)
    return _slopes[key]


def alibi_bias(spec: ArchSpec, q_pos: torch.Tensor, k_pos: torch.Tensor,
               tp: ShardGroup | None = None) -> torch.Tensor:
    """BLOOM's alibi additive bias slope_h * (k_pos - q_pos): q_pos (..., T,
    1), k_pos (S,) -> (..., H, T, S) (HF convention; H the rank's heads
    under tp)."""
    slopes = _local_slopes(spec, k_pos.device, tp)
    rel = (k_pos.to(torch.float32) - q_pos.to(torch.float32))
    return slopes[:, None, None] * rel.unsqueeze(-3)


def build_mask(spec: ArchSpec, T: int, S: int, device="cpu",
               tp: ShardGroup | None = None) -> torch.Tensor:
    """(1, 1 | H, T, S) additive mask: causal, plus alibi's bias."""
    mask = causal_mask(T, S, device)
    if spec.pos == "alibi":
        q_pos = torch.arange(T, device=device)[:, None] + (S - T)
        mask = mask + alibi_bias(spec, q_pos, torch.arange(S, device=device),
                                 tp)
    return mask


# ---------------------------------------------------------------------------
# serving fusion
# ---------------------------------------------------------------------------

def same_actq(a, b) -> bool:
    """Elementwise equality of two activation-quantizer param dicts (both
    None counts as equal): a fused entry applies part 0's quantizer to the
    whole input."""
    if a is None or b is None:
        return a is None and b is None
    return (a["maxq"] == b["maxq"] and torch.equal(a["scale"], b["scale"])
            and torch.equal(a["zero"], b["zero"]))


def fuse_serving(spec: ArchSpec, params: dict, a8: bool = False) -> dict:
    """Merge q/k/v (not BLOOM's, which is one linear already) and the llama
    / Gemma gate/up PackedWeights that share one input into single wider
    weights (one dequant-matmul launch instead of three / two), each
    part's bias kept in b_parts. Parts of different bits (mixed
    precision), formats or act-order perms stay apart (ops/pack
    fuse_packed), as do parts whose activation quantizers differ; equal
    ones ride on the fused entry. With a8=True every packed linear is
    marked for dynamic int8 activations (the --faster-kernel path)."""

    def try_fuse(lp, names, key):
        lins = [lp.get(n) for n in names]
        if any(lin is None or not isinstance(lin.get("w"), PackedWeight)
               for lin in lins):
            return
        act_qs = [lin.get("act_q") for lin in lins]
        if not all(same_actq(act_qs[0], aq) for aq in act_qs[1:]):
            return
        fused = fuse_packed([lin["w"] for lin in lins])
        if fused is None:
            return
        lp[key] = {
            "w": fused,
            "act_q": act_qs[0],
            "splits": FusedSplits(tuple((lin["w"].Np, lin["w"].N)
                                        for lin in lins)),
            "b_parts": [lin.get("b") for lin in lins],
        }
        for n in names:
            del lp[n]

    new_layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        if spec.arch != "bloom":
            try_fuse(lp, ("q", "k", "v"), "qkv_fused")
        if spec.arch in ("llama", "gemma"):
            try_fuse(lp, ("gate", "up"), "gateup_fused")
        if a8:
            for key, val in lp.items():
                w = val.get("w") if isinstance(val, dict) else None
                if isinstance(w, PackedWeight):
                    lp[key] = {**val, "serve": ServeFlags(a8=True)}
        new_layers.append(lp)
    out = {**params, "layers": new_layers}
    lm = params.get("lm_head")
    if a8 and lm is not None and isinstance(lm.get("w"), PackedWeight):
        out["lm_head"] = {**lm, "serve": ServeFlags(a8=True)}
    return out


def _apply_fused(entry: dict, x: torch.Tensor) -> list:
    """Run a fused linear and slice each part's logical columns back out."""
    y = linear_apply({"w": entry["w"], "b": None, "act_q": entry.get("act_q"),
                      "serve": entry.get("serve")}, x)
    outs = []
    off = 0
    for (n_stored, n_logical), bias in zip(entry["splits"].parts,
                                           entry["b_parts"]):
        part = y[..., off:off + n_logical]
        if bias is not None:
            part = part + bias
        outs.append(part)
        off += n_stored
    return outs


# ---------------------------------------------------------------------------
# fused-route gates (as gptq_tpu/models/common.py)
# ---------------------------------------------------------------------------

def _ffn_fusion_impl(device) -> bool:
    """Whether the fused serving kernels serve tensors on `device`
    (GPTQ_TPU_FFN_FUSION: auto = on CUDA tensors only, on / kernel /
    interpret = everywhere, off = never)."""
    mode = os.environ.get("GPTQ_TPU_FFN_FUSION", "auto")
    if mode in ("on", "kernel", "interpret"):
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(
            f"GPTQ_TPU_FFN_FUSION={mode!r}: expected auto/on/off/interpret")
    return torch.device(device).type == "cuda"


def _stream_preferred(w) -> bool:
    """Serve through the fused kernels? Uniform formats only (BCQ keeps its
    own kernel, as in the JAX package)."""
    return isinstance(w, PackedWeight) and w.fmt != "bcq"


def _a8_mode(*entries):
    """The shared dynamic-int8 activation mode of a phase's entries, or
    None when the flags disagree (mixed configs keep the unfused path)."""
    modes = {bool(e.get("serve") and e["serve"].a8) for e in entries}
    return modes.pop() if len(modes) == 1 else None


def _ffn_fusion_entry(p, captures, device, tp=None):
    """The gate|up entry's activation mode (True = a8, False = a16) when
    ffn_fused can serve this block's MLP, else None (always under tp)."""
    if (not _ffn_fusion_impl(device) or tp is not None
            or captures is not None):
        return None
    gu = p.get("gateup_fused")
    dn = p.get("down")
    if gu is None or dn is None or not _stream_preferred(dn.get("w")):
        return None
    if not _stream_preferred(gu.get("w")):
        return None
    a8 = _a8_mode(gu, dn)
    if a8 is None:
        return None
    if gu.get("act_q") is not None or dn.get("act_q") is not None:
        return None
    if any(b is not None for b in gu["b_parts"]) or dn.get("b") is not None:
        return None
    if not ffn_fusable(gu["w"], dn["w"]):
        return None
    return a8


def _norm_qkv_ok(spec, p, captures, n_rows, device, tp=None):
    """Activation mode (True = a8, False = a16) when norm_qkv_fused can
    serve this block's attention input (ln1 + fused q|k|v), else None."""
    if (not _ffn_fusion_impl(device) or tp is not None
            or captures is not None or n_rows > 32):
        return None
    if not spec.do_layer_norm_before or spec.norm_type not in (
            "rmsnorm", "rmsnorm1p", "layernorm"):
        return None
    if spec.arch == "bloom":  # its q|k|v is natively one fused linear
        entry = p.get("qkv")
        if entry is None or not _stream_preferred(entry.get("w")):
            return None
        if entry.get("act_q") is not None:
            return None
        if entry.get("b") is not None and entry["w"].Np != entry["w"].N:
            return None
        return _a8_mode(entry) if norm_qkv_fusable(entry["w"]) else None
    entry = p.get("qkv_fused")
    if entry is None or not _stream_preferred(entry.get("w")):
        return None
    if entry.get("act_q") is not None:
        return None
    if any(b is not None for b in entry["b_parts"]):
        # biases fold into the kernel only when every part's stored width
        # equals its logical width (the concat then lines up exactly)
        if any(ns != nl for ns, nl in entry["splits"].parts):
            return None
    return _a8_mode(entry) if norm_qkv_fusable(entry["w"]) else None


def _qkv_fused_bias(entry):
    """Concatenated per-part bias vector for the fused qkv kernel, or None
    (only called when _norm_qkv_ok validated the alignment)."""
    if all(b is None for b in entry["b_parts"]):
        return None
    w = entry["w"].scale
    return torch.cat([torch.zeros(ns, dtype=torch.float32, device=w.device)
                      if b is None else b.to(torch.float32)
                      for (ns, _), b in zip(entry["splits"].parts,
                                            entry["b_parts"])])


def _mlp_entries(spec, p):
    """(fc1-like entry, fc2-like entry, glu) for the fused MLP kernels:
    llama / Gemma the fused gate|up weight (GLU), OPT / BLOOM fc1 / fc2."""
    if spec.arch in ("llama", "gemma"):
        return p.get("gateup_fused"), p.get("down"), True
    if spec.arch in ("opt", "bloom"):
        return p.get("fc1"), p.get("fc2"), False
    return None, None, False


def _attn_mlp_ok(spec, p, captures, n_rows, device, tp=None):
    """Activation mode (True = a8, False = a16) when attn_mlp_fused can
    serve this block (o + residual + norm + MLP + residual), else None."""
    if (not _ffn_fusion_impl(device) or tp is not None
            or captures is not None or n_rows > 32):
        return None
    if not spec.do_layer_norm_before or spec.norm_type not in (
            "rmsnorm", "rmsnorm1p", "layernorm"):
        return None
    g_e, d_e, glu = _mlp_entries(spec, p)
    if g_e is None or d_e is None:
        return None
    for e in (g_e, d_e):
        if not _stream_preferred(e.get("w")) or e.get("act_q") is not None:
            return None
    if glu and (any(b is not None for b in g_e["b_parts"])
                or d_e.get("b") is not None):
        return None  # the llama family has no MLP biases
    if not glu:
        # OPT / BLOOM biases fold into the kernel only when stored == N
        for e in (g_e, d_e):
            if e.get("b") is not None and e["w"].Np != e["w"].N:
                return None
    o = p.get("o")
    if o is None or not _stream_preferred(o.get("w")) or o.get("act_q"):
        return None
    if o.get("b") is not None and o["w"].Np != o["w"].N:
        return None
    a8 = _a8_mode(o, g_e, d_e)
    if a8 is None:
        return None
    if not attn_mlp_fusable(o["w"], g_e["w"], d_e["w"], glu=glu):
        return None
    return a8


def _layer_fusion_impl() -> bool:
    """Whether decode takes the whole-layer route (ops/layer_fused.py):
    GPTQ_TPU_LAYER_FUSION = off (the default, as in the JAX package) / on
    (also `kernel`, `auto`) / interpret. `on` and `interpret` both take
    it; the wrapper launches the kernel for CUDA tensors and runs the
    plain version for CPU ones."""
    mode = os.environ.get("GPTQ_TPU_LAYER_FUSION", "off")
    if mode in ("on", "kernel", "auto", "interpret"):
        return True
    if mode != "off":
        raise ValueError(
            f"GPTQ_TPU_LAYER_FUSION={mode!r}: expected off/on/interpret")
    return False


def _layer_fusion_ok(spec, p, captures, B, T, cache, cache_len, tp=None):
    """Activation mode (True = a8, False = a16) when decode_layer_fused can
    serve this whole block, else None (the JAX gate): decode only at
    B == T == 1 with a scalar length, a bf16 / f32 cache, rope + pre-norm
    rmsnorm, and four bias-free PackedWeight entries sharing one a8
    mode."""
    if (not _layer_fusion_impl() or tp is not None or captures is not None
            or B != 1 or T != 1):
        return None
    if cache is None or cache_len is None:
        return None
    if getattr(cache_len, "ndim", 0):
        return None  # per-slot offsets keep the three-launch path
    if len(cache) == 4 and cache[2] is not None:
        return None  # an int8 cache keeps the int8 attention kernel
    if cache[0].dtype == torch.int8:
        return None
    if (spec.pos != "rope" or not spec.do_layer_norm_before
            or spec.norm_type not in ("rmsnorm", "rmsnorm1p")):
        return None
    entries = (p.get("qkv_fused"), p.get("o"), p.get("gateup_fused"),
               p.get("down"))
    if any(e is None for e in entries):
        return None
    for e in entries:
        if not isinstance(e.get("w"), PackedWeight) or e.get("act_q"):
            return None
    qkv, o, gu, dn = entries
    if any(b is not None for b in qkv["b_parts"]):
        return None
    if any(b is not None for b in gu["b_parts"]):
        return None
    if o.get("b") is not None or dn.get("b") is not None:
        return None
    a8 = _a8_mode(*entries)
    if a8 is None:
        return None
    if not layer_fusable(qkv["w"], qkv["splits"], o["w"], gu["w"], dn["w"],
                         spec.hidden, spec.n_heads, spec.kv_heads,
                         head_dim=spec.hd):
        return None
    return a8


def _head_fusion_ok(spec, params, n_rows, device, tp=None):
    """Activation mode (True = a8 under --faster-kernel, False = bf16) when
    final_ln + the packed lm_head can run as one norm_qkv_fused launch,
    else None."""
    if not _ffn_fusion_impl(device) or tp is not None or n_rows > 32:
        return None
    if spec.norm_type not in ("rmsnorm", "rmsnorm1p", "layernorm"):
        return None
    if params.get("final_ln") is None:
        return None
    if params["embed"].get("project_out") is not None:
        return None  # OPT's projection lies between final_ln and the head
    lm = params.get("lm_head")
    if lm is None or not _stream_preferred(lm.get("w")):
        return None
    if lm.get("act_q") is not None:
        return None
    if lm.get("b") is not None and lm["w"].Np != lm["w"].N:
        return None
    if not norm_qkv_fusable(lm["w"]):
        return None
    return _a8_mode(lm)


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------

def _qkv(spec: ArchSpec, p: dict, x: torch.Tensor, captures):
    B, T, _ = x.shape
    hd = spec.hd
    if "qkv_fused" in p:
        q, k, v = _apply_fused(p["qkv_fused"], x)
    elif spec.arch == "bloom":
        if captures is not None:
            captures["self_attention.query_key_value"] = x
        return _split_bloom_qkv(linear_apply(p["qkv"], x), hd)
    else:
        if captures is not None:
            captures["self_attn.q_proj"] = x
            captures["self_attn.k_proj"] = x
            captures["self_attn.v_proj"] = x
        q = linear_apply(p["q"], x)
        k = linear_apply(p["k"], x)
        v = linear_apply(p["v"], x)
    return (q.reshape(B, T, q.shape[-1] // hd, hd),
            k.reshape(B, T, k.shape[-1] // hd, hd),
            v.reshape(B, T, v.shape[-1] // hd, hd))


def _row_linear(lin: dict, x: torch.Tensor, tp: ShardGroup | None):
    """A row-parallel (input-sharded) linear: the rank's partial product,
    summed over the tp group, the bias added once after the sum. An
    act-order row shard carries the rank's slice of the padded
    permutation (parallel/tp.py): the input is gathered over the group
    and the rank takes the rows its permuted weight shard needs."""
    if tp is None:
        return linear_apply(lin, x)
    w = lin.get("w")
    if isinstance(w, PackedWeight) and w.perm is not None:
        x = all_gather_last(x, tp)[..., w.perm.long()]
        lin = {**lin, "w": dataclasses.replace(w, perm=None)}
    y = all_reduce_sum(linear_apply({**lin, "b": None}, x), tp)
    if lin.get("b") is not None:
        y = y + lin["b"]
    return y


def _split_bloom_qkv(fused: torch.Tensor, hd: int):
    """BLOOM's fused q|k|v output (B, T, H * 3 hd), interleaved per head,
    -> q, k, v (B, T, H, hd)."""
    B, T, n = fused.shape
    fused = fused.reshape(B, T, n // (3 * hd), 3 * hd)
    return torch.split(fused, hd, dim=-1)


def block_forward(spec: ArchSpec, p: dict, x: torch.Tensor, *,
                  positions=None, mask=None, cache=None, cache_len=None,
                  capture: bool = False, rope=None, defer_write: bool = False,
                  full_cache=None, moe_aux: list | None = None,
                  attn_fn=None, tp: ShardGroup | None = None,
                  ep: ShardGroup | None = None):
    """One decoder block. Returns (out, new_kv, captures).

    With `cache` = (k, v, k_scale, v_scale) per-layer views, keys/values
    are written IN PLACE at [cache_len, cache_len + T) (a (B,) cache_len:
    each row at its own offset) and attention runs over the cache under
    the caller's mask (prefill). With `defer_write` (T == 1) the block
    does not write the cache: decode_attention reads the whole stacked
    cache `full_cache` = (kL, vL, ksL, vsL, i) at this block's layer i,
    over slots < cache_len plus the token's own k/v, and new_kv returns
    the fresh (B, 1, kvh, hd) rows for model_forward to write. On the
    whole-layer route (_layer_fusion_ok) one decode_layer_fused launch
    runs the block and writes its fresh rows at cache_len. Without a
    cache, S = T (calibration / eval). `moe_aux`, a list, collects an MoE
    layer's load-balancing loss. `attn_fn(spec, q, k, v, mask)`, given,
    replaces attention() (sequence-parallel ring prefill / SPCache decode)
    and keeps the whole-layer route off; the fused norm_qkv and attn_mlp
    routes stay as their gates decide. `tp` (a ShardGroup): p holds the
    rank's shards (module doc) and every fused route stands down; `ep`:
    an MoE layer runs the rank's expert slice (models/moe.moe_ffn)."""
    captures = {} if capture else None
    B, T, _ = x.shape
    residual = x
    layer_a8 = (None if attn_fn is not None or defer_write else
                _layer_fusion_ok(spec, p, captures, B, T, cache,
                                 cache_len, tp))
    if layer_a8 is not None:
        # the whole decoder layer in one launch (ln1 + q|k|v + rope +
        # attention + o + ln2 + MLP + residuals); it writes the fresh rows
        cos, sin = rope if rope is not None else rope_tables(spec, positions)
        if full_cache is not None:  # read the stacked cache in place
            kc, vc, li = full_cache[0], full_cache[1], full_cache[4]
        else:
            kc, vc, li = cache[0], cache[1], None
        y = decode_layer_fused(
            x, kc, vc, cache_len, cos, sin, p["ln1"]["w"], p["ln2"]["w"],
            p["qkv_fused"]["w"], p["o"]["w"], p["gateup_fused"]["w"],
            p["down"]["w"], n_heads=spec.n_heads, n_kv_heads=spec.kv_heads,
            head_dim=spec.hd, act=spec.act, norm=spec.norm_type,
            eps=float(spec.norm_eps), sm_scale=float(spec.scale), a8=layer_a8,
            layer=li)
        return y.to(x.dtype), cache, captures
    qkv_a8 = _norm_qkv_ok(spec, p, captures, B * T, x.device, tp)
    if qkv_a8 is not None:
        # ln1 + fused q|k|v in one launch
        if spec.arch == "bloom":  # the natively fused q|k|v linear
            entry = p["qkv"]
            y = norm_qkv_fused(x, p["ln1"]["w"], entry["w"],
                               norm=spec.norm_type, eps=float(spec.norm_eps),
                               a8=qkv_a8, b_ln=p["ln1"].get("b"),
                               b_qkv=entry.get("b"))
            q, k, v = _split_bloom_qkv(y[..., :entry["w"].N], spec.hd)
        else:
            entry = p["qkv_fused"]
            y = norm_qkv_fused(x, p["ln1"]["w"], entry["w"],
                               norm=spec.norm_type, eps=float(spec.norm_eps),
                               a8=qkv_a8, b_ln=p["ln1"].get("b"),
                               b_qkv=_qkv_fused_bias(entry))
            outs, off = [], 0
            for n_stored, n_logical in entry["splits"].parts:
                outs.append(y[..., off:off + n_logical])
                off += n_stored
            q, k, v = (o.reshape(B, T, o.shape[-1] // spec.hd, spec.hd)
                       for o in outs)
    else:
        h = norm_apply(spec, p["ln1"], x) if spec.do_layer_norm_before else x
        q, k, v = _qkv(spec, p, h, captures)
    if spec.pos == "rope":
        cos, sin = rope if rope is not None else rope_tables(spec, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_kv = None
    if cache is not None:
        ck, cv, ks, vs = cache
        if defer_write:
            if T != 1 or full_cache is None:
                raise ValueError("defer_write decodes one token at a time "
                                 "over the stacked cache (full_cache)")
            new_kv = (k, v)
            if spec.pos == "alibi":
                # no decode kernel takes alibi (as in the JAX package): the
                # materialized cache under the caller's mask + the token
                if ks is not None:
                    k_all = ck.to(torch.float32) * ks[..., None]
                    v_all = cv.to(torch.float32) * vs[..., None]
                else:
                    k_all, v_all = ck, cv
                attn = _attention_with_self(spec, q, k_all, v_all, mask, k, v)
                return _finish_block(spec, p, residual, attn, captures,
                                     new_kv, moe_aux, tp, ep)
            kL, vL, ksL, vsL, li = full_cache
            out = decode_attention(q[:, 0], kL, vL, cache_len, spec.scale,
                                   k_scale=ksL, v_scale=vsL, fresh_k=k[:, 0],
                                   fresh_v=v[:, 0], layer=li)
            attn = out.reshape(B, 1, -1).to(x.dtype)
            return _finish_block(spec, p, residual, attn, captures, new_kv,
                                 moe_aux, tp, ep)
        if ks is not None:
            kq, ksn = _quantize_kv(k)
            vq, vsn = _quantize_kv(v)
            for buf, rows in ((ck, kq), (cv, vq), (ks, ksn), (vs, vsn)):
                _write_slots(buf, rows, cache_len, 1)
            k_all = ck.to(torch.float32) * ks[..., None]
            v_all = cv.to(torch.float32) * vs[..., None]
        elif ck.dtype == torch.int8:
            raise ValueError("an int8 KV cache needs its scale planes")
        else:
            _write_slots(ck, k, cache_len, 1)
            _write_slots(cv, v, cache_len, 1)
            k_all, v_all = ck, cv
        new_kv = cache
    else:
        k_all, v_all = k, v
    attn = (attn_fn or attention)(spec, q, k_all, v_all, mask)
    return _finish_block(spec, p, residual, attn, captures, new_kv, moe_aux,
                         tp, ep)


def _finish_block(spec, p, residual, attn, captures, new_kv, moe_aux=None,
                  tp: ShardGroup | None = None, ep: ShardGroup | None = None):
    """Post-attention half of a block: the o projection, then the GLU MLP
    (llama / Gemma), fc1 -> act -> fc2 (OPT / BLOOM) or the routed expert
    FFN of an MoE layer; OPT-350m's post-norm where do_layer_norm_before
    is False. Under tp the row shards o / down / fc2 sum over the group."""
    n_rows = attn.numel() // attn.shape[-1]
    mlp_a8 = (None if "router" in p else
              _attn_mlp_ok(spec, p, captures, n_rows, attn.device, tp))
    if mlp_a8 is not None:
        # o + residual + ln2 + MLP + residual in one launch
        g_e, d_e, glu = _mlp_entries(spec, p)
        out = attn_mlp_fused(
            attn, residual, p["ln2"]["w"], p["o"]["w"], g_e["w"], d_e["w"],
            act=spec.act, norm=spec.norm_type, eps=float(spec.norm_eps),
            glu=glu, a8=mlp_a8, b_ln=p["ln2"].get("b"), b_o=p["o"].get("b"),
            b_g=None if glu else g_e.get("b"),
            b_d=None if glu else d_e.get("b"))
        return out, new_kv, captures
    if captures is not None:
        o_name = {"bloom": "self_attention.dense",
                  "opt": "self_attn.out_proj"}.get(spec.arch,
                                                   "self_attn.o_proj")
        captures[o_name] = attn
    h = residual + _row_linear(p["o"], attn, tp)
    if not spec.do_layer_norm_before:  # OPT-350m's post-norm
        h = norm_apply(spec, p["ln1"], h)
    m = norm_apply(spec, p["ln2"], h) if spec.do_layer_norm_before else h
    if "router" in p:
        if captures is not None:
            captures["moe.input"] = m  # gptq_quantize_experts calibration
        mlp_out = moe_ffn(spec, p, m, ep=ep,
                          activation=lambda g: activation(spec, g),
                          aux_out=moe_aux)
        return h + mlp_out, new_kv, captures
    if spec.arch in ("opt", "bloom"):
        bloom = spec.arch == "bloom"
        if captures is not None:
            captures["mlp.dense_h_to_4h" if bloom else "fc1"] = m
        inner = activation(spec, linear_apply(p["fc1"], m))
        if captures is not None:
            captures["mlp.dense_4h_to_h" if bloom else "fc2"] = inner
        out = h + _row_linear(p["fc2"], inner, tp)
        if not spec.do_layer_norm_before:
            out = norm_apply(spec, p["ln2"], out)
        return out, new_kv, captures
    ffn_a8 = _ffn_fusion_entry(p, captures, m.device, tp)
    if n_rows <= 32 and ffn_a8 is not None:
        # gate|up + act + down in one launch
        mlp_out = ffn_fused(m, p["gateup_fused"]["w"], p["down"]["w"],
                            act=spec.act, a8=ffn_a8)
        return h + mlp_out, new_kv, captures
    if "gateup_fused" in p:
        g, up = _apply_fused(p["gateup_fused"], m)
        gate = activation(spec, g)
    else:
        if captures is not None:
            captures["mlp.gate_proj"] = m
            captures["mlp.up_proj"] = m
        gate = activation(spec, linear_apply(p["gate"], m))
        up = linear_apply(p["up"], m)
    inner = gate * up
    if captures is not None:
        captures["mlp.down_proj"] = inner
    return h + _row_linear(p["down"], inner, tp), new_kv, captures


# ---------------------------------------------------------------------------
# embedding / head / model
# ---------------------------------------------------------------------------

def embed_forward(spec: ArchSpec, params: dict, input_ids: torch.Tensor,
                  positions=None) -> torch.Tensor:
    """Token embeddings: OPT's project_in and learned positions (offset 2,
    HF's OPTLearnedPositionalEmbedding; positions default to 0 .. T - 1),
    BLOOM's word-embedding layernorm, Gemma's scale in the embedding's
    dtype."""
    emb = params["embed"]["tokens"][input_ids]
    if spec.arch == "opt":
        if params["embed"].get("project_in") is not None:
            emb = linear_apply(params["embed"]["project_in"], emb)
        if positions is None:
            positions = torch.arange(input_ids.shape[-1],
                                     device=input_ids.device)
        emb = emb + params["embed"]["positions"][positions + 2]
    elif spec.arch == "bloom":
        emb = norm_apply(spec, params["embed"]["ln"], emb)
    elif spec.arch == "gemma":
        emb = emb * torch.tensor(spec.embed_scale, dtype=emb.dtype)
    return emb


def head_forward(spec: ArchSpec, params: dict, h: torch.Tensor,
                 tp: ShardGroup | None = None) -> torch.Tensor:
    """final_ln (+ OPT's project_out) and the head -> logits. A head that
    is the rank's vocab slice (ServeFlags.vocab_tp) gathers its logits
    over the tp group."""
    head_a8 = _head_fusion_ok(spec, params, h.numel() // h.shape[-1],
                              h.device, tp)
    if head_a8 is not None:
        # final_ln + packed lm_head in one launch
        lm = params["lm_head"]
        y = norm_qkv_fused(h, params["final_ln"]["w"], lm["w"],
                           norm=spec.norm_type, eps=float(spec.norm_eps),
                           a8=head_a8, b_ln=params["final_ln"].get("b"),
                           b_qkv=lm.get("b"))
        return y[..., :lm["w"].N]
    if params.get("final_ln") is not None:
        h = norm_apply(spec, params["final_ln"], h)
    if params["embed"].get("project_out") is not None:
        h = linear_apply(params["embed"]["project_out"], h)
    lm = params.get("lm_head")
    if lm is None:  # tied embeddings
        return _dense(h, params["embed"]["tokens"])
    logits = linear_apply(lm, h)
    flags = lm.get("serve")
    if tp is not None and flags is not None and flags.vocab_tp:
        logits = all_gather_last(logits, tp)
    return logits


def model_forward(spec: ArchSpec, params: dict, input_ids: torch.Tensor,
                  cache: KVCache | None = None,
                  moe_aux: list | None = None,
                  tp: ShardGroup | None = None,
                  ep: ShardGroup | None = None):
    """Full forward -> (logits (B, T, vocab), new cache or None).

    With a cache, appends T tokens at cache.length. Single-token decode
    (T == 1) attends the slots strictly below cache.length plus each
    layer's own fresh k/v, and writes all layers' fresh rows once after
    the last layer (quantized for an int8 cache), in place. With layer
    fusion on (GPTQ_TPU_LAYER_FUSION) decode keeps the write-first path,
    as in the JAX package: the whole-layer kernel writes its own rows.
    A tensor cache.length stays on the device at T == 1 (a prompt reads
    it on the host). A (B,) cache.length holds one length per slot
    (engine/batching.py's lock-step): each row appends at its own length,
    and decode takes the deferred write whatever the layer route says.
    `moe_aux`, a list, collects each MoE layer's load-balancing loss.
    Alibi (BLOOM) adds its bias to the mask on every path, the deferred
    decode's too (which then masks the slots at and past the length).
    `tp` / `ep` (ShardGroups): params are the rank's local view
    (parallel/tp.py, parallel/ep.py) and the cache holds the rank's kv
    heads; the logits come out whole on every rank."""
    B, T = input_ids.shape
    dev = input_ids.device
    start = 0 if cache is None else cache.length
    per_slot = getattr(start, "ndim", 0) == 1
    defer = cache is not None and T == 1 and (per_slot
                                              or not _layer_fusion_impl())
    if isinstance(start, torch.Tensor) and T > 1 and not per_slot:
        start = int(start)
    if per_slot:
        positions = (start.to(device=dev, dtype=torch.int64)[:, None]
                     + torch.arange(T, device=dev))
    else:
        positions = (start + torch.arange(T, device=dev)).expand(B, T)
    alibi = spec.pos == "alibi"
    if cache is None:
        mask = build_mask(spec, T, T, dev, tp)
    elif defer and not alibi:
        mask = None  # decode_attention masks by length itself
    else:
        S = cache.k.shape[2]
        k_pos = torch.arange(S, device=dev)
        q_pos = positions[:, :, None] if per_slot else positions[0, :, None]
        # the deferred decode masks the slots strictly below the length
        valid = k_pos < q_pos if defer else k_pos <= q_pos
        mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
        mask = mask[:, None] if per_slot else mask[None, None]
        if alibi:
            bias = alibi_bias(spec, q_pos, k_pos, tp)
            mask = mask + torch.where(valid.unsqueeze(-3), bias, 0.0)

    h = embed_forward(spec, params, input_ids, positions)
    rope = rope_tables(spec, positions) if spec.pos == "rope" else None
    fresh = []
    for i, bp in enumerate(params["layers"]):
        layer_cache = None
        if cache is not None:
            layer_cache = (cache.k[i], cache.v[i],
                           None if cache.k_scale is None else cache.k_scale[i],
                           None if cache.v_scale is None else cache.v_scale[i])
        h, new_kv, _ = block_forward(
            spec, bp, h, positions=positions, mask=mask, cache=layer_cache,
            cache_len=start if cache is not None else None, rope=rope,
            defer_write=defer,
            full_cache=((cache.k, cache.v, cache.k_scale, cache.v_scale, i)
                        if cache is not None and T == 1 else None),
            moe_aux=moe_aux, tp=tp, ep=ep)
        if defer:
            fresh.append(new_kv)
    if defer:
        fk = torch.stack([f[0] for f in fresh])  # (L, B, 1, kvh, hd)
        fv = torch.stack([f[1] for f in fresh])
        if cache.k_scale is not None:
            kq, ksn = _quantize_kv(fk)
            vq, vsn = _quantize_kv(fv)
            writes = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ksn),
                      (cache.v_scale, vsn))
        else:
            writes = ((cache.k, fk), (cache.v, fv))
        for buf, rows in writes:
            _write_slots(buf, rows, start, 2)
    logits = head_forward(spec, params, h, tp)
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, length=start + T,
                            k_scale=cache.k_scale, v_scale=cache.v_scale)
    return logits, new_cache


# ---------------------------------------------------------------------------
# random init (tests / the chip smoke run)
# ---------------------------------------------------------------------------

def init_params(spec: ArchSpec, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random params with the structure of converted HF weights (the JAX
    package's init_params per family), drawn from a torch.Generator seeded
    with `seed` on `device`. With spec.n_experts (llama / Gemma only) every
    layer carries a router and expert stacks (models/moe.init_moe_params)
    in place of gate / up / down."""
    if spec.n_experts and spec.arch not in ("llama", "gemma"):
        raise ValueError(
            f"n_experts={spec.n_experts} is only supported for the "
            f"llama / gemma (GLU-FFN) families, not arch={spec.arch!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, f = spec.hidden, spec.ffn

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def lin(out_d, in_d):
        return {"w": randn(out_d, in_d) * (0.4 / math.sqrt(in_d)),
                "b": (torch.zeros(out_d, dtype=dtype, device=device)
                      if spec.linear_bias else None)}

    def norm_p():
        if spec.norm_type == "layernorm":
            return {"w": torch.ones(h, dtype=dtype, device=device),
                    "b": torch.zeros(h, dtype=dtype, device=device)}
        fill = torch.ones if spec.norm_type == "rmsnorm" else torch.zeros
        return {"w": fill(h, dtype=dtype, device=device)}

    qd = spec.n_heads * spec.hd
    kvd = spec.kv_heads * spec.hd
    layers = []
    for _ in range(spec.n_layers):
        lp = {"ln1": norm_p(), "ln2": norm_p()}
        if spec.arch == "bloom":
            lp.update(qkv=lin(3 * h, h), o=lin(h, h), fc1=lin(f, h),
                      fc2=lin(h, f))
        else:
            lp.update(q=lin(qd, h), k=lin(kvd, h), v=lin(kvd, h),
                      o=lin(h, qd))
            if spec.arch == "opt":
                lp.update(fc1=lin(f, h), fc2=lin(h, f))
            elif spec.n_experts:
                lp.update(init_moe_params(spec, gen, dtype, device))
            else:
                lp.update(gate=lin(f, h), up=lin(f, h), down=lin(h, f))
        layers.append(lp)
    embed = {"tokens": randn(spec.vocab, h) * 0.02}
    if spec.arch == "opt":
        embed.update(positions=randn(spec.max_pos + 2, h) * 0.02,
                     project_in=None, project_out=None)
    elif spec.arch == "bloom":
        embed["ln"] = norm_p()
    params = {"embed": embed, "layers": layers, "final_ln": norm_p()}
    params["lm_head"] = (None if spec.tie_embeddings else
                         {"w": randn(spec.vocab, h) * 0.02, "b": None})
    return params
