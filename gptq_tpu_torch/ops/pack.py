"""Bit-packing of quantized weights into int32 words (port of the
uniform-grid, expert-bank and BCQ parts of gptq_tpu/ops/pack.py).

The layout is the JAX package's byteplane-subblock order, bit for bit, so
checkpoints interchange:

  * a b-bit code splits into power-of-two fields (3 = 2+1 bits);
  * each field of width fb packs P = 32/fb K rows per int32 word; within
    a subblock of SB = subblock(K, groupsize) rows (Wsb = SB/P words,
    E = 8/fb sub-byte planes) row

        SB*s + e*(4*Wsb) + 4*j + b     (e < E, j < Wsb, b < 4 bytes)

    lives in word s*Wsb + j at bit 8*b + fb*e;
  * the 8-bit field stores code-128 (byte ^ 0x80).

Codes are stored transposed as (K, N) = (in_features, out_features), so
serving computes y = x @ dequant(codes).

torch has no uint32 arithmetic: words are built in int64 (the fields do
not overlap, so a sum is an OR), the low 32 bits kept, and values >= 2^31
mapped to the int32 with the same bit pattern.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

# bits -> list of (field_bits, shift_in_code); fields sum to `bits`
FIELD_SPLITS = {
    1: [(1, 0)],
    2: [(2, 0)],
    3: [(2, 0), (1, 2)],
    4: [(4, 0)],
    8: [(8, 0)],
}


def subblock(K: int, groupsize: int = -1) -> int:
    """Byteplane subblock length: the largest power of two <= 512 dividing
    K (and the groupsize, down to 32 rows)."""
    sb = 512
    while K % sb:
        sb //= 2
    if groupsize > 0:
        while groupsize % sb and sb > 32:
            sb //= 2
    return sb


def _to_int32_bits(word: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    word = word & 0xFFFFFFFF
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def pack_codes(codes: torch.Tensor, bits: int,
               groupsize: int = -1) -> tuple[torch.Tensor, ...]:
    """Pack unsigned codes (K, N) in [0, 2^bits) into byteplane int32 words.

    Returns one (K // P_f, N) int32 tensor per field. K must be a
    multiple of 32."""
    K, N = codes.shape
    if K % 32:
        raise ValueError(f"K={K} must be a multiple of 32 for packing")
    SB = subblock(K, groupsize)
    codes = codes.to(torch.int64)
    dev = codes.device
    words = []
    for fb, sh in FIELD_SPLITS[bits]:
        P = 32 // fb
        Wsb = SB // P
        E = 8 // fb
        part = (codes >> sh) & ((1 << fb) - 1)
        if fb == 8:
            part = part ^ 0x80  # store code-128 for int8 reinterpretation
        part = part.reshape(K // SB, E, Wsb, 4, N)
        e_sh = (fb * torch.arange(E, device=dev)).reshape(1, E, 1, 1, 1)
        b_sh = (8 * torch.arange(4, device=dev)).reshape(1, 1, 1, 4, 1)
        word = (part << (e_sh + b_sh)).sum(dim=(1, 3))
        words.append(_to_int32_bits(word.reshape(K // P, N)))
    return tuple(words)


def unpack_field(w: torch.Tensor, fb: int, K: int,
                 groupsize: int = -1) -> torch.Tensor:
    """One field's words (K // P, N) -> (K, N) int64 sub-codes."""
    P = 32 // fb
    SB = subblock(K, groupsize)
    Wsb = SB // P
    E = 8 // fb
    N = w.shape[-1]
    dev = w.device
    wu = (w.to(torch.int64) & 0xFFFFFFFF).reshape(K // SB, 1, Wsb, 1, N)
    e_sh = (fb * torch.arange(E, device=dev)).reshape(1, E, 1, 1, 1)
    b_sh = (8 * torch.arange(4, device=dev)).reshape(1, 1, 1, 4, 1)
    part = (wu >> (e_sh + b_sh)) & ((1 << fb) - 1)  # (K/SB, E, Wsb, 4, N)
    part = part.reshape(K, N)
    if fb == 8:
        part = part ^ 0x80
    return part


def unpack_codes(words: tuple[torch.Tensor, ...], bits: int,
                 groupsize: int = -1) -> torch.Tensor:
    """Inverse of pack_codes -> (K, N) int32 codes."""
    out = None
    for (fb, sh), w in zip(FIELD_SPLITS[bits], words):
        K = w.shape[0] * (32 // fb)
        part = unpack_field(w, fb, K, groupsize) << sh
        out = part if out is None else out + part
    return out.to(torch.int32)


@dataclass
class PackedWeight:
    """A served quantized linear: y = x @ dequant() + bias.

    fmt="uniform" (uniform grids):
      words  — tuple of blocked int32 field tensors, K-major
      scale  — (num_groups, Np) f32
      zoff   — (num_groups, Np) f32, scale*zero so dequant = scale*q - zoff
    fmt="bcq" (binary coding, served by ops/bcq_matmul.py):
      words  — one (bits, Kp//32, Np) int32 tensor: a 1-bit byteplane
               field per sign plane (+1 -> bit set)
      alpha  — (num_groups, bits, Np) f32
    Both:
      bias   — (N,) or None
      perm   — (K,) int32 activation permutation for act-order, or None

    K/N are the LOGICAL dims; stored tensors may be zero-padded (pad_dim),
    with zero pad scales / alphas so padded rows/columns contribute
    exactly 0."""

    words: tuple
    scale: Optional[torch.Tensor] = None
    zoff: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None
    bits: int = 4
    K: int = 0
    N: int = 0
    groupsize: int = -1
    fmt: str = field(default="uniform")

    @property
    def Kp(self) -> int:
        """Stored (padded) K."""
        w = self.words[0]
        if self.fmt == "bcq":
            return w.shape[1] * 32
        fb = FIELD_SPLITS[self.bits][0][0]
        return w.shape[-2] * (32 // fb)

    @property
    def Np(self) -> int:
        """Stored (padded) N."""
        return self.words[0].shape[-1]

    def to(self, device) -> "PackedWeight":
        def mv(t):
            return None if t is None else t.to(device)

        return PackedWeight(
            words=tuple(w.to(device) for w in self.words),
            scale=mv(self.scale), zoff=mv(self.zoff), alpha=mv(self.alpha),
            bias=mv(self.bias), perm=mv(self.perm), bits=self.bits, K=self.K,
            N=self.N, groupsize=self.groupsize, fmt=self.fmt)


def pad_dim(dim: int, groupsize: int = -1, unit: int = 512) -> int:
    """Round `dim` up to the next multiple of lcm(unit, groupsize); no-op
    when it already divides or the padding would exceed 12.5%."""
    u = unit
    if groupsize > 0:
        u = unit * groupsize // math.gcd(unit, groupsize)
    if dim % u == 0:
        return dim
    padded = ((dim + u - 1) // u) * u
    if (padded - dim) * 8 > dim:  # >12.5% waste: keep the natural size
        return dim
    return padded


def quantize_to_codes(W: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes (K, N) from a quantize-dequantized weight W (N, K)
    and its (num_groups, N) grids. torch.round rounds half to even, as
    jnp.round does."""
    _, K = W.shape
    ng = scale.shape[0]
    g = K // ng
    Wt = W.to(torch.float32).T  # (K, N)
    s = torch.repeat_interleave(scale.to(torch.float32), g, dim=0)
    z = torch.repeat_interleave(zero.to(torch.float32), g, dim=0)
    return torch.clamp(torch.round(Wt / s + z), 0,
                       (1 << bits) - 1).to(torch.int32)


def pack_quantized(
    Q: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    bits: int,
    groupsize: int = -1,
    bias: torch.Tensor | None = None,
    perm: torch.Tensor | None = None,
    actorder: bool = False,
    tp: int = 1,
) -> PackedWeight:
    """Pack a GPTQ-quantized weight for serving.

    Q: (N, K) dequantized weight (original column order); scale/zero:
    (num_groups, N) solver grids. With actorder and groupsize > 0, K is
    stored in permuted order and serving gathers x[:, perm]. `tp` pads
    the stored dims in units of 512 * tp, so that 1/tp shards start on
    subblock boundaries (parallel/tp.py)."""
    Nn, K = Q.shape
    if actorder and perm is not None and groupsize > 0:
        Qp = Q[:, perm.long()]
        store_perm = perm.to(torch.int32)
    else:
        Qp = Q
        store_perm = None
    codes = quantize_to_codes(Qp, scale, zero, bits)
    scale = scale.to(torch.float32)
    zoff = (scale * zero).to(torch.float32)
    unit = 512 * max(1, tp)
    Kp, Np = pad_dim(K, groupsize, unit), pad_dim(Nn, -1, unit)
    if (Kp, Np) != (K, Nn):
        codes = torch.nn.functional.pad(codes, (0, Np - Nn, 0, Kp - K))
        ng_p = Kp // groupsize if groupsize > 0 else 1
        scale = torch.nn.functional.pad(
            scale, (0, Np - Nn, 0, ng_p - scale.shape[0]))
        zoff = torch.nn.functional.pad(
            zoff, (0, Np - Nn, 0, ng_p - zoff.shape[0]))
    words = pack_codes(codes, bits, groupsize)
    return PackedWeight(words=words, scale=scale.contiguous(),
                        zoff=zoff.contiguous(), bias=bias, perm=store_perm,
                        bits=bits, K=K, N=Nn, groupsize=groupsize,
                        fmt="uniform")


def fuse_packed(pws: list, tp: int = 1) -> Optional[PackedWeight]:
    """Concatenate PackedWeights sharing one input (q/k/v, gate/up) along N
    into one wider weight: one kernel launch instead of several. The fused
    N is the total STORED width (each part's pad columns compute exact
    zeros). Returns None when the parts are not fusable.

    tp > 1 builds the shard-interleaved layout of tensor parallelism: N
    runs [p0 shard 0, p1 shard 0, ..., p0 shard 1, ...], so that the tp
    equal slices of the fused N are each the standard fused weight of one
    rank's column shards (part widths Np_i / tp)."""
    p0 = pws[0]
    for pw in pws:
        if (pw.fmt != p0.fmt or pw.bits != p0.bits or pw.Kp != p0.Kp
                or pw.K != p0.K or pw.groupsize != p0.groupsize):
            return None
        if pw.bias is not None:
            return None  # a bias baked into a part would vanish in the fusion
        if (pw.perm is None) != (p0.perm is None):
            return None
        if pw.perm is not None and not torch.equal(pw.perm, p0.perm):
            return None
        if tp > 1 and pw.Np % tp:
            return None

    def cat(ts):
        if tp == 1:
            return torch.cat(ts, dim=-1)
        chunks = [t.chunk(tp, dim=-1) for t in ts]
        return torch.cat([ch[s] for s in range(tp) for ch in chunks], dim=-1)

    if p0.fmt == "bcq":
        words = (cat([pw.words[0] for pw in pws]),)
        alpha = cat([pw.alpha for pw in pws])
        scale = zoff = None
    else:
        words = tuple(cat(list(ws)) for ws in zip(*[pw.words for pw in pws]))
        scale = cat([pw.scale for pw in pws])
        zoff = cat([pw.zoff for pw in pws])
        alpha = None
    return PackedWeight(
        words=words, scale=scale, zoff=zoff, alpha=alpha, bias=None,
        perm=p0.perm, bits=p0.bits, K=p0.K, N=sum(pw.Np for pw in pws),
        groupsize=p0.groupsize, fmt=p0.fmt)


@dataclass
class PackedExperts:
    """A stacked bank of E uniform-grid packed weights sharing one format:
    the sub-byte serving layout of an MoE layer's expert stacks
    (models/moe.py).

      words — tuple of (E, Kp // P, Np) int32 field tensors (each expert's
              pack_codes planes, stacked on a leading expert dim)
      scale — (E, ng, Np) f32 per-(expert, group) grids
      zoff  — (E, ng, Np) f32, scale*zero

    E derives from the tensors. K/N are the logical (in, out) dims of one
    expert; stored dims may be padded like PackedWeight's, with zero pad
    grids."""

    words: tuple
    scale: torch.Tensor
    zoff: torch.Tensor
    bits: int = 4
    K: int = 0
    N: int = 0
    groupsize: int = -1

    @property
    def E(self) -> int:
        return self.words[0].shape[0]

    @property
    def Kp(self) -> int:
        fb = FIELD_SPLITS[self.bits][0][0]
        return self.words[0].shape[-2] * (32 // fb)

    @property
    def Np(self) -> int:
        return self.words[0].shape[-1]

    def expert(self, e) -> PackedWeight:
        """Expert e's weight as a PackedWeight view (e: an int, or a 0-d
        integer tensor on the bank's device, which indexes without a host
        sync: index_select, where plain indexing would read it on the
        host)."""
        if isinstance(e, torch.Tensor):
            idx = e.reshape(1).to(torch.long)

            def pick(t):
                return t.index_select(0, idx)[0]
        else:
            def pick(t):
                return t[e]
        return PackedWeight(
            words=tuple(pick(w) for w in self.words), scale=pick(self.scale),
            zoff=pick(self.zoff), bits=self.bits, K=self.K, N=self.N,
            groupsize=self.groupsize, fmt="uniform")

    def to(self, device) -> "PackedExperts":
        return PackedExperts(
            words=tuple(w.to(device) for w in self.words),
            scale=self.scale.to(device), zoff=self.zoff.to(device),
            bits=self.bits, K=self.K, N=self.N, groupsize=self.groupsize)


def pack_expert_stack(W: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, bits: int,
                      groupsize: int = -1) -> PackedExperts:
    """Pack an (E, N, K) expert weight stack for serving.

    W: per-expert (out, in) quantize-dequantized weights; scale/zero:
    (E, num_groups, N) grids. Every expert packs with pack_codes, padded
    like pack_quantized and then to a multiple of 32 rows (pad rows store
    code 0, met by zero x pad rows at run time)."""
    E, Nn, K = W.shape
    ng = scale.shape[1]
    codes = torch.stack([quantize_to_codes(W[e], scale[e], zero[e], bits)
                         for e in range(E)])  # (E, K, N)
    scale = scale.to(torch.float32)
    zoff = (scale * zero).to(torch.float32)
    Kp, Np = pad_dim(K, groupsize, 512), pad_dim(Nn, -1, 512)
    if Kp % 32:
        Kp = -(-Kp // 32) * 32
    if (Kp, Np) != (K, Nn):
        codes = torch.nn.functional.pad(codes, (0, Np - Nn, 0, Kp - K))
        ng_p = Kp // groupsize if groupsize > 0 else 1
        scale = torch.nn.functional.pad(scale, (0, Np - Nn, 0, ng_p - ng))
        zoff = torch.nn.functional.pad(zoff, (0, Np - Nn, 0, ng_p - ng))
    per = [pack_codes(codes[e], bits, groupsize) for e in range(E)]
    words = tuple(torch.stack(ws) for ws in zip(*per))
    return PackedExperts(words=words, scale=scale.contiguous(),
                         zoff=zoff.contiguous(), bits=bits, K=K, N=Nn,
                         groupsize=groupsize)


def pack_bcq(B: torch.Tensor, alpha: torch.Tensor,
             bias: torch.Tensor | None = None,
             groupsize: int = -1, tp: int = 1) -> PackedWeight:
    """Pack BCQ signs for serving.

    B: (N, num_groups, g, bits) in {-1, +1}; alpha: (N, num_groups, bits).
    Stored as (bits, Kp//32, Np) sign bitplanes (+1 -> bit set), each a
    1-bit byteplane field of pack_codes, and alpha (num_groups, bits, Np)
    f32, both zero-padded like pack_quantized pads (for `tp` as there)."""
    Nn, ng, g, bits = B.shape
    K = ng * g
    signs = (B.reshape(Nn, K, bits) > 0).to(torch.int32)
    signs = signs.permute(2, 1, 0)  # (bits, K, N)
    gsz = g if groupsize != -1 else -1
    alpha_t = alpha.to(torch.float32).permute(1, 2, 0)  # (ng, bits, N)
    unit = 512 * max(1, tp)
    Kp, Np = pad_dim(K, gsz, unit), pad_dim(Nn, -1, unit)
    if (Kp, Np) != (K, Nn):
        signs = torch.nn.functional.pad(signs, (0, Np - Nn, 0, Kp - K))
        ng_p = Kp // gsz if gsz > 0 else 1
        alpha_t = torch.nn.functional.pad(
            alpha_t, (0, Np - Nn, 0, 0, 0, ng_p - alpha_t.shape[0]))
    words = torch.stack([pack_codes(signs[b], 1, gsz)[0]
                         for b in range(bits)])  # (bits, Kp//32, Np)
    return PackedWeight(words=(words,), alpha=alpha_t.contiguous(), bias=bias,
                        bits=bits, K=K, N=Nn, groupsize=gsz, fmt="bcq")
