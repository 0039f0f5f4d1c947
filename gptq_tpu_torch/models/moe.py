"""Mixture-of-experts FFN: Mixtral-style routed GLU experts (port of
gptq_tpu/models/moe.py).

Routing is the JAX package's: softmax over the router logits, the top k
taken with ties to the lower expert index (a stable descending sort:
`torch.topk` promises no order on ties, `jax.lax.top_k` puts the lower
index first), the k probabilities renormalized to 1. Two paths, chosen
from the spec's capacity:

* capacity-bound (C < N): the GShard dispatch / combine einsums, each
  expert taking at most C token slots, every token's first choice placed
  before any token's second choice;
* dropless (C >= N, what a converted HF Mixtral spec gets:
  capacity = E / k): each expert's GLU over all N tokens weighted by its
  routing column, one expert at a time.

Expert stacks serve dense, as int8 RTN codes with per-row scales
(quantize_experts), or as sub-byte PackedExperts banks (pack_experts),
which take the dropless path only and run, as in the JAX package:
  * N == 1 with top_k < E: per selection and projection one launch of the
    select kernel (#9, ops/qmatmul.expert_dequant_matmul_select); the
    expert index stays on the device;
  * 1 < N <= 32: one batched launch per projection over the whole bank
    (#8, expert_dequant_matmul);
  * N > 32: per expert and projection one dequant_matmul (#1's M > 1
    kernel).
`gptq_quantize_experts` quantizes the expert stacks with GPTQ from each
expert's routed tokens.

Expert parallelism (`ep`, a models/common.ShardGroup; parallel/ep.py):
the expert stacks are the rank's E / ep slice, experts ep_rank * E / ep
onwards; the router stays whole and runs over all tokens on every rank;
the rank keeps its experts' routing columns (dropless) or its slice of
the dispatch / combine tensors, runs its local bank, and the partial
outputs sum over the ep group (one all_reduce of the f32 output). At
N == 1 the select kernel takes the top k of the rank's local weights,
so a selection of an expert that lives on another rank has weight 0
and adds an exact 0.
"""

from __future__ import annotations

import math
import time

import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.ops.pack import PackedExperts, pack_expert_stack
from gptq_tpu_torch.ops.qmatmul import (dequant_matmul,
                                        expert_dequant_matmul,
                                        expert_dequant_matmul_select,
                                        matmul_impl)


def expert_capacity(spec, n_tokens: int) -> int:
    """Static per-expert token slots for a batch of n_tokens rows."""
    c = int(-(-spec.expert_top_k * n_tokens * spec.expert_capacity
              // spec.n_experts))
    return max(1, min(c, n_tokens))


def select_top_k(v: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim, ties
    to the lower index (as jax.lax.top_k). No host sync."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of int indices in [0, n), built by a scatter
    (F.one_hot checks its range on the host)."""
    out = torch.zeros((*idx.shape, n), dtype=torch.float32, device=idx.device)
    return out.scatter_(-1, idx.long()[..., None], 1.0)


def _probs(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    logits = x.to(torch.float32) @ router_w.to(torch.float32).T  # (N, E)
    return torch.softmax(logits, dim=-1)


def _aux(E: int, onehot: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer load-balancing loss E * sum_e f_e * P_e (f_e: the
    share of tokens whose first choice is e; P_e: e's mean probability)."""
    return E * torch.sum(onehot[:, 0].mean(dim=0) * probs.mean(dim=0))


def route(spec, router_w: torch.Tensor, x: torch.Tensor, aux: bool = True):
    """(dispatch, combine, aux) for x of shape (N, D).

    dispatch: (N, E, C) 0/1, token n in slot c of expert e; combine: (N, E,
    C) f32, dispatch times the renormalized top-k probability, 0 for a
    dropped assignment; aux: the load-balancing loss, None unless asked
    for (its kernels run only then)."""
    N = x.shape[0]
    E, k = spec.n_experts, spec.expert_top_k
    C = expert_capacity(spec, N)
    probs = _probs(router_w, x)
    topv, topi = select_top_k(probs, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    onehot = _one_hot(topi, E)  # (N, k, E)
    # slot-major order: every token's first choice before any second
    flat = onehot.transpose(0, 1).reshape(k * N, E)
    pos = torch.cumsum(flat, dim=0) - flat  # position within the expert
    kept = flat * (pos < C)
    # a position past C is dropped (kept = 0): clamping it is harmless
    slot = _one_hot(pos.to(torch.int64).clamp(max=C - 1), C)
    dc = (kept[..., None] * slot).reshape(k, N, E, C)
    dispatch = dc.sum(dim=0)
    combine = (dc * topv.T[..., None, None]).sum(dim=0)
    return dispatch, combine, _aux(E, onehot, probs) if aux else None


def route_weights(spec, router_w: torch.Tensor, x: torch.Tensor,
                  aux: bool = True):
    """(w, aux) for the dropless path: w (N, E) holds each token's
    renormalized top-k probability at its selected experts, 0 elsewhere;
    aux as route's."""
    E, k = spec.n_experts, spec.expert_top_k
    probs = _probs(router_w, x)
    topv, topi = select_top_k(probs, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    onehot = _one_hot(topi, E)  # (N, k, E)
    w = torch.sum(onehot * topv[..., None], dim=1)
    return w, _aux(E, onehot, probs) if aux else None


def _f32mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 products and sums (the JAX einsums'
    preferred_element_type=f32 on bf16 or f32 operands)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def moe_ffn(spec, p: dict, x: torch.Tensor, ep=None, activation=None,
            aux_out: list | None = None) -> torch.Tensor:
    """Routed GLU expert FFN of x (B, T, D) -> (B, T, D) in x's dtype.

    p: {"router": {"w": (E, D)}, "experts": {"gate": (E, F, D), "up":
    (E, F, D), "down": (E, D, F)}} dense, int8 codes with "<name>_scale"
    (E, rows) entries, or PackedExperts banks. `aux_out`, a list, collects
    this layer's load-balancing loss; without it the loss is not computed
    (XLA drops the unused loss from the JAX package's graph). `ep`, a
    ShardGroup: the stacks are this rank's expert slice (module doc)."""
    from gptq_tpu_torch.models.common import all_reduce_sum

    B, T, D = x.shape
    N = B * T
    xt = x.reshape(N, D)
    ex = p["experts"]
    cdt = x.dtype
    act = activation if activation is not None else torch.nn.functional.silu
    dropless = expert_capacity(spec, N) >= N
    want_aux = aux_out is not None
    if dropless:
        w, aux = route_weights(spec, p["router"]["w"], xt, aux=want_aux)
    else:
        dispatch, combine, aux = route(spec, p["router"]["w"], xt,
                                       aux=want_aux)
    if aux_out is not None:
        aux_out.append(aux)
    sharded = ep is not None and ep.size > 1
    el = spec.n_experts // ep.size if sharded else spec.n_experts
    if sharded:
        e0 = ep.rank * el
        if dropless:
            w = w[:, e0:e0 + el]
        else:
            dispatch = dispatch[:, e0:e0 + el]
            combine = combine[:, e0:e0 + el]

    if isinstance(ex["gate"], PackedExperts):
        if not dropless:
            raise ValueError(
                "packed expert banks serve the dropless path (C >= N); "
                "capacity-bound GShard routing is a training regime — "
                "keep dense/int8 stacks there")
        y = _packed_expert_ffn(ex, xt, w, act, top_k=spec.expert_top_k)
        if sharded:
            y = all_reduce_sum(y, ep)
        return y.reshape(B, T, D).to(x.dtype)

    # int8 RTN stacks dequantize in the activations' dtype, as the JAX
    # package folds codes * scale into its einsums
    int8w = ex["gate"].dtype == torch.int8

    def ew(name, e=slice(None)):
        v = ex[name][e]
        if int8w:
            return v.to(cdt) * ex[name + "_scale"][e][..., None].to(cdt)
        return v

    if dropless:
        # one expert at a time: an (N, F) intermediate, not (E, N, F)
        y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
        for e in range(el):
            g = _f32mm(xt, ew("gate", e).T)
            u = _f32mm(xt, ew("up", e).T)
            inner = act(g) * u
            ye = _f32mm(inner.to(cdt), ew("down", e).T)
            y = y + w[:, e:e + 1] * ye
    else:
        xe = torch.einsum("nec,nd->ecd", dispatch.to(cdt).to(torch.float32),
                          xt.to(torch.float32)).to(cdt)
        g = _f32mm(xe, ew("gate").transpose(1, 2))  # (E, C, F)
        u = _f32mm(xe, ew("up").transpose(1, 2))
        inner = act(g) * u
        ye = _f32mm(inner.to(cdt), ew("down").transpose(1, 2))  # (E, C, D)
        y = torch.einsum("nec,ecd->nd", combine, ye)
    if sharded:
        y = all_reduce_sum(y, ep)
    return y.reshape(B, T, D).to(x.dtype)


def _packed_expert_ffn(ex: dict, xt: torch.Tensor, w: torch.Tensor, act,
                       top_k: int = 0) -> torch.Tensor:
    """Dropless routed GLU over PackedExperts banks: xt (N, D), w (N, E)
    routing weights -> (N, D) f32 (the three regimes of the module doc)."""
    gate_pe, up_pe, down_pe = ex["gate"], ex["up"], ex["down"]
    el = gate_pe.E
    N = xt.shape[0]
    cdt = xt.dtype
    if N == 1 and 0 < top_k < el:
        kernel_sel = matmul_impl() in ("pallas", "streamed")
        wv, wi = select_top_k(w[0], top_k)
        wi = wi.to(torch.int32)  # stays on the device: no host sync

        def mm(xx, pe, j):
            e = wi[j:j + 1]
            if kernel_sel:
                return expert_dequant_matmul_select(xx, pe, e)
            return dequant_matmul(xx, pe.expert(e)).to(torch.float32)

        y = torch.zeros((1, down_pe.N), dtype=torch.float32, device=xt.device)
        for j in range(top_k):
            g = mm(xt, gate_pe, j)
            u = mm(xt, up_pe, j)
            ye = mm((act(g) * u).to(cdt), down_pe, j)
            y = y + wv[j] * ye
        return y
    if N <= 32:
        g = expert_dequant_matmul(xt, gate_pe)  # (E, N, F) f32
        u = expert_dequant_matmul(xt, up_pe)
        ye = expert_dequant_matmul((act(g) * u).to(cdt), down_pe)  # (E, N, D)
        return torch.einsum("ne,end->nd", w, ye)
    y = torch.zeros((N, down_pe.N), dtype=torch.float32, device=xt.device)
    for e in range(el):
        g = dequant_matmul(xt, gate_pe.expert(e)).to(torch.float32)
        u = dequant_matmul(xt, up_pe.expert(e)).to(torch.float32)
        ye = dequant_matmul((act(g) * u).to(cdt), down_pe.expert(e))
        y = y + w[:, e:e + 1] * ye.to(torch.float32)
    return y


# ---------------------------------------------------------------------------
# quantization of the expert stacks
# ---------------------------------------------------------------------------

def _rtn_expert_grids(W: torch.Tensor, bits: int, groupsize: int = -1):
    """Per-(expert, row[, group]) asymmetric min-max grids of an (E, F, D)
    stack, the range clamped to include 0. Returns scale / zero (E, ng,
    F)."""
    E, F, D = W.shape
    g = groupsize if groupsize > 0 else D
    ng = D // g
    maxq = (1 << bits) - 1
    Wg = W.reshape(E, F, ng, g)
    xmin = torch.clamp(Wg.amin(dim=-1), max=0.0)
    xmax = torch.clamp(Wg.amax(dim=-1), min=0.0)
    scale = (xmax - xmin) / maxq
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-xmin / scale)
    return scale.transpose(1, 2), zero.transpose(1, 2)


def pack_experts(params: dict, bits: int = 4, groupsize: int = -1) -> None:
    """In place: every MoE layer's dense expert stacks become PackedExperts
    banks. The grids come from gptq_quantize_experts(..., keep_grids=True)
    where it stashed them at these bits and groupsize (exact code
    recovery), else per-row RTN min-max grids refit on the dense values."""
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"bits={bits} not in (2, 3, 4, 8)")
    for bp in params["layers"]:
        ex = bp.get("experts")
        if ex is None or isinstance(ex.get("gate"), PackedExperts):
            continue
        if ex["gate"].dtype == torch.int8:
            raise ValueError(
                "expert stacks are already int8-compressed "
                "(quantize_experts); pack_experts needs the dense values "
                "— run it instead of, not after, the int8 compression")
        grids = ex.pop("_grids", None)
        grid_ok = (grids is not None and grids.get("bits") == bits
                   and grids.get("groupsize", -1) == groupsize)
        for name in ("gate", "up", "down"):
            W = ex[name].to(torch.float32)  # (E, out, in)
            if grid_ok and name in grids:
                s, z = grids[name]["scale"], grids[name]["zero"]
            else:
                s, z = _rtn_expert_grids(W, bits, groupsize)
            ex[name] = pack_expert_stack(W, s, z, bits, groupsize)


def init_moe_params(spec, gen: torch.Generator, dtype=torch.float32,
                    device="cuda") -> dict:
    """Router and stacked expert weights of one decoder layer, drawn from
    `gen` (on `device`: the card unless the caller names the CPU)."""
    device = resolve_device(device)
    E, D, F = spec.n_experts, spec.hidden, spec.ffn
    s = 0.4 / math.sqrt(D)
    sf = 0.4 / math.sqrt(F)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    return {
        "router": {"w": randn(E, D) * s},
        "experts": {"gate": randn(E, F, D) * s, "up": randn(E, F, D) * s,
                    "down": randn(E, D, F) * sf},
    }


def quantize_experts(params: dict, bits: int = 8) -> None:
    """In place: RTN int8 codes with per-(expert, row) symmetric scales
    ("gate" -> "gate" int8 + "gate_scale"), which moe_ffn dequantizes in
    its products. bits < 8 narrows the grid inside the int8 container."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits={bits} not in [2, 8]")
    qmax = float(2 ** (bits - 1) - 1)
    for bp in params["layers"]:
        ex = bp.get("experts")
        if ex is None:
            continue
        for name in ("gate", "up", "down"):
            w = ex[name]
            if w.dtype == torch.int8:
                continue
            wf = w.to(torch.float32)
            s = torch.clamp(wf.abs().amax(dim=-1) / qmax, min=1e-12)
            q = torch.clamp(torch.round(wf / s[..., None]), -qmax, qmax)
            ex[name] = q.to(torch.int8)
            ex[name + "_scale"] = s


@torch.no_grad()
def gptq_quantize_experts(spec, params: dict, calib_ids: torch.Tensor, cfg,
                          log=lambda s: None,
                          keep_grids: bool = False) -> dict:
    """GPTQ of every MoE layer's expert stacks, in place (fake-quantized
    dense values, as pipeline.quantize_model writes them). Run it after
    quantize_model, so the experts' Hessians see the quantized attention.

    Each expert's gate / up Hessian comes from the token slots routed to
    it (route()'s dispatch), its down Hessian from the GLU computed with
    the already-quantized gate / up; each layer's output is then
    re-propagated through the quantized layer. With keep_grids the solver
    grids are stashed under experts["_grids"] for pack_experts (uniform
    mode, and act-order only with whole-row groups). Returns
    {"layer.{i}.expert{e}.{proj}": loss}."""
    from gptq_tpu_torch.models.common import (activation, block_forward,
                                              build_mask, embed_forward,
                                              rope_tables)
    from gptq_tpu_torch.pipeline import solver_config_for
    from gptq_tpu_torch.quant.gptq import (gptq_quantize, hessian_init,
                                           hessian_update)

    nsamples, T = calib_ids.shape
    dev = calib_ids.device
    positions = torch.arange(T, device=dev)[None]
    mask = build_mask(spec, T, T, dev)
    rope = rope_tables(spec, positions)
    scfg = solver_config_for(cfg, cfg.wbits)
    E = spec.n_experts
    inps = torch.stack([embed_forward(spec, params, calib_ids[j:j + 1])[0]
                        for j in range(nsamples)])

    def layer_pass(bp, inps):
        """Every sample through one layer: (outputs, the MoE FFN inputs;
        a dense layer's inputs stand in for the latter)."""
        outs, ms = [], []
        for j in range(inps.shape[0]):
            out, _, caps = block_forward(spec, bp, inps[j:j + 1],
                                         positions=positions, mask=mask,
                                         rope=rope, capture=True)
            m = caps.get("moe.input")
            outs.append(out[0])
            ms.append(inps[j] if m is None else m[0])
        return torch.stack(outs), torch.stack(ms)

    def dispatched(router_w, m):
        """(E, C, D) f32 token slots of each expert for one sample."""
        dispatch, _, _ = route(spec, router_w, m, aux=False)
        return torch.einsum("nec,nd->ecd", dispatch, m.to(torch.float32))

    def solve(ex, name, e, states, li, grids):
        H, _, mean = states[e]
        r = gptq_quantize(ex[name][e].to(torch.float32), H, scfg,
                          mean_input=mean)
        ex[name][e] = r["Q"].to(ex[name].dtype)
        losses[f"layer.{li}.expert{e}.{name}"] = float(r["loss"])
        if grids is not None:
            gd = grids.setdefault(name, {"scale": [], "zero": []})
            gd["scale"].append(r["scale"])
            gd["zero"].append(r["zero"])

    stash = keep_grids and scfg.mode == "uniform" and (
        not scfg.actorder or scfg.groupsize <= 0)
    if keep_grids and not stash:
        log("expert grids not stashed (non-uniform mode or act-order "
            "groups); pack_experts will refit RTN grids")
    losses: dict[str, float] = {}
    for li, bp in enumerate(params["layers"]):
        ex = bp.get("experts")
        if ex is None:
            inps, _ = layer_pass(bp, inps)
            continue
        t0 = time.time()
        _, ms = layer_pass(bp, inps)  # (nsamples, T, D) FFN inputs
        router_w = bp["router"]["w"]
        D = ms.shape[-1]
        hg = [hessian_init(D, device=dev) for _ in range(E)]
        for m in ms:
            xe = dispatched(router_w, m)
            hg = [hessian_update(hg[e], xe[e]) for e in range(E)]
        grids = {"bits": scfg.bits, "groupsize": scfg.groupsize} \
            if stash else None
        for e in range(E):
            for name in ("gate", "up"):
                solve(ex, name, e, hg, li, grids)
        del hg
        # down's Hessian from the GLU inner computed with the QUANTIZED
        # gate / up (true-sequential order)
        F = ex["up"].shape[1]
        hd = [hessian_init(F, device=dev) for _ in range(E)]
        for m in ms:
            xe = dispatched(router_w, m)
            g = torch.einsum("ecd,efd->ecf", xe, ex["gate"].to(torch.float32))
            u = torch.einsum("ecd,efd->ecf", xe, ex["up"].to(torch.float32))
            inner = activation(spec, g) * u
            hd = [hessian_update(hd[e], inner[e]) for e in range(E)]
        for e in range(E):
            solve(ex, "down", e, hd, li, grids)
        del hd
        if grids is not None:
            ex["_grids"] = {k: (v if not isinstance(v, dict) else
                                {"scale": torch.stack(v["scale"]),
                                 "zero": torch.stack(v["zero"])})
                            for k, v in grids.items()}
        # re-propagate through the quantized layer
        inps, _ = layer_pass(bp, inps)
        log(f"layer {li}: {3 * E} expert projections quantized in "
            f"{time.time() - t0:.1f}s")
    return losses
