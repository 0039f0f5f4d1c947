"""Sharded serving engines (port of gptq_tpu/engine/serving.py).

SPEngine (tp = 1): long-context serving with the KV
cache sharded over the ranks of a torch.distributed process group for its
whole lifetime (parallel/sp.py: ring prefill, SPCache decode). The CLI
reaches it with `--sp N` under `torchrun --nproc-per-node N`.

The chained loop runs a chunk of decode steps as one CUDA graph on the
card, as engine/decode.DecodeEngine does, and eagerly on the CPU. The
graph reads and writes only storage that outlives it: the engine's cache
for the batch (its buffers and `pos` plane, which prefill fills in place),
the token the next chunk feeds, the cache length (a 0-dim int32 device
tensor), and a benchmark chain's ids and NLLs. The combine's
all_reduce calls are captured inside the graph. Capacity guards run on
the host once per chunk.

EPEngine: MoE serving with the expert stacks split over ep ranks
(parallel/ep.py), attention optionally tensor-parallel over an (ep, tp)
layout of the world; the CLI's `--ep N [--tp M]` under torchrun with
N * M processes. Its chained benchmark runs engine/decode's chained loop,
as one CUDA graph a chain where the groups are NCCL's and eagerly on
the card where they are gloo's (ranks sharing one card).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.engine.decode import DecodeEngine, chained_run
from gptq_tpu_torch.models.common import (ArchSpec, KVCache, ShardGroup,
                                          fuse_serving)
from gptq_tpu_torch.parallel.distributed import graph_capable
from gptq_tpu_torch.parallel.ep import _check, ep_specs, ep_tp_local
from gptq_tpu_torch.parallel.mesh import make_layout
from gptq_tpu_torch.parallel.sp import (SPCache, group_layout,
                                        make_sp_cache_prefill,
                                        make_sp_decode_step)
from gptq_tpu_torch.parallel.tp import move_params


def _round_up(n: int, unit: int) -> int:
    return -(-n // unit) * unit


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SPEngine:
    """Long-context serving with this rank's S / sp share of the KV cache.
    cache_dtype defaults to int8 at max_len >= 1024 (half the cache bytes,
    read in place by the partial-attention kernel) and bf16 below.
    max_len rounds up to a multiple of 128 * sp, as in the JAX package.
    Every rank of `group` (None: the default group, which must be
    initialised; its size must be sp) builds the engine and makes the same
    calls. params lie on `device` (default CUDA). The engine holds one
    cache per batch size, which prefill fills in place and every decode
    path (step, generate's graphs, benchmark_chained) writes."""

    def __init__(self, spec: ArchSpec, params: dict, sp: int, tp: int = 1,
                 max_len: int = 2048, cache_dtype=None, fuse: bool = True,
                 a8: bool = False, group=None, device="cuda"):
        self.device = resolve_device(device)
        if tp > 1:
            raise NotImplementedError(
                "SPEngine: tp > 1 (sp x tp serving) is not ported yet "
                "(ROADMAP item 18, sp x tp)")
        size, self.rank = group_layout(group)
        if size != sp:
            raise ValueError(f"SPEngine: sp={sp} but the process group has "
                             f"{size} ranks")
        if cache_dtype is None:
            cache_dtype = torch.int8 if max_len >= 1024 else torch.bfloat16
        self.spec = spec
        self.sp = sp
        self.tp = tp
        self.group = group
        self.cache_dtype = cache_dtype
        self.int8 = cache_dtype == torch.int8
        self.max_len = _round_up(max_len, 128 * sp)
        # chunks run as CUDA graphs, but for a gloo group's collectives,
        # which a graph cannot capture (ranks sharing one card)
        self.graph = (self.device.type == "cuda"
                      and graph_capable(group))
        # sp replicates the weights: serve-time fusion applies up front
        self.params = (fuse_serving(spec, params, a8=a8)
                       if fuse or a8 else params)
        self._prefill = make_sp_cache_prefill(
            spec, self.params, group, cache_dtype=cache_dtype,
            max_len=self.max_len, device=self.device)
        self._steps: dict = {}   # meta -> step
        self._buffers: dict = {}  # batch -> this rank's cache buffers
        self._states: dict = {}  # (meta, B) -> chained state
        self._graphs: dict = {}  # key -> (CUDAGraph, outputs)

    # -- steps, the cache buffers and the chained state ----------------------

    def _step_for(self, meta: tuple):
        if meta not in self._steps:
            self._steps[meta] = make_sp_decode_step(
                self.spec, self.params, meta, self.group,
                int8_cache=self.int8)
        return self._steps[meta]

    def _buffers_for(self, B: int) -> SPCache:
        """This rank's one cache for batch B (k, v, scales and pos at the
        engine's capacity), made at the first prefill of that batch."""
        if B not in self._buffers:
            spec, ml = self.spec, self.max_len // self.sp
            shape = (spec.n_layers, B, ml, spec.kv_heads, spec.hd)

            def buf(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            self._buffers[B] = SPCache(
                k=buf(shape, self.cache_dtype), v=buf(shape, self.cache_dtype),
                pos=torch.full((ml,), -1, dtype=torch.int32,
                               device=self.device), length=0,
                k_scale=buf(shape[:-1], torch.float32) if self.int8 else None,
                v_scale=buf(shape[:-1], torch.float32) if self.int8 else None)
        return self._buffers[B]

    def _load_state(self, cache: SPCache, tok: torch.Tensor) -> dict:
        """The chained state of cache's (meta, batch): the cache's buffers
        (which the engine's prefill filled in place), the next token and
        the length, set from cache and tok."""
        B = cache.k.shape[1]
        key = (tuple(cache.meta), B)
        if key not in self._states:
            self._states[key] = {
                "key": key, "cache": cache,
                "tok": torch.zeros((B, 1), dtype=torch.int64,
                                   device=self.device),
                "len": torch.zeros((), dtype=torch.int32,
                                   device=self.device)}
        st = self._states[key]
        st["tok"].copy_(tok)
        st["len"].fill_(int(cache.length))
        return st

    @staticmethod
    def _state_cache(st: dict, pos=None, length=None) -> SPCache:
        c = st["cache"]
        return SPCache(k=c.k, v=c.v, pos=c.pos if pos is None else pos,
                       length=st["len"] if length is None else length,
                       k_scale=c.k_scale, v_scale=c.v_scale, meta=c.meta)

    @torch.no_grad()
    def _steps_chained(self, st: dict, n: int, forced=None,
                       nll=None) -> torch.Tensor:
        """n decode steps from the chained state; returns the (B, n) greedy
        tokens and leaves the last one and the advanced length in the
        state. With `forced` ((n + 1,) ids) step i feeds forced[i] and
        `nll` ((n,) f32), when given, receives each step's next-token NLL
        of forced[i + 1]."""
        inner = self._step_for(st["key"][0]).inner
        cache = self._state_cache(st)
        tok = st["tok"]
        toks = []
        for i in range(n):
            if forced is not None:
                tok = forced[i:i + 1].reshape(1, 1)
            logits, cache = inner(cache, tok)
            if nll is not None:
                lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
                nll[i:i + 1] = -lp.gather(0, forced[i + 1:i + 2])
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok)
        st["tok"].copy_(tok)
        st["len"].copy_(cache.length)
        return torch.cat(toks, dim=1)

    def _run(self, st: dict, key, fn) -> torch.Tensor:
        """fn() (one chunk's steps) on the chained state: eagerly on the
        CPU and on a gloo group; else a CUDA graph captured at the first
        call with `key` (after one eager warm step, which brings up every
        library, kernel and communicator the step needs) and replayed
        after."""
        if not self.graph:
            return fn()
        entry = self._graphs.get(key)
        if entry is None:
            # the warm step writes its row at the state's slot, masked out
            # by a copy of pos, and leaves the length as it was
            warm = self._state_cache(st, pos=st["cache"].pos.clone(),
                                     length=st["len"].clone())
            self._step_for(st["key"][0]).inner(warm, st["tok"].clone())
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    out = fn()
            except RuntimeError as e:
                raise RuntimeError(f"SPEngine: capturing {key} as a CUDA "
                                   f"graph failed: {e}") from e
            entry = self._graphs[key] = (graph, out)
        graph, out = entry
        graph.replay()
        return out

    def _chunk(self, st: dict, n: int) -> torch.Tensor:
        """n greedy steps chained on the device; (B, n) tokens."""
        return self._run(st, ("chunk", st["key"], n),
                         lambda: self._steps_chained(st, n))

    # -- serving API --------------------------------------------------------

    def prefill(self, ids):
        """(last-token logits (B, vocab), this rank's SPCache). The prompt
        length must divide by sp (generate() feeds a ragged remainder
        through decode steps). The cache lives in the engine's one set of
        buffers for batch B, so per-rank cache memory stays S / sp: the
        next prefill of that batch size overwrites it."""
        ids = torch.as_tensor(ids, device=self.device)
        logits, cache = self._prefill(
            ids, out=self._buffers_for(ids.shape[0]))
        return logits[:, -1], cache

    def step(self, cache: SPCache, token):
        """One guarded decode step -> (logits (B, vocab), cache)."""
        step = self._step_for(tuple(cache.meta))
        return step(cache, torch.as_tensor(token, device=self.device))

    def _capacity(self, cache: SPCache) -> int:
        return cache.meta[1] * self.sp

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 chunk: int = 32) -> np.ndarray:
        """Greedy generation: the sp-divisible prompt prefix prefills
        through the ring, the ragged remainder runs through decode steps,
        and the new tokens through the chained decode (one graph replay
        per `chunk` tokens on the card). Returns (B, <= max_new_tokens)."""
        ids = torch.as_tensor(np.asarray(prompt_ids), device=self.device)
        ids = ids.to(torch.int64)
        B, T = ids.shape
        Tp = max(self.sp, (T // self.sp) * self.sp)
        if Tp > T:
            raise ValueError(f"prompt length {T} < sp {self.sp}")
        logits, cache = self.prefill(ids[:, :Tp])
        length = Tp
        for i in range(Tp, T):  # the ragged remainder (< sp tokens)
            logits, cache = self.step(cache, ids[:, i:i + 1])
            length += 1
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [tok.cpu().numpy()]
        st = self._load_state(cache, tok)
        remaining = max_new_tokens - 1
        while remaining > 0:
            n = min(chunk, remaining, self._capacity(cache) - length - 1)
            if n <= 0:
                break
            out.append(self._chunk(st, n).cpu().numpy())
            remaining -= n
            length += n
        return np.concatenate(out, axis=1)

    @torch.no_grad()
    def benchmark_chained(self, input_ids, check: bool = False,
                          warmup: int = 2, reps: int = 3, log=print) -> dict:
        """Decode benchmark through the sharded-cache serving path (the JAX
        package's protocol): the first sp tokens prefill, the rest feed
        token by token inside one chained chunk (one CUDA graph). The
        host's share cancels by differencing a full-length and a
        half-length chain, each the min over `reps` timed runs after
        `warmup`."""
        n = int(np.prod(np.shape(input_ids)))
        ids = torch.as_tensor(np.asarray(input_ids).reshape(1, n),
                              device=self.device).to(torch.int64)
        sp = self.sp
        _, cache0 = self.prefill(ids[:, :sp])
        if n > self._capacity(cache0):
            raise ValueError(f"{n} tokens exceed capacity "
                             f"{self._capacity(cache0)}")
        st = self._load_state(cache0, ids[:, sp:sp + 1])
        pos0 = cache0.pos.clone()
        # the graphs read the ids and write the NLLs in buffers that live
        # with the state, so that a later call replays them on its own ids
        cap = self._capacity(cache0)
        if "forced" not in st:
            st["forced"] = torch.zeros((cap,), dtype=torch.int64,
                                       device=self.device)
            st["nll"] = torch.zeros((cap,), dtype=torch.float32,
                                    device=self.device)
        st["forced"][:n - sp].copy_(ids[0, sp:])
        nll = st["nll"]

        def run(length: int):
            # every chain starts from the prefilled cache: the slots a
            # previous chain wrote are masked again by the prompt's pos
            st["cache"].pos.copy_(pos0)
            st["len"].fill_(sp)
            # the chain feeds ids[sp .. sp + length - 1]; each step's NLL
            # target is the next id
            forced = st["forced"][:length + 1]
            return self._run(st, ("forced", st["key"], length, check),
                             lambda: self._steps_chained(
                                 st, length, forced=forced,
                                 nll=nll if check else None))

        def timed(length: int) -> float:
            run(length)
            _sync(self.device)
            for _ in range(max(1, warmup - 1)):
                run(length)
            _sync(self.device)
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run(length)
                _sync(self.device)
                ts.append(time.perf_counter() - t0)
            return min(ts)

        full = n - sp - 1
        half = full // 2
        t_half = timed(half)
        t_full = timed(full)
        per_tok = (t_full - t_half) / (full - half)
        below = per_tok <= 0
        if below:
            per_tok = t_full / full
        result = {
            "per_token_s": per_tok,
            "tokens_per_s": 1.0 / per_tok,
            "full_run_s": t_full,
            "half_run_s": t_half,
            "n_tokens": full,
            "below_noise_floor": below,
            "sp": self.sp, "tp": self.tp,
            "cache_dtype": "int8" if self.int8 else "bfloat16",
            "max_len": self.max_len, "graph": self.graph,
        }
        log(f"sp={self.sp} tp={self.tp} cache={result['cache_dtype']} "
            f"{'cuda graph ' if self.graph else ''}"
            f"max_len={self.max_len}: {per_tok * 1e3:.3f} ms/token "
            f"({result['tokens_per_s']:.1f} tok/s)"
            f"{' (upper bound)' if below else ''}")
        if check:
            # the full chain ran last
            total = 0.0
            for v in nll[:full].tolist():
                total += v
            result["ppl"] = float(np.exp(total / full))
            log(f"PPL: {result['ppl']:.4f}")
        return result


class EPEngine:
    """MoE serving with the expert stacks split over the ep ranks: each
    rank holds E / ep experts. With tp > 1 the world is an (ep, tp)
    layout (parallel/mesh.make_layout): attention linears
    split over the rank's tp group and the KV cache holds its kv heads;
    at tp = 1 the cache is whole on every rank and the serving fusion
    (fuse / a8) applies before the experts are sliced. params are the
    whole model, on any device (a host copy keeps the card's memory to
    the rank's share); the rank's local params go to `device`. Every
    rank builds the engine and makes the same calls. The decode step
    takes prefill too (T > 1 appends)."""

    def __init__(self, spec: ArchSpec, params: dict, ep: int, tp: int = 1,
                 max_len: int = 2048, cache_dtype=torch.bfloat16,
                 fuse: bool = True, a8: bool = False, device="cuda"):
        _check(spec, ep)
        layout = make_layout(ep, tp)
        self.spec, self.ep, self.tp = spec, ep, tp
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.rank = layout.outer_rank * tp + layout.tp_rank
        epg = ShardGroup(layout.outer_group, ep, layout.outer_rank)
        if tp > 1:
            local = ep_tp_local(spec, params, layout, fuse=fuse, a8=a8)
            tpg = ShardGroup(layout.tp_group, tp, layout.tp_rank)
        else:
            local = ep_specs(fuse_serving(spec, params, a8=a8)
                             if fuse or a8 else params, ep, layout.outer_rank)
            tpg = None
        local = move_params(local, resolve_device(device))
        self.engine = DecodeEngine(spec, local, max_len=max_len, batch=1,
                                   cache_dtype=cache_dtype, tp=tpg, ep=epg)
        self.device = self.engine.device

    def new_cache(self, batch: int = 1) -> KVCache:
        e = self.engine
        return KVCache.init(e._cache_spec, batch, self.max_len,
                            self.cache_dtype, self.device)

    def prefill(self, ids, cache: KVCache | None = None):
        """(last-position logits, cache) of a prompt (B, T)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        cache = cache if cache is not None else self.new_cache(ids.shape[0])
        return self.engine.step(cache, ids.to(torch.int64))

    def step(self, cache: KVCache, token):
        return self.engine.step(
            cache, torch.as_tensor(token, device=self.device))

    def generate(self, prompt_ids, max_new_tokens: int) -> np.ndarray:
        """Greedy generation: (B, max_new_tokens) token ids."""
        logits, cache = self.prefill(prompt_ids)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.step(cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()

    @torch.no_grad()
    def benchmark_chained(self, input_ids, check: bool = False,
                          warmup: int = 2, reps: int = 3, log=print) -> dict:
        """The JAX package's forced-sequence protocol through the ep step
        (decode.chained_run), with the ep / tp sizes."""
        n = int(np.prod(np.shape(input_ids)))
        if n + 1 > self.max_len:
            raise ValueError(f"{n} tokens exceed max_len {self.max_len}")
        return {**chained_run(self.engine, input_ids, check, warmup, reps,
                              log), "ep": self.ep, "tp": self.tp}
