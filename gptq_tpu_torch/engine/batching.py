"""Continuous batching (port of gptq_tpu/engine/batching.py: Request and
ContinuousBatcher).

A fixed pool of `batch_slots` slots decodes in lock-step while finished
slots are refilled with queued prompts, so the weights each decode step
streams serve many requests. The slot state lives in fixed device
buffers: the stacked cache (L, B, S, kv_heads, hd) (int8 with its scale
planes), each slot's next token and each slot's filled length. A refill
writes into them in place.

One lock-step is models.common.model_forward over the (B,) lengths: each
slot attends its own cache below its length plus its fresh k/v (the
deferred write, decode_attention reading lens[b]), then one per-slot
scatter writes every layer's fresh rows at [:, b, lengths[b]] (quantized
first for an int8 cache), and lengths advance, clamped at S - 1 (an idle
or finished slot decodes junk into its own last row, which no reader
covers, until the host refills it). `run(window=n)` runs n lock-steps per
host round trip: on the card one CUDA graph of n steps, captured at its
first use and replayed after (it reads the slot buffers, which refills
update in place, so the graph stays valid); on the CPU the same steps run
eagerly. Outputs equal window 1's: a slot's greedy token depends only on
its own cache.

The refill (`_fill_slots`) batches the prefill: the prompts of one length
bucket run as one dispatch of rows padded to a power of two (the pad rows
repeat the first slot), each row write-first from position 0 over the
bucket length into a copy of its slots' cache prefix, and only the real
rows are scattered back. Each filled slot restarts from len(prompt) - 1
with the prompt's last token, so its first decode step rewrites that row
and yields the first new token; the prefill's logits are not needed, and
no head is computed there.

Data-parallel slots over a mesh (the JAX batcher's `mesh=`) are not
ported (ROADMAP item 18). A `prefill_group` that is not a power of two is
rounded down to one (the JAX batcher pads such a group to a row count
that is not a power of two).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from gptq_tpu_torch.models.common import (ArchSpec, KVCache, block_forward,
                                          causal_mask, embed_forward,
                                          model_forward, rope_tables)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (T,) token ids
    max_new_tokens: int
    eos_id: int | None = None
    output: list = field(default_factory=list)
    done: bool = False


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


class ContinuousBatcher:
    def __init__(self, spec: ArchSpec, params: dict, batch_slots: int = 8,
                 max_len: int = 2048, cache_dtype=torch.bfloat16,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024),
                 mesh=None, prefill_group: int | None = None):
        """params as model_forward takes them (fuse_serving's for the
        fused route); the slot buffers go on the embedding's device.
        prefill_group caps the rows of one prefill dispatch (rounded down
        to a power of two; default batch_slots)."""
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousBatcher(mesh=...): data-parallel slots over a "
                "mesh are not ported (ROADMAP item 18)")
        if spec.arch != "llama":
            raise NotImplementedError(
                f"ContinuousBatcher: arch {spec.arch!r} is not served by "
                f"the batcher yet (ROADMAP queue 1: the batcher on the OPT, "
                f"BLOOM and Gemma families)")
        self.spec = spec
        self.params = params
        self.B = batch_slots
        self.S = max_len
        self.device = params["embed"]["tokens"].device
        cache = KVCache.init(spec, batch_slots, max_len, cache_dtype,
                             self.device)
        self.kc, self.vc = cache.k, cache.v
        self.ks, self.vs = cache.k_scale, cache.v_scale
        self.lengths = torch.zeros((batch_slots,), dtype=torch.int32,
                                   device=self.device)
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int64,
                                  device=self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._buckets = prefill_buckets
        self._prefill_group = _pow2_floor(min(prefill_group or batch_slots,
                                              batch_slots))
        self._uid = 0
        self.prefill_calls = 0  # prefill dispatches
        self._graphs = {}  # window length -> (CUDAGraph, (n, B) tokens)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 64,
               eos_id: int | None = None) -> int:
        prompt = np.asarray(prompt).reshape(-1)
        if len(prompt) + max_new_tokens > self.S:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the cache max_len ({self.S})")
        self._uid += 1
        self.queue.append(Request(self._uid, prompt, max_new_tokens, eos_id))
        return self._uid

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.S

    # -- prefill -------------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, ids: torch.Tensor, cache: KVCache) -> None:
        """Every layer write-first from position 0 over ids (rows, T) into
        `cache` (rows, T slots); no head."""
        spec = self.spec
        rows, T = ids.shape
        positions = torch.arange(T, device=self.device).expand(rows, T)
        mask = causal_mask(T, T, self.device)
        rope = rope_tables(spec, positions)
        h = embed_forward(spec, self.params, ids, positions)
        for i, bp in enumerate(self.params["layers"]):
            layer_cache = (cache.k[i], cache.v[i],
                           None if cache.k_scale is None else cache.k_scale[i],
                           None if cache.v_scale is None else cache.v_scale[i])
            h, _, _ = block_forward(spec, bp, h, positions=positions,
                                    mask=mask, cache=layer_cache, cache_len=0,
                                    rope=rope)

    @torch.no_grad()
    def _fill_slots(self) -> None:
        """Refill every free slot: the prompts sharing a length bucket run
        as one prefill dispatch (at most prefill_group rows each)."""
        assign: list[tuple[int, Request]] = []
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            assign.append((slot, self.queue.pop(0)))
        if not assign:
            return
        by_bucket: dict[int, list[tuple[int, Request]]] = {}
        for slot, req in assign:
            by_bucket.setdefault(self._bucket(len(req.prompt)), []).append(
                (slot, req))
        cap = self._prefill_group
        chunks = [(Tp, full_group[g0:g0 + cap])
                  for Tp, full_group in by_bucket.items()
                  for g0 in range(0, len(full_group), cap)]
        for Tp, group in chunks:
            n_real = len(group)
            gp = _pow2_ceil(n_real)  # <= cap: cap is a power of two
            slots = torch.tensor([s for s, _ in group]
                                 + [group[0][0]] * (gp - n_real),
                                 device=self.device)
            ids = np.zeros((gp, Tp), np.int64)
            for row, (_, req) in enumerate(group):
                ids[row, :len(req.prompt)] = req.prompt
            planes = [p for p in (self.kc, self.vc, self.ks, self.vs)
                      if p is not None]
            got = [p[:, slots, :Tp] for p in planes]  # copies
            self._prefill(torch.from_numpy(ids).to(self.device), KVCache(
                k=got[0], v=got[1], length=0,
                k_scale=got[2] if len(got) == 4 else None,
                v_scale=got[3] if len(got) == 4 else None))
            self.prefill_calls += 1
            real = slots[:n_real]
            for p, g in zip(planes, got):
                p[:, real, :Tp] = g[:, :n_real]
            # each slot re-decodes from its prompt's end (the padding
            # wrote junk beyond it, which its length masks out)
            sl = real.to(torch.int64)
            self.lengths[sl] = torch.tensor(
                [len(req.prompt) - 1 for _, req in group], dtype=torch.int32,
                device=self.device)
            self.tokens[sl] = torch.tensor(
                [int(req.prompt[-1]) for _, req in group], dtype=torch.int64,
                device=self.device)
            for slot, req in group:
                self.slot_req[slot] = req

    # -- decode --------------------------------------------------------------

    def _logits(self) -> torch.Tensor:
        """The lock-step's forward over the slot buffers: each slot's
        token at its length, the fresh rows written; (B, vocab) logits.
        The lengths and tokens are left to the caller."""
        logits, _ = model_forward(self.spec, self.params, self.tokens[:, None],
                                  KVCache(k=self.kc, v=self.vc,
                                          length=self.lengths,
                                          k_scale=self.ks, v_scale=self.vs))
        return logits[:, -1]

    def _body(self) -> torch.Tensor:
        """One lock-step over the slot buffers, in place; (B,) tokens."""
        nxt = torch.argmax(self._logits(), dim=-1)
        self.tokens.copy_(nxt)
        self.lengths.add_(1).clamp_(max=self.S - 1)
        return nxt

    def _steps(self, n: int) -> torch.Tensor:
        return torch.stack([self._body() for _ in range(n)])

    def _window(self, n: int) -> torch.Tensor:
        """n lock-steps -> (n, B) tokens: eagerly on the CPU; on CUDA one
        graph per n, captured at its first use after one eager warm step
        (its rows are rewritten by the first replayed step) and replayed.
        The result is the graph's static output, overwritten by the next
        replay of the same n."""
        if self.device.type != "cuda":
            return self._steps(n)
        entry = self._graphs.get(n)
        if entry is None:
            tokens, lengths = self.tokens.clone(), self.lengths.clone()
            self._body()
            self.tokens.copy_(tokens)
            self.lengths.copy_(lengths)
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    out = self._steps(n)
            except RuntimeError as e:
                raise RuntimeError(f"ContinuousBatcher: capturing a window of "
                                   f"{n} steps as a CUDA graph failed: {e}"
                                   ) from e
            entry = self._graphs[n] = (graph, out)
        graph, out = entry
        graph.replay()
        return out

    @torch.no_grad()
    def step(self) -> None:
        """One eager lock-step, its tokens harvested."""
        self._harvest(self._body().cpu().numpy()[None])

    def _harvest(self, tok_rows: np.ndarray) -> None:
        """Fold (n_steps, B) tokens into the requests' outputs; retire a
        request at eos / max_new_tokens (later rows of its slot are the
        junk the lock-step kept decoding) and reset the freed slots'
        lengths in one update."""
        freed: list[int] = []
        for row in tok_rows:
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                t = int(row[slot])
                req.output.append(t)
                if (req.eos_id is not None and t == req.eos_id) or (
                        len(req.output) >= req.max_new_tokens):
                    req.done = True
                    self.finished.append(req)
                    self.slot_req[slot] = None
                    freed.append(slot)
        if freed:
            self.lengths[torch.tensor(freed, device=self.device)] = 0

    @torch.no_grad()
    def run(self, progress: Callable[[int, int], None] | None = None,
            window: int = 1) -> list[Request]:
        """Drain the queue; the finished requests by uid. window > 1 runs
        that many lock-steps per host round trip: slots refill only on
        window boundaries, and a request finishing mid-window idles its
        slot until the boundary."""
        while self.queue or any(r is not None for r in self.slot_req):
            self._fill_slots()
            if window == 1:
                self.step()
            else:
                self._harvest(self._window(window).cpu().numpy())
            if progress:
                progress(len(self.finished), len(self.queue))
        out = sorted(self.finished, key=lambda r: r.uid)
        self.finished = []
        return out
