"""KV-cache decode engine and the decode benchmarks (port of
gptq_tpu/engine/decode.py: sample_token, DecodeEngine with generate and
generate_chained, benchmark_decode, measure_dispatch_rtt and
benchmark_decode_chained).

`benchmark_decode` is the reference's protocol: feed the tokens one at a
time through the cached decode step, synchronise the device after every
token (`torch.cuda.synchronize()`), and report the median per-token
latency.

The chained loop takes the host out of the token loop. The JAX package
runs a chunk of decode steps as one jitted `lax.scan`; here a chunk is
one CUDA graph of those steps, captured once per chunk length (and
sampling rule) and replayed. The graph reads the cache length from
device memory (a tensor KVCache.length), feeds each step's token to the
next, and leaves the next token and the advanced length in the engine's
chained state, so successive replays continue the sequence. On the CPU
the same steps run eagerly. A step that cannot be captured raises; no
path falls back to eager steps on the card.

Under tensor or expert parallelism (`tp` / `ep` ShardGroups: the CLI's
--tp) the engine runs this rank's local params (parallel/tp.py) over its
groups; every rank makes the same calls. A CUDA graph captures NCCL's
collectives but not gloo's, so on a gloo group (ranks sharing one card)
the chained loop runs its steps eagerly on the card: the engine's `graph`
says which, and so do the chained benchmark's result and log line.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gptq_tpu_torch.config import resolve_device
from gptq_tpu_torch.models.common import (ArchSpec, KVCache, ShardGroup,
                                          fuse_serving, model_forward)
from gptq_tpu_torch.parallel.distributed import graph_capable


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy at temperature 0, else temperature-scaled (optionally top-k
    filtered) categorical sampling from `generator`: the argmax of p / E
    with E ~ Exp(1), torch.multinomial's rule for one sample, written out
    because multinomial checks its input on the host, which a CUDA graph
    cannot capture."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.to(torch.float32) / temperature
    if top_k > 0:
        thresh = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < thresh, torch.full_like(lg, float("-inf")), lg)
    probs = torch.softmax(lg, dim=-1)
    draws = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / draws, dim=-1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Cached decode of one model (or, with `tp` / `ep` ShardGroups, of
    this rank's local params: parallel/tp.tp_local_view, parallel/ep,
    which also build the serving fusion; fuse_serving runs otherwise)."""

    def __init__(self, spec: ArchSpec, params: dict, max_len: int = 2048,
                 batch: int = 1, cache_dtype=torch.bfloat16, a8: bool = False,
                 tp: ShardGroup | None = None, ep: ShardGroup | None = None):
        self.spec = spec
        self.tp, self.ep = tp, ep
        self.params = (params if tp is not None or ep is not None
                       else fuse_serving(spec, params, a8=a8))
        self.max_len = max_len
        self.batch = batch
        self.cache_dtype = cache_dtype
        self.device = params["embed"]["tokens"].device
        # the cache holds the rank's kv heads under tp
        self._cache_spec = spec if tp is None else dataclasses.replace(
            spec, n_kv_heads=spec.kv_heads // tp.size)
        # chunks run as CUDA graphs unless a group's collectives cannot be
        # captured (gloo)
        self.graph = self.device.type == "cuda" and all(
            g is None or g.size == 1 or graph_capable(g.group)
            for g in (tp, ep))
        self._state = None  # the chained loop's cache, token and length
        self._graphs = {}   # captured chunks: key -> (CUDAGraph, tokens)

    def new_cache(self) -> KVCache:
        return KVCache.init(self._cache_spec, self.batch, self.max_len,
                            self.cache_dtype, self.device)

    @torch.no_grad()
    def step(self, cache: KVCache, token: torch.Tensor):
        """One forward over `token` (B, T) -> (last-position logits, cache)."""
        logits, cache = model_forward(self.spec, self.params, token, cache,
                                      tp=self.tp, ep=self.ep)
        return logits[:, -1], cache

    def prefill(self, ids: torch.Tensor, cache: KVCache | None = None):
        """Feed a prompt; returns (last-token logits, cache)."""
        cache = cache if cache is not None else self.new_cache()
        return self.step(cache, ids)

    def generate(self, prompt_ids, max_new_tokens: int) -> np.ndarray:
        """Greedy generation: (B, max_new_tokens) token ids."""
        ids = torch.as_tensor(np.asarray(prompt_ids), device=self.device)
        ids = ids.reshape(self.batch, -1).to(torch.int64)
        logits, cache = self.prefill(ids)
        out = []
        tok = sample_token(logits)
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = self.step(cache, tok[:, None])
            tok = sample_token(logits)
        return torch.stack(out, dim=1).cpu().numpy()

    def _chain_state(self) -> dict:
        """The chained loop's state on the device, made once: a cache whose
        buffers every captured graph reads and writes, the token the next
        chunk feeds and the cache length it starts at."""
        if self._state is None:
            self._state = {
                "cache": self.new_cache(),
                "tok": torch.zeros((self.batch, 1), dtype=torch.int64,
                                   device=self.device),
                "len": torch.zeros((), dtype=torch.int32, device=self.device)}
        return self._state

    def _state_cache(self) -> KVCache:
        st = self._chain_state()
        c = st["cache"]
        return KVCache(k=c.k, v=c.v, length=st["len"], k_scale=c.k_scale,
                       v_scale=c.v_scale)

    @torch.no_grad()
    def _steps(self, n: int, generator=None, temperature: float = 0.0,
               top_k: int = 0, forced=None, nll=None) -> torch.Tensor:
        """n decode steps from the chained state; returns the (B, n) tokens
        they pick and leaves the last one and the advanced length in the
        state. With `forced` ((n,) ids, a chain from length 0) step i feeds
        forced[i] instead, and `nll` ((n,) f32), when given, receives each
        step's next-token NLL of forced[i + 1]."""
        st = self._chain_state()
        cache = self._state_cache()
        tok = st["tok"]
        toks = []
        for i in range(n):
            if forced is not None:
                tok = forced[i:i + 1].reshape(1, 1)
            logits, cache = self.step(cache, tok)
            if nll is not None and i + 1 < n:
                lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
                nll[i:i + 1] = -lp.gather(0, forced[i + 1:i + 2])
            tok = sample_token(logits, generator, temperature, top_k)[:, None]
            toks.append(tok)
        st["tok"].copy_(tok)
        st["len"].copy_(cache.length)
        return torch.cat(toks, dim=1)

    def _warm(self) -> None:
        """One eager step at the chained state's length (its row is
        rewritten by the first replayed step), so every library, kernel
        and occupancy query a step needs is loaded before a capture."""
        st = self._chain_state()
        c = self._state_cache()
        self.step(KVCache(k=c.k, v=c.v, length=st["len"].clone(),
                          k_scale=c.k_scale, v_scale=c.v_scale),
                  st["tok"].clone())
        torch.cuda.synchronize(self.device)

    def _run(self, key, fn, generator=None) -> torch.Tensor:
        """fn() (the steps of one chunk) on the chained state: eagerly on
        the CPU and on a gloo group; else as a CUDA graph captured at the
        first call with `key` and replayed after. Returns the chunk's
        outputs (from a graph a static tensor that the next replay of the
        same key overwrites)."""
        if not self.graph:
            return fn()
        entry = self._graphs.get(key)
        if entry is None:
            self._warm()
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                if not hasattr(graph, "register_generator_state"):
                    raise RuntimeError(
                        "generate_chained: sampling from a generator inside "
                        "a CUDA graph needs CUDAGraph.register_generator_"
                        f"state, which torch {torch.__version__} lacks")
                graph.register_generator_state(generator)
            try:
                with torch.cuda.graph(graph):
                    out = fn()
            except RuntimeError as e:
                raise RuntimeError(f"chained decode: capturing {key} as a "
                                   f"CUDA graph failed: {e}") from e
            entry = self._graphs[key] = (graph, out)
        graph, out = entry
        graph.replay()
        return out

    def _chunk(self, n: int, generator=None, temperature: float = 0.0,
               top_k: int = 0) -> torch.Tensor:
        """n sampled (or greedy) steps chained on the device: one CUDA
        graph per (n, temperature, top_k, generator); (B, n) tokens."""
        key = ("chunk", n, float(temperature), int(top_k), generator)
        return self._run(key, lambda: self._steps(n, generator, temperature,
                                                  top_k), generator)

    @torch.no_grad()
    def generate_chained(self, prompt_ids, max_new_tokens: int,
                         chunk: int = 32, temperature: float = 0.0,
                         top_k: int = 0, generator: torch.Generator | None = None,
                         bucketed: bool = True) -> np.ndarray:
        """Generation with the decode loop on the device: one graph replay
        per `chunk` tokens instead of per token. temperature 0 reproduces
        `generate` (greedy); temperature > 0 samples (optionally top-k
        truncated) from `generator` (the device's default one when None).

        `bucketed` is the JAX package's option of running each chunk
        against the smallest power-of-two cache prefix that covers it.
        The port's decode kernels read only the slots below the cache
        length, which the graph takes from device memory, so a bucket
        would not change what they read: both settings run the same
        graphs and give the same tokens. Returns (B, max_new_tokens)."""
        del bucketed
        ids = torch.as_tensor(np.asarray(prompt_ids), device=self.device)
        ids = ids.reshape(self.batch, -1).to(torch.int64)
        if ids.shape[1] + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"generate_chained: {ids.shape[1]} prompt + "
                             f"{max_new_tokens} new tokens exceed max_len "
                             f"{self.max_len}")
        st = self._chain_state()
        c = st["cache"]
        logits, _ = self.prefill(ids, KVCache(k=c.k, v=c.v, length=0,
                                              k_scale=c.k_scale,
                                              v_scale=c.v_scale))
        first = sample_token(logits, generator, temperature, top_k)
        out = [first[:, None]]
        st["tok"].copy_(first[:, None])
        st["len"].fill_(ids.shape[1])
        remaining = max_new_tokens - 1
        while remaining > 0:
            n = min(chunk, remaining)
            out.append(self._chunk(n, generator, temperature, top_k).clone())
            remaining -= n
        return torch.cat(out, dim=1)[:, :max_new_tokens].cpu().numpy()


def _round_len(n: int, cache_dtype) -> int:
    """Benchmark cache length: the int8 cache rounds up to a 128 multiple
    (as the JAX package does for its tile-aligned kernel; slots past the
    filled length are never read)."""
    if cache_dtype == torch.int8:
        return ((n + 127) // 128) * 128
    return n


@torch.no_grad()
def benchmark_decode(spec: ArchSpec, params: dict, input_ids,
                     check: bool = False, warmup: int = 100, log=print,
                     cache_dtype=torch.bfloat16,
                     tp: ShardGroup | None = None) -> dict:
    """Feed input_ids (1, n) one token at a time through the cached decode
    step; report the median per-token latency (host clock around each
    synchronised step). With check=True also accumulate the next-token
    NLL and report its PPL. `tp`: params are the rank's tp_local_view."""
    n = int(np.prod(np.shape(input_ids)))
    engine = DecodeEngine(spec, params, max_len=_round_len(n + 1, cache_dtype),
                          batch=1, cache_dtype=cache_dtype, tp=tp)
    dev = engine.device
    ids = torch.as_tensor(np.asarray(input_ids).reshape(1, n),
                          device=dev).to(torch.int64)
    tok0 = ids[:, :1]
    warm_cache = engine.new_cache()
    for _ in range(warmup):
        logits, _ = engine.step(warm_cache, tok0)
    _sync(dev)

    cache = engine.new_cache()
    times = []
    nll = 0.0
    for i in range(n):
        t0 = time.perf_counter()
        logits, cache = engine.step(cache, ids[:, i:i + 1])
        _sync(dev)
        times.append(time.perf_counter() - t0)
        if check and i != n - 1:
            lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
            nll += -float(lp[ids[0, i + 1]])

    med = float(np.median(times))
    result = {"median_s": med, "tokens_per_s": 1.0 / med,
              "mean_s": float(np.mean(times)),
              "p90_s": float(np.percentile(times, 90)),
              "n_tokens": n, "warmup": warmup}
    log(f"Median: {med:.6f}s  ({1.0 / med:.1f} tok/s)")
    if check:
        result["ppl"] = float(np.exp(nll / (n - 1)))
        log(f"PPL: {result['ppl']:.4f}")
    return result


def measure_dispatch_rtt(reps: int = 5, device="cuda") -> float:
    """Host <-> device round trip of one small launch and the fetch of its
    result (seconds, median of `reps`)."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    float((x + 1.0)[0, 0])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float((x + 1.0)[0, 0])
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@torch.no_grad()
def chained_run(engine: DecodeEngine, input_ids, check: bool, warmup: int,
                reps: int, log=print) -> dict:
    """The chained protocol on `engine` (batch 1): the n ids fed one a step
    from an empty cache, as one chained run (one CUDA graph where the
    engine captures), for the first n // 2 ids and for all n, each the
    min over `reps` timed runs after `warmup`; the per-token time is the
    difference of the two. With check also the PPL of the full chain's
    next-token NLL. A sharded engine's result says whether its chunks
    were captured ("graph": on a gloo group they run eagerly)."""
    n = int(np.prod(np.shape(input_ids)))
    dev = engine.device
    ids = torch.as_tensor(np.asarray(input_ids).reshape(n),
                          device=dev).to(torch.int64)
    nll = torch.zeros((n,), dtype=torch.float32, device=dev)
    st = engine._chain_state()

    def run(length: int):
        st["len"].fill_(0)
        return engine._run(("forced", length, check), lambda: engine._steps(
            length, forced=ids[:length], nll=nll if check else None))

    def timed(length: int) -> float:
        run(length)
        _sync(dev)
        for _ in range(max(1, warmup - 1)):
            run(length)
        _sync(dev)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(length)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_half = timed(n // 2)
    t_full = timed(n)
    half = n // 2
    per_tok = (t_full - t_half) / (n - half)
    rtt = measure_dispatch_rtt(device=dev)
    below_floor = per_tok <= 0
    if below_floor:
        # the difference drowned in the host's noise: the full chain's
        # average, an upper bound that still carries one launch
        per_tok = t_full / n
    result = {"per_token_s": per_tok, "tokens_per_s": 1.0 / per_tok,
              "full_run_s": t_full, "half_run_s": t_half,
              "dispatch_rtt_s": rtt, "n_tokens": n,
              "below_noise_floor": below_floor}
    if engine.tp is not None or engine.ep is not None:
        result["graph"] = engine.graph
    qualifier = (" (upper bound: difference below noise floor)"
                 if below_floor else "")
    mode = "" if engine.graph or dev.type != "cuda" else ", eager: gloo"
    log(f"Per-token (chained, {dev.type}{mode}): {per_tok * 1e3:.3f} ms "
        f"({result['tokens_per_s']:.1f} tok/s){qualifier}; "
        f"dispatch RTT {rtt * 1e3:.3f} ms")
    if check:
        # the full chain ran last; summed in benchmark_decode's order
        total = 0.0
        for v in nll[:n - 1].tolist():
            total += v
        result["ppl"] = float(np.exp(total / (n - 1)))
        log(f"PPL: {result['ppl']:.4f}")
    return result


@torch.no_grad()
def benchmark_decode_chained(spec: ArchSpec, params: dict, input_ids,
                             check: bool = False, warmup: int = 2,
                             reps: int = 3, log=print,
                             cache_dtype=torch.bfloat16,
                             tp: ShardGroup | None = None,
                             ep: ShardGroup | None = None) -> dict:
    """Decode benchmark with the token loop on the device (the JAX
    package's protocol). The workload of benchmark_decode (input_ids fed
    one token at a time through a growing cache), but all n steps of a
    chain run as one CUDA graph (eagerly on the CPU). The host's share is
    cancelled by differencing a full-length and a half-length chain, each
    the min over `reps` timed runs after `warmup`; both are reported.
    With check=True also the PPL of the full chain's next-token NLL.
    `tp` / `ep`: params are the rank's local view (DecodeEngine); on a
    gloo group the chains run eagerly ("graph": false)."""
    n = int(np.prod(np.shape(input_ids)))
    engine = DecodeEngine(spec, params, max_len=_round_len(n + 1, cache_dtype),
                          batch=1, cache_dtype=cache_dtype, tp=tp, ep=ep)
    return chained_run(engine, input_ids, check, warmup, reps, log)
