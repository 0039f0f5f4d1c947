"""Calibration / evaluation token streams (own copy of gptq_tpu/data.py).

`get_loaders` reads wikitext2 / ptb / c4 (and the ptb-new / c4-new
protocols) through the HF `datasets` package, imported inside the
loaders, and samples the calibration windows with the same
`random.Random` call sequence and the same joins as the JAX package, so
both packages cut bit-identical windows and test streams for one seed
and tokenizer. Offline runs pass `data_dir` (a datasets cache) or use
the synthetic streams. Everything returns numpy int arrays.
"""

from __future__ import annotations

import random

import numpy as np


class TokenStream:
    """Minimal stand-in for a tokenizer output wrapper (`.input_ids`)."""

    def __init__(self, input_ids: np.ndarray):
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        self.input_ids = input_ids


def _sample_windows(trainenc: np.ndarray, nsamples: int, seed: int,
                    seqlen: int) -> np.ndarray:
    """Seeded random windows of one token stream."""
    rnd = random.Random()
    rnd.seed(seed)
    out = []
    total = trainenc.shape[-1]
    flat = trainenc.reshape(-1)
    for _ in range(nsamples):
        i = rnd.randint(0, total - seqlen - 1)
        out.append(flat[i:i + seqlen])
    return np.stack(out)


def _load(*args, data_dir=None, **kw):
    from datasets import load_dataset

    if data_dir is not None:
        kw["cache_dir"] = data_dir
    return load_dataset(*args, **kw)


def get_wikitext2(nsamples, seed, seqlen, tokenizer, data_dir=None):
    traindata = _load("wikitext", "wikitext-2-raw-v1", split="train",
                      data_dir=data_dir)
    testdata = _load("wikitext", "wikitext-2-raw-v1", split="test",
                     data_dir=data_dir)
    trainenc = np.asarray(tokenizer("\n\n".join(traindata["text"])).input_ids)
    testenc = np.asarray(tokenizer("\n\n".join(testdata["text"])).input_ids)
    return (_sample_windows(trainenc[None], nsamples, seed, seqlen),
            TokenStream(testenc))


def get_ptb(nsamples, seed, seqlen, tokenizer, data_dir=None, new=False):
    """ptb; `new` evaluates on the test split joined by spaces."""
    traindata = _load("ptb_text_only", "penn_treebank", split="train",
                      data_dir=data_dir)
    valdata = _load("ptb_text_only", "penn_treebank",
                    split="test" if new else "validation", data_dir=data_dir)
    join = " " if new else "\n\n"
    trainenc = np.asarray(tokenizer(join.join(traindata["sentence"])).input_ids)
    testenc = np.asarray(tokenizer(join.join(valdata["sentence"])).input_ids)
    return (_sample_windows(trainenc[None], nsamples, seed, seqlen),
            TokenStream(testenc))


def _c4_window(rnd, data, tokenizer, seqlen) -> np.ndarray:
    """One seqlen window of a random document at least seqlen tokens
    long: documents are drawn until one is long enough."""
    while True:
        i = rnd.randint(0, len(data) - 1)
        enc = np.asarray(tokenizer(data[i]["text"]).input_ids)
        if enc.shape[0] >= seqlen:
            break
    i = rnd.randint(0, enc.shape[0] - seqlen - 1)
    return enc[i:i + seqlen]


def get_c4(nsamples, seed, seqlen, tokenizer, data_dir=None, new=False):
    """c4 with the per-document retry loop; the validation stream is 256
    windows drawn with seed 0, or (`new`) the first 1,100 documents
    joined by spaces, cut to 256 * seqlen tokens."""
    traindata = _load(
        "allenai/c4",
        data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
        split="train", data_dir=data_dir)
    valdata = _load(
        "allenai/c4",
        data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
        split="validation", data_dir=data_dir)
    rnd = random.Random()
    rnd.seed(seed)
    train = np.stack([_c4_window(rnd, traindata, tokenizer, seqlen)
                      for _ in range(nsamples)])
    if new:
        valenc = np.asarray(
            tokenizer(" ".join(valdata[:1100]["text"])).input_ids)
        valenc = valenc[:256 * seqlen]
    else:
        rnd = random.Random()
        rnd.seed(0)
        valenc = np.concatenate([_c4_window(rnd, valdata, tokenizer, seqlen)
                                 for _ in range(256)])
    return train, TokenStream(valenc)


def get_loaders(name: str, nsamples=128, seed=0, seqlen=2048, tokenizer=None,
                data_dir=None):
    """(calibration windows (nsamples, seqlen), test TokenStream)."""
    if "wikitext2" in name:
        return get_wikitext2(nsamples, seed, seqlen, tokenizer, data_dir)
    if "ptb" in name:
        return get_ptb(nsamples, seed, seqlen, tokenizer, data_dir,
                       new="new" in name)
    if "c4" in name:
        return get_c4(nsamples, seed, seqlen, tokenizer, data_dir,
                      new="new" in name)
    raise ValueError(f"unknown dataset {name}")


def markov_stream(vocab: int, n_tokens: int, seed: int = 0,
                  branch: int = 4, seq_seed: int | None = None) -> np.ndarray:
    """Order-1 Markov chain with sparse zipf-weighted transitions: each
    state has `branch` successors. The transition table derives from
    `seed`, the sampled path from `seq_seed` (default seed + 1), so a
    held-out stream comes from the same process."""
    rng = np.random.default_rng(seed)
    succ = np.stack([rng.choice(vocab, size=branch, replace=False)
                     for _ in range(vocab)])  # (vocab, branch)
    w = 1.0 / np.arange(1, branch + 1) ** 1.2
    w /= w.sum()
    path_rng = np.random.default_rng(seed + 1 if seq_seed is None
                                     else seq_seed)
    ids = np.empty(n_tokens, np.int32)
    state = int(path_rng.integers(vocab))
    choices = path_rng.choice(branch, size=n_tokens, p=w)
    for i in range(n_tokens):
        state = int(succ[state, choices[i]])
        ids[i] = state
    return ids


def synthetic_stream(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-text for offline runs: zipf-ish unigrams with
    local repetition so models have learnable structure."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    ids = rng.choice(vocab, size=n_tokens, p=probs)
    # inject repetition: every 17th token repeats the one 5 back
    ids[17::17] = ids[12::17][: ids[17::17].shape[0]]
    return ids.astype(np.int32)
