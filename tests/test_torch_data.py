"""gptq_tpu_torch.data.get_loaders against gptq_tpu.data.get_loaders: the
calibration windows and test streams of wikitext2, ptb, ptb-new, c4 and
c4-new are bit-identical for one seed and tokenizer. `datasets` is a fake
module with rows of seeded text (no download) and the tokenizer maps text
to deterministic synthetic ids of a length set by the text (documents
shorter than the window exercise c4's retry loop)."""

import sys
import types
import zlib

import numpy as np
import pytest

from gptq_tpu import data as jdata
from gptq_tpu_torch import data as tdata
from torch_threads import torch_threads  # noqa: F401 (autouse)

VOCAB = 99
SEQLEN = 64


class FakeTokenizer:
    def __call__(self, text, **kw):
        n = max(16, min(len(text) // 3, 6000))
        return types.SimpleNamespace(
            input_ids=tdata.synthetic_stream(VOCAB, n,
                                             seed=len(text) % 97).tolist())


class FakeSplit:
    def __init__(self, rows, key):
        self.rows, self.key = rows, key

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.rows
        return {self.key: self.rows[i]}


def fake_load_dataset(path, *args, split=None, **kw):
    """Rows whose lengths vary with the split: a c4 document is 2-600
    words, so some are shorter than a window."""
    rng = np.random.default_rng(zlib.crc32(f"{path}/{split}".encode()))
    rows = [" ".join(f"w{i}_{j}" for j in range(int(rng.integers(2, 600))))
            for i in range(60)]
    return FakeSplit(rows, "sentence" if path == "ptb_text_only" else "text")


@pytest.fixture()
def fake_datasets(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=fake_load_dataset))


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "ptb-new", "c4",
                                  "c4-new"])
def test_loaders_match_jax_bit_for_bit(name, fake_datasets):
    tok = FakeTokenizer()
    jw, jt = jdata.get_loaders(name, nsamples=6, seed=3, seqlen=SEQLEN,
                               tokenizer=tok)
    tw, tt = tdata.get_loaders(name, nsamples=6, seed=3, seqlen=SEQLEN,
                               tokenizer=tok)
    assert tw.shape == (6, SEQLEN)
    np.testing.assert_array_equal(tw, jw)
    assert tt.input_ids.dtype == jt.input_ids.dtype
    np.testing.assert_array_equal(tt.input_ids, jt.input_ids)
    other, _ = tdata.get_loaders(name, nsamples=6, seed=4, seqlen=SEQLEN,
                                 tokenizer=tok)
    assert not np.array_equal(other, tw)  # the seed moves the windows


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.get_loaders("lambada", tokenizer=FakeTokenizer())
