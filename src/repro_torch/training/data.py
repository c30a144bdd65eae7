"""Data pipeline: deterministic, restart-safe, shardable (copy of
``repro/training/data.py``: the batches are the reference's, bit for bit).

A language-modeling stream over a byte-tokenized corpus (synthetic text by
default).  The iterator state is just
(seed, step), so checkpoint/restart resumes exactly, and each data-parallel
host reads only its shard (host_id, num_hosts) — the production layout.
Batches are numpy arrays; the train loop moves them to the device.
"""

from __future__ import annotations

import numpy as np


_WORDS = (
    "the of to and a in is it you that he was for on are with as his they "
    "be at one have this from or had by hot word but what some we can out "
    "other were all there when up use your how said an each she which do "
    "their time if will way about many then them write would like so these "
    "her long make thing see him two has look more day could go come did "
    "number sound no most people my over know water than call first who may "
    "down side been now find").split()


def synthetic_corpus(seed: int, n_bytes: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = rng.choice(_WORDS, size=n_bytes // 4)
    return (" ".join(words.tolist())).encode()[:n_bytes]


class LMDataset:
    """Deterministic next-token-prediction batches.

    state = (seed, step); `batch(step)` is a pure function, so restart
    resumption and straggler re-issue are trivial."""

    def __init__(self, *, vocab_size, batch_size, seq_len, seed=0,
                 host_id=0, num_hosts=1, corpus: bytes | None = None):
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        corpus = corpus if corpus is not None else synthetic_corpus(
            seed, max(1 << 20, batch_size * (seq_len + 1) * 4))
        self.tokens = np.frombuffer(corpus, np.uint8).astype(np.int32)
        assert batch_size % num_hosts == 0
        self.local_batch = batch_size // num_hosts

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        n = len(self.tokens) - self.seq_len - 1
        # every host draws the full batch's offsets deterministically and
        # takes its slice — no coordination needed
        offs = rng.integers(0, n, size=self.batch_size)
        offs = offs[self.host_id * self.local_batch:
                    (self.host_id + 1) * self.local_batch]
        toks = np.stack([self.tokens[o:o + self.seq_len + 1] for o in offs])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}
