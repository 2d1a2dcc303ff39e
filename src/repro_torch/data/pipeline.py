"""Data pipeline: synthetic corpus (documents with Zipfian token statistics
and learnable bigram structure), sequence packing with EOS boundaries, and a
host-side batch iterator.  Deterministic given the seed."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 200
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Documents whose next-token distribution depends on the previous token
    (a planted bigram model) so a real LM can actually learn structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # planted bigram: each token has a small successor set
        self.n_succ = min(8, V - 1)
        self.succ = rng.integers(1, V, size=(V, self.n_succ))
        ranks = np.arange(1, V, dtype=np.float64)
        zipf = ranks ** -cfg.zipf_a
        self.start_p = zipf / zipf.sum()

    def documents(self, seed: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        while True:
            length = max(8, int(rng.exponential(cfg.mean_doc_len)))
            doc = np.empty(length, np.int64)
            doc[0] = 1 + rng.choice(cfg.vocab_size - 1, p=self.start_p)
            for i in range(1, length):
                if rng.random() < 0.8:     # follow the planted bigram
                    doc[i] = self.succ[doc[i - 1], rng.integers(self.n_succ)]
                else:
                    doc[i] = 1 + rng.choice(cfg.vocab_size - 1,
                                            p=self.start_p)
            yield doc


def packed_batches(cfg: DataConfig, shard_id: int = 0,
                   num_shards: int = 1) -> Iterator[dict]:
    """Pack documents into fixed (batch, seq_len+1) rows with EOS separators;
    emit {tokens, targets}.  Host-sharded by (shard_id, num_shards)."""
    corpus = SyntheticCorpus(cfg)
    docs = corpus.documents(cfg.seed * num_shards + shard_id + 1)
    buf = np.empty(0, np.int64)
    need = cfg.seq_len + 1
    while True:
        rows = []
        while len(rows) < cfg.batch_size:
            while len(buf) < need:
                buf = np.concatenate([buf, next(docs),
                                      np.array([cfg.eos_id])])
            rows.append(buf[:need].copy())
            buf = buf[need:]
        arr = np.stack(rows)
        yield {"tokens": arr[:, :-1].astype(np.int32),
               "targets": arr[:, 1:].astype(np.int32)}
