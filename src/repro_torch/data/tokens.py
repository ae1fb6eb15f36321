"""Synthetic LM token pipeline, the port's copy of ``repro.data.tokens``
(numpy only).

The port imports nothing of ``repro``; this copy is the same code, so a
(seed, step, shard) gives bit-identical batches in both packages and the
port's training reads the reference's data step for step.

Deterministic, seekable, shardable: batch ``step`` is a pure function of
(seed, step), so every data-parallel worker can slice its shard without
coordination.

The stream has learnable structure (a fixed "phrase book" of n-grams with
Zipf-distributed usage, phrases stitched with a skip-gram noise channel),
so cross-entropy drops well below ln(V) within a few hundred steps —
enough signal for the training launcher to demonstrate learning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_phrases: int = 512
    phrase_len: int = 8
    noise: float = 0.05


class TokenStream:
    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = max(cfg.vocab_size - 1, 2)
        self._phrases = rng.integers(
            1, v, size=(cfg.num_phrases, cfg.phrase_len), dtype=np.int64)
        # Zipf-ish phrase frequencies
        ranks = np.arange(1, cfg.num_phrases + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._phrase_p = p / p.sum()

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """Batch for ``step``; optionally only the rows of ``shard``."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        rows = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        n_phr = cfg.seq_len // cfg.phrase_len + 2
        idx = rng.choice(cfg.num_phrases, size=(rows, n_phr), p=self._phrase_p)
        toks = self._phrases[idx].reshape(rows, -1)[:, : cfg.seq_len + 1]
        noise = rng.random(toks.shape) < cfg.noise
        toks = np.where(noise,
                        rng.integers(1, cfg.vocab_size, size=toks.shape),
                        toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_stream(vocab_size: int, seq_len: int, global_batch: int,
                seed: int = 0, **kw) -> TokenStream:
    return TokenStream(TokenStreamConfig(
        vocab_size=vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, **kw))
