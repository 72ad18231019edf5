"""Token data pipeline: deterministic, step-indexed, restart-safe.

The port of the JAX package's ``data/tokens.py`` (numpy only; its
batches are the JAX package's, array for array, for the same ``(seed,
step, shard, n_shards)``). The loader is a pure function of (step,
shard): a restarted job regenerates exactly the batch it would have
seen (no iterator state to checkpoint), and adding or removing data
shards only changes the shard parameter. A background thread keeps the
next batches ready.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Tuple

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic LM corpus (zipf-ish unigram + markov blend)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard, n_shards]))
        b = self.batch // n_shards
        # zipf-like marginal
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks ** 1.1
        p /= p.sum()
        toks = rng.choice(self.vocab, size=(b, self.seq_len + 1), p=p)
        # short-range structure: random repeats
        rep = rng.random((b, self.seq_len + 1)) < 0.2
        toks[:, 1:][rep[:, 1:]] = toks[:, :-1][rep[:, 1:]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class Prefetcher:
    """Host-side async prefetch of the next ``depth`` batches."""

    def __init__(self, source, start_step: int, depth: int = 2,
                 shard: int = 0, n_shards: int = 1):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._shard, self._n = shard, n_shards
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self._shard, self._n)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
