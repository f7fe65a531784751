"""Deterministic, shardable, checkpointable token pipeline.

Two sources:
  * :class:`SyntheticLM` — counter-based (stateless) generation: batch for
    step ``s``, data-parallel rank ``r`` is a pure function of
    ``(seed, s, r)``.  Restart at any step reproduces the exact stream with
    zero state — the strongest checkpointability you can have.
  * :class:`MemmapCorpus` — fixed token file (np.memmap), deterministic
    strided reads per (step, rank); state is just the step counter.

Both emit ``{"tokens": int32 [per_rank_batch, seq_len+?]}``; a background
prefetch thread keeps ``depth`` batches ready (overlap host data work with
device compute).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic tokens with enough structure for loss to fall."""

    def __init__(self, vocab: int, seq_len: int, batch_per_rank: int,
                 seed: int = 0, rank: int = 0, num_ranks: int = 1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch_per_rank
        self.seed = seed
        self.rank = rank
        self.num_ranks = num_ranks

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.rank]))
        B, T, V = self.batch, self.seq_len, self.vocab
        # structured stream: random walk over the vocab with repetitions —
        # learnable short-range correlations.
        start = rng.integers(0, V, size=(B, 1))
        steps = rng.integers(-3, 4, size=(B, T - 1))
        toks = np.concatenate([start, steps], axis=1).cumsum(axis=1) % V
        return {"tokens": toks.astype(np.int32)}

    def state(self, step: int) -> Dict:
        return {"step": step, "seed": self.seed}


class MemmapCorpus:
    def __init__(self, path: str, seq_len: int, batch_per_rank: int,
                 rank: int = 0, num_ranks: int = 1):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.batch = batch_per_rank
        self.rank = rank
        self.num_ranks = num_ranks
        self.n_seq = len(self.data) // seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, T = self.batch, self.seq_len
        base = (step * self.num_ranks + self.rank) * B
        idx = (base + np.arange(B)) % self.n_seq
        toks = np.stack([self.data[i * T:(i + 1) * T] for i in idx])
        return {"tokens": toks.astype(np.int32)}

    def state(self, step: int) -> Dict:
        return {"step": step}


class Prefetcher:
    """Background thread keeping ``depth`` upcoming batches ready."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
