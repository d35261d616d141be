"""Data pipeline: deterministic synthetic LM token streams with sharded,
double-buffered host loading (copied from ``repro.train.data``: numpy only,
the same tokens bit for bit).

Production shape: every (host, step) pair derives its batch shard from a
stateless counter-based RNG, so restarts resume mid-epoch bit-exactly from
the checkpointed step (no data-loader state to save), stragglers can't skew
the stream, and elastic re-sharding just re-partitions the index space.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure: orderly enough that a model can reduce loss
    ngram: int = 3


def batch_for_step(cfg: DataConfig, step: int,
                   lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
    """Tokens for sequences [lo, hi) of the step's global batch.

    Counter-based: tokens = f(seed, step, sequence_index) -- no stream state.
    The synthetic distribution is an ngram-ish recurrence so cross-entropy
    is learnable (used by the convergence example/test).
    """
    hi = cfg.global_batch if hi is None else hi
    rows = []
    for idx in range(lo, hi):
        # one Philox counter per (step, sequence): shard boundaries cannot
        # change the stream => elastic re-sharding is bit-exact
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=np.array([step, idx, 0, 0], np.uint64)))
        base = rng.integers(0, cfg.vocab, size=cfg.seq_len, dtype=np.int64)
        toks = base
        # ngram-ish recurrence: most tokens are a deterministic mix of the
        # previous tokens (predictable => loss can fall well below ln(V))
        for k in range(1, cfg.ngram):
            mix = np.roll(toks, k) * (k + 7)
            toks = np.where(rng.random(cfg.seq_len) < 0.8,
                            (mix + 13) % cfg.vocab, toks)
        toks[0] = base[0]
        rows.append(toks)
    return np.stack(rows).astype(np.int32)


class Loader:
    """Double-buffered background loader for one host's batch shard."""

    def __init__(self, cfg: DataConfig, lo: int = 0, hi: Optional[int] = None,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.lo, self.hi = lo, hi
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, step, self.lo, self.hi)
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
