"""Data pipeline (a numpy copy of ``repro.data.pipeline``, whose batches
it reproduces byte for byte): deterministic synthetic token streams
(per-shard seeded, restart-reproducible) and a file-backed tokenized
dataset with sharded sequential readers + host-side prefetch.

At dry-run scale each data-parallel rank draws only its own shard — the
pipeline is a pure function of (seed, step, shard), so checkpoint restart
and elastic re-sharding (different #ranks) replay identical global streams.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    """Markov-ish synthetic stream: deterministic in (seed, step, shard)."""

    def __init__(self, cfg: DataConfig, n_shards: int = 1, shard: int = 0):
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard = shard
        assert cfg.global_batch % n_shards == 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // self.n_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 997 + self.shard) % 2**31)
        # structured stream (random walk over vocab) => learnable bigrams
        start = rng.randint(0, cfg.vocab, size=(b, 1))
        steps = rng.randint(-8, 9, size=(b, cfg.seq_len))
        toks = (np.cumsum(np.concatenate([start, steps[:, :-1]], axis=1),
                          axis=1) % cfg.vocab).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        return {"tokens": toks, "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class FileDataset:
    """Flat .bin of int32 tokens; each shard reads a strided window."""

    def __init__(self, path: str, cfg: DataConfig, n_shards: int = 1,
                 shard: int = 0):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard = shard

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // self.n_shards
        span = cfg.seq_len + 1
        n_windows = len(self.tokens) // span
        idx = (step * cfg.global_batch + self.shard * b
               + np.arange(b)) % n_windows
        rows = np.stack([self.tokens[i * span:(i + 1) * span] for i in idx])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


class Prefetcher:
    """Host-side background prefetch (overlap input with step compute)."""

    def __init__(self, source, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            it = iter(source)
            while not self._stop.is_set():
                try:
                    self.q.put(next(it), timeout=0.5)
                except queue.Full:
                    continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self, timeout: float = 30.0):
        return self.q.get(timeout=timeout)

    def close(self):
        self._stop.set()
