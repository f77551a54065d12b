"""Deterministic, resumable data pipeline: synthetic LM stream + memmap corpus.

Port of ``repro.data.pipeline``: the port's own copy, numpy only, giving
the reference's batches bitwise.  A batch is host numpy arrays; the
training loop moves it to the model's device.

Determinism contract (fault tolerance depends on it): batch ``i`` of a source
is a pure function of ``(seed, i)`` -- after a crash+restore at step ``s`` the
loop asks for batch ``s`` and gets exactly what it would have seen.  Host
sharding slices each global batch by ``(host_id, host_count)`` so every host
feeds its addressable devices only.  A background prefetch thread keeps
``depth`` batches in flight (overlaps host data work with device steps).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    host_count: int = 1


class SyntheticLM:
    """Markov-ish synthetic token stream (structure so loss can decrease)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # fixed bigram transition table: each token has 8 likely successors
        self._succ = base.integers(0, cfg.vocab, size=(cfg.vocab, 8), dtype=np.int64)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        local = cfg.global_batch // cfg.host_count
        lo = cfg.host_id * local
        tokens = np.empty((local, cfg.seq_len + 1), np.int32)
        start = rng.integers(0, cfg.vocab, size=(cfg.global_batch,))
        choices = rng.integers(0, 8, size=(cfg.global_batch, cfg.seq_len))
        noise = rng.random((cfg.global_batch, cfg.seq_len)) < 0.1
        rand_tok = rng.integers(0, cfg.vocab, size=(cfg.global_batch, cfg.seq_len))
        for b in range(local):
            g = lo + b
            t = start[g]
            tokens[b, 0] = t
            for s in range(cfg.seq_len):
                t = rand_tok[g, s] if noise[g, s] else self._succ[t, choices[g, s]]
                tokens[b, s + 1] = t
        return {"tokens": tokens}


class MemmapCorpus:
    """Pre-tokenized flat corpus (uint16/uint32 .bin); random crops by index."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        if len(self.data) < cfg.seq_len + 2:
            raise ValueError("corpus shorter than one sequence")

    def batch(self, index: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        local = cfg.global_batch // cfg.host_count
        lo = cfg.host_id * local
        starts = rng.integers(0, len(self.data) - cfg.seq_len - 1, size=cfg.global_batch)
        out = np.stack(
            [
                np.asarray(self.data[s : s + cfg.seq_len + 1], np.int32)
                for s in starts[lo : lo + local]
            ]
        )
        return {"tokens": np.minimum(out, cfg.vocab - 1)}


class Prefetcher:
    """Background-thread prefetch of source.batch(i) for i = start, start+1, ..."""

    def __init__(self, source, start: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = self._next
        while not self._stop.is_set():
            try:
                self._q.put((i, self.source.batch(i)), timeout=0.2)
                i += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
