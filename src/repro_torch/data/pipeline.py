"""Deterministic, shardable data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; batches stay numpy and the trainer
loop moves them to the device).

Two sources:
  SyntheticLM        — seeded Markov-ish token stream (no I/O; used by tests
                       and the training runs). Deterministic in (seed, step,
                       host) so restarts resume bit-identically and every
                       data-parallel host draws a disjoint slice.
  BinaryTokenDataset — packed uint16/uint32 token files (memory-mapped), sequence-
                       chunked, host-sharded. The "real data" path.

Both yield host-local numpy batches (a host's slice of the global batch; one
host takes the whole batch). ``batch_at`` draws the same tokens as the
reference's for the same (config, step, host).

Prefetching: a bounded queue filled by a background thread (keeps the host
busy while the device runs the step).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    vocab: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | binary
    path: Optional[str] = None
    dtype: str = "uint16"


class SyntheticLM:
    """Deterministic pseudo-natural token stream.

    Tokens follow a power-law unigram mixed with a shift-register "grammar" so a
    model can actually reduce loss (tests assert learning works). Batch at step t
    on host h depends only on (seed, t, h).
    """

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.batch // num_hosts
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id])
        )
        b, s = self.local_batch, self.cfg.seq
        base = rng.choice(self.cfg.vocab, size=(b, s + 1), p=self._probs)
        # inject learnable structure: token[t] == token[t-3] with prob .5
        copy_mask = rng.random((b, s + 1)) < 0.5
        for t in range(3, s + 1):
            base[:, t] = np.where(copy_mask[:, t], base[:, t - 3], base[:, t])
        return {"tokens": base.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class BinaryTokenDataset:
    """Memory-mapped packed token file → (batch, seq+1) windows, host-sharded."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.path is not None
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.batch // num_hosts
        self.tokens = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id])
        )
        idx = rng.integers(0, self.n_windows, size=(self.local_batch,))
        rows = np.stack(
            [self.tokens[i * self.cfg.seq : i * self.cfg.seq + self.cfg.seq + 1] for i in idx]
        )
        return {"tokens": rows.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Prefetcher:
    def __init__(self, src, start_step: int = 0, depth: int = 2):
        self.src = src
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.src.batch_at(s)
            self.q.put((s, batch))
            s += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def make_pipeline(cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1,
                  start_step: int = 0, prefetch: bool = True):
    src = (
        SyntheticLM(cfg, host_id, num_hosts)
        if cfg.source == "synthetic"
        else BinaryTokenDataset(cfg, host_id, num_hosts)
    )
    if prefetch:
        return _Prefetcher(src, start_step=start_step)
    def gen():
        s = start_step
        while True:
            yield s, src.batch_at(s)
            s += 1
    return gen()
