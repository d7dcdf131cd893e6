"""Deterministic sharded data pipeline (``repro.train.data``, which is numpy
only, copied whole so the port imports nothing of the JAX package).

Restart/straggler contract: batch content is a pure function of
(seed, step, shard) — no iterator state. A restarted or replaced host
resumes at any step and reproduces exactly the batches it would have seen;
that determinism is what makes checkpoint-restart and elastic rescale exact
(tested in tests/test_fault_tolerance.py).

Two sources:
* SyntheticLM — hashed token stream (CI / examples; no files needed).
* TokenFile   — np.memmap over a flat binary token file, strided
  deterministically by (step, shard).

``prefetch`` wraps either in a background-thread queue so host-side batch
assembly overlaps device compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    path: Optional[str] = None      # None -> synthetic
    frontend: str = "tokens"        # tokens | frames
    frontend_dim: int = 0


class SyntheticLM:
    """Deterministic pseudo-text: next-token structure is learnable
    (affine-mod sequences with noise) so example losses visibly drop."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, shard: int, n_shards: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        if cfg.frontend == "frames":
            frames = rng.standard_normal(
                (b, cfg.seq_len, cfg.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, cfg.vocab, (b, cfg.seq_len), dtype=np.int32)
            return {"frames": frames, "labels": labels}
        start = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int64)
        stride = rng.integers(1, 7, (b, 1), dtype=np.int64)
        seq = (start + stride * np.arange(cfg.seq_len + 1)) % cfg.vocab
        noise = rng.random((b, cfg.seq_len + 1)) < 0.05
        seq = np.where(noise, rng.integers(0, cfg.vocab, seq.shape), seq)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}


class TokenFile:
    """Flat binary token file (uint16/uint32), deterministic strided reads."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch(self, step: int, shard: int, n_shards: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        # window indices: a fixed permutation-free stride pattern keyed by step
        base = (step * cfg.global_batch + shard * b) % self.n_windows
        idx = (base + np.arange(b)) % self.n_windows
        toks = np.stack([
            self.data[i * cfg.seq_len: i * cfg.seq_len + cfg.seq_len + 1]
            for i in idx]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_source(cfg: DataConfig):
    return TokenFile(cfg) if cfg.path else SyntheticLM(cfg)


def prefetch(source, start_step: int, shard: int, n_shards: int,
             depth: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetch: keeps ``depth`` host batches ready."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(source.batch(step, shard, n_shards), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
