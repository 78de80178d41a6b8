"""Synthetic deterministic token pipeline with double-buffered prefetch.

Batches are a pure function of (seed, step, shard), in numpy, so the port's
tokens are the reference's (``repro.data.pipeline``) bit for bit, and
restarts reproduce the exact stream.  Token statistics are Zipf-ish with
short-range repetition, so the LM loss actually falls.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig


def _tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-distributed tokens with short-range repetition structure."""
    z = rng.zipf(1.3, shape).astype(np.int64)
    toks = (z - 1) % vocab
    # inject copy structure: with p=0.3 repeat the previous token
    rep = rng.random(shape) < 0.3
    toks_shift = np.roll(toks, 1, axis=-1)
    toks = np.where(rep, toks_shift, toks)
    return toks.astype(np.int32)


def make_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int, step: int,
               shard: int = 0, n_shards: int = 1) -> dict:
    """One batch: tokens (B, S+1) int32 numpy, plus modality stubs."""
    rng = np.random.default_rng((seed * 1_000_003 + step) * 65_537 + shard)
    b = batch // n_shards
    out = {"tokens": _tokens(rng, (b, seq + 1), cfg.vocab_size)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        n_txt = max(seq - cfg.n_vision_tokens, 8)
        out["tokens"] = _tokens(rng, (b, n_txt + 1), cfg.vocab_size)
        out["patches"] = rng.normal(0, 1, (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


@dataclass
class SyntheticLM:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    def __iter__(self):
        step = 0
        while True:
            yield make_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                             step=step, shard=self.shard, n_shards=self.n_shards)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch (host-side overlap with compute).
    The filling thread is a daemon: it blocks on the full queue once the
    consumer stops reading, and dies with the process."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
