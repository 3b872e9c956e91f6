"""Deterministic synthetic LM data pipeline.

Port of ``repro.training.data``: numpy only, the same arithmetic, so one
seed gives the JAX package's tokens.

Production properties the trainer relies on:
  * deterministic & seekable — batch(step) is a pure function of
    (seed, step), so resume-after-failure re-produces the exact stream
    without replaying it;
  * host-shardable — each data-parallel rank draws only its slice;
  * straggler mitigation — `DeadlineIterator` drops batches whose
    producer missed a deadline (skipped steps are logged, training
    continues on the next batch — the standard large-fleet policy of
    trading samples for synchrony).

The token stream is a mixture of repeated n-gram motifs over the vocab so
the LM loss decreases measurably within a few hundred steps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_motifs: int = 64            # distinct repeated patterns
    motif_len: int = 16


class SyntheticLM:
    """batch(step) -> tokens [global_batch, seq_len] int32 (deterministic)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len), dtype=np.int32)

    def batch(self, step: int, *, rank: int = 0, world: int = 1) -> np.ndarray:
        cfg = self.cfg
        assert cfg.global_batch % world == 0
        b_loc = cfg.global_batch // world
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, rank]))
        n_tiles = -(-cfg.seq_len // cfg.motif_len)
        ids = rng.integers(0, cfg.n_motifs, (b_loc, n_tiles))
        toks = self._motifs[ids].reshape(b_loc, -1)[:, :cfg.seq_len]
        # light noise keeps the task from being trivially memorized
        noise = rng.random((b_loc, cfg.seq_len)) < 0.02
        toks = np.where(noise,
                        rng.integers(0, cfg.vocab_size, toks.shape), toks)
        return toks.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class DeadlineIterator:
    """Wrap a (step -> batch) source with a per-batch deadline; a miss skips
    the batch (straggler mitigation). `clock`/`produce_time` are injectable
    for tests."""

    def __init__(self, source: SyntheticLM, deadline_s: float,
                 produce: Optional[Callable[[int], Tuple[np.ndarray, float]]] = None):
        self.source = source
        self.deadline_s = deadline_s
        self._produce = produce
        self.skipped = []

    def batch(self, step: int, **kw) -> Optional[np.ndarray]:
        if self._produce is not None:
            data, elapsed = self._produce(step)
        else:
            t0 = time.monotonic()
            data = self.source.batch(step, **kw)
            elapsed = time.monotonic() - t0
        if elapsed > self.deadline_s:
            self.skipped.append(step)
            return None
        return data
