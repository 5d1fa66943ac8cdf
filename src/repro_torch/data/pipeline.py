"""Deterministic, restart-exact data pipeline (a copy of
``repro.data.pipeline``, which is numpy only: the port imports nothing of
the JAX package).

The batch for global step ``s`` is a pure function of ``(seed, s)`` — no
iterator state — so a job restored from a step-``s`` checkpoint replays
exactly the batches that would have followed (restart-exact).
Each data-parallel host slices its shard of the global batch by rank, so
the pipeline scales horizontally with zero coordination.

Two sources:
  * ``SyntheticLM`` — a seeded Zipf-ish Markov token stream (structured
    enough that a model's loss visibly falls; used by the end-to-end
    training example).
  * ``TokenFileSource`` — a memory-mapped flat token file (uint16/uint32),
    chunked into (seq+1)-grams indexed by a seeded permutation per epoch.

Both emit numpy ``{inputs, targets, positions}`` matching
``models.model.loss_fn``; the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng_for(seed: int, step: int, rank: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, rank)))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Order-1 Markov chain over ``vocab`` with a Zipf marginal — cheap,
    deterministic, and learnable (bigram structure)."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pos_dims: int = 1
    frontend_dim: int | None = None    # emit float frames instead of tokens

    def _transition(self, rng: np.random.Generator, tokens: np.ndarray
                    ) -> np.ndarray:
        # next ∼ 0.7·(affine map of current) + 0.3·Zipf noise
        det = (tokens * 31 + 17) % self.vocab
        noise = (rng.zipf(1.5, size=tokens.shape) - 1) % self.vocab
        pick = rng.random(tokens.shape) < 0.7
        return np.where(pick, det, noise)

    def batch_at(self, step: int, *, rank: int = 0, world: int = 1) -> dict:
        assert self.global_batch % world == 0
        b = self.global_batch // world
        # generate the GLOBAL batch from (seed, step) and slice the rank's
        # rows — rank shards are exact slices of the world=1 batch, so any
        # host count produces bit-identical global data (restart-exact
        # under elastic rescaling). Synthetic generation is cheap enough
        # that the redundant work doesn't matter.
        rng = _rng_for(self.seed, step)
        toks = np.empty((self.global_batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.global_batch)
        for t in range(self.seq_len):
            toks[:, t + 1] = self._transition(rng, toks[:, t])
        toks = toks[rank * b:(rank + 1) * b]
        pos = np.broadcast_to(np.arange(self.seq_len, dtype=np.int32),
                              (b, self.seq_len)).copy()
        if self.pos_dims > 1:
            pos = np.stack([pos] * self.pos_dims, axis=-1)
        if self.frontend_dim is not None:
            # stub modality frontend: embed tokens as random-projected
            # one-hots (deterministic in the token id)
            proj = _rng_for(self.seed, -1).normal(
                0, 1, (self.vocab, self.frontend_dim)).astype(np.float32)
            inputs = proj[toks[:, :-1]]
        else:
            inputs = toks[:, :-1]
        return dict(inputs=inputs, targets=toks[:, 1:], positions=pos)


@dataclasses.dataclass(frozen=True)
class TokenFileSource:
    """Memory-mapped token corpus → shuffled (seq+1)-gram batches."""
    path: str
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dtype: str = "uint16"

    def _tokens(self) -> np.ndarray:
        return np.memmap(self.path, dtype=self.dtype, mode="r")

    def n_chunks(self) -> int:
        return len(self._tokens()) // (self.seq_len + 1)

    def batch_at(self, step: int, *, rank: int = 0, world: int = 1) -> dict:
        assert self.global_batch % world == 0
        b = self.global_batch // world
        n = self.n_chunks()
        toks = self._tokens()
        gb = self.global_batch
        epoch = (step * gb) // n
        offset = (step * gb) % n
        perm_rng = _rng_for(self.seed, epoch)
        perm = perm_rng.permutation(n)
        idx = perm[(offset + rank * b + np.arange(b)) % n]
        rows = np.stack([
            toks[i * (self.seq_len + 1):(i + 1) * (self.seq_len + 1)]
            for i in idx]).astype(np.int32) % self.vocab
        pos = np.broadcast_to(np.arange(self.seq_len, dtype=np.int32),
                              (b, self.seq_len)).copy()
        return dict(inputs=rows[:, :-1], targets=rows[:, 1:], positions=pos)
