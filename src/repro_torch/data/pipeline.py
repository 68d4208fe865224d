"""Synthetic LM data: deterministic, step-indexed, shard-aware
(``repro.data.pipeline``).

The batch for step *k* is a pure function of ``(seed, k, shard)``: each
batch draws from its own ``torch.Generator`` seeded from those three, so
the pipeline carries no state and any rank can regenerate any step's
batch.  The distribution is the reference's: a fixed bank of ``n_grams``
random n-grams, sequences built from n-gram slots, and a ``noise_prob``
share of tokens replaced by uniform noise.  The numbers differ from the
reference's ``jax.random`` draws; tests that compare the two feed the
reference's batches to both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

_MASK63 = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_grams: int = 64          # distinct memorizable n-grams
    gram_len: int = 8
    noise_prob: float = 0.1


def _mix(*parts: int) -> int:
    """A 63-bit generator seed from a few small integers."""
    h = 0x243F6A8885A308D3
    for p in parts:
        h = ((h ^ (int(p) & _MASK63)) * 0x100000001B3) & _MASK63
    return h


class SyntheticLM:
    """``batch(step, shard, n_shards)`` → tokens/labels (int64, CPU) of
    that data shard; ``tokens`` and ``labels`` are ``seq_len − 1`` long
    (the labels are the tokens shifted by one)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        gen = torch.Generator().manual_seed(_mix(cfg.seed, 0xC0FFEE))
        self.grams = torch.randint(0, cfg.vocab_size,
                                   (cfg.n_grams, cfg.gram_len),
                                   generator=gen)

    def _tokens(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        cfg = self.cfg
        n_slots = -(-cfg.seq_len // cfg.gram_len)
        slot_ids = torch.randint(0, cfg.n_grams, (batch, n_slots),
                                 generator=gen)
        seq = self.grams[slot_ids].reshape(batch, n_slots * cfg.gram_len)
        seq = seq[:, :cfg.seq_len]
        noise = torch.randint(0, cfg.vocab_size, seq.shape, generator=gen)
        mask = torch.rand(seq.shape, generator=gen) < cfg.noise_prob
        return torch.where(mask, noise, seq)

    def batch(self, step: int, shard: int = 0,
              n_shards: int = 1) -> Dict[str, torch.Tensor]:
        """Deterministic batch for ``step``, this data shard's rows only."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_shards} shards")
        per = cfg.global_batch // n_shards
        gen = torch.Generator().manual_seed(_mix(cfg.seed, step, shard))
        toks = self._tokens(gen, per)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """All rows of the step's batch (one data shard)."""
        return self.batch(step, 0, 1)


__all__ = ["DataConfig", "SyntheticLM"]
