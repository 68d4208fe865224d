"""The vocab-parallel embedding and LM head of a model line (the
reference's rule table: ``embed`` is ``(model, data)`` and ``lm_head``
``(data, model)``, ``repro/dist/sharding.py``).

Rank r of a line of n holds the vocab ids ``[r·V/n, (r+1)·V/n)``: the
rows of ``embed`` (V, D) and the columns of ``lm_head`` (D, V), or, tied,
the rows of ``embed`` that its head reads transposed.

* The embedding (:meth:`VocabParallel.partial`, then
  ``tp_block.SeqLine.embed``): every rank looks up every token of the
  line's sequence in its own rows, with zeros for the ids it does not
  hold, and the (B, S, D) partials are reduce-scattered over the
  sequence on the line (the conduit's differentiable
  ``reduce_scatter``, whose backward is the all-gather), which leaves each
  rank its (B, S/n, D) rows.  At most one rank's partial of a row is
  not zero, so the sum is exact: the rows equal the replicated lookup's
  bit for bit.  Backward scatters the gathered cotangent into the rank's
  own rows only, so the shard's gradient is complete on the rank.
* The head (:meth:`VocabParallel.logits`): the AG ring edge of the TP
  blocks (``artblock.ag_edge``, ``kernels/cc_matmul``) with N = V/n: the
  logits of the line's gathered rows over the rank's vocab columns.  Its
  backward is the fused RS ring for dh and a local weight gradient.  On
  the ``xla`` conduit (``models/tp_block.py``'s path) the rows are
  all-gathered and multiplied, as the reference's GSPMD head.
  ``dist/loss.py`` combines the ranks' log-sum-exps per token.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.conduit import Conduit
from repro_torch.models.artblock import ag_edge


@dataclasses.dataclass(frozen=True)
class VocabParallel:
    """A model line's vocab split: ``conduit`` over the line (the TP
    blocks' conduit), ``vocab`` the logical vocab size (a multiple of the
    line's extent)."""

    conduit: Conduit
    vocab: int

    def __post_init__(self):
        if self.vocab % self.size:
            raise ValueError(f"vocab {self.vocab} does not split over "
                             f"{self.size} ranks")

    @property
    def size(self) -> int:
        return self.conduit.axis.size

    @property
    def rank(self) -> int:
        return self.conduit.axis.rank

    @property
    def part(self) -> int:
        """Vocab ids a rank holds."""
        return self.vocab // self.size

    @property
    def lo(self) -> int:
        """This rank's first vocab id."""
        return self.rank * self.part

    def local_ids(self, ids: torch.Tensor):
        """(``ids`` as rows of this rank's shard, clamped into it; where
        this rank holds the id)."""
        rel = ids - self.lo
        own = (rel >= 0) & (rel < self.part)
        return rel.clamp(0, self.part - 1), own

    def partial(self, shard: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """``shard`` (V/n, D) this rank's rows of ``embed``, ``tokens``
        (B, S) → (B, S, D): the rows of the ids this rank holds, zeros for
        the rest (the line reduce-scatters them: ``tp_block.SeqLine``)."""
        idx, own = self.local_ids(tokens)
        return torch.where(own[..., None], shard[idx], shard.new_zeros(()))

    def logits(self, h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """``h`` (B, b, D) this rank's rows, ``head`` (D, V/n) its vocab
        columns (contiguous) → (B, n·b, V/n): the line's gathered rows
        (rank j's b rows at ``[j·b, (j+1)·b)``) over its columns.  On the
        ``xla`` conduit (the reference's GSPMD path: the ``logit_hidden``
        constraint) the rows' ``all_gather`` and then the product, in
        ``h``'s dtype; on any other the AG edge, in fp32."""
        if self.conduit.transport == "xla":
            return self.conduit.all_gather(h, dim=1) @ head
        return ag_edge(h, head, self.conduit)


__all__ = ["VocabParallel"]
