"""Plain versions of the fused collective matmul's hop kernels, and the
group-level oracles (``repro.kernels.cc_matmul.kernel`` / ``ref``).

The three hop functions are the kernels' plain PyTorch versions: the CPU
path of the wrappers in ``ops.py`` and what ``chip_smoke.py`` holds the
CUDA kernels to.  Each takes an optional leading batch dim (the
reference's ``jax.vmap`` over B, written out) and computes in fp32.

The oracles are the unfused compositions: a plain ``all_gather`` or
reduce-scatter on the group with a plain matmul.  They are the plain
versions of the two whole-ring kernels (the CPU path of
``ag_matmul_ring``/``rs_matmul_ring``).  When a card is present nothing on
the training path calls them.
"""

from __future__ import annotations

import torch


def matmul_tile_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dot(x, w)`` in fp32: x (b, K) or (B, b, K), w (K, N)."""
    return torch.matmul(x.float(), w.float())


def consume_matmul_plain(scratch: torch.Tensor, w: torch.Tensor, *,
                         slot: int) -> torch.Tensor:
    """AG hop consume, ``dot(scratch[slot], w)`` in fp32: scratch
    (2, b, K) or (2, B, b, K)."""
    return torch.matmul(scratch[slot].float(), w.float())


def consume_matmul_acc_plain(scratch: torch.Tensor, x: torch.Tensor,
                             w: torch.Tensor, *, slot: int) -> torch.Tensor:
    """RS hop consume, ``scratch[slot] + dot(x, w)`` in fp32 (the add order
    of the reference: arrived + dot): scratch (2, b, N) or (2, B, b, N)
    fp32."""
    return scratch[slot].float() + torch.matmul(x.float(), w.float())


def allgather_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                         group) -> torch.Tensor:
    """``all_gather(x) @ w`` materialized: rows on x's second-to-last dim,
    (…, b, K) → (…, n·b, N_loc) fp32."""
    full = group.all_gather(x, dim=x.dim() - 2)
    return torch.matmul(full.float(), w.float())


def matmul_reducescatter_ref(x: torch.Tensor, w: torch.Tensor,
                             group) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` materialized: (…, n·b, K_loc) →
    (…, b, N) fp32; rank q keeps row block q of the group's sum."""
    partial = torch.matmul(x.float(), w.float())
    total = group.all_reduce(partial)
    b = total.shape[-2] // group.size
    return total[..., group.rank * b:(group.rank + 1) * b, :].contiguous()


__all__ = ["allgather_matmul_ref", "consume_matmul_acc_plain",
           "consume_matmul_plain", "matmul_reducescatter_ref",
           "matmul_tile_plain"]
