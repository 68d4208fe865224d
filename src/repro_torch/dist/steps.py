"""Single-device serving steps: what ``repro.dist.steps``'s builders mean on
one GPU with no mesh and no jit.

The reference builds jitted, sharded steps with donated caches; here each
is a plain function that updates the cache in place where the reference
donated it.  The chunk step (``build_prefill_chunk_step``) is
``models.prefill.prefill_chunk`` itself.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decode import decode_step

Params = Dict[str, Any]
Cache = Dict[str, Any]


def serve_step(cfg: ModelConfig, params: Params, cache: Cache,
               tokens: torch.Tensor) -> Tuple[Cache, torch.Tensor]:
    """One batched decode step, greedy-sampled on the device: returns the
    cache and the (B,) int32 next-token ids (``build_serve_step`` with
    ``sample=True``)."""
    cache, logits = decode_step(cfg, params, cache, tokens)
    return cache, torch.argmax(logits, dim=-1).to(torch.int32)


def slot_write(cache: Cache, slot_cache: Cache, i: int) -> Cache:
    """Write every leaf of a batch-1 cache into row ``i`` of the contiguous
    batched cache, in place (``build_slot_write_step``): the per-row
    bookkeeping ``pos``/``slot_pos`` carries the batch on axis 0, the
    (L, B, ...) layer stacks (``k``/``v``, ``ssm_state``/``conv_state``)
    on axis 1."""
    for name, leaf in cache.items():
        axis = 0 if name in ("pos", "slot_pos") else 1
        leaf.select(axis, i).copy_(slot_cache[name].select(axis, 0))
    return cache


def block_write(cache: Cache, bk: torch.Tensor, bv: torch.Tensor,
                dst: torch.Tensor, table_row: torch.Tensor,
                slot_pos_row: torch.Tensor, pos: torch.Tensor,
                i: int) -> Cache:
    """Push finished prefill blocks ``bk``/``bv`` (L, n, Hkv, blk, hd) into
    pool ids ``dst`` (n,) and install row ``i``'s block table and
    bookkeeping (``build_block_write_step``)."""
    dst = dst.long()
    cache["kp"][:, dst] = bk.to(cache["kp"].dtype)
    cache["vp"][:, dst] = bv.to(cache["vp"].dtype)
    cache["block_ids"][i] = table_row
    cache["slot_pos"][i] = slot_pos_row
    cache["pos"][i] = pos
    return cache


def park_row(cache: Cache, i: int) -> Cache:
    """Point row ``i``'s table at its own parking block and clear its
    bookkeeping, so a retired row's dead decode writes touch no live block."""
    cache["block_ids"][i] = i
    cache["slot_pos"][i] = -1
    cache["pos"][i] = 0
    return cache
