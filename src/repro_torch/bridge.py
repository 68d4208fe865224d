"""Reference parameters → port parameters.

Takes the reference's parameter pytree with numpy leaves (``layers`` leaves
stacked on a leading layer axis by ``lax.scan``, the hybrid's
``shared_blocks`` on a leading block axis, the encoder-decoder's
``enc_layers`` and ``dec_layers`` each on its own) and returns the port's
dict of tensors with each stack as a list of per-layer (per-block) dicts;
every other leaf (``frontend_proj``, ``dec_pos``, a LayerNorm's ``scale``
and ``bias``) goes across as it is.  bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects; they go across bit for bit through a 16-bit integer view.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike


def to_tensor(a: Any, device: DeviceLike = "cpu") -> torch.Tensor:
    """One numpy leaf → tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(node: Any, device: DeviceLike) -> Any:
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def _unstack(node: Any, i: int) -> Any:
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _unstack_all(stacked: Any, device: DeviceLike) -> list:
    """A stacked subtree → one dict per index of its leading axis (read
    off any leaf)."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_tree(_unstack(stacked, i), device)
            for i in range(np.asarray(leaf).shape[0])]


#: the stacked subtrees of the reference's parameter pytree
STACKED = ("layers", "shared_blocks", "enc_layers", "dec_layers")


def params_from_reference(tree: Dict[str, Any],
                          device: DeviceLike = "cpu") -> Dict[str, Any]:
    """The reference's parameter pytree (numpy leaves) → the port's
    parameters on ``device``: each stack of :data:`STACKED` it holds as a
    list of per-layer (per-block) dicts."""
    out = {k: _tree(v, device) for k, v in tree.items() if k not in STACKED}
    for k in STACKED:
        if k in tree:
            out[k] = _unstack_all(tree[k], device)
    return out


def shard_params(tree: Dict[str, Any], rank: int, size: int,
                 device: DeviceLike = "cpu", axis: str = "model", *,
                 scheme: Optional[str] = None) -> Dict[str, Any]:
    """The reference's full parameter pytree (numpy leaves) → rank
    ``rank``'s shard of it in the port's layout, under the placement of
    ``repro_torch.dist.sharding`` on ``axis``: ``model`` (TP, under the
    TP path ``scheme``, ``"xla"`` or ``"art"``, which it needs) or
    ``expert`` (a MoE model's routed experts split over the group)."""
    from repro_torch.dist.sharding import shard_tree

    return shard_tree(params_from_reference(tree, device), rank, size, axis,
                      scheme=scheme)
