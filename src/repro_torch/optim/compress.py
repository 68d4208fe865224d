"""8-bit gradient compression with error feedback
(``repro.optim.compress``): the data axis's optional int8 wire.

A tensor is flattened, zero-padded to a multiple of ``block`` and cut
into blocks; each block keeps an fp32 scale, its max |x| over 127, and
its elements as ``round(x / scale)`` (half to even, as ``jnp.round``)
clipped to ±127 in int8.  Error feedback re-injects each step's
quantization residual ``e' = (g + e) − Q(g + e)`` into the next step's
gradient (Karimireddy et al., 2019).  ``dist/grad_sync.py`` ships the
int8 payloads and the scales (:class:`~repro_torch.dist.grad_sync.
Int8Conduit`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def compress_8bit(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q: int8 (padded_n,), scale: fp32 (n_blocks,))."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = scale.clamp_min(1e-12)
    q = torch.round(blocks / safe[:, None]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(-1), scale


def decompress_8bit(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], block: int = 256) -> torch.Tensor:
    """The fp32 tensor of ``shape`` that ``(q, scale)`` encode."""
    blocks = q.reshape(-1, block).float() * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(tuple(shape))


def ef_init(grads: Sequence[torch.Tensor]) -> list:
    """Error-feedback residuals shaped like the gradients (fp32 zeros)."""
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in grads]


def ef_compress_update(grads: Sequence[torch.Tensor],
                       ef_state: Sequence[torch.Tensor], block: int = 256
                       ) -> Tuple[list, list]:
    """Error feedback: ``g' = Q(g + e)``, ``e' = (g + e) − g'``, leaf by
    leaf.  Returns (the quantized-then-dequantized gradients in their own
    dtypes, the new residuals)."""
    out, res = [], []
    for g, e in zip(grads, ef_state):
        corrected = g.float() + e
        q, s = compress_8bit(corrected, block)
        deq = decompress_8bit(q, s, g.shape, block)
        out.append(deq.to(g.dtype))
        res.append(corrected - deq)
    return out, res


def compressed_bytes(n_elements: int, block: int = 256) -> int:
    """Wire bytes of a compressed tensor (int8 payload + fp32 scales)."""
    n_blocks = -(-n_elements // block)
    return n_blocks * block + 4 * n_blocks


__all__ = ["compress_8bit", "compressed_bytes", "decompress_8bit",
           "ef_compress_update", "ef_init"]
