"""Fused collective matmuls by hand-written CUDA kernels (the whole ring
in one kernel on a card whose ranks map each other's memory, else the hop
consumed by a kernel), conduit transport family ``fused``."""

from repro_torch.kernels.cc_matmul.ops import (
    AG_MATMUL_RING,
    CONSUME_MATMUL,
    CONSUME_MATMUL_ACC,
    HOP_KERNELS,
    KERNELS,
    MATMUL_TILE,
    PLAIN_CALLS,
    RING_KERNELS,
    RS_MATMUL_RING,
    ag_matmul_ring,
    allgather_matmul_fused,
    consume_matmul,
    consume_matmul_acc,
    launches,
    matmul_reducescatter_fused,
    matmul_tile,
    reset_counts,
    rs_matmul_ring,
)
from repro_torch.kernels.cc_matmul.ref import (
    allgather_matmul_ref,
    consume_matmul_acc_plain,
    consume_matmul_plain,
    matmul_reducescatter_ref,
    matmul_tile_plain,
)

__all__ = [
    "AG_MATMUL_RING", "CONSUME_MATMUL", "CONSUME_MATMUL_ACC", "HOP_KERNELS",
    "KERNELS", "MATMUL_TILE", "PLAIN_CALLS", "RING_KERNELS",
    "RS_MATMUL_RING", "ag_matmul_ring", "allgather_matmul_fused",
    "allgather_matmul_ref", "consume_matmul", "consume_matmul_acc",
    "consume_matmul_acc_plain", "consume_matmul_plain", "launches",
    "matmul_reducescatter_fused", "matmul_reducescatter_ref", "matmul_tile",
    "matmul_tile_plain", "reset_counts", "rs_matmul_ring",
]
