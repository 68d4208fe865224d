"""Analytic link model: the subset of ``repro.core.netmodel`` that the
conduit's cost model (``conduit.estimate_time``, ``matmul_edge_estimate``,
``pipeline_estimate`` and the ``auto`` policy) needs: the packet model
and the pipeline algebra.  Pure Python, formula for formula.

The link constants are the reference's modelled links: the FSHMEM QSFP+
link of the paper (Fig. 5, Table III) and the reference's ICI link.  They
price schedule decisions (which transport, chunk and direction split a
collective or a TP edge takes); they are not measurements of the port's
wire, which on one card is gloo staged through host memory.  The one
rate that is the card's own is :data:`DENSE_BF16_FLOPS`, which sizes a
TP edge's compute term.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    """Fixed per-message latency stages (seconds)."""

    t_host_cmd: float  # command issue -> scheduler -> sequencer
    t_dma: float       # payload read-DMA startup (long messages only)
    t_header: float    # header serialization + wire + remote check
    t_handler: float   # AM receive-handler turnaround
    t_sched: float     # reply-path scheduler/FIFO (no host involvement)

    @property
    def put_short(self) -> float:
        """Table III short-PUT latency (no payload DMA stage)."""
        return self.t_host_cmd + self.t_header

    @property
    def put_long(self) -> float:
        """Table III long-PUT latency (adds the read-DMA startup)."""
        return self.t_host_cmd + self.t_dma + self.t_header


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """A point-to-point link with packetized framing."""

    name: str
    line_rate: float                      # bytes/s raw
    line_efficiency: float                # encoding/framing ceiling
    packet_overhead_bytes: Dict[int, float]  # packet size -> overhead
    latency: LatencyParams

    @property
    def peak_bandwidth(self) -> float:
        """Ceiling imposed by line encoding, independent of packet size."""
        return self.line_rate * self.line_efficiency

    def overhead_bytes(self, packet_size: int) -> float:
        """Per-packet overhead; measured points exact, log-interp between."""
        table = self.packet_overhead_bytes
        if packet_size in table:
            return table[packet_size]
        keys = sorted(table)
        if packet_size <= keys[0]:
            return table[keys[0]]
        if packet_size >= keys[-1]:
            return table[keys[-1]]
        for lo, hi in zip(keys, keys[1:]):
            if lo < packet_size < hi:
                f = (math.log(packet_size) - math.log(lo)) / (
                    math.log(hi) - math.log(lo))
                return table[lo] * (1 - f) + table[hi] * f
        raise AssertionError  # unreachable

    def packet_time(self, packet_size: int) -> float:
        """Wire time of one packet: payload + per-packet overhead bytes."""
        return (packet_size + self.overhead_bytes(packet_size)) / self.line_rate


# The paper's QSFP+ link: 250 MHz x 128-bit datapath = 4 GB/s raw.
FSHMEM_QSFP = LinkParams(
    name="fshmem-qsfp+",
    line_rate=4.0e9,
    line_efficiency=3813.0 / 4000.0,
    packet_overhead_bytes={128: 67.4, 256: 43.5, 512: 25.1, 1024: 25.1},
    latency=LatencyParams(
        t_host_cmd=0.12e-6,
        t_dma=0.14e-6,
        t_header=0.09e-6,
        t_handler=0.03e-6,
        t_sched=0.12e-6,
    ),
)

# TPU v5e ICI, one link direction (the reference's second link class).
TPU_ICI = LinkParams(
    name="tpu-v5e-ici",
    line_rate=50.0e9,
    line_efficiency=0.95,
    packet_overhead_bytes={512: 64.0, 4096: 64.0, 65536: 64.0},
    latency=LatencyParams(
        t_host_cmd=0.0,
        t_dma=0.5e-6,
        t_header=1.0e-6,
        t_handler=0.2e-6,
        t_sched=0.3e-6,
    ),
)

def n_packets(size_bytes: int, packet_size: int) -> int:
    """⌈size/packet⌉, at least one packet."""
    return max(1, -(-size_bytes // packet_size))


def put_time(link: LinkParams, size_bytes: int, packet_size: int) -> float:
    """Command-to-completion time of gasnet_put of ``size_bytes``."""
    if size_bytes == 0:
        return link.latency.put_short
    wire = n_packets(size_bytes, packet_size) * link.packet_time(packet_size)
    wire = max(wire, size_bytes / link.peak_bandwidth)  # encoding ceiling
    return link.latency.put_long + wire


# ---------------------------------------------------------------------------
# the pipeline algebra (the ART overlap model, paper Sec. III-B)
# ---------------------------------------------------------------------------


def bulk_time(t_compute: float, t_comm: float, t_msg: float) -> float:
    """Baseline: compute fully, then one bulk PUT of the whole result."""
    return t_compute + t_msg + t_comm


def pipeline_time(compute_times, wire_times) -> float:
    """Wall-clock of a chunked overlap pipeline: chunk k's transfer starts
    once its compute has finished and the link is free; transfers
    serialize on the link while later chunks compute underneath.  The
    cost model of ``core/pipeline.py``'s loops (and, by time reversal, of
    the consumer pipeline ``streamed``)."""
    assert len(compute_times) == len(wire_times), (
        len(compute_times), len(wire_times))
    link_free = 0.0
    computed = 0.0
    for tc, tx in zip(compute_times, wire_times):
        computed += tc
        start = max(computed, link_free)
        link_free = start + tx
    return link_free


#: the stream rate the reference's model prices an XLA-level hop's repack
#: at (the arriving chunk's round trip through device memory between the
#: permute and the next sub-matmul): a modelling constant of the cost
#: model, kept so ``auto`` decides as the reference does on equal inputs;
#: not a measurement of the card
HBM_BYTES_PER_S = 100e9

#: the dense bf16 tensor-core rate of the NVIDIA H100 80GB HBM3 (989
#: TFLOP/s, the rate of the kernel bounds in PERF.md), which sizes the
#: compute term of a TP edge (``models/artblock.py``)
DENSE_BF16_FLOPS = 989e12


def hop_launch_overhead(link: LinkParams, hop_bytes: int = 0,
                        hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """Per-hop boundary cost an unfused ring matmul (``core/overlap.py``)
    pays and the fused kernel does not: a fresh launch (``t_host_cmd``),
    its DMA set-up (``t_dma``) and the arrived chunk's repack
    (``hop_bytes`` at ``hbm_bytes_per_s``)."""
    boundary = link.latency.t_host_cmd + link.latency.t_dma
    return boundary + max(0, int(hop_bytes)) / hbm_bytes_per_s


def fused_pipeline_time(compute_times, wire_times, *,
                        launch_overhead: float = 0.0) -> float:
    """Wall-clock of a fused ring pipeline: :func:`pipeline_time` with the
    per-hop boundary paid once for the whole ring."""
    return launch_overhead + pipeline_time(compute_times, wire_times)


__all__ = ["DENSE_BF16_FLOPS", "FSHMEM_QSFP", "HBM_BYTES_PER_S",
           "LatencyParams", "LinkParams", "TPU_ICI", "bulk_time",
           "fused_pipeline_time", "hop_launch_overhead", "n_packets",
           "pipeline_time", "put_time"]
