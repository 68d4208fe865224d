"""Analytic link model: the subset of ``repro.core.netmodel`` that the
conduit's ring-vs-bidir pricing (``conduit.estimate_time`` for
``all_gather`` over ``ring``/``bidir``) needs.  Pure Python, copied.

The constants are the reference's: the FSHMEM QSFP+ link of the paper
(Fig. 5, Table III) and the TPU v5e ICI.  They price a schedule decision
(which direction split a fused TP edge takes); they are not measurements
of the port's wire, which on one card is gloo staged through host memory.
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


__all__ = ["FSHMEM_QSFP", "LatencyParams", "LinkParams", "TPU_ICI",
           "n_packets", "put_time"]
