from repro_torch.kernels.ssd.ops import SSD, ssd, ssd_chunk_fed
from repro_torch.kernels.ssd.ref import (
    ssd_decode_step,
    ssd_plain,
    ssd_sequential,
    ssd_split,
)

__all__ = ["SSD", "ssd", "ssd_chunk_fed", "ssd_decode_step", "ssd_plain",
           "ssd_sequential", "ssd_split"]
