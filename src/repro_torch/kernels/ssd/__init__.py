from repro_torch.kernels.ssd.ops import (
    SSD,
    SSD_BWD,
    ssd,
    ssd_bwd,
    ssd_chunk_fed,
)
from repro_torch.kernels.ssd.ref import (
    ssd_bwd_bf16_emulated,
    ssd_bwd_plain,
    ssd_decode_step,
    ssd_plain,
    ssd_sequential,
    ssd_split,
)

__all__ = ["SSD", "SSD_BWD", "ssd", "ssd_bwd", "ssd_bwd_bf16_emulated",
           "ssd_bwd_plain", "ssd_chunk_fed", "ssd_decode_step", "ssd_plain",
           "ssd_sequential", "ssd_split"]
