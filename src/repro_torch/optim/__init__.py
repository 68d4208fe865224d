"""Optimizer of the port: AdamW, its LR schedule, gradient clipping and
the int8 gradient compression with error feedback."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import (
    compress_8bit,
    compressed_bytes,
    decompress_8bit,
    ef_compress_update,
    ef_init,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_8bit", "compressed_bytes",
           "decompress_8bit", "ef_compress_update", "ef_init",
           "global_norm", "warmup_cosine"]
