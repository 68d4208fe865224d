from repro_torch.kernels.flash_attention.ops import (
    FLASH,
    KvSplitPlan,
    flash_attention,
    kv_split_plan,
    split_ranges,
    visible_tiles,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_plain,
    attention_split_plain,
)

__all__ = ["FLASH", "KvSplitPlan", "attention_plain",
           "attention_split_plain", "flash_attention", "kv_split_plan",
           "split_ranges", "visible_tiles"]
