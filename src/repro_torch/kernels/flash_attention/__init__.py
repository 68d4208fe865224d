from repro_torch.kernels.flash_attention.ops import FLASH, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_plain

__all__ = ["FLASH", "attention_plain", "flash_attention"]
