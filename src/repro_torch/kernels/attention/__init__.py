from .ops import FLASH, flash_attention, mha
from .ref import flash_attention_ref, mha_ref

__all__ = ["FLASH", "flash_attention", "mha", "flash_attention_ref",
           "mha_ref"]
