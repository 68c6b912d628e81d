from .ops import FLASH, FLASH_TC, flash_attention, mha
from .ref import flash_attention_ref, mha_ref

__all__ = ["FLASH", "FLASH_TC", "flash_attention", "mha",
           "flash_attention_ref", "mha_ref"]
