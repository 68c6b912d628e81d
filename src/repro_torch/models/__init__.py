"""Model zoo — port of ``src/repro/models`` for LM serving and training:
the generic pattern-based decoder LM (dense GQA, MoE and Mamba-2 SSD
blocks, any pattern of them), the Whisper encoder-decoder and their
shared layers."""

from . import layers, lm, moe, ssd, whisper
from .config import ModelConfig

__all__ = ["layers", "lm", "moe", "ssd", "whisper", "ModelConfig"]
