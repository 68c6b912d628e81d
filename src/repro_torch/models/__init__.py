"""Model zoo — port of ``src/repro/models`` for LM serving and training:
the generic pattern-based decoder LM (dense GQA, MoE and Mamba-2 SSD
blocks, any pattern of them) and its shared layers.  Whisper is
``ROADMAP.md`` A7."""

from . import layers, lm, moe, ssd
from .config import ModelConfig

__all__ = ["layers", "lm", "moe", "ssd", "ModelConfig"]
