"""Model zoo — port of ``src/repro/models`` for LM serving and training:
the generic pattern-based decoder LM (dense GQA and Mamba-2 SSD blocks)
and its shared layers.  MoE, Whisper and the hybrid patterns are
``ROADMAP.md`` A7."""

from . import layers, lm, ssd
from .config import ModelConfig

__all__ = ["layers", "lm", "ssd", "ModelConfig"]
