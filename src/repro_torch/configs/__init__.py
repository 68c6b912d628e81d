"""Architecture configs — port of ``src/repro/configs`` (the dense
Phi-4-mini and Mamba-2 configs; the rest of the zoo is ``ROADMAP.md``
A7)."""

from .registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
