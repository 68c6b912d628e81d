"""Architecture configs — port of ``src/repro/configs`` (the decoder-only
configs of the zoo; Whisper and Nemotron-4 are ``ROADMAP.md`` A7)."""

from .registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
