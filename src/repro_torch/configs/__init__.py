"""Architecture configs — port of ``src/repro/configs``: the zoo's ten
ids, the decoder-only families and the encoder-decoder Whisper."""

from .registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
