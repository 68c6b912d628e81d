"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Port of ``src/repro/configs/registry.py``.  Each
``repro_torch/configs/<id>.py`` exports ``config()`` (the assigned
configuration) and ``smoke_config()`` (a reduced same-family config for
the CPU tests).  As in the reference, any id resolves to the module
``repro_torch.configs.<id>``, a module a caller registered under that
name in ``sys.modules`` included, and an unknown id raises
``ModuleNotFoundError``.  The port carries all ten of the reference's
ids: dense (Phi-4-mini, StarCoder2-3B and -7B, Nemotron-4 with its head
dim of 192 and its Adafactor), MoE (Qwen3-MoE, Llama-4 Scout), SSM
(Mamba-2), the Jamba hybrid, the LLaVA backbone with its patch prefix
and the encoder-decoder Whisper.  The reference's input-shape table and
cell rules serve its mesh dry-run (``ROADMAP.md`` A7.7) and are not
carried.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS = (
    "llama4_scout_17b_a16e",
    "qwen3_moe_235b_a22b",
    "starcoder2_7b",
    "phi4_mini_3_8b",
    "nemotron_4_340b",
    "starcoder2_3b",
    "mamba2_1_3b",
    "jamba_1_5_large_398b",
    "whisper_large_v3",
    "llava_next_34b",
)

# canonical external ids (assignment spelling) -> module name
_ALIASES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "starcoder2-7b": "starcoder2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "starcoder2-3b": "starcoder2_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-large-v3": "whisper_large_v3",
    "llava-next-34b": "llava_next_34b",
}


def _module(name: str):
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__package__}.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
