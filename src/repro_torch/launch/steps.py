"""Model specs for a config — the single-device part of
``src/repro/launch/steps.py``.  The reference's jit-able train / prefill
/ decode step builders and abstract sharded inputs serve its dry-run and
mesh launchers (``ROADMAP.md`` A5, A7); the port runs ``lm.prefill`` and
``lm.decode_step`` eagerly (``serve/decode.py``)."""

from __future__ import annotations

from ..models import lm

__all__ = ["model_specs"]


def model_specs(cfg):
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models (Whisper) are ROADMAP.md A7")
    return lm.lm_specs(cfg)
