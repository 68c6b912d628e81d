"""Training substrate — port of ``src/repro/train``: the optimizers and
schedules (Adam for the in-situ trainer, AdamW with clipping and a
warmup-cosine schedule for the LM) and the LM train state."""

from . import optimizer, train_state

__all__ = ["optimizer", "train_state"]
