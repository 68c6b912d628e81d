"""Training substrate — port of ``src/repro/train``: the optimizers and
schedules (Adam for the in-situ trainer, AdamW with clipping and a
warmup-cosine schedule for the LM), the LM train state, and durable and
in-memory checkpoints."""

from . import checkpoint, optimizer, train_state
from .train_state import TrainState, make_tx

__all__ = ["checkpoint", "optimizer", "train_state", "TrainState", "make_tx"]
