"""Data-consumer substrate — port of ``src/repro/ml``: the QuadConv layer,
the autoencoder and the in-situ trainer (single device)."""

from . import autoencoder, quadconv, trainer
from .autoencoder import AEConfig

__all__ = ["autoencoder", "quadconv", "trainer", "AEConfig"]
