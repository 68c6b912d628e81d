"""Data-consumer substrate — port of ``src/repro/ml``: the QuadConv layer
and autoencoder (the served model).  The in-situ trainer is the next slice
(``ROADMAP.md`` A2)."""

from . import autoencoder, quadconv
from .autoencoder import AEConfig

__all__ = ["autoencoder", "quadconv", "AEConfig"]
