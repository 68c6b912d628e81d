"""Data-producer substrate — port of ``src/repro/sim``: the synthetic
flat-plate snapshots the serving slice feeds.  The spectral and
distributed solvers and the reproducer are later slices (``ROADMAP.md``
A2, A3, A5)."""

from . import flatplate
from .flatplate import FlatPlateConfig

__all__ = ["flatplate", "FlatPlateConfig"]
