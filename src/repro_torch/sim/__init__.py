"""Data-producer substrate — port of ``src/repro/sim``: the synthetic
flat-plate snapshots and the Fortran-reproducer analogue that drives the
scaling benchmarks.  The spectral and distributed solvers are later slices
(``ROADMAP.md`` A8, A5)."""

from . import flatplate, reproducer
from .flatplate import FlatPlateConfig
from .reproducer import ReproducerConfig

__all__ = ["flatplate", "reproducer", "FlatPlateConfig", "ReproducerConfig"]
