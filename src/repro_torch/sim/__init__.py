"""Data-producer substrate — port of ``src/repro/sim``: the pseudo-spectral
Navier-Stokes solver (the PHASTA analogue, on ``torch.fft``), the
synthetic flat-plate snapshots and the Fortran-reproducer analogue that
drives the scaling benchmarks.  The domain-decomposed finite-difference
solver and its halo exchange are a later slice (``ROADMAP.md`` A5)."""

from . import flatplate, reproducer, spectral
from .flatplate import FlatPlateConfig
from .reproducer import ReproducerConfig
from .spectral import NSConfig, NSState, partition_snapshot

__all__ = ["flatplate", "reproducer", "spectral", "FlatPlateConfig",
           "ReproducerConfig", "NSConfig", "NSState", "partition_snapshot"]
