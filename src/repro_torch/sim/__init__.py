"""Data-producer substrate — port of ``src/repro/sim``: the pseudo-spectral
Navier-Stokes solver (the PHASTA analogue, on ``torch.fft``), the
domain-decomposed finite-difference solver (``distributed`` + ``halo``,
the sharded producer of the ``capture_scan_sharded`` tier), the synthetic
flat-plate snapshots and the Fortran-reproducer analogue that drives the
scaling benchmarks."""

from . import distributed, flatplate, halo, reproducer, spectral
from .distributed import (FDConfig, FDState, decaying_turbulence,
                          make_producer, make_step, shard_state,
                          taylor_green, taylor_green_factor)
from .flatplate import FlatPlateConfig
from .halo import WALL_MODES, halo_exchange, halo_exchange_nd, pad_reference
from .reproducer import ReproducerConfig
from .spectral import NSConfig, NSState, partition_snapshot

__all__ = [
    "distributed", "flatplate", "halo", "reproducer", "spectral",
    "FDConfig", "FDState", "decaying_turbulence", "make_producer",
    "make_step", "shard_state", "taylor_green", "taylor_green_factor",
    "WALL_MODES", "halo_exchange", "halo_exchange_nd", "pad_reference",
    "FlatPlateConfig", "ReproducerConfig", "NSConfig", "NSState",
    "partition_snapshot",
]
