"""The paper's own architecture: the QuadConv autoencoder (paper §4).

Port of ``src/repro/configs/quadconv_ae.py``.  The full config mirrors
the paper's setup scaled to its per-rank partition: 36M elements / 960
ranks = 37,500 points per rank (the nearest structured grid 48x25x32 =
38,400), 4 channels, 16 internal channels, 2 blocks, latent 100 ->
~1536x compression (paper: 1700x).  The smoke config's ``mode="ref"`` is
the port's ``AEConfig.mode`` for the plain einsum contraction.
"""

from ..ml.autoencoder import AEConfig
from ..sim.flatplate import FlatPlateConfig

__all__ = ["config", "grid_config", "smoke_config", "smoke_grid_config"]


def config() -> AEConfig:
    return AEConfig(n_points=38_400, channels=4, internal=16, latent=100,
                    blocks=2, pool=4, mlp_width=64, mlp_depth=5)


def grid_config() -> FlatPlateConfig:
    return FlatPlateConfig(nx=48, ny=25, nz=32)


def smoke_config() -> AEConfig:
    return AEConfig(n_points=256, channels=4, internal=8, latent=16,
                    blocks=2, pool=4, mlp_width=16, mlp_depth=3, mode="ref")


def smoke_grid_config() -> FlatPlateConfig:
    return FlatPlateConfig(nx=8, ny=8, nz=4)
