"""Data-consumer substrate — port of ``src/repro/ml``: the QuadConv layer,
the autoencoder, ResNet-50 (the paper's inference benchmark model) and the
in-situ trainer (single device and mesh)."""

from . import autoencoder, quadconv, resnet, trainer
from .autoencoder import AEConfig
from .trainer import TrainerConfig, TrainState

__all__ = ["autoencoder", "quadconv", "resnet", "trainer", "AEConfig",
           "TrainerConfig", "TrainState"]
