"""Training substrate — port of ``src/repro/train``: the optimizer the
in-situ trainer uses (Adam as the reference writes it)."""

from . import optimizer

__all__ = ["optimizer"]
