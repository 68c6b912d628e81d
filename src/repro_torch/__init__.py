"""PyTorch/CUDA port of the in-situ framework (``src/repro`` is the JAX
reference it is held against).

The package mirrors the reference's subpackages and public names, slice by
slice (``ROADMAP.md``).  This slice is the store-backed serving plane:
``core`` (store, server, client, driver), ``serve`` (continuous batching),
``insitu`` (serving session and plan), ``ml`` (the QuadConv encoder),
``sim`` (flat-plate snapshots) and ``kernels`` (hand-written Hopper
kernels for probe, gather and the QuadConv contraction).

Entry points take an explicit ``device`` that defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch path on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
