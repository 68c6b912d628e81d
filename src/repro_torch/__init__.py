"""PyTorch/CUDA port of the in-situ framework (``src/repro`` is the JAX
reference it is held against).

The package mirrors the reference's subpackages and public names, slice by
slice (``ROADMAP.md``): the store-backed serving plane and the paper's
in-situ training workflow — ``core`` (store, server, client, driver),
``serve`` (continuous batching), ``insitu`` (sessions and plans), ``ml``
(the QuadConv autoencoder and its trainer), ``train``, ``sim``
(flat-plate snapshots) — and LM serving and training (``models``,
``configs``, ``parallel``, ``serve.decode``, ``launch.serve``,
``data``, ``launch.train``: Phi-4-mini and Mamba-2), over ``kernels``:
hand-written Hopper kernels for probe, sample, gather, the QuadConv
contraction, the flash-attention forward and its two backward passes
(dq; dk/dv) and the SSD intra-chunk step.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch path on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
