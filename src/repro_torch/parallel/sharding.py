"""Parameter specs and their materialization, on one device.

Port of the single-device part of ``src/repro/parallel/sharding.py``
(``:254-301``): :class:`ParamSpec` (shape, logical axes, initializer),
:func:`init_params` and :func:`lm_params_from_numpy`.  The logical axes
are kept so a spec tree reads like the reference's; they place nothing
here (meshes and ``torch.distributed`` are ``ROADMAP.md`` A5).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ParamSpec", "init_params", "lm_params_from_numpy"]


class ParamSpec:
    """Declares one parameter: shape, logical axes, initializer."""

    __slots__ = ("shape", "axes", "init", "scale")

    def __init__(self, shape: Sequence[int], axes: Sequence[str | None],
                 init: str = "normal", scale: float | None = None):
        if len(shape) != len(axes):
            raise ValueError(f"ParamSpec rank mismatch: {shape} vs {axes}")
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        self.init = init
        self.scale = scale

    def __repr__(self):
        return f"ParamSpec({self.shape}, {self.axes}, {self.init})"


def _std(spec: ParamSpec) -> float:
    if spec.scale is not None:
        return float(spec.scale)
    if spec.init == "embed":
        return 0.02
    # fan-in over the trailing input dim (stacked-layer dims excluded)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return math.sqrt(1.0 / max(1, fan_in))


def _init_leaf(spec: ParamSpec, generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale or 0.0, dtype=dtype,
                          device=device)
    if spec.init in ("normal", "embed"):
        # drawn in place, in ``dtype``, on the device: a 3.8B-parameter
        # model is never built on the host or held twice in fp32
        return torch.empty(spec.shape, dtype=dtype, device=device).normal_(
            0.0, _std(spec), generator=generator)
    raise ValueError(f"unknown init {spec.init!r}")


def _build(tree, make, path=()):
    """``make(spec, path)`` at every :class:`ParamSpec` of ``tree``."""
    if isinstance(tree, ParamSpec):
        return make(tree, path)
    if isinstance(tree, dict):
        return {k: _build(v, make, path + (k,)) for k, v in tree.items()}
    return type(tree)(_build(t, make, path + (i,))
                      for i, t in enumerate(tree))


def init_params(specs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None):
    """Materialize a specs tree into a params tree (same structure), with
    the reference's initializers: fan-in ``normal``, ``embed`` (std 0.02),
    ``ones``, ``zeros``, ``const``.  ``generator`` must live on ``device``
    (``torch.Generator(device=...)``).  JAX's threefry draws cannot be
    reproduced: parity tests feed numpy weights through
    :func:`lm_params_from_numpy`."""
    device = resolve_device(device)
    return _build(specs, lambda spec, _: _init_leaf(spec, generator, dtype,
                                                    device))


def lm_params_from_numpy(tree, cfg, device=None, dtype=None):
    """The reference's LM params (``lm.lm_specs`` layout, leaves as numpy
    arrays or anything ``np.asarray`` takes) as the port's: the same
    nested dict, each leaf a tensor of ``dtype`` (default ``cfg.dtype``;
    optimizer moments pass ``torch.float32``) on ``device``.  Every leaf's
    shape is checked against the port's ``lm_specs(cfg)``."""
    from ..launch.steps import model_specs
    device = resolve_device(device)
    dtype = dtype or cfg.dtype

    def convert(spec, path):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        arr = np.asarray(leaf)
        if arr.shape != spec.shape:
            raise ValueError(f"lm_params_from_numpy: {'/'.join(map(str, path))}"
                             f" has shape {arr.shape}, the spec {spec.shape}")
        # a copy, never a view of the caller's array: the train step
        # updates its params in place
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device=device, dtype=dtype, copy=True)

    return _build(model_specs(cfg), convert)
