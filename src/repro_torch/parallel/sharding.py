"""Meshes, the slab placement rule, and parameter specs.

Port of ``src/repro/parallel/sharding.py``: :func:`data_mesh`,
:func:`space_mesh`, :func:`slab_sharding` and, from ``:254-301``,
:class:`ParamSpec`, :func:`init_params` and :func:`lm_params_from_numpy`;
and :class:`ElemSharding`, the port's stand-in for the ``NamedSharding``
of one stored element (the co-located deployment's layout).

The port is single-controller, as the reference is: one process holds the
store, the producer and the trainer, and a mesh is an ordered list of
``torch.device`` values, with an axis name, one entry per rank.  The
reference's ``shard_map`` over the mesh becomes a loop over its ranks and
its collectives become the explicit functions of
:mod:`~repro_torch.parallel.collectives`.  Ranks may share a device when
the caller lists it twice (``data_mesh(2, devices=["cuda:0"] * 2)``): the
port's counterpart of the reference's forced host devices, and how one
card runs a 2-rank mesh.  Multi-host ``torch.distributed`` is a later
slice (``ROADMAP.md`` A5.4).  The logical axes of a :class:`ParamSpec` are
kept so a spec tree reads like the reference's; they place nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "SlabSharding", "ElemSharding", "ElemShards", "data_mesh",
           "space_mesh", "slab_sharding", "ParamSpec", "init_params",
           "lm_params_from_numpy"]


def _canonical(device) -> torch.device:
    """``device`` resolved (raising for CUDA without a card) and with the
    index a tensor allocated there reports (``cuda`` → ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[r]`` is rank ``r``'s device (repeats allowed)."""

    devices: tuple[torch.device, ...]
    axis: str = "data"

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        """Each device once, in rank order: where replicated state and
        replicated compute live (once per device, whatever its ranks)."""
        return tuple(dict.fromkeys(self.devices))


@dataclass(frozen=True)
class SlabSharding:
    """The slab-sharded placement of one table: rank ``r`` of ``mesh``
    owns slots ``[r * local_cap, (r + 1) * local_cap)``."""

    mesh: Mesh
    local_cap: int

    def offset(self, rank: int) -> int:
        return rank * self.local_cap


@dataclass(frozen=True)
class ElemSharding:
    """The layout of one stored element over a mesh: ``spec`` holds, for
    each element dim, the mesh's axis name (that dim is cut into
    ``mesh.size`` equal blocks, block ``r`` on rank ``r``'s device) or
    ``None`` (whole on every rank); missing trailing entries are ``None``.
    The port's counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``
    over the element dims; a 1-D mesh cuts at most one dim."""

    mesh: Mesh
    spec: tuple = ()

    def __post_init__(self):
        spec = tuple(self.spec)
        object.__setattr__(self, "spec", spec)
        for entry in spec:
            if entry is not None and entry != self.mesh.axis:
                raise ValueError(f"elem spec {spec} names axis {entry!r}; "
                                 f"the mesh has {self.mesh.axis!r}")
        if sum(e is not None for e in spec) > 1:
            raise ValueError(f"elem spec {spec} uses mesh axis "
                             f"{self.mesh.axis!r} twice")

    @property
    def dim(self) -> int | None:
        """The element dim cut over the mesh (``None``: replicated)."""
        for i, entry in enumerate(self.spec):
            if entry is not None:
                return i
        return None

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def is_fully_replicated(self) -> bool:
        return self.dim is None or self.mesh.size == 1

    def local_shape(self, shape) -> tuple[int, ...]:
        """One rank's block of an element of ``shape``."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"elem spec {self.spec} has more entries than "
                             f"the element rank {len(shape)} (shape "
                             f"{shape})")
        if self.dim is None:
            return shape
        d = self.mesh.size
        if shape[self.dim] % d:
            raise ValueError(f"element dim {self.dim} of {shape} does not "
                             f"divide over the {d}-rank {self.mesh.axis!r} "
                             f"axis")
        return shape[:self.dim] + (shape[self.dim] // d,) \
            + shape[self.dim + 1:]

    def split(self, x: torch.Tensor, lead: int = 0) -> list[torch.Tensor]:
        """Each rank's block of ``x`` (``lead`` batch dims before the
        element dims), contiguous on its rank's device."""
        if self.dim is None:
            return [x.to(d) for d in self.mesh.devices]
        axis = lead + self.dim
        blk = x.shape[axis] // self.mesh.size
        return [x.narrow(axis, r * blk, blk).to(d).contiguous()
                for r, d in enumerate(self.mesh.devices)]


class ElemShards(NamedTuple):
    """A value (or a batch of values, with leading batch dims) held as each
    rank's block of its elements: ``blocks[r]`` is rank ``r``'s block, laid
    out by ``placement``, on its rank's device.  What a domain-decomposed
    producer emits (``sim.distributed.make_producer``); never assembled
    unless a reader needs the whole element."""

    blocks: tuple[torch.Tensor, ...]
    placement: ElemSharding


def data_mesh(n_devices: int | None = None, axis: str = "data",
              devices: Sequence | None = None) -> Mesh:
    """A 1-D mesh over ``axis`` for data parallelism.

    ``devices`` lists each rank's device and may repeat one; without it
    the mesh takes the first ``n_devices`` visible CUDA devices (default:
    all of them), and raises where there is no card.
    """
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")          # raises: no card
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"data_mesh({n}): {count} CUDA devices visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None and int(n_devices) != len(devices):
        raise ValueError(f"data_mesh({n_devices}) given {len(devices)} "
                         f"devices")
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(_canonical(d) for d in devices), axis)


def space_mesh(n_devices: int | None = None, axis: str = "space",
               devices: Sequence | None = None) -> Mesh:
    """A 1-D mesh over ``axis`` for domain decomposition: the producer-side
    twin of :func:`data_mesh` (the axis a halo-exchanged solver,
    ``sim.distributed``, cuts its grid rows over, and the axis its element
    layout carries into the store).  Ranks may share a device, as in
    :func:`data_mesh`: ``space_mesh(2, devices=["cuda:0"] * 2)``."""
    return data_mesh(n_devices, axis=axis, devices=devices)


def slab_sharding(spec, mesh: Mesh | None) -> SlabSharding | None:
    """Placement rule of the slab-sharded data plane: split a table's
    ``[capacity, *elem]`` slab along its slot axis over the mesh's axis,
    ``capacity / D`` slots a rank.  ``None`` (the table stays whole on the
    server's device) without a mesh or when ``capacity`` does not divide
    by ``D`` — the reference then places it replicated.  ``spec`` is a
    ``core.store.TableSpec`` (anything with ``capacity``)."""
    if mesh is None:
        return None
    d = mesh.size
    if spec.capacity % d:
        return None
    return SlabSharding(mesh, spec.capacity // d)


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
