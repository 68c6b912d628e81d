"""Meshes, the slab placement rule, and parameter specs.

Port of ``src/repro/parallel/sharding.py``: :func:`data_mesh`,
:func:`space_mesh`, :func:`disjoint_data_meshes`, :func:`slab_sharding`
and, from ``:254-301``, :class:`ParamSpec`, :func:`init_params` and
:func:`lm_params_from_numpy`; and :class:`ElemSharding`, the port's
stand-in for the ``NamedSharding`` of one stored element (the co-located
deployment's layout), and :class:`GridSharding`, a table cut both ways on
a 2-D ``(slab, element)`` grid (``core.deployment.make_clustered_2d``).

The port is single-controller, as the reference is: one process holds the
store, the producer and the trainer, and a mesh is an ordered list of
``torch.device`` values, one entry per rank, laid out over a grid of
named axes (1-D by default).  The
reference's ``shard_map`` over the mesh becomes a loop over its ranks and
its collectives become the explicit functions of
:mod:`~repro_torch.parallel.collectives`.  Ranks may share a device when
the caller lists it twice (``data_mesh(2, devices=["cuda:0"] * 2)``): the
port's counterpart of the reference's forced host devices, and how one
card runs a 2-rank mesh.  Multi-host ``torch.distributed`` is a later
slice (``ROADMAP.md`` A, item 4).  The logical axes of a :class:`ParamSpec` are
kept so a spec tree reads like the reference's; they place nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "SlabSharding", "ElemSharding", "GridSharding",
           "ElemShards", "data_mesh", "space_mesh", "disjoint_data_meshes",
           "slab_sharding", "ParamSpec", "init_params",
           "lm_params_from_numpy"]


def _canonical(device) -> torch.device:
    """``device`` resolved (raising for CUDA without a card) and with the
    index a tensor allocated there reports (``cuda`` → ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True, init=False)
class Mesh:
    """A grid of ranks: ``devices[r]`` is rank ``r``'s device (repeats
    allowed), the ranks laid out row-major over ``grid`` with one name a
    grid axis.  ``Mesh(devices, "data")`` is the 1-D mesh the port has
    always had; ``Mesh(devices, ("slab", "space"), (2, 2))`` a 2-D one."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    grid: tuple[int, ...]

    def __init__(self, devices, axis="data", grid=None):
        devices = tuple(devices)
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        grid = (len(devices),) if grid is None else tuple(int(g)
                                                          for g in grid)
        if len(names) != len(grid) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} for a grid {grid}")
        if math.prod(grid) != len(devices):
            raise ValueError(f"a {grid} grid of {len(devices)} devices")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "grid", grid)

    @property
    def axis(self) -> str:
        """The one axis of a 1-D mesh (an N-D mesh raises: name one)."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a {self.grid} mesh has axes "
                             f"{self.axis_names}: name one")
        return self.axis_names[0]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        """Each device once, in rank order: where replicated state and
        replicated compute live (once per device, whatever its ranks)."""
        return tuple(dict.fromkeys(self.devices))

    def _axis_index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)

    def coords(self, rank: int) -> tuple[int, ...]:
        """Rank ``rank``'s grid coordinates (row-major)."""
        return tuple(int(c) for c in np.unravel_index(rank, self.grid))

    def coord(self, rank: int, axis: str) -> int:
        """Rank ``rank``'s coordinate along ``axis``."""
        return self.coords(rank)[self._axis_index(axis)]

    def groups(self, axis: str) -> list[list[int]]:
        """The ranks that share every coordinate but ``axis``'s, one list
        a group, each ordered along ``axis``; the groups in row-major
        order of the other coordinates.  A collective over ``axis`` runs
        within each group."""
        i = self._axis_index(axis)
        order = np.moveaxis(np.arange(self.size).reshape(self.grid), i, -1)
        return [[int(r) for r in row]
                for row in order.reshape(-1, self.grid[i])]


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
    each element dim, a mesh axis name (that dim is cut into the axis's
    size of equal blocks, rank ``r`` holding the block of its coordinate
    along that axis, on its own device) or ``None`` (whole on every
    rank); missing trailing entries are ``None``.  The port's counterpart
    of ``NamedSharding(mesh, PartitionSpec(*spec))`` over the element
    dims; one dim at most is cut.  On a 2-D mesh the blocks repeat along
    the other axis: ``(None, "space", None)`` on a ``(slab, space)`` grid
    gives every rank of a ``space`` column the same block."""

    mesh: Mesh
    spec: tuple = ()

    def __post_init__(self):
        spec = tuple(self.spec)
        object.__setattr__(self, "spec", spec)
        for entry in spec:
            if entry is not None and entry not in self.mesh.axis_names:
                raise ValueError(f"elem spec {spec} names axis {entry!r}; "
                                 f"the mesh has {self.mesh.axis_names}")
        cut = [e for e in spec if e is not None]
        if len(cut) > 1:
            raise ValueError(
                f"elem spec {spec} uses mesh axis {cut[0]!r} twice"
                if len(set(cut)) < len(cut) else
                f"elem spec {spec} cuts more than one dim (the port cuts "
                f"one)")

    @property
    def dim(self) -> int | None:
        """The element dim cut over the mesh (``None``: replicated)."""
        for i, entry in enumerate(self.spec):
            if entry is not None:
                return i
        return None

    @property
    def axis(self) -> str | None:
        """The mesh axis the cut dim is laid over (``None``: none)."""
        d = self.dim
        return None if d is None else self.spec[d]

    @property
    def blocks(self) -> int:
        """How many distinct blocks an element is cut into."""
        return 1 if self.axis is None else self.mesh.shape[self.axis]

    def block_of(self, rank: int) -> int:
        """The block rank ``rank`` holds."""
        return 0 if self.axis is None else self.mesh.coord(rank, self.axis)

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def is_fully_replicated(self) -> bool:
        return self.blocks == 1

    def local_shape(self, shape) -> tuple[int, ...]:
        """One rank's block of an element of ``shape``."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"elem spec {self.spec} has more entries than "
                             f"the element rank {len(shape)} (shape "
                             f"{shape})")
        if self.dim is None:
            return shape
        d = self.blocks
        if shape[self.dim] % d:
            raise ValueError(f"element dim {self.dim} of {shape} does not "
                             f"divide over the {d}-rank {self.axis!r} "
                             f"axis")
        return shape[:self.dim] + (shape[self.dim] // d,) \
            + shape[self.dim + 1:]

    def split(self, x: torch.Tensor, lead: int = 0) -> list[torch.Tensor]:
        """Each rank's block of ``x`` (``lead`` batch dims before the
        element dims), contiguous on its rank's device."""
        if self.dim is None:
            return [x.to(d) for d in self.mesh.devices]
        axis = lead + self.dim
        blk = x.shape[axis] // self.blocks
        return [x.narrow(axis, self.block_of(r) * blk, blk).to(d)
                .contiguous() for r, d in enumerate(self.mesh.devices)]


@dataclass(frozen=True)
class GridSharding:
    """A table cut both ways on a 2-D mesh: the slot axis over
    ``slab_axis`` (rank ``r`` owns slots ``[i * local_cap, (i + 1) *
    local_cap)``, ``i`` its ``slab_axis`` coordinate) and every element by
    ``elem``, laid out over the other axis — the reference's
    ``NamedSharding(db_mesh, P("slab", *elem_spec))``."""

    mesh: Mesh
    slab_axis: str
    local_cap: int
    elem: ElemSharding

    def __post_init__(self):
        if self.mesh.ndim != 2 or self.slab_axis not in self.mesh.axis_names:
            raise ValueError(f"a grid placement needs a 2-D mesh with axis "
                             f"{self.slab_axis!r}: {self.mesh.shape}")
        if self.elem.mesh != self.mesh or self.elem.axis == self.slab_axis:
            raise ValueError(f"the element layout {self.elem.spec} must lie "
                             f"over the grid's other axis")

    @property
    def elem_axis(self) -> str:
        return next(a for a in self.mesh.axis_names if a != self.slab_axis)

    @property
    def slab_shards(self) -> int:
        return self.mesh.shape[self.slab_axis]

    def slab_index(self, rank: int) -> int:
        return self.mesh.coord(rank, self.slab_axis)

    def offset(self, rank: int) -> int:
        return self.slab_index(rank) * self.local_cap


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


def disjoint_data_meshes(count: int, axis: str = "data",
                         devices: Sequence | None = None
                         ) -> list[Mesh | None]:
    """Cut the device pool into ``count`` disjoint 1-D data meshes, one a
    trainer replica (multi-consumer training).  ``devices`` is the pool
    (default: every visible card; a list may repeat one, ``["cuda:0"] *
    4`` is four ranks of one card); each replica takes ``len(devices) //
    count`` consecutive positions (the remainder stays idle, so every
    replica has the same shape).  A
    slice of fewer than 2 ranks gives ``None``: that replica falls back
    to the single-device ``fused`` tier."""
    if count < 1:
        raise ValueError("count must be >= 1")
    if devices is None:
        devices = data_mesh().devices
    devices = list(devices)
    per = len(devices) // count
    if per < 2:
        return [None] * count
    return [Mesh([_canonical(d) for d in devices[i * per:(i + 1) * per]],
                 axis) for i in range(count)]


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
    """The reference's model params (``launch.steps.model_specs`` layout:
    ``lm.lm_specs``, or ``whisper.whisper_specs`` for an encoder-decoder
    config; leaves as numpy arrays or anything ``np.asarray`` takes) as
    the port's: the same nested dict, each leaf a tensor of ``dtype``
    (default ``cfg.dtype``; optimizer moments pass ``torch.float32``) on
    ``device``.  Every leaf's shape is checked against the port's
    ``model_specs(cfg)``."""
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
