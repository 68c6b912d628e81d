"""Store deployment policies: co-located vs clustered (paper §2.3).

Port of ``src/repro/core/deployment.py``.  On Polaris the *co-located*
deployment runs one database shard per compute node, beside the
simulation and ML ranks, so every send and retrieve stays on its node.  On
a card the same idea is :class:`Colocated`: the store's slab is laid out
exactly like the producer's output, one block of every element per rank
of the producer's mesh, so a ``put`` of a domain-decomposed emission is a
rank-local slab update — no collective and no staged transfer.

The port has no ``PartitionSpec``: an element's layout is a tuple with an
axis name or ``None`` for each element dim, and ``elem_sharding(spec)``
returns a ``parallel.sharding.ElemSharding`` (the stand-in for
``NamedSharding``).  ``slab_sharding(spec)`` is the placement a server
gives each table: the same ``ElemSharding``, the element cut over the
mesh.  The reference's ``capacity_axis`` (the slot axis cut as well) has
no path or cell that needs it yet and raises naming ``ROADMAP.md`` A5.

The interface the server and session consume is ``slab_sharding``,
``elem_sharding``, ``describe`` and ``faults``.  Nothing is staged on a
co-located store, so the reference's staging verbs (``stage``,
``stage_batch``, ``stage_chunk``, ``stage_to_clients``) and its
``fan_in`` and ``crosses_mesh`` come with ``Clustered``, which alone
uses them.

The ``Clustered`` deployment (a dedicated store mesh, every transfer
staged across it, the overlap pipeline) with ``StagingPipeline`` and
``make_clustered_1d``/``_2d`` is ``ROADMAP.md`` A5.2 and raises here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..parallel.sharding import ElemSharding, Mesh, data_mesh
from .faults import FaultPlan
from .store import TableSpec

__all__ = ["Deployment", "Colocated", "Clustered", "split_devices",
           "fan_in_ratio", "StagingPipeline", "ElemSharding",
           "make_colocated_1d", "make_clustered_1d", "make_clustered_2d"]

_CLUSTERED_OPEN = ("the Clustered deployment (a dedicated store mesh, "
                   "staged transfers, the overlap pipeline): ROADMAP.md A5 "
                   "(A5.2)")


def fan_in_ratio(n_clients: int, n_db: int) -> int:
    """Clients per db shard — the paper's Fig.-5 contention knob (ceiling
    division: the hottest shard's load; at least 1)."""
    return max(1, -(-int(n_clients) // max(1, int(n_db))))


def split_devices(devices: Sequence | None = None,
                  db_fraction: float = 0.25):
    """Split the devices (default: every visible card) into ``(client,
    db)`` lists, as the paper splits its nodes: at least one device on
    each side; a single device lands on both."""
    if devices is None:
        devices = data_mesh().devices
    devices = list(devices)
    if len(devices) == 1:
        return devices, devices
    n_db = max(1, int(round(len(devices) * db_fraction)))
    n_db = min(n_db, len(devices) - 1)
    return devices[:-n_db], devices[-n_db:]


class Deployment:
    """Interface; see module docstring."""

    #: declared fault plan (``core.faults.FaultPlan``): a server built on
    #: this deployment arms its injector and exactly-once machinery with it.
    faults: FaultPlan | None = None

    def slab_sharding(self, spec: TableSpec):
        raise NotImplementedError

    def elem_sharding(self, spec: TableSpec):
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


@dataclass
class Colocated(Deployment):
    """Store laid out exactly like the producer's output (the on-node
    database).

    ``elem_spec`` is the layout of one stored element (an axis name or
    ``None`` per element dim); it must match the layout the producer emits
    so that puts are rank-local.  ``capacity_axis`` keeps the reference's
    signature; setting it raises (``ROADMAP.md`` A5).
    """

    mesh: Mesh
    elem_spec: tuple = ()
    capacity_axis: str | None = None
    faults: FaultPlan | None = None

    def __post_init__(self):
        self.elem_spec = tuple(self.elem_spec)
        ElemSharding(self.mesh, self.elem_spec)   # checks the axes
        if self.capacity_axis is not None:
            raise NotImplementedError(
                f"Colocated(capacity_axis={self.capacity_axis!r}): a "
                f"co-located table with its slot axis cut over the mesh "
                f"(no path or cell needs it yet): ROADMAP.md A5")

    def slab_sharding(self, spec: TableSpec | None = None) -> ElemSharding:
        return self.elem_sharding(spec)

    def elem_sharding(self, spec: TableSpec | None = None) -> ElemSharding:
        return ElemSharding(self.mesh, self.elem_spec)

    def describe(self) -> str:
        return (f"colocated(mesh={tuple(self.mesh.shape.items())}, "
                f"elem_spec={self.elem_spec})")


class Clustered(Deployment):
    """``ROADMAP.md`` A5.2: raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_CLUSTERED_OPEN)


class StagingPipeline:
    """The clustered overlap pipeline's two slots: ``ROADMAP.md`` A5.2,
    raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_CLUSTERED_OPEN)


def make_colocated_1d(axis: str = "data", mesh: Mesh | None = None,
                      shard_dim: int = 0, ndim: int = 1,
                      faults: FaultPlan | None = None) -> Colocated:
    """Convenience: a co-located deployment cutting element dim
    ``shard_dim`` (of ``ndim``) over ``axis``; ``mesh`` defaults to every
    visible card (``data_mesh(axis=axis)``)."""
    if mesh is None:
        mesh = data_mesh(axis=axis)
    spec = [None] * ndim
    spec[shard_dim] = axis
    return Colocated(mesh=mesh, elem_spec=tuple(spec), faults=faults)


def make_clustered_1d(*args, **kwargs) -> Clustered:
    """``ROADMAP.md`` A5.2: raises."""
    raise NotImplementedError(_CLUSTERED_OPEN)


def make_clustered_2d(*args, **kwargs) -> Clustered:
    """``ROADMAP.md`` A5.2: raises."""
    raise NotImplementedError(_CLUSTERED_OPEN)


def check_deployment(deployment):
    """``deployment`` when the port runs it (``None``, the local store, or
    :class:`Colocated`); any other raises ``NotImplementedError`` naming
    ``ROADMAP.md`` A5."""
    if deployment is None or isinstance(deployment, Colocated):
        return deployment
    raise NotImplementedError(_CLUSTERED_OPEN)
