"""Store deployment policies: co-located vs clustered (paper §2.3).

Port of ``src/repro/core/deployment.py``.  On Polaris the *co-located*
deployment runs one database shard per compute node, beside the
simulation and ML ranks, so every send and retrieve stays on its node;
the *clustered* deployment gives the database dedicated nodes and pushes
every transfer across the interconnect.

* :class:`Colocated` — the store's slab is laid out exactly like the
  producer's output, one block of every element per rank of the
  producer's mesh, so a ``put`` of a domain-decomposed emission is a
  rank-local slab update: no collective and no staged transfer.
  ``capacity_axis`` cuts the slot axis over a mesh axis as well: a
  ``SlabSharding`` when the elements stay whole on a 1-D mesh, a
  ``GridSharding`` when they are cut over the other axis of a 2-D one.
* :class:`Clustered` — the store lives on a dedicated db mesh.  Every
  write stages its payload onto that mesh first (``stage``,
  ``stage_batch``, ``stage_chunk``) and every staged read leaves it again
  (``stage_to_clients``); the server counts one staged transfer a hop.
  ``slab_axis`` cuts the slab's slot axis over the db mesh (a
  ``parallel.sharding.SlabSharding``); ``elem_spec`` lays each element
  out over it (an ``ElemSharding``).  On a 1-D db mesh a table is one or
  the other; :func:`make_clustered_2d` builds a 2-D ``(slab, element)``
  db grid on which it is both (a ``GridSharding``).  ``overlap`` turns on
  the two-slot staging pipeline of the fused put (:class:`StagingPipeline`).

The port has no ``PartitionSpec``: an element's layout is a tuple with an
axis name or ``None`` for each element dim, and ``elem_sharding(spec)``
returns a ``parallel.sharding.ElemSharding`` (the stand-in for
``NamedSharding``).

**A stage is a copy.**  ``jax.device_put`` may alias a buffer onto the
same device, because JAX arrays are immutable.  The port writes in place,
so every stage copies into tensors allocated on the db ranks' devices,
also when client and db ranks share a card: the store never holds a
buffer a client writes again.  ``stage_chunk(..., donate=True)`` (the
overlap pipeline) enqueues its copies on a staging stream of the db
device, after an event recorded on the producer's stream, and returns a
:class:`StagedChunk` whose ``ready`` event the insert waits on.  The
chunk holds its copies' sources until then: source and destination were
allocated on the producer's stream, and neither is freed before that
stream has waited on the copies, so the caching allocator cannot hand
them to the next chunk while a copy still runs (``Tensor.record_stream``
would keep each 2 GB block from reuse until the host saw the event,
costing a fresh allocation a chunk).  On the CPU the copies run in order
and ``ready`` is ``None``.

On a 2-D db grid a staged element is copied once to every db rank, each
rank taking the block of its element-axis coordinate (the reference
stages onto ``P(None, *elem_spec)``, replicated along the slab axis): the
ranks of a slab row then insert the rows they own without a collective.
Every grid read goes through the plain gather kernel once per shard
(``Clustered.gather_shards`` is 1 on a 2-D grid).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from ..parallel.sharding import (ElemSharding, ElemShards, GridSharding, Mesh,
                                 SlabSharding, data_mesh)
from ..tree import tree_map
from .faults import FaultPlan
from .store import TableSpec

__all__ = ["Deployment", "Colocated", "Clustered", "split_devices",
           "fan_in_ratio", "StagingPipeline", "StagedChunk", "ElemSharding",
           "make_colocated_1d", "make_clustered_1d", "make_clustered_2d",
           "check_deployment"]


def fan_in_ratio(n_clients: int, n_db: int) -> int:
    """Clients per db shard — the paper's Fig.-5 contention knob (ceiling
    division: the hottest shard's load; at least 1).  The one source both
    ``Clustered.fan_in`` and the plan's ``ComponentPlan.fan_in`` read."""
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

    #: clients per store shard — drives the clustered contention model.
    fan_in: int = 1
    #: does ``stage`` move bytes across meshes?  The server counts one
    #: staged transfer per stage call only when this is set.
    crosses_mesh: bool = False
    #: declared fault plan (``core.faults.FaultPlan``): a server built on
    #: this deployment arms its injector and exactly-once machinery with it.
    faults: FaultPlan | None = None

    def slab_sharding(self, spec: TableSpec):
        raise NotImplementedError

    def elem_sharding(self, spec: TableSpec):
        raise NotImplementedError

    def stage(self, x, spec: TableSpec | None = None):
        raise NotImplementedError

    def stage_batch(self, values, spec: TableSpec | None = None):
        """Move a ``[n, *shape]`` batch onto the store placement in one
        transfer (leading batch dims are never cut by ``elem_spec``)."""
        raise NotImplementedError

    def stage_chunk(self, keys, values, mask, spec: TableSpec | None = None,
                    donate: bool = False):
        """Move a whole collected chunk (keys ``[n]``, values ``[n,
        *shape]``, emit mask ``[n]``) onto the store placement as ONE
        transfer."""
        raise NotImplementedError

    def stage_to_clients(self, x):
        """The read-side hop: a gathered batch from the store placement
        back onto the consumers."""
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


@dataclass
class Colocated(Deployment):
    """Store laid out exactly like the producer's output (the on-node
    database).

    ``elem_spec`` is the layout of one stored element (an axis name or
    ``None`` per element dim); it must match the layout the producer emits
    so that puts are rank-local.  ``capacity_axis`` cuts the slot axis
    over that mesh axis too (``capacity / D`` slots a rank): with whole
    elements on a 1-D mesh a ``SlabSharding`` (reads gather each rank's
    own rows and ``psum`` them; a replicated-entry mesh trainer
    all-gathers the slab), with elements cut over the other axis of a 2-D
    mesh a ``GridSharding``.  Nothing crosses a mesh: ``fan_in`` is 1,
    ``crosses_mesh`` False (class constants) and the staging verbs return
    what they are given.
    """

    mesh: Mesh
    elem_spec: tuple = ()
    capacity_axis: str | None = None
    faults: FaultPlan | None = None

    def __post_init__(self):
        self.elem_spec = tuple(self.elem_spec)
        layout = ElemSharding(self.mesh, self.elem_spec)   # checks the axes
        if self.capacity_axis is not None:
            if self.capacity_axis not in self.mesh.axis_names:
                raise ValueError(f"capacity_axis {self.capacity_axis!r} is "
                                 f"not an axis of the mesh "
                                 f"{self.mesh.axis_names}")
            if layout.axis == self.capacity_axis:
                raise ValueError(
                    f"capacity_axis {self.capacity_axis!r} also appears in "
                    f"elem_spec {self.elem_spec}: the slot and element cuts "
                    f"need disjoint mesh axes")

    def slab_sharding(self, spec: TableSpec | None = None):
        layout = self.elem_sharding(spec)
        if self.capacity_axis is None:
            return layout
        if spec is None:
            raise ValueError("a capacity-cut placement needs the table spec")
        d = self.mesh.shape[self.capacity_axis]
        if spec.capacity % d:
            raise ValueError(f"table {spec.name!r}: capacity "
                             f"{spec.capacity} does not divide over the "
                             f"{d}-rank {self.capacity_axis!r} axis")
        if self.mesh.ndim == 1:
            return SlabSharding(self.mesh, spec.capacity // d)
        return GridSharding(self.mesh, self.capacity_axis,
                            spec.capacity // d, layout)

    def elem_sharding(self, spec: TableSpec | None = None) -> ElemSharding:
        return ElemSharding(self.mesh, self.elem_spec)

    def stage(self, x, spec: TableSpec | None = None):
        return x

    def stage_batch(self, values, spec: TableSpec | None = None):
        return values

    def stage_chunk(self, keys, values, mask, spec: TableSpec | None = None,
                    donate: bool = False):
        return keys, values, mask

    def stage_to_clients(self, x):
        return x

    def describe(self) -> str:
        return (f"colocated(mesh={tuple(self.mesh.shape.items())}, "
                f"elem_spec={self.elem_spec}"
                + (f", capacity_axis={self.capacity_axis!r}"
                   if self.capacity_axis else "") + ")")


def _fit_spec(parts: Sequence, shape: Sequence[int], mesh: Mesh) -> tuple:
    """Drop the mesh axes that do not divide their dim (a staged element
    must divide exactly).  An ``elem_spec`` LONGER than the element rank
    is a misconfiguration, not a fitting problem: it raises."""
    parts = tuple(parts)
    if len(parts) > len(shape):
        raise ValueError(
            f"elem_spec {parts} has more entries than the element rank "
            f"{len(shape)} (shape {tuple(shape)})")
    fitted = []
    for dim, entry in zip(shape, parts + (None,) * (len(shape) -
                                                    len(parts))):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            n = math.prod(mesh.shape[a] for a in axes)
            if dim % n != 0:
                entry = None
        fitted.append(entry)
    return tuple(fitted)


class StagedChunk:
    """A chunk staged onto the db mesh: ``keys``, ``values`` and ``mask``
    (it unpacks as those three, like the reference's tuple) and
    ``ready``, the CUDA event that follows its copies on the staging
    stream (``None`` when they ran in the current stream's order).  Until
    :meth:`wait` it also holds the copies' sources."""

    __slots__ = ("keys", "values", "mask", "ready", "_sources")

    def __init__(self, keys, values, mask, ready=None, sources=()):
        self.keys, self.values, self.mask = keys, values, mask
        self.ready, self._sources = ready, tuple(sources)

    def __iter__(self):
        return iter((self.keys, self.values, self.mask))

    def wait(self) -> None:
        """Order the current stream of the keys' device after the copies,
        then let the sources go (a no-op when the copies ran in stream
        order)."""
        if self.ready is not None:
            torch.cuda.current_stream(self.keys.device).wait_event(
                self.ready)
            self.ready = None
        self._sources = ()

    def __del__(self):
        # a chunk dropped before its insert still orders the stream that
        # will reuse its buffers after its copies
        if getattr(self, "ready", None) is not None:
            self.wait()


class _Copier:
    """The copies of one transfer: each destination allocated on its
    device from the current stream, filled by ``copy_``.  ``stream`` (a
    CUDA stream, the overlap pipeline) runs them there after an event on
    the current stream; ``None`` runs them in the current stream's
    order."""

    def __init__(self, stream=None):
        self.stream = stream
        self.pairs: list = []

    def copy(self, src: torch.Tensor, device) -> torch.Tensor:
        dst = torch.empty(src.shape, dtype=src.dtype, device=device)
        if self.stream is None:
            dst.copy_(src)
        else:
            self.pairs.append((src, dst))
        return dst

    def run(self):
        """Enqueue the deferred copies → the event that follows them."""
        if self.stream is None:
            return None
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(self.stream.device))
        self.stream.wait_event(produced)
        with torch.cuda.stream(self.stream):
            for src, dst in self.pairs:
                dst.copy_(src, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self.stream)
        return ready

    @property
    def sources(self) -> tuple:
        return tuple(src for src, _ in self.pairs)


@dataclass
class Clustered(Deployment):
    """Store on dedicated devices; every transfer crosses between meshes.

    ``elem_spec`` lays one element out across the db mesh; it is fitted
    per table (axes that do not divide the element dims fall back to
    whole).  ``slab_axis`` names the db mesh's axis to cut the slot axis
    over (``capacity / D`` slots a db rank; a whole slab when capacity
    does not divide).  ``overlap`` enables the two-slot staging pipeline
    of the fused put: chunk N's copy runs on the staging stream while
    chunk N+1 collects, and chunk N's insert comes one capture later
    (drained at capture end and before a restage).  ``cost_model`` is a
    fitted ``insitu.plan.ContentionModel`` (untyped: core does not import
    the plan layer); when set, the session's plan autotunes the chunk from
    it.  ``crosses_mesh`` is True (a class constant); ``fan_in`` is
    derived from the meshes' sizes.
    """

    client_mesh: Mesh
    db_mesh: Mesh
    elem_spec: tuple = ()
    slab_axis: str | None = None
    overlap: bool = True
    cost_model: object | None = None
    faults: FaultPlan | None = None

    crosses_mesh = True

    def __post_init__(self):
        self.elem_spec = tuple(self.elem_spec)
        self.fan_in = fan_in_ratio(self.client_mesh.size, self.db_mesh.size)
        ElemSharding(self.db_mesh, self.elem_spec)   # checks the axes
        if self.slab_axis is not None:
            used = {a for entry in self.elem_spec if entry is not None
                    for a in ((entry,) if isinstance(entry, str)
                              else entry)}
            if self.slab_axis in used:
                raise ValueError(
                    f"slab_axis {self.slab_axis!r} also appears in "
                    f"elem_spec {self.elem_spec}: a slot-partitioned "
                    f"slab keeps each element whole on its owning shard "
                    f"— use disjoint mesh axes")
            if self.slab_axis not in self.db_mesh.axis_names:
                raise ValueError(f"slab_axis {self.slab_axis!r} is not an "
                                 f"axis of the db mesh "
                                 f"{self.db_mesh.axis_names}")
        self._streams: dict = {}

    @property
    def home(self) -> torch.device:
        """The db mesh's rank-0 device: where a staged whole value lands."""
        return self.db_mesh.devices[0]

    def _elem_spec_for(self, spec: TableSpec | None) -> tuple:
        if spec is None:
            return self.elem_spec
        return _fit_spec(self.elem_spec, spec.shape, self.db_mesh)

    def slab_shards(self, spec: TableSpec) -> int:
        """How many slot partitions the slab splits into (1 when
        ``slab_axis`` is unset or capacity does not divide)."""
        if self.slab_axis is None:
            return 1
        d = self.db_mesh.shape[self.slab_axis]
        return d if spec.capacity % d == 0 else 1

    def gather_shards(self, spec: TableSpec) -> int:
        """Shard count of the shard-local staged gather
        (``store.make_clustered_gather``): the slot-partition factor, but
        only where the element dims are whole on the db mesh.  THE rule
        both the server's gather and the plan's ``plan(hlo=True)``
        consult.  On a 2-D db grid it is 1: the grid read takes the plain
        gather kernel once per shard, cut elements or not."""
        if any(e is not None for e in self._elem_spec_for(spec)) \
                or self.db_mesh.ndim > 1:
            return 1
        return self.slab_shards(spec)

    def slab_sharding(self, spec: TableSpec):
        """A ``SlabSharding`` over the db mesh when the slot axis is cut (a
        ``GridSharding`` on a 2-D db grid, the elements laid out by the
        fitted ``elem_spec`` along its other axis), else the fitted
        ``ElemSharding`` (which, cutting nothing, leaves the slab whole on
        the server's device, one of the db mesh's)."""
        d = self.slab_shards(spec)
        if d > 1 and self.db_mesh.ndim > 1:
            return GridSharding(self.db_mesh, self.slab_axis,
                                spec.capacity // d, self.elem_sharding(spec))
        if d > 1:
            return SlabSharding(self.db_mesh, spec.capacity // d)
        return self.elem_sharding(spec)

    def elem_sharding(self, spec: TableSpec | None = None) -> ElemSharding:
        return ElemSharding(self.db_mesh, self._elem_spec_for(spec))

    # -- the hops ------------------------------------------------------------

    def _stream(self, device: torch.device):
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device=device)
        return stream

    def _whole_value(self, x, lead: int) -> torch.Tensor:
        """``x`` as one tensor: an ``ElemShards`` cut over a mesh is
        concatenated on ``home`` (``lead`` batch dims), a tensor as is."""
        if not isinstance(x, ElemShards):
            return torch.as_tensor(x)
        src = x.placement
        if src.is_fully_replicated:
            return x.blocks[0]
        first = {src.block_of(r): b for r, b in
                 reversed(list(enumerate(x.blocks)))}
        return torch.cat([first[i].to(self.home) for i in range(src.blocks)],
                         dim=lead + src.dim)

    def _place(self, x, layout: ElemSharding, lead: int, copier: _Copier):
        """``x`` (a tensor or an ``ElemShards``; ``lead`` batch dims)
        copied into fresh tensors laid out by ``layout`` on the db mesh:
        one block a db rank when it cuts a dim (rank ``r`` the block of
        its coordinate along the cut axis), else whole on ``home``.
        Blocks of a 1-D emission already cut like ``layout`` are copied
        block for block."""
        if layout.is_fully_replicated:
            return copier.copy(self._whole_value(x, lead), self.home)
        d = layout.blocks
        if isinstance(x, ElemShards) and x.placement.dim == layout.dim \
                and x.placement.mesh.ndim == 1 and len(x.blocks) == d:
            blocks = x.blocks
        else:
            x = self._whole_value(x, lead)
            axis = lead + layout.dim
            blk = x.shape[axis] // d
            blocks = [x.narrow(axis, i * blk, blk) for i in range(d)]
        return ElemShards(tuple(
            copier.copy(blocks[layout.block_of(r)], dev)
            for r, dev in enumerate(layout.mesh.devices)), layout)

    def stage(self, x, spec: TableSpec | None = None):
        """The hop of one element onto the db mesh, in the table's fitted
        element layout: a fresh copy (``ElemShards`` when it cuts a
        dim)."""
        return self._place(x, self.elem_sharding(spec), 0, _Copier())

    def stage_batch(self, values, spec: TableSpec | None = None):
        """A batch with any number of leading batch dims (``put_many``
        sends ``[n, *shape]``, ``put_stream`` may send ``[T, R, *shape]``)
        in one hop; without a spec, one batch dim."""
        ndim = values.blocks[0].dim() if isinstance(values, ElemShards) \
            else torch.as_tensor(values).dim()
        lead = max(1, ndim - len(spec.shape)) if spec is not None else 1
        return self._place(values, self.elem_sharding(spec), lead,
                           _Copier())

    def stage_chunk(self, keys, values, mask, spec: TableSpec | None = None,
                    donate: bool = False) -> StagedChunk:
        """ONE hop for a whole collected chunk: keys, values and mask
        copied onto the db mesh together (keys and mask onto ``home``).
        ``donate=True`` (the overlap pipeline) enqueues the copies on the
        db device's staging stream and returns at once; the chunk's
        ``ready`` event orders its insert after them."""
        stream = None
        if donate and self.home.type == "cuda":
            stream = self._stream(self.home)
        copier = _Copier(stream)
        k = copier.copy(torch.as_tensor(keys), self.home)
        v = self._place(values, self.elem_sharding(spec), 1, copier)
        m = copier.copy(torch.as_tensor(mask), self.home)
        return StagedChunk(k, v, m, copier.run(), copier.sources)

    def stage_to_clients(self, x):
        """The read-side hop: a gathered batch (any tree of tensors) copied
        off the db mesh onto the client mesh's rank-0 device in one
        transfer."""
        copier = _Copier()
        home = self.client_mesh.devices[0]
        return tree_map(lambda t: copier.copy(t, home), x)

    def describe(self) -> str:
        return (f"clustered(clients={tuple(self.client_mesh.shape.items())}, "
                f"db={tuple(self.db_mesh.shape.items())}, "
                f"fan_in={self.fan_in}"
                + (", overlap" if self.overlap else "")
                + (f", slab_axis={self.slab_axis!r}"
                   if self.slab_axis else "") + ")")


class StagingPipeline:
    """The two slots of the overlapped clustered put.

    Slot A (held here) is the *in-flight* chunk: its ``stage_chunk``
    copies are enqueued but its masked insert has not run.  Slot B is the
    chunk being collected, in the caller's hands until its own stage, at
    which point ``swap`` retires slot A for insertion and parks the new
    chunk.  ``drain`` empties slot A without refilling it (capture end,
    or the drain-on-restage flush after a dropped transfer).  Inserts
    therefore run in collect order: the ring's last-writer-wins cannot
    see the pipelining.
    """

    __slots__ = ("_in_flight",)

    def __init__(self):
        self._in_flight = None

    @property
    def pending(self) -> bool:
        return self._in_flight is not None

    def swap(self, staged):
        """Retire the in-flight slot (returned for insertion; ``None`` on
        the first chunk) and park ``staged`` in its place."""
        prev = self._in_flight
        self._in_flight = staged
        return prev

    def drain(self):
        """Empty the in-flight slot without refilling it."""
        prev = self._in_flight
        self._in_flight = None
        return prev


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


def make_clustered_1d(db_fraction: float = 0.25, axis: str = "data",
                      devices=None, elem_spec: tuple = (),
                      slab_axis: str | None = None, overlap: bool = True,
                      faults: FaultPlan | None = None) -> Clustered:
    """Convenience: split ``devices`` (default: every visible card; a
    list may repeat one, ``["cuda:0"] * 4`` is four ranks on one card)
    into client and db 1-D meshes over ``axis`` (``split_devices``) and
    build the ``Clustered`` deployment over them.  ``overlap=False`` is
    the serial stage-then-insert put path."""
    client_devs, db_devs = split_devices(devices, db_fraction)
    return Clustered(
        client_mesh=data_mesh(axis=axis, devices=client_devs),
        db_mesh=data_mesh(axis=axis, devices=db_devs),
        elem_spec=tuple(elem_spec), slab_axis=slab_axis, overlap=overlap,
        faults=faults)


def make_clustered_2d(elem_spec: tuple, db_fraction: float = 0.5,
                      slab_axis: str = "slab", elem_axis: str = "space",
                      client_axis: str = "space", devices=None,
                      slab_shards: int | None = None, overlap: bool = True,
                      faults: FaultPlan | None = None) -> Clustered:
    """A clustered deployment over a 2-D ``(slab, element)`` db grid.

    ``Clustered`` keeps the slot cut and the element cut on disjoint mesh
    axes, so a 1-D db mesh must choose; this factory reshapes the db ranks
    (``split_devices``; ``devices`` may repeat one card) into a
    ``(slab_shards, n_db / slab_shards)`` grid: slots cut over
    ``slab_axis`` (rows), each element laid out over ``elem_axis``
    (columns) by ``elem_spec``.  The client mesh is 1-D over
    ``client_axis``; name it after the producer's axis (default
    ``"space"``) so one ``elem_spec`` reads the same on both sides.
    ``slab_shards=None`` takes 2 when the db pool is even, else 1."""
    used = {a for entry in elem_spec if entry is not None
            for a in ((entry,) if isinstance(entry, str) else entry)}
    if slab_axis in used:
        raise ValueError(
            f"slab_axis {slab_axis!r} also appears in elem_spec "
            f"{tuple(elem_spec)}: the 2-D db mesh gives the slot and element "
            f"partitions their own axes — put the element layout on "
            f"{elem_axis!r}")
    client_devs, db_devs = split_devices(devices, db_fraction)
    n_db = len(db_devs)
    if slab_shards is None:
        slab_shards = 2 if n_db % 2 == 0 and n_db >= 2 else 1
    if slab_shards < 1 or n_db % slab_shards != 0:
        raise ValueError(
            f"slab_shards={slab_shards} does not divide the {n_db}-device "
            f"db pool: the (slab, element) grid needs equal rows")
    db_grid = Mesh(data_mesh(devices=db_devs).devices, (slab_axis, elem_axis),
                   (slab_shards, n_db // slab_shards))
    return Clustered(
        client_mesh=data_mesh(axis=client_axis, devices=client_devs),
        db_mesh=db_grid, elem_spec=tuple(elem_spec), slab_axis=slab_axis,
        overlap=overlap, faults=faults)


def check_deployment(deployment):
    """``deployment`` when the port runs it (``None``, the local store,
    :class:`Colocated` or :class:`Clustered`); any other raises
    ``NotImplementedError``."""
    if deployment is None or isinstance(deployment, (Colocated, Clustered)):
        return deployment
    raise NotImplementedError(
        f"deployment {type(deployment).__name__}: the port runs the local "
        f"store, Colocated and Clustered")
