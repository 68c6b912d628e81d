"""TensorStore: a device-resident in-memory key-value tensor store.

Port of ``src/repro/core/store.py``: tables, the write verbs and
``delete``, the batched gets, ``latest`` and ``poll``, the serving
dispatch, the trainer's random gather (``sample``), its slab-sharded form
(``sample_sharded_impl``), its clustered form on a dedicated db mesh
(``make_clustered_gather``) and the producer's capture family with its
collect-only form (``capture_scan_collect[_multi]``: the chunk a server
armed with a ``FaultPlan`` inserts exactly once).  Each table is a fixed-capacity slab
``[capacity, *elem_shape]`` on the device plus per-slot metadata
(``keys``, ``version``) and scalar cursors (``ptr``, ``count``), with two
engines: ``ring`` (slots from a monotone write pointer) and ``hash``
(slot = key mod capacity).

**Slab-sharded tables.**  Given a ``parallel.sharding.SlabSharding``,
``init_table`` splits the slab along its slot axis into a
:class:`ShardedSlab`: rank ``r`` of the mesh holds slots ``[r·Cl,
(r+1)·Cl)`` as its own ``[Cl, *shape]`` tensor on its device.  Keys,
version, ptr and count stay single tensors on the table's device (one of
the mesh's).  Every write verb runs its slot arithmetic on the global
slots as before and puts each row into its owner's shard at ``slot -
offset``, so the shards, concatenated, hold the bytes an unsharded slab
holds after the same verbs.  A read selects slots once (from the
metadata), gathers each shard's own rows with the ``gather_sharded``
kernel and sums the shards' results with one ``collectives.psum``: each
slot has one owner, so the sum is the plain gather.  The rule, as in the
reference's ``shard_map``: replicated compute (slot selection) runs once
per distinct device of the mesh, per-rank work (the shard gather) once
per rank — on one card, selection once a call and the gather D times.

**Element-sharded tables** (the co-located deployment, ``core.deployment.
Colocated``).  Given a ``parallel.sharding.ElemSharding``, ``init_table``
cuts every element along one of its dims into D equal blocks: an
:class:`ElemShardedSlab` whose rank ``r`` holds ``[capacity, *block]`` on
its own device — the reference's slab placed ``P(None, *elem_spec)``.  The
metadata stays single, as for a :class:`ShardedSlab`.  A write verb takes
either whole values (each rank's block sliced from them and copied to its
device) or an ``ElemShards`` of the ranks' own blocks (what a
domain-decomposed producer emits, written into each rank's shard as it
is), and calls no collective.  A read selects slots once and launches the
gather kernel once per shard on that shard's rows (:func:`_gather_blocks`);
a caller that needs whole elements gets them through ONE counted
``collectives.all_gather`` along the cut dim, decided in one place,
:func:`_gather` — every read verb here returns whole elements.

**Grid tables** (a clustered deployment's 2-D ``(slab, element)`` db
grid, ``core.deployment.make_clustered_2d``, or ``Colocated(
capacity_axis=)`` on a 2-D mesh).  Given a ``parallel.sharding.
GridSharding``, the slab is cut both ways: a :class:`GridSlab` whose rank
``r`` holds, for the slots its slab row owns, its element block.  A write
puts each rank's block of the rows its slab row owns into its shard (no
collective); a read launches the plain gather kernel once per shard and
assembles whole rows with one grouped ``all_gather`` along the element
axis and one grouped ``psum`` along the slab axis (:func:`_gather_grid`).

Differences from the reference, all deliberate:

* Keys are int64 tensors carrying the uint32 key value (torch has no
  uint32 ``remainder``/``searchsorted``); ``EMPTY_KEY`` is 0xFFFFFFFF.
* The write verbs update the table **in place** and return a state that
  shares the slab/keys/version tensors — the reference *donates* the state
  it is given, so in both packages the caller must drop the old state.
  ``ptr`` and ``count`` are fresh 0-d int32 tensors.
* The reference drops filtered-out writes with ``mode="drop"``; an
  out-of-range index faults on CUDA, so the port selects the surviving
  rows instead (the same ``is_last`` last-writer-wins pre-filter, so no
  two writes land on one slot and the scatter order cannot matter).
* ``serve_batch`` calls the registered model ONCE on the whole gathered
  batch (the registry contract of the port takes a leading batch axis;
  see ``StoreServer.set_model``) instead of ``vmap``-ping a per-element
  function.
* ``sample`` takes its random draw as a tensor instead of a ``jax.random``
  key: uniforms in [0, 1) scaled on the device by the live count, so no
  host read is needed (the parity tests feed uniforms that give the
  reference's ranks back).
* ``capture_scan[_multi]`` are host loops over steps (and ranks) that call
  the single-step verbs, instead of one ``lax.scan`` dispatch; the state
  and counters they leave are byte-identical to the reference's.  A step
  that raises leaves the puts before it in place, which a caller commits
  through ``on_put``.  Eager torch compiles nothing, so no chunk is
  padded to its bucket (``bucket_length`` stays for the plan).

``get_many``, ``latest`` and ``sample`` route through the hand-written
probe, sample, gather and sharded-gather kernels
(``repro_torch.kernels.store``) on the card and their plain versions on
the CPU.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.store import ops as _kops
from ..kernels.store.ref import EMPTY_KEY, KEY_DTYPE
from ..parallel import collectives as C
from ..parallel.sharding import (ElemSharding, ElemShards, GridSharding,
                                 SlabSharding)
from ..tree import tree_map

__all__ = [
    "TableSpec", "TableState", "ShardedSlab", "ElemShardedSlab",
    "GridSlab", "ElemShards", "make_key", "name_key",
    "init_table", "put", "put_many", "put_masked", "put_stream", "get",
    "get_many", "serve_batch", "sample", "sample_and_step",
    "sample_sharded_impl", "whole_slab",
    "latest", "poll", "delete", "valid_count", "table_bytes", "slab_bytes",
    "copy_state", "capture_scan", "capture_scan_multi",
    "capture_scan_collect", "capture_scan_collect_multi",
    "capture_emit_count", "capture_emit_count_multi", "capture_rows",
    "bucket_length", "make_clustered_gather", "MIN_BUCKET", "EMPTY_KEY",
    "KEY_DTYPE",
]


def name_key(name: str) -> int:
    """Stable 32-bit key for a string tensor name (crc32, never EMPTY_KEY)."""
    return int(zlib.crc32(name.encode()) & 0xFFFFFFFE)


def make_key(rank, step) -> torch.Tensor:
    """Pack (rank, step) into a uint32 key value (as int64):
    ``1<<31 | step<<12 | rank`` with rank in [0, 2^12), step in [0, 2^19)."""
    rank = torch.as_tensor(rank, dtype=KEY_DTYPE)
    step = torch.as_tensor(step, dtype=KEY_DTYPE)
    key = (1 << 31) | ((step & 0x7FFFF) << 12) | (rank & 0xFFF)
    return torch.where(key == EMPTY_KEY, 0x7FFFFFFF, key)


@dataclass(frozen=True)
class TableSpec:
    """Static description of one store table."""

    name: str
    shape: tuple[int, ...]          # element shape
    dtype: torch.dtype = torch.float32
    capacity: int = 16
    engine: str = "ring"            # "ring" | "hash"

    def __post_init__(self):
        if self.engine not in ("ring", "hash"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")

    @property
    def elem_bytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def slab_bytes(self) -> int:
        return self.capacity * self.elem_bytes


class ShardedSlab(NamedTuple):
    """A slab split along its slot axis: ``shards[r]`` holds the slots
    ``[placement.offset(r), placement.offset(r) + local_cap)`` on rank
    ``r``'s device, a separate allocation per rank."""

    shards: tuple[torch.Tensor, ...]
    placement: SlabSharding


class ElemShardedSlab(NamedTuple):
    """A slab whose elements are cut along one dim: ``shards[r]`` holds
    every slot's rank-``r`` block, ``[capacity, *placement.local_shape(
    shape)]``, on rank ``r``'s device, a separate allocation per rank."""

    shards: tuple[torch.Tensor, ...]
    placement: ElemSharding


class GridSlab(NamedTuple):
    """A slab cut both ways on a 2-D mesh (``placement``, a
    ``GridSharding``): ``shards[r]`` holds rank ``r``'s block of every
    slot its slab row owns, ``[local_cap, *placement.elem.local_shape(
    shape)]``, on rank ``r``'s device, a separate allocation per rank."""

    shards: tuple[torch.Tensor, ...]
    placement: GridSharding


Slab = torch.Tensor | ShardedSlab | ElemShardedSlab | GridSlab


class TableState(NamedTuple):
    """Device-resident state of one table."""

    slab: Slab                # [capacity, *shape], whole or in shards
    keys: torch.Tensor      # int64[capacity]; EMPTY_KEY where never written
    version: torch.Tensor   # int32[capacity]; 0 where empty, else write stamp
    ptr: torch.Tensor       # int32 scalar: next ring slot
    count: torch.Tensor     # int32 scalar: total successful puts (watermark)


def init_table(spec: TableSpec,
               slab_sharding: SlabSharding | ElemSharding | None = None,
               *, device=None) -> TableState:
    """Allocate an empty table on ``device`` (default: the card); with
    ``slab_sharding`` the slab is split over its mesh's devices, one
    of which must be ``device`` (the metadata's): along the slot axis for a
    ``SlabSharding``, along an element dim for an ``ElemSharding`` (one
    that cuts nothing leaves the slab whole).  The positional order is the
    reference's (``init_table(spec, slab_sharding)``)."""
    dev = resolve_device(device)
    shape = (spec.capacity, *spec.shape)
    if isinstance(slab_sharding, ElemSharding) \
            and slab_sharding.dim is None:
        slab_sharding = None
    if slab_sharding is None:
        slab = torch.zeros(shape, dtype=spec.dtype, device=dev)
    elif isinstance(slab_sharding, GridSharding):
        grid = slab_sharding
        if grid.local_cap * grid.slab_shards != spec.capacity:
            raise ValueError(f"table {spec.name!r}: {grid.slab_shards} slab "
                             f"rows of {grid.local_cap} slots != capacity "
                             f"{spec.capacity}")
        local = grid.elem.local_shape(spec.shape)
        slab = GridSlab(tuple(
            torch.zeros((grid.local_cap, *local), dtype=spec.dtype, device=d)
            for d in grid.mesh.devices), grid)
    elif isinstance(slab_sharding, ElemSharding):
        local = slab_sharding.local_shape(spec.shape)
        slab = ElemShardedSlab(tuple(
            torch.zeros((spec.capacity, *local), dtype=spec.dtype, device=d)
            for d in slab_sharding.mesh.devices), slab_sharding)
    else:
        mesh = slab_sharding.mesh
        if slab_sharding.local_cap * mesh.size != spec.capacity:
            raise ValueError(f"table {spec.name!r}: {mesh.size} shards of "
                             f"{slab_sharding.local_cap} slots != capacity "
                             f"{spec.capacity}")
        slab = ShardedSlab(tuple(
            torch.zeros((slab_sharding.local_cap, *spec.shape),
                        dtype=spec.dtype, device=d) for d in mesh.devices),
            slab_sharding)
    keys = torch.full((spec.capacity,), EMPTY_KEY, dtype=KEY_DTYPE,
                      device=dev)
    if slab_sharding is not None \
            and keys.device not in slab_sharding.mesh.distinct_devices:
        raise ValueError(f"table {spec.name!r}: metadata device "
                         f"{keys.device} is not on the slab's mesh")
    return TableState(
        slab=slab,
        keys=keys,
        version=torch.zeros((spec.capacity,), dtype=torch.int32, device=dev),
        ptr=torch.zeros((), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def table_bytes(spec: TableSpec) -> int:
    """Device footprint of the table (slab + metadata) in the reference's
    accounting, which holds keys as uint32: the port's int64 keys take
    ``4 · capacity`` bytes more."""
    return spec.slab_bytes + spec.capacity * (4 + 4) + 8


def _as_keys(keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=KEY_DTYPE)
    return torch.as_tensor(np.asarray(keys).astype(np.int64), device=device)


def _as_values(spec: TableSpec, values, device):
    """``values`` as the table's dtype: a tensor on ``device``, or an
    ``ElemShards`` whose blocks stay on their ranks' devices."""
    if isinstance(values, ElemShards):
        return ElemShards(tuple(b.to(spec.dtype) for b in values.blocks),
                          values.placement)
    return torch.as_tensor(values, dtype=spec.dtype, device=device)


def _rows(values, fn: Callable):
    """``fn`` applied to a tensor, or to every block of an ``ElemShards``
    (a row-wise op: indexing, reshaping or stacking the leading dims)."""
    if isinstance(values, ElemShards):
        return ElemShards(tuple(fn(b) for b in values.blocks),
                          values.placement)
    return fn(values)


def _value_shape(spec: TableSpec, values, lead: tuple) -> tuple | None:
    """The shape ``values`` must have (``lead`` batch dims, then an
    element, or each rank's block of one) when it differs, else None."""
    if isinstance(values, ElemShards):
        want = (*lead, *values.placement.local_shape(spec.shape))
        got = [tuple(b.shape) for b in values.blocks]
        if len(got) == values.placement.mesh.size \
                and all(g == want for g in got):
            return None
        return f"blocks {got} != {values.placement.mesh.size} x {want}"
    got = tuple(values.shape)
    want = (*lead, *spec.shape)
    return None if got == want else f"{got} != {want}"


def _whole(values, lead: int):
    """An ``ElemShards`` assembled into whole values (``lead`` batch dims)
    by one counted ``all_gather``, on rank 0's device; a tensor as is."""
    if not isinstance(values, ElemShards):
        return values
    layout = values.placement
    if layout.dim is None:
        return values.blocks[0]
    mesh = layout.mesh
    if mesh.ndim > 1:
        return C.all_gather(list(values.blocks), mesh, dim=lead + layout.dim,
                            axis=layout.axis)[0]
    return C.all_gather(list(values.blocks), mesh,
                        dim=lead + layout.dim)[mesh.devices[0]]


def whole_slab(slab: Slab) -> torch.Tensor:
    """The slab as one ``[capacity, *shape]`` tensor: a whole slab as it
    is; a slot-sharded one's shards along the slot axis, an
    element-sharded one's blocks along the cut dim, each by one counted
    ``all_gather`` onto rank 0's device.  The one place outside the read
    verbs that knows how shards assemble."""
    if isinstance(slab, torch.Tensor):
        return slab
    layout = slab.placement
    if isinstance(slab, GridSlab):
        rows = list(slab.shards)
        if not layout.elem.is_fully_replicated:
            rows = C.all_gather(rows, layout.mesh, dim=1 + layout.elem.dim,
                                axis=layout.elem_axis)
        return C.all_gather(rows, layout.mesh, dim=0,
                            axis=layout.slab_axis)[0]
    if isinstance(slab, ElemShardedSlab):
        return _whole(ElemShards(slab.shards, layout), 1)
    return C.all_gather(list(slab.shards), layout.mesh,
                        dim=0)[layout.mesh.devices[0]]


def slab_bytes(slab: Slab) -> dict[str, int]:
    """Bytes of slab held on each device (``str(device)`` → bytes)."""
    out: dict[str, int] = {}
    for t in (slab,) if isinstance(slab, torch.Tensor) else slab.shards:
        key = str(t.device)
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def copy_state(state: TableState) -> TableState:
    """A deep copy of a table's state: every tensor cloned on its own
    device, each shard of a :class:`ShardedSlab` too.  The write verbs
    update the slab, keys and version in place, so a snapshot that shared
    them would follow every later write."""
    slab = state.slab
    slab = slab.clone() if isinstance(slab, torch.Tensor) \
        else type(slab)(tuple(t.clone() for t in slab.shards),
                        slab.placement)
    return TableState(slab, state.keys.clone(), state.version.clone(),
                      state.ptr.clone(), state.count.clone())


def _scatter_rows(slab: Slab, idx: torch.Tensor, rows) -> None:
    """``slab[idx] = rows`` in place (``idx`` int64, no slot twice); a
    sharded slab takes each row into its owner's shard, in row order; an
    element-sharded one each rank's block of every row into that rank's
    shard.  ``rows`` is a tensor ``[n, *shape]`` or an ``ElemShards`` of
    the ranks' ``[n, *block]``: laid out like the slab, each block is
    written as it is; otherwise it is assembled first (one all-gather).
    A grid slab takes each rank's block of the rows its slab row owns."""
    if isinstance(slab, GridSlab):
        _scatter_grid(slab, idx, rows)
        return
    if isinstance(slab, ElemShardedSlab):
        layout = slab.placement
        if isinstance(rows, ElemShards) and rows.placement.mesh \
                == layout.mesh and rows.placement.dim == layout.dim:
            blocks = rows.blocks
        else:
            blocks = layout.split(_whole(rows, 1), lead=1)
        for shard, block in zip(slab.shards, blocks):
            shard.index_copy_(0, idx.to(shard.device), block.to(shard.device))
        return
    rows = _whole(rows, 1).to(idx.device)
    if not isinstance(slab, ShardedSlab):
        slab.index_copy_(0, idx, rows)
        return
    # one stable sort by owner keeps each shard's rows in order; one host
    # read of the per-owner counts splits them
    order, counts = _split_by_owner(idx, slab.placement.local_cap,
                                    len(slab.shards))
    for r, (shard, i, v) in enumerate(zip(
            slab.shards, idx.index_select(0, order).split(counts),
            rows.index_select(0, order).split(counts))):
        shard.index_copy_(0, (i - slab.placement.offset(r)).to(shard.device),
                          v.to(shard.device))


def _split_by_owner(idx: torch.Tensor, local_cap: int, owners: int):
    """``(order, counts)``: a stable sort of ``idx`` by owning shard and
    the per-owner counts (one host read), so ``order.split(counts)[i]``
    are owner ``i``'s positions, in row order."""
    owner = idx // local_cap
    order = torch.argsort(owner, stable=True)
    return order, torch.bincount(owner, minlength=owners).tolist()


def _scatter_grid(slab: GridSlab, idx: torch.Tensor, rows) -> None:
    """:func:`_scatter_rows` on a grid slab: rows already laid out like
    the slab's elements (a staged chunk's ``ElemShards``) are written
    block by block, others cut first; each rank writes its block of the
    rows its slab row owns, at ``slot - offset``.  No collective."""
    layout = slab.placement
    elem = layout.elem
    if isinstance(rows, ElemShards) and rows.placement == elem:
        blocks = rows.blocks
    else:
        blocks = elem.split(_whole(rows, 1).to(idx.device), lead=1)
    order, counts = _split_by_owner(idx, layout.local_cap,
                                    layout.slab_shards)
    positions = order.split(counts)
    for r, (shard, block) in enumerate(zip(slab.shards, blocks)):
        i = layout.slab_index(r)
        dev = shard.device
        pos = positions[i]
        shard.index_copy_(0, (idx.index_select(0, pos)
                              - layout.offset(r)).to(dev),
                          block.index_select(0, pos.to(block.device))
                          .to(dev))


def _gather_grid(slab: GridSlab, slots: torch.Tensor) -> torch.Tensor:
    """Whole rows ``slab[slots]`` from a grid slab, on ``slots``' device:
    each rank launches the plain gather kernel once on its own shard at
    its slots clamped into range and zeroes the rows its slab row does
    not own; one grouped ``all_gather`` along the element axis assembles
    whole elements within each slab row, one grouped ``psum`` along the
    slab axis adds the rows' disjoint parts (the reference's rule: an
    element-cut slab reads through the plain gather, never the sharded
    one)."""
    layout = slab.placement
    cap = layout.local_cap
    blocks = []
    for r, shard in enumerate(slab.shards):
        s = slots.to(shard.device)
        off = layout.offset(r)
        rows = _kops.gather_rows(shard, (s - off).clamp(0, cap - 1)
                                 .contiguous())
        owned = ((s >= off) & (s < off + cap)).reshape(
            (-1,) + (1,) * (rows.dim() - 1))
        blocks.append(_zero_unless(owned, rows))
    mesh = layout.mesh
    if not layout.elem.is_fully_replicated:
        blocks = C.all_gather(blocks, mesh, dim=1 + layout.elem.dim,
                              axis=layout.elem_axis)
    return C.psum(blocks, mesh, axis=layout.slab_axis)[0].to(slots.device)


def _gather_sharded(slab: ShardedSlab, slots: dict) -> dict:
    """``slab[slots]`` from a sharded slab: each rank gathers the rows it
    owns (``slots`` from its device's entry of ``{device: int32 [n]}``),
    one ``psum`` sums them → ``{device: rows}``."""
    mesh = slab.placement.mesh
    local = [_kops.gather_rows_sharded(shard, slots[d],
                                       slab.placement.offset(r))
             for r, (shard, d) in enumerate(zip(slab.shards, mesh.devices))]
    return C.psum(local, mesh)


def _gather_blocks(slab: ElemShardedSlab,
                   slots: torch.Tensor) -> ElemShards:
    """Each rank's blocks of rows ``slots`` (int32, in range): the gather
    kernel once per shard, on that shard's device, no collective."""
    return ElemShards(tuple(_kops.gather_rows(shard, slots.to(shard.device))
                            for shard in slab.shards), slab.placement)


def _gather(slab: Slab, slots: torch.Tensor) -> torch.Tensor:
    """Whole rows ``slab[slots]`` (int32, in range) through the gather
    kernels, on ``slots``' device.  THE rule for element-sharded slabs:
    the per-shard gathers of :func:`_gather_blocks`, then one counted
    ``all_gather`` along the cut dim assembles whole elements (every read
    verb returns whole elements)."""
    if isinstance(slab, ElemShardedSlab):
        return _whole(_gather_blocks(slab, slots), 1).to(slots.device)
    if isinstance(slab, GridSlab):
        return _gather_grid(slab, slots)
    if not isinstance(slab, ShardedSlab):
        return _kops.gather_rows(slab, slots)
    mesh = slab.placement.mesh
    return _gather_sharded(slab, {d: slots.to(d) for d in
                                  mesh.distinct_devices})[slots.device]


def _write(state: TableState, keep: torch.Tensor, slots: torch.Tensor,
           keys: torch.Tensor, values: torch.Tensor,
           stamps: torch.Tensor) -> None:
    """Scatter the rows selected by ``keep`` into their slots, in place.
    The callers' last-writer-wins filter leaves at most one kept row per
    slot, so the scatter is order-independent."""
    sel = keep.nonzero(as_tuple=True)[0]
    idx = slots.index_select(0, sel).to(torch.int64)
    _scatter_rows(state.slab, idx, _rows(
        values, lambda b: b.index_select(0, sel.to(b.device))))
    state.keys.index_copy_(0, idx, keys.index_select(0, sel))
    state.version.index_copy_(0, idx, stamps.index_select(0, sel))


def _slot_for_put(spec: TableSpec, state: TableState,
                  key: torch.Tensor) -> torch.Tensor:
    if spec.engine == "ring":
        return state.ptr
    # hash engine: reuse an existing live slot holding this key
    # (idempotent overwrite), else key mod capacity
    homed = (key % spec.capacity).to(torch.int32)
    match = (state.keys == key) & (state.version > 0)
    existing = match.to(torch.int32).argmax().to(torch.int32)
    return torch.where(match.any(), existing, homed)


def put(spec: TableSpec, state: TableState, key, value) -> TableState:
    """Insert/overwrite one element (in place; see module docstring)."""
    dev = state.keys.device
    value = _as_values(spec, value, dev)
    bad = _value_shape(spec, value, ())
    if bad:
        raise ValueError(
            f"put into table {spec.name!r}: value shape {bad} (element "
            f"shape {spec.shape})")
    key = _as_keys(key, dev).reshape(())
    slot = _slot_for_put(spec, state, key).to(torch.int64).reshape(1)
    stamp = state.count + 1
    _scatter_rows(state.slab, slot, _rows(value, lambda b: b.unsqueeze(0)))
    state.keys.index_copy_(0, slot, key.reshape(1))
    state.version.index_copy_(0, slot, stamp.reshape(1))
    new_ptr = (state.ptr + 1) % spec.capacity if spec.engine == "ring" \
        else state.ptr
    return state._replace(ptr=new_ptr, count=stamp)


def put_many(spec: TableSpec, state: TableState, keys, values) -> TableState:
    """Vectorized put of n elements; collisions resolve last-writer-wins
    with every element bumping ``count``, exactly like n single puts (the
    batched hash path probes the homed slot only, as in the reference)."""
    dev = state.keys.device
    keys = _as_keys(keys, dev)
    values = _as_values(spec, values, dev)
    n = keys.shape[0]
    bad = _value_shape(spec, values, (n,))
    if bad:
        raise ValueError(f"put_many into {spec.name!r}: values {bad}")
    i = torch.arange(n, dtype=torch.int32, device=dev)
    if spec.engine == "ring":
        slots = (state.ptr + i) % spec.capacity
        new_ptr = (state.ptr + n) % spec.capacity
        # consecutive ring slots: element i is overwritten only by
        # i + capacity, i + 2·capacity, …
        keep = i + spec.capacity >= n
    else:
        slots = (keys % spec.capacity).to(torch.int32)
        new_ptr = state.ptr
        later_dup = (slots[None, :] == slots[:, None]) \
            & (i[None, :] > i[:, None])
        keep = ~later_dup.any(dim=1)
    stamps = state.count + 1 + i
    _write(state, keep, slots, keys, values, stamps)
    return state._replace(ptr=new_ptr, count=state.count + n)


def put_masked(spec: TableSpec, state: TableState, keys, values,
               mask) -> TableState:
    """Vectorized put of the masked subset of a chunk, in chunk order —
    equal to replaying the masked elements' single puts (slots, stamps,
    ``count`` and last-writer-wins collisions all match)."""
    dev = state.keys.device
    keys = _as_keys(keys, dev)
    values = _as_values(spec, values, dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    n = keys.shape[0]
    bad = _value_shape(spec, values, (n,))
    if bad:
        raise ValueError(f"put_masked into {spec.name!r}: values {bad}")
    m = mask.to(torch.int32)
    r = torch.cumsum(m, 0, dtype=torch.int32) - 1   # emission rank
    total = m.sum(dtype=torch.int32)
    if spec.engine == "ring":
        slots = (state.ptr + r) % spec.capacity
        new_ptr = (state.ptr + total) % spec.capacity
        is_last = r + spec.capacity >= total
    else:
        slots = (keys % spec.capacity).to(torch.int32)
        new_ptr = state.ptr
        i = torch.arange(n, dtype=torch.int32, device=dev)
        # last masked writer per slot (scatter-max); unmasked elements
        # dump into the extra bucket at index `capacity`
        dump = torch.where(mask, slots, spec.capacity).to(torch.int64)
        last = torch.full((spec.capacity + 1,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce(0, dump, i, "amax")
        is_last = last[dump] == i
    stamps = state.count + 1 + r
    _write(state, mask & is_last, slots, keys, values, stamps)
    return state._replace(ptr=new_ptr, count=state.count + total)


def put_stream(spec: TableSpec, state: TableState, keys,
               values) -> TableState:
    """A whole trajectory of sends as one ``put_many``: ``keys [T]`` /
    ``values [T, *shape]``, or ``keys [T, R]`` / ``values [T, R, *shape]``
    (T steps of R ranks, time-major) — equal to the sequence of
    ``put``/``put_many`` calls, last writer winning on a slot."""
    dev = state.keys.device
    keys = _as_keys(keys, dev)
    values = _as_values(spec, values, dev)
    if keys.dim() == 2:
        t, r = keys.shape
        keys = keys.reshape(t * r)
        values = _rows(values, lambda b: b.reshape(t * r, *b.shape[2:]))
    return put_many(spec, state, keys, values)


def get(spec: TableSpec, state: TableState, key):
    """Fetch by key → ``(value, found)``; zeros if absent.  The lowest live
    slot wins (the reference's argmax); ``EMPTY_KEY`` is never found."""
    key = _as_keys(key, state.keys.device).reshape(())
    match = (state.keys == key) & (state.version > 0)
    found = match.any() & (key != EMPTY_KEY)
    idx = match.to(torch.int32).argmax().reshape(1)
    value = state.slab.index_select(0, idx)[0] \
        if isinstance(state.slab, torch.Tensor) \
        else _gather(state.slab, idx.to(torch.int32))[0]
    return torch.where(found, value, torch.zeros_like(value)), found


def get_many(spec: TableSpec, state: TableState, keys):
    """Vectorized get through the probe + gather kernels → ``(values
    [n, *shape], founds [n])``; duplicate keys resolve to the lowest slot."""
    keys = _as_keys(keys, state.keys.device)
    idx, found = _kops.probe_slots(state.keys, state.version, keys)
    safe = idx.clamp(max=spec.capacity - 1)
    values = _gather(state.slab, safe)
    values = torch.where(found.reshape((-1,) + (1,) * len(spec.shape)),
                         values, torch.zeros((), dtype=values.dtype,
                                             device=values.device))
    return values, found


def serve_batch(req_spec: TableSpec, res_spec: TableSpec,
                apply_fn: Callable, req_state: TableState,
                res_state: TableState, params: Any, keys, mask):
    """Serving dispatch: gather requests → model → masked scatter.

    ``apply_fn(params, xs)`` takes the whole gathered batch ``[n, *shape]``
    and returns ``[n, *res_shape]``.  ``mask`` (host-known active slots)
    drives the insert.  Returns ``(new_res_state, found & mask, ys)``.
    """
    dev = req_state.keys.device
    keys = _as_keys(keys, dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    xs, found = get_many(req_spec, req_state, keys)
    ys = apply_fn(params, xs).to(res_spec.dtype)
    new_res = put_masked(res_spec, res_state, keys, ys, mask)
    return new_res, found & mask, ys


def _select(spec: TableSpec, version: torch.Tensor, draw: torch.Tensor):
    """Slot selection of ``sample`` on ``version``'s device → ``(slots
    int32 [n], ok)``."""
    nvalid = (version > 0).sum(dtype=torch.int32)
    top = nvalid.clamp(min=1)
    ranks = torch.minimum((draw.to(version.device) * top).floor()
                          .to(torch.int32), top - 1)
    slots = _kops.sample_slots(version, ranks.contiguous())
    return slots.clamp(max=spec.capacity - 1), nvalid > 0


def _zero_unless(ok: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, values, torch.zeros((), dtype=values.dtype,
                                               device=values.device))


def sample(spec: TableSpec, state: TableState, draw: torch.Tensor):
    """Uniformly sample ``n = len(draw)`` live elements (with replacement):
    the trainer's in-situ data loader.

    ``draw`` holds float uniforms in ``[0, 1)``, turned into ranks on the
    device as ``floor(u · max(nvalid, 1))`` — no host read, so a caller
    holding the table lock never waits for the card.  Returns ``(values
    [n, *shape], keys [n], ok)`` on the table's device; ``ok`` is False
    and the values are zeros when the table is empty.  A sharded slab
    takes :func:`sample_sharded_impl`.
    """
    if isinstance(state.slab, ShardedSlab):
        values, keys, ok = sample_sharded_impl(spec, state, draw)
        return values[state.keys.device], keys, ok
    slots, ok = _select(spec, state.version, draw)
    values = _zero_unless(ok, _gather(state.slab, slots))
    return values, state.keys.index_select(0, slots), ok


def sample_and_step(spec: TableSpec, state: TableState, draw: torch.Tensor,
                    n: int, step_fn: Callable, carry):
    """Fused consumer step: :func:`sample` ``n`` live elements, then the
    training microstep ``step_fn(carry, values) -> (carry, aux)``.
    Returns ``(carry, aux, ok)``.  ``draw`` is the sample's ``[n]``
    uniforms, as for :func:`sample`.  The table is only read: call under
    the table's capture or lock, so the read is ordered against puts."""
    if draw.shape != (n,):
        raise ValueError(f"draw of shape {tuple(draw.shape)} for n={n}")
    values, _, ok = sample(spec, state, draw)
    carry, aux = step_fn(carry, values)
    return carry, aux, ok


def sample_sharded_impl(spec: TableSpec, state: TableState,
                        draw: torch.Tensor):
    """:func:`sample` on a sharded slab, with the batch on every device of
    its placement's mesh: slot selection once per distinct device
    (replicated compute), each rank's owned rows through the
    ``gather_sharded`` kernel, one ``psum`` — bit for bit the plain
    gather, since each slot has one owner.  Returns ``(values {device:
    [n, *shape]}, keys [n], ok)``, keys and ok on the table's device."""
    slab = state.slab
    if not isinstance(slab, ShardedSlab):
        raise ValueError(f"sample_sharded_impl: table {spec.name!r} is not "
                         f"slab-sharded")
    mesh = slab.placement.mesh
    sel = {d: _select(spec, state.version.to(d), draw)
           for d in mesh.distinct_devices}
    values = _gather_sharded(slab, {d: s for d, (s, _) in sel.items()})
    slots, ok = sel[state.keys.device]
    return ({d: _zero_unless(sel[d][1], v) for d, v in values.items()},
            state.keys.index_select(0, slots), ok)


def latest(spec: TableSpec, state: TableState, n: int):
    """The ``n`` most recently written elements, newest first →
    ``(values [n, *shape], keys [n], valid [n])``.  Slots of equal version
    (the empty ones, when ``n`` exceeds the live count) come lowest slot
    first, as the reference's ``top_k`` orders them: a stable descending
    sort (``torch.topk`` promises no order among ties on the card)."""
    if not 0 <= n <= spec.capacity:
        raise ValueError(f"latest: n={n} outside [0, {spec.capacity}]")
    slots = torch.sort(state.version, descending=True,
                       stable=True).indices[:n].to(torch.int32)
    return (_gather(state.slab, slots), state.keys.index_select(0, slots),
            state.version.index_select(0, slots) > 0)


def poll(spec: TableSpec, state: TableState, key) -> torch.Tensor:
    """Does ``key`` live in the table?  ``EMPTY_KEY`` never does."""
    key = _as_keys(key, state.keys.device).reshape(())
    return ((state.keys == key) & (state.version > 0)).any() \
        & (key != EMPTY_KEY)


def valid_count(spec: TableSpec, state: TableState) -> torch.Tensor:
    return (state.version > 0).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# The producer's capture family
# ---------------------------------------------------------------------------

#: The data plane's bucket floor: the smallest power-of-two bucket a fused
#: chunk pads to in the reference (the plan's ``default_chunk`` derives its
#: floor from it).
MIN_BUCKET = 8


def bucket_length(length: int, min_bucket: int = MIN_BUCKET) -> int:
    """Round a chunk length up to the next power-of-two bucket ``>=
    min_bucket``.  The reference compiles one executable per bucket; the
    port runs eagerly and never pads, but the plan still reports it."""
    if length < 1:
        raise ValueError("length must be >= 1")
    n = max(length, min_bucket)
    return 1 << (n - 1).bit_length()


def _constrain_elem(spec: TableSpec, value, elem_sharding, lead: int = 0):
    """An emitted element (with ``lead`` stacked leading axes) in the
    producer's element layout: a whole value is cut into its ranks' blocks
    on their devices; an ``ElemShards`` must already be laid out so.
    ``elem_sharding=None`` (the unsharded path) leaves the value as it
    is."""
    if elem_sharding is None:
        return value
    if isinstance(value, ElemShards):
        if value.placement.mesh != elem_sharding.mesh \
                or value.placement.dim != elem_sharding.dim:
            raise ValueError(f"capture into table {spec.name!r}: the "
                             f"emission's layout {value.placement} is not "
                             f"the producer's {elem_sharding}")
        return value
    value = torch.as_tensor(value).to(spec.dtype)
    return ElemShards(tuple(elem_sharding.split(value, lead)),
                      elem_sharding)


def capture_scan(spec: TableSpec, state: TableState, step_fn: Callable,
                 carry, length: int, emit_every: int = 1, t0: int = 0,
                 on_put: Callable | None = None, elem_sharding=None):
    """Run ``length`` producer steps and their puts: ``step_fn(carry, t)
    -> (carry, key, value)`` for ``t`` in ``t0 .. t0+length-1``; steps
    where ``t % emit_every == 0`` put their value.  ``elem_sharding`` (an
    ``ElemSharding``: a domain-decomposed producer's element layout) holds
    every emission in that layout, so on a table laid out alike each put is
    a rank-local write into each rank's shard, with no collective.

    A host loop over the single-step verb, so the puts land in ring order
    exactly as the reference's one-dispatch scan leaves them — including
    last-writer-wins when more than ``capacity`` steps emit in one call.
    The puts write the table's buffers in place, so ``on_put(state, n)``,
    when given, is called after each put with the state so far and the
    ``n`` puts it added: a caller commits there, and a step that raises
    leaves the earlier puts committed with their ``ptr`` and ``count``.
    Returns ``(state, carry)``; ``capture_emit_count`` gives the put count.
    """
    for t in range(t0, t0 + length):
        carry, key, value = step_fn(carry, t)
        if t % emit_every == 0:
            value = _constrain_elem(spec, value, elem_sharding)
            state = put(spec, state, key, value)
            if on_put is not None:
                on_put(state, 1)
    return state, carry


def capture_emit_count(length: int, emit_every: int = 1, t0: int = 0) -> int:
    """Host-side count of puts a ``capture_scan`` call performs."""
    return sum(1 for t in range(t0, t0 + length) if t % emit_every == 0)


def _rank_clocks(t0, n_ranks: int) -> list[int]:
    """Per-rank start steps from an int or a length-``n_ranks`` sequence."""
    if isinstance(t0, int):
        return [t0] * n_ranks
    clocks = [int(t) for t in (t0.tolist() if isinstance(t0, torch.Tensor)
                               else t0)]
    if len(clocks) != n_ranks:
        raise ValueError(f"t0 has {len(clocks)} clocks for {n_ranks} ranks")
    return clocks


def capture_scan_multi(spec: TableSpec, state: TableState,
                       step_fn: Callable, carry, length: int, n_ranks: int,
                       emit_every: int = 1, t0=0,
                       on_put: Callable | None = None):
    """``n_ranks`` producers advancing in lockstep for ``length`` steps.

    ``step_fn(carry_r, rank, t) -> (carry_r, key, value)`` is one rank's
    step; every leaf of ``carry`` stacks the per-rank states on a leading
    ``[R]`` axis.  ``t0`` is an int or one start step per rank; emission is
    gated on rank 0's clock, and each emitting step writes all R snapshots
    with one ``put_many`` (rank-major), byte-identical to R sequential puts.
    ``on_put`` is called after each ``put_many`` as in :func:`capture_scan`.
    Returns ``(state, carry)``; ``capture_emit_count_multi`` gives the put
    count.
    """
    clocks = _rank_clocks(t0, n_ranks)
    for i in range(length):
        carries, keys, values = [], [], []
        for r in range(n_ranks):
            c_r, key, value = step_fn(tree_map(lambda x: x[r], carry), r,
                                      clocks[r] + i)
            carries.append(c_r)
            keys.append(_as_keys(key, state.keys.device).reshape(()))
            values.append(_as_values(spec, value, state.keys.device))
        carry = tree_map(lambda *xs: torch.stack(xs), *carries)
        if (clocks[0] + i) % emit_every == 0:
            state = put_many(spec, state, torch.stack(keys),
                             torch.stack(values))
            if on_put is not None:
                on_put(state, n_ranks)
    return state, carry


def capture_emit_count_multi(n_ranks: int, length: int, emit_every: int = 1,
                             t0: int = 0) -> int:
    """Host-side count of puts a ``capture_scan_multi`` call performs
    (``t0`` is rank 0's start step, the emission gate's clock)."""
    return n_ranks * capture_emit_count(length, emit_every, t0)


def capture_rows(length: int, emit_every: int = 1) -> int:
    """The most emissions any ``length``-step window can hold."""
    return -(-length // emit_every)


def _emitted(spec: TableSpec, value, lead: tuple = ()):
    """A step's emitted value (a tensor or an ``ElemShards``) as the
    table's dtype, its shape checked."""
    value = _as_values(spec, value, None) if isinstance(value, ElemShards) \
        else torch.as_tensor(value).to(spec.dtype)
    bad = _value_shape(spec, value, lead)
    if bad:
        raise ValueError(f"capture into table {spec.name!r}: value shape "
                         f"{bad}")
    return value


def _pad_rows(v: torch.Tensor, size: int) -> torch.Tensor:
    return torch.cat([v, v.new_zeros((size - v.shape[0], *v.shape[1:]))])


def _pack(spec: TableSpec, keys: list, values: list, size: int,
          elem_sharding=None):
    """The collected emissions, in order, padded with zeros to ``size``
    entries → ``(keys [size], values [size, *shape], mask [size])``;
    ``mask`` marks the filled prefix.  With ``elem_sharding`` the values
    are an ``ElemShards`` of the ranks' ``[size, *block]``, each rank's
    rows on its own device."""
    if elem_sharding is not None:
        dev = elem_sharding.mesh.devices[0]
        local = elem_sharding.local_shape(spec.shape)
        v = ElemShards(tuple(
            _pad_rows(torch.cat([x.blocks[r] for x in values]) if values
                      else torch.zeros((0, *local), dtype=spec.dtype,
                                       device=d), size)
            for r, d in enumerate(elem_sharding.mesh.devices)),
            elem_sharding)
    else:
        dev = values[0].device if values else torch.device("cpu")
        v = _pad_rows(torch.cat(values) if values
                      else torch.zeros((0, *spec.shape), dtype=spec.dtype,
                                       device=dev), size)
    k = torch.cat(keys).to(dev) if keys \
        else torch.zeros((0,), dtype=KEY_DTYPE, device=dev)
    n = k.shape[0]
    k = _pad_rows(k, size)
    return k, v, torch.arange(size, device=dev) < n


def capture_scan_collect(spec: TableSpec, step_fn: Callable, carry,
                         length: int, emit_every: int = 1, t0: int = 0,
                         elem_sharding=None):
    """:func:`capture_scan`'s steps with the would-be puts **collected**
    instead of applied: no table is touched.  The emitting steps fill a
    compact ``rows = capture_rows(length, emit_every)`` buffer in step
    order; replaying its masked prefix with :func:`put_masked` leaves the
    bytes :func:`capture_scan` leaves.  The server's exactly-once insert
    (``StoreServer.apply_chunk``) takes the chunk whole.

    Returns ``(carry, keys [rows], values [rows, *shape], mask [rows])``;
    with ``elem_sharding`` the values are an ``ElemShards`` of each rank's
    ``[rows, *block]``, collected on its own device.
    """
    keys, values, layout = [], [], elem_sharding
    for t in range(t0, t0 + length):
        carry, key, value = step_fn(carry, t)
        value = _emitted(spec, _constrain_elem(spec, value, elem_sharding))
        if isinstance(value, ElemShards):
            layout = value.placement
        if t % emit_every == 0:
            keys.append(_as_keys(key, None).reshape(1))
            values.append(_rows(value, lambda b: b.unsqueeze(0)))
    return (carry, *_pack(spec, keys, values,
                          capture_rows(length, emit_every), layout))


def capture_scan_collect_multi(spec: TableSpec, step_fn: Callable, carry,
                               length: int, n_ranks: int,
                               emit_every: int = 1, t0=0):
    """:func:`capture_scan_multi`'s lockstep steps (per-rank ``t0``
    clocks, emission gated on rank 0's), collected instead of put.

    Returns ``(carry, keys [rows·R], values [rows·R, *shape], mask
    [rows·R])``, rank-major within each emitting step, so the masked
    replay leaves the bytes :func:`capture_scan_multi` leaves.
    """
    clocks = _rank_clocks(t0, n_ranks)
    keys, values = [], []
    for i in range(length):
        carries, ks, vs = [], [], []
        for r in range(n_ranks):
            c_r, key, value = step_fn(tree_map(lambda x: x[r], carry), r,
                                      clocks[r] + i)
            carries.append(c_r)
            vs.append(torch.as_tensor(value))
            ks.append(_as_keys(key, vs[-1].device).reshape(()))
        carry = tree_map(lambda *xs: torch.stack(xs), *carries)
        step_values = _emitted(spec, torch.stack(vs), (n_ranks,))
        if (clocks[0] + i) % emit_every == 0:
            keys.append(torch.stack(ks))
            values.append(step_values)
    return (carry, *_pack(spec, keys, values,
                          capture_rows(length, emit_every) * n_ranks))


def delete(spec: TableSpec, state: TableState, key) -> TableState:
    """Tombstone every slot holding ``key`` (in place; the slab's bytes
    stay where they are, as in the reference)."""
    key = _as_keys(key, state.keys.device).reshape(())
    match = state.keys == key
    state.version.masked_fill_(match, 0)
    state.keys.masked_fill_(match, EMPTY_KEY)
    return state


def make_clustered_gather(spec: TableSpec, n: int, db_mesh=None,
                          axis: str | None = None, shards: int = 1,
                          mode: str | None = None) -> Callable:
    """The db-mesh half of the clustered read path: ONE store op sampling
    ``n`` elements from the table on its own mesh.

    With ``shards > 1`` the slab is slot-partitioned over the db mesh
    (``axis`` names its axis) and the gather runs shard-local:
    :func:`sample_sharded_impl`, the ``gather_sharded`` kernel once per db
    shard and one ``psum``; the assembled batch then leaves the mesh in
    the caller's staged transfer.  Otherwise :func:`sample` (the plain
    ``sample`` and ``gather`` kernels).  Like :func:`sample`, it takes
    ``n`` uniform draws in ``[0, 1)``, not a ``jax.random`` key.

    Returns ``fn(state, draw) -> (values [n, *shape], ok)``, on the
    table's device.  ``mode`` keeps the reference's signature (the port's
    kernels choose their route by device)."""
    if shards > 1 and db_mesh is not None and axis is not None \
            and axis not in db_mesh.axis_names:
        raise ValueError(f"make_clustered_gather: axis {axis!r} is not an "
                         f"axis of the db mesh {db_mesh.axis_names}")

    def gather(state: TableState, draw: torch.Tensor):
        if draw.shape != (n,):
            raise ValueError(f"draw of shape {tuple(draw.shape)} for n={n}")
        if shards > 1:
            values, _, ok = sample_sharded_impl(spec, state, draw)
            return values[state.keys.device], ok
        values, _, ok = sample(spec, state, draw)
        return values, ok

    return gather
