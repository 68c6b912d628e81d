"""TensorStore: a device-resident in-memory key-value tensor store.

Port of ``src/repro/core/store.py`` — the single-device subset: tables,
the write verbs, the batched gets, the serving dispatch, the trainer's
random gather (``sample``) and the producer's capture family.  Each table
is a fixed-capacity slab ``[capacity, *elem_shape]`` on the device plus
per-slot metadata (``keys``, ``version``) and scalar cursors (``ptr``,
``count``), with two engines: ``ring`` (slots from a monotone write
pointer) and ``hash`` (slot = key mod capacity).

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

``get_many`` and ``sample`` route through the hand-written probe, sample
and gather kernels (``repro_torch.kernels.store``) on the card and their
plain versions on the CPU.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.store import ops as _kops
from ..tree import tree_map
from ..kernels.store.ref import EMPTY_KEY, KEY_DTYPE

__all__ = [
    "TableSpec", "TableState", "make_key", "name_key", "init_table",
    "put", "put_many", "put_masked", "put_stream", "get", "get_many",
    "serve_batch", "sample", "valid_count", "capture_scan",
    "capture_scan_multi", "capture_emit_count", "capture_emit_count_multi",
    "capture_rows", "bucket_length", "MIN_BUCKET", "EMPTY_KEY", "KEY_DTYPE",
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


class TableState(NamedTuple):
    """Device-resident state of one table."""

    slab: torch.Tensor      # [capacity, *shape]
    keys: torch.Tensor      # int64[capacity]; EMPTY_KEY where never written
    version: torch.Tensor   # int32[capacity]; 0 where empty, else write stamp
    ptr: torch.Tensor       # int32 scalar: next ring slot
    count: torch.Tensor     # int32 scalar: total successful puts (watermark)


def init_table(spec: TableSpec, device=None) -> TableState:
    """Allocate an empty table on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return TableState(
        slab=torch.zeros((spec.capacity, *spec.shape), dtype=spec.dtype,
                         device=dev),
        keys=torch.full((spec.capacity,), EMPTY_KEY, dtype=KEY_DTYPE,
                        device=dev),
        version=torch.zeros((spec.capacity,), dtype=torch.int32, device=dev),
        ptr=torch.zeros((), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _as_keys(keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=KEY_DTYPE)
    return torch.as_tensor(np.asarray(keys).astype(np.int64), device=device)


def _as_values(spec: TableSpec, values, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=spec.dtype, device=device)


def _write(state: TableState, keep: torch.Tensor, slots: torch.Tensor,
           keys: torch.Tensor, values: torch.Tensor,
           stamps: torch.Tensor) -> None:
    """Scatter the rows selected by ``keep`` into their slots, in place.
    The callers' last-writer-wins filter leaves at most one kept row per
    slot, so the scatter is order-independent."""
    sel = keep.nonzero(as_tuple=True)[0]
    idx = slots.index_select(0, sel).to(torch.int64)
    state.slab.index_copy_(0, idx, values.index_select(0, sel))
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
    dev = state.slab.device
    value = _as_values(spec, value, dev)
    if tuple(value.shape) != spec.shape:
        raise ValueError(
            f"put into table {spec.name!r}: value shape "
            f"{tuple(value.shape)} != element shape {spec.shape}")
    key = _as_keys(key, dev).reshape(())
    slot = _slot_for_put(spec, state, key).to(torch.int64).reshape(1)
    stamp = state.count + 1
    state.slab.index_copy_(0, slot, value.unsqueeze(0))
    state.keys.index_copy_(0, slot, key.reshape(1))
    state.version.index_copy_(0, slot, stamp.reshape(1))
    new_ptr = (state.ptr + 1) % spec.capacity if spec.engine == "ring" \
        else state.ptr
    return state._replace(ptr=new_ptr, count=stamp)


def put_many(spec: TableSpec, state: TableState, keys, values) -> TableState:
    """Vectorized put of n elements; collisions resolve last-writer-wins
    with every element bumping ``count``, exactly like n single puts (the
    batched hash path probes the homed slot only, as in the reference)."""
    dev = state.slab.device
    keys = _as_keys(keys, dev)
    values = _as_values(spec, values, dev)
    n = keys.shape[0]
    if tuple(values.shape) != (n, *spec.shape):
        raise ValueError(
            f"put_many into {spec.name!r}: values {tuple(values.shape)} != "
            f"({n}, *{spec.shape})")
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
    dev = state.slab.device
    keys = _as_keys(keys, dev)
    values = _as_values(spec, values, dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    n = keys.shape[0]
    if tuple(values.shape) != (n, *spec.shape):
        raise ValueError(
            f"put_masked into {spec.name!r}: values {tuple(values.shape)} "
            f"!= ({n}, *{spec.shape})")
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
    dev = state.slab.device
    keys = _as_keys(keys, dev)
    values = _as_values(spec, values, dev)
    if keys.dim() == 2:
        t, r = keys.shape
        keys = keys.reshape(t * r)
        values = values.reshape(t * r, *values.shape[2:])
    return put_many(spec, state, keys, values)


def get(spec: TableSpec, state: TableState, key):
    """Fetch by key → ``(value, found)``; zeros if absent.  The lowest live
    slot wins (the reference's argmax); ``EMPTY_KEY`` is never found."""
    key = _as_keys(key, state.slab.device).reshape(())
    match = (state.keys == key) & (state.version > 0)
    found = match.any() & (key != EMPTY_KEY)
    idx = match.to(torch.int32).argmax().reshape(1)
    value = state.slab.index_select(0, idx)[0]
    return torch.where(found, value, torch.zeros_like(value)), found


def get_many(spec: TableSpec, state: TableState, keys):
    """Vectorized get through the probe + gather kernels → ``(values
    [n, *shape], founds [n])``; duplicate keys resolve to the lowest slot."""
    keys = _as_keys(keys, state.slab.device)
    idx, found = _kops.probe_slots(state.keys, state.version, keys)
    safe = idx.clamp(max=spec.capacity - 1)
    values = _kops.gather_rows(state.slab, safe)
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
    dev = req_state.slab.device
    keys = _as_keys(keys, dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    xs, found = get_many(req_spec, req_state, keys)
    ys = apply_fn(params, xs).to(res_spec.dtype)
    new_res = put_masked(res_spec, res_state, keys, ys, mask)
    return new_res, found & mask, ys


def sample(spec: TableSpec, state: TableState, draw: torch.Tensor):
    """Uniformly sample ``n = len(draw)`` live elements (with replacement):
    the trainer's in-situ data loader.

    ``draw`` holds float uniforms in ``[0, 1)``, turned into ranks on the
    device as ``floor(u · max(nvalid, 1))`` — no host read, so a caller
    holding the table lock never waits for the card.  Returns ``(values
    [n, *shape], keys [n], ok)``; ``ok`` is False and the values are zeros
    when the table is empty.
    """
    dev = state.version.device
    nvalid = (state.version > 0).sum(dtype=torch.int32)
    ok = nvalid > 0
    top = nvalid.clamp(min=1)
    ranks = torch.minimum((draw.to(dev) * top).floor().to(torch.int32),
                          top - 1)
    slots = _kops.sample_slots(state.version, ranks.contiguous())
    slots = slots.clamp(max=spec.capacity - 1)
    values = _kops.gather_rows(state.slab, slots)
    values = torch.where(ok, values, torch.zeros((), dtype=values.dtype,
                                                 device=dev))
    return values, state.keys.index_select(0, slots), ok


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


def capture_scan(spec: TableSpec, state: TableState, step_fn: Callable,
                 carry, length: int, emit_every: int = 1, t0: int = 0,
                 on_put: Callable | None = None):
    """Run ``length`` producer steps and their puts: ``step_fn(carry, t)
    -> (carry, key, value)`` for ``t`` in ``t0 .. t0+length-1``; steps
    where ``t % emit_every == 0`` put their value.

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
            keys.append(_as_keys(key, state.slab.device).reshape(()))
            values.append(_as_values(spec, value, state.slab.device))
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


def _not_ported(name: str, item: str) -> Callable:
    def fn(*_args, **_kwargs):
        raise NotImplementedError(f"store.{name}: ROADMAP.md {item}")
    fn.__name__ = name
    return fn


sample_and_step = _not_ported("sample_and_step",
                              "A8 (what the training slice left out)")
latest = _not_ported("latest", "A3 (reproducer)")
poll = _not_ported("poll", "A3 (reproducer)")
delete = _not_ported("delete", "A4 (fault recovery)")
capture_scan_collect = _not_ported("capture_scan_collect",
                                   "A5 (multi-device tiers)")
capture_scan_collect_multi = _not_ported("capture_scan_collect_multi",
                                         "A5 (multi-device tiers)")
sample_sharded_impl = _not_ported("sample_sharded_impl",
                                  "A5 (multi-device tiers)")
make_clustered_gather = _not_ported("make_clustered_gather",
                                    "A5 (multi-device tiers)")
