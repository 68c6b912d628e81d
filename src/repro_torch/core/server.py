"""StoreServer: the host-side owner of TensorStore state.

Port of ``src/repro/core/server.py`` — the local deployment: tables on
the server's device (a table's slab optionally split over a mesh, the
slab-sharded data plane), per-table locks, host metadata with cached
(lock-free) watermarks, capture transactions, the fused serving dispatch,
the random gather, the model registry and ``stats()``.

Host threads call the server's verbs; each verb launches the store op on
the device (asynchronously, on PyTorch's current stream) while holding the
table's lock, so writes and reads of one table are ordered.  The server-
wide lock guards only the registries.

**Faults.**  A declared ``FaultPlan`` (even an empty one) arms the
recovery machinery: a ``FaultInjector`` every client consults, the
acknowledged-chunk-id set that makes :meth:`apply_chunk` and
:meth:`serve_batch` exactly-once, a per-table write-ahead log of every
committed write, and the declared operator actions at commit boundaries
(``snapshot`` parks a deep copy of every table and truncates the replay
tail; ``restart`` rebuilds every table from that copy and replays the
tail).  The write verbs update a table in place, so :meth:`snapshot`,
:meth:`restore` and the recovery image copy every tensor of a table
(``store.copy_state``), and the log holds copies of the payloads it is
given.

**Deployments.**  A deployment (``core.deployment``) places every table
by its rule (``slab_sharding(spec)``) and its ``faults`` arm the server
when ``faults`` is not given.  ``Colocated(...)`` cuts each element over
the producer's mesh, so a domain-decomposed emission is written
rank-local; nothing crosses a mesh and ``staged_transfers`` stays 0.
``Clustered(...)`` keeps the tables on its db mesh, which must hold the
server's device: every write verb stages its payload onto that mesh
first (``_staged``, ``_staged_batch``), a fused chunk crosses in ONE hop
(:meth:`stage_chunk`, :meth:`apply_chunk`, or the overlap pipeline's
:meth:`stage_chunk_logged` then :meth:`insert_chunk`), and
:meth:`sample_staged` gathers on the db mesh and moves the batch back
to the clients.  ``staged_transfers`` counts one per hop, where the
reference counts: a dropped transfer has paid its hop, a duplicated one
pays one more, and a deferred insert never counts.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import _canonical
from ..tree import tree_map
from . import store as S
from .deployment import Colocated, check_deployment
from .faults import (FaultInjector, FaultPlan, StoreTimeout,
                     WatermarkTimeout)
from .telemetry import Timers, poll_backoff

__all__ = ["StoreServer", "CaptureTxn", "PendingChunk"]


class PendingChunk:
    """An in-flight slot of the overlap staging pipeline: the chunk's
    ``stage_chunk`` copies are enqueued (and its hop counted) but its
    masked insert has not run.  ``keys``/``values``/``mask`` are the
    *staged* (db-placed, store-owned) tensors and ``staged`` the
    deployment's ``StagedChunk`` (its copies' event and sources), so the
    deferred :meth:`StoreServer.insert_chunk` is a db-mesh op with no
    further hop."""

    __slots__ = ("chunk_id", "keys", "values", "mask", "puts", "staged")

    def __init__(self, chunk_id: tuple, keys, values, mask, puts: int,
                 staged=None):
        self.chunk_id = chunk_id
        self.keys = keys
        self.values = values
        self.mask = mask
        self.puts = puts
        self.staged = staged

    def wait(self) -> None:
        """Order the current stream after the chunk's copies (a no-op
        where they ran in stream order)."""
        if self.staged is not None:
            self.staged.wait()


class CaptureTxn:
    """One capture transaction on a single table.

    ``state`` holds the checked-out ``TableState``; assign the updated
    state back to commit, and set ``puts`` to the number of put operations
    performed so the cached watermark stays exact
    (``store.capture_emit_count``).  Read-only captures (consumers) leave
    ``state`` untouched.
    """

    __slots__ = ("spec", "state", "puts", "_orig")

    def __init__(self, spec: S.TableSpec, state: S.TableState):
        self.spec = spec
        self.state = state
        self.puts = 0
        self._orig = state


class StoreServer:
    """Thread-safe owner of a set of store tables plus the model registry."""

    def __init__(self, deployment=None, timers: Timers | None = None,
                 faults: FaultPlan | None = None, *, device=None):
        self.deployment = check_deployment(deployment)
        if faults is None:
            faults = getattr(deployment, "faults", None)
        self.timers = timers or Timers()
        self.device = resolve_device(device)
        db_mesh = getattr(self.deployment, "db_mesh", None)
        if db_mesh is not None \
                and _canonical(self.device) not in db_mesh.distinct_devices:
            raise ValueError(f"server device {self.device} is not on the "
                             f"clustered db mesh {db_mesh.devices}")
        self._lock = threading.RLock()           # registries + metadata only
        self._table_locks: dict[str, threading.RLock] = {}
        self._specs: dict[str, S.TableSpec] = {}
        self._state: dict[str, S.TableState] = {}
        self._placements: dict[str, Any] = {}
        self._counts: dict[str, int] = {}        # cached watermarks
        self._models: dict[str, tuple[Callable, Any]] = {}
        self._model_versions: dict[str, int] = {}  # hot-swap generations
        self.model_swaps = 0                     # serving weight adoptions
        self._meta: dict[str, Any] = {}          # tiny host-side metadata KV
        self._meta_event = threading.Condition(self._lock)
        self._ops_lock = threading.Lock()
        self.op_count = 0                        # dispatched store ops
        self.staged_transfers = 0                # cross-mesh staging hops
        self._gathers: dict[tuple, Callable] = {}  # clustered gather cache
        # the fault/recovery machinery, armed by a declared FaultPlan (an
        # empty one too: a fault-free baseline takes this path as well)
        self.faults = FaultInjector(faults) if faults is not None else None
        self.wal_enabled = faults is not None
        self.retries = 0                         # verb retries (clients')
        self.recoveries = 0                      # completed store restarts
        self._wal: dict[str, list] = {}          # per-table write-ahead log
        self._wal_base: dict[str, int] = {}      # replay floor (snapshot)
        self._acked: set = set()                 # applied chunk ids
        self._recovery: dict[str, S.TableState] | None = None

    def _bump_ops(self, n: int = 1) -> None:
        with self._ops_lock:
            self.op_count += n

    def _bump_staged(self, n: int = 1) -> None:
        with self._ops_lock:
            self.staged_transfers += n

    def _bump_retry(self, n: int = 1) -> None:
        with self._ops_lock:
            self.retries += n

    # -- table management ---------------------------------------------------

    def create_table(self, spec: S.TableSpec, deployment=None,
                     slab_sharding=None) -> S.TableSpec:
        """Register + allocate a table on the server's device.
        ``slab_sharding`` (``parallel.sharding.slab_sharding``, or an
        ``ElemSharding``) splits its slab over a mesh that holds that
        device; when it is ``None`` the deployment's placement rule
        applies (``deployment``, else the server's)."""
        dep = check_deployment(deployment or self.deployment)
        if slab_sharding is None and dep is not None:
            slab_sharding = dep.slab_sharding(spec)
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(f"table {spec.name!r} already exists")
            self._state[spec.name] = S.init_table(spec, slab_sharding,
                                                  device=self.device)
            self._specs[spec.name] = spec
            self._placements[spec.name] = slab_sharding
            self._table_locks[spec.name] = threading.RLock()
            self._counts[spec.name] = 0
            self._wal[spec.name] = []
            self._wal_base[spec.name] = 0
        return spec

    def placement(self, table: str):
        """The slab sharding ``table`` was created with (``None``: whole on
        the server's device)."""
        return self._placements[table]

    def spec(self, table: str) -> S.TableSpec:
        return self._specs[table]

    def tables(self) -> list[str]:
        return list(self._specs)

    def hbm_bytes(self) -> int:
        """Every table's footprint (``store.table_bytes``), summed."""
        return sum(S.table_bytes(sp) for sp in self._specs.values())

    def table_lock(self, table: str) -> threading.RLock:
        """The per-table lock (dispatch ordering for fused captures)."""
        return self._table_locks[table]

    # -- capture transactions ------------------------------------------------

    def checkout(self, table: str) -> S.TableState:
        with self._table_locks[table]:
            return self._state[table]

    def commit(self, table: str, new_state: S.TableState,
               puts: int = 0) -> None:
        """Swap in a state produced outside a capture; ``puts`` keeps the
        cached watermark exact without a device read."""
        with self._table_locks[table]:
            self._state[table] = new_state
            self._counts[table] += puts
        self._bump_ops()

    @contextlib.contextmanager
    def capture(self, table: str):
        """Checkout → work → commit, atomically under the table lock.
        Yields a :class:`CaptureTxn`.

        An assigned ``txn.state`` commits even if the body then raises:
        the port's write verbs update the checked-out buffers in place
        (the reference's donation), so there is nothing to roll back to.
        A body that raises without assigning leaves the table untouched.
        One capture is one store op, read-only captures included; a
        committed one is a commit boundary of an armed ``FaultPlan``.
        """
        committed = False
        with self._table_locks[table]:
            txn = CaptureTxn(self._specs[table], self._state[table])
            try:
                yield txn
            finally:
                if txn.state is not txn._orig:
                    self._state[table] = txn.state
                    self._counts[table] += txn.puts
                    committed = True
        self._bump_ops()
        if committed:
            self._after_commit(table)

    # -- staging (the clustered deployment's hops) ---------------------------

    def _crossing(self) -> bool:
        dep = self.deployment
        return dep is not None and dep.crosses_mesh

    def _staged(self, value, spec: S.TableSpec | None = None):
        """Stage one element onto the store placement (the per-verb path),
        in the table's own element layout, counting one staged transfer
        when the deployment crosses meshes."""
        if not self._crossing():
            return value
        self._bump_staged()
        return self.deployment.stage(value, spec)

    def _staged_batch(self, values, spec: S.TableSpec | None = None):
        """Stage a batch (any leading batch dims) in ONE transfer."""
        if not self._crossing():
            return values
        self._bump_staged()
        return self.deployment.stage_batch(values, spec)

    def stage_chunk(self, table: str, keys, values, mask):
        """Stage a whole collected chunk (keys, values, emit mask) onto
        the store placement as ONE counted hop; a no-op, not counted, on a
        deployment that never crosses meshes."""
        if not self._crossing():
            return keys, values, mask
        self._bump_staged()
        return tuple(self.deployment.stage_chunk(keys, values, mask,
                                                 self._specs[table]))

    # lint: holds-lock — runs inside the caller's capture txn (table lock)
    def apply_chunk(self, table: str, chunk_id: tuple, txn: CaptureTxn,
                    keys, values, mask, puts: int) -> None:
        """Exactly-once insert of one collected chunk
        (``store.capture_scan_collect[_multi]``) into ``txn``'s table: the
        write path of every fused capture once a ``FaultPlan`` is armed
        or the deployment crosses meshes.

        ``chunk_id`` is the client's stable ``(rank, seq)``: the SAME id
        on every retry of one chunk, a new id per chunk.  On a crossing
        deployment the hop is counted first; then the injector is
        consulted: a declared drop raises ``TransferDropped`` before
        anything is applied (the hop is paid; the client retries under the
        same id), a declared duplicate delivers the chunk twice (one more
        hop) and the acknowledged set makes the second delivery a no-op
        (``put_masked`` is not idempotent: ``ptr`` and ``count`` advance
        on every apply).  The applied chunk, staged, is logged for
        replay."""
        spec = self._specs[table]
        crossing = self._crossing()
        if crossing:
            self._bump_staged()
        dup = self.faults.on_stage(table) if self.faults is not None \
            else False
        if chunk_id not in self._acked:
            if crossing:
                keys, values, mask = self.deployment.stage_chunk(
                    keys, values, mask, spec)
            txn.state = S.put_masked(spec, txn.state, keys, values, mask)
            txn.puts = puts
            self._acked.add(chunk_id)
            if self.wal_enabled:
                self._wal[table].append(("chunk", (keys, values, mask),
                                         puts))
        if dup and crossing:
            # the duplicate delivery crosses too; the ack set drops it
            self._bump_staged()

    def stage_chunk_logged(self, table: str, chunk_id: tuple, keys, values,
                           mask, puts: int) -> PendingChunk:
        """First half of the overlapped exactly-once apply
        (:meth:`apply_chunk` split at the wire): count the hop, consult
        the injector, enqueue the chunk's copies on the staging stream
        (``stage_chunk(..., donate=True)``) and hand back the in-flight
        :class:`PendingChunk` for the client's two-slot pipeline.  The
        hop counts once per crossing, at stage time, exactly as on the
        serial path; the deferred insert never counts."""
        spec = self._specs[table]
        crossing = self._crossing()
        if crossing:
            self._bump_staged()
        # may raise TransferDropped (hop paid, nothing in flight)
        dup = self.faults.on_stage(table) if self.faults is not None \
            else False
        staged = None
        if crossing:
            staged = self.deployment.stage_chunk(keys, values, mask, spec,
                                                 donate=True)
            keys, values, mask = staged
        if dup and crossing:
            self._bump_staged()
        return PendingChunk(chunk_id, keys, values, mask, puts, staged)

    # lint: holds-lock — runs inside the caller's capture txn (table lock)
    def insert_chunk(self, table: str, txn: CaptureTxn,
                     pending: PendingChunk) -> None:
        """Second half of the overlapped apply: the masked insert of an
        in-flight staged chunk inside the caller's capture txn, after its
        copies (the current stream waits on their event).
        Deduplicated by the ack set like :meth:`apply_chunk` and logged
        with the staged tensors, which the store owns, so a restart
        replays it byte for byte."""
        pending.wait()
        if pending.chunk_id in self._acked:
            return
        spec = self._specs[table]
        txn.state = S.put_masked(spec, txn.state, pending.keys,
                                 pending.values, pending.mask)
        txn.puts += pending.puts
        self._acked.add(pending.chunk_id)
        if self.wal_enabled:
            self._wal[table].append(("chunk", (pending.keys, pending.values,
                                               pending.mask), pending.puts))

    def _after_commit(self, table: str) -> None:
        """The declared operator actions at a commit boundary: ``snapshot``
        parks a recovery image (and truncates the replay tail),
        ``restart`` rebuilds the store from it."""
        if self.faults is None:
            return
        for act in self.faults.on_commit(table):
            if act == "snapshot":
                self._take_recovery_snapshot()
            else:
                self._restart_and_recover()

    # -- verbs ---------------------------------------------------------------

    def _logged(self, spec: S.TableSpec, keys, values, batch: bool = True):
        """A write's payload on the table's device, staged onto the store
        placement first on a crossing deployment (one counted hop:
        ``batch`` for the batched verbs); copied when the log keeps it,
        since the caller may reuse its tensors (a staged payload is
        already the store's own copy)."""
        staged = self._crossing()
        if staged:
            values = self._staged_batch(values, spec) if batch \
                else self._staged(values, spec)
        keys = S._as_keys(keys, self.device)
        values = S._as_values(spec, values, self.device)
        if self.wal_enabled:
            keys = keys.clone()
            if not staged:
                values = S._rows(values, torch.clone)
        return keys, values

    def put(self, table: str, key, value) -> None:
        spec = self._specs[table]
        key, value = self._logged(spec, key, value, batch=False)
        with self._table_locks[table]:
            self._state[table] = S.put(spec, self._state[table], key, value)
            self._counts[table] += 1
            if self.wal_enabled:
                self._wal[table].append(("put", (key, value), 1))
        self._bump_ops()
        self._after_commit(table)

    def put_many(self, table: str, keys, values) -> None:
        """One op for ``len(keys)`` puts (``store.put_many``)."""
        spec = self._specs[table]
        keys, values = self._logged(spec, keys, values)
        n = int(keys.shape[0])
        with self._table_locks[table]:
            self._state[table] = S.put_many(spec, self._state[table], keys,
                                            values)
            self._counts[table] += n
            if self.wal_enabled:
                self._wal[table].append(("put_many", (keys, values), n))
        self._bump_ops()
        self._after_commit(table)

    def put_stream(self, table: str, keys, values) -> None:
        """One op for a whole trajectory of sends (``store.put_stream``)."""
        spec = self._specs[table]
        keys, values = self._logged(spec, keys, values)
        n = keys.numel()
        with self._table_locks[table]:
            self._state[table] = S.put_stream(spec, self._state[table], keys,
                                              values)
            self._counts[table] += n
            if self.wal_enabled:
                self._wal[table].append(("put_stream", (keys, values), n))
        self._bump_ops()
        self._after_commit(table)

    def delete(self, table: str, key) -> None:
        """Tombstone ``key`` (``store.delete``).  Logged like a write: a
        replay that skipped deletes would resurrect dead keys."""
        spec = self._specs[table]
        key = S._as_keys(key, self.device)
        with self._table_locks[table]:
            self._state[table] = S.delete(spec, self._state[table], key)
            if self.wal_enabled:
                self._wal[table].append(("delete", (key.clone(),), 0))
        self._bump_ops()
        self._after_commit(table)

    def get(self, table: str, key):
        spec = self._specs[table]
        with self._table_locks[table]:
            out = S.get(spec, self._state[table], key)
        self._bump_ops()
        return out

    def get_many(self, table: str, keys):
        """Batched get through the probe and gather kernels
        (``store.get_many``) → ``(values [n, *shape], founds [n])``."""
        spec = self._specs[table]
        with self._table_locks[table]:
            out = S.get_many(spec, self._state[table], keys)
        self._bump_ops()
        return out

    def serve_batch(self, req_table: str, res_table: str, keys, mask,
                    apply_fn, params, chunk_id: tuple | None = None):
        """Drain one continuous-batching batch in ONE dispatch: gather the
        active requests from ``req_table``, apply the bound model to the
        whole batch, scatter the responses into ``res_table``
        (``store.serve_batch``).  ``mask`` is the host's active-slot
        array.  Returns the per-slot found-and-served flags.

        Under an armed ``FaultPlan`` the injector's stage hook on
        ``res_table`` is consulted (a drop retries the dispatch under the
        same ``chunk_id``, a duplicate is deduplicated by the ack set, as
        in :meth:`apply_chunk`) and the insert is logged as a
        ``put_masked`` chunk, so a restart replays it byte for byte."""
        req_spec = self._specs[req_table]
        res_spec = self._specs[res_table]
        mask = np.asarray(mask, dtype=bool)
        puts = int(mask.sum())
        keys = S._as_keys(keys, self.device)
        first, second = sorted((req_table, res_table))
        with self._table_locks[first], self._table_locks[second]:
            if self.faults is not None:
                self.faults.on_stage(res_table)
            if chunk_id is None or chunk_id not in self._acked:
                new_res, ok, ys = S.serve_batch(
                    req_spec, res_spec, apply_fn, self._state[req_table],
                    self._state[res_table], params, keys, mask)
                self._state[res_table] = new_res
                self._counts[res_table] += puts
                if chunk_id is not None:
                    self._acked.add(chunk_id)
                if self.wal_enabled:
                    self._wal[res_table].append(
                        ("chunk", (keys.clone(), ys, ok.new_tensor(mask)),
                         puts))
            else:
                ok = torch.as_tensor(mask, device=self.device)
        self._bump_ops()
        self._after_commit(res_table)
        return ok

    def sample(self, table: str, draw: torch.Tensor):
        """The random gather (``store.sample``) under the table lock:
        ``(values [n, *shape], keys [n], ok)`` with ``n = len(draw)``."""
        spec = self._specs[table]
        with self._table_locks[table]:
            out = S.sample(spec, self._state[table], draw)
        self._bump_ops()
        return out

    def _clustered_gather(self, table: str, n: int) -> Callable:
        """The cached db-mesh gather of ``sample_staged`` (one per table
        and batch size; ``store.make_clustered_gather``), its shard count
        by the deployment's rule (``Clustered.gather_shards``)."""
        key = (table, n)
        fn = self._gathers.get(key)
        if fn is None:
            spec = self._specs[table]
            dep = self.deployment
            shards = dep.gather_shards(spec) \
                if hasattr(dep, "gather_shards") else 1
            fn = S.make_clustered_gather(
                spec, n, db_mesh=getattr(dep, "db_mesh", None),
                axis=getattr(dep, "slab_axis", None), shards=shards)
            with self._lock:
                self._gathers[key] = fn
        return fn

    def sample_staged(self, table: str, draw: torch.Tensor):
        """The clustered read verb: sample ``n = len(draw)`` elements ON
        the store mesh (the shard-local gather and one ``psum`` when the
        slab's slot axis is cut), then move the batch onto the clients in
        ONE counted staged transfer.  One store op, like :meth:`sample`;
        off a crossing deployment a plain sample, nothing staged.
        Returns ``(values [n, *shape], ok)``."""
        gather = self._clustered_gather(table, len(draw))
        with self._table_locks[table]:
            values, ok = gather(self._state[table], draw)
        if self._crossing():
            values, ok = self.deployment.stage_to_clients((values, ok))
            self._bump_staged()
        self._bump_ops()
        return values, ok

    def latest(self, table: str, n: int):
        """The ``n`` newest elements (``store.latest``)."""
        spec = self._specs[table]
        with self._table_locks[table]:
            out = S.latest(spec, self._state[table], n)
        self._bump_ops()
        return out

    def poll(self, table: str, key) -> bool:
        spec = self._specs[table]
        with self._table_locks[table]:
            hit = S.poll(spec, self._state[table], key)
        self._bump_ops()
        return bool(hit)

    def stats(self) -> dict:
        """Telemetry snapshot: dispatched-op count, staged transfers (the
        clustered deployment's hops: one per staged verb element or batch,
        one per fused chunk, one per staged gather; 0 elsewhere), fault
        counters, model swaps and every
        table's cached watermark — the reference's keys — and
        ``slab_bytes``, each table's slab bytes by device."""
        with self._lock:
            marks = dict(self._counts)
            slabs = {name: S.slab_bytes(st.slab)
                     for name, st in self._state.items()}
        return {"op_count": self.op_count,
                "staged_transfers": self.staged_transfers,
                "faults_injected": self.faults.faults_injected
                if self.faults is not None else 0,
                "retries": self.retries,
                "recoveries": self.recoveries,
                "model_swaps": self.model_swaps,
                "watermarks": marks,
                "slab_bytes": slabs}

    def watermark(self, table: str) -> int:
        """Total writes so far (host-side cached counter, lock-free)."""
        return self._counts[table]

    def watermark_device(self, table: str) -> int:
        """The watermark read from the table's device state (a blocking
        read; it always equals the cached :meth:`watermark`)."""
        with self._table_locks[table]:
            count = self._state[table].count
        return int(count)

    def valid_count(self, table: str) -> int:
        spec = self._specs[table]
        with self._table_locks[table]:
            n = S.valid_count(spec, self._state[table])
        self._bump_ops()
        return int(n)

    def wait_watermark(self, table: str, minimum: int, timeout: float = 60.0,
                       interval: float = 0.001, max_interval: float = 0.05,
                       strict: bool = True) -> bool:
        """Block until ``watermark >= minimum``; raises
        :class:`~.faults.WatermarkTimeout` on timeout (``strict=False``:
        returns False)."""
        for _ in poll_backoff(timeout, interval, max_interval):
            if self._counts[table] >= minimum:
                return True
        if self._counts[table] >= minimum:
            return True
        if strict:
            raise WatermarkTimeout(table, minimum, self._counts[table],
                                   timeout)
        return False

    # -- metadata (host KV, paper's "useful metadata") ------------------------

    def put_meta(self, name: str, value) -> None:
        with self._meta_event:
            self._meta[name] = value
            self._meta_event.notify_all()

    def get_meta(self, name: str, default=None):
        with self._lock:
            return self._meta.get(name, default)

    def wait_meta(self, name: str, timeout: float = 60.0,
                  strict: bool = True):
        """Block until metadata ``name`` exists.  On timeout raises
        :class:`~.faults.StoreTimeout` (``strict=False``: returns None —
        the polling form inference consumers loop on)."""
        with self._meta_event:
            ok = self._meta_event.wait_for(lambda: name in self._meta,
                                           timeout=timeout)
            if ok:
                return self._meta.get(name)
        if strict:
            raise StoreTimeout("metadata", name, timeout)
        return None

    # -- model registry (RedisAI analogue) ------------------------------------

    def set_model(self, key: str, apply_fn: Callable, params,
                  jit_compile: bool = True) -> None:
        """Store a model "in the database" under ``key``.

        Registry contract of the port: ``apply_fn(params, xs)`` takes a
        LEADING BATCH AXIS (``xs [n, *request_shape]`` → ``[n,
        *response_shape]``).  The fused serving dispatch calls it once per
        drained batch; :meth:`run_model` calls it on a batch of one.  (The
        reference vmaps a per-element function inside its jitted dispatch;
        a hand-written kernel cannot be vmapped, so the batch axis is
        explicit here.)  Each call bumps the key's version — the serving
        loop's hot-swap watermark.  ``jit_compile`` is the reference's
        signature: eager PyTorch has no compile step, so it changes
        nothing here.  On a clustered deployment the params are staged
        onto the store placement (copied, not counted, as in the
        reference)."""
        dep = self.deployment
        if dep is not None and not isinstance(dep, Colocated):
            params = tree_map(dep.stage, params)
        with self._lock:
            self._models[key] = (apply_fn, params)
            self._model_versions[key] = \
                self._model_versions.get(key, 0) + 1

    def has_model(self, key: str) -> bool:
        with self._lock:
            return key in self._models

    def model_keys(self) -> list[str]:
        with self._lock:
            return list(self._models)

    def run_model(self, key: str, *inputs):
        """Evaluate model ``key`` on single elements (a batch of one)."""
        with self._lock:
            fn, params = self._models[key]
        out = fn(params, *(torch.as_tensor(x).unsqueeze(0) for x in inputs))
        if isinstance(out, (tuple, list)):
            return type(out)(o[0] for o in out)
        return out[0]

    def model_version(self, key: str) -> int:
        """Monotonic publication counter for ``key`` (0 = never
        published)."""
        with self._lock:
            return self._model_versions.get(key, 0)

    def bind_model(self, key: str, have: int | None = None):
        """Atomically adopt the current weights for ``key`` if they are
        newer than generation ``have``: ``(apply_fn, params, version)``,
        or ``None`` when nothing newer is published.  Version and registry
        are read under one lock (never a torn pair); every adoption bumps
        ``model_swaps``."""
        with self._lock:
            version = self._model_versions.get(key, 0)
            if version == 0 or version == have:
                return None
            fn, params = self._models[key]
        with self._ops_lock:
            self.model_swaps += 1
        return fn, params, version

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict[str, S.TableState]:
        """A deep copy of every table's state (``store.copy_state``: the
        slab, every shard of a sharded one, keys, version, ptr, count),
        each table copied under its own lock.  The write verbs update the
        live state in place, so a snapshot sharing it would follow them."""
        snap = {}
        with self._lock:
            names = list(self._specs)
        for name in names:
            with self._table_locks[name]:
                snap[name] = S.copy_state(self._state[name])
        return snap

    def restore(self, snap: dict[str, S.TableState]) -> None:
        """Make each table of ``snap`` live again, as a copy (``snap``
        stays restorable after later writes), with the cached watermark
        read back from the state."""
        for name, st in snap.items():
            if name in self._specs:
                with self._table_locks[name]:
                    self._state[name] = S.copy_state(st)
                    self._counts[name] = int(st.count)

    # -- injected store restart + recovery -----------------------------------

    def _take_recovery_snapshot(self) -> None:
        """A declared ``snapshot``: park a deep copy of every table and
        mark each log's current length as its replay floor (the commits
        before it never replay again, which also bounds the log)."""
        snap = self.snapshot()
        # the image and the floor are published together, under the
        # registry lock, so a restart never pairs one with the other's
        # predecessor
        with self._lock:
            self._recovery = snap
            for t in self._wal:
                self._wal_base[t] = len(self._wal[t])

    def _replay_entry(self, spec: S.TableSpec, state: S.TableState,
                      kind: str, payload) -> S.TableState:
        if kind == "put":
            return S.put(spec, state, *payload)
        if kind == "put_many":
            return S.put_many(spec, state, *payload)
        if kind == "put_stream":
            return S.put_stream(spec, state, *payload)
        if kind == "delete":
            return S.delete(spec, state, *payload)
        return S.put_masked(spec, state, *payload)       # "chunk"

    def _restart_and_recover(self) -> None:
        """A declared ``restart``: the store dies and comes back.  Each
        table is rebuilt from a copy of the last recovery image (empty
        where none was taken) and its log's tail since that image is
        replayed in commit order: the same writes on the same state leave
        the same bytes.  Each replayed entry is one store op, counted in
        ``op_count`` as ``faults.simulate_overhead`` predicts."""
        with self._lock:
            names = list(self._specs)
        for name in names:
            spec = self._specs[name]
            with self._table_locks[name]:
                if self._recovery is not None and name in self._recovery:
                    st = S.copy_state(self._recovery[name])
                else:
                    st = S.init_table(spec, self._placements[name],
                                      device=self.device)
                for kind, payload, _puts in \
                        self._wal[name][self._wal_base[name]:]:
                    st = self._replay_entry(spec, st, kind, payload)
                    self._bump_ops()
                self._state[name] = st
                self._counts[name] = int(st.count)
        with self._ops_lock:
            self.recoveries += 1
