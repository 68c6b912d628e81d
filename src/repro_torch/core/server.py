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

**Deployments.**  ``deployment=Colocated(...)`` (``core.deployment``)
places every table by the deployment's rule (``slab_sharding(spec)``: an
element cut over the producer's mesh, so a domain-decomposed emission is
written rank-local); its ``faults`` arm the server when ``faults`` is not
given.  Nothing crosses a mesh, so ``staged_transfers`` stays 0.  The
``Clustered`` deployment (the dedicated store mesh, with the overlap
pipeline's ``stage_chunk_logged``/``insert_chunk``) is ``ROADMAP.md`` A5.2
and raises here.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from . import store as S
from .deployment import check_deployment
from .faults import (FaultInjector, FaultPlan, StoreTimeout,
                     WatermarkTimeout)
from .telemetry import Timers, poll_backoff

__all__ = ["StoreServer", "CaptureTxn"]

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
        self.staged_transfers = 0                # 0: no deployment crosses
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

    # lint: holds-lock — runs inside the caller's capture txn (table lock)
    def apply_chunk(self, table: str, chunk_id: tuple, txn: CaptureTxn,
                    keys, values, mask, puts: int) -> None:
        """Exactly-once insert of one collected chunk
        (``store.capture_scan_collect[_multi]``) into ``txn``'s table: the
        write path of every fused capture once a ``FaultPlan`` is armed.

        ``chunk_id`` is the client's stable ``(rank, seq)``: the SAME id
        on every retry of one chunk, a new id per chunk.  The injector is
        consulted first: a declared drop raises ``TransferDropped`` before
        anything is applied (the client retries under the same id), a
        declared duplicate delivers the chunk twice and the acknowledged
        set makes the second delivery a no-op (``put_masked`` is not
        idempotent: ``ptr`` and ``count`` advance on every apply).  The
        applied chunk is logged for replay."""
        spec = self._specs[table]
        if self.faults is not None:
            # a declared duplicate's second delivery finds its id acked
            self.faults.on_stage(table)
        if chunk_id not in self._acked:
            txn.state = S.put_masked(spec, txn.state, keys, values, mask)
            txn.puts = puts
            self._acked.add(chunk_id)
            if self.wal_enabled:
                self._wal[table].append(("chunk", (keys, values, mask),
                                         puts))

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

    def _logged(self, spec: S.TableSpec, keys, values):
        """A write's payload on the table's device; copied when the log
        keeps it, since the caller may reuse its tensors."""
        keys = S._as_keys(keys, self.device)
        values = S._as_values(spec, values, self.device)
        if self.wal_enabled:
            keys, values = keys.clone(), S._rows(values, torch.clone)
        return keys, values

    def put(self, table: str, key, value) -> None:
        spec = self._specs[table]
        key, value = self._logged(spec, key, value)
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
        """Telemetry snapshot: dispatched-op count, staged transfers (0 on
        the local deployment), fault counters, model swaps and every
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
        nothing here."""
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
