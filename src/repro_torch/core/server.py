"""StoreServer: the host-side owner of TensorStore state.

Port of ``src/repro/core/server.py`` — the local deployment only: tables
on one device, per-table locks, host metadata with cached (lock-free)
watermarks, capture transactions, the fused serving dispatch, the random
gather, the model registry and ``stats()``.

Host threads call the server's verbs; each verb launches the store op on
the device (asynchronously, on PyTorch's current stream) while holding the
table's lock, so writes and reads of one table are ordered.  The server-
wide lock guards only the registries.  ``Colocated``/``Clustered``
deployments (``ROADMAP.md`` A5) and an armed ``FaultPlan`` with its
write-ahead log (A4) are later slices and raise here.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from . import store as S
from .faults import FaultPlan, StoreTimeout, WatermarkTimeout
from .telemetry import poll_backoff

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

    def __init__(self, deployment=None, faults: FaultPlan | None = None,
                 device=None):
        if deployment is not None:
            raise NotImplementedError(
                "deployments other than local: ROADMAP.md A5")
        if faults is not None:
            raise NotImplementedError("armed FaultPlan: ROADMAP.md A4")
        self.deployment = None
        self.device = resolve_device(device)
        self._lock = threading.RLock()           # registries + metadata only
        self._table_locks: dict[str, threading.RLock] = {}
        self._specs: dict[str, S.TableSpec] = {}
        self._state: dict[str, S.TableState] = {}
        self._counts: dict[str, int] = {}        # cached watermarks
        self._models: dict[str, tuple[Callable, Any]] = {}
        self._model_versions: dict[str, int] = {}  # hot-swap generations
        self.model_swaps = 0                     # serving weight adoptions
        self._meta: dict[str, Any] = {}          # tiny host-side metadata KV
        self._meta_event = threading.Condition(self._lock)
        self._ops_lock = threading.Lock()
        self.op_count = 0                        # dispatched store ops
        self.staged_transfers = 0                # always 0: local only
        self.faults = None                       # no FaultPlan: A4
        self.retries = 0                         # verb retries (clients')
        self.recoveries = 0

    def _bump_ops(self, n: int = 1) -> None:
        with self._ops_lock:
            self.op_count += n

    def _bump_retry(self, n: int = 1) -> None:
        with self._ops_lock:
            self.retries += n

    # -- table management ---------------------------------------------------

    def create_table(self, spec: S.TableSpec, deployment=None,
                     slab_sharding=None) -> S.TableSpec:
        """Register + allocate a table on the server's device."""
        if deployment is not None or slab_sharding is not None:
            raise NotImplementedError("table placement: ROADMAP.md A5")
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(f"table {spec.name!r} already exists")
            self._specs[spec.name] = spec
            self._state[spec.name] = S.init_table(spec, self.device)
            self._table_locks[spec.name] = threading.RLock()
            self._counts[spec.name] = 0
        return spec

    def spec(self, table: str) -> S.TableSpec:
        return self._specs[table]

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
        One capture is one store op, read-only captures included.
        """
        with self._table_locks[table]:
            txn = CaptureTxn(self._specs[table], self._state[table])
            try:
                yield txn
            finally:
                if txn.state is not txn._orig:
                    self._state[table] = txn.state
                    self._counts[table] += txn.puts
        self._bump_ops()

    # -- verbs ---------------------------------------------------------------

    def put(self, table: str, key, value) -> None:
        spec = self._specs[table]
        with self._table_locks[table]:
            self._state[table] = S.put(spec, self._state[table], key, value)
            self._counts[table] += 1
        self._bump_ops()

    def put_stream(self, table: str, keys, values) -> None:
        """One op for a whole trajectory of sends (``store.put_stream``)."""
        spec = self._specs[table]
        n = int(np.prod(np.shape(keys)))
        with self._table_locks[table]:
            self._state[table] = S.put_stream(spec, self._state[table], keys,
                                              values)
            self._counts[table] += n
        self._bump_ops()

    def get(self, table: str, key):
        spec = self._specs[table]
        with self._table_locks[table]:
            out = S.get(spec, self._state[table], key)
        self._bump_ops()
        return out

    def serve_batch(self, req_table: str, res_table: str, keys, mask,
                    apply_fn, params):
        """Drain one continuous-batching batch in ONE dispatch: gather the
        active requests from ``req_table``, apply the bound model to the
        whole batch, scatter the responses into ``res_table``
        (``store.serve_batch``).  ``mask`` is the host's active-slot
        array.  Returns the per-slot found-and-served flags."""
        req_spec = self._specs[req_table]
        res_spec = self._specs[res_table]
        mask = np.asarray(mask, dtype=bool)
        first, second = sorted((req_table, res_table))
        with self._table_locks[first], self._table_locks[second]:
            new_res, ok, _ys = S.serve_batch(
                req_spec, res_spec, apply_fn, self._state[req_table],
                self._state[res_table], params, keys, mask)
            self._state[res_table] = new_res
            self._counts[res_table] += int(mask.sum())
        self._bump_ops()
        return ok

    def sample(self, table: str, draw: torch.Tensor):
        """The random gather (``store.sample``) under the table lock:
        ``(values [n, *shape], keys [n], ok)`` with ``n = len(draw)``."""
        spec = self._specs[table]
        with self._table_locks[table]:
            out = S.sample(spec, self._state[table], draw)
        self._bump_ops()
        return out

    def stats(self) -> dict:
        """Telemetry snapshot: dispatched-op count, staged transfers (0 on
        the local deployment), fault counters, model swaps and every
        table's cached watermark — the same keys as the reference."""
        with self._lock:
            marks = dict(self._counts)
        return {"op_count": self.op_count,
                "staged_transfers": self.staged_transfers,
                "faults_injected": 0,
                "retries": self.retries,
                "recoveries": self.recoveries,
                "model_swaps": self.model_swaps,
                "watermarks": marks}

    def watermark(self, table: str) -> int:
        """Total writes so far (host-side cached counter, lock-free)."""
        return self._counts[table]

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

    def set_model(self, key: str, apply_fn: Callable, params) -> None:
        """Store a model "in the database" under ``key``.

        Registry contract of the port: ``apply_fn(params, xs)`` takes a
        LEADING BATCH AXIS (``xs [n, *request_shape]`` → ``[n,
        *response_shape]``).  The fused serving dispatch calls it once per
        drained batch; :meth:`run_model` calls it on a batch of one.  (The
        reference vmaps a per-element function inside its jitted dispatch;
        a hand-written kernel cannot be vmapped, so the batch axis is
        explicit here.)  Each call bumps the key's version — the serving
        loop's hot-swap watermark."""
        with self._lock:
            self._models[key] = (apply_fn, params)
            self._model_versions[key] = \
                self._model_versions.get(key, 0) + 1

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
