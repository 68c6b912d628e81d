"""Store-backed serving loop: continuous batching over the request table.

The production shape of the paper's inference workflow (SmartSim's
ocean-climate deployment: many concurrent clients, one in-database model)
as a store protocol:

* **Request queue** = a ring table plus per-client host metadata counters.
  Client ``c`` submits request ``s`` by ``put``-ting its payload under
  ``request_key(c, s)`` and bumping ``"<table>.submitted.<c>"`` — the
  submission watermark the consumer sweeps (metadata reads are free: zero
  store dispatches, so queue discovery costs nothing on the dispatch
  budget).
* **Continuous batching** = a :class:`~repro.serve.batching.Batcher` over
  ring slots; each drained batch is ONE fused dispatch
  (``Client.serve_batch``: gather → model → scatter, the serving analogue
  of ``capture_scan``).
* **Responses** = the same packed keys in a results table the clients
  poll; the results watermark doubles as the exactly-once recovery
  cursor (see :meth:`ServeLoop.recover`).
* **Hot-swap** = the model registry's version counter
  (``StoreServer.model_version``); the loop re-binds between batches via
  ``bind_model`` — an atomic (fn, params, version) read, never a torn
  pair.

Discovery sweeps round-robin over clients, admitting at most one request
per client per sweep: for a fixed set of submitted requests the admission
order — and therefore the batch count, ``ceil(total / max_batch)`` — is
canonical regardless of arrival interleaving, which is what lets
``plan.explain()`` predict drained batches exactly.

Port of ``src/repro/serve/engine.py``, unchanged but for the package it
runs on: the registered model takes the whole drained batch (see the
port's ``StoreServer.set_model``).
"""

from __future__ import annotations

import threading

import numpy as np

from ..core.client import Client
from ..core.faults import StoreTimeout
from ..core.telemetry import poll_backoff

__all__ = ["ServeLoop", "request_key", "submitted_meta"]


def request_key(client: int, seq: int) -> int:
    """Host-int mirror of ``store.make_key(client, seq)`` — the packed
    uint32 key a (client, sequence-id) request lives under in both the
    request and results tables."""
    key = (1 << 31) | ((seq & 0x7FFFF) << 12) | (client & 0xFFF)
    return 0x7FFFFFFF if key == 0xFFFFFFFF else key


def submitted_meta(table: str, client: int) -> str:
    """Metadata key carrying client ``client``'s submission watermark for
    ``table`` (the count of requests it has made visible)."""
    return f"{table}.submitted.{client}"


class ServeLoop:
    """Drains a request table through the fused serving dispatch.

    One loop serves ``clients * requests`` total requests (``requests``
    per client, sequence ids ``0..requests-1``), in batches of up to
    ``max_batch`` ring slots.  ``reload_every`` sets the hot-swap cadence:
    the model version is re-checked every that many drained batches (and
    always before the first).

    The loop object is the unit of crash recovery: a component restart
    reuses the SAME ``ServeLoop`` (see :meth:`recover`), so the adopted
    model generation survives the crash and recovery never re-binds — the
    swap count stays exactly what the plan predicted.
    """

    def __init__(self, client: Client, *, model_key: str,
                 request_table: str, response_table: str,
                 clients: int, requests: int, max_batch: int,
                 reload_every: int = 1, component: str = "serving"):
        self.client = client
        self.model_key = model_key
        self.request_table = request_table
        self.response_table = response_table
        self.clients = int(clients)
        self.requests = int(requests)
        self.max_batch = int(max_batch)
        self.reload_every = int(reload_every)
        self.component = component
        self.total = self.clients * self.requests
        from .batching import Batcher
        self.batcher = Batcher(max_batch=self.max_batch)
        self._enqueued = [0] * self.clients   # next seq to discover, per client
        self._discovered: list[tuple[int, int]] = []  # admission order log
        self.served = 0                       # responses committed
        self.batches = 0                      # fused serve dispatches
        self.swaps = 0                        # model generations adopted
        self._apply = None
        self._params = None
        self._version: int | None = None

    # -- model binding -------------------------------------------------------

    def wait_model(self, timeout: float = 60.0,
                   stop_event: threading.Event | None = None) -> None:
        """Block until the first model generation is published (the paper's
        "ML ranks poll the DB" moment, against the version counter instead
        of a tensor key — zero store dispatches while spinning)."""
        server = self.client.server
        for _ in poll_backoff(timeout, 1e-4, 0.01):
            if server.model_version(self.model_key) > 0:
                return
            if stop_event is not None and stop_event.is_set():
                return
        if server.model_version(self.model_key) > 0:
            return
        raise StoreTimeout("model", self.model_key, timeout)

    def maybe_swap(self) -> bool:
        """Adopt a newer model generation if one is published.  Atomic:
        ``bind_model`` reads (fn, params, version) under one registry
        lock, so the loop never holds a torn pair."""
        bound = self.client.server.bind_model(self.model_key, self._version)
        if bound is None:
            return False
        self._apply, self._params, self._version = bound
        self.swaps += 1
        return True

    # -- queue discovery -----------------------------------------------------

    def _discover(self) -> None:
        """Sweep the per-client submission watermarks round-robin,
        admitting at most one request per client per sweep, until a full
        sweep makes no progress.  Canonical admission order for any
        arrival interleave; free (metadata reads only)."""
        server = self.client.server
        progress = True
        while progress:
            progress = False
            for c in range(self.clients):
                s = self._enqueued[c]
                if s >= self.requests:
                    continue
                submitted = server.get_meta(
                    submitted_meta(self.request_table, c), 0)
                if submitted > s:
                    self.batcher.submit([c, s], max_new_tokens=1)
                    self._discovered.append((c, s))
                    self._enqueued[c] = s + 1
                    progress = True

    # -- continuous-batching drain -------------------------------------------

    def step(self) -> bool:
        """One drain iteration: swap check → discover → admit → ONE fused
        serve dispatch over the active slots.  Returns False when no slot
        was active (nothing discovered yet)."""
        if self._apply is None or self.batches % self.reload_every == 0:
            self.maybe_swap()
        self._discover()
        self.batcher.admit()
        keys = np.zeros(self.max_batch, np.uint32)
        mask = np.zeros(self.max_batch, bool)
        for i, req in enumerate(self.batcher.slots):
            if req is not None and not req.done:
                c, s = req.prompt
                keys[i] = request_key(c, s)
                mask[i] = True
        if not mask.any():
            return False
        self.client.fault_point(self.component, self.batches)
        self.client.serve_batch(self.request_table, self.response_table,
                                keys, mask, self._apply, self._params)
        # max_new_tokens=1: one served token retires every active slot.
        self.batcher.record_tokens(np.zeros(self.max_batch, np.int64))
        self.batches += 1
        self.served += int(mask.sum())
        return True

    def run(self, stop_event: threading.Event | None = None,
            timeout: float = 60.0) -> None:
        """Continuous-batching tier: drain until every request is
        answered.  Idle spins (queue empty, slots empty) back off without
        dispatching; a full ``timeout`` of no progress raises."""
        self.wait_model(timeout, stop_event)
        while self.served < self.total:
            if stop_event is not None and stop_event.is_set():
                return
            if self.step():
                continue
            progressed = False
            for _ in poll_backoff(timeout, 1e-4, 0.01):
                if self.step():
                    progressed = True
                    break
                if stop_event is not None and stop_event.is_set():
                    return
            if not progressed and self.served < self.total:
                raise StoreTimeout("serving", self.request_table, timeout,
                                   f"served {self.served}/{self.total}")

    # -- three-step baseline -------------------------------------------------

    def run_three_step(self, stop_event: threading.Event | None = None,
                       timeout: float = 60.0) -> None:
        """Paper-protocol baseline: drain the same requests one at a time
        via ``get → run_model → put`` (one store dispatch per get and per
        put, no batching, no swap accounting — ``run_model`` always sees
        the latest weights).  Canonical client-major order per sequence
        id; parity tests assert bit-identical responses vs :meth:`run`."""
        self.wait_model(timeout, stop_event)
        server = self.client.server
        order = [(c, s) for s in range(self.requests)
                 for c in range(self.clients)]
        for c, s in order[self.served:]:
            if stop_event is not None and stop_event.is_set():
                return
            meta = submitted_meta(self.request_table, c)
            for _ in poll_backoff(timeout, 1e-4, 0.01):
                if server.get_meta(meta, 0) > s:
                    break
            else:
                if not server.get_meta(meta, 0) > s:
                    raise StoreTimeout("serving", self.request_table,
                                       timeout, f"waiting for ({c},{s})")
            self.client.fault_point(self.component, self.served)
            key = request_key(c, s)
            x, found = self.client.get_kv(self.request_table, key)
            y = server.run_model(self.model_key, x)
            self.client.put_kv(self.response_table, key, y)
            self.served += 1

    # -- crash recovery ------------------------------------------------------

    def recover(self) -> None:
        """Resume after an injected crash: the results watermark counts
        responses already committed (responses commit in admission order,
        and crashes fire *before* a dispatch), so it is the exact cursor.
        The batcher is rebuilt from the discovery log's tail — in-flight
        slots from the crashed drain are re-admitted, already-answered
        requests are not.  ``_version`` survives (same loop object), so
        recovery never re-binds the model."""
        self.served = int(self.client.server.watermark(self.response_table))
        from .batching import Batcher
        self.batcher = Batcher(max_batch=self.max_batch)
        for c, s in self._discovered[self.served:]:
            self.batcher.submit([c, s], max_new_tokens=1)
