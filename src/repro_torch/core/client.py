"""Client: the SmartRedis-verb API (paper §2.2).

Port of ``src/repro/core/client.py`` — the verbs the serving plane uses:
``put_kv``/``get_kv`` (pre-made-key put/get), ``serve_batch`` (one fused
continuous-batching drain), ``set_model``, ``fault_point`` and the fault
boundary every verb goes through.  Every verb is timed into the paper's
component buckets (``send`` / ``retrieve`` / ``model_eval`` /
``model_load``).  The named-tensor, capture and sampling verbs come with
later slices (``ROADMAP.md`` A2, A3).
"""

from __future__ import annotations

import time
from typing import Callable

from . import store as S
from .faults import call_with_retry
from .server import StoreServer
from .telemetry import Timers

__all__ = ["Client"]


class Client:
    def __init__(self, server: StoreServer, rank: int = 0,
                 timers: Timers | None = None):
        t0 = time.perf_counter()
        self.server = server
        self.rank = int(rank)
        self.timers = timers or Timers()
        #: fault-tolerance telemetry, surfaced through ComponentResult
        self.retries = 0
        self.restarts = 0
        self.straggler_events = 0
        S.name_key("__warmup__")
        self.timers.record("client_init", time.perf_counter() - t0)

    # -- fault boundary -------------------------------------------------------

    def _count_retry(self) -> None:
        self.retries += 1
        self.server._bump_retry()

    def _call_verb(self, verb: str, table: str | None, call):
        """Route one store verb through the fault boundary: with an armed
        injector each attempt is announced and transient failures are
        retried under its policy; without one (the only case this slice's
        server allows) it is a plain call."""
        inj = self.server.faults
        if inj is None:
            return call()

        def attempt():
            inj.on_verb(verb, table)
            return call()

        return call_with_retry(attempt, inj.retry, self._count_retry)

    def fault_point(self, component: str, idx: int) -> None:
        """A declared crash point (raises ``InjectedCrash`` once when an
        armed plan says ``component`` dies at ``idx``)."""
        inj = self.server.faults
        if inj is not None:
            inj.maybe_crash(component, idx)

    # -- pre-made keys (the serving clients' path) ----------------------------

    def put_kv(self, table: str, key, value) -> None:
        """Pre-made-key put through the fault boundary."""
        with self.timers.time("send", payload=value):
            self._call_verb("put", table,
                            lambda: self.server.put(table, key, value))

    def get_kv(self, table: str, key):
        """Pre-made-key get through the fault boundary → ``(value, found)``."""
        with self.timers.time("retrieve") as box:
            value, found = self._call_verb(
                "get", table, lambda: self.server.get(table, key))
            box[0] = value
        return value, found

    def serve_batch(self, req_table: str, res_table: str, keys, mask,
                    apply_fn, params):
        """One continuous-batching drain through the fault boundary (the
        fused gather → model → scatter, ``StoreServer.serve_batch``).
        Returns the per-slot served flags."""
        with self.timers.time("model_eval") as box:
            ok = self._call_verb(
                "serve", res_table,
                lambda: self.server.serve_batch(req_table, res_table, keys,
                                                mask, apply_fn, params))
            box[0] = ok
        return ok

    # -- models (RedisAI verbs) -----------------------------------------------

    def set_model(self, key: str, apply_fn: Callable, params) -> None:
        with self.timers.time("model_load"):
            self.server.set_model(key, apply_fn, params)
