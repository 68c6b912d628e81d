"""Client: the SmartRedis-verb API (paper §2.2).

Port of ``src/repro/core/client.py`` — the single-device verbs: named
tensors (``put_tensor``/``get_tensor``), pre-made-key ``put_kv``/``get_kv``,
the producer's fused ``capture_scan``, the trainer's ``sample_batch`` and
``capture_epoch``, watermarks and metadata, the model registry verbs
(``set_model``, ``run_model``, the fused ``infer``), the serving drain
``serve_batch``, ``fault_point`` and the fault boundary every verb goes
through.  Every verb is timed into the paper's component buckets
(``client_init`` / ``metadata`` / ``send`` / ``retrieve`` /
``model_eval`` / ``model_load``).  The reference's logged and staged
capture paths belong to later slices (``ROADMAP.md`` A4, A5).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

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

    # -- named tensors --------------------------------------------------------

    def put_tensor(self, name: str, value, table: str = "default") -> None:
        with self.timers.time("send", payload=value):
            self._call_verb("put", table,
                            lambda: self.server.put(table, S.name_key(name),
                                                    value))

    def get_tensor(self, name: str, table: str = "default"):
        with self.timers.time("retrieve") as box:
            value, found = self.server.get(table, S.name_key(name))
            box[0] = value
        return value, found

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

    # -- fused capture --------------------------------------------------------

    @contextlib.contextmanager
    def capture(self, table: str = "default"):
        """A capture transaction under the table's lock (yields the
        server's :class:`~.server.CaptureTxn`): run the fused work against
        ``txn.state``, assign the result back, set ``txn.puts``."""
        with self.server.capture(table) as txn:
            yield txn

    def capture_scan(self, table: str, step_fn, carry, length: int,
                     emit_every: int = 1, t0=0, n_ranks: int | None = None):
        """``length`` producer steps and their ring puts as ONE store op
        under one table-lock round-trip (the fused producer tier).

        ``n_ranks=None``: ``step_fn(carry, t) -> (carry, key, value)``;
        with ``n_ranks=R``: ``step_fn(carry_r, rank, t)`` over the leading
        ``[R]`` axis of ``carry`` (``store.capture_scan_multi``; ``t0`` an
        int or one start step per rank).  Each put commits as it lands,
        with the cached watermark bumped by its count, so a step that
        raises leaves the table consistent with the puts made before it.
        Returns the new carry.
        """
        spec = self.server.spec(table)
        clocks = S._rank_clocks(t0, n_ranks or 1)
        with self.timers.time("send"):
            with self.capture(table) as txn:
                def commit(state, n):
                    txn.state = state
                    txn.puts += n

                if n_ranks is None:
                    _, carry = S.capture_scan(
                        spec, txn.state, step_fn, carry, length, emit_every,
                        t0=clocks[0], on_put=commit)
                else:
                    _, carry = S.capture_scan_multi(
                        spec, txn.state, step_fn, carry, length, n_ranks,
                        emit_every, t0=clocks, on_put=commit)
        return carry

    # -- consumer-side loaders ------------------------------------------------

    def sample_batch(self, table: str, n: int, draw):
        """Random gather of ``n`` stored tensors (the paper's data loader);
        ``draw`` holds ``n`` uniforms in ``[0, 1)`` (``store.sample``)."""
        if len(draw) != n:
            raise ValueError(f"sample_batch: {len(draw)} draws for n={n}")
        with self.timers.time("retrieve") as box:
            values, keys, ok = self._call_verb(
                "sample", table, lambda: self.server.sample(table, draw))
            box[0] = values
        return values, keys, ok

    def capture_epoch(self, table: str, body):
        """One read-only capture through the fault boundary;
        ``body(txn)``'s return value is passed through (the fused
        trainer's ``(state, metrics)``)."""
        def attempt():
            with self.server.capture(table) as txn:
                return body(txn)

        return self._call_verb("capture", table, attempt)

    def wait_for_data(self, table: str, minimum: int = 1,
                      timeout: float = 60.0) -> bool:
        """Wait for the first training snapshots; on timeout the trainer
        proceeds with whatever exists (``strict=False``)."""
        with self.timers.time("metadata"):
            return self.server.wait_watermark(table, minimum, timeout,
                                              strict=False)

    def watermark(self, table: str) -> int:
        with self.timers.time("metadata"):
            return self.server.watermark(table)

    # -- metadata -------------------------------------------------------------

    def put_metadata(self, name: str, value) -> None:
        with self.timers.time("metadata"):
            self.server.put_meta(name, value)

    def get_metadata(self, name: str, timeout: float | None = None,
                     strict: bool = False):
        """Non-strict by default (None on a missed ``timeout`` wait)."""
        with self.timers.time("metadata"):
            if timeout is None:
                return self.server.get_meta(name)
            return self.server.wait_meta(name, timeout=timeout,
                                         strict=strict)

    # -- models (RedisAI verbs) -----------------------------------------------

    def set_model(self, key: str, apply_fn: Callable, params) -> None:
        with self.timers.time("model_load"):
            self.server.set_model(key, apply_fn, params)

    def run_model(self, key: str, inputs: Sequence[str],
                  outputs: Sequence[str], table: str = "default",
                  out_table: str | None = None) -> None:
        """Evaluate a stored model on stored tensors and store the
        predictions: step (2) of the paper's three-step protocol."""
        out_table = out_table or table
        ins = [self.server.get(table, S.name_key(nm))[0] for nm in inputs]
        with self.timers.time("model_eval") as box:
            outs = self.server.run_model(key, *ins)
            box[0] = outs
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(outputs):
            raise ValueError(f"model {key!r} returned {len(outs)} outputs, "
                             f"expected {len(outputs)}")
        for nm, o in zip(outputs, outs):
            self.server.put(out_table, S.name_key(nm), o)

    def infer(self, key: str, *xs):
        """Fused fast path: one registry call, no store round-trip."""
        with self.timers.time("model_eval") as box:
            out = self.server.run_model(key, *xs)
            box[0] = out
        return out
