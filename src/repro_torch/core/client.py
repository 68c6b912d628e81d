"""Client: the SmartRedis-verb API (paper §2.2).

Port of ``src/repro/core/client.py`` — the single-device verbs: named
tensors (``put_tensor``/``get_tensor``/``poll_tensor``), the rank/step-keyed
``send_step``/``retrieve_step`` (the reproducer's per-rank loop and the LM
serving loop's capture hook) and their vectorized ``send_batch``,
pre-made-key ``put_kv``/``get_kv``, the newest elements
(``latest_batch``), the producer's fused ``capture_scan``, the trainer's
``sample_batch`` and ``capture_epoch``, watermarks and metadata, the
model registry verbs (``set_model``, ``run_model``, the fused ``infer``),
the serving drain ``serve_batch``, ``delete_tensor``, ``fault_point``
and the fault boundary every verb goes through.  Every verb is timed into
the paper's component buckets (``client_init`` / ``metadata`` / ``send``
/ ``retrieve`` / ``model_eval`` / ``model_load``).

Once the server is armed with a ``FaultPlan``, ``capture_scan`` takes the
reference's logged path: each chunk gets a stable ``(rank, seq)`` id, its
steps run collect-only (``store.capture_scan_collect[_multi]``) and the
server inserts it exactly once (``StoreServer.apply_chunk``), the whole
attempt inside the retry boundary and against the original carry.
``capture_scan(elem_sharding=...)`` is the domain-decomposed producer's
capture (the ``capture_scan_sharded`` tier): on a co-located table each
rank's block is written into its own shard.

On a ``Clustered`` deployment every chunk takes the logged path too,
armed or not, and crosses to the db mesh in ONE staged hop: serially
(``StoreServer.apply_chunk``), or with ``overlap`` through the two-slot
pipeline (:class:`~.deployment.StagingPipeline`): chunk N's copies are
enqueued on the staging stream, the previous chunk is inserted in the
same capture, and chunk N's insert waits for the next capture, for
:meth:`drain_captures` at capture end, or for the drain-on-restage
flush after a dropped transfer.  ``sample_staged`` is the clustered
read: gathered on the db mesh, one hop back.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

import torch

from . import store as S
from .deployment import StagingPipeline
from .faults import StoreTimeout, TransferDropped, call_with_retry
from .server import StoreServer
from .telemetry import Timers, poll_backoff

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
        self._seq = 0            # next logged chunk's sequence number
        # two-slot overlap pipelines, one per table (clustered fused tier)
        self._staging: dict[str, StagingPipeline] = {}
        S.name_key("__warmup__")
        self.timers.record("client_init", time.perf_counter() - t0)

    # -- fault boundary -------------------------------------------------------

    def _count_retry(self) -> None:
        self.retries += 1
        self.server._bump_retry()

    def _call_verb(self, verb: str, table: str | None, call):
        """Route one store verb through the fault boundary: with an armed
        injector each attempt is announced and transient failures are
        retried under its policy, each retry counted on the client and
        the server; without one it is a plain call."""
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

    def delete_tensor(self, name: str, table: str = "default") -> None:
        self.server.delete(table, S.name_key(name))

    def poll_tensor(self, name: str, table: str = "default",
                    timeout: float = 10.0, interval: float = 0.001,
                    max_interval: float = 0.05, strict: bool = True) -> bool:
        """Poll until the key exists (SmartRedis ``poll_tensor``), one
        store op a probe, backing off exponentially between probes.  On
        timeout raises :class:`~.faults.StoreTimeout` (``strict=False``:
        returns False)."""
        key = S.name_key(name)
        with self.timers.time("metadata"):
            for _ in poll_backoff(timeout, interval, max_interval):
                if self.server.poll(table, key):
                    return True
            if strict:
                raise StoreTimeout("tensor", name, timeout,
                                   f"table {table!r}")
            return False

    # -- rank/step-keyed streaming ---------------------------------------------

    def send_step(self, table: str, step: int, value) -> None:
        """Send this rank's contribution of one time step (unique key per
        rank and step, exactly the paper's keying scheme)."""
        with self.timers.time("send", payload=value):
            self._call_verb(
                "put", table,
                lambda: self.server.put(table, S.make_key(self.rank, step),
                                        value))

    def retrieve_step(self, table: str, rank: int, step: int):
        """Fetch ``rank``'s contribution of ``step`` → ``(value, found)``."""
        with self.timers.time("retrieve") as box:
            value, found = self.server.get(table, S.make_key(rank, step))
            box[0] = value
        return value, found

    def send_batch(self, table: str, step: int, values, ranks=None) -> None:
        """Many ranks' contributions of one step in ONE op (``put_many``):
        ``values [n, *shape]``, ranks ``0..n-1`` unless given."""
        dev = self.server.device
        n = values.shape[0]
        ranks = torch.arange(n, device=dev) if ranks is None \
            else torch.as_tensor(ranks, device=dev)
        keys = S.make_key(ranks, step)
        with self.timers.time("send", payload=values):
            self.server.put_many(table, keys, values)

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
        fused gather → model → scatter, ``StoreServer.serve_batch``), under
        a stable chunk id when the server logs, so a dropped response
        transfer is retried under the SAME id and the insert stays
        exactly-once.  Returns the per-slot served flags."""
        chunk_id = None
        if self.server.wal_enabled:
            chunk_id = (self.rank, self._seq)
            self._seq += 1
        with self.timers.time("model_eval") as box:
            ok = self._call_verb(
                "serve", res_table,
                lambda: self.server.serve_batch(req_table, res_table, keys,
                                                mask, apply_fn, params,
                                                chunk_id=chunk_id))
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
                     emit_every: int = 1, t0=0, n_ranks: int | None = None,
                     elem_sharding=None):
        """``length`` producer steps and their ring puts as ONE store op
        under one table-lock round-trip (the fused producer tier).

        ``n_ranks=None``: ``step_fn(carry, t) -> (carry, key, value)``;
        with ``n_ranks=R``: ``step_fn(carry_r, rank, t)`` over the leading
        ``[R]`` axis of ``carry`` (``store.capture_scan_multi``; ``t0`` an
        int or one start step per rank).  Returns the new carry.

        Unarmed, each put commits as it lands, with the cached watermark
        bumped by its count, so a step that raises leaves the table
        consistent with the puts made before it.  With a ``FaultPlan``
        armed the chunk commits whole, exactly once: the steps run
        collect-only under the chunk's stable ``(rank, seq)`` id and
        ``StoreServer.apply_chunk`` inserts them.  A dropped transfer
        retries the whole attempt against the original carry (collecting
        never changes it), a duplicate is deduplicated by the id, and the
        applied chunk is logged for replay after a store restart.

        ``elem_sharding`` (single-rank only) holds every emission in the
        producer's element layout (``store.capture_scan``).
        """
        if elem_sharding is not None and n_ranks is not None:
            raise ValueError("elem_sharding is single-rank (n_ranks=None): "
                             "a domain-decomposed producer is ONE rank "
                             "spread over the mesh")
        spec = self.server.spec(table)
        clocks = S._rank_clocks(t0, n_ranks or 1)
        dep = self.server.deployment
        staged = dep is not None and dep.crosses_mesh
        # a crossing deployment must go collect → stage → masked insert;
        # an armed FaultPlan routes every deployment through the same
        # logged path, because exactly-once needs the chunk boundary
        if staged or self.server.wal_enabled:
            puts = S.capture_emit_count(length, emit_every, clocks[0]) \
                * (n_ranks or 1)
            chunk_id = (self.rank, self._seq)
            self._seq += 1
            overlap = staged and getattr(dep, "overlap", False)

            def attempt():
                try:
                    with self.server.capture(table) as txn:
                        if n_ranks is None:
                            new_carry, keys, vals, mask = \
                                S.capture_scan_collect(
                                    spec, step_fn, carry, length,
                                    emit_every, t0=clocks[0],
                                    elem_sharding=elem_sharding)
                        else:
                            new_carry, keys, vals, mask = \
                                S.capture_scan_collect_multi(
                                    spec, step_fn, carry, length, n_ranks,
                                    emit_every, t0=clocks)
                        if overlap:
                            # two slots: this chunk's copies in flight,
                            # the previous chunk inserted now (collect
                            # order, one capture late)
                            pending = self.server.stage_chunk_logged(
                                table, chunk_id, keys, vals, mask, puts)
                            prev = self._pipeline(table).swap(pending)
                            if prev is not None:
                                self.server.insert_chunk(table, txn, prev)
                        else:
                            self.server.apply_chunk(table, chunk_id, txn,
                                                    keys, vals, mask, puts)
                except TransferDropped:
                    # drain-on-restage: flush the surviving in-flight slot
                    # before the retry re-collects and re-stages
                    self.drain_captures(table)
                    raise
                return new_carry

            with self.timers.time("send"):
                return self._call_verb("capture", table, attempt)
        with self.timers.time("send"):
            with self.capture(table) as txn:
                def commit(state, n):
                    txn.state = state
                    txn.puts += n

                if n_ranks is None:
                    _, carry = S.capture_scan(
                        spec, txn.state, step_fn, carry, length, emit_every,
                        t0=clocks[0], on_put=commit,
                        elem_sharding=elem_sharding)
                else:
                    _, carry = S.capture_scan_multi(
                        spec, txn.state, step_fn, carry, length, n_ranks,
                        emit_every, t0=clocks, on_put=commit)
        return carry

    def _pipeline(self, table: str) -> StagingPipeline:
        pipe = self._staging.get(table)
        if pipe is None:
            pipe = self._staging[table] = StagingPipeline()
        return pipe

    def drain_captures(self, table: str) -> None:
        """Flush the two-slot staging pipeline: insert the in-flight
        chunk in one capture.  Called at capture end (an overlapped
        producer run ends with exactly one chunk in flight: the plan's ONE
        ``drain`` op) and on a dropped transfer's restage (recovery
        overhead, which ``faults.simulate_overhead`` predicts).  A no-op,
        no op counted, when nothing is in flight."""
        pipe = self._staging.get(table)
        prev = pipe.drain() if pipe is not None else None
        if prev is None:
            return
        with self.timers.time("send"):
            with self.server.capture(table) as txn:
                self.server.insert_chunk(table, txn, prev)

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

    def sample_staged(self, table: str, n: int, draw):
        """The clustered random gather: ``n`` elements sampled on the
        store mesh and brought back to the clients in ONE counted staged
        transfer (``StoreServer.sample_staged``) → ``(values [n, *shape],
        ok)``.  ``draw`` holds ``n`` uniforms in ``[0, 1)``, as for
        :meth:`sample_batch`."""
        if len(draw) != n:
            raise ValueError(f"sample_staged: {len(draw)} draws for n={n}")
        with self.timers.time("retrieve") as box:
            values, ok = self._call_verb(
                "sample_staged", table,
                lambda: self.server.sample_staged(table, draw))
            box[0] = values
        return values, ok

    def capture_epoch(self, table: str, body):
        """One read-only capture through the fault boundary;
        ``body(txn)``'s return value is passed through (the fused
        trainer's ``(state, metrics)``)."""
        def attempt():
            with self.server.capture(table) as txn:
                return body(txn)

        return self._call_verb("capture", table, attempt)

    def latest_batch(self, table: str, n: int):
        """The ``n`` newest elements → ``(values, keys, valid)``."""
        with self.timers.time("retrieve") as box:
            values, keys, valid = self.server.latest(table, n)
            box[0] = values
        return values, keys, valid

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
