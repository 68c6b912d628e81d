"""Typed store failures, retry, declared fault plans and their cost.

Port of ``src/repro/core/faults.py``:

* a typed failure taxonomy (``StoreError`` and friends) replaces the
  silent-``False`` timeouts and bare ``RuntimeError``s of the early store;
* :class:`RetryPolicy` / :func:`call_with_retry` give every client verb
  bounded exponential backoff with deterministic jitter, deadline-clamped
  exactly like ``telemetry.poll_backoff``;
* :class:`FaultPlan` / :class:`FaultEvent` declare *which* faults fire
  *where* (dropped or duplicated chunk transfers, transient
  ``StoreUnavailable`` windows on client verbs, component crashes, store
  snapshots and restarts), keyed by deterministic attempt indices, never
  wall clock; :meth:`FaultPlan.random` draws one from
  ``random.Random(seed)``, so a seed gives the same events in both
  packages;
* :class:`FaultInjector` is the runtime arbiter the ``Client`` consults at
  every verb attempt and the ``StoreServer`` at every chunk staging
  attempt and table commit;
* :func:`simulate_overhead` re-runs the same injector against a session's
  static component schedule, so the plan's predicted retries, replay ops
  and restarts equal the measured ``StoreServer.stats()`` exactly.

Exactly-once: ``store.put_masked`` is not idempotent (``ptr``/``count``
advance on every apply), so the server keys every chunk by a stable
``(rank, seq)`` id: a dropped transfer is retried under the same id, a
duplicated one hits the acknowledged-id set and is a no-op.  A store
restart replays the write-ahead log's tail from the last snapshot: the
same entries in the same order from the same state give the same bytes.

On a clustered deployment the simulator also walks the two-slot overlap
pipeline (a drop flushes the in-flight chunk in its own op before the
restage) and counts the re-staged hops (``extra_staged``).
"""

from __future__ import annotations

import random as _random
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterator

__all__ = [
    "StoreError", "StoreTimeout", "WatermarkTimeout", "StoreUnavailable",
    "TransferDropped", "InjectedCrash",
    "RetryPolicy", "call_with_retry",
    "FaultEvent", "FaultPlan", "FaultInjector",
    "Overhead", "simulate_overhead",
]


# ---------------------------------------------------------------------------
# Typed failure taxonomy
# ---------------------------------------------------------------------------

class StoreError(RuntimeError):
    """Base class of every store-side failure."""


class StoreTimeout(StoreError):
    """A store wait expired.  Carries what was awaited and the deadline
    context so callers (and ``ComponentResult.error``) see *which* wait on
    *what* object timed out, not a bare ``False``."""

    def __init__(self, what: str, name: str, timeout: float,
                 detail: str = ""):
        self.what, self.name, self.timeout = what, name, timeout
        msg = f"{what} {name!r} timed out after {timeout:.3g}s"
        super().__init__(msg + (f" ({detail})" if detail else ""))


class WatermarkTimeout(StoreTimeout):
    """``wait_watermark`` expired: the table never reached the minimum."""

    def __init__(self, table: str, minimum: int, watermark: int,
                 timeout: float):
        self.table, self.minimum, self.watermark = table, minimum, watermark
        super().__init__("watermark of table", table, timeout,
                         f"wanted >= {minimum}, have {watermark}")


class StoreUnavailable(StoreError):
    """Transient store unavailability — the retryable class: client verbs
    wrapped in :func:`call_with_retry` absorb it up to the policy bound."""


class TransferDropped(StoreUnavailable):
    """A staged chunk transfer was lost in flight (the clustered
    deployment's dropped-TCP-message analogue).  Retryable: the client
    re-stages the chunk under the same chunk id."""


class InjectedCrash(StoreError):
    """A declared component crash.  NOT retryable at the verb level — it
    propagates to the component's restart loop (producer: resume from the
    table watermark; trainer: resume from ``MemoryCheckpoint``)."""

    def __init__(self, component: str, at: int):
        self.component, self.at = component, at
        super().__init__(f"injected crash of {component!r} at index {at}")


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    The sleep schedule mirrors ``telemetry.poll_backoff``: ``interval``
    doubling up to ``max_interval``, every sleep clamped to the time
    remaining before ``timeout`` so a retry loop never overshoots its
    deadline by a backoff step.  ``jitter`` scales each sleep by a factor
    drawn from ``random.Random(seed)`` — seeded, so two runs of the same
    plan sleep identically (fault determinism is the whole point)."""

    max_attempts: int = 6
    interval: float = 0.001
    max_interval: float = 0.05
    timeout: float = 30.0
    jitter: float = 0.25
    seed: int = 0

    def sleeps(self) -> Iterator[float]:
        """Yield the bounded, jittered, deadline-clamped sleep durations
        between attempts (``max_attempts - 1`` of them at most)."""
        rng = _random.Random(self.seed)
        deadline = time.perf_counter() + self.timeout
        interval = self.interval
        for _ in range(max(0, self.max_attempts - 1)):
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return
            scale = 1.0 + self.jitter * rng.random()
            yield min(interval * scale, remaining)
            interval = min(interval * 2.0, self.max_interval)


def call_with_retry(fn, policy: RetryPolicy, on_retry=None):
    """Call ``fn()``; on :class:`StoreUnavailable` retry per ``policy``.

    ``on_retry`` (if given) runs once per retry — the hook the client and
    server use to keep their retry counters exact.  The last failure is
    re-raised when attempts or the deadline run out.  Non-transient
    exceptions (anything not ``StoreUnavailable``) propagate immediately.
    """
    sleeps = policy.sleeps()
    while True:
        try:
            return fn()
        except StoreUnavailable:
            sleep_s = next(sleeps, None)
            if sleep_s is None:
                raise
            if on_retry is not None:
                on_retry()
            time.sleep(sleep_s)


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

#: event kinds and the index space their ``at`` lives in
FAULT_KINDS = {
    "drop_chunk":  "table staging-attempt index",
    "dup_chunk":   "table staging-attempt index",
    "unavailable": "per-verb attempt index (``count`` consecutive raises)",
    "snapshot":    "table commit index (1-based, fires after that commit)",
    "restart":     "table commit index (1-based, fires after that commit)",
    "crash":       "component step/chunk/epoch index",
}


@dataclass(frozen=True)
class FaultEvent:
    """One declared fault.  ``at`` indexes deterministic progress counters
    (attempt/commit/step indices — see :data:`FAULT_KINDS`), never wall
    time, so a plan replays identically on any machine."""

    kind: str
    table: str | None = None      # chunk/commit kinds; optional verb filter
    verb: str | None = None       # "unavailable": which client verb
    at: int = 0
    count: int = 1                # "unavailable": consecutive failures
    component: str | None = None  # "crash": which component

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(have {sorted(FAULT_KINDS)})")
        if self.kind == "unavailable" and self.verb is None:
            raise ValueError("'unavailable' needs a verb")
        if self.kind == "crash" and self.component is None:
            raise ValueError("'crash' needs a component name")
        if self.kind in ("drop_chunk", "dup_chunk", "snapshot", "restart") \
                and self.table is None:
            raise ValueError(f"{self.kind!r} needs a table")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative set of faults plus the retry policy that
    absorbs the transient ones.  Declared on an ``InSituSession`` or a
    ``StoreServer``; an *empty* plan (no events) still arms the
    exactly-once machinery (chunk ids, write-ahead log, checkpoints), so
    a fault-free baseline takes the identical code path."""

    events: tuple[FaultEvent, ...] = ()
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    seed: int = 0

    @classmethod
    def random(cls, seed: int, *, tables=("field",), verbs=("put", "sample",
                                                            "capture"),
               components=("producer", "trainer"), n_events: int = 3,
               max_index: int = 8, retry: RetryPolicy | None = None
               ) -> "FaultPlan":
        """A seeded random plan over the given index bounds — the chaos
        grid's generator.  Same seed, same plan, on every machine."""
        rng = _random.Random(seed)
        events = []
        for _ in range(n_events):
            kind = rng.choice(sorted(FAULT_KINDS))
            at = rng.randrange(max(1, max_index))
            if kind == "unavailable":
                events.append(FaultEvent(kind, verb=rng.choice(list(verbs)),
                                         at=at, count=rng.randint(1, 2)))
            elif kind == "crash":
                events.append(FaultEvent(
                    kind, component=rng.choice(list(components)), at=at))
            else:
                events.append(FaultEvent(
                    kind, table=rng.choice(list(tables)),
                    at=at + (1 if kind in ("snapshot", "restart") else 0)))
        return cls(events=tuple(events),
                   retry=retry or RetryPolicy(seed=seed), seed=seed)


class FaultInjector:
    """The runtime (and plan-time) arbiter of a :class:`FaultPlan`.

    Keeps the deterministic progress counters the events key on — per-verb
    attempt counts, per-table staging-attempt counts, per-table commit
    counts, per-component crash-point indices — and raises/returns the
    declared fault when a counter crosses an event.  The server owns one
    injector; every client of that server consults it, so the counters are
    global and (in sequential runs) fully deterministic.  The plan-time
    simulator (:func:`simulate_overhead`) drives a *fresh* injector with
    the same call sequence, which is what makes predictions exact."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.retry = plan.retry
        self.faults_injected = 0
        self._verb_attempts: dict[str, int] = defaultdict(int)
        self._stage_attempts: dict[str, int] = defaultdict(int)
        self._commits: dict[str, int] = defaultdict(int)
        self._consumed: set[int] = set()
        self._verb_events = [e for e in plan.events
                             if e.kind == "unavailable"]
        self._chunk_events = {(e.table, e.at): e.kind for e in plan.events
                              if e.kind in ("drop_chunk", "dup_chunk")}
        self._commit_events: dict[tuple, list[str]] = defaultdict(list)
        for e in plan.events:
            if e.kind in ("snapshot", "restart"):
                self._commit_events[(e.table, e.at)].append(e.kind)
        for acts in self._commit_events.values():
            acts.sort(reverse=True)      # snapshot before restart
        self._crash_events = [(i, e) for i, e in enumerate(plan.events)
                              if e.kind == "crash"]

    # -- injection points ---------------------------------------------------

    def on_verb(self, verb: str, table: str | None = None) -> None:
        """One client verb attempt (retries included).  Raises
        :class:`StoreUnavailable` when a declared window covers it."""
        i = self._verb_attempts[verb]
        self._verb_attempts[verb] = i + 1
        for e in self._verb_events:
            if e.verb == verb and (e.table is None or e.table == table) \
                    and e.at <= i < e.at + e.count:
                self.faults_injected += 1
                raise StoreUnavailable(
                    f"injected: store unavailable for {verb!r} attempt {i}")

    def on_stage(self, table: str) -> bool:
        """One chunk staging attempt on ``table`` (retries included).
        Raises :class:`TransferDropped` on a declared drop; returns True
        when a *duplicate* delivery of this chunk should follow (the
        caller pays the extra hop; the ack set deduplicates it)."""
        i = self._stage_attempts[table]
        self._stage_attempts[table] = i + 1
        kind = self._chunk_events.get((table, i))
        if kind == "drop_chunk":
            self.faults_injected += 1
            raise TransferDropped(
                f"injected: chunk transfer to {table!r} dropped "
                f"(staging attempt {i})")
        if kind == "dup_chunk":
            self.faults_injected += 1
            return True
        return False

    def on_commit(self, table: str) -> tuple[str, ...]:
        """One committed mutation of ``table``.  Returns the declared
        operator actions at this commit index: ``"snapshot"`` and/or
        ``"restart"`` (snapshot always first)."""
        self._commits[table] += 1
        acts = tuple(self._commit_events.get((table, self._commits[table]),
                                             ()))
        self.faults_injected += sum(1 for a in acts if a == "restart")
        return acts

    def maybe_crash(self, component: str, at: int) -> None:
        """One crash point (producer: before step/chunk ``at``; trainer:
        top of epoch ``at``).  Each declared crash fires exactly once —
        the restarted component passes the same index unharmed."""
        for i, e in self._crash_events:
            if i not in self._consumed and e.component == component \
                    and e.at == at:
                self._consumed.add(i)
                self.faults_injected += 1
                raise InjectedCrash(component, at)


# ---------------------------------------------------------------------------
# Plan-time cost prediction
# ---------------------------------------------------------------------------

@dataclass
class Overhead:
    """Per-component fault overhead: extra store dispatches (WAL replay
    after a store restart), extra staged transfers (dropped/duplicated
    chunk deliveries across meshes; 0 on the port's local deployment),
    verb retries, and component restarts."""

    extra_ops: int = 0
    extra_staged: int = 0
    retries: int = 0
    restarts: int = 0

    @property
    def empty(self) -> bool:
        return not (self.extra_ops or self.extra_staged or self.retries
                    or self.restarts)


def simulate_overhead(plan: FaultPlan, schedule, crosses_mesh: bool
                      ) -> tuple[dict[str, Overhead], dict[str, int]]:
    """Walk a session's component ``schedule`` through a fresh
    :class:`FaultInjector` and tally what the faults will cost.

    ``schedule`` is a list of dicts (declaration order — the sequential
    execution order the exactness claim covers), one per plan entry:

    * producer per-verb: ``{kind, name, tier: "per_verb", table, steps,
      emit_every, ranks}``
    * producer fused: ``{kind, name, tier, table, n_chunks, overlap}``
      (``overlap``: the clustered two-slot staging pipeline)
    * trainer: ``{kind, name, tier, table, epochs, bootstrap}``
    * inference: ``{kind, name, tier, steps}``
    * serving clients: ``{kind, name, tier, table, results, requests,
      submit, collect}``
    * serving consumer: ``{kind, name, tier, table, results, requests,
      n_batches}``

    The walk mirrors the runtime control flow *exactly* — every
    ``on_verb`` / ``on_stage`` / ``on_commit`` / ``maybe_crash`` call the
    live components make, in the same order, driving the same injector
    class — so predicted retries/replays/restages equal the measured
    counters, not approximately but identically.  Returns
    ``(per_component_overhead, totals)`` where totals carries the
    ``faults_injected`` / ``retries`` / ``recoveries`` the server's
    ``stats()`` will report."""
    inj = FaultInjector(plan)
    wal_len: dict[str, int] = defaultdict(int)
    wal_base: dict[str, int] = defaultdict(int)
    recoveries = [0]
    per: dict[str, Overhead] = {}

    def _verb(o: Overhead, verb: str, table: str | None) -> None:
        while True:
            try:
                inj.on_verb(verb, table)
                return
            except StoreUnavailable:
                o.retries += 1

    def _commit(o: Overhead, table: str) -> None:
        wal_len[table] += 1
        for act in inj.on_commit(table):
            if act == "snapshot":
                for t in list(wal_len):
                    wal_base[t] = wal_len[t]
            else:  # restart: replay every table's WAL tail, one op each
                o.extra_ops += sum(wal_len[t] - wal_base[t]
                                   for t in wal_len)
                recoveries[0] += 1

    def _logged_capture(o: Overhead, table: str) -> None:
        # mirrors Client.capture_scan's WAL path: verb attempt, staging
        # attempt (hop paid before the drop check), dup pays one more hop
        while True:
            try:
                inj.on_verb("capture", table)
            except StoreUnavailable:
                o.retries += 1
                continue
            try:
                dup = inj.on_stage(table)
            except TransferDropped:
                o.retries += 1
                if crosses_mesh:
                    o.extra_staged += 1
                continue
            if dup and crosses_mesh:
                o.extra_staged += 1
            break
        _commit(o, table)

    def _overlap_capture(o: Overhead, table: str, pending: bool) -> bool:
        # mirrors the two-slot pipeline in Client.capture_scan: verb
        # attempt, then THIS chunk's staging attempt (hop paid before the
        # drop check, dup pays one more).  A drop triggers the drain-on-
        # restage flush — the surviving in-flight slot commits in its own
        # recovery op — before the retry re-collects and re-stages.  A
        # successful stage swaps slots: the PREVIOUS chunk commits in
        # this capture, the new chunk becomes the in-flight slot.
        while True:
            try:
                inj.on_verb("capture", table)
            except StoreUnavailable:
                o.retries += 1
                continue
            try:
                dup = inj.on_stage(table)
            except TransferDropped:
                o.retries += 1
                if crosses_mesh:
                    o.extra_staged += 1
                if pending:
                    o.extra_ops += 1      # the drain-on-restage op
                    _commit(o, table)
                    pending = False
                continue
            if dup and crosses_mesh:
                o.extra_staged += 1
            if pending:
                _commit(o, table)
            return True

    def _serve_chunk(o: Overhead, table: str) -> None:
        # mirrors Client.serve_batch: verb attempt, then the injector's
        # stage hook on the results table (a drop retries the whole fused
        # dispatch under the same chunk id; the serve dispatch never
        # crosses the interconnect, so no hops are counted either way),
        # then the commit boundary
        while True:
            try:
                inj.on_verb("serve", table)
            except StoreUnavailable:
                o.retries += 1
                continue
            try:
                inj.on_stage(table)
            except TransferDropped:
                o.retries += 1
                continue
            break
        _commit(o, table)

    def _crash_point(o: Overhead, name: str, at: int) -> None:
        while True:
            try:
                inj.maybe_crash(name, at)
                return
            except InjectedCrash:
                o.restarts += 1

    for comp in schedule:
        o = per.setdefault(comp["name"], Overhead())
        kind, tier = comp["kind"], comp["tier"]
        if kind == "producer" and tier == "per_verb":
            for t in range(comp["steps"]):
                _crash_point(o, comp["name"], t)
                if t % comp["emit_every"] == 0:
                    for _ in range(comp["ranks"]):
                        _verb(o, "put", comp["table"])
                        _commit(o, comp["table"])
        elif kind == "producer":
            if comp.get("overlap"):
                pending = False
                for i in range(comp["n_chunks"]):
                    _crash_point(o, comp["name"], i)
                    pending = _overlap_capture(o, comp["table"], pending)
                if pending:
                    # the capture-end drain: its op is part of the base
                    # plan (("drain", 1)), only its commit walks here
                    _commit(o, comp["table"])
            else:
                for i in range(comp["n_chunks"]):
                    _crash_point(o, comp["name"], i)
                    _logged_capture(o, comp["table"])
        elif kind == "trainer":
            if comp["bootstrap"]:
                _verb(o, "sample", comp["table"])
            for e in range(comp["epochs"]):
                _crash_point(o, comp["name"], e)
                if tier == "per_verb":
                    _verb(o, "sample", comp["table"])
                elif tier == "slab_sharded_clustered":
                    _verb(o, "sample_staged", comp["table"])
                else:           # fused tiers: a read-only capture
                    _verb(o, "capture", comp["table"])
        elif kind == "inference" and tier == "three_step":
            tin, tout = f"{comp['name']}_in", f"{comp['name']}_out"
            for _ in range(comp["steps"]):
                _verb(o, "put", tin)
                _commit(o, tin)       # put_tensor of the input
                _commit(o, tout)      # run_model's prediction put
        elif kind == "clients":
            if comp["submit"]:
                for r in range(comp["requests"]):
                    _crash_point(o, comp["name"], r)
                    _verb(o, "put", comp["table"])
                    _commit(o, comp["table"])
            if comp["collect"]:
                # response gets ride the fault boundary but never commit
                for _ in range(comp["requests"]):
                    _verb(o, "get", comp["results"])
        elif kind == "serving" and tier == "three_step":
            for r in range(comp["requests"]):
                _crash_point(o, comp["name"], r)
                _verb(o, "get", comp["table"])
                _verb(o, "put", comp["results"])
                _commit(o, comp["results"])
        elif kind == "serving":
            # continuous batching: crash index = batch index (recovery
            # re-cursors from the results watermark and retries the SAME
            # batch, so the drained-batch count is crash-invariant)
            for i in range(comp["n_batches"]):
                _crash_point(o, comp["name"], i)
                _serve_chunk(o, comp["results"])
        # fused_registry inference never touches the store: nothing to walk

    totals = {
        "faults_injected": inj.faults_injected,
        "retries": sum(o.retries for o in per.values()),
        "recoveries": recoveries[0],
    }
    return per, totals
