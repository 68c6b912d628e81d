"""InSituDriver: the SmartSim "driver program" (paper §2.2).

The paper's driver is a Python script using the SmartSim infrastructure
library to launch the database, the CFD simulation and the distributed
training job, and to wire them together.  Here the driver:

  * builds the ``StoreServer`` with the chosen deployment (co-located or
    clustered),
  * creates the tables the workflow declares,
  * runs the producer and consumer loops on concurrent host threads
    (loose coupling: they interact only with the store, never with each
    other),
  * enforces wall-clock / step budgets and the straggler policy,
  * collects per-component timers from every rank and merges them into the
    paper's Tables-1/2 style report.

Fault-tolerance hooks: a component raising is recorded, the other side keeps
running until its own budget expires (the paper's loose coupling means one
side's failure never deadlocks the other), and ``InSituDriver.run`` returns
a structured result with per-component status so callers (tests, the
launcher) can decide to restart from the in-store checkpoint.

Port of ``src/repro/core/orchestrator.py``: the same driver over the
port's local ``StoreServer``, on the device the caller names.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from . import store as S
from .client import Client
from .faults import FaultPlan
from .server import StoreServer
from .telemetry import Timers

__all__ = ["InSituDriver", "ComponentResult", "RunResult", "StragglerPolicy"]


@dataclass
class StragglerPolicy:
    """Deadline-based mitigation for slow components.

    ``consumer_wait_s``: how long the consumer waits for fresh data before
    training on what it has (never blocks indefinitely on a slow producer).
    ``producer_send_async``: producer sends are enqueue-only (asynchronous
    CUDA launches); the producer never waits for the consumer at all.
    ``max_step_s``: if a single producer/consumer step exceeds this, the
    driver logs a straggler event (on real fleets this triggers rescheduling;
    here it feeds the telemetry used by tests).
    """

    consumer_wait_s: float = 30.0
    producer_send_async: bool = True
    max_step_s: float = float("inf")


@dataclass
class ComponentResult:
    name: str
    steps: int = 0
    error: str | None = None
    #: the exception class name behind ``error`` — the typed taxonomy
    #: (``WatermarkTimeout``, ``InjectedCrash``, …) survives formatting.
    error_type: str | None = None
    straggler_events: int = 0
    #: transient-fault verb retries this component's client absorbed.
    retries: int = 0
    #: crash-recovery restarts this component survived (producer: resumed
    #: from the table watermark; trainer: from ``MemoryCheckpoint``).
    restarts: int = 0
    wall_s: float = 0.0
    #: whatever the component callable returned (an int is also recorded as
    #: ``steps``; richer objects — e.g. the trainer's final state — ride
    #: here so session callers can get results back without side channels).
    output: Any = None
    #: store dispatches attributable to this component (sequential runs
    #: only — concurrent components interleave on one op counter).
    op_delta: int | None = None
    #: cross-mesh staged transfers attributable to this component
    #: (sequential runs only; always 0 off a clustered deployment).
    staged_delta: int | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class RunResult:
    components: dict[str, ComponentResult]
    timers: Timers
    wall_s: float
    #: which component's failure triggered the shutdown (``None`` when the
    #: run completed or ``stop_on_error`` was off).
    failed: str | None = None

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.components.values())

    @property
    def outputs(self) -> dict[str, Any]:
        """Per-component return values (``None`` for bare-int returns)."""
        return {name: c.output for name, c in self.components.items()}


class InSituDriver:
    """Launch producer/consumer component loops against one store."""

    def __init__(self, deployment=None,
                 tables: Sequence[S.TableSpec] = (),
                 straggler: StragglerPolicy | None = None,
                 table_shardings: dict[str, Any] | None = None,
                 faults: FaultPlan | None = None, device=None):
        self.server = StoreServer(deployment, faults=faults, device=device)
        self.straggler = straggler or StragglerPolicy()
        table_shardings = table_shardings or {}
        for spec in tables:
            self.server.create_table(
                spec, slab_sharding=table_shardings.get(spec.name))

    def client(self, rank: int = 0) -> Client:
        return Client(self.server, rank=rank)

    def run(self, components: dict[str, Callable[[Client, "threading.Event"], int]],
            max_wall_s: float = 300.0, ranks: dict[str, int] | None = None,
            sequential: bool = False, stop_on_error: bool = True
            ) -> RunResult:
        """Run each component loop on its own thread.

        A component is ``fn(client, stop_event) -> steps_completed`` (or a
        richer output object carrying a ``steps`` attribute — it lands in
        ``ComponentResult.output``); it should poll ``stop_event`` between
        steps.  ``ranks`` assigns each component a client rank (default:
        enumeration order).

        ``sequential=True`` runs the components one after another in
        declaration order instead of concurrently — deterministic store-op
        attribution (``ComponentResult.op_delta``) for benchmarks and the
        plan-parity tests, and the natural mode for producer-then-train
        offline workflows.  The wall budget covers the whole sequence.

        ``stop_on_error`` (default on): the first component failure fires
        the stop event immediately, so siblings drain and exit instead of
        burning the rest of ``max_wall_s``; the triggering component lands
        in ``RunResult.failed``.  Pass ``stop_on_error=False`` to keep the
        old fully-loose coupling (siblings run to their own budgets —
        e.g. a consumer deliberately finishing on stale data after its
        producer died).
        """
        ranks = ranks or {}
        stop = threading.Event()
        results: dict[str, ComponentResult] = {}
        clients: dict[str, Client] = {}
        threads = []
        failed: list[str] = []

        def _wrap(name: str, fn):
            def _run():
                res = results[name]
                cl = clients[name]
                t0 = time.perf_counter()
                ops0 = self.server.op_count
                staged0 = self.server.staged_transfers
                try:
                    out = fn(cl, stop)
                    res.output = out
                    if isinstance(out, (int, type(None))):
                        res.steps = int(out or 0)
                        res.output = None
                    else:
                        res.steps = int(getattr(out, "steps", 0) or 0)
                except Exception as exc:  # noqa: BLE001 — component isolation
                    res.error = traceback.format_exc()
                    res.error_type = type(exc).__name__
                    if stop_on_error:
                        # prompt shutdown: siblings see the stop event now,
                        # not when their own wall budget expires
                        if not failed:
                            failed.append(name)
                        stop.set()
                finally:
                    res.wall_s = time.perf_counter() - t0
                    res.retries = cl.retries
                    res.restarts = cl.restarts
                    res.straggler_events = cl.straggler_events
                    if sequential:
                        res.op_delta = self.server.op_count - ops0
                        res.staged_delta = \
                            self.server.staged_transfers - staged0
            return _run

        for i, (name, fn) in enumerate(components.items()):
            results[name] = ComponentResult(name=name)
            clients[name] = Client(self.server, rank=ranks.get(name, i))
            threads.append(threading.Thread(target=_wrap(name, fn),
                                            name=f"insitu-{name}", daemon=True))

        t0 = time.perf_counter()
        deadline = t0 + max_wall_s
        if sequential:
            for th in threads:
                th.start()
                th.join(max(0.0, deadline - time.perf_counter()))
                if th.is_alive():        # budget exhausted: stop the rest
                    stop.set()
                    th.join(timeout=30.0)
        else:
            for th in threads:
                th.start()
            for th in threads:
                th.join(max(0.0, deadline - time.perf_counter()))
            stop.set()
            for th in threads:
                th.join(timeout=30.0)

        timers = Timers()
        for name, cl in clients.items():
            timers.merge(cl.timers)
        return RunResult(components=results, timers=timers,
                         wall_s=time.perf_counter() - t0,
                         failed=failed[0] if failed else None)
