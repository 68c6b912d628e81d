"""InSituSession: one declarative call for a coupling scenario.

Port of ``src/repro/insitu/session.py`` — the serving plane: declare the
request clients and the draining consumer,

    session = InSituSession(
        tables=[TableSpec("sreq", shape=(4, n), capacity=32),
                TableSpec("sres", shape=(100,), capacity=32)],
        components=[ServingClients(feed, table="sreq", ...),
                    ServingConsumer("encoder", table="sreq",
                                    results="sres", ...)],
        device="cuda")
    plan = session.plan()            # predicted dispatches, batches, swaps
    result = session.run(plan=plan, preload=register_model)

and the :class:`~.plan.Plan` resolver picks the tier and predicts the
store dispatches that ``result.server.stats()`` must show.  Only the local
deployment exists in this slice (``deployment`` other than ``None``:
``ROADMAP.md`` A5; an armed ``FaultPlan``: A4; ``plan(hlo=True)``: A6).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable, Sequence

from ..core import store as S
from ..core.client import Client
from ..core.faults import FaultPlan, InjectedCrash
from ..core.orchestrator import InSituDriver, RunResult, StragglerPolicy
from ..core.server import StoreServer
from ..device import resolve_device
from ..serve.engine import ServeLoop, request_key, submitted_meta
from . import plan as P
from .components import (ServingClients, ServingClientsOutput,
                         ServingConsumer, ServingOutput)

__all__ = ["InSituSession", "SessionResult"]


@dataclass
class SessionResult:
    """What a session run produced: the orchestrator's RunResult, the plan
    it executed, the live server and typed per-component outputs."""

    run: RunResult
    plan: P.Plan
    server: StoreServer
    driver: InSituDriver

    @property
    def ok(self) -> bool:
        return self.run.ok

    @property
    def outputs(self) -> dict[str, Any]:
        return self.run.outputs

    def output(self, name: str):
        return self.run.components[name].output

    def op_delta(self, name: str) -> int | None:
        """Store dispatches attributed to one component (sequential runs)."""
        return self.run.components[name].op_delta


class InSituSession:
    """Declarative in-situ coupling session (see module docstring)."""

    def __init__(self, components: Sequence[Any],
                 tables: Sequence[S.TableSpec] = (),
                 deployment=None,
                 straggler: StragglerPolicy | None = None,
                 faults: FaultPlan | None = None, device=None):
        if not components:
            raise ValueError("a session needs at least one component")
        if deployment is not None:
            raise NotImplementedError(
                "deployments other than local: ROADMAP.md A5")
        if faults is not None:
            raise NotImplementedError("armed FaultPlan: ROADMAP.md A4")
        self.tables = tuple(tables)
        self.deployment = None
        self.straggler = straggler
        self.device = resolve_device(device)
        self.components = self._normalize(components)
        table_names = {t.name for t in self.tables}
        for comp in self.components:
            if isinstance(comp, ServingClients):
                if comp.table not in table_names:
                    raise ValueError(f"serving clients {comp.name!r} target "
                                     f"unknown table {comp.table!r}")
                if comp.collect \
                        and self._serving_consumer_for(comp.table) is None:
                    raise ValueError(
                        f"serving clients {comp.name!r} collect from table "
                        f"{comp.table!r} but no ServingConsumer drains it")
            if isinstance(comp, ServingConsumer):
                for tname in (comp.table, comp.results):
                    if tname not in table_names:
                        raise ValueError(f"serving {comp.name!r} uses "
                                         f"unknown table {tname!r}")
                    spec = self._spec(tname)
                    total = comp.clients * comp.requests
                    # packed (client, seq) keys are unique but not dense:
                    # the hash engine would collide them mod capacity, and
                    # a ring smaller than the request volume would evict
                    # unanswered requests — both break exactly-once.
                    if spec.engine != "ring":
                        raise ValueError(
                            f"serving table {tname!r} must use the ring "
                            f"engine (hash collides packed request keys)")
                    if spec.capacity < total:
                        raise ValueError(
                            f"serving table {tname!r} capacity "
                            f"{spec.capacity} < {total} total requests")
        for comp in self.components:
            if isinstance(comp, ServingConsumer):
                subs = [c for c in self.components
                        if isinstance(c, ServingClients) and c.submit
                        and c.table == comp.table]
                if len(subs) != 1:
                    raise ValueError(
                        f"serving {comp.name!r} needs exactly one "
                        f"submitting ServingClients on table "
                        f"{comp.table!r}, found {len(subs)}")
                if (subs[0].clients, subs[0].requests) != \
                        (comp.clients, comp.requests):
                    raise ValueError(
                        f"serving {comp.name!r} drains "
                        f"{comp.clients}x{comp.requests} requests but "
                        f"{subs[0].name!r} submits "
                        f"{subs[0].clients}x{subs[0].requests}")

    @staticmethod
    def _normalize(components) -> tuple[Any, ...]:
        """Give every component a unique name (suffix duplicates)."""
        seen: dict[str, int] = {}
        out = []
        for comp in components:
            if not isinstance(comp, (ServingClients, ServingConsumer)):
                raise TypeError(f"unknown component type {type(comp)!r}")
            name = comp.name
            if name in seen or sum(c.name == name for c in components) > 1:
                idx = seen.get(name, 0)
                seen[name] = idx + 1
                comp = _dc_replace(comp, name=f"{name}{idx}")
            else:
                seen[name] = 1
            out.append(comp)
        return tuple(out)

    # -- plan resolution ----------------------------------------------------

    def plan(self, hlo: bool = False) -> P.Plan:
        """Resolve the frozen execution :class:`~.plan.Plan`."""
        if hlo:
            raise NotImplementedError(
                "plan(hlo=True) collective accounting: ROADMAP.md A6")
        entries: list[P.ComponentPlan] = []
        for comp in self.components:
            total = comp.clients * comp.requests
            if isinstance(comp, ServingClients):
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="clients", tier="per_verb",
                    table=comp.table, steps=total,
                    dispatches=P.clients_dispatches(total, comp.submit,
                                                    comp.collect)))
            else:
                tier = P.serving_tier(comp)
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="serving", tier=tier,
                    table=comp.table, steps=total,
                    dispatches=P.serving_dispatches(tier, total,
                                                    comp.max_batch),
                    swaps=P.serving_swaps(tier)))
        return P.Plan(deployment="local", components=tuple(entries))

    def _spec(self, table: str) -> S.TableSpec:
        for t in self.tables:
            if t.name == table:
                return t
        raise KeyError(table)

    def _serving_consumer_for(self, table: str) -> ServingConsumer | None:
        """The ServingConsumer draining request ``table``, if declared."""
        for c in self.components:
            if isinstance(c, ServingConsumer) and c.table == table:
                return c
        return None

    def _serving_results(self, table: str) -> str:
        c = self._serving_consumer_for(table)
        if c is None:
            raise ValueError(f"no ServingConsumer drains table {table!r}")
        return c.results

    # -- runtime ------------------------------------------------------------

    def run(self, plan: P.Plan | None = None, max_wall_s: float = 300.0,
            sequential: bool = False,
            preload: Callable[[StoreServer], None] | None = None
            ) -> SessionResult:
        """Execute the session: build the store on the session's device,
        run one thread per component per ``plan``.  ``sequential=True``
        runs components in declaration order (exact per-component dispatch
        attribution); ``preload`` is called with the fresh server before
        any component starts (register the served model there)."""
        plan = plan or self.plan()
        driver = InSituDriver(tables=self.tables, straggler=self.straggler,
                              device=self.device)
        if preload is not None:
            preload(driver.server)
        fns: dict[str, Callable] = {}
        if len(plan.components) != len(self.components):
            raise ValueError("plan does not match this session's declaration")
        for comp, entry in zip(self.components, plan.components):
            kind = "clients" if isinstance(comp, ServingClients) \
                else "serving"
            if entry.kind != kind:
                raise ValueError(
                    f"plan does not match this session's declaration "
                    f"(expected a {kind!r} entry, got {entry})")
            if kind == "clients":
                fns[entry.name] = self._clients_fn(comp, entry, max_wall_s)
            else:
                fns[entry.name] = self._serving_fn(comp, entry, max_wall_s)
        res = driver.run(fns, max_wall_s=max_wall_s, sequential=sequential)
        return SessionResult(run=res, plan=plan, server=driver.server,
                             driver=driver)

    # -- component runners --------------------------------------------------

    def _clients_fn(self, comp: ServingClients, entry: P.ComponentPlan,
                    max_wall_s: float):
        results = self._serving_results(comp.table) if comp.collect \
            else None
        total = comp.clients * comp.requests

        def fn(client: Client, stop):
            server = client.server
            responses: dict = {}
            submitted = 0
            if comp.submit:
                # client-major arrival by default; order_seed shuffles
                # WHICH client submits next (per-client sequence ids stay
                # monotone) — the loop's round-robin discovery makes the
                # batch count invariant to it
                order = [c for _ in range(comp.requests)
                         for c in range(comp.clients)]
                if comp.order_seed is not None:
                    random.Random(comp.order_seed).shuffle(order)
                next_seq = [0] * comp.clients
                for i, c in enumerate(order):
                    if stop.is_set():
                        break
                    s = next_seq[c]
                    client.fault_point(entry.name, i)
                    value = comp.feed(c, s)
                    client.put_kv(comp.table, request_key(c, s), value)
                    # make the request visible: a host metadata write
                    server.put_meta(submitted_meta(comp.table, c), s + 1)
                    next_seq[c] = s + 1
                    submitted += 1
            if comp.collect:
                # the results watermark is the free completion signal;
                # each owned key is then fetched once, client-major
                server.wait_watermark(results, total, timeout=max_wall_s)
                for c in range(comp.clients):
                    for s in range(comp.requests):
                        if stop.is_set():
                            break
                        v, _found = client.get_kv(results,
                                                  request_key(c, s))
                        responses[(c, s)] = v
            return ServingClientsOutput(requests=submitted,
                                        responses=responses)
        return fn

    def _serving_fn(self, comp: ServingConsumer, entry: P.ComponentPlan,
                    max_wall_s: float):
        def fn(client: Client, stop):
            timeout = comp.wait_timeout_s if comp.wait_timeout_s \
                is not None else max_wall_s
            loop = ServeLoop(
                client, model_key=comp.model_key,
                request_table=comp.table, response_table=comp.results,
                clients=comp.clients, requests=comp.requests,
                max_batch=comp.max_batch, reload_every=comp.reload_every,
                component=entry.name)
            while True:
                try:
                    if entry.tier == "three_step":
                        loop.run_three_step(stop_event=stop,
                                            timeout=timeout)
                    else:
                        loop.run(stop_event=stop, timeout=timeout)
                    break
                except InjectedCrash:
                    client.restarts += 1
                    loop.recover()
            return ServingOutput(steps=loop.served, batches=loop.batches,
                                 swaps=loop.swaps)
        return fn
