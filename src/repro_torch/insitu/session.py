"""InSituSession: one declarative call for a coupling scenario.

Port of ``src/repro/insitu/session.py`` — the local deployment on one
device.  Declare *what* runs,

    session = InSituSession(
        tables=[TableSpec("field", shape=(4, n), capacity=24)],
        components=[Producer(step_fn, table="field", steps=40,
                             emit_every=2),
                    TrainerConsumer(cfg, coords, model_key="encoder"),
                    InferenceConsumer("encoder", feed)],
        device="cuda")
    plan = session.plan()            # tiers and predicted dispatches
    result = session.run(plan=plan)

and the :class:`~.plan.Plan` resolver picks *how*: per-verb vs
``capture_scan`` vs ``capture_scan_multi`` producers, per-verb vs fused
trainers, fused-registry vs three-step inference, continuous-batching vs
three-step serving.  It predicts the store dispatches that
``result.server.stats()`` must show.  Deployments other than ``None``
(``ROADMAP.md`` A5), an armed ``FaultPlan`` (A4) and ``plan(hlo=True)``
(A6) raise.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable, Sequence

import torch

from ..core import store as S
from ..core.client import Client
from ..core.faults import FaultPlan, InjectedCrash
from ..core.orchestrator import InSituDriver, RunResult, StragglerPolicy
from ..core.server import StoreServer
from ..core.telemetry import block_until_ready
from ..device import resolve_device
from ..ml import autoencoder as ae
from ..ml import trainer as tr
from ..serve.engine import ServeLoop, request_key, submitted_meta
from ..tree import tree_map
from . import plan as P
from .components import (InferenceConsumer, InferenceOutput, Producer,
                         ProducerOutput, ServingClients,
                         ServingClientsOutput, ServingConsumer,
                         ServingOutput, TrainerConsumer, TrainerOutput)

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
            if isinstance(comp, Producer) and comp.table not in table_names:
                raise ValueError(f"producer {comp.name!r} targets unknown "
                                 f"table {comp.table!r}")
            if isinstance(comp, TrainerConsumer) \
                    and comp.cfg.table not in table_names:
                raise ValueError(f"trainer {comp.name!r} reads unknown "
                                 f"table {comp.cfg.table!r}")
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
            if not isinstance(comp, _COMPONENT_KINDS):
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
        first_trainer = True
        for comp in self.components:
            if isinstance(comp, Producer):
                tier = P.producer_tier(comp)
                chunk = comp.chunk or P.default_chunk(comp.emit_every)
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="producer", tier=tier,
                    table=comp.table, ranks=comp.ranks, steps=comp.steps,
                    chunk=0 if tier == "per_verb" else chunk,
                    bucketed=comp.bucket and tier != "per_verb",
                    dispatches=P.producer_dispatches(
                        tier, comp.steps, comp.emit_every, comp.ranks,
                        chunk)))
            elif isinstance(comp, TrainerConsumer):
                tier = P.trainer_tier(comp.cfg, comp.tier)
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="trainer", tier=tier,
                    table=comp.cfg.table, steps=comp.cfg.epochs,
                    dispatches=P.trainer_dispatches(
                        tier, comp.cfg.epochs, bootstrap=first_trainer)))
                first_trainer = False
            elif isinstance(comp, InferenceConsumer):
                tier = P.inference_tier(comp)
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="inference", tier=tier,
                    steps=comp.steps,
                    dispatches=P.inference_dispatches(tier, comp.steps)))
            elif isinstance(comp, ServingClients):
                total = comp.clients * comp.requests
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="clients", tier="per_verb",
                    table=comp.table, steps=total,
                    dispatches=P.clients_dispatches(total, comp.submit,
                                                    comp.collect)))
            else:
                total = comp.clients * comp.requests
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
            preload: Callable[[StoreServer], None] | None = None,
            verbose: bool = False) -> SessionResult:
        """Execute the session: build the store on the session's device,
        run one thread per component per ``plan``.  ``sequential=True``
        runs components in declaration order (exact per-component dispatch
        attribution); ``preload`` is called with the fresh server before
        any component starts (register a served model there); ``verbose``
        prints one line per trainer epoch."""
        plan = plan or self.plan()
        driver = InSituDriver(tables=self.tables, straggler=self.straggler,
                              device=self.device)
        if preload is not None:
            preload(driver.server)
        fns: dict[str, Callable] = {}
        if len(plan.components) != len(self.components):
            raise ValueError("plan does not match this session's declaration")
        for comp, entry in zip(self.components, plan.components):
            kind = _COMPONENT_KINDS_BY_TYPE[type(comp)]
            if entry.kind != kind:
                raise ValueError(
                    f"plan does not match this session's declaration "
                    f"(expected a {kind!r} entry, got {entry})")
            if kind == "producer":
                fns[entry.name] = self._producer_fn(comp, entry)
            elif kind == "trainer":
                fns[entry.name] = self._trainer_fn(comp, entry, verbose)
            elif kind == "inference":
                fns[entry.name] = self._inference_fn(comp, entry,
                                                     max_wall_s)
            elif kind == "clients":
                fns[entry.name] = self._clients_fn(comp, entry, max_wall_s)
            else:
                fns[entry.name] = self._serving_fn(comp, entry, max_wall_s)
        res = driver.run(fns, max_wall_s=max_wall_s, sequential=sequential)
        return SessionResult(run=res, plan=plan, server=driver.server,
                             driver=driver)

    # -- component runners --------------------------------------------------

    def _producer_fn(self, comp: Producer, entry: P.ComponentPlan):
        pol = self.straggler or StragglerPolicy()

        def warm(client: Client):
            """One step off the clock, dropped (first-call set-up)."""
            if comp.warmup:
                with client.timers.time("warmup") as box:
                    carry = comp.carry if comp.ranks == 1 else \
                        tree_map(lambda x: x[0], comp.carry)
                    box[0] = comp.step_fn(carry, 0, 0)[2]

        if entry.tier == "per_verb":
            def fn(client: Client, stop):
                warm(client)
                carry, done = comp.carry, 0
                for t in range(comp.steps):
                    if stop.is_set():
                        break
                    client.fault_point(entry.name, t)
                    it0 = time.perf_counter()
                    emit = t % comp.emit_every == 0
                    with client.timers.time("equation_solution") as box:
                        if comp.ranks == 1:
                            carry, key, value = comp.step_fn(carry, 0, t)
                            sends = [(key, value)]
                        else:
                            new, sends = [], []
                            for r in range(comp.ranks):
                                c_r, key, value = comp.step_fn(
                                    tree_map(lambda x: x[r], carry), r, t)
                                new.append(c_r)
                                sends.append((key, value))
                            carry = tree_map(lambda *xs: torch.stack(xs),
                                             *new)
                        box[0] = [v for _, v in sends]
                    if emit:
                        for key, value in sends:
                            client.put_kv(comp.table, key, value)
                    done += 1
                    if time.perf_counter() - it0 > pol.max_step_s:
                        client.straggler_events += 1
                client.put_metadata("sim_done", True)
                return ProducerOutput(steps=done)
            return fn

        single = entry.tier == "capture_scan"
        step_fn = (lambda c, t: comp.step_fn(c, 0, t)) if single \
            else comp.step_fn

        def fn(client: Client, stop):
            warm(client)
            carry, done, chunk = comp.carry, 0, entry.chunk
            for base in range(0, comp.steps, chunk):
                if stop.is_set():
                    break
                client.fault_point(entry.name, base // chunk)
                it0 = time.perf_counter()
                k = min(chunk, comp.steps - base)
                # the ring puts ride the solver steps (the fused tier):
                # the chunk is charged to equation_solution
                with client.timers.time("equation_solution") as box:
                    carry = client.capture_scan(
                        comp.table, step_fn, carry, k, comp.emit_every,
                        t0=base, n_ranks=None if single else comp.ranks)
                    box[0] = client.server.checkout(comp.table).count
                done += k
                if time.perf_counter() - it0 > pol.max_step_s:
                    client.straggler_events += 1
            client.put_metadata("sim_done", True)
            return ProducerOutput(steps=done)
        return fn

    def _trainer_fn(self, comp: TrainerConsumer, entry: P.ComponentPlan,
                    verbose: bool):
        pol = self.straggler or StragglerPolicy()
        cfg = comp.cfg

        def fn(client: Client, stop):
            user_cb = comp.on_epoch
            if user_cb is None and verbose:
                user_cb = lambda r: print(          # noqa: E731
                    f"  [{entry.name}] epoch {r.epoch:3d} "
                    f"train {r.train_loss:.4f} val {r.val_loss:.4f} "
                    f"relF {r.val_rel_error:.3f}")
            last = [time.perf_counter()]

            def on_epoch(r):
                # the trainer's straggler deadline unit is one epoch
                now = time.perf_counter()
                if now - last[0] > pol.max_step_s:
                    client.straggler_events += 1
                last[0] = now
                if user_cb is not None:
                    user_cb(r)

            on_ckpt = None
            if comp.publish_every is not None:
                pub_levels = ae.coords_pyramid(
                    cfg.ae, torch.as_tensor(comp.coords).to(self.device))

                def on_ckpt(epoch, st):
                    if (epoch + 1) % comp.publish_every == 0:
                        client.set_model(comp.model_key, _encoder(
                            cfg.ae, pub_levels), st.params)
            state, history, levels, stats = tr.insitu_train(
                client, comp.coords, cfg, stop_event=stop,
                on_epoch=on_epoch, tier=entry.tier, component=entry.name,
                on_checkpoint=on_ckpt, draws=comp.draws)
            if comp.model_key is not None:
                client.set_model(comp.model_key, _encoder(cfg.ae, levels),
                                 state.params)
                client.put_metadata("trained", True)
            return TrainerOutput(steps=len(history), state=state,
                                 history=history, levels=levels,
                                 norm_stats=stats)
        return fn

    def _inference_fn(self, comp: InferenceConsumer, entry: P.ComponentPlan,
                      max_wall_s: float):
        def fn(client: Client, stop):
            if comp.wait_meta is not None:
                # wait in slices so a stopping session interrupts us
                budget = comp.wait_timeout_s if comp.wait_timeout_s \
                    is not None else max_wall_s
                deadline = time.perf_counter() + budget
                while client.get_metadata(comp.wait_meta,
                                          timeout=0.5) is None:
                    if stop.is_set():
                        return InferenceOutput(steps=0, last=None)
                    if time.perf_counter() >= deadline:
                        raise TimeoutError(
                            f"inference {comp.name!r}: metadata "
                            f"{comp.wait_meta!r} never appeared "
                            f"within {budget:.0f}s")
            outputs: list = []
            tin, tout = f"{comp.name}_in", f"{comp.name}_out"
            if comp.warmup:
                # one untimed eval: first-call set-up lands off the clock
                block_until_ready(client.server.run_model(
                    comp.model_key, comp.feed(client, 0)))
            for step in range(comp.steps):
                if stop.is_set():
                    break
                x = comp.feed(client, step)
                if entry.tier == "fused_registry":
                    outputs.append(client.infer(comp.model_key, x))
                    continue
                if not outputs:
                    y0 = client.server.run_model(comp.model_key, x)
                    client.server.create_table(S.TableSpec(
                        tin, shape=tuple(x.shape), capacity=2,
                        engine="hash"))
                    client.server.create_table(S.TableSpec(
                        tout, shape=tuple(y0.shape), capacity=2,
                        engine="hash"))
                client.put_tensor("x", x, table=tin)
                client.run_model(comp.model_key, inputs=["x"],
                                 outputs=["y"], table=tin, out_table=tout)
                outputs.append(client.get_tensor("y", table=tout)[0])
            last = outputs[-1] if outputs else None
            block_until_ready(last)
            return InferenceOutput(steps=len(outputs), last=last,
                                   outputs=outputs)
        return fn

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


def _encoder(cfg: ae.AEConfig, levels) -> Callable:
    """The registry function of a trained encoder: a batch ``[n, N, C]``
    → latents ``[n, latent]``."""
    def fn(params, f):
        return ae.encode(params, cfg, levels, f)
    return fn


_COMPONENT_KINDS_BY_TYPE = {Producer: "producer", TrainerConsumer: "trainer",
                            InferenceConsumer: "inference",
                            ServingClients: "clients",
                            ServingConsumer: "serving"}
_COMPONENT_KINDS = tuple(_COMPONENT_KINDS_BY_TYPE)
