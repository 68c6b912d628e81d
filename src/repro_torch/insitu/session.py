"""InSituSession: one declarative call for a coupling scenario.

Port of ``src/repro/insitu/session.py`` — the local, co-located and
clustered deployments.  Declare *what* runs,

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
``capture_scan`` vs ``capture_scan_multi`` vs ``capture_scan_sharded``
producers, per-verb vs fused
vs mesh (``sharded_fused``, ``slab_sharded``, ``slab_sharded_clustered``)
trainers, fused-registry vs three-step inference, continuous-batching vs
three-step serving.  It predicts the store dispatches and staged
transfers that ``result.server.stats()`` must show.  A table that a
slab-sharded trainer reads is created split over that trainer's mesh
(``parallel.sharding.slab_sharding``); every other table is placed by
the deployment (``Colocated``: its elements cut over the producer's mesh;
``Clustered``: on its db mesh, where a slab-sharded trainer's table stays
too, the trainer reaching it through the staged gather) or, without one,
whole on the session's device.  Under ``Clustered`` the plan's fused
producer chunk comes from the deployment's ``cost_model``
(``plan.autotune_chunk``) unless the producer names one, the overlap
pipeline adds one ``drain`` op per fused producer, and
``SessionResult.staged_delta`` attributes the hops to components.

Multi-consumer training: a ``TrainerConsumer(count=N)`` expands, when the
session is built, into N replicas named ``<name>0 .. <name>N-1``, replica
``i`` with ``cfg.seed + i``, its own draws (``draws[i]``, or drawn from
its seed) and its own disjoint mesh (``parallel.sharding.disjoint_data_meshes`` over
the session's device pool; under ``Clustered``, over the client mesh
only).  The pool is
``devices=`` (a list, repeats allowed: ``["cuda:0"] * 4`` is four ranks
of one card), else every visible card when the session's device is a
card, else the session's device alone.  A slice of fewer than 2 ranks
trains in the single-device ``fused`` tier, as in the reference.  The plan
has one entry per replica, the first taking the norm-stats bootstrap.

``faults=`` arms a ``FaultPlan``: the producer survives crashes at
declared steps or chunks (resuming from the table watermark), the
trainer resumes from a ``MemoryCheckpoint`` parked after every epoch,
the serving loop from its results watermark (``ServeLoop.recover``), and
the store replays its write-ahead log after a declared restart.  The plan
walks the same schedule through ``core.faults.simulate_overhead``, so its
predicted retries, replay ops and restarts equal the run's counters.
``plan(hlo=True)`` measures each component's collectives on throwaway
tables placed like the live ones: the ``parallel.collectives`` calls one
epoch of each trainer tier makes, one chunk of each producer and one drain
of each serving consumer.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable, Sequence

import torch

from ..core import store as S
from ..core.client import Client
from ..core.deployment import Clustered, check_deployment
from ..core.faults import FaultPlan, InjectedCrash, simulate_overhead
from ..core.orchestrator import InSituDriver, RunResult, StragglerPolicy
from ..core.server import StoreServer
from ..core.telemetry import block_until_ready
from ..device import resolve_device
from ..ml import autoencoder as ae
from ..ml import trainer as tr
from ..parallel import collectives as C
from ..parallel.sharding import (ElemSharding, GridSharding, SlabSharding,
                                 data_mesh, disjoint_data_meshes,
                                 slab_sharding)
from ..serve.engine import ServeLoop, request_key, submitted_meta
from ..train import optimizer as opt
from ..train.checkpoint import MemoryCheckpoint
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
    def timers(self):
        """Merged component timers (the paper-table reports read them
        here)."""
        return self.run.timers

    @property
    def outputs(self) -> dict[str, Any]:
        return self.run.outputs

    def output(self, name: str):
        return self.run.components[name].output

    def op_delta(self, name: str) -> int | None:
        """Store dispatches attributed to one component (sequential runs)."""
        return self.run.components[name].op_delta

    def staged_delta(self, name: str) -> int | None:
        """Staged transfers attributed to one component (sequential runs;
        0 off a clustered deployment)."""
        return self.run.components[name].staged_delta

    @property
    def straggler_events(self) -> int:
        """Component iterations past the ``StragglerPolicy.max_step_s``
        deadline, summed over components."""
        return sum(c.straggler_events for c in self.run.components.values())

    @property
    def retries(self) -> int:
        """Transient-fault verb retries absorbed across components."""
        return sum(c.retries for c in self.run.components.values())

    @property
    def restarts(self) -> int:
        """Crash restarts survived across components."""
        return sum(c.restarts for c in self.run.components.values())

    def client(self, rank: int = 99) -> Client:
        """A fresh client of the session's live server."""
        return self.driver.client(rank=rank)


class InSituSession:
    """Declarative in-situ coupling session (see module docstring)."""

    def __init__(self, components: Sequence[Any],
                 tables: Sequence[S.TableSpec] = (),
                 deployment=None,
                 straggler: StragglerPolicy | None = None,
                 faults: FaultPlan | None = None, device=None,
                 devices: Sequence | None = None):
        if not components:
            raise ValueError("a session needs at least one component")
        self.deployment = check_deployment(deployment)
        self.tables = tuple(tables)
        self.straggler = straggler
        # the armed fault plan: the session's own, else the deployment's
        self.faults = faults if faults is not None \
            else getattr(deployment, "faults", None)
        self.device = resolve_device(device)
        self.devices = tuple(devices) if devices is not None else None
        self.components = self._normalize(
            [r for comp in components for r in self._replicas(comp)])
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

    def _pool(self) -> list:
        """The device pool replicas are carved from: ``devices=``, else
        every visible card (a session on a card), else the session's
        device."""
        if self.devices is not None:
            return list(self.devices)
        if self.device.type == "cuda":
            return list(data_mesh().devices)
        return [self.device]

    def _replicas(self, comp) -> list:
        """A ``TrainerConsumer(count=N)`` as its N replicas (each
        ``count=1``, named ``<name><i>``, seed ``+ i``, its own mesh and
        draws); any other component as itself."""
        if not isinstance(comp, TrainerConsumer) or comp.count == 1:
            return [comp]
        if comp.cfg.slab_sharded \
                and not isinstance(self.deployment, Clustered):
            raise ValueError(
                f"trainer {comp.name!r}: slab_sharded replicas would each "
                f"need the table split over their own mesh (use a "
                f"Clustered deployment, whose db mesh holds the table)")
        # the replicas never claim the store's dedicated devices: under
        # Clustered they are carved out of the client mesh only
        pool = list(self.deployment.client_mesh.devices) \
            if isinstance(self.deployment, Clustered) else self._pool()
        meshes = disjoint_data_meshes(comp.count, axis=comp.cfg.mesh_axis,
                                      devices=pool)
        draws = comp.draws
        if draws is None or isinstance(draws, tr.TrainDraws):
            if draws is not None:
                raise ValueError(f"trainer {comp.name!r}: one TrainDraws "
                                 f"for {comp.count} replicas; pass one a "
                                 f"replica")
            draws = [None] * comp.count
        draws = list(draws)
        if len(draws) != comp.count:
            raise ValueError(f"trainer {comp.name!r}: {len(draws)} draws "
                             f"for {comp.count} replicas")
        return [_dc_replace(comp, cfg=_dc_replace(comp.cfg, mesh=mesh,
                                                  seed=comp.cfg.seed + i),
                            count=1, draws=draws[i],
                            name=f"{comp.name}{i}")
                for i, mesh in enumerate(meshes)]

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
        """Resolve the frozen execution :class:`~.plan.Plan`.

        With an armed ``FaultPlan`` the declared faults are walked through
        ``simulate_overhead`` against the static schedule, and each
        entry's replay ops, retries and restarts are merged in.
        ``hlo=True`` also measures each trainer entry's collectives (one
        epoch of its tier; see :meth:`_trainer_collectives`)."""
        entries: list[P.ComponentPlan] = []
        #: the static component walk for the fault simulator, one dict per
        #: entry in the sequential order the exactness claim covers
        schedule: list[dict] = []
        first_trainer = True
        dep = self.deployment
        crosses = dep is not None and dep.crosses_mesh
        for comp in self.components:
            if isinstance(comp, Producer):
                tier = P.producer_tier(comp)
                # the two-slot staging pipeline exists only on the fused
                # crossing path (per-verb puts stage per element)
                overlap = crosses and tier != "per_verb" \
                    and getattr(dep, "overlap", False)
                fan_in = dep.fan_in if crosses else 1
                cost_model = getattr(dep, "cost_model", None)
                chunk = comp.chunk or P.autotune_chunk(
                    comp.emit_every, cost_model, steps=comp.steps,
                    fan_in=fan_in)
                if tier == "per_verb":
                    schedule.append({
                        "kind": "producer", "name": comp.name, "tier": tier,
                        "table": comp.table, "steps": comp.steps,
                        "emit_every": comp.emit_every, "ranks": comp.ranks})
                else:
                    schedule.append({
                        "kind": "producer", "name": comp.name, "tier": tier,
                        "table": comp.table, "overlap": overlap,
                        "n_chunks": -(-comp.steps // chunk)})
                # the sharded chunk holds the solver's halo ppermutes:
                # claim exactly that where the placement makes it
                # structural (co-located); every other put path makes no
                # collective (a clustered hop is a staged copy)
                slots_cut, _ = self._table_cuts(comp.table)
                pred = P.sharded_producer_prediction(
                    comp.elem_sharding, dep is not None and not crosses,
                    slots_cut) \
                    if tier == "capture_scan_sharded" else P.COLLECTIVE_FREE
                predicted_sps = None
                if cost_model is not None and tier != "per_verb":
                    try:
                        predicted_sps = cost_model.predict_steps_per_s(
                            fan_in)
                    except ValueError:
                        pass    # fan_in outside the fitted sweep: no claim
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="producer", tier=tier,
                    table=comp.table, ranks=comp.ranks, steps=comp.steps,
                    chunk=0 if tier == "per_verb" else chunk,
                    bucketed=comp.bucket and tier != "per_verb",
                    fan_in=fan_in, predicted_steps_per_s=predicted_sps,
                    dispatches=P.producer_dispatches(
                        tier, comp.steps, comp.emit_every, comp.ranks,
                        chunk, overlap=overlap),
                    staged=P.producer_staged(
                        tier, comp.steps, comp.emit_every, comp.ranks,
                        chunk, crosses),
                    predicted_collectives=pred,
                    collectives=self._producer_collectives(comp, tier, chunk)
                    if hlo else None))
            elif isinstance(comp, TrainerConsumer):
                cfg = self._trainer_cfg(comp)
                tier = P.trainer_tier(cfg, comp.tier)
                mesh = cfg.mesh
                slots_cut, elems_cut = self._table_cuts(cfg.table)
                schedule.append({
                    "kind": "trainer", "name": comp.name, "tier": tier,
                    "table": cfg.table, "epochs": cfg.epochs,
                    "bootstrap": first_trainer})
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="trainer", tier=tier,
                    table=cfg.table, steps=cfg.epochs,
                    mesh_devices=1 if mesh is None else mesh.size,
                    dispatches=P.trainer_dispatches(
                        tier, cfg.epochs, bootstrap=first_trainer),
                    staged=P.trainer_staged(tier, cfg.epochs, crosses),
                    predicted_collectives=P.trainer_collective_prediction(
                        tier, slots_cut or elems_cut, elems_cut),
                    collectives=self._trainer_collectives(comp, cfg, tier)
                    if hlo else None))
                first_trainer = False
            elif isinstance(comp, InferenceConsumer):
                tier = P.inference_tier(comp)
                schedule.append({"kind": "inference", "name": comp.name,
                                 "tier": tier, "steps": comp.steps})
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="inference", tier=tier,
                    steps=comp.steps,
                    dispatches=P.inference_dispatches(tier, comp.steps),
                    staged=P.inference_staged(tier, comp.steps, crosses)))
            elif isinstance(comp, ServingClients):
                total = comp.clients * comp.requests
                schedule.append({
                    "kind": "clients", "name": comp.name,
                    "tier": "per_verb", "table": comp.table,
                    "results": self._serving_results(comp.table)
                    if comp.collect else None,
                    "requests": total, "submit": comp.submit,
                    "collect": comp.collect})
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="clients", tier="per_verb",
                    table=comp.table, steps=total,
                    dispatches=P.clients_dispatches(total, comp.submit,
                                                    comp.collect),
                    staged=P.clients_staged(total, comp.submit, crosses),
                    predicted_collectives=P.COLLECTIVE_FREE if comp.submit
                    else None))
            else:
                total = comp.clients * comp.requests
                tier = P.serving_tier(comp)
                slots_cut, elems_cut = self._table_cuts(comp.table)
                schedule.append({
                    "kind": "serving", "name": comp.name, "tier": tier,
                    "table": comp.table, "results": comp.results,
                    "requests": total,
                    "n_batches": -(-total // comp.max_batch)})
                entries.append(P.ComponentPlan(
                    name=comp.name, kind="serving", tier=tier,
                    table=comp.table, steps=total,
                    dispatches=P.serving_dispatches(tier, total,
                                                    comp.max_batch),
                    staged=P.serving_staged(tier, total, crosses),
                    swaps=P.serving_swaps(tier),
                    predicted_collectives=P.serving_collective_prediction(
                        elems_cut, slots_cut),
                    collectives=self._serving_collectives(comp, tier)
                    if hlo else None))
        fault_totals: tuple[tuple[str, int], ...] = ()
        if self.faults is not None:
            # a FRESH injector driven through the runtime's call sequence:
            # the predicted replays, retries and restarts are exact
            per, totals = simulate_overhead(self.faults, schedule, crosses)
            merged = []
            for e in entries:
                o = per.get(e.name)
                if o is None or o.empty:
                    merged.append(e)
                    continue
                merged.append(_dc_replace(
                    e, dispatches=e.dispatches + (
                        (("replay", o.extra_ops),) if o.extra_ops else ()),
                    staged=e.staged + (
                        (("restage", o.extra_staged),) if o.extra_staged
                        else ()),
                    retries=o.retries, restarts=o.restarts))
            entries = merged
            fault_totals = tuple(sorted(totals.items()))
        return P.Plan(deployment=dep.describe() if dep is not None
                      else "local", components=tuple(entries),
                      fan_in=dep.fan_in if dep is not None else 1,
                      faults=fault_totals)

    # -- collective accounting (plan(hlo=True)) -----------------------------

    def _trainer_collectives(self, comp: TrainerConsumer, cfg, tier: str
                             ) -> tuple[tuple[str, int], ...]:
        """The collectives one epoch of ``tier`` makes, by the reference's
        op names: ``parallel.collectives.COUNTS``' change over one epoch
        from a fresh state on a throwaway table placed like the live one
        (split over the slab-sharded trainer's mesh, or on the clustered
        db mesh, where the live one is), with the off-clock warm-up's
        fixed draws.  The port's counterpart of compiling the epoch and
        counting HLO ops.  The clustered tier counts both of its halves:
        the db-mesh staged gather (its shard count by the deployment's
        rule, ``Clustered.gather_shards``) and the DDP body on the
        gathered batch; the hop between them is a copy."""
        if tier == "per_verb":
            return tuple((op, 0) for op in P.COLLECTIVE_OPS)
        spec = self._spec(cfg.table)
        dev = self.device
        levels = ae.coords_pyramid(cfg.ae,
                                   torch.as_tensor(comp.coords).to(dev))
        tx = opt.adam(cfg.scaled_lr)
        state = tr.init_state(cfg, torch.Generator().manual_seed(cfg.seed),
                              tx, dev)
        epoch_fn = tr.EPOCH_BUILDERS[tier](cfg, levels, tx, spec)
        table = S.init_table(spec, self._table_placement(spec), device=dev)
        mu = torch.zeros(spec.shape[0], device=dev)
        draws = tr._warm_draws(cfg, dev)
        with C.counted() as calls:
            if tier == "slab_sharded_clustered":
                shards = self.deployment.gather_shards(spec) \
                    if isinstance(self.deployment, Clustered) else 1
                gather = S.make_clustered_gather(
                    spec, cfg.gather, db_mesh=cfg.db_mesh, axis=cfg.db_axis,
                    shards=shards)
                vals, ok = gather(table, draws.sample)
                out = epoch_fn.train_fn(vals, ok, state, draws, mu, mu + 1.0)
            else:
                out = epoch_fn(table, state, draws, mu, mu + 1.0)
            block_until_ready(out[1])
        return _by_op(calls)

    def _producer_collectives(self, comp: Producer, tier: str, chunk: int
                              ) -> tuple[tuple[str, int], ...]:
        """The collectives of one put (``per_verb``: a zero element) or one
        chunk of ``min(chunk, steps)`` steps of the producer's fused tier
        from its initial carry, on a throwaway table placed like the live
        one (the port's counterpart of compiling that chunk and counting
        its HLO collectives).  On a clustered deployment the fused chunk is
        its client-side collect, the staged copy and the db-side masked
        insert, all counted: the claim covers the whole put path."""
        spec = self._spec(comp.table)
        state = S.init_table(spec, self._table_placement(spec),
                             device=self.device)
        n = min(chunk, comp.steps)
        dep = self.deployment
        staged = dep is not None and dep.crosses_mesh
        with C.counted() as calls:
            if tier == "per_verb":
                value = torch.zeros(spec.shape, dtype=spec.dtype,
                                    device=self.device)
                if staged:
                    value = dep.stage(value, spec)
                state = S.put(spec, state, 1, value)
            elif staged:
                if tier == "capture_scan_multi":
                    _, keys, vals, mask = S.capture_scan_collect_multi(
                        spec, comp.step_fn, comp.carry, n, comp.ranks,
                        comp.emit_every)
                else:
                    es = comp.elem_sharding \
                        if tier == "capture_scan_sharded" else None
                    _, keys, vals, mask = S.capture_scan_collect(
                        spec, lambda c, t: comp.step_fn(c, 0, t),
                        comp.carry, n, comp.emit_every, elem_sharding=es)
                staged_chunk = dep.stage_chunk(keys, vals, mask, spec)
                state = S.put_masked(spec, state, *staged_chunk)
            elif tier == "capture_scan_multi":
                state, _ = S.capture_scan_multi(
                    spec, state, comp.step_fn, comp.carry, n, comp.ranks,
                    comp.emit_every)
            else:
                es = comp.elem_sharding if tier == "capture_scan_sharded" \
                    else None
                state, _ = S.capture_scan(
                    spec, state, lambda c, t: comp.step_fn(c, 0, t),
                    comp.carry, n, comp.emit_every, elem_sharding=es)
            block_until_ready(state.count)
        return _by_op(calls)

    def _serving_collectives(self, comp: ServingConsumer, tier: str
                             ) -> tuple[tuple[str, int], ...]:
        """The collectives of one serving drain on throwaway request and
        results tables placed like the live ones: ``max_batch`` requests
        through the fused gather → model → scatter, or the three-step
        tier's one get and one put.  The registered model is unknown at
        plan time, so a stub that reads every request element stands in:
        the claim covers the store plumbing."""
        req_spec, res_spec = self._spec(comp.table), self._spec(comp.results)
        dev = self.device
        req = S.init_table(req_spec, self._table_placement(req_spec),
                           device=dev)
        res = S.init_table(res_spec, self._table_placement(res_spec),
                           device=dev)
        n = comp.max_batch

        def stub_apply(params, xs):
            means = xs.reshape(xs.shape[0], -1).mean(dim=1)
            return means.reshape(-1, *([1] * len(res_spec.shape))).expand(
                xs.shape[0], *res_spec.shape).to(res_spec.dtype)

        with C.counted() as calls:
            if tier == "three_step":
                x, _ = S.get(req_spec, req, 1)
                res = S.put(res_spec, res, 1, stub_apply(None, x[None])[0])
            else:
                res, _, _ = S.serve_batch(
                    req_spec, res_spec, stub_apply, req, res, None,
                    torch.zeros((n,), dtype=S.KEY_DTYPE, device=dev),
                    torch.zeros((n,), dtype=torch.bool, device=dev))
            block_until_ready(res.count)
        return _by_op(calls)

    def _table_placement(self, spec: S.TableSpec):
        """Where ``spec``'s slab lives: split over a slab-sharded trainer's
        mesh when one reads it (except under ``Clustered``: the slab stays
        on the db mesh and the trainer reaches it through the staged
        gather), else by the deployment's rule (``None``: whole on the
        session's device)."""
        explicit = self._table_shardings().get(spec.name)
        if explicit is not None:
            return explicit
        if self.deployment is not None:
            return self.deployment.slab_sharding(spec)
        return None

    def _trainer_cfg(self, comp: TrainerConsumer):
        """The trainer's config as it runs: under ``Clustered`` a
        slab-sharded trainer's table lives on the DEDICATED db mesh, so
        that mesh and its slot axis are wired in (``db_mesh``,
        ``db_axis``) and the tier resolves to ``slab_sharded_clustered``."""
        cfg = comp.cfg
        if isinstance(self.deployment, Clustered) and cfg.slab_sharded \
                and cfg.db_mesh is None:
            cfg = _dc_replace(cfg, db_mesh=self.deployment.db_mesh,
                              db_axis=self.deployment.slab_axis)
        return cfg

    def _table_cuts(self, table: str) -> tuple[bool, bool]:
        """``(slots_cut, elems_cut)``: is ``table``'s slot axis split over
        more than one rank, and are its elements?"""
        placement = self._table_placement(self._spec(table))
        if isinstance(placement, ElemSharding):
            return False, not placement.is_fully_replicated
        if isinstance(placement, GridSharding):
            return (placement.slab_shards > 1,
                    not placement.elem.is_fully_replicated)
        if isinstance(placement, SlabSharding):
            return placement.mesh.size > 1, False
        return False, False

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

    # -- table placement (the slab-sharded data plane) ----------------------

    def _table_shardings(self) -> dict[str, Any]:
        """Each table a slab-sharded trainer reads → its placement over
        that trainer's mesh (the other tables stay whole); none under
        ``Clustered``, whose own rule places every table."""
        out = {}
        if isinstance(self.deployment, Clustered):
            return out
        for comp in self.components:
            if isinstance(comp, TrainerConsumer) and comp.cfg.slab_sharded:
                out[comp.cfg.table] = slab_sharding(
                    self._spec(comp.cfg.table), comp.cfg.mesh)
        return out

    # -- runtime ------------------------------------------------------------

    def run(self, plan: P.Plan | None = None, max_wall_s: float = 300.0,
            sequential: bool = False, verbose: bool = False,
            preload: Callable[[StoreServer], None] | None = None
            ) -> SessionResult:
        """Execute the session: build the store on the session's device,
        run one thread per component per ``plan``.  ``sequential=True``
        runs components in declaration order (exact per-component dispatch
        attribution); ``verbose`` prints one line per trainer epoch;
        ``preload`` is called with the fresh server before any component
        starts (register a served model there)."""
        plan = plan or self.plan()
        driver = InSituDriver(deployment=self.deployment,
                              tables=self.tables, straggler=self.straggler,
                              table_shardings=self._table_shardings(),
                              faults=self.faults, device=self.device)
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
                    _survive_crash(client, entry.name, t, comp.table)
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

        single = entry.tier in ("capture_scan", "capture_scan_sharded")
        es = comp.elem_sharding if entry.tier == "capture_scan_sharded" \
            else None
        step_fn = (lambda c, t: comp.step_fn(c, 0, t)) if single \
            else comp.step_fn

        def fn(client: Client, stop):
            warm(client)
            carry, done, chunk = comp.carry, 0, entry.chunk
            for base in range(0, comp.steps, chunk):
                if stop.is_set():
                    break
                # crash point per chunk: the restarted producer resumes
                # the t0 clock at the same chunk base
                _survive_crash(client, entry.name, base // chunk,
                               comp.table)
                it0 = time.perf_counter()
                k = min(chunk, comp.steps - base)
                # the ring puts ride the solver steps (the fused tier):
                # the chunk is charged to equation_solution
                with client.timers.time("equation_solution") as box:
                    carry = client.capture_scan(
                        comp.table, step_fn, carry, k, comp.emit_every,
                        t0=base, n_ranks=None if single else comp.ranks,
                        elem_sharding=es)
                    box[0] = client.server.checkout(comp.table).count
                done += k
                if time.perf_counter() - it0 > pol.max_step_s:
                    client.straggler_events += 1
            # capture end: flush the overlap pipeline's in-flight chunk
            # (the plan's ONE "drain" op; nothing off that pipeline)
            client.drain_captures(comp.table)
            client.put_metadata("sim_done", True)
            return ProducerOutput(steps=done)
        return fn

    def _trainer_fn(self, comp: TrainerConsumer, entry: P.ComponentPlan,
                    verbose: bool):
        pol = self.straggler or StragglerPolicy()
        cfg = self._trainer_cfg(comp)

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
            # an armed FaultPlan parks the trainer's state, draws and
            # history in the store after every epoch; a declared crash
            # propagates out of insitu_train and the loop re-enters it
            memckpt = MemoryCheckpoint(client.server, key=entry.name) \
                if client.server.wal_enabled else None
            while True:
                last[0] = time.perf_counter()
                try:
                    state, history, levels, stats = tr.insitu_train(
                        client, comp.coords, cfg, stop_event=stop,
                        on_epoch=on_epoch, tier=entry.tier,
                        memckpt=memckpt, component=entry.name,
                        on_checkpoint=on_ckpt, draws=comp.draws)
                    break
                except InjectedCrash:
                    client.restarts += 1
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
                    _survive_crash(client, entry.name, i, comp.table)
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


def _by_op(calls: dict) -> tuple[tuple[str, int], ...]:
    """``collectives.counted()``'s calls under the reference's op names."""
    return tuple((op, calls.get(op.replace("-", "_"), 0))
                 for op in P.COLLECTIVE_OPS)


def _survive_crash(client: Client, name: str, idx: int, table: str) -> None:
    """A producer's (or submitting client's) crash point: a declared crash
    kills the attempt before anything is dispatched, the restarted
    component reads the table watermark (its recovery cursor, a host
    counter: no store op) and retries the same index, which the injector
    now lets pass (each declared crash fires once)."""
    while True:
        try:
            client.fault_point(name, idx)
            return
        except InjectedCrash:
            client.restarts += 1
            client.watermark(table)


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
