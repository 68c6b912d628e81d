"""Plan: tier selection as *data*.

Port of ``src/repro/insitu/plan.py`` — the local and co-located
deployments: the producer, trainer, inference and serving tiers, the
per-component dispatch and model-swap predictions, the fault overhead of
a declared ``FaultPlan`` (replay ops in ``dispatches``, ``retries``,
``restarts``, and the ``Plan.faults`` totals ``stats()`` must show), the
collective structure of the trainers, the producers and the serving
drains (``predicted_collectives``, held against what ``plan(hlo=True)``
measures), and the frozen :class:`Plan` whose predictions the tests hold
against ``StoreServer.stats()``.

=============  =====================================================
producer       ``per_verb`` | ``capture_scan`` | ``capture_scan_multi``
               | ``capture_scan_sharded``
trainer        ``per_verb`` | ``fused`` | ``sharded_fused`` |
               ``slab_sharded``
inference      ``fused_registry`` | ``three_step``
serving        ``continuous_batch`` | ``three_step``
=============  =====================================================

The reference measures collectives in compiled HLO.  The port has no
HLO: a mesh's collectives are explicit calls
(``parallel.collectives``), so ``plan(hlo=True)`` counts the calls one
epoch of a tier makes, under the reference's five op names
(:data:`COLLECTIVE_OPS`).

One prediction deliberately differs from the reference's: a serving
drain on a request table whose elements are cut over a mesh (a
co-located deployment) all-gathers the requests it reads, because the
registered model takes whole elements (:func:`serving_collective_prediction`);
the reference claims every drain collective-free.

The ``slab_sharded_clustered`` tier, the staged-transfer predictions and
the contention model are ``ROADMAP.md`` A5.2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core import store as S

__all__ = [
    "PRODUCER_TIERS", "TRAINER_TIERS", "INFERENCE_TIERS", "SERVING_TIERS",
    "producer_tier", "trainer_tier", "inference_tier", "serving_tier",
    "default_chunk", "ComponentPlan", "Plan", "producer_dispatches",
    "trainer_dispatches", "inference_dispatches", "clients_dispatches",
    "serving_dispatches", "serving_swaps", "COLLECTIVE_OPS",
    "COLLECTIVE_FREE", "TRAINER_COLLECTIVE_PREDICTIONS",
    "trainer_collective_prediction", "sharded_producer_prediction",
    "serving_collective_prediction",
]

#: the collective op names of the reference's HLO accounting
#: (``src/repro/analysis/hlo.py``); ``parallel.collectives.COUNTS`` keys
#: map onto the first two
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

PRODUCER_TIERS = ("per_verb", "capture_scan", "capture_scan_multi",
                  "capture_scan_sharded")
TRAINER_TIERS = ("per_verb", "fused", "sharded_fused", "slab_sharded")
INFERENCE_TIERS = ("fused_registry", "three_step")
SERVING_TIERS = ("continuous_batch", "three_step")


def producer_tier(comp) -> str:
    """Resolve a :class:`~.components.Producer`'s tier: a forced tier is
    validated; otherwise non-traceable steps pin ``per_verb``, a set
    ``elem_sharding`` takes ``capture_scan_sharded`` (single-rank: the one
    rank IS the whole mesh), one rank ``capture_scan``, several
    ``capture_scan_multi``."""
    sharded = getattr(comp, "elem_sharding", None) is not None
    if sharded and not comp.traceable:
        raise ValueError("elem_sharding needs a traceable step_fn: the "
                         "sharded put only exists inside the fused capture")
    if sharded and comp.ranks > 1:
        raise ValueError(
            "elem_sharding is single-rank (ranks=1): a domain-decomposed "
            "producer is ONE rank spread over the mesh — its parallelism "
            "is the sharding, not a vmapped rank axis")
    if comp.tier is not None:
        if comp.tier not in PRODUCER_TIERS:
            raise ValueError(f"unknown producer tier {comp.tier!r} "
                             f"(have {PRODUCER_TIERS})")
        if comp.tier != "per_verb" and not comp.traceable:
            raise ValueError(f"tier {comp.tier!r} needs a traceable step_fn")
        if comp.tier == "capture_scan" and comp.ranks > 1:
            raise ValueError("capture_scan is single-rank; use "
                             "capture_scan_multi or ranks=1")
        if comp.tier == "capture_scan_multi" and comp.ranks == 1:
            raise ValueError("capture_scan_multi needs ranks > 1")
        if comp.tier == "capture_scan_sharded" and not sharded:
            raise ValueError("capture_scan_sharded needs elem_sharding "
                             "(the producer's own element layout)")
        if sharded and comp.tier not in ("per_verb", "capture_scan_sharded"):
            raise ValueError(
                f"tier {comp.tier!r} would drop the declared elem_sharding; "
                f"use capture_scan_sharded (or per_verb to measure the "
                f"unfused baseline)")
        return comp.tier
    if not comp.traceable:
        return "per_verb"
    if sharded:
        return "capture_scan_sharded"
    return "capture_scan" if comp.ranks == 1 else "capture_scan_multi"


def trainer_tier(cfg, override: str | None = None) -> str:
    """Resolve a trainer tier from a ``TrainerConfig`` (the rule
    ``ml.trainer.insitu_train`` consults when no plan names one): a forced
    tier is checked against the config, with the reference's errors."""
    mesh_tiers = ("sharded_fused", "slab_sharded")
    if override is not None:
        if override == "slab_sharded_clustered":
            raise NotImplementedError(
                "tier slab_sharded_clustered (the Clustered deployment): "
                "ROADMAP.md A5")
        if override not in TRAINER_TIERS:
            raise ValueError(f"unknown trainer tier {override!r} "
                             f"(have {TRAINER_TIERS})")
        if override in mesh_tiers and cfg.mesh is None:
            raise ValueError(f"{override} needs cfg.mesh")
        if override not in mesh_tiers and cfg.mesh is not None:
            raise ValueError(
                f"cfg.mesh is set; tier {override!r} would ignore it")
        if override == "slab_sharded" and not cfg.slab_sharded:
            raise ValueError(f"{override} needs cfg.slab_sharded=True")
        if override != "slab_sharded" and cfg.slab_sharded:
            raise ValueError(
                f"cfg.slab_sharded is set; tier {override!r} would pass "
                f"the table replicated")
        if override != "per_verb" and not cfg.fused:
            raise ValueError(f"tier {override!r} needs cfg.fused=True")
        return override
    if not cfg.fused:
        return "per_verb"
    if cfg.mesh is None:
        return "fused"
    return "slab_sharded" if cfg.slab_sharded else "sharded_fused"


def inference_tier(comp) -> str:
    if comp.tier is not None:
        if comp.tier not in INFERENCE_TIERS:
            raise ValueError(f"unknown inference tier {comp.tier!r} "
                             f"(have {INFERENCE_TIERS})")
        return comp.tier
    return "fused_registry"


def default_chunk(emit_every: int) -> int:
    """The fused producer's chunk length (steps per capture): one bucket
    floor's worth of emissions (``store.MIN_BUCKET``)."""
    return max(S.MIN_BUCKET * emit_every, S.MIN_BUCKET)


def serving_tier(comp) -> str:
    """Resolve a :class:`~.components.ServingConsumer`'s tier: the fused
    continuous-batching drain by default; ``three_step`` forces the
    paper's one-request-at-a-time get → run_model → put baseline."""
    if comp.tier is not None:
        if comp.tier not in SERVING_TIERS:
            raise ValueError(f"unknown serving tier {comp.tier!r} "
                             f"(have {SERVING_TIERS})")
        return comp.tier
    return "continuous_batch"


def _pred(**nonzero: bool) -> tuple[tuple[str, bool], ...]:
    """Collective-structure prediction: op name -> must-be-nonzero flag
    (keyword names use ``_`` for ``-``)."""
    return tuple((op, bool(nonzero.get(op.replace("-", "_"), False)))
                 for op in COLLECTIVE_OPS)


#: a hot path that must make no collective (the single-device epochs)
COLLECTIVE_FREE: tuple[tuple[str, bool], ...] = _pred()

#: each trainer tier's collective structure on a table that is NOT split
#: over a mesh: both mesh tiers all-reduce (the DDP gradients; the
#: slab-sharded gather's ``psum`` is an all-reduce too) and neither
#: all-gathers; :func:`trainer_collective_prediction` resolves a split
#: table
TRAINER_COLLECTIVE_PREDICTIONS: dict[str, tuple[tuple[str, bool], ...]] = {
    "per_verb": COLLECTIVE_FREE,
    "fused": COLLECTIVE_FREE,
    "sharded_fused": _pred(all_reduce=True),
    "slab_sharded": _pred(all_reduce=True),
}


def trainer_collective_prediction(tier: str, table_sharded: bool = False
                                  ) -> tuple[tuple[str, bool], ...] | None:
    """One trainer entry's collective structure.  ``table_sharded``: the
    table it reads is split over more than one rank (a slab-sharded
    trainer's placement).  Then ``sharded_fused`` all-gathers the slab on
    entry, the anti-pattern ``slab_sharded`` removes; the single-device
    ``fused`` tier gets no claim (``None``), as in the reference."""
    if table_sharded and tier == "sharded_fused":
        return _pred(all_reduce=True, all_gather=True)
    if table_sharded and tier == "fused":
        return None
    return TRAINER_COLLECTIVE_PREDICTIONS[tier]


def sharded_producer_prediction(elem_sharding, colocated: bool
                                ) -> tuple[tuple[str, bool], ...] | None:
    """The collective structure of one ``capture_scan_sharded`` chunk: the
    rank-local put adds **no cross-rank collective beyond the producer's
    own halo exchange** — ``collective_permute`` nonzero (the ppermuted
    faces), everything else, ``all_gather`` above all, zero.  Claimed only
    where it is structural: co-located over more than one rank (the slab
    carries the emission's layout).  Elsewhere ``None``: a local table
    holds whole elements, so the emission is assembled into it."""
    if not colocated or elem_sharding is None:
        return None
    if getattr(elem_sharding, "num_devices", 1) <= 1 \
            or getattr(elem_sharding, "is_fully_replicated", False):
        return None
    return _pred(collective_permute=True)


def serving_collective_prediction(req_sharded: bool
                                  ) -> tuple[tuple[str, bool], ...]:
    """The collective structure of one serving drain (either tier): the
    store plumbing makes none on a whole request table; on one whose
    elements are cut over a mesh (``req_sharded``, a co-located
    deployment) each read assembles its requests with one all-gather, the
    registered model taking whole elements, and the response write stays
    rank-local.  (The reference claims the drain collective-free on every
    deployment.)"""
    return _pred(all_gather=True) if req_sharded else COLLECTIVE_FREE


@dataclass(frozen=True)
class ComponentPlan:
    """One component's frozen execution decision."""

    name: str
    #: "producer" | "trainer" | "inference" | "clients" | "serving"
    kind: str
    tier: str
    table: str | None = None
    ranks: int = 1
    steps: int = 0               # producer steps / epochs / calls / requests
    chunk: int = 0               # fused producer: steps per capture
    bucketed: bool = False
    mesh_devices: int = 1        # mesh trainer: ranks of its mesh
    #: predicted store dispatches this component will perform, by cause.
    dispatches: tuple[tuple[str, int], ...] = ()
    #: predicted model-generation adoptions (serving hot-swap).
    swaps: int = 0
    #: the collective calls one epoch of the component's tier made
    #: (``plan(hlo=True)``; ``None`` until measured), by op name
    collectives: tuple[tuple[str, int], ...] | None = None
    #: op -> must the hot path make it?  (``None``: no claim)
    predicted_collectives: tuple[tuple[str, bool], ...] | None = None
    #: predicted transient-fault verb retries under the session's
    #: ``FaultPlan`` (``core.faults.simulate_overhead``); the replay ops a
    #: restart costs land in ``dispatches`` as ``"replay"``
    retries: int = 0
    #: predicted crash restarts (producer: resume from the watermark;
    #: trainer: from its ``MemoryCheckpoint``; serving: ``recover()``)
    restarts: int = 0

    @property
    def store_dispatches(self) -> int:
        return sum(n for _, n in self.dispatches)

    def check_collectives(self) -> None:
        """Assert the measured collectives (``plan(hlo=True)``) have the
        predicted structure; a no-op when either side is unresolved."""
        if self.collectives is None or self.predicted_collectives is None:
            return
        measured = dict(self.collectives)
        for op, nonzero in self.predicted_collectives:
            got = measured.get(op, 0)
            if bool(got) != nonzero:
                raise AssertionError(
                    f"{self.name} [{self.tier}]: predicted {op} "
                    f"{'> 0' if nonzero else '== 0'}, measured {got} "
                    f"(all: {measured})")

    def explain(self) -> dict:
        out: dict[str, Any] = {
            "tier": self.tier,
            "store_dispatches": self.store_dispatches,
            "dispatch_detail": dict(self.dispatches),
        }
        if self.kind == "producer":
            out["ranks"] = self.ranks
            out["dispatches_per_step"] = \
                self.store_dispatches / max(1, self.steps)
            if self.tier != "per_verb":
                out["chunk"] = self.chunk
                out["bucketed"] = self.bucketed
        if self.kind == "trainer":
            out["dispatches_per_epoch"] = \
                dict(self.dispatches).get("epoch", 0) / max(1, self.steps)
            out["mesh_devices"] = self.mesh_devices
        if self.kind in ("clients", "serving"):
            out["requests"] = self.steps
        if self.kind == "serving":
            d = dict(self.dispatches)
            out["drained_batches"] = d.get("serve", 0)
            out["model_swaps"] = self.swaps
            if self.tier == "continuous_batch":
                # THE serving claim: one fused dispatch per drained batch
                out["dispatches_per_batch"] = \
                    self.store_dispatches / max(1, d.get("serve", 0))
        if self.retries or self.restarts:
            out["fault_overhead"] = {"retries": self.retries,
                                     "restarts": self.restarts}
        if self.predicted_collectives is not None:
            out["predicted_collectives"] = {
                op: ("nonzero" if nz else "zero")
                for op, nz in self.predicted_collectives}
        if self.collectives is not None:
            out["collectives"] = dict(self.collectives)
        return out


@dataclass(frozen=True)
class Plan:
    """The session's full execution decision, frozen (components in
    declaration order)."""

    deployment: str
    components: tuple[ComponentPlan, ...]
    #: the declared faults' totals, ``simulate_overhead``'s prediction of
    #: ``stats()``'s counters: sorted ``(("faults_injected", n),
    #: ("recoveries", n), ("retries", n))``; ``()`` when no plan is armed
    faults: tuple[tuple[str, int], ...] = ()

    def __post_init__(self):
        names = [c.name for c in self.components]
        dups = {n for n in names if names.count(n) > 1}
        if dups:
            raise ValueError(f"component names collide: {sorted(dups)}")

    def component(self, name: str) -> ComponentPlan:
        for c in self.components:
            if c.name == name:
                return c
        raise KeyError(name)

    @property
    def store_dispatches(self) -> int:
        """Predicted total store dispatches for one session run."""
        return sum(c.store_dispatches for c in self.components)

    @property
    def model_swaps(self) -> int:
        """Predicted total model-generation adoptions (== ``stats()
        ["model_swaps"]``)."""
        return sum(c.swaps for c in self.components)

    def describe(self) -> str:
        """One line per component, for logs and reports."""
        lines = [f"deployment: {self.deployment}"]
        for c in self.components:
            bits = [f"tier={c.tier}", f"dispatches={c.store_dispatches}"]
            if c.kind == "producer":
                bits.append(f"ranks={c.ranks}")
                if c.tier != "per_verb":
                    bits.append(f"chunk={c.chunk}"
                                + ("+bucketed" if c.bucketed else ""))
            if c.kind == "trainer" and c.mesh_devices > 1:
                bits.append(f"mesh={c.mesh_devices}dev")
            if c.kind == "serving":
                bits.append(f"requests={c.steps} swaps={c.swaps}")
            if c.retries or c.restarts:
                bits.append(f"retries={c.retries} restarts={c.restarts}")
            lines.append(f"  {c.name} [{c.kind}]: " + " ".join(bits))
        if self.faults:
            f = dict(self.faults)
            lines.append(f"  faults: injected={f.get('faults_injected', 0)}"
                         f" retries={f.get('retries', 0)}"
                         f" recoveries={f.get('recoveries', 0)}")
        return "\n".join(lines)

    def explain(self) -> dict:
        out = {"deployment": self.deployment,
               "store_dispatches": self.store_dispatches,
               "components": {c.name: c.explain() for c in self.components}}
        if self.model_swaps:
            out["model_swaps"] = self.model_swaps
        if self.faults:
            out["faults"] = dict(self.faults)
        return out


def producer_dispatches(tier: str, steps: int, emit_every: int,
                        ranks: int, chunk: int
                        ) -> tuple[tuple[str, int], ...]:
    """Per-verb: one ``put`` per rank per emitting step.  Fused: one
    capture per chunk, ``ceil(steps / chunk)``."""
    if tier == "per_verb":
        return (("put", ranks * S.capture_emit_count(steps, emit_every)),)
    return (("capture", -(-steps // chunk)),)


def trainer_dispatches(tier: str, epochs: int, bootstrap: bool
                       ) -> tuple[tuple[str, int], ...]:
    """One store op per epoch on every tier (a capture, or the per-verb
    tier's one ``sample``; a mesh tier's ranks share its capture), plus
    the one-off norm-stats bootstrap sample for the trainer that pays
    it."""
    out = [("epoch", epochs)]
    if bootstrap:
        out.append(("norm_bootstrap", 1))
    return tuple(out)


def inference_dispatches(tier: str, steps: int
                         ) -> tuple[tuple[str, int], ...]:
    """Fused registry calls never touch the store; the three-step protocol
    costs put(1) + run_model's get-in/put-out(2) + get(1) per step."""
    if tier == "fused_registry":
        return ()
    return (("three_step", 4 * steps),)


def clients_dispatches(requests: int, submit: bool, collect: bool
                       ) -> tuple[tuple[str, int], ...]:
    """One ``put`` per submitted request (the submission-watermark bump is
    a host write), one ``get`` per collected response."""
    out = []
    if submit:
        out.append(("request", requests))
    if collect:
        out.append(("response", requests))
    return tuple(out)


def serving_dispatches(tier: str, requests: int, max_batch: int
                       ) -> tuple[tuple[str, int], ...]:
    """Continuous batching: ONE fused serve dispatch per drained batch,
    ``ceil(requests / max_batch)`` under canonical admission order.
    Three-step: one ``get`` plus one ``put`` per request."""
    if tier == "three_step":
        return (("get", requests), ("put", requests))
    return (("serve", -(-requests // max_batch)),)


def serving_swaps(tier: str) -> int:
    """Sequential run: the continuous-batching loop binds exactly the one
    generation published before it drains; three-step never binds."""
    return 1 if tier == "continuous_batch" else 0
