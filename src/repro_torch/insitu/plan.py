"""Plan: tier selection as *data*.

Port of ``src/repro/insitu/plan.py`` — the local, co-located and
clustered deployments: the producer, trainer, inference and serving
tiers, the
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
               ``slab_sharded`` | ``slab_sharded_clustered``
inference      ``fused_registry`` | ``three_step``
serving        ``continuous_batch`` | ``three_step``
=============  =====================================================

The reference measures collectives in compiled HLO.  The port has no
HLO: a mesh's collectives are explicit calls
(``parallel.collectives``), so ``plan(hlo=True)`` counts the calls one
epoch of a tier makes, under the reference's five op names
(:data:`COLLECTIVE_OPS`).

The predictions follow the calls the port makes, and some deliberately
differ from the reference's: a serving drain on a request table whose
elements are cut over a mesh all-gathers the requests it reads, because
the registered model takes whole elements, and one on a table whose slots
are cut (``Colocated(capacity_axis=)``, a slot-cut clustered table)
all-reduces its reads (:func:`serving_collective_prediction`; the
reference claims every drain collective-free); the clustered staged
trainer all-gathers on the db side when the table's elements are cut
(:func:`trainer_collective_prediction`).  :func:`ddp_all_reduces` counts
the all-reduce calls of a DDP epoch's microsteps (two a microstep with
``ddp="psum"``, three over the int8 wire).

Clustered deployments also get *staged-transfer* predictions
(``ComponentPlan.staged``, ``staged_transfers``): one hop per put verb on
the per-verb tier, exactly ONE per fused chunk, one per epoch of the
staged clustered gather, held exactly against ``stats()
["staged_transfers"]``; the overlap pipeline adds one ``drain`` op per
fused producer run.  :class:`ContentionModel` fits producer steps/s
against the clients-per-shard ``fan_in``, and :func:`autotune_chunk`
picks the fused chunk from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core import store as S
from ..core.deployment import fan_in_ratio

__all__ = [
    "PRODUCER_TIERS", "TRAINER_TIERS", "INFERENCE_TIERS", "SERVING_TIERS",
    "producer_tier", "trainer_tier", "inference_tier", "serving_tier",
    "default_chunk", "autotune_chunk", "ContentionModel", "fan_in_ratio",
    "ComponentPlan", "Plan", "producer_dispatches",
    "trainer_dispatches", "inference_dispatches", "clients_dispatches",
    "serving_dispatches", "serving_swaps", "producer_staged",
    "trainer_staged", "inference_staged", "clients_staged",
    "serving_staged", "COLLECTIVE_OPS",
    "COLLECTIVE_FREE", "TRAINER_COLLECTIVE_PREDICTIONS",
    "trainer_collective_prediction", "sharded_producer_prediction",
    "serving_collective_prediction", "ddp_all_reduces",
]

#: the collective op names of the reference's HLO accounting
#: (``src/repro/analysis/hlo.py``); ``parallel.collectives.COUNTS`` keys
#: map onto the first two
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

PRODUCER_TIERS = ("per_verb", "capture_scan", "capture_scan_multi",
                  "capture_scan_sharded")
TRAINER_TIERS = ("per_verb", "fused", "sharded_fused", "slab_sharded",
                 "slab_sharded_clustered")
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
    mesh_tiers = ("sharded_fused", "slab_sharded", "slab_sharded_clustered")
    slab_tiers = ("slab_sharded", "slab_sharded_clustered")
    if override is not None:
        if override not in TRAINER_TIERS:
            raise ValueError(f"unknown trainer tier {override!r} "
                             f"(have {TRAINER_TIERS})")
        if override in mesh_tiers and cfg.mesh is None:
            raise ValueError(f"{override} needs cfg.mesh")
        if override not in mesh_tiers and cfg.mesh is not None:
            raise ValueError(
                f"cfg.mesh is set; tier {override!r} would ignore it")
        if override in slab_tiers and not cfg.slab_sharded:
            raise ValueError(f"{override} needs cfg.slab_sharded=True")
        if override not in slab_tiers and cfg.slab_sharded:
            raise ValueError(
                f"cfg.slab_sharded is set; tier {override!r} would pass "
                f"the table replicated")
        if override == "slab_sharded_clustered" and cfg.db_mesh is None:
            raise ValueError("slab_sharded_clustered needs cfg.db_mesh "
                             "(the store's dedicated mesh; a session "
                             "wires it from the Clustered deployment)")
        if override != "slab_sharded_clustered" and cfg.db_mesh is not None:
            raise ValueError(
                f"cfg.db_mesh is set; tier {override!r} would ignore the "
                f"dedicated store mesh")
        if override != "per_verb" and not cfg.fused:
            raise ValueError(f"tier {override!r} needs cfg.fused=True")
        return override
    if not cfg.fused:
        return "per_verb"
    if cfg.mesh is None:
        return "fused"
    if cfg.slab_sharded:
        return "slab_sharded_clustered" if cfg.db_mesh is not None \
            else "slab_sharded"
    return "sharded_fused"


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


@dataclass(frozen=True)
class ContentionModel:
    """The fan-in contention model: predicted producer throughput
    (steps/s) as a function of the clients-per-shard ``fan_in``, fitted
    from a measured sweep (the paper's Fig.-5 story made quantitative),

        t_step(fan_in) = t_base + k_fanin * fan_in
        steps_per_s    = 1 / t_step

    ``k_fanin``'s sign is fitted, not assumed.  ``fit`` is an ordinary
    least-squares line through ``(fan_in, 1/steps_per_s)``; ``residual``
    is the worst relative throughput error over the cells it was fitted
    from."""

    t_base: float               # seconds/step at fan_in -> 0
    k_fanin: float              # marginal seconds/step per fan-in unit
    step_bytes: float = 0.0     # staged payload bytes per producer step
    #: fixed per-capture host overhead (seconds/op) from the measured
    #: dispatch-cost curve — the autotuner's amortization term.
    t_dispatch: float = 0.0

    @classmethod
    def fit(cls, cells) -> "ContentionModel":
        """Least-squares fit from sweep cells — mappings with ``fan_in``
        and ``steps_per_s`` (and optionally ``step_bytes``).  Needs >= 2
        distinct fan-in points."""
        pts = sorted({(float(c["fan_in"]), 1.0 / float(c["steps_per_s"]))
                      for c in cells})
        xs = [x for x, _ in pts]
        ys = [y for _, y in pts]
        if len(set(xs)) < 2:
            raise ValueError(
                f"contention fit needs >= 2 distinct fan_in points, got "
                f"{sorted(set(xs))}")
        n = float(len(xs))
        mx, my = sum(xs) / n, sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        k = sxy / sxx
        bites = [float(c.get("step_bytes", 0.0)) for c in cells]
        return cls(t_base=my - k * mx, k_fanin=k,
                   step_bytes=max(bites) if bites else 0.0)

    def predict_steps_per_s(self, fan_in: int) -> float:
        t = self.t_base + self.k_fanin * float(fan_in)
        if t <= 0:
            raise ValueError(
                f"contention model predicts non-positive step time "
                f"{t:.3g}s at fan_in={fan_in} (t_base={self.t_base:.3g}, "
                f"k_fanin={self.k_fanin:.3g}) — fit covers too narrow a "
                f"sweep to extrapolate this far")
        return 1.0 / t

    def residual(self, cells) -> float:
        """Worst relative throughput error of the fitted line over
        ``cells``."""
        return max(abs(self.predict_steps_per_s(c["fan_in"])
                       / float(c["steps_per_s"]) - 1.0) for c in cells)


def autotune_chunk(emit_every: int, model: ContentionModel | None = None,
                   dispatch_cost: float | None = None,
                   steps: int | None = None,
                   fan_in: int = 1, max_chunk: int = 512) -> int:
    """The fused producer's chunk length from the fitted cost model: the
    power-of-two bucket boundaries from the data plane's floor up, the
    one minimizing the predicted wall time of a ``steps``-step run,

        ceil(steps/chunk) * (dispatch_cost + chunk * t_step(fan_in))
        + dispatch_cost                                  # the drain

    Without a model (or with ``fan_in`` outside its fit) it is
    :func:`default_chunk`."""
    if model is None:
        return default_chunk(emit_every)
    if dispatch_cost is None:
        dispatch_cost = model.t_dispatch
    try:
        t_step = 1.0 / model.predict_steps_per_s(fan_in)
    except ValueError:
        return default_chunk(emit_every)
    total = int(steps) if steps else max_chunk
    floor = S.bucket_length(S.MIN_BUCKET * emit_every)
    candidates = []
    c = floor
    while c <= max(floor, max_chunk):
        candidates.append(c)
        c *= 2

    def wall(n: int) -> float:
        n_chunks = -(-total // n)
        return n_chunks * (dispatch_cost + n * t_step) + dispatch_cost

    return min(candidates, key=wall)


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
    # the db-side gather's psum and the client-side DDP psum; the hop
    # between the meshes is a staged copy, never a collective, and the
    # table is never all-gathered (the slab stays on the db mesh)
    "slab_sharded_clustered": _pred(all_reduce=True),
}


def trainer_collective_prediction(tier: str, table_sharded: bool = False,
                                  elems_cut: bool = False
                                  ) -> tuple[tuple[str, bool], ...] | None:
    """One trainer entry's collective structure.  ``table_sharded``: the
    table it reads is split over more than one rank (a slab-sharded
    trainer's placement, or a capacity-cut co-located one).  Then
    ``sharded_fused`` all-gathers the slab on entry, the anti-pattern
    ``slab_sharded`` removes; the single-device ``fused`` tier gets no
    claim (``None``), as in the reference.  The clustered staged tier
    never takes the table into its epoch; its db-side gather all-gathers
    only where the table's elements are cut (``elems_cut``: the port's
    reads return whole elements; the reference makes this claim on no
    placement)."""
    if tier == "slab_sharded_clustered":
        if elems_cut:
            return _pred(all_reduce=True, all_gather=True)
        return TRAINER_COLLECTIVE_PREDICTIONS[tier]
    if table_sharded and tier == "sharded_fused":
        return _pred(all_reduce=True, all_gather=True)
    if table_sharded and tier == "fused":
        return None
    return TRAINER_COLLECTIVE_PREDICTIONS[tier]


def sharded_producer_prediction(elem_sharding, colocated: bool,
                                slots_cut: bool = False
                                ) -> tuple[tuple[str, bool], ...] | None:
    """The collective structure of one ``capture_scan_sharded`` chunk: the
    rank-local put adds **no cross-rank collective beyond the producer's
    own halo exchange** — ``collective_permute`` nonzero (the ppermuted
    faces), everything else, ``all_gather`` above all, zero.  Claimed only
    where it is structural: co-located over more than one rank (the slab
    carries the emission's layout).  Elsewhere ``None``: a local table
    holds whole elements, so the emission is assembled into it, and a
    co-located table whose slots are cut too (``slots_cut``,
    ``capacity_axis``) is laid out unlike the emission."""
    if not colocated or elem_sharding is None or slots_cut:
        return None
    if getattr(elem_sharding, "num_devices", 1) <= 1 \
            or getattr(elem_sharding, "is_fully_replicated", False):
        return None
    return _pred(collective_permute=True)


def serving_collective_prediction(req_sharded: bool, slots_cut: bool = False
                                  ) -> tuple[tuple[str, bool], ...]:
    """The collective structure of one serving drain (either tier): the
    store plumbing makes none on a whole request table; on one whose
    elements are cut over a mesh (``req_sharded``) each read assembles
    its requests with one all-gather, the registered model taking whole
    elements; on one whose slots are cut (``slots_cut``) each read sums
    the shards' own rows with one all-reduce.  The response write stays
    rank-local.  (The reference claims the drain collective-free on every
    deployment.)"""
    return _pred(all_gather=req_sharded, all_reduce=slots_cut)


def ddp_all_reduces(ddp: str, microsteps: int) -> int:
    """The all-reduce calls of ``microsteps`` DDP microsteps: the loss and
    the gradient tree (``"psum"``), or the loss, the int8 payload tree and
    the scale tree (``"int8"``).  An epoch's gather adds its own (the
    slab-sharded gather's ``psum``)."""
    return microsteps * (3 if ddp == "int8" else 2)


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
    #: predicted cross-mesh staged transfers (clustered deployments), by
    #: cause — held exactly against ``stats()["staged_transfers"]``.
    staged: tuple[tuple[str, int], ...] = ()
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
    #: clients per db shard for THIS component's staged traffic
    #: (``fan_in_ratio``, the source ``Clustered.fan_in`` uses; 1 off
    #: clustered)
    fan_in: int = 1
    #: the contention model's predicted producer steps/s at ``fan_in``,
    #: when the deployment carries a fitted :class:`ContentionModel`
    predicted_steps_per_s: float | None = None

    @property
    def store_dispatches(self) -> int:
        return sum(n for _, n in self.dispatches)

    @property
    def staged_transfers(self) -> int:
        """Predicted staged hops (0 off the clustered deployment)."""
        return sum(n for _, n in self.staged)

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
        if self.staged:
            out["staged_transfers"] = self.staged_transfers
            out["staged_detail"] = dict(self.staged)
        if self.kind == "producer":
            out["ranks"] = self.ranks
            out["dispatches_per_step"] = \
                self.store_dispatches / max(1, self.steps)
            if self.tier != "per_verb":
                out["chunk"] = self.chunk
                out["bucketed"] = self.bucketed
                if self.staged:
                    # THE clustered fused claim: one hop per chunk capture
                    # (the overlap pipeline's drain stages nothing)
                    captures = dict(self.dispatches).get(
                        "capture", self.store_dispatches)
                    out["staged_per_chunk"] = \
                        self.staged_transfers / max(1, captures)
            if self.staged:
                out["fan_in"] = self.fan_in
            if self.predicted_steps_per_s is not None:
                out["predicted_steps_per_s"] = self.predicted_steps_per_s
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
    #: clients per store shard (``Deployment.fan_in``; 1 off clustered)
    fan_in: int = 1
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
    def staged_transfers(self) -> int:
        """Predicted total staged hops (0 off clustered)."""
        return sum(c.staged_transfers for c in self.components)

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
        if self.fan_in != 1 or self.staged_transfers:
            out["fan_in"] = self.fan_in
            out["staged_transfers"] = self.staged_transfers
        if self.model_swaps:
            out["model_swaps"] = self.model_swaps
        if self.faults:
            out["faults"] = dict(self.faults)
        return out


def producer_dispatches(tier: str, steps: int, emit_every: int,
                        ranks: int, chunk: int, overlap: bool = False
                        ) -> tuple[tuple[str, int], ...]:
    """Per-verb: one ``put`` per rank per emitting step.  Fused: one
    capture per chunk, ``ceil(steps / chunk)``; ``overlap`` (the
    clustered two-slot staging pipeline) adds the ONE capture-end
    ``drain`` op that inserts the last in-flight chunk."""
    if tier == "per_verb":
        return (("put", ranks * S.capture_emit_count(steps, emit_every)),)
    out = (("capture", -(-steps // chunk)),)
    if overlap and steps > 0:
        out += (("drain", 1),)
    return out


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


def producer_staged(tier: str, steps: int, emit_every: int, ranks: int,
                    chunk: int, crosses_mesh: bool
                    ) -> tuple[tuple[str, int], ...]:
    """Staged hops of a producer run: per-verb, one per rank per emitting
    step; fused, ONE per chunk (``ceil(steps / chunk)``)."""
    if not crosses_mesh:
        return ()
    if tier == "per_verb":
        return (("elem_stage", ranks * S.capture_emit_count(steps,
                                                            emit_every)),)
    return (("chunk_stage", -(-steps // chunk)),)


def trainer_staged(tier: str, epochs: int, crosses_mesh: bool
                   ) -> tuple[tuple[str, int], ...]:
    """Staged hops of one trainer: only the clustered staged tier moves
    bytes (one gathered batch per epoch)."""
    if crosses_mesh and tier == "slab_sharded_clustered":
        return (("gather_stage", epochs),)
    return ()


def inference_staged(tier: str, steps: int, crosses_mesh: bool
                     ) -> tuple[tuple[str, int], ...]:
    """The three-step protocol stages its two put legs a step (input in,
    prediction out); the fused registry path never touches the store."""
    if crosses_mesh and tier == "three_step":
        return (("put_stage", 2 * steps),)
    return ()


def clients_staged(requests: int, submit: bool, crosses_mesh: bool
                   ) -> tuple[tuple[str, int], ...]:
    """Each submitted request's put stages its payload; response gets
    read in place and never stage."""
    if crosses_mesh and submit:
        return (("request_stage", requests),)
    return ()


def serving_staged(tier: str, requests: int, crosses_mesh: bool
                   ) -> tuple[tuple[str, int], ...]:
    """The fused drain runs on the store placement (no hop); the
    three-step baseline stages each response put."""
    if crosses_mesh and tier == "three_step":
        return (("response_stage", requests),)
    return ()


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
