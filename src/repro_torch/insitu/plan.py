"""Plan: tier selection as *data*.

Port of ``src/repro/insitu/plan.py`` — the single-device part: the
producer, trainer, inference and serving tiers, the per-component
dispatch and model-swap predictions, and the frozen :class:`Plan` whose
predictions the tests hold against ``StoreServer.stats()``.

=============  =====================================================
producer       ``per_verb`` | ``capture_scan`` | ``capture_scan_multi``
trainer        ``per_verb`` | ``fused``
inference      ``fused_registry`` | ``three_step``
serving        ``continuous_batch`` | ``three_step``
=============  =====================================================

The reference's sharded tiers (``capture_scan_sharded``,
``sharded_fused``, ``slab_sharded[_clustered]``), staged-transfer and
fault predictions and the contention model are ``ROADMAP.md`` A4–A5;
the collective predictions of ``plan(hlo=True)`` are A6.
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
    "serving_dispatches", "serving_swaps",
]

PRODUCER_TIERS = ("per_verb", "capture_scan", "capture_scan_multi")
TRAINER_TIERS = ("per_verb", "fused")
INFERENCE_TIERS = ("fused_registry", "three_step")
SERVING_TIERS = ("continuous_batch", "three_step")


def producer_tier(comp) -> str:
    """Resolve a :class:`~.components.Producer`'s tier: a forced tier is
    validated; otherwise non-traceable steps pin ``per_verb``, one rank
    takes ``capture_scan``, several ``capture_scan_multi``."""
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
        return comp.tier
    if not comp.traceable:
        return "per_verb"
    return "capture_scan" if comp.ranks == 1 else "capture_scan_multi"


def trainer_tier(cfg, override: str | None = None) -> str:
    """Resolve a trainer tier from a ``TrainerConfig`` (the rule
    ``ml.trainer.insitu_train`` consults when no plan names one)."""
    if override is not None:
        if override not in TRAINER_TIERS:
            raise ValueError(f"unknown trainer tier {override!r} "
                             f"(have {TRAINER_TIERS})")
        if override != "per_verb" and not cfg.fused:
            raise ValueError(f"tier {override!r} needs cfg.fused=True")
        return override
    return "fused" if cfg.fused else "per_verb"


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
    #: predicted store dispatches this component will perform, by cause.
    dispatches: tuple[tuple[str, int], ...] = ()
    #: predicted model-generation adoptions (serving hot-swap).
    swaps: int = 0

    @property
    def store_dispatches(self) -> int:
        return sum(n for _, n in self.dispatches)

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
        return out


@dataclass(frozen=True)
class Plan:
    """The session's full execution decision, frozen (components in
    declaration order)."""

    deployment: str
    components: tuple[ComponentPlan, ...]

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
            if c.kind == "serving":
                bits.append(f"requests={c.steps} swaps={c.swaps}")
            lines.append(f"  {c.name} [{c.kind}]: " + " ".join(bits))
        return "\n".join(lines)

    def explain(self) -> dict:
        out = {"deployment": self.deployment,
               "store_dispatches": self.store_dispatches,
               "components": {c.name: c.explain() for c in self.components}}
        if self.model_swaps:
            out["model_swaps"] = self.model_swaps
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
    """One store op per epoch on either tier (a capture, or the per-verb
    tier's one ``sample``), plus the one-off norm-stats bootstrap sample
    for the trainer that pays it."""
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
