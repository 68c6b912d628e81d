"""Plan: tier selection as *data*.

Port of ``src/repro/insitu/plan.py`` — the serving plane's part: the
serving tiers, the per-component dispatch and model-swap predictions,
and the frozen :class:`Plan` whose predictions the tests hold against
``StoreServer.stats()``.  The producer and trainer tiers come
with the training slice (``ROADMAP.md`` A2), the collective predictions
of ``plan(hlo=True)`` with the multi-device tiers (A6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = [
    "SERVING_TIERS", "serving_tier", "ComponentPlan", "Plan",
    "clients_dispatches", "serving_dispatches", "serving_swaps",
]

SERVING_TIERS = ("continuous_batch", "three_step")


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
    kind: str                    # "clients" | "serving"
    tier: str
    table: str | None = None
    steps: int = 0               # requests
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
            "requests": self.steps,
        }
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

    def explain(self) -> dict:
        out = {"deployment": self.deployment,
               "store_dispatches": self.store_dispatches,
               "components": {c.name: c.explain() for c in self.components}}
        if self.model_swaps:
            out["model_swaps"] = self.model_swaps
        return out


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
