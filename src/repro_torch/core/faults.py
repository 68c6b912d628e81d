"""Typed store failures, retry, and declared fault plans.

Port of ``src/repro/core/faults.py``, cut to what the serving slice runs:

* a typed failure taxonomy (``StoreError`` and friends) replaces the
  silent-``False`` timeouts and bare ``RuntimeError``s of the early store;
* :class:`RetryPolicy` / :func:`call_with_retry` give every client verb
  bounded exponential backoff with deterministic jitter, deadline-clamped
  exactly like ``telemetry.poll_backoff``;
* :class:`FaultPlan` / :class:`FaultEvent` declare *which* faults fire
  *where*, keyed by deterministic attempt indices, never wall clock.

The injector that arms a plan, and the plan-time prediction of its
retries, replays and restarts, are ``ROADMAP.md`` A4: a session or server
given a plan raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass, field
from typing import Iterator

__all__ = [
    "StoreError", "StoreTimeout", "WatermarkTimeout", "StoreUnavailable",
    "TransferDropped", "InjectedCrash",
    "RetryPolicy", "call_with_retry",
    "FaultEvent", "FaultPlan",
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
    ``StoreServer``; in this slice any plan, even an empty one, raises
    there (``ROADMAP.md`` A4)."""

    events: tuple[FaultEvent, ...] = ()
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    seed: int = 0
