"""Declarative in-situ components: *what* runs, never *how*.

Port of ``src/repro/insitu/components.py`` — the single-device
components: the simulation ``Producer``, the ``TrainerConsumer``, the
``InferenceConsumer`` and the serving plane's two components, each with
its typed output.  What needs several devices raises
``NotImplementedError`` naming its ``ROADMAP.md`` item: a sharded
producer element (``elem_sharding``) and multi-consumer training
(``count > 1``), both A5.

Two contracts differ from the reference: ``TrainerConsumer`` takes the
trainer's random ``draws`` (see ``ml.trainer``), and an inference
``feed`` returns ONE element, ``[N, C]`` — the registry adds the batch
axis (``StoreServer.run_model``), where the reference's feed returns
``[1, N, C]`` itself.  ``InferenceOutput`` keeps every output, not only
the last.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ..ml.trainer import EpochResult, TrainDraws, TrainerConfig, TrainState

__all__ = [
    "Producer", "TrainerConsumer", "InferenceConsumer",
    "ServingClients", "ServingConsumer",
    "ProducerOutput", "TrainerOutput", "InferenceOutput",
    "ServingClientsOutput", "ServingOutput",
]


@dataclass
class Producer:
    """A data-producing component (the paper's simulation ranks).

    ``step_fn(carry, rank, t) -> (carry, key, value)`` is one rank's
    single step: advance the solver carry, return the key/value to store
    when step ``t`` emits.  With ``ranks > 1`` the carry stacks the
    per-rank states on a leading ``[ranks]`` axis and the plan picks the
    multi-producer capture.  ``traceable=False`` (e.g. an emulated solver
    that sleeps) pins the per-verb tier, as in the reference.  ``warmup``
    runs one step off the clock (timed as ``warmup``) and drops it.
    """

    step_fn: Callable
    table: str
    steps: int
    ranks: int = 1
    carry: Any = None
    emit_every: int = 1
    traceable: bool = True
    chunk: int | None = None      # fused chunk length (None: plan default)
    bucket: bool = True           # report the tail's pow2 bucket in the plan
    tier: str | None = None       # force a producer tier (see plan module)
    elem_sharding: Any = None
    warmup: bool = True
    name: str = "producer"

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if self.ranks < 1:
            raise ValueError("ranks must be >= 1")
        if self.emit_every < 1:
            raise ValueError("emit_every must be >= 1")
        if self.elem_sharding is not None:
            raise NotImplementedError(
                "Producer.elem_sharding (capture_scan_sharded): ROADMAP.md "
                "A5")


@dataclass
class ProducerOutput:
    steps: int


@dataclass
class TrainerConsumer:
    """A training component (the paper's ML ranks).

    ``cfg`` carries the numerics; the tier (per-verb or fused) is resolved
    by the plan from ``cfg`` unless forced via ``tier``.  Set
    ``model_key`` to publish the trained encoder into the model registry
    (plus a ``"trained"`` metadata flag) for downstream
    :class:`InferenceConsumer`\\ s; ``publish_every`` also publishes a
    versioned checkpoint every that many epochs.  ``draws`` are the
    trainer's random draws (``ml.trainer.TrainDraws``; default: from
    ``cfg.seed``).  ``count > 1`` (multi-consumer training) is
    ``ROADMAP.md`` A5.
    """

    cfg: TrainerConfig
    coords: Any
    count: int = 1
    tier: str | None = None
    model_key: str | None = None
    on_epoch: Callable[[EpochResult], None] | None = None
    publish_every: int | None = None
    draws: TrainDraws | None = None
    name: str = "trainer"

    def __post_init__(self):
        if self.count < 1:
            raise ValueError("count must be >= 1")
        if self.count > 1:
            raise NotImplementedError(
                "TrainerConsumer(count > 1), multi-consumer training: "
                "ROADMAP.md A5")
        if self.publish_every is not None:
            if self.publish_every < 1:
                raise ValueError("publish_every must be >= 1")
            if self.model_key is None:
                raise ValueError("publish_every requires model_key")


@dataclass
class TrainerOutput:
    steps: int
    state: TrainState
    history: list[EpochResult]
    levels: Any
    norm_stats: Any


@dataclass
class InferenceConsumer:
    """An in-situ inference component (paper §3.2 / Fig. 1b).

    Evaluates the registered model ``model_key`` on inputs produced by
    ``feed(client, step)`` (one element each).  The default tier is the
    fused registry call (no store round-trip); ``tier="three_step"`` runs
    the paper's put → run_model → get protocol through scratch tables.
    ``wait_meta`` blocks until a metadata flag (a trainer's ``"trained"``)
    appears; ``wait_timeout_s=None`` waits as long as the session's wall
    budget allows.  ``warmup`` runs one untimed evaluation first.
    """

    model_key: str
    feed: Callable
    steps: int = 5
    wait_meta: str | None = "trained"
    wait_timeout_s: float | None = None
    warmup: bool = True
    tier: str | None = None
    name: str = "inference"

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError("steps must be >= 1")


@dataclass
class InferenceOutput:
    steps: int
    last: Any
    #: every step's output, in step order
    outputs: list = field(default_factory=list)


@dataclass
class ServingClients:
    """The request-submitting side of the serving plane: ``clients``
    concurrent inference clients, each submitting ``requests`` requests
    (``feed(client, seq) -> value``) into the store-backed request
    ``table`` under packed (client, seq) keys, then polling the paired
    results table for their answers.

    ``submit`` / ``collect`` split the two halves for sequential
    scheduling (a submit-only writer before the :class:`ServingConsumer`,
    a collect-only reader after it); ``order_seed`` shuffles the arrival
    interleave across clients.
    """

    feed: Callable
    table: str
    clients: int = 2
    requests: int = 4
    submit: bool = True
    collect: bool = True
    order_seed: int | None = None
    name: str = "clients"

    def __post_init__(self):
        if self.clients < 1:
            raise ValueError("clients must be >= 1")
        if self.requests < 1:
            raise ValueError("requests must be >= 1")
        if not (self.submit or self.collect):
            raise ValueError("at least one of submit/collect is required")


@dataclass
class ServingClientsOutput:
    requests: int
    #: collected responses keyed ``(client, seq)`` (empty when
    #: ``collect=False``)
    responses: dict


@dataclass
class ServingConsumer:
    """The serving plane's drain side: continuous batching over the
    request ``table``, responses into ``results``, model ``model_key``
    hot-swapped from the registry between batches.

    The default tier (``continuous_batch``) drains up to ``max_batch``
    requests per fused dispatch and re-checks the model version every
    ``reload_every`` batches; ``tier="three_step"`` forces the paper's
    one-at-a-time get → run_model → put baseline.  ``wait_timeout_s``
    bounds the wait for the first published model and for requests.
    """

    model_key: str
    table: str
    results: str
    clients: int = 2
    requests: int = 4
    max_batch: int = 4
    reload_every: int = 1
    wait_timeout_s: float | None = None
    tier: str | None = None
    name: str = "serving"

    def __post_init__(self):
        if self.clients < 1:
            raise ValueError("clients must be >= 1")
        if self.requests < 1:
            raise ValueError("requests must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.reload_every < 1:
            raise ValueError("reload_every must be >= 1")
        if self.table == self.results:
            raise ValueError("request and results tables must differ")


@dataclass
class ServingOutput:
    steps: int      # requests served
    batches: int    # fused serve dispatches (0 for three_step)
    swaps: int      # model generations adopted
