"""Declarative in-situ components: *what* runs, never *how*.

Port of ``src/repro/insitu/components.py`` — the serving plane's two
components and their outputs.  ``Producer``, ``TrainerConsumer`` and
``InferenceConsumer`` are the training slice (``ROADMAP.md`` A2) and raise
here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

__all__ = [
    "Producer", "TrainerConsumer", "InferenceConsumer",
    "ServingClients", "ServingConsumer",
    "ServingClientsOutput", "ServingOutput",
]


class _NotPorted:
    item = ""

    def __init__(self, *_args, **_kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}: ROADMAP.md {self.item}")


class Producer(_NotPorted):
    item = "A2 (training slice)"


class TrainerConsumer(_NotPorted):
    item = "A2 (training slice)"


class InferenceConsumer(_NotPorted):
    item = "A2 (training slice)"


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
