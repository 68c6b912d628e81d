"""Request batching for the serving loop.

A minimal continuous-batching front end: requests arrive with a prompt and
a token budget; the ``Batcher`` packs up to ``max_batch`` active requests
into the fixed-shape decode step (padding empty slots), admits new
requests into freed slots between steps, and retires finished sequences.
Fixed shapes keep one compiled ``serve_step`` for the whole run — slot
admission is pure host logic.

A copy of ``src/repro/serve/batching.py`` (numpy only).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Request", "Batcher"]


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    submitted_at: float = field(default_factory=time.perf_counter)
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None


class Batcher:
    """Slot-based continuous batching over a fixed decode batch size."""

    def __init__(self, max_batch: int, eos_id: int | None = None):
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_batch
        self._ids = itertools.count()
        self.completed: list[Request] = []

    def submit(self, prompt: list[int], max_new_tokens: int = 16) -> Request:
        req = Request(rid=next(self._ids), prompt=list(prompt),
                      max_new_tokens=max_new_tokens)
        self.queue.append(req)
        return req

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the queue; returns newly placed (slot, req)."""
        placed = []
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                placed.append((i, req))
        return placed

    def active_mask(self) -> np.ndarray:
        return np.array([s is not None and not s.done for s in self.slots])

    def record_tokens(self, token_per_slot: np.ndarray) -> None:
        now = time.perf_counter()
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            tok = int(token_per_slot[i])
            if req.first_token_at is None:
                req.first_token_at = now
            req.tokens.append(tok)
            if (self.eos_id is not None and tok == self.eos_id) or \
                    len(req.tokens) >= req.max_new_tokens:
                req.done = True
                req.finished_at = now
                self.completed.append(req)
                self.slots[i] = None

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
