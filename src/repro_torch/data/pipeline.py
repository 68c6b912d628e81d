"""Host data pipeline: synthetic token streams with background prefetch.

Port of ``src/repro/data/pipeline.py``.  ``TokenStream`` is the
reference's deterministic synthetic corpus, draw for draw (a zipfian
unigram mixture with a repeating n-gram rule, numpy's generator from
``seed``), so a seed gives batches byte-identical to the reference's.
``PrefetchIterator`` builds batches on a host thread into a bounded
queue and hands out tensors already on an explicit device: on a card,
each array is staged in pinned host memory and copied with
``non_blocking=True`` on the thread's current stream (the default
stream, so the copy is ordered before any later work that reads it).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["TokenStream", "PrefetchIterator"]


@dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    structure: float = 0.7     # fraction of deterministic-ngram positions

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        # zipf-ish unigram distribution
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        while True:
            base = rng.choice(self.vocab, size=(self.batch, self.seq_len),
                              p=probs).astype(np.int32)
            # structured positions: token t = (prev*31 + 7) mod vocab — a
            # learnable next-token rule, applied sequentially so the
            # invariant holds through cascaded replacements
            mask = rng.random((self.batch, self.seq_len - 1)) < self.structure
            for t in range(1, self.seq_len):
                det = (base[:, t - 1] * 31 + 7) % self.vocab
                base[:, t] = np.where(mask[:, t - 1], det, base[:, t])
            yield {"tokens": base, "labels": base.copy()}


class PrefetchIterator:
    """Background-thread prefetch with a bounded buffer: batches (dicts of
    numpy arrays) become dicts of tensors on ``device`` (default: the
    card) before the consumer asks for them.  An exception in the thread
    (the source's, or a failed copy to the device) is raised again by
    the ``next`` that meets the end of the stream.  ``close()`` stops the
    thread."""

    def __init__(self, it, buffer_size: int = 2, device=None):
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._sentinel = object()
        self._stop = threading.Event()
        self._error: BaseException | None = None

        def _producer():
            try:
                for item in it:
                    if self._stop.is_set():
                        break
                    self._put({k: self._to_device(v)
                               for k, v in item.items()})
            except BaseException as e:      # handed to the consumer
                self._error = e
            finally:
                self._put(self._sentinel)

        self._thread = threading.Thread(target=_producer, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _to_device(self, arr) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
