"""Component timers for the in-situ framework.

The paper reports, for every framework component (client initialization,
metadata transfer, training-data send, training-data retrieve, model
evaluation), the mean and standard deviation of the time spent across ranks
(Tables 1-2).  ``Timers`` reproduces that accounting: named accumulators that
record per-call wall time, with helpers to emit the paper-style summary
table.

Port of ``src/repro/core/telemetry.py``.  Where a timed payload holds a
CUDA tensor, the timer waits on an event recorded on the current stream
right after the payload was produced before it stops, so asynchronously
launched device work is charged to the component that issued it.  Work
other threads enqueue later is not waited for; work they enqueued earlier
on the same stream is, since the payload cannot complete before it (all
components share the device's default stream).
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch

__all__ = ["Timers", "TimerStats", "poll_backoff", "block_until_ready"]


def _has_cuda_tensor(payload: Any) -> bool:
    if isinstance(payload, torch.Tensor):
        return payload.is_cuda
    if isinstance(payload, dict):
        return any(_has_cuda_tensor(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return any(_has_cuda_tensor(v) for v in payload)
    return False


def block_until_ready(payload: Any) -> Any:
    """Wait for the device work producing ``payload`` (a tensor or a
    nest of them): an event recorded now on the current stream, not a
    device-wide synchronize.  A no-op for CPU tensors."""
    if _has_cuda_tensor(payload):
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
    return payload


def poll_backoff(timeout: float, interval: float, max_interval: float):
    """Drive a deadline-bounded polling loop: yields once per probe,
    sleeping with exponential backoff (``interval`` doubling up to
    ``max_interval``) between probes, each sleep clamped to the time
    remaining so the loop never overshoots ``timeout`` by a backoff
    step.  Shared by every store poller (``Client.poll_tensor``,
    ``StoreServer.wait_watermark``) so the clamp rule stays in lockstep.

        for _ in poll_backoff(timeout, interval, max_interval):
            if condition():
                return True
        return condition()   # one last look at the deadline
    """
    deadline = time.perf_counter() + timeout
    while True:
        yield
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            return
        time.sleep(min(interval, remaining))
        interval = min(interval * 2.0, max_interval)


@dataclass
class TimerStats:
    """Online mean/variance accumulator (Welford)."""

    count: int = 0
    total: float = 0.0
    _mean: float = 0.0
    _m2: float = 0.0
    min: float = math.inf
    max: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        delta = dt - self._mean
        self._mean += delta / self.count
        self._m2 += delta * (dt - self._mean)
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.count - 1))


class Timers:
    """Named wall-clock accumulators, paper-Tables-1/2 style."""

    def __init__(self) -> None:
        self._stats: dict[str, TimerStats] = {}

    def stats(self, name: str) -> TimerStats:
        if name not in self._stats:
            self._stats[name] = TimerStats()
        return self._stats[name]

    @contextmanager
    def time(self, name: str, payload: Any = None):
        """Time a block; if ``payload`` is set, block on it before stopping.

        The payload can also be supplied late by assigning to ``box[0]``
        of the yielded one-element list (useful when the timed block
        produces the arrays to block on).
        """
        box = [payload]
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            if box[0] is not None:
                block_until_ready(box[0])
            self.stats(name).add(time.perf_counter() - t0)

    def record(self, name: str, dt: float) -> None:
        self.stats(name).add(dt)

    def total(self, name: str) -> float:
        return self._stats[name].total if name in self._stats else 0.0

    def mean(self, name: str) -> float:
        return self._stats[name].mean if name in self._stats else 0.0

    def merge(self, other: "Timers") -> None:
        """Merge per-rank timers (used to average across worker threads)."""
        for name, st in other._stats.items():
            mine = self.stats(name)
            # Merge by replaying summary statistics (exact for mean/total,
            # approximate pooled variance).
            if st.count == 0:
                continue
            n1, n2 = mine.count, st.count
            if n1 == 0:
                self._stats[name] = TimerStats(
                    count=st.count, total=st.total, _mean=st._mean, _m2=st._m2,
                    min=st.min, max=st.max,
                )
                continue
            delta = st._mean - mine._mean
            tot = n1 + n2
            mine._m2 = mine._m2 + st._m2 + delta * delta * n1 * n2 / tot
            mine._mean = (n1 * mine._mean + n2 * st._mean) / tot
            mine.count = tot
            mine.total += st.total
            mine.min = min(mine.min, st.min)
            mine.max = max(mine.max, st.max)

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "count": st.count,
                "total_s": st.total,
                "mean_s": st.mean,
                "std_s": st.std,
                "min_s": st.min if st.count else 0.0,
                "max_s": st.max,
            }
            for name, st in sorted(self._stats.items())
        }

    def table(self, title: str = "") -> str:
        """Render the paper-style component table."""
        lines = []
        if title:
            lines.append(title)
        lines.append(f"{'Component':<28} {'Total [s]':>12} {'Mean [s]':>12} "
                     f"{'Std [s]':>12} {'Count':>8}")
        for name, st in sorted(self._stats.items()):
            lines.append(
                f"{name:<28} {st.total:>12.6f} {st.mean:>12.6f} "
                f"{st.std:>12.6f} {st.count:>8d}"
            )
        return "\n".join(lines)
