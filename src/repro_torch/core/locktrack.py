"""Runtime lock-order witness for :class:`~repro_torch.core.server.StoreServer`.

Port of ``src/repro/core/locktrack.py``.  The static lock rules of
``tools/lint`` prove lock discipline *lexically*; this module proves it
*dynamically*: every lock the server owns (``_lock``, ``_ops_lock``, one
``_table_locks`` entry per table) is wrapped in a tracking proxy, each
acquisition records ``held -> acquired`` edges into a lock-order graph,
and :meth:`LockTracker.assert_acyclic` fails with the offending cycle if
two code paths ever disagree on ordering.  The port's chaos tests run
under :meth:`LockTracker.instrument`.

The expected (acyclic) graph, for reference::

    server._lock ──────────┐
    table:<a> ── table:<b> ─┴──▶ server._ops_lock      (leaf)

with ``table:<a> -> table:<b>`` only ever in sorted-name order (the
canonical two-lock acquisition in ``serve_batch``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

__all__ = ["LockTracker", "LockCycleError"]


class LockCycleError(AssertionError):
    """The witnessed lock-order graph contains a cycle (deadlock hazard)."""


class _TrackedLock:
    """Proxy around a ``threading`` lock that reports acquire/release.

    Everything not intercepted — notably the private
    ``_is_owned``/``_release_save``/``_acquire_restore`` hooks
    :class:`threading.Condition` looks up — is delegated to the raw
    lock, so a Condition built on a tracked lock behaves identically.
    """

    def __init__(self, tracker: "LockTracker", raw, name: str):
        self._tracker = tracker
        self._raw = raw
        self._name = name

    def acquire(self, *args, **kwargs) -> bool:
        got = self._raw.acquire(*args, **kwargs)
        if got:
            self._tracker._note_acquire(self._name)
        return got

    def release(self) -> None:
        self._tracker._note_release(self._name)
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._raw, attr)

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name} of {self._raw!r}>"


class LockTracker:
    """Collects the realised lock-order graph across all threads."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._names: set[str] = set()
        self._held = threading.local()

    # -- wrapping ------------------------------------------------------------

    def wrap(self, raw, name: str) -> _TrackedLock:
        with self._mu:
            self._names.add(name)
        return _TrackedLock(self, raw, name)

    def attach(self, server) -> None:
        """Wrap every lock a live ``StoreServer`` owns (and any table
        lock it creates later)."""
        server._lock = self.wrap(server._lock, "server._lock")
        server._ops_lock = self.wrap(server._ops_lock, "server._ops_lock")
        # Rebuild the metadata Condition on the tracked registry lock so
        # wait/notify keep going through one (witnessed) mutex.
        server._meta_event = threading.Condition(server._lock)
        for t, lk in list(server._table_locks.items()):
            server._table_locks[t] = self.wrap(lk, f"table:{t}")

        orig_create = server.create_table

        def create_table(spec, *args, **kwargs):
            out = orig_create(spec, *args, **kwargs)
            raw = server._table_locks[spec.name]
            if not isinstance(raw, _TrackedLock):
                server._table_locks[spec.name] = \
                    self.wrap(raw, f"table:{spec.name}")
            return out

        server.create_table = create_table

    @classmethod
    @contextlib.contextmanager
    def instrument(cls) -> Iterator["LockTracker"]:
        """Patch ``StoreServer.__init__`` so every server constructed in
        the ``with`` block is attached to one shared tracker — how the
        chaos suite wires the witness in without touching call sites."""
        from .server import StoreServer
        tracker = cls()
        orig_init = StoreServer.__init__

        def init(self, *args, **kwargs):
            orig_init(self, *args, **kwargs)
            tracker.attach(self)

        StoreServer.__init__ = init  # type: ignore[method-assign]
        try:
            yield tracker
        finally:
            StoreServer.__init__ = orig_init  # type: ignore[method-assign]

    # -- recording -----------------------------------------------------------

    def _stack(self) -> list[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def _note_acquire(self, name: str) -> None:
        stack = self._stack()
        with self._mu:
            for held in stack:
                if held != name:
                    self._edges.setdefault(held, set()).add(name)
        stack.append(name)

    def _note_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def note_acquire(self, name: str) -> None:
        """Public recording hook (tests build synthetic graphs with it)."""
        with self._mu:
            self._names.add(name)
        self._note_acquire(name)

    def note_release(self, name: str) -> None:
        self._note_release(name)

    # -- the graph -----------------------------------------------------------

    def edges(self) -> dict[str, tuple[str, ...]]:
        with self._mu:
            return {k: tuple(sorted(v)) for k, v in self._edges.items()}

    def find_cycle(self) -> list[str] | None:
        """A witnessed cycle as ``[a, b, ..., a]``, or None."""
        edges = self.edges()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in
                 set(edges) | {d for v in edges.values() for d in v}}
        path: list[str] = []

        def dfs(node: str) -> list[str] | None:
            color[node] = GRAY
            path.append(node)
            for nxt in edges.get(node, ()):
                if color[nxt] == GRAY:
                    return path[path.index(nxt):] + [nxt]
                if color[nxt] == WHITE:
                    cyc = dfs(nxt)
                    if cyc is not None:
                        return cyc
            path.pop()
            color[node] = BLACK
            return None

        for node in sorted(color):
            if color[node] == WHITE:
                cyc = dfs(node)
                if cyc is not None:
                    return cyc
        return None

    def assert_acyclic(self) -> None:
        cyc = self.find_cycle()
        if cyc is not None:
            raise LockCycleError(
                "lock-order cycle witnessed: " + " -> ".join(cyc)
                + f" (full graph: {self.edges()})")
