"""Lock discipline of the port's ``StoreServer``, statically and at run time.

* ``tools/lint``'s lock rules (``rules_locks``: lock-holds, lock-leaf,
  lock-mutation, lock-order), run through ``lint_source`` on
  ``src/repro_torch/core/server.py``, find nothing, and do find a
  guarded-state write added outside any lock (the rules do see the
  port's server: its ``_table_locks`` make it a lock class).
* The port's ``LockTracker`` builds the reference's graph: on a synthetic
  cycle both raise ``LockCycleError`` on the same cycle, and the same
  drive of a live server in each package (verbs, metadata, the two-lock
  serving drain in both argument orders, a recovery replay) realises the
  same acyclic lock-order graph.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

REPO = Path(__file__).resolve().parent.parent
SERVER = REPO / "src" / "repro_torch" / "core" / "server.py"


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file."""
    global torch
    import torch
    torch.set_num_threads(1)


def _lock_rules():
    sys.path.insert(0, str(REPO / "tools"))
    from lint import rules_locks
    from lint.engine import all_rules, lint_source
    rules = [r for r in all_rules()
             if type(r).__module__ == rules_locks.__name__]
    return lint_source, rules


def test_lock_rules_pass_the_port_server():
    lint_source, rules = _lock_rules()
    assert sorted(r.id for r in rules) == ["lock-holds", "lock-leaf",
                                          "lock-mutation", "lock-order"]
    assert lint_source(SERVER.read_text(), str(SERVER), rules) == []


def test_lock_rules_see_an_unlocked_write_in_the_port_server():
    lint_source, rules = _lock_rules()
    src = SERVER.read_text()
    anchor = "    def get_meta(self, name: str, default=None):\n"
    assert anchor in src
    bad = src.replace(anchor, "    def drop(self, table: str) -> None:\n"
                              "        self._state.pop(table)\n\n" + anchor)
    found = lint_source(bad, str(SERVER), rules)
    assert [f.rule for f in found] == ["lock-mutation"], found


def _trackers():
    from repro.core.locktrack import LockCycleError as JCycle
    from repro.core.locktrack import LockTracker as JTracker
    from repro_torch.core.locktrack import LockCycleError as TCycle
    from repro_torch.core.locktrack import LockTracker as TTracker
    return {"jax": (JTracker, JCycle), "torch": (TTracker, TCycle)}


def test_cycle_fixture_matches_the_reference():
    seen = {}
    for pkg, (Tracker, Cycle) in _trackers().items():
        tracker = Tracker()
        for a, b in (("A", "B"), ("B", "C")):
            tracker.note_acquire(a)
            tracker.note_acquire(b)
            tracker.note_release(b)
            tracker.note_release(a)
        tracker.assert_acyclic()
        tracker.note_acquire("C")
        tracker.note_acquire("A")          # closes A -> B -> C -> A
        tracker.note_release("A")
        tracker.note_release("C")
        with pytest.raises(Cycle) as err:
            tracker.assert_acyclic()
        seen[pkg] = (tracker.edges(), tracker.find_cycle(), str(err.value))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == ["A", "B", "C", "A"]


def _drive(pkg: str):
    """The reference's live-server drive in ``pkg``, under its tracker."""
    Tracker, _ = _trackers()[pkg]
    if pkg == "jax":
        from repro.core import StoreServer, TableSpec
        from repro.core import store as S
        from repro.core.faults import FaultPlan
        ones, kw = (lambda: jnp.ones((2,))), {}
        keys = jnp.asarray([S.name_key("x")], S.KEY_DTYPE)
        mask = jnp.asarray([True])
    else:
        from repro_torch.core import StoreServer, TableSpec
        from repro_torch.core import store as S
        from repro_torch.core.faults import FaultPlan
        ones, kw = (lambda: torch.ones(2)), {"device": "cpu"}
        keys = torch.tensor([S.name_key("x")])
        mask = torch.tensor([True])
    with Tracker.instrument() as tracker:
        srv = StoreServer(faults=FaultPlan(), **kw)
        for name in ("a", "b"):
            srv.create_table(TableSpec(name, shape=(2,), capacity=8,
                                       engine="hash"))
        srv.put("a", S.name_key("x"), ones())
        srv.get("a", S.name_key("x"))
        srv.put_meta("ready", 1)
        assert srv.get_meta("ready") == 1
        apply_fn = lambda p, x: x  # noqa: E731
        srv.serve_batch("a", "b", keys, mask, apply_fn, None)
        srv.serve_batch("b", "a", keys, mask, apply_fn, None)
        srv._restart_and_recover()
    tracker.assert_acyclic()
    return tracker.edges()


def test_live_server_graph_matches_the_reference():
    edges = _drive("torch")
    assert edges == _drive("jax")
    assert "server._ops_lock" in edges["table:a"]
    assert "table:b" in edges["table:a"]
    assert "table:a" not in edges.get("table:b", ())


def test_instrument_restores_the_port_server_init():
    from repro_torch.core.locktrack import LockTracker
    from repro_torch.core.server import StoreServer
    orig = StoreServer.__init__
    with LockTracker.instrument():
        assert StoreServer.__init__ is not orig
    assert StoreServer.__init__ is orig
