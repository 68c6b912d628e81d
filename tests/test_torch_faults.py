"""Port parity for fault recovery at the store level, and the fault-cost
simulator.

Each store cell of ``tests/test_faults.py`` runs here in BOTH packages on
the same inputs (values built from the same numbers, the same
``FaultEvent``s, the reference's fast ``RetryPolicy``):

* transient ``unavailable`` windows on ``put`` and ``sample`` are retried
  and counted, and an exhausted policy raises;
* ``apply_chunk``'s acknowledged-id set makes a duplicate chunk a no-op,
  a new id re-applies the same payload, and a dropped plus a duplicated
  capture chunk converge to the fault-free table;
* a store ``restart`` replays the write-ahead log (deletes too) from the
  last ``snapshot``, which truncates the tail and survives two restarts;
* ``snapshot``/``restore`` round trips, a write after the snapshot never
  reaching the restored image, on a whole and on a 2-rank sharded slab
  (the port's; the reference's sharded case needs two devices);
* a declared crash fires exactly once.

Every table (slab, keys, version, ptr, count) is equal across the two
packages byte for byte (keys compared as integers: uint32 in the
reference, int64 in the port), and equal to its own fault-free run.

The simulator: for ``FaultPlan.random`` seeds 0–8, at the shapes the
reference's chaos grids draw (``tests/test_plan_properties.py``), the
port draws the same events, and ``simulate_overhead`` gives the same
per-component overheads and totals on the same schedules.  Pure host
code: milliseconds.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Client as JClient
from repro.core import StoreServer as JServer
from repro.core import TableSpec as JTableSpec
from repro.core import faults as jfaults
from repro.core import store as JS


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TClient, TServer, TTableSpec, tfaults, TS, data_mesh
    global slab_sharding
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.core import faults as tfaults
    from repro_torch.core import store as TS
    from repro_torch.parallel.sharding import data_mesh, slab_sharding
    torch.set_num_threads(1)


#: the reference tests' fast retry: nothing sleeps for long
FAST = dict(interval=1e-4, max_interval=1e-3)
CAP = 8


class _Pkg:
    """One package's side of a cell: servers, clients, values, events."""

    def __init__(self, name: str):
        self.name = name
        self.jax = name == "jax"
        self.faults = jfaults if self.jax else tfaults

    def server(self, *events, retry=None, table=True, armed=True):
        f = self.faults
        plan = f.FaultPlan(events=tuple(f.FaultEvent(**e) for e in events),
                           retry=retry or f.RetryPolicy(**FAST)) \
            if armed else None
        srv = JServer(faults=plan) if self.jax \
            else TServer(faults=plan, device="cpu")
        if table:
            srv.create_table((JTableSpec if self.jax else TTableSpec)(
                "t", shape=(3,), capacity=CAP, engine="ring"))
        return srv

    def client(self, srv):
        return (JClient if self.jax else TClient)(srv)

    def full(self, v, n=3):
        return jnp.full((n,), float(v)) if self.jax \
            else torch.full((n,), float(v))

    def fill(self, client, n, start=0):
        for i in range(start, start + n):
            client.put_tensor(f"x{i}", self.full(i), table="t")
        return client

    def table(self, srv, name="t") -> list:
        """slab, keys, version, ptr, count as numpy (keys as int64)."""
        st = srv.checkout(name)
        if self.jax:
            out = [np.asarray(x) for x in st]
        else:
            slab = st.slab
            if isinstance(slab, TS.ShardedSlab):
                slab = torch.cat(slab.shards)
            out = [t.numpy() for t in (slab, *st[1:])]
        out[1] = out[1].astype(np.int64)
        return out

    def chunk(self, n=3, start=0):
        keys = np.arange(start, start + n)
        vals = np.stack([np.full((3,), float(start + i), np.float32)
                         for i in range(n)])
        if self.jax:
            return (jnp.asarray(keys, JS.KEY_DTYPE), jnp.asarray(vals),
                    jnp.ones((n,), bool))
        return (torch.as_tensor(keys), torch.as_tensor(vals),
                torch.ones(n, dtype=torch.bool))

    def capture_chunks(self, *events):
        """Two 3-step capture chunks (the producer's fused path)."""
        srv = self.server(*events)
        client = self.client(srv)
        S = JS if self.jax else TS

        def step(c, t):
            return c, S.make_key(0, t), self.full(1.0) * t

        carry = jnp.zeros(()) if self.jax else torch.zeros(())
        for base in range(0, 6, 3):
            client.capture_scan("t", step, carry, 3, t0=base)
        return srv, client


PKGS = ("jax", "torch")


def _both(fn):
    """``fn(pkg)`` in each package → ``{name: result}``."""
    return {name: fn(_Pkg(name)) for name in PKGS}


def _assert_tables_equal(*tables):
    first = tables[0]
    for other in tables[1:]:
        for a, b in zip(first, other):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Transient unavailability
# ---------------------------------------------------------------------------

def test_put_window_retried_and_counted():
    def cell(p):
        srv = p.server(dict(kind="unavailable", verb="put", at=0, count=2))
        client = p.client(srv)
        client.put_tensor("x", p.full(1.0), table="t")
        _, found = client.get_tensor("x", table="t")
        st = srv.stats()
        return (bool(found), client.retries, st["retries"],
                st["faults_injected"], srv.watermark("t")), p.table(srv)

    out = _both(cell)
    assert out["jax"][0] == out["torch"][0] == (True, 2, 2, 2, 1)
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_retry_exhaustion_raises():
    def cell(p):
        srv = p.server(dict(kind="unavailable", verb="put", at=0, count=99),
                       retry=p.faults.RetryPolicy(max_attempts=3,
                                                  interval=1e-5,
                                                  max_interval=1e-4))
        client = p.client(srv)
        with pytest.raises(p.faults.StoreUnavailable):
            client.put_tensor("x", p.full(1.0), table="t")
        return client.retries, srv.watermark("t"), srv.op_count

    assert _both(cell) == {"jax": (2, 0, 0), "torch": (2, 0, 0)}


def test_sample_window_absorbed():
    """The second ``sample`` attempt fails once and is retried; the port's
    draw gives back the reference's ranks."""
    def cell(p):
        srv = p.server(dict(kind="unavailable", verb="sample", at=1))
        client = p.fill(p.client(srv), 4)
        if p.jax:
            k = jax.random.key(0)
            outs = [client.sample_batch("t", 2, k) for _ in range(2)]
        else:
            draw = torch.tensor([0.1, 0.6])
            outs = [client.sample_batch("t", 2, draw) for _ in range(2)]
        vals = outs[1][0]
        return (tuple(vals.shape), client.retries,
                srv.stats()["faults_injected"], srv.op_count)

    assert _both(cell) == {"jax": ((2, 3), 1, 1, 6),
                           "torch": ((2, 3), 1, 1, 6)}


# ---------------------------------------------------------------------------
# Exactly-once chunk delivery
# ---------------------------------------------------------------------------

def test_duplicate_chunk_id_is_deduplicated():
    def cell(p):
        srv = p.server()
        keys, vals, mask = p.chunk()
        with srv.capture("t") as txn:
            srv.apply_chunk("t", (0, 0), txn, keys, vals, mask, puts=3)
        before = p.table(srv)
        with srv.capture("t") as txn:     # the same id: a no-op
            srv.apply_chunk("t", (0, 0), txn, keys, vals, mask, puts=3)
        _assert_tables_equal(before, p.table(srv))
        return (srv.watermark("t"), srv.watermark_device("t"),
                srv.op_count), p.table(srv)

    out = _both(cell)
    assert out["jax"][0] == out["torch"][0] == (3, 3, 2)
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_same_payload_new_id_applies():
    """``put_masked`` is not idempotent: a new id applies the same bytes
    again (ptr and count advance), which is why dedup keys on the id."""
    def cell(p):
        srv = p.server()
        keys, vals, mask = p.chunk()
        for seq in range(2):
            with srv.capture("t") as txn:
                srv.apply_chunk("t", (0, seq), txn, keys, vals, mask,
                                puts=3)
        return (srv.watermark("t"), srv.watermark_device("t")), p.table(srv)

    out = _both(cell)
    assert out["jax"][0] == out["torch"][0] == (6, 6)
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_drop_and_dup_converge_to_baseline():
    """A dropped first chunk (retried under the same id) and a duplicated
    second one leave the fault-free table, in both packages."""
    faults = (dict(kind="drop_chunk", table="t", at=0),
              dict(kind="dup_chunk", table="t", at=2))

    def cell(p):
        base, _ = p.capture_chunks()
        srv, client = p.capture_chunks(*faults)
        _assert_tables_equal(p.table(base), p.table(srv))
        st = srv.stats()
        return (client.retries, st["faults_injected"], srv.watermark("t"),
                st["staged_transfers"], srv.op_count), p.table(srv)

    out = _both(cell)
    assert out["jax"][0] == out["torch"][0] == (1, 2, 6, 0, 2)
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_collect_scans_match_reference():
    """``capture_scan_collect[_multi]``'s chunk equals the reference's
    (keys, values, mask), and its masked replay equals ``capture_scan``,
    at emit_every 1 and 3 with a ``t0`` phase, one rank and three."""
    vals = np.random.default_rng(0).standard_normal((16, 3)).astype(
        np.float32)
    jspec = JTableSpec("t", shape=(3,), capacity=5)
    tspec = TTableSpec("t", shape=(3,), capacity=5)

    def jstep(c, t):
        return c + 1, JS.make_key(0, t), jnp.asarray(vals)[t]

    def tstep(c, t):
        return c + 1, TS.make_key(0, t), torch.as_tensor(vals[t])

    def jmulti(c, r, t):
        return c + 1, JS.make_key(r, t), jnp.asarray(vals)[t] + r

    def tmulti(c, r, t):
        return c + 1, TS.make_key(r, t), torch.as_tensor(vals[t]) + r

    for every, t0, length in ((1, 0, 7), (3, 1, 8)):
        jc, jk, jv, jm = JS.capture_scan_collect(jspec, jstep, jnp.int32(0),
                                                 length, every, t0=t0)
        tc, tk, tv, tm = TS.capture_scan_collect(tspec, tstep,
                                                 torch.tensor(0), length,
                                                 every, t0=t0)
        assert int(jc) == int(tc) == length
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        whole, _ = TS.capture_scan(tspec, TS.init_table(tspec, device="cpu"),
                                   tstep, torch.tensor(0), length, every,
                                   t0=t0)
        replay = TS.put_masked(tspec, TS.init_table(tspec, device="cpu"),
                               tk, tv, tm)
        assert all(torch.equal(a, b) for a, b in zip(whole, replay))
        jc, jk, jv, jm = JS.capture_scan_collect_multi(
            jspec, jmulti, jnp.zeros((3,), jnp.int32), length, 3, every,
            t0=jnp.asarray([t0, t0 + 1, t0 + 2]))
        tc, tk, tv, tm = TS.capture_scan_collect_multi(
            tspec, tmulti, torch.zeros(3, dtype=torch.int32), length, 3,
            every, t0=[t0, t0 + 1, t0 + 2])
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


# ---------------------------------------------------------------------------
# Store restart + WAL replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("events, n, extra_ops, recoveries", [
    ((dict(kind="restart", table="t", at=3),), 5, 3, 1),
    # only the commits after the snapshot replay
    ((dict(kind="snapshot", table="t", at=2),
      dict(kind="restart", table="t", at=5)), 6, 3, 1),
    # the parked image survives a second restart
    ((dict(kind="snapshot", table="t", at=2),
      dict(kind="restart", table="t", at=4),
      dict(kind="restart", table="t", at=6)), 6, 6, 2),
], ids=["restart", "snapshot_truncates", "two_restarts"])
def test_restart_replays_wal(events, n, extra_ops, recoveries):
    def cell(p):
        base = p.server()
        p.fill(p.client(base), n)
        srv = p.server(*events)
        client = p.fill(p.client(srv), n)
        _assert_tables_equal(p.table(base), p.table(srv))
        extra = srv.op_count - base.op_count
        _, found = client.get_tensor("x0", table="t")
        return (extra, srv.stats()["recoveries"], srv.watermark("t"),
                srv.watermark_device("t"), bool(found)), p.table(srv)

    out = _both(cell)
    assert out["jax"][0] == out["torch"][0] \
        == (extra_ops, recoveries, n, n, True)
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_restart_replays_deletes():
    """A tombstone is a logged write: after the restart the deleted key
    stays dead, in both packages."""
    def cell(p):
        srv = p.server(dict(kind="restart", table="t", at=4))
        client = p.fill(p.client(srv), 3)
        client.delete_tensor("x1", table="t")        # commit 4: restart
        _, dead = client.get_tensor("x1", table="t")
        _, live = client.get_tensor("x2", table="t")
        return (bool(dead), bool(live), srv.stats()["recoveries"],
                srv.op_count), p.table(srv)

    out = _both(cell)
    # 3 puts + delete + 4 replayed + 2 gets
    assert out["jax"][0] == out["torch"][0] == (False, True, 1, 10)
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_wal_cut_by_one_entry_differs():
    """The control the recovery claim rests on: replaying the log with
    its last entry cut leaves a different table."""
    p = _Pkg("torch")
    srv = p.server()
    p.fill(p.client(srv), 5)
    want = p.table(srv)
    srv._wal["t"].pop()
    srv._restart_and_recover()
    got = p.table(srv)
    assert srv.watermark("t") == 4
    assert any(not np.array_equal(a, b) for a, b in zip(want, got))


# ---------------------------------------------------------------------------
# snapshot() / restore()
# ---------------------------------------------------------------------------

def _roundtrip(p, srv):
    client = p.fill(p.client(srv), 3)
    snap = srv.snapshot()
    image = [x.copy() for x in p.table(srv)]
    p.fill(client, 3, start=3)                  # writes after the snapshot
    assert srv.watermark("t") == 6
    srv.restore(snap)
    _assert_tables_equal(image, p.table(srv))
    _, found = client.get_tensor("x4", table="t")
    v, found1 = client.get_tensor("x1", table="t")
    if not p.jax:
        # the port restores a copy: writing it leaves the snapshot as it
        # was, so it restores the same bytes again (the reference's later
        # puts donate the restored arrays)
        p.fill(client, 2, start=6)
        srv.restore(snap)
        _assert_tables_equal(image, p.table(srv))
    return (srv.watermark("t"), srv.watermark_device("t"), bool(found),
            bool(found1), np.asarray(v).tolist()), p.table(srv)


def test_snapshot_restore_roundtrip():
    def cell(p):
        return _roundtrip(p, p.server(armed=False))

    out = _both(cell)
    assert out["jax"][0] == out["torch"][0] \
        == (3, 3, False, True, [1.0, 1.0, 1.0])
    _assert_tables_equal(out["jax"][1], out["torch"][1])


def test_snapshot_restore_sharded_slab():
    """A slab split over a 2-rank mesh: every shard is copied, and the
    round trip leaves the bytes of the whole-slab round trip."""
    p = _Pkg("torch")
    srv = p.server(armed=False, table=False)
    spec = TTableSpec("t", shape=(3,), capacity=CAP, engine="ring")
    srv.create_table(spec, slab_sharding=slab_sharding(
        spec, data_mesh(2, devices=["cpu"] * 2)))
    got, table = _roundtrip(p, srv)
    want, whole = _roundtrip(p, p.server(armed=False))
    assert got == want
    _assert_tables_equal(table, whole)
    slab = srv.checkout("t").slab
    assert isinstance(slab, TS.ShardedSlab) and len(slab.shards) == 2
    snap = srv.snapshot()
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(snap["t"].slab.shards, slab.shards))


def test_model_registry_survives_restore():
    p = _Pkg("torch")
    srv = p.server(armed=False)
    srv.set_model("head", lambda prm, x: x @ prm["w"],
                  {"w": torch.ones((3, 2))})
    srv.restore(srv.snapshot())
    assert srv.has_model("head")
    out = srv.run_model("head", torch.arange(3.0))
    np.testing.assert_allclose(out.numpy(), [3.0, 3.0])


# ---------------------------------------------------------------------------
# Crashes
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_crash_fires_exactly_once():
    def cell(p):
        srv = p.server(dict(kind="crash", component="sim", at=2))
        client = p.client(srv)
        client.fault_point("sim", 0)
        client.fault_point("sim", 1)
        with pytest.raises(p.faults.InjectedCrash) as ei:
            client.fault_point("sim", 2)
        client.fault_point("sim", 2)       # the restarted rank passes
        return ei.value.component, ei.value.at, \
            srv.stats()["faults_injected"]

    assert _both(cell) == {"jax": ("sim", 2, 1), "torch": ("sim", 2, 1)}


# ---------------------------------------------------------------------------
# FaultPlan.random and simulate_overhead
# ---------------------------------------------------------------------------

def _events(plan) -> list:
    return [(e.kind, e.table, e.verb, e.at, e.count, e.component)
            for e in plan.events]


def _overheads(per) -> dict:
    return {k: (o.extra_ops, o.extra_staged, o.retries, o.restarts)
            for k, o in per.items()}


def _chaos_shape(seed: int) -> dict:
    """The training chaos grid's draw (``_run_chaos_scenario``)."""
    rng = random.Random(seed)
    return dict(producer_per_verb=rng.random() < 0.3,
                steps=rng.randint(6, 12), emit_every=rng.randint(1, 2),
                chunk=rng.randint(2, 5), epochs=rng.randint(1, 2))


def _serving_shape(seed: int) -> dict:
    """The serving chaos grid's draw (``_run_serving_chaos``)."""
    rng = random.Random(seed)
    return dict(clients=rng.randint(2, 3), requests=rng.randint(2, 4),
                max_batch=rng.randint(1, 4),
                tier=rng.choice(["continuous_batch", "three_step"]),
                order_seed=rng.choice([None, rng.randint(0, 10**6)]))


def _training_schedule(sh: dict) -> list:
    if sh["producer_per_verb"]:
        prod = {"kind": "producer", "name": "producer", "tier": "per_verb",
                "table": "field", "steps": sh["steps"],
                "emit_every": sh["emit_every"], "ranks": 1}
    else:
        prod = {"kind": "producer", "name": "producer",
                "tier": "capture_scan", "table": "field", "overlap": False,
                "n_chunks": -(-sh["steps"] // sh["chunk"])}
    return [prod, {"kind": "trainer", "name": "trainer", "tier": "fused",
                   "table": "field", "epochs": sh["epochs"],
                   "bootstrap": True}]


def _serving_schedule(sh: dict) -> list:
    total = sh["clients"] * sh["requests"]
    return [
        {"kind": "clients", "name": "writers", "tier": "per_verb",
         "table": "sreq", "results": None, "requests": total,
         "submit": True, "collect": False},
        {"kind": "serving", "name": "serving", "tier": sh["tier"],
         "table": "sreq", "results": "sres", "requests": total,
         "n_batches": -(-total // sh["max_batch"])},
        {"kind": "clients", "name": "readers", "tier": "per_verb",
         "table": "sreq", "results": "sres", "requests": total,
         "submit": False, "collect": True}]


@pytest.mark.parametrize("seed", range(9))
def test_random_plans_and_overheads_match_reference(seed):
    """Same seed, same events; same schedule, same predicted overheads and
    totals — for the training grid's and the serving grid's draws, and
    for the default arguments."""
    assert _events(jfaults.FaultPlan.random(seed)) \
        == _events(tfaults.FaultPlan.random(seed))
    sh = _chaos_shape(seed)
    sv = _serving_shape(seed)
    total = sv["clients"] * sv["requests"]
    cases = [
        (dict(tables=("field",), verbs=("put", "capture", "sample"),
              components=("producer", "trainer"), n_events=3,
              max_index=sh["steps"]), _training_schedule(sh)),
        (dict(tables=("sreq", "sres"), verbs=("put", "get", "serve"),
              components=("writers", "serving"), n_events=3,
              max_index=total), _serving_schedule(sv)),
    ]
    for kw, schedule in cases:
        plans = {}
        for name, f in (("jax", jfaults), ("torch", tfaults)):
            retry = f.RetryPolicy(seed=seed, **FAST)
            plans[name] = f.FaultPlan.random(seed, retry=retry, **kw)
        assert _events(plans["jax"]) == _events(plans["torch"])
        assert plans["torch"].retry == tfaults.RetryPolicy(seed=seed, **FAST)
        jper, jtot = jfaults.simulate_overhead(plans["jax"], schedule, False)
        tper, ttot = tfaults.simulate_overhead(plans["torch"], schedule,
                                               False)
        assert _overheads(jper) == _overheads(tper)
        assert jtot == ttot


def test_simulator_refuses_the_overlap_pipeline():
    """The overlap pipeline's walk, once refused, now predicts what the
    reference's does: a drop flushes the in-flight chunk in its own op
    and pays its hop again."""
    schedule = [{"kind": "producer", "name": "p", "tier": "capture_scan",
                 "table": "field", "overlap": True, "n_chunks": 3}]
    for f in (tfaults, jfaults):
        plan = f.FaultPlan(events=(f.FaultEvent("drop_chunk", table="field",
                                                at=1),))
        per, totals = f.simulate_overhead(plan, schedule, True)
        o = per["p"]
        assert (o.extra_ops, o.extra_staged, o.retries) == (1, 1, 1)
        assert totals["faults_injected"] == 1


def test_armed_entry_points_default_to_the_card(monkeypatch):
    """An armed server and session take the card unless told the CPU:
    without one they raise, naming ``device='cpu'``."""
    from repro_torch.insitu import InSituSession, Producer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = tfaults.FaultPlan()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServer(faults=plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InSituSession(
            tables=[TTableSpec("t", shape=(3,), capacity=CAP)],
            components=[Producer(lambda c, r, t: (c, TS.make_key(r, t),
                                                  torch.zeros(3)),
                                 table="t", steps=1, carry=torch.zeros(()))],
            faults=plan)
    assert TServer(faults=plan, device="cpu").device.type == "cpu"
