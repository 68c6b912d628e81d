"""Port parity for the clustered deployment: ``core.deployment.Clustered``
with its staging verbs, the two-slot overlap pipeline, the staged
clustered gather, the fault simulator's overlap walk, the plan's staged
predictions and contention model, and tier ``slab_sharded_clustered``.

* ``tests/test_clustered.py``'s ``TestStagedTelemetry``,
  ``TestDeploymentEdges`` and ``test_chaos_restage_parity`` in both
  packages on the degenerate shared-device ``make_clustered_1d()`` (the
  port's on ``["cpu"]``): tables byte-identical across the packages,
  ``staged_transfers``, ``op_count``, watermarks and retries equal.
* Overlap on vs off byte-identical, with and without ring wrap and masked
  tails, the overlap costing exactly the one drain op.
* ``_fit_spec``'s fitting and its error; a staged element laid out by the
  fitted spec; every stage a copy, never the caller's buffer.
* ``ContentionModel.fit`` / ``predict_steps_per_s`` / ``residual`` and
  ``autotune_chunk`` equal to the reference's on the same cells.
* ``simulate_overhead`` on overlapped clustered schedules equal to the
  reference's for ``FaultPlan.random`` seeds 0–99.
* A clustered session's ``plan().explain()`` (staged keys, fan-in,
  autotuned chunk, predicted steps/s, restage and replay under a fault
  plan) equal to the reference's.
* ONE reference subprocess with four forced host devices: the
  reference's ``slab_sharded_clustered`` epochs on a real 2 + 2 split,
  their draws fed to the port's on ``["cpu"] * 4``: params rtol 2e-5 /
  atol 1e-6, train loss 1e-5, val loss and relative error 1e-4 (the
  reference's mesh tolerances, ``tests/test_sharded_epoch.py:62-65``),
  ``staged_transfers`` and ``op_count`` equal; and the port's clustered
  epochs ``torch.equal`` to its own ``slab_sharded`` on the same draws.
* A clustered CPU session with a slab-sharded trainer runs as planned:
  ``op_count``, ``staged_transfers`` and each component's staged delta
  equal to the plan, and ``plan(hlo=True)``'s counted collectives held to
  the predictions.

The reference subprocess's time is recorded as the junit property
``reference_subprocess_s``.
"""

import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from conftest import run_subprocess
from repro.core import Client as JClient
from repro.core import StoreServer as JServer
from repro.core import TableSpec as JSpec
from repro.core import deployment as jdep
from repro.core import faults as jfaults
from repro.core import store as JS
from repro.insitu import InferenceConsumer as JInference
from repro.insitu import InSituSession as JSession
from repro.insitu import Producer as JProducer
from repro.insitu import ServingClients as JClients
from repro.insitu import ServingConsumer as JServing
from repro.insitu import plan as jplan

TESTS = Path(__file__).resolve().parent
FAST = dict(interval=1e-4, max_interval=1e-3)
# the epoch parity config: a one-block autoencoder at 64 points, so the
# reference's clustered epoch compiles in seconds
N, CAP, PUTS, GATHER, BATCH, EPOCHS, SEED = 64, 16, 20, 6, 4, 2, 3
_AE = dict(n_points=N, channels=4, internal=4, latent=4, blocks=1, pool=4,
           mlp_width=8, mlp_depth=2)


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection (every xdist worker collects every test file)."""
    global torch, TS, TServer, TClient, dep, tfaults, tplan, ttr, tae, topt
    global data_mesh, slab_sharding, ElemShards, C, TSession, TProducer
    global TTrainer, TInference, TClients, TServing, tree_leaves
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import deployment as dep
    from repro_torch.core import faults as tfaults
    from repro_torch.core import store as TS
    from repro_torch.insitu import InferenceConsumer as TInference
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import ServingClients as TClients
    from repro_torch.insitu import ServingConsumer as TServing
    from repro_torch.insitu import TrainerConsumer as TTrainer
    from repro_torch.insitu import plan as tplan
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import trainer as ttr
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import (ElemShards, data_mesh,
                                               slab_sharding)
    from repro_torch.train import optimizer as topt
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# one cell in each package
# ---------------------------------------------------------------------------

class _Pkg:
    """One package's side of a cell on the degenerate shared-device
    clustered deployment."""

    def __init__(self, name: str):
        self.jax = name == "jax"
        self.faults = jfaults if self.jax else tfaults

    def clustered(self, **kw):
        if self.jax:
            return jdep.make_clustered_1d(**kw)
        return dep.make_clustered_1d(devices=["cpu"], **kw)

    def server(self, deployment="clustered", faults=None, **kw):
        if deployment == "clustered":
            deployment = self.clustered(**kw)
        if self.jax:
            return JServer(deployment, faults=faults)
        return TServer(deployment, faults=faults, device="cpu")

    def spec(self, name="t", shape=(3,), capacity=8):
        return (JSpec if self.jax else TS.TableSpec)(name, shape=shape,
                                                     capacity=capacity)

    def client(self, srv):
        return (JClient if self.jax else TClient)(srv)

    def step(self, c, t):
        if self.jax:
            return c + 1.0, JS.make_key(0, t), jnp.full((3,), t, jnp.float32)
        return c + 1.0, TS.make_key(0, t), torch.full((3,), float(t))

    def zero(self):
        return jnp.zeros(()) if self.jax else torch.zeros(())

    def arr(self, x):
        return jnp.asarray(x) if self.jax else torch.as_tensor(x)

    def key(self, t):
        return (JS if self.jax else TS).make_key(0, t)


def _pkgs():
    return _Pkg("jax"), _Pkg("torch")


def _state(srv, table="t"):
    """A table's state as numpy (an element- or slot-sharded port slab
    reassembled; keys as uint32)."""
    st = srv.checkout(table)
    if isinstance(srv, JServer):
        slab = np.asarray(st.slab)
        return [slab, np.asarray(st.keys), np.asarray(st.version),
                int(st.ptr), int(st.count)]
    return [TS.whole_slab(st.slab).numpy(),
            st.keys.numpy().astype(np.uint32), st.version.numpy(),
            int(st.ptr), int(st.count)]


def _assert_same(a, b):
    for x, y in zip(_state(a), _state(b)):
        np.testing.assert_array_equal(x, y)


def _counts(srv):
    st = srv.stats()
    return (st["op_count"], st["staged_transfers"], st["watermarks"],
            st["faults_injected"])


# ---------------------------------------------------------------------------
# staged telemetry (tests/test_clustered.py::TestStagedTelemetry)
# ---------------------------------------------------------------------------

def _fused_chunk(p, srv):
    cli = p.client(srv)
    cli.capture_scan("t", p.step, p.zero(), 10, emit_every=2)
    mid = _counts(srv)
    cli.drain_captures("t")
    return mid


def _per_verb(p, srv):
    for t in range(3):
        srv.put("t", p.key(t), p.arr(np.ones(3, np.float32)))


def _batched(p, srv):
    ktype = np.uint32 if p.jax else np.int64
    srv.put_many("t", p.arr(np.arange(4, dtype=ktype)),
                 p.arr(np.ones((4, 3), np.float32)))
    mid = _counts(srv)
    srv.put_stream("t", p.arr(np.arange(6, dtype=ktype).reshape(3, 2)),
                   p.arr(np.arange(18, dtype=np.float32).reshape(3, 2, 3)))
    return mid


def _sample_staged(p, srv):
    srv.put("t", p.key(0), p.arr(np.arange(3, dtype=np.float32)))
    before = _counts(srv)
    if p.jax:
        vals, ok = srv.sample_staged("t", jax.random.key(0), 4)
    else:
        vals, ok = srv.sample_staged("t", torch.rand(4))
    assert bool(ok) and tuple(vals.shape) == (4, 3)
    np.testing.assert_array_equal(np.asarray(vals),
                                  np.tile(np.arange(3.0), (4, 1)))
    return before


@pytest.mark.parametrize("case,want", [
    (_fused_chunk, ((1, 1), (2, 1, 5))),     # ONE hop for 5 puts; drain
    (_per_verb, (None, (3, 3, 3))),
    (_batched, ((1, 1), (2, 2, 10))),
    (_sample_staged, ((1, 1), (2, 2, 1))),
])
def test_staged_telemetry_matches_reference(case, want):
    """Each verb stages where the reference stages, counts what it
    counts, and leaves the reference's table byte for byte."""
    got = {}
    for p in _pkgs():
        srv = p.server()
        srv.create_table(p.spec())
        mid = case(p, srv)
        got[p.jax] = (mid, _counts(srv), srv)
    (jmid, jend, jsrv), (tmid, tend, tsrv) = got[True], got[False]
    assert (jmid, jend) == (tmid, tend)
    mid, (ops, staged, wm) = want
    if mid is not None:
        assert tmid[:2] == mid
    assert tend[:2] == (ops, staged) and tend[2]["t"] == wm
    _assert_same(jsrv, tsrv)


def test_fused_chunk_equals_local_replay():
    """The staged, drained chunk equals the local store's capture."""
    p = _Pkg("torch")
    srv = p.server()
    srv.create_table(p.spec())
    _fused_chunk(p, srv)
    local = p.server(deployment=None)
    local.create_table(p.spec())
    p.client(local).capture_scan("t", p.step, p.zero(), 10, emit_every=2)
    _assert_same(srv, local)
    assert local.stats()["staged_transfers"] == 0


def test_local_and_colocated_never_stage():
    """The reference's twin fails at its co-located put
    (``src/repro/core/store.py:249``, ``ROADMAP.md`` A5.1); the port's
    local and co-located servers stage nothing on the same verbs."""
    p = _Pkg("torch")
    for d in (None, dep.Colocated(data_mesh(1, devices=["cpu"]))):
        srv = p.server(deployment=d)
        srv.create_table(p.spec())
        srv.put("t", p.key(0), torch.ones(3))
        p.client(srv).capture_scan("t", p.step, p.zero(), 4)
        srv.sample_staged("t", torch.rand(2))
        assert srv.stats()["staged_transfers"] == 0


# ---------------------------------------------------------------------------
# deployment edges (tests/test_clustered.py::TestDeploymentEdges)
# ---------------------------------------------------------------------------

def test_split_devices_and_fan_in_match_reference():
    devs = list(range(8))
    for frac in (0.0, 0.25, 0.5, 1.0):
        assert dep.split_devices(devs, frac) == \
            jdep.split_devices(devs, frac)
    assert dep.split_devices([42], 0.5) == ([42], [42])
    for clients, db, expect in [(1, 3, 1), (3, 1, 3), (3, 2, 2), (7, 2, 4),
                                (4, 4, 1), (5, 3, 2)]:
        d = dep.Clustered(data_mesh(clients, devices=["cpu"] * clients),
                          data_mesh(db, devices=["cpu"] * db))
        assert d.fan_in == expect == jdep.fan_in_ratio(clients, db)
        assert tplan.fan_in_ratio is dep.fan_in_ratio
    for kw in ({}, {"overlap": False}, {"slab_axis": "data"}):
        assert _Pkg("torch").clustered(**kw).describe() \
            == _Pkg("jax").clustered(**kw).describe()
    ns = {}
    exec("from repro_torch.core.deployment import *", ns)
    assert callable(ns["make_clustered_1d"]) \
        and callable(ns["StagingPipeline"])


def test_fit_spec_matches_reference():
    mesh = SimpleNamespace(shape={"data": 2})
    for parts, shape in [(("data",), (4,)), (("data",), (3,)),
                         ((None, "data"), (3, 6)), (("data", None), (3, 6)),
                         ((), (4, 4)), ((None, "data", None), (2, 8, 8))]:
        assert dep._fit_spec(parts, shape, mesh) \
            == tuple(jdep._fit_spec(parts, shape, mesh))
    for fit in (dep._fit_spec, jdep._fit_spec):
        with pytest.raises(ValueError, match="more entries than the "
                                             "element rank"):
            fit(("data", None), (4,), mesh)


def test_staging_is_a_copy_in_the_fitted_layout():
    """``stage`` lands in the table's fitted layout (a non-dividing dim
    falls back to whole); every hop copies, never aliasing the caller's
    buffer; a slab axis that collides with the element layout raises."""
    d = dep.make_clustered_1d(devices=["cpu"] * 4, db_fraction=0.5,
                              elem_spec=("data", None))
    spec = TS.TableSpec("t", shape=(4, 6), capacity=4)
    x = torch.arange(24.0).reshape(4, 6)
    staged = d.stage(x, spec)
    assert isinstance(staged, ElemShards) and len(staged.blocks) == 2
    assert torch.equal(torch.cat(staged.blocks), x)
    x += 1                                    # the caller writes again
    assert torch.equal(torch.cat(staged.blocks), x - 1)
    odd = TS.TableSpec("o", shape=(3, 6), capacity=4)
    assert d.elem_sharding(odd).spec == (None, None)
    whole = d.stage(torch.ones(3, 6), odd)
    assert torch.is_tensor(whole) and whole.shape == (3, 6)
    k, v, m = d.stage_chunk(torch.arange(2), torch.zeros(2, 4, 6),
                            torch.ones(2, dtype=torch.bool), spec)
    assert isinstance(v, ElemShards) and v.blocks[0].shape == (2, 2, 6)
    vals = torch.ones(2, 3)
    back, ok = d.stage_to_clients((vals, torch.ones((), dtype=torch.bool)))
    assert torch.equal(back, vals) and back.data_ptr() != vals.data_ptr()
    with pytest.raises(ValueError, match="more entries"):
        d.elem_sharding(TS.TableSpec("r", shape=(4,), capacity=4))
    for make in (jdep.make_clustered_1d, dep.make_clustered_1d):
        kw = {} if make is jdep.make_clustered_1d \
            else {"devices": ["cpu"] * 4}
        with pytest.raises(ValueError, match="disjoint mesh axes"):
            make(db_fraction=0.5, elem_spec=("data",), slab_axis="data",
                 **kw)
    with pytest.raises(ValueError, match="own axes"):
        dep.make_clustered_2d((None, "slab"), devices=["cpu"] * 4)


# ---------------------------------------------------------------------------
# the overlap pipeline (tests/test_clustered.py::TestOverlapPipeline)
# ---------------------------------------------------------------------------

def _pipeline_run(p, overlap, *events, capacity=16, length=8, emit_every=2,
                  n_chunks=3):
    plan = p.faults.FaultPlan(events=tuple(
        p.faults.FaultEvent(*e[:1], **e[1]) for e in events),
        retry=p.faults.RetryPolicy(**FAST))
    srv = p.server(faults=plan, overlap=overlap)
    srv.create_table(p.spec(capacity=capacity))
    cli = p.client(srv)
    for i in range(n_chunks):
        cli.capture_scan("t", p.step, p.zero(), length,
                         emit_every=emit_every, t0=i * length)
    cli.drain_captures("t")
    return srv, cli


@pytest.mark.parametrize("capacity,length,wm", [
    (16, 8, 12), (16, 7, 11), (4, 8, 12), (4, 7, 11)])
def test_overlap_matches_serial_and_reference(capacity, length, wm):
    """Divisible and masked-tail chunks, with and without ring wrap: the
    overlapped run equals the serial one and the reference's byte for
    byte, with the same hops; the overlap costs exactly the drain op."""
    runs = {(p.jax, ov): _pipeline_run(p, ov, capacity=capacity,
                                       length=length)[0]
            for p in _pkgs() for ov in (True, False)}
    ov, se = runs[(False, True)], runs[(False, False)]
    _assert_same(ov, se)
    _assert_same(ov, runs[(True, True)])
    assert ov.watermark("t") == wm == int(ov.checkout("t").count)
    assert ov.stats()["staged_transfers"] == se.stats()["staged_transfers"] \
        == 3
    assert ov.stats()["op_count"] == se.stats()["op_count"] + 1
    for key in runs:
        assert _counts(runs[key]) == _counts(
            runs[(not key[0], key[1])])


def test_chaos_restage_parity():
    """A dropped transfer mid-pipeline forces the drain-on-restage flush,
    a later duplicate is deduplicated: both schedules in both packages
    retry under the same chunk id and land byte-identical to each other
    and to the fault-free run, with the drop and the dup's extra hops."""
    events = (("drop_chunk", dict(table="t", at=1)),
              ("dup_chunk", dict(table="t", at=3)))
    base = _pipeline_run(_Pkg("torch"), True, capacity=8)[0]
    runs = {}
    for p in _pkgs():
        for ov in (True, False):
            srv, cli = _pipeline_run(p, ov, *events, capacity=8)
            runs[(p.jax, ov)] = srv
            assert cli.retries == 1
            assert srv.stats()["faults_injected"] == 2
            assert srv.stats()["staged_transfers"] == 5
            assert srv.watermark("t") == base.watermark("t")
    for key, srv in runs.items():
        _assert_same(srv, base)
        assert _counts(srv) == _counts(runs[(not key[0], key[1])])
    # the drop flushes the in-flight chunk in its own op
    assert runs[(False, True)].stats()["op_count"] == \
        runs[(False, False)].stats()["op_count"] + 2


def test_staging_pipeline_slots():
    pipe = dep.StagingPipeline()
    assert not pipe.pending and pipe.swap("a") is None and pipe.pending
    assert pipe.swap("b") == "a" and pipe.drain() == "b"
    assert pipe.drain() is None and not pipe.pending


# ---------------------------------------------------------------------------
# the contention model and the chunk autotuner
# ---------------------------------------------------------------------------

CELLS = [{"fan_in": 1, "steps_per_s": 410.0, "step_bytes": 262144},
         {"fan_in": 2, "steps_per_s": 300.0, "step_bytes": 262144},
         {"fan_in": 3, "steps_per_s": 250.0, "step_bytes": 262144}]


def test_contention_model_and_autotune_match_reference():
    tm, jm = tplan.ContentionModel.fit(CELLS), jplan.ContentionModel.fit(
        CELLS)
    assert (tm.t_base, tm.k_fanin, tm.step_bytes) == \
        (jm.t_base, jm.k_fanin, jm.step_bytes)
    for f in (1, 2, 3, 4):
        assert tm.predict_steps_per_s(f) == jm.predict_steps_per_s(f)
    assert tm.residual(CELLS) == jm.residual(CELLS)
    neg = [{"fan_in": 1, "steps_per_s": 100.0},
           {"fan_in": 2, "steps_per_s": 400.0}]
    for P in (tplan, jplan):
        with pytest.raises(ValueError, match=">= 2 distinct"):
            P.ContentionModel.fit(CELLS[:1])
        with pytest.raises(ValueError, match="non-positive"):
            P.ContentionModel.fit(neg).predict_steps_per_s(9)
    for emit, steps, fan_in, cost in [(1, 256, 1, None), (2, 40, 2, 1e-3),
                                      (1, 100, 3, 5e-2), (4, None, 1, 1e-4),
                                      (1, 256, 9, None)]:
        kw = dict(steps=steps, fan_in=fan_in, dispatch_cost=cost)
        for m in ((tm, jm), (None, None),
                  (tplan.ContentionModel(1e-3, 1e-4, t_dispatch=2e-3),
                   jplan.ContentionModel(1e-3, 1e-4, t_dispatch=2e-3))):
            assert tplan.autotune_chunk(emit, m[0], **kw) \
                == jplan.autotune_chunk(emit, m[1], **kw)


# ---------------------------------------------------------------------------
# the fault simulator's overlap walk
# ---------------------------------------------------------------------------

def _events(plan) -> list:
    return [(e.kind, e.table, e.verb, e.at, e.count, e.component)
            for e in plan.events]


def _overheads(per) -> dict:
    return {k: (o.extra_ops, o.extra_staged, o.retries, o.restarts)
            for k, o in per.items()}


def test_overlap_overheads_match_reference():
    """``FaultPlan.random`` seeds 0–99 over an overlapped clustered
    producer and a staged clustered trainer: the same events, the same
    per-component overheads (restaged hops and drain ops included) and
    totals as the reference's walk."""
    kw = dict(tables=("field",), verbs=("capture", "sample",
                                        "sample_staged"),
              components=("producer", "trainer"), n_events=4, max_index=6)
    for seed in range(100):
        n_chunks = 2 + seed % 4
        schedule = [
            {"kind": "producer", "name": "producer", "tier": "capture_scan",
             "table": "field", "overlap": seed % 5 != 0,
             "n_chunks": n_chunks},
            {"kind": "trainer", "name": "trainer",
             "tier": "slab_sharded_clustered", "table": "field",
             "epochs": 1 + seed % 3, "bootstrap": True}]
        plans = {name: f.FaultPlan.random(seed, retry=f.RetryPolicy(
            seed=seed, **FAST), **kw) for name, f in (("jax", jfaults),
                                                     ("torch", tfaults))}
        assert _events(plans["jax"]) == _events(plans["torch"])
        for crosses in (True, False):
            jper, jtot = jfaults.simulate_overhead(plans["jax"], schedule,
                                                   crosses)
            tper, ttot = tfaults.simulate_overhead(plans["torch"], schedule,
                                                   crosses)
            assert _overheads(jper) == _overheads(tper), seed
            assert jtot == ttot, seed


# ---------------------------------------------------------------------------
# a clustered session's plan against the reference's
# ---------------------------------------------------------------------------

_TINY = dict(n_points=64, channels=4, internal=4, latent=4, blocks=2,
             pool=4, mlp_width=8, mlp_depth=2)


def _plan_session(p, cost_model=None, faults=None):
    """One declaration in ``p``'s package on its degenerate clustered
    deployment: a fused and a per-verb producer, a fused trainer, a
    three-step inference consumer and a three-step serving plane."""
    d = p.clustered()
    d.cost_model = cost_model
    if p.jax:
        from repro.insitu import TrainerConsumer as Train
        from repro.ml import autoencoder as ae
        from repro.ml import trainer as tr
        zeros, S, Prod, Inf, Cl, Sv, Sess, spec = (
            jnp.zeros, JS, JProducer, JInference, JClients, JServing,
            JSession, JSpec)
        kw = {}
    else:
        Train, ae, tr = TTrainer, tae, ttr
        zeros, S, Prod, Inf, Cl, Sv, Sess, spec = (
            torch.zeros, TS, TProducer, TInference, TClients, TServing,
            TSession, TS.TableSpec)
        kw = {"device": "cpu"}
    tcfg = tr.TrainerConfig(ae=ae.AEConfig(**_TINY), epochs=3, gather=4,
                            batch_size=2)

    def step(c, r, t):
        return c, S.make_key(r, t), zeros((4, 64))

    comps = [
        Prod(step, table="field", steps=13, emit_every=2, carry=zeros(())),
        Prod(step, table="field2", steps=5, carry=zeros(()),
             traceable=False, name="slow"),
        Train(tcfg, zeros((64, 3))),
        Inf("encoder", lambda c, s: zeros((64, 4)), steps=3,
            tier="three_step"),
        Cl(lambda c, s: zeros((4,)), table="sreq", clients=2, requests=3,
           collect=False, name="writers"),
        Sv("encoder", table="sreq", results="sres", clients=2, requests=3,
           max_batch=4, tier="three_step"),
        Cl(lambda c, s: zeros((4,)), table="sreq", clients=2, requests=3,
           submit=False, name="readers")]
    tables = [spec("field", shape=(4, 64), capacity=16),
              spec("field2", shape=(4, 64), capacity=8),
              spec("sreq", shape=(4,), capacity=8),
              spec("sres", shape=(4,), capacity=8)]
    return Sess(components=comps, tables=tables, deployment=d,
                faults=faults, **kw).plan()


_KEYS = ("tier", "store_dispatches", "dispatch_detail", "staged_transfers",
         "staged_detail", "chunk", "fan_in", "staged_per_chunk",
         "predicted_steps_per_s", "fault_overhead", "requests",
         "dispatches_per_epoch")


@pytest.mark.parametrize("variant", ["plain", "cost_model", "faults"])
def test_clustered_session_plan_matches_reference(variant):
    """Every component's dispatches, staged hops (by cause), chunk,
    fan-in and predicted steps/s, and the plan's totals, equal to the
    reference's plan of the same declaration."""
    plans = {}
    for p in _pkgs():
        cm = fp = None
        if variant == "cost_model":
            cm = (jplan if p.jax else tplan).ContentionModel.fit(CELLS)
            cm = type(cm)(cm.t_base, cm.k_fanin, t_dispatch=0.05)
        if variant == "faults":
            fp = p.faults.FaultPlan(events=(
                p.faults.FaultEvent("drop_chunk", table="field", at=1),
                p.faults.FaultEvent("dup_chunk", table="field", at=2),
                p.faults.FaultEvent("restart", table="field", at=2)),
                retry=p.faults.RetryPolicy(**FAST))
        plans[p.jax] = _plan_session(p, cm, fp)
    jp, tp = plans[True], plans[False]
    assert (tp.deployment, tp.fan_in, tp.staged_transfers,
            tp.store_dispatches, tp.faults) == \
        (jp.deployment, jp.fan_in, jp.staged_transfers, jp.store_dispatches,
         jp.faults)
    for je, te in zip(jp.components, tp.components):
        jx, tx = je.explain(), te.explain()
        assert {k: tx.get(k) for k in _KEYS} == \
            {k: jx.get(k) for k in _KEYS}, te.name
    if variant == "cost_model":
        assert tp.component("producer").predicted_steps_per_s \
            == jp.component("producer").predicted_steps_per_s is not None
    assert tp.explain()["staged_transfers"] == tp.staged_transfers > 0


# ---------------------------------------------------------------------------
# tier slab_sharded_clustered against the reference on a real 2 + 2 split
# ---------------------------------------------------------------------------

_REFERENCE = """
    import sys, time
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, {tests!r})
    from _torch_parity import np_autoencoder_params
    from repro.core import Client, StoreServer, TableSpec, make_clustered_1d
    from repro.core import store as S
    from repro.ml import autoencoder as ae, trainer as tr
    from repro.train import optimizer as opt

    N, CAP, GATHER, EPOCHS = {N}, {CAP}, {GATHER}, {EPOCHS}
    inputs = np.load({inputs!r})
    snaps = inputs["snaps"]
    aecfg = ae.AEConfig(mode="ref", **{ae!r})
    levels = ae.coords_pyramid(aecfg, jnp.asarray(inputs["coords"]))
    dep = make_clustered_1d(db_fraction=0.5, slab_axis="data")
    srv = StoreServer(dep)
    spec = srv.create_table(TableSpec("field", shape=(4, N), capacity=CAP))
    for i in range(len(snaps)):
        srv.put("field", S.make_key(0, i), jnp.asarray(snaps[i]))
    client = Client(srv)
    tx = opt.adam(1e-3)
    params = jax.tree.map(jnp.asarray, np_autoencoder_params(aecfg, {seed}))
    state = tr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    cfg = tr.TrainerConfig(ae=aecfg, gather=GATHER, batch_size={BATCH},
                           lr=1e-3, mesh=dep.client_mesh, slab_sharded=True,
                           db_mesh=dep.db_mesh, db_axis="data")
    epoch = tr.EPOCH_BUILDERS["slab_sharded_clustered"](cfg, levels, tx,
                                                        spec)
    rep = NamedSharding(dep.client_mesh, P())
    mu = jax.device_put(jnp.asarray(inputs["mu"]), rep)
    sd = jax.device_put(jnp.asarray(inputs["sd"]), rep)
    out = {{}}
    for e in range(EPOCHS):
        state, m = epoch(client, state, jax.random.key(7 + e), mu, sd)
        out[f"metrics{{e}}"] = np.array([float(x) for x in m[:3]])
    for i, leaf in enumerate(jax.tree.leaves(state.params)):
        out[f"param{{i}}"] = np.asarray(leaf)
    st = srv.stats()
    out["counts"] = np.array([st["op_count"], st["staged_transfers"]])
    version = srv.checkout("field").version
    nvalid = jnp.maximum(jnp.sum((version > 0).astype(jnp.int32)), 1)
    out["nvalid"] = np.array(int(nvalid))
    for e in range(EPOCHS):
        k_samp, k_val, k_perm = jax.random.split(jax.random.key(7 + e), 3)
        out[f"ranks{{e}}"] = np.asarray(
            jax.random.randint(k_samp, (GATHER,), 0, nvalid))
        out[f"val_idx{{e}}"] = np.asarray(
            jax.random.randint(k_val, (), 0, GATHER))
        out[f"perm{{e}}"] = np.asarray(
            jax.random.permutation(k_perm, GATHER - 1))
    np.savez({result!r}, **out)
"""


def _snaps() -> np.ndarray:
    return np.random.default_rng(SEED).standard_normal(
        (PUTS, 4, N)).astype(np.float32)


def _coords() -> np.ndarray:
    return np.random.default_rng(1).random((N, 3)).astype(np.float32)


def _sorted_leaves(tree) -> list:
    """Leaves with dict keys sorted (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sorted_leaves(t)]
    return [tree]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One subprocess with four forced host devices (2 client + 2 db):
    the reference's clustered epochs and their draws → an ``.npz``."""
    tmp = tmp_path_factory.mktemp("clustered")
    snaps = _snaps()
    mu = snaps.mean(axis=(0, 2)).astype(np.float32)
    sd = (snaps.std(axis=(0, 2)) + 1e-6).astype(np.float32)
    np.savez(tmp / "inputs.npz", snaps=snaps, coords=_coords(), mu=mu, sd=sd)
    t0 = time.perf_counter()
    run_subprocess(_REFERENCE.format(
        tests=str(TESTS), N=N, CAP=CAP, GATHER=GATHER, EPOCHS=EPOCHS,
        BATCH=BATCH, seed=SEED, ae=_AE, inputs=str(tmp / "inputs.npz"),
        result=str(tmp / "result.npz")), n_devices=4)
    return (dict(np.load(tmp / "result.npz")), time.perf_counter() - t0,
            snaps, mu, sd)


def _port_epochs(tier, snaps, mu, sd, draws):
    """The port's epochs of ``tier`` on a table filled with ``snaps``:
    the clustered tier through a server on a 2 + 2 split of ``"cpu"``,
    ``slab_sharded`` on a 2-rank mesh → ``(state, metrics, server)``."""
    from repro.ml import autoencoder as jae
    jcfg = jae.AEConfig(mode="ref", **_AE)
    cfg_ae = torch_ae_config(jcfg)
    spec = TS.TableSpec("field", shape=(4, N), capacity=CAP)
    if tier == "slab_sharded_clustered":
        d = dep.make_clustered_1d(devices=["cpu"] * 4, db_fraction=0.5,
                                  slab_axis="data")
        mesh, kw = d.client_mesh, dict(db_mesh=d.db_mesh, db_axis="data")
        srv = TServer(d, device="cpu")
    else:
        mesh, kw = data_mesh(2, devices=["cpu"] * 2), {}
        srv = TServer(device="cpu")
    srv.create_table(spec, slab_sharding=None if kw
                     else slab_sharding(spec, mesh))
    for i, snap in enumerate(snaps):
        srv.put("field", TS.make_key(0, i), torch.as_tensor(snap))
    cfg = ttr.TrainerConfig(ae=cfg_ae, gather=GATHER, batch_size=BATCH,
                            lr=1e-3, mesh=mesh, slab_sharded=True, **kw)
    tx = topt.adam(cfg.scaled_lr)
    epoch = ttr.EPOCH_BUILDERS[tier](
        cfg, tae.coords_pyramid(cfg_ae, torch.as_tensor(_coords())), tx,
        spec)
    state = ttr.train_state_from_numpy(np_autoencoder_params(jcfg, SEED),
                                       device="cpu")
    client, metrics = TClient(srv), []
    for dr in draws:
        if kw:
            state, m = epoch(client, state, dr, torch.as_tensor(mu),
                             torch.as_tensor(sd))
        else:
            with client.capture("field") as txn:
                state, m = epoch(txn.state, state, dr, torch.as_tensor(mu),
                                 torch.as_tensor(sd))
        metrics.append([float(x) for x in m[:3]])
    return state, metrics, srv


def test_clustered_epochs_match_reference(reference, record_property):
    ref, seconds, snaps, mu, sd = reference
    record_property("reference_subprocess_s", seconds)
    nvalid = int(ref["nvalid"])
    draws = [ttr.EpochDraws(
        torch.as_tensor(uniforms_for_ranks(ref[f"ranks{e}"], nvalid)),
        torch.as_tensor(ref[f"val_idx{e}"]), torch.as_tensor(ref[f"perm{e}"]))
        for e in range(EPOCHS)]
    C.reset_counts()
    with C.counted() as calls:
        state, metrics, srv = _port_epochs("slab_sharded_clustered", snaps,
                                           mu, sd, draws)
    got = _sorted_leaves(state.params)
    assert len(got) == sum(k.startswith("param") for k in ref)
    for i, leaf in enumerate(got):
        np.testing.assert_allclose(leaf.numpy(), ref[f"param{i}"],
                                   rtol=2e-5, atol=1e-6, err_msg=str(i))
    for e, m in enumerate(metrics):
        want = ref[f"metrics{e}"]
        np.testing.assert_allclose(m[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(m[1:], want[1:], rtol=1e-4)
    st = srv.stats()
    assert [st["op_count"], st["staged_transfers"]] == \
        ref["counts"].tolist() == [PUTS + EPOCHS, PUTS + EPOCHS]
    # the db-side gather's psum and the DDP psums; the table never
    # all-gathered
    assert calls["all_gather"] == 0 and calls["all_reduce"] > 0
    # the port's own slab_sharded on the same draws: bit for bit
    state2, metrics2, _ = _port_epochs("slab_sharded", snaps, mu, sd,
                                       draws)
    assert metrics == metrics2
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(state.params), tree_leaves(state2.params)))


def test_clustered_session_runs_as_planned():
    """A CPU session on a 2 + 2 split: a producer on the client ranks, a
    slab-sharded trainer whose table stays slot-partitioned on the db
    ranks: the tier resolves to ``slab_sharded_clustered``, ``op_count``,
    ``staged_transfers`` and each component's staged delta equal the
    plan, and ``plan(hlo=True)``'s counted collectives hold to the
    predictions."""
    d = dep.make_clustered_1d(devices=["cpu"] * 4, db_fraction=0.5,
                              slab_axis="data")
    cfg_ae = tae.AEConfig(**_TINY)
    tcfg = ttr.TrainerConfig(ae=cfg_ae, epochs=2, gather=4, batch_size=2,
                             mesh=d.client_mesh, slab_sharded=True)
    coords = torch.as_tensor(np.random.default_rng(1).random(
        (64, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    field = torch.randn(12, 4, 64, generator=gen)

    def step(c, r, t):
        return c, TS.make_key(r, t), field[t]

    sess = TSession(
        tables=[TS.TableSpec("field", shape=(4, 64), capacity=8)],
        components=[TProducer(step, table="field", steps=12, chunk=4,
                              carry=torch.zeros(())),
                    TTrainer(tcfg, coords)],
        deployment=d, device="cpu")
    plan = sess.plan(hlo=True)
    trainer = plan.component("trainer")
    assert trainer.tier == "slab_sharded_clustered"
    assert dict(trainer.staged) == {"gather_stage": 2}
    assert dict(plan.component("producer").dispatches) == \
        {"capture": 3, "drain": 1}
    for entry in plan.components:
        entry.check_collectives()
    coll = dict(trainer.collectives)
    assert coll["all-reduce"] > 0 and coll["all-gather"] == 0
    assert not any(dict(plan.component("producer").collectives).values())
    res = sess.run(plan=plan, sequential=True)
    assert res.ok, {n: c.error for n, c in res.run.components.items()}
    st = res.server.stats()
    assert (st["op_count"], st["staged_transfers"]) == \
        (plan.store_dispatches, plan.staged_transfers) == (7, 5)
    for entry in plan.components:
        assert res.op_delta(entry.name) == entry.store_dispatches
        assert res.staged_delta(entry.name) == entry.staged_transfers
    assert isinstance(res.server.checkout("field").slab, TS.ShardedSlab)
    hist = res.output("trainer").history
    assert len(hist) == 2 and all(np.isfinite(h.train_loss) for h in hist)
