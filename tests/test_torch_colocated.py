"""Port parity for the co-located deployment: ``core.deployment.Colocated``,
element-sharded tables, the ``capture_scan_sharded`` producer tier and
co-located serving and transfer, on a 2-rank mesh on ``"cpu"``.

* The same write verbs (``put``, ``put_many``, ``put_stream``,
  ``delete``, a ring-wrapping ``capture_scan``; ``put_masked`` on the
  store) on the reference's LOCAL store and on the port's co-located one,
  ring and hash: the port's shards, reassembled, and its keys, version,
  ptr, count, watermarks and ``op_count`` byte-identical to the
  reference's; ``get``, ``get_many`` and ``latest`` equal to the
  reference's reads.  Writes make no collective; each read makes one
  all-gather (its per-shard gathers assembled).
* The ``capture_scan_sharded`` session of ``tests/test_plan_properties.py``
  at n = 16, 12 steps in chunks of 4 on ``Colocated(space_mesh(2))``:
  ``op_count == plan.store_dispatches == 3``, no staged transfer, the
  chunk's counted collectives equal to ``sharded_producer_prediction``
  (``collective_permute`` only), the stored snapshot within 1e-5 of the
  reference's UNSHARDED solver after 12 steps and bit-identical to the
  port's own unsharded step; against ONE reference subprocess with two
  forced host devices running the same co-located session on its
  ``space_mesh(2)``: the tier, the prediction, the measured collectives'
  structure, ``op_count`` and the stored field (1e-5).
* Serving at ``SHAPE = (2, 4)`` on both tiers: the co-located responses
  equal the port's local run and the reference's local run, plan ==
  ``stats()``, each drain's counted collectives equal to the port's
  prediction (one all-gather).
* ``run_transfer`` on a co-located server: every read equal to the local
  server's, ``op_count`` equal.
* The tier and ``elem_sharding`` validation errors of
  ``src/repro/insitu/plan.py:115-152`` with the reference's messages; the
  layout errors; what of the clustered deployment stays open raising
  ``ROADMAP.md`` A5.

The reference subprocess's time is recorded as the junit property
``reference_subprocess_s``.
"""

import json
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import run_subprocess
from repro.core import Client as JClient
from repro.core import StoreServer as JServer
from repro.core import TableSpec as JSpec
from repro.core import store as JS
from repro.insitu import InSituSession as JSession
from repro.insitu import ServingClients as JClients
from repro.insitu import ServingConsumer as JServing
from repro.insitu import plan as jplan
from repro.sim import distributed as jfd

SHAPE = (2, 4)
N, STEPS, CHUNK, CAP = 16, 12, 4, 16


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection (every xdist worker collects every test file)."""
    global torch, TS, TServer, TClient, dep, C, fd, tplan, data_mesh
    global space_mesh, ElemSharding, ElemShards, TSession, TProducer
    global TClients, TServing, TP, TSlabSharding
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import deployment as dep
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import ServingClients as TClients
    from repro_torch.insitu import ServingConsumer as TServing
    from repro_torch.insitu import plan as tplan
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import (ElemSharding, ElemShards,
                                               data_mesh, space_mesh)
    from repro_torch.parallel.sharding import SlabSharding as TSlabSharding
    from repro_torch.sim import distributed as fd
    from repro_torch.sim import reproducer as TP
    torch.set_num_threads(1)


def _mesh(axis="data"):
    return data_mesh(2, axis=axis, devices=["cpu"] * 2)


def _colocated(ndim=2, shard_dim=1):
    return dep.make_colocated_1d(mesh=_mesh(), ndim=ndim,
                                 shard_dim=shard_dim)


def _whole_slab(slab):
    """A port slab as one array (an element-sharded one reassembled)."""
    return TS.whole_slab(slab).numpy()


def _assert_state(jst, tst):
    np.testing.assert_array_equal(_whole_slab(tst.slab), np.asarray(jst.slab))
    np.testing.assert_array_equal(tst.keys.numpy().astype(np.uint32),
                                  np.asarray(jst.keys))
    np.testing.assert_array_equal(tst.version.numpy(),
                                  np.asarray(jst.version))
    assert int(tst.ptr) == int(jst.ptr)
    assert int(tst.count) == int(jst.count)


def _values(k: int, t0: int = 0) -> np.ndarray:
    return (np.arange(k * 8, dtype=np.float32).reshape(k, *SHAPE)
            + 100.0 * t0)


# ---------------------------------------------------------------------------
# write verbs and reads against the reference's local store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["ring", "hash"])
def test_write_verbs_match_reference_local(engine):
    jspec = JSpec("t", shape=SHAPE, capacity=5, engine=engine)
    tspec = TS.TableSpec("t", shape=SHAPE, capacity=5, engine=engine)
    js, ts = JServer(), TServer(deployment=_colocated(), device="cpu")
    js.create_table(jspec)
    ts.create_table(tspec)
    assert isinstance(ts.placement("t"), ElemSharding)
    keys = np.array([7, 12, 7, 3], np.uint32)
    C.reset_counts()
    for srv, arr in ((js, jnp.asarray), (ts, torch.as_tensor)):
        srv.put("t", 5, arr(_values(1)[0]))
        srv.put("t", 9, arr(_values(1, 1)[0]))
        srv.put_many("t", arr(keys.astype(np.int64)) if srv is ts
                     else arr(keys), arr(_values(4, 2)))
        srv.put_stream("t", arr(np.array([[20, 21], [22, 23]],
                                         np.int64 if srv is ts
                                         else np.uint32)),
                       arr(_values(4, 3).reshape(2, 2, *SHAPE)))
        srv.delete("t", 12)

    def jstep(c, t):
        return c + 1.0, JS.make_key(0, t), jnp.full(SHAPE, 1.0) * (c + t)

    def tstep(c, t):
        return c + 1.0, TS.make_key(0, t), torch.full(SHAPE, 1.0) * (c + t)

    JClient(js).capture_scan("t", jstep, jnp.float32(0.5), 7, 2, t0=3)
    TClient(ts).capture_scan("t", tstep, torch.tensor(0.5), 7, 2, t0=3)
    assert C.COUNTS == {"all_reduce": 0, "all_gather": 0,
                        "collective_permute": 0}
    _assert_state(js._state["t"], ts._state["t"])
    assert ts.stats()["op_count"] == js.stats()["op_count"]
    assert ts.watermark("t") == js.watermark("t") == ts.watermark_device("t")
    assert ts.stats()["staged_transfers"] == 0
    assert ts.stats()["slab_bytes"]["t"] == {"cpu": 5 * 8 * 4}
    assert ts.hbm_bytes() == js.hbm_bytes()

    probe = [5, 9, 20, 23, 12, 4, 6]
    C.reset_counts()
    jv, jf = js.get_many("t", jnp.asarray(probe, jnp.uint32))
    tv, tf = ts.get_many("t", probe)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for key in (23, 12):
        jg, jok = js.get("t", key)
        tg, tok = ts.get("t", key)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert bool(tok) == bool(jok)
    jl, jk, jvalid = js.latest("t", 4)
    tl, tk, tvalid = ts.latest("t", 4)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                  np.asarray(jk))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert C.COUNTS == {"all_reduce": 0, "all_gather": 4,
                        "collective_permute": 0}


def test_put_masked_and_rank_blocks_match_reference():
    """``put_masked`` at the store level, and the same values written as
    the ranks' own blocks (an ``ElemShards``): byte-identical tables."""
    jspec = JSpec("t", shape=SHAPE, capacity=4)
    tspec = TS.TableSpec("t", shape=SHAPE, capacity=4)
    layout = _colocated().elem_sharding(tspec)
    keys = np.array([3, 4, 5, 6, 7, 8], np.uint32)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    vals = _values(6)
    jst = JS.put_masked(jspec, JS.init_table(jspec), jnp.asarray(keys),
                        jnp.asarray(vals), jnp.asarray(mask))
    whole = TS.put_masked(tspec, TS.init_table(tspec, layout, device="cpu"),
                          keys.astype(np.int64), vals, mask)
    blocks = ElemShards(tuple(torch.from_numpy(vals).chunk(2, dim=2)),
                        layout)
    C.reset_counts()
    ranked = TS.put_masked(tspec, TS.init_table(tspec, layout, device="cpu"),
                           keys.astype(np.int64), blocks, mask)
    assert C.COUNTS["all_gather"] == 0
    _assert_state(jst, whole)
    _assert_state(jst, ranked)
    with C.counted() as calls:
        local = TS.put_masked(tspec, TS.init_table(tspec, device="cpu"),
                              keys.astype(np.int64), blocks, mask)
    assert calls["all_gather"] == 1             # assembled into a whole slab
    _assert_state(jst, local)
    draw = torch.tensor([0.1, 0.6, 0.9])
    np.testing.assert_array_equal(TS.sample(tspec, ranked, draw)[0].numpy(),
                                  TS.sample(tspec, local, draw)[0].numpy())


def test_layout_errors():
    mesh = _mesh()
    with pytest.raises(ValueError, match="names axis 'space'"):
        ElemSharding(mesh, (None, "space"))
    with pytest.raises(ValueError, match="twice"):
        ElemSharding(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="does not divide"):
        TS.init_table(TS.TableSpec("t", shape=(3, 4)),
                      ElemSharding(mesh, ("data",)), device="cpu")
    with pytest.raises(ValueError, match="more entries than the element"):
        ElemSharding(mesh, (None, None, "data")).local_shape((2, 4))
    with pytest.raises(ValueError, match="disjoint mesh axes"):
        dep.Colocated(mesh=mesh, elem_spec=("data",), capacity_axis="data")
    spec = TS.TableSpec("t", shape=SHAPE, capacity=4)
    st = TS.init_table(spec, _colocated().slab_sharding(spec), device="cpu")
    with pytest.raises(ValueError, match="value shape"):
        TS.put(spec, st, 1, ElemShards((torch.zeros(2, 4),) * 2,
                                       st.slab.placement))
    capacity = dep.Colocated(mesh=mesh, capacity_axis="data")
    assert capacity.slab_sharding(spec) == TSlabSharding(mesh, 2)
    with pytest.raises(ValueError, match="does not divide"):
        capacity.slab_sharding(TS.TableSpec("t", shape=SHAPE, capacity=3))
    with pytest.raises(ValueError, match="not an axis"):
        dep.Colocated(mesh=mesh, capacity_axis="slab")
    whole = dep.Colocated(mesh=mesh)
    assert whole.slab_sharding(spec).dim is None
    assert "colocated(mesh=(('data', 2),)" in whole.describe()


def test_clustered_still_raises():
    """A deployment the port does not run raises; ``Clustered`` and its
    2-D db grid run (``tests/test_torch_clustered.py``,
    ``tests/test_torch_multidevice.py``)."""
    grid = dep.make_clustered_2d((None, "space"), devices=["cpu"] * 4)
    assert grid.db_mesh.shape == {"slab": 2, "space": 1}
    clustered = dep.make_clustered_1d(devices=["cpu"] * 2, db_fraction=0.5)
    assert isinstance(clustered, dep.Clustered) and clustered.fan_in == 1
    assert isinstance(dep.StagingPipeline(), dep.StagingPipeline)

    class Other(dep.Deployment):
        """A deployment the port does not run."""

    with pytest.raises(NotImplementedError, match="the port runs the local"):
        TServer(deployment=Other(), device="cpu")
    with pytest.raises(NotImplementedError, match="the port runs the local"):
        TSession([TClients(lambda c, s: 0, table="t", collect=False)],
                 tables=[TS.TableSpec("t", shape=SHAPE)],
                 deployment=Other(), device="cpu")
    assert dep.fan_in_ratio(3, 2) == 2 and dep.fan_in_ratio(1, 4) == 1
    assert dep.split_devices(["cpu"] * 4) == (["cpu"] * 3, ["cpu"])


# ---------------------------------------------------------------------------
# the capture_scan_sharded producer
# ---------------------------------------------------------------------------

_REFERENCE = """
import json, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core import TableSpec
from repro.core import store as S
from repro.core.deployment import Colocated
from repro.insitu import InSituSession, Producer
from repro.parallel.sharding import space_mesh
from repro.sim import distributed as fd

mesh = space_mesh(2)
cfg = fd.FDConfig(n={n}, jacobi_iters=8)
step_fn, s0, es = fd.make_producer(cfg, mesh)
spec = TableSpec("field", shape=(2, cfg.n, cfg.n), capacity={cap})
sess = InSituSession(
    tables=[spec],
    components=[Producer(step_fn, table="field", steps={steps},
                         chunk={chunk}, carry=s0, elem_sharding=es)],
    deployment=Colocated(mesh=mesh, elem_spec=PS(None, "space", None)))
plan = sess.plan(hlo=True)
res = sess.run(plan=plan, sequential=True, max_wall_s=240)
entry = plan.component("producer")
val, ok = S.get(spec, res.server.checkout("field"), S.make_key(0, {last}))
print("RESULT" + json.dumps({{
    "ok": res.ok, "tier": entry.tier, "stats": res.server.stats(),
    "dispatches": plan.store_dispatches,
    "explain": entry.explain(), "found": bool(ok),
    "value": np.asarray(val).ravel().tolist()}}))
"""


@pytest.fixture(scope="module")
def reference_session():
    t0 = time.perf_counter()
    out = run_subprocess(_REFERENCE.format(n=N, cap=CAP, steps=STEPS,
                                           chunk=CHUNK, last=STEPS - 1),
                         n_devices=2)
    line = [x for x in out.splitlines() if x.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):]), time.perf_counter() - t0


def _port_session(deployment=True):
    mesh = space_mesh(2, devices=["cpu"] * 2)
    cfg = fd.FDConfig(n=N, jacobi_iters=8)
    step_fn, s0, es = fd.make_producer(cfg, mesh)
    return TSession(
        tables=[TS.TableSpec("field", shape=(2, N, N), capacity=CAP)],
        components=[TProducer(step_fn, table="field", steps=STEPS,
                              chunk=CHUNK, carry=s0, elem_sharding=es)],
        deployment=dep.Colocated(mesh=mesh, elem_spec=(None, "space", None))
        if deployment else None, device="cpu")


def test_sharded_producer_session(reference_session, record_property):
    ref, seconds = reference_session
    record_property("reference_subprocess_s", seconds)
    sess = _port_session()
    plan = sess.plan(hlo=True)
    entry = plan.component("producer")
    assert entry.tier == ref["tier"] == "capture_scan_sharded"
    mine = entry.explain()
    assert mine["predicted_collectives"] \
        == ref["explain"]["predicted_collectives"]
    entry.check_collectives()
    for op in tplan.COLLECTIVE_OPS:
        assert bool(dict(entry.collectives)[op]) \
            == bool(ref["explain"]["collectives"][op]), (op, mine, ref)
    # one chunk: 4 steps x (2 + 1 + 8 + 1) exchanges x 2 ppermutes
    assert dict(entry.collectives)["collective-permute"] == CHUNK * 12 * 2
    C.reset_counts()
    res = sess.run(plan=plan, sequential=True, max_wall_s=120)
    assert res.ok, {k: c.error for k, c in res.run.components.items()}
    assert C.COUNTS["all_gather"] == C.COUNTS["all_reduce"] == 0
    stats = res.server.stats()
    assert stats["op_count"] == plan.store_dispatches == 3 \
        == ref["stats"]["op_count"] == ref["dispatches"]
    assert stats["staged_transfers"] == ref["stats"]["staged_transfers"] == 0
    assert res.server.watermark("field") == STEPS
    assert stats["slab_bytes"]["field"] == {"cpu": CAP * 2 * N * N * 4}
    st = res.server.checkout("field")
    assert isinstance(st.slab, TS.ElemShardedSlab)
    spec = res.server.spec("field")
    got, ok = TS.get(spec, st, TS.make_key(0, STEPS - 1))
    assert bool(ok) and ref["found"]
    np.testing.assert_allclose(got.numpy().ravel(), ref["value"], atol=1e-5)
    # the reference's unsharded solver, in process, and the port's own
    jcfg = jfd.FDConfig(n=N, jacobi_iters=8)
    jstep, r = jfd.make_step(jcfg), jfd.taylor_green(jcfg)
    cfg = fd.FDConfig(n=N, jacobi_iters=8)
    step, w = fd.make_step(cfg), fd.taylor_green(cfg, "cpu")
    for _ in range(STEPS):
        r, w = jstep(r), step(w)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.stack([r.u, r.v])),
                               atol=1e-5)
    assert torch.equal(got, fd.snapshot(w))
    assert plan.deployment.startswith("colocated")


def test_sharded_producer_without_colocation():
    """The same producer on the local deployment: no claim (the emission
    is assembled into the whole slab, one all-gather a put), the same
    stored bytes as the co-located run."""
    plan = _port_session(deployment=False).plan(hlo=True)
    entry = plan.component("producer")
    assert entry.tier == "capture_scan_sharded"
    assert entry.predicted_collectives is None
    assert dict(entry.collectives)["all-gather"] == CHUNK
    colo = _port_session().run(sequential=True).server
    local = _port_session(deployment=False).run(sequential=True).server
    a, b = colo.checkout("field"), local.checkout("field")
    np.testing.assert_array_equal(_whole_slab(a.slab), b.slab.numpy())
    assert torch.equal(a.keys, b.keys)


def _component(**kw):
    base = dict(elem_sharding=None, traceable=True, ranks=1, tier=None)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [
    dict(elem_sharding="es", traceable=False),
    dict(elem_sharding="es", ranks=2),
    dict(tier="capture_scan_sharded"),
    dict(elem_sharding="es", tier="capture_scan"),
    dict(elem_sharding="es", tier="bogus"),
    dict(elem_sharding="es"), dict(elem_sharding="es", tier="per_verb"),
    dict(), dict(ranks=3), dict(traceable=False)])
def test_producer_tier_matches_reference(kw):
    comp = _component(**kw)
    try:
        want = jplan.producer_tier(comp)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tplan.producer_tier(comp)
        assert str(got.value) == str(exc)
        return
    assert tplan.producer_tier(comp) == want
    assert tplan.PRODUCER_TIERS == jplan.PRODUCER_TIERS


def test_sharded_producer_prediction_matches_reference():
    mesh2 = space_mesh(2, devices=["cpu"] * 2)
    one = space_mesh(1, devices=["cpu"])
    for es, jes in ((ElemSharding(mesh2, (None, "space")),
                     SimpleNamespace(num_devices=2,
                                     is_fully_replicated=False)),
                    (ElemSharding(one, (None, "space")),
                     SimpleNamespace(num_devices=1,
                                     is_fully_replicated=False)),
                    (ElemSharding(mesh2, ()),
                     SimpleNamespace(num_devices=2,
                                     is_fully_replicated=True)),
                    (None, None)):
        for colocated in (False, True):
            assert tplan.sharded_producer_prediction(es, colocated) \
                == jplan.sharded_producer_prediction(jes, colocated)


# ---------------------------------------------------------------------------
# serving and transfer on a co-located store
# ---------------------------------------------------------------------------

def _feed(c, s):
    return np.full(SHAPE, float(100 * c + s), np.float32)


def _serving(pkg, tier, deployment=None):
    Session, Clients, Serving, Spec = \
        (JSession, JClients, JServing, JSpec) if pkg == "ref" else \
        (TSession, TClients, TServing, TS.TableSpec)
    wrap = jnp.asarray if pkg == "ref" else torch.as_tensor
    kw = {} if pkg == "ref" else {"device": "cpu"}
    return Session(
        tables=[Spec("req", shape=SHAPE, capacity=32),
                Spec("res", shape=SHAPE, capacity=32)],
        components=[
            Clients(lambda c, s: wrap(_feed(c, s)), table="req", clients=3,
                    requests=4, collect=False, name="writers"),
            Serving("m", table="req", results="res", clients=3, requests=4,
                    max_batch=4, tier=tier),
            Clients(lambda c, s: wrap(_feed(c, s)), table="req", clients=3,
                    requests=4, submit=False, name="readers")],
        deployment=deployment, **kw)


@pytest.mark.parametrize("tier", ["continuous_batch", "three_step"])
def test_serving_matches_local(tier):
    out = {}
    for name in ("ref", "local", "colocated"):
        deployment = _colocated(shard_dim=0) if name == "colocated" else None
        sess = _serving("ref" if name == "ref" else "port", tier, deployment)
        plan = sess.plan(hlo=name == "colocated")
        if name == "ref":
            res = sess.run(plan=plan, sequential=True, max_wall_s=120,
                           preload=lambda srv: srv.set_model(
                               "m", lambda p, x: p * x + 1.0,
                               jnp.asarray(2.0)))
        else:
            res = sess.run(plan=plan, sequential=True, max_wall_s=120,
                           preload=lambda srv: srv.set_model(
                               "m", lambda p, x: p * x + 1.0,
                               torch.tensor(2.0)))
        assert res.ok, {k: c.error for k, c in res.run.components.items()}
        stats = res.server.stats()
        assert stats["op_count"] == plan.store_dispatches
        assert stats["model_swaps"] == plan.model_swaps
        assert stats["staged_transfers"] == 0
        out[name] = {k: np.asarray(v)
                     for k, v in res.output("readers").responses.items()}
        if name == "colocated":
            entry = plan.component("serving")
            entry.check_collectives()
            assert dict(entry.collectives)["all-gather"] == 1
            assert sum(dict(entry.collectives).values()) == 1
            assert isinstance(res.server.checkout("res").slab,
                              TS.ElemShardedSlab)
    assert sorted(out["ref"]) == sorted(out["local"]) == sorted(
        out["colocated"])
    for k in out["ref"]:
        np.testing.assert_array_equal(out["local"][k], out["ref"][k])
        np.testing.assert_array_equal(out["colocated"][k], out["ref"][k])
        np.testing.assert_array_equal(out["ref"][k], 2.0 * _feed(*k) + 1.0)


def test_run_transfer_matches_local():
    cfg = TP.ReproducerConfig(n_ranks=4, bytes_per_rank=256, iterations=3,
                              warmup=1)
    data = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 64)).astype(np.float32))
    reads, ops = {}, {}
    for name, deployment in (("local", None),
                             ("colocated", dep.make_colocated_1d(
                                 mesh=_mesh()))):
        server = TServer(deployment=deployment, device="cpu")
        got = []
        C.reset_counts()
        TP.run_transfer(cfg, server, data=data,
                        on_read=lambda step, v, f: got.append(
                            (v.clone(), bool(f.all()))))
        reads[name], ops[name] = got, server.stats()["op_count"]
        if deployment is not None:
            assert isinstance(server.checkout("repro").slab,
                              TS.ElemShardedSlab)
            assert C.COUNTS["all_gather"] == cfg.warmup + cfg.iterations
    assert ops["local"] == ops["colocated"] == 2 * 4
    for (a, fa), (b, fb) in zip(reads["local"], reads["colocated"]):
        assert fa and fb and torch.equal(a, b) and torch.equal(a, data)
