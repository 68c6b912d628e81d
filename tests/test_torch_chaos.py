"""Port parity for fault recovery at the session level (the reference's
chaos cells, ``tests/test_plan_properties.py -m chaos``).

Two cells, each run in BOTH packages at the reference chaos grid's tiny
sizes, first under an empty armed ``FaultPlan`` (the fault-free baseline
takes the same logged path) and then under a fixed plan of every fault
kind:

* training — a producer (10 steps, chunk 3) and the fused trainer
  (2 epochs, gather 4, batch 2) on one ring table, under an
  ``unavailable`` window on ``capture``, a dropped and a duplicated
  chunk, a ``snapshot`` then a ``restart``, a producer crash and a
  trainer crash.  Both packages start from the same numpy-seeded weights
  and snapshots; the reference's own draws are fed to the port.
* serving — 2 clients × 3 requests through ``continuous_batch`` (max
  batch 2) under a serving crash at batch 1, a duplicated response
  chunk, a dropped one, a writer crash, ``unavailable`` windows and a
  ``snapshot`` + ``restart`` of the results table.

Checks, each exact unless a tolerance is named:

* the two packages' plans are equal (tiers, dispatches with the
  ``"replay"`` ops, retries, restarts, ``Plan.faults``), and each equals
  its own run's ``op_delta``, component retries and restarts and
  ``stats()`` counters;
* the tables (slab, keys, version, ptr, count) are byte-identical to
  the fault-free run and across the packages; every response likewise;
* the port's trained state is bit-identical (``torch.equal``) to its
  fault-free run, and its epoch losses are within 1e-3 relative of the
  reference's (``tests/test_torch_insitu.py``'s tolerance; the largest
  difference is recorded as junit property ``max_rel_epoch_deviation``).

Every test runs under the port's ``LockTracker`` witness: the lock-order
graph its servers realise must be acyclic.

Then, in the port alone, the training grid's random plans for seeds 0–8
(the reference grid's shapes and ``FaultPlan.random`` draws): each run
completes with exact predictions and the baseline's bytes, and its plan
equals the reference session's plan (plans only: no reference run).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from repro.core import TableSpec as JTableSpec
from repro.core import faults as jfaults
from repro.core import store as JS
from repro.insitu import InSituSession as JSession
from repro.insitu import Producer as JProducer
from repro.insitu import ServingClients as JClients
from repro.insitu import ServingConsumer as JConsumer
from repro.insitu import TrainerConsumer as JTrainer
from repro.ml import autoencoder as jae
from repro.ml import trainer as jtr


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TTableSpec, tfaults, TS, TSession, TProducer, TClients
    global TConsumer, TTrainer, ttr, tree_leaves
    import torch
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.core import faults as tfaults
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import ServingClients as TClients
    from repro_torch.insitu import ServingConsumer as TConsumer
    from repro_torch.insitu import TrainerConsumer as TTrainer
    from repro_torch.ml import trainer as ttr
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_lock_order_witness():
    """Every test here runs under the port's ``LockTracker``: each
    ``repro_torch`` server built in it has its locks wrapped, and the
    test fails if the realised lock-order graph has a cycle (the
    reference's chaos witness, ``tests/conftest.py``, wraps only the
    reference's servers)."""
    from repro_torch.core.locktrack import LockTracker
    with LockTracker.instrument() as tracker:
        yield
    tracker.assert_acyclic()


FAST = dict(interval=1e-4, max_interval=1e-3)
N, CAP, STEPS, CHUNK, EPOCHS, GATHER = 32, 16, 10, 3, 2, 4
LOSS_RTOL = 1e-3
SNAPS = np.random.default_rng(5).standard_normal((8, 4, N)).astype(
    np.float32)
COORDS = np.random.default_rng(6).random((N, 3)).astype(np.float32)
JAE = jae.AEConfig(n_points=N, mode="ref", latent=4, internal=4, blocks=1,
                   mlp_width=8, mlp_depth=2)
PARAMS = np_autoencoder_params(JAE, seed=3)

#: every fault kind, on the training cell: a capture window, a dropped and
#: a duplicated chunk, a snapshot then a restart, both components crashing
TRAIN_FAULTS = (
    dict(kind="unavailable", verb="capture", at=1, count=2),
    dict(kind="drop_chunk", table="field", at=0),
    dict(kind="dup_chunk", table="field", at=2),
    dict(kind="snapshot", table="field", at=1),
    dict(kind="restart", table="field", at=3),
    dict(kind="crash", component="producer", at=2),
    dict(kind="crash", component="trainer", at=1),
)
SERVE_FAULTS = (
    dict(kind="crash", component="serving", at=1),
    dict(kind="dup_chunk", table="sres", at=0),
    dict(kind="drop_chunk", table="sres", at=2),
    dict(kind="crash", component="writers", at=3),
    dict(kind="unavailable", verb="put", at=2),
    dict(kind="unavailable", verb="serve", at=1),
    dict(kind="snapshot", table="sres", at=1),
    dict(kind="restart", table="sres", at=2),
)


def _plan(f, events, seed=0):
    return f.FaultPlan(events=tuple(f.FaultEvent(**e) for e in events),
                       retry=f.RetryPolicy(seed=seed, **FAST))


def _reference_draws(cfg, nvalid: int):
    """The draws the reference's ``insitu_train`` makes from its key
    ``seed + 1``, as the port's ``TrainDraws`` (the sample ranks as the
    uniforms that give them back)."""
    top = jnp.maximum(jnp.int32(nvalid), 1)

    def sample(k):
        ranks = jax.random.randint(k, (cfg.gather,), 0, top)
        return torch.as_tensor(uniforms_for_ranks(ranks, nvalid))

    rng, k = jax.random.split(jax.random.key(cfg.seed + 1))
    boot = sample(k)
    epochs = []
    for _ in range(cfg.epochs):
        rng, k_ep = jax.random.split(rng)
        k_samp, k_val, k_perm = jax.random.split(k_ep, 3)
        epochs.append(ttr.EpochDraws(
            sample(k_samp),
            torch.as_tensor(np.array(jax.random.randint(
                k_val, (), 0, cfg.gather))),
            torch.as_tensor(np.array(jax.random.permutation(
                k_perm, cfg.gather - 1)))))
    return ttr.TrainDraws(boot, epochs)


def _training_session(pkg: str, faults, *, steps=STEPS, chunk=CHUNK,
                      emit_every=1, epochs=EPOCHS, per_verb=False,
                      draws=True):
    jax_side = pkg == "jax"
    if jax_side:
        cfg = jtr.TrainerConfig(ae=JAE, epochs=epochs, gather=GATHER,
                                batch_size=2, lr=1e-3)

        snaps = jnp.asarray(SNAPS)

        def step(c, r, t):
            return c, JS.make_key(r, t), snaps[t % 8]
        return JSession(
            tables=[JTableSpec("field", shape=(4, N), capacity=CAP)],
            components=[
                JProducer(step, table="field", steps=steps,
                          carry=jnp.zeros(()), emit_every=emit_every,
                          chunk=chunk, tier="per_verb" if per_verb else None),
                JTrainer(cfg, jnp.asarray(COORDS))],
            faults=faults)
    cfg = ttr.TrainerConfig(ae=torch_ae_config(JAE), epochs=epochs,
                            gather=GATHER, batch_size=2, lr=1e-3)
    jcfg = jtr.TrainerConfig(ae=JAE, epochs=epochs, gather=GATHER)
    nvalid = min(JS.capture_emit_count(steps, emit_every), CAP)

    def tstep(c, r, t):
        return c, TS.make_key(r, t), torch.as_tensor(SNAPS[t % 8])
    return TSession(
        tables=[TTableSpec("field", shape=(4, N), capacity=CAP)],
        components=[
            TProducer(tstep, table="field", steps=steps,
                      carry=torch.zeros(()), emit_every=emit_every,
                      chunk=chunk, tier="per_verb" if per_verb else None),
            TTrainer(cfg, torch.as_tensor(COORDS),
                     draws=_reference_draws(jcfg, nvalid) if draws
                     else None)],
        faults=faults, device="cpu")


@pytest.fixture
def same_weights(monkeypatch):
    """Both trainers start from ``PARAMS``."""
    def jinit(cfg, _key, tx):
        p = jax.tree.map(jnp.asarray, PARAMS)
        return jtr.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))

    def tinit(cfg, _gen, tx, device=None):
        return ttr.train_state_from_numpy(PARAMS, device=device)

    monkeypatch.setattr(jtr, "init_state", jinit)
    monkeypatch.setattr(ttr, "init_state", tinit)


def _plan_rows(plan) -> list:
    return [(c.name, c.kind, c.tier, tuple(c.dispatches), c.retries,
             c.restarts) for c in plan.components]


def _run_checked(sess, **kw):
    """Run ``sess`` sequentially and hold every prediction of its plan
    against the run → ``(plan, result)``."""
    plan = sess.plan()
    res = sess.run(plan=plan, sequential=True, max_wall_s=240, **kw)
    assert res.ok, {k: c.error for k, c in res.run.components.items()}
    for entry in plan.components:
        comp = res.run.components[entry.name]
        assert res.op_delta(entry.name) == entry.store_dispatches, \
            (entry.name, res.op_delta(entry.name), entry.store_dispatches)
        assert (comp.retries, comp.restarts) \
            == (entry.retries, entry.restarts), entry.name
    stats = res.server.stats()
    assert stats["op_count"] == plan.store_dispatches
    for key, predicted in plan.faults:
        assert stats[key] == predicted, (key, predicted, stats[key])
    return plan, res


def _table(res, name: str, jax_side: bool) -> list:
    st = res.server.checkout(name)
    out = [np.asarray(x) if jax_side else x.numpy() for x in st]
    out[1] = out[1].astype(np.int64)
    return out


def _equal_tables(a: list, b: list) -> None:
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.chaos
def test_training_chaos_cell(same_weights, record_property):
    out = {}
    for pkg, f in (("jax", jfaults), ("torch", tfaults)):
        base = _run_checked(_training_session(pkg, _plan(f, ())))
        chaos = _run_checked(_training_session(pkg, _plan(f, TRAIN_FAULTS)))
        out[pkg] = (base, chaos)
    (jbase, (jplan, jres)), (tbase, (tplan, tres)) = out["jax"], out["torch"]
    assert _plan_rows(tplan) == _plan_rows(jplan)
    assert tplan.faults == jplan.faults
    # every fault kind fired: two restarts survived, retries absorbed, a
    # store recovery replayed the log
    f = dict(tplan.faults)
    assert f["recoveries"] == 1 and f["retries"] >= 3
    assert tres.restarts == 2
    assert dict(tplan.component("producer").dispatches).get("replay", 0) > 0
    jt = _table(jres, "field", True)
    tt = _table(tres, "field", False)
    _equal_tables(jt, _table(jbase[1], "field", True))
    _equal_tables(tt, _table(tbase[1], "field", False))
    _equal_tables(jt, tt)
    tstate = tres.output("trainer").state
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tbase[1].output("trainer").state),
        tree_leaves(tstate)))
    jhist = jres.output("trainer").history
    thist = tres.output("trainer").history
    assert len(jhist) == len(thist) == EPOCHS
    worst = 0.0
    for j, t in zip(jhist, thist):
        for field in ("train_loss", "val_loss", "val_rel_error"):
            want, got = getattr(j, field), getattr(t, field)
            assert abs(got - want) <= LOSS_RTOL * abs(want), \
                (j.epoch, field, got, want)
            worst = max(worst, abs(got - want) / abs(want))
    record_property("max_rel_epoch_deviation", worst)


def _serve_feed_j(c, s):
    return jnp.full((2, 4), float(100 * c + s))


def _serving_session(pkg: str, faults):
    jax_side = pkg == "jax"
    Spec, Clients, Consumer, Session = (
        (JTableSpec, JClients, JConsumer, JSession) if jax_side
        else (TTableSpec, TClients, TConsumer, TSession))
    feed = _serve_feed_j if jax_side \
        else (lambda c, s: torch.full((2, 4), float(100 * c + s)))
    kw = {} if jax_side else {"device": "cpu"}
    return Session(
        tables=[Spec("sreq", shape=(2, 4), capacity=32),
                Spec("sres", shape=(2, 4), capacity=32)],
        components=[
            Clients(feed, table="sreq", clients=2, requests=3,
                    submit=True, collect=False, name="writers"),
            Consumer("m", table="sreq", results="sres", clients=2,
                     requests=3, max_batch=2, name="serving"),
            Clients(feed, table="sreq", clients=2, requests=3,
                    submit=False, collect=True, name="readers")],
        faults=faults, **kw)


@pytest.mark.chaos
def test_serving_chaos_cell():
    preload = {
        "jax": lambda srv: srv.set_model("m", lambda p, x: p * x + 1.0,
                                         jnp.asarray(2.0)),
        "torch": lambda srv: srv.set_model("m", lambda p, x: p * x + 1.0,
                                           torch.tensor(2.0))}
    out = {}
    for pkg, f in (("jax", jfaults), ("torch", tfaults)):
        base = _run_checked(_serving_session(pkg, _plan(f, ())),
                            preload=preload[pkg])
        chaos = _run_checked(_serving_session(pkg, _plan(f, SERVE_FAULTS)),
                             preload=preload[pkg])
        out[pkg] = (base, chaos)
    (jbase, (jplan, jres)), (tbase, (tplan, tres)) = out["jax"], out["torch"]
    assert _plan_rows(tplan) == _plan_rows(jplan)
    assert tplan.faults == jplan.faults
    f = dict(tplan.faults)
    assert f["recoveries"] == 1 and tres.restarts == 2
    assert tres.server.stats()["model_swaps"] == tplan.model_swaps == 1
    for name in ("sreq", "sres"):
        jt, tt = _table(jres, name, True), _table(tres, name, False)
        _equal_tables(jt, _table(jbase[1], name, True))
        _equal_tables(tt, _table(tbase[1], name, False))
        _equal_tables(jt, tt)
    jresp = jres.output("readers").responses
    tresp = tres.output("readers").responses
    tbresp = tbase[1].output("readers").responses
    assert sorted(tresp) == sorted(jresp) == [(c, s) for c in range(2)
                                              for s in range(3)]
    for k in jresp:
        assert torch.equal(tresp[k], tbresp[k])
        np.testing.assert_array_equal(tresp[k].numpy(), np.asarray(jresp[k]))
    assert tres.output("serving").batches == 3


def _grid_shape(seed: int) -> dict:
    """The reference chaos grid's draw (``_run_chaos_scenario``)."""
    rng = random.Random(seed)
    return dict(per_verb=rng.random() < 0.3, steps=rng.randint(6, 12),
                emit_every=rng.randint(1, 2), chunk=rng.randint(2, 5),
                epochs=rng.randint(1, 2))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(9))
def test_random_plans_in_the_port(seed, same_weights):
    sh = _grid_shape(seed)
    kw = dict(tables=("field",), verbs=("put", "capture", "sample"),
              components=("producer", "trainer"), n_events=3,
              max_index=sh["steps"])
    tplan_f = tfaults.FaultPlan.random(
        seed, retry=tfaults.RetryPolicy(seed=seed, **FAST), **kw)
    jplan_f = jfaults.FaultPlan.random(
        seed, retry=jfaults.RetryPolicy(seed=seed, **FAST), **kw)
    base = _run_checked(_training_session(
        "torch", _plan(tfaults, (), seed), draws=False, **sh))[1]
    tplan, res = _run_checked(_training_session("torch", tplan_f,
                                                draws=False, **sh))
    jplan = _training_session("jax", jplan_f, **sh).plan()
    assert _plan_rows(tplan) == _plan_rows(jplan)
    assert tplan.faults == jplan.faults
    _equal_tables(_table(base, "field", False), _table(res, "field", False))
    assert res.server.watermark("field") \
        == res.server.watermark_device("field")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(base.output("trainer").state),
        tree_leaves(res.output("trainer").state)))
