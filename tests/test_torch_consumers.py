"""Port parity for multi-consumer training (``TrainerConsumer(count > 1)``
on ``parallel.sharding.disjoint_data_meshes``), the capacity-cut
co-located deployment (``Colocated(capacity_axis=)``) and the launcher's
``--consumers``.

* ONE reference subprocess with four forced host devices: the twin of
  ``tests/test_session.py:480-560``'s multi-consumer session (a producer
  of numpy-made snapshots, ``TrainerConsumer(count=2)``, three epochs, the
  same numpy-seeded weights a replica seed in both packages, the
  reference's draws of each replica fed to the port): replica names,
  tiers and mesh sizes, every entry's predicted dispatches and
  ``op_delta``, and each replica's params within the reference's mesh
  tolerances (rtol 2e-5 / atol 1e-6, ``tests/test_sharded_epoch.py:
  62-65``) and losses (train 1e-5, val 1e-4); the replicas' params differ.
* In the port: replica 0 of a two-replica session equals a one-trainer
  session on the same mesh and draws (``torch.equal``); the device pool
  (``devices=``, the session's device, the remainder left idle); a
  ``count > 1`` trainer given a mesh (its sibling's) or the wrong number
  of draws raises.
* The twin of ``tests/test_session.py:371-380``: a ``sharded_fused``
  trainer reading a ``Colocated(capacity_axis="data")`` table is predicted
  to all-gather it (as the reference predicts) and measured to, and
  trains bit for bit as on a local table; serving on such a table is
  predicted to all-reduce its reads and measured to, its responses equal
  to the local run's.
* ``launch.insitu.run(consumers=2)`` at its smoke size on the CPU: two
  ``fused`` replicas, the plan held against ``stats()``.

The reference subprocess's time is recorded as the junit property
``reference_subprocess_s``.
"""

import json
import time
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from conftest import run_subprocess
from repro.insitu import plan as jplan
from repro.ml import autoencoder as jae

TESTS = Path(__file__).resolve().parent
N, CAP, STEPS, EMIT, GATHER, BATCH, EPOCHS, SEED = 64, 16, 20, 2, 6, 4, 3, 0
_AE = dict(n_points=N, channels=4, internal=4, latent=4, blocks=1, pool=4,
           mlp_width=8, mlp_depth=2)
SHAPE = (2, 3)


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection (every xdist worker collects every test file)."""
    global torch, TS, dep, ttr, tplan, TSession, TProducer, TTrainer
    global TClients, TServing, data_mesh, disjoint_data_meshes, tlaunch
    global tree_leaves
    import torch
    from repro_torch.core import deployment as dep
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import ServingClients as TClients
    from repro_torch.insitu import ServingConsumer as TServing
    from repro_torch.insitu import TrainerConsumer as TTrainer
    from repro_torch.insitu import plan as tplan
    from repro_torch.launch import insitu as tlaunch
    from repro_torch.ml import trainer as ttr
    from repro_torch.parallel.sharding import data_mesh, disjoint_data_meshes
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)


def _snaps() -> np.ndarray:
    return np.random.default_rng(11).standard_normal(
        (STEPS, 4, N)).astype(np.float32)


def _coords() -> np.ndarray:
    return np.random.default_rng(1).random((N, 3)).astype(np.float32)


_REFERENCE = """
import json, sys, time
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
from _torch_parity import np_autoencoder_params
from repro.core import TableSpec
from repro.core import store as S
from repro.insitu import InSituSession, Producer, TrainerConsumer
from repro.ml import autoencoder as ae, trainer as tr

inputs = np.load({inputs!r})
snaps = jnp.asarray(inputs["snaps"])
aecfg = ae.AEConfig(**{ae!r})


def init_state(cfg, key, tx):
    # the numpy weights of the replica's seed, in both packages
    p = jax.tree.map(jnp.asarray, np_autoencoder_params(aecfg, cfg.seed))
    return tr.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))


tr.init_state = init_state
cfg = tr.TrainerConfig(ae=aecfg, epochs={epochs}, gather={gather},
                       batch_size={batch}, lr=1e-3, seed={seed})
sess = InSituSession(
    tables=[TableSpec("field", shape=(4, {n}), capacity={cap})],
    components=[
        Producer(lambda c, r, t: (c, S.make_key(r, t), snaps[t]),
                 table="field", steps={steps}, carry=jnp.zeros(()),
                 emit_every={emit}),
        TrainerConsumer(cfg, jnp.asarray(inputs["coords"]), count=2)])
t0 = time.perf_counter()
plan = sess.plan()
res = sess.run(plan=plan, sequential=True, max_wall_s=380)
assert res.ok, {{k: v.error for k, v in res.run.components.items()}}
out = {{"plan": [[c.name, c.kind, c.tier, c.mesh_devices,
                 [list(d) for d in c.dispatches]] for c in plan.components],
       "op_delta": {{c.name: res.op_delta(c.name) for c in plan.components}},
       "seconds": time.perf_counter() - t0}}
for name in ("trainer0", "trainer1"):
    o = res.output(name)
    out[name] = {{"params": [np.asarray(x).ravel().tolist()
                            for x in jax.tree.leaves(o.state.params)],
                 "history": [[h.train_loss, h.val_loss, h.val_rel_error]
                             for h in o.history]}}
print("RESULT" + json.dumps(out))
"""


def _reference_draws(seed: int, nvalid: int,
                     bootstrap: bool) -> "ttr.TrainDraws":
    """The draws the reference's ``insitu_train`` takes from its key
    ``seed + 1`` (a replica's seed): the bootstrap sample, split off only
    by the trainer that bootstraps, then per epoch the sample ranks (as
    the uniforms that give them back), the held-out index and the
    permutation."""
    top = jnp.maximum(jnp.int32(nvalid), 1)

    def sample(k):
        ranks = jax.random.randint(k, (GATHER,), 0, top)
        return torch.as_tensor(uniforms_for_ranks(ranks, nvalid))

    rng = jax.random.key(seed + 1)
    if bootstrap:
        rng, k = jax.random.split(rng)
    boot = sample(k) if bootstrap else torch.zeros(GATHER)
    epochs = []
    for _ in range(EPOCHS):
        rng, k_ep = jax.random.split(rng)
        k_samp, k_val, k_perm = jax.random.split(k_ep, 3)
        epochs.append(ttr.EpochDraws(
            sample(k_samp),
            torch.as_tensor(np.array(jax.random.randint(k_val, (), 0,
                                                        GATHER))),
            torch.as_tensor(np.array(jax.random.permutation(
                k_perm, GATHER - 1)))))
    return ttr.TrainDraws(boot, epochs)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("consumers")
    np.savez(tmp / "inputs.npz", snaps=_snaps(), coords=_coords())
    t0 = time.perf_counter()
    text = run_subprocess(_REFERENCE.format(
        tests=str(TESTS), inputs=str(tmp / "inputs.npz"), ae=_AE,
        epochs=EPOCHS, gather=GATHER, batch=BATCH, seed=SEED, n=N, cap=CAP,
        steps=STEPS, emit=EMIT), n_devices=4)
    line = [x for x in text.splitlines() if x.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):]), time.perf_counter() - t0


def _init_state(cfg, _gen, tx, device=None):
    """The numpy weights of the replica's seed (the reference's twin)."""
    return ttr.train_state_from_numpy(
        np_autoencoder_params(jae.AEConfig(**_AE), cfg.seed), device=device)


def _session(count=2, mesh=None, devices=("cpu",) * 4, draws=None,
             deployment=None, epochs=EPOCHS):
    snaps = torch.as_tensor(_snaps())
    cfg = ttr.TrainerConfig(ae=torch_ae_config(jae.AEConfig(**_AE)),
                            epochs=epochs, gather=GATHER, batch_size=BATCH,
                            lr=1e-3, seed=SEED, mesh=mesh)
    return TSession(
        tables=[TS.TableSpec("field", shape=(4, N), capacity=CAP)],
        components=[
            TProducer(lambda c, r, t: (c, TS.make_key(r, t), snaps[t]),
                      table="field", steps=STEPS, carry=torch.zeros(()),
                      emit_every=EMIT),
            TTrainer(cfg, torch.as_tensor(_coords()), count=count,
                     draws=draws)],
        device="cpu", devices=devices, deployment=deployment)


def _replica_draws(count=2):
    nvalid = min(-(-STEPS // EMIT), CAP)
    return [_reference_draws(SEED + i, nvalid, i == 0) for i in range(count)]


def _sorted_leaves(tree) -> list:
    """Leaves with dict keys sorted (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sorted_leaves(t)]
    return [tree]


@pytest.fixture(scope="module")
def port_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "init_state", _init_state)
        sess = _session(draws=_replica_draws())
        plan = sess.plan()
        res = sess.run(plan=plan, sequential=True, max_wall_s=300)
    assert res.ok, {k: c.error for k, c in res.run.components.items()}
    return plan, res


def test_plan_and_op_deltas_match_reference(reference, port_run,
                                            record_property):
    ref, seconds = reference
    record_property("reference_subprocess_s", seconds)
    plan, res = port_run
    got = [[c.name, c.kind, c.tier, c.mesh_devices,
            [list(d) for d in c.dispatches]] for c in plan.components]
    assert got == ref["plan"]
    assert [c.name for c in plan.components if c.kind == "trainer"] \
        == ["trainer0", "trainer1"]
    assert all(plan.component(n).tier == "sharded_fused"
               and plan.component(n).mesh_devices == 2
               for n in ("trainer0", "trainer1"))
    for c in plan.components:
        assert res.op_delta(c.name) == c.store_dispatches \
            == ref["op_delta"][c.name]
    assert res.server.stats()["op_count"] == plan.store_dispatches


@pytest.mark.parametrize("name", ["trainer0", "trainer1"])
def test_replica_params_match_reference(reference, port_run, name):
    ref, _ = reference
    _, res = port_run
    out = res.output(name)
    got = _sorted_leaves(out.state.params)
    want = ref[name]["params"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy().ravel(), w, rtol=2e-5,
                                   atol=1e-6, err_msg=f"{name} leaf {i}")
    assert len(out.history) == EPOCHS
    for h, w in zip(out.history, ref[name]["history"]):
        np.testing.assert_allclose(h.train_loss, w[0], rtol=1e-5)
        np.testing.assert_allclose([h.val_loss, h.val_rel_error], w[1:],
                                   rtol=1e-4)


def test_replicas_differ_and_replica_zero_is_one_trainer(port_run):
    """The replicas train from different seeds, so their params differ;
    replica 0 equals a single trainer on the same mesh and draws."""
    _, res = port_run
    a = tree_leaves(res.output("trainer0").state.params)
    b = tree_leaves(res.output("trainer1").state.params)
    assert any(not torch.equal(x, y) for x, y in zip(a, b))
    mesh = disjoint_data_meshes(2, devices=["cpu"] * 4)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "init_state", _init_state)
        single = _session(count=1, mesh=mesh, draws=_replica_draws()[0])
        one = single.run(sequential=True, max_wall_s=300)
    assert one.ok
    assert all(torch.equal(x, y) for x, y in zip(
        a, tree_leaves(one.output("trainer").state.params)))


def test_device_pool_and_replica_errors():
    assert [(c.name, c.tier, c.mesh_devices)
            for c in _session(devices=None).plan().components][1:] \
        == [("trainer0", "fused", 1), ("trainer1", "fused", 1)]
    # five ranks for two replicas: two each, the fifth idle
    plan = _session(devices=("cpu",) * 5).plan()
    assert [plan.component(n).mesh_devices
            for n in ("trainer0", "trainer1")] == [2, 2]
    # consecutive slices of the pool, one a replica
    pool = [torch.device("cpu", i) for i in range(5)]
    meshes = disjoint_data_meshes(2, devices=pool)
    assert [m.devices for m in meshes] == [tuple(pool[:2]),
                                           tuple(pool[2:4])]
    assert disjoint_data_meshes(3, devices=["cpu"] * 5) == [None] * 3
    # the session owns the slicing: a replica given its sibling's mesh
    with pytest.raises(ValueError, match="own the device slicing"):
        _session(mesh=disjoint_data_meshes(2, devices=["cpu"] * 4)[0])
    with pytest.raises(ValueError, match="draws for 2 replicas"):
        _session(draws=_replica_draws(3))
    with pytest.raises(ValueError, match="one TrainDraws"):
        _session(draws=_replica_draws(1)[0])


# ---------------------------------------------------------------------------
# The capacity-cut co-located table (tests/test_session.py:371-380)
# ---------------------------------------------------------------------------

def _capacity_dep():
    return dep.Colocated(data_mesh(2, devices=["cpu"] * 2),
                         elem_spec=(None, None), capacity_axis="data")


def test_capacity_cut_trainer_all_gathers():
    mesh = data_mesh(2, devices=["cpu"] * 2)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "init_state", _init_state)
        for name, d in (("capacity", _capacity_dep()), ("local", None)):
            sess = _session(count=1, mesh=mesh, deployment=d, epochs=2,
                            draws=_replica_draws()[0])
            plan = sess.plan(hlo=True)
            entry = plan.component("trainer")
            assert entry.tier == "sharded_fused"
            for e in plan.components:
                e.check_collectives()           # no false alarm
            res = sess.run(plan=plan, sequential=True, max_wall_s=300)
            assert res.ok, {k: c.error for k, c in
                            res.run.components.items()}
            for e in plan.components:
                assert res.op_delta(e.name) == e.store_dispatches
            runs[name] = (plan, res)
    plan, res = runs["capacity"]
    entry = plan.component("trainer")
    pred = dict(entry.predicted_collectives)
    assert pred["all-gather"] is True
    assert entry.predicted_collectives \
        == jplan.trainer_collective_prediction("sharded_fused", True)
    assert dict(entry.collectives)["all-gather"] > 0
    assert dict(runs["local"][0].component("trainer").collectives)[
        "all-gather"] == 0
    assert isinstance(res.server.checkout("field").slab, TS.ShardedSlab)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(res.output("trainer").state.params),
        tree_leaves(runs["local"][1].output("trainer").state.params)))
    # a prediction with the all-gather removed raises
    wrong = replace(entry, predicted_collectives=tplan._pred(
        all_reduce=True))
    with pytest.raises(AssertionError, match="all-gather"):
        wrong.check_collectives()


def _feed(c, s):
    return torch.full(SHAPE, float(100 * c + s))


@pytest.mark.parametrize("tier", ["continuous_batch", "three_step"])
def test_capacity_cut_serving(tier):
    out = {}
    for name, d in (("capacity", _capacity_dep()), ("local", None)):
        sess = TSession(
            tables=[TS.TableSpec("req", shape=SHAPE, capacity=12),
                    TS.TableSpec("res", shape=SHAPE, capacity=12)],
            components=[
                TClients(_feed, table="req", clients=3, requests=4,
                         collect=False, name="writers"),
                TServing("m", table="req", results="res", clients=3,
                         requests=4, max_batch=4, tier=tier),
                TClients(_feed, table="req", clients=3, requests=4,
                         submit=False, name="readers")],
            deployment=d, device="cpu")
        plan = sess.plan(hlo=name == "capacity")
        res = sess.run(plan=plan, sequential=True, max_wall_s=120,
                       preload=lambda srv: srv.set_model(
                           "m", lambda p, x: p * x + 1.0, torch.tensor(2.0)))
        assert res.ok, {k: c.error for k, c in res.run.components.items()}
        assert res.server.stats()["op_count"] == plan.store_dispatches
        out[name] = res.output("readers").responses
        if name == "capacity":
            entry = plan.component("serving")
            assert dict(entry.predicted_collectives) == {
                "all-reduce": True, "all-gather": False,
                "reduce-scatter": False, "all-to-all": False,
                "collective-permute": False}
            entry.check_collectives()
            assert dict(entry.collectives)["all-reduce"] > 0
    assert sorted(out["capacity"]) == sorted(out["local"])
    for k in out["local"]:
        assert torch.equal(out["capacity"][k], out["local"][k])
        assert torch.equal(out["local"][k], 2.0 * _feed(*k) + 1.0)


def test_launcher_consumers(capsys):
    res = tlaunch.run(epochs=1, sim_steps=8, consumers=2, device="cpu",
                      verbose=False)
    plan = res.plan
    assert [(c.name, c.tier) for c in plan.components] == [
        ("producer", "capture_scan"), ("trainer0", "fused"),
        ("trainer1", "fused"), ("inference", "fused_registry")]
    assert res.server.stats()["op_count"] == plan.store_dispatches
    assert all(len(res.output(n).history) == 1
               for n in ("trainer0", "trainer1"))
    assert "in-situ inference" in capsys.readouterr().out
