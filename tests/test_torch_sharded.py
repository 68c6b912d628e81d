"""Port parity for the slab-sharded data plane and the DDP fused epoch
(trainer tiers ``sharded_fused`` and ``slab_sharded``).

* The sharded gather's plain version equals the reference's Pallas kernel
  in interpret mode EXACTLY, for D = 1, 2, 4 shards of f32 and i32 slabs,
  at every shard's offset, with slots on every shard's first and last
  slot; the shards' results sum to the whole gather.
* A table split over a 2- or 4-rank mesh takes the same server verbs as a
  whole one (``put``, ``put_stream``, a ring-wrapping ``capture_scan``,
  single and multi-rank): concatenated shards, keys, version, ptr, count,
  ``op_count`` and watermarks byte-identical, ``sample`` equal.
* From ONE reference subprocess at mesh 2 (``--xla_force_host_platform_
  device_count=2``; a JAX mesh cannot be built in this process, which
  has one device): the reference's ``sharded_fused`` and ``slab_sharded``
  epochs (2 epochs each, the same numpy-seeded weights and table), their
  draws fed to the port, against the port's on a 2-rank CPU mesh: params
  rtol 2e-5 / atol 1e-6, train loss rtol 1e-5, val loss and relative
  error rtol 1e-4 (the reference's own mesh-vs-single-device tolerances,
  ``tests/test_sharded_epoch.py``); and the reference session's plan.
* In the port, ``slab_sharded`` equals ``sharded_fused`` under
  ``torch.equal`` at D = 2 and 4, makes no ``all_gather`` (the replicated
  entry makes one an epoch on a sharded table), and a CPU session with a
  slab-sharded trainer runs as planned.
* ``trainer_tier`` and ``TrainerConfig`` give the reference's tier or
  error over its whole override matrix.

The autoencoder is small (128 points, latent 16, filter MLP 16 wide) so
the file stays within about a minute on one core; the reference
subprocess's time is recorded as the junit property
``reference_subprocess_s``.
"""

import json
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from conftest import run_subprocess
from repro.insitu import plan as jplan
from repro.kernels.store import ops as jops
from repro.ml import autoencoder as jae
from repro.ml import trainer as jtr


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TS, tops, tae, ttr, topt, tplan, C, data_mesh
    global slab_sharding, StoreServer, Client, TSession, TProducer, TTrainer
    global tree_leaves
    import torch
    from repro_torch.core import Client, StoreServer
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import TrainerConsumer as TTrainer
    from repro_torch.insitu import plan as tplan
    from repro_torch.kernels.store import ops as tops
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import trainer as ttr
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import data_mesh, slab_sharding
    from repro_torch.train import optimizer as topt
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)


TESTS = Path(__file__).resolve().parent
# the parity config: 128 points, the reference test's AE widths
N, CAP, PUTS, GATHER, BATCH, EPOCHS, SEED = 128, 16, 20, 6, 4, 2, 3
# the port-only config: a tiny AE
_TINY = dict(n_points=64, channels=4, internal=4, latent=4, blocks=2,
             pool=4, mlp_width=8, mlp_depth=2)
# the reference session whose plan the port's must equal
PLAN_STEPS, PLAN_EMIT, PLAN_EPOCHS = 13, 2, 2


def _snaps() -> np.ndarray:
    return np.random.default_rng(SEED).standard_normal(
        (PUTS, 4, N)).astype(np.float32)


def _coords(n: int) -> np.ndarray:
    return np.random.default_rng(1).random((n, 3)).astype(np.float32)


def _mu_sd(snaps):
    return (snaps.mean(axis=(0, 2)).astype(np.float32),
            (snaps.std(axis=(0, 2)) + 1e-6).astype(np.float32))


def _jcfg():
    return jae.AEConfig(n_points=N, mode="ref", latent=16, mlp_width=16)


def _sorted_leaves(tree) -> list:
    """Leaves with dict keys sorted (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sorted_leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# The sharded gather: plain version vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_gather_ref_matches_interpret(D, dtype):
    rng = np.random.default_rng(D)
    cl = CAP // D
    slab = (rng.standard_normal((CAP, 4, 8)) * 100).astype(dtype)
    edges = [s for r in range(D) for s in (r * cl, r * cl + cl - 1)]
    slots = np.array(edges + list(rng.integers(0, CAP, 3)), np.int32)
    total = None
    for r in range(D):
        local = slab[r * cl:(r + 1) * cl]
        want = np.asarray(jops.gather_rows_sharded(
            jnp.asarray(local), jnp.asarray(slots), r * cl,
            mode="interpret"))
        got = tops.gather_rows_sharded(torch.as_tensor(local),
                                       torch.as_tensor(slots), r * cl)
        np.testing.assert_array_equal(got.numpy(), want)
        total = got if total is None else total + got
    np.testing.assert_array_equal(total.numpy(), slab[slots])


# ---------------------------------------------------------------------------
# Sharded table ≡ whole table under the same verbs
# ---------------------------------------------------------------------------

def _drive(server: "StoreServer", spec, snaps) -> None:
    """put, put_stream, then captures that wrap the ring (one rank, two)."""
    client = Client(server)
    for i in range(3):
        server.put(spec.name, TS.make_key(0, i), snaps[i])
    keys = torch.stack([TS.make_key(1, i) for i in range(5)])
    server.put_stream(spec.name, keys, torch.as_tensor(snaps[3:8]))

    def one(carry, t):
        return carry + 1, TS.make_key(2, t), torch.as_tensor(snaps[t % 20])

    def multi(carry, rank, t):
        return carry, TS.make_key(rank, t), \
            torch.as_tensor(snaps[(t + rank) % 20]) * (rank + 1)

    client.capture_scan(spec.name, one, torch.zeros(()), CAP + 3)
    client.capture_scan(spec.name, multi, torch.zeros((2,)), 5, n_ranks=2)


@pytest.mark.parametrize("engine", ["ring", "hash"])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_table_matches_whole_table(D, engine):
    spec = TS.TableSpec("field", shape=(4, N), capacity=CAP, engine=engine)
    snaps = _snaps()
    whole, split = StoreServer(device="cpu"), StoreServer(device="cpu")
    whole.create_table(spec)
    placement = slab_sharding(spec, data_mesh(D, devices=["cpu"] * D))
    split.create_table(spec, slab_sharding=placement)
    assert split.placement("field") is placement and placement.local_cap \
        == CAP // D
    for server in (whole, split):
        _drive(server, spec, snaps)
    a, b = whole.checkout("field"), split.checkout("field")
    assert isinstance(b.slab, TS.ShardedSlab) and len(b.slab.shards) == D
    assert all(s.shape == (CAP // D, 4, N) for s in b.slab.shards)
    assert torch.cat(b.slab.shards).numpy().tobytes() \
        == a.slab.numpy().tobytes()
    for field in ("keys", "version", "ptr", "count"):
        assert getattr(a, field).numpy().tobytes() \
            == getattr(b, field).numpy().tobytes(), field
    sa, sb = whole.stats(), split.stats()
    assert (sa["op_count"], sa["watermarks"]) \
        == (sb["op_count"], sb["watermarks"])
    draw = torch.as_tensor(np.random.default_rng(D).random(GATHER),
                           dtype=torch.float32)
    va, ka, oka = whole.sample("field", draw)
    vb, kb, okb = split.sample("field", draw)
    assert torch.equal(va, vb) and torch.equal(ka, kb) and bool(oka & okb)
    keys = torch.cat([a.keys[:3], torch.tensor([12345])])
    for got, want in zip(TS.get_many(spec, b, keys),
                         TS.get_many(spec, a, keys)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The mesh epochs against the reference's at mesh 2
# ---------------------------------------------------------------------------

_REFERENCE = """
    import json, sys, time
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, {tests!r})
    from _torch_parity import np_autoencoder_params
    from repro.core import TableSpec
    from repro.core import store as S
    from repro.insitu import InSituSession, Producer, TrainerConsumer
    from repro.ml import autoencoder as ae, trainer as tr
    from repro.parallel.sharding import data_mesh, slab_sharding
    from repro.train import optimizer as opt

    N, CAP, GATHER, EPOCHS = {N}, {CAP}, {GATHER}, {EPOCHS}
    inputs = np.load({inputs!r})
    snaps = inputs["snaps"]
    aecfg = ae.AEConfig(n_points=N, mode="ref", latent=16, mlp_width=16)
    levels = ae.coords_pyramid(aecfg, jnp.asarray(inputs["coords"]))
    spec = TableSpec("field", shape=(4, N), capacity=CAP)
    st = S.init_table(spec)
    for i in range(len(snaps)):
        st = S.put(spec, st, S.make_key(0, i), jnp.asarray(snaps[i]))
    mesh = data_mesh(2)
    rep = NamedSharding(mesh, P())
    st_sh = S.TableState(jax.device_put(st.slab, slab_sharding(spec, mesh)),
                         *(jax.device_put(x, rep) for x in st[1:]))
    tx = opt.adam(1e-3)
    params = jax.tree.map(jnp.asarray,
                          np_autoencoder_params(aecfg, {seed}))
    state0 = tr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    mu, sd = jnp.asarray(inputs["mu"]), jnp.asarray(inputs["sd"])
    out = {{}}
    t0 = time.perf_counter()
    for tier, table in (("sharded_fused", st), ("slab_sharded", st_sh)):
        cfg = tr.TrainerConfig(ae=aecfg, gather=GATHER, batch_size={BATCH},
                               lr=1e-3, mesh=mesh,
                               slab_sharded=tier == "slab_sharded")
        epoch = tr.EPOCH_BUILDERS[tier](cfg, levels, tx, spec)
        state = state0
        for e in range(EPOCHS):
            state, m = epoch(table, state, jax.random.key(7 + e), mu, sd)
            out[f"{{tier}}/metrics{{e}}"] = np.array([float(x)
                                                      for x in m[:3]])
        for i, leaf in enumerate(jax.tree.leaves(state.params)):
            out[f"{{tier}}/param{{i}}"] = np.asarray(leaf)
    out["epochs_s"] = np.array(time.perf_counter() - t0)
    # each epoch's draws, as _epoch_data takes them from its key
    nvalid = jnp.maximum(jnp.sum((st.version > 0).astype(jnp.int32)), 1)
    out["nvalid"] = np.array(int(nvalid))
    for e in range(EPOCHS):
        k_samp, k_val, k_perm = jax.random.split(jax.random.key(7 + e), 3)
        out[f"ranks{{e}}"] = np.asarray(
            jax.random.randint(k_samp, (GATHER,), 0, nvalid))
        out[f"val_idx{{e}}"] = np.asarray(
            jax.random.randint(k_val, (), 0, GATHER))
        out[f"perm{{e}}"] = np.asarray(
            jax.random.permutation(k_perm, GATHER - 1))
    # the plan of a session with a slab-sharded trainer
    tiny = ae.AEConfig(**{tiny!r})
    sess = InSituSession(tables=[TableSpec("field", shape=(4, 64),
                                           capacity=CAP)], components=[
        Producer(lambda c, r, t: (c, S.make_key(r, t), jnp.zeros((4, 64))),
                 table="field", steps={steps}, carry=jnp.zeros(()),
                 emit_every={emit}),
        TrainerConsumer(tr.TrainerConfig(ae=tiny, epochs={plan_epochs},
                                         gather=GATHER, batch_size={BATCH},
                                         mesh=mesh, slab_sharded=True),
                        jnp.zeros((64, 3)))])
    out["plan"] = np.array(json.dumps([
        [c.name, c.kind, c.tier, c.chunk, c.mesh_devices,
         [list(d) for d in c.dispatches]] for c in sess.plan().components]))
    np.savez({result!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One subprocess with two forced host devices: the reference's mesh
    epochs, their draws, and its session plan → an ``.npz``."""
    tmp = tmp_path_factory.mktemp("sharded")
    snaps = _snaps()
    mu, sd = _mu_sd(snaps)
    np.savez(tmp / "inputs.npz", snaps=snaps, coords=_coords(N), mu=mu,
             sd=sd)
    t0 = time.perf_counter()
    run_subprocess(_REFERENCE.format(
        tests=str(TESTS), N=N, CAP=CAP, GATHER=GATHER, EPOCHS=EPOCHS,
        BATCH=BATCH, seed=SEED, inputs=str(tmp / "inputs.npz"),
        result=str(tmp / "result.npz"), tiny=_TINY, steps=PLAN_STEPS,
        emit=PLAN_EMIT, plan_epochs=PLAN_EPOCHS), n_devices=2)
    seconds = time.perf_counter() - t0
    return dict(np.load(tmp / "result.npz")), seconds, snaps, mu, sd


def _port_epochs(tier: str, D: int, snaps, mu, sd, draws, cfg_ae, coords,
                 params):
    """The port's mesh epochs over a table filled with ``snaps``."""
    mesh = data_mesh(D, devices=["cpu"] * D)
    spec = TS.TableSpec("field", shape=(4, cfg_ae.n_points), capacity=CAP)
    slab = tier == "slab_sharded"
    table = TS.init_table(spec, slab_sharding(spec, mesh) if slab else None,
                          device="cpu")
    for i, snap in enumerate(snaps):
        table = TS.put(spec, table, TS.make_key(0, i), snap)
    cfg = ttr.TrainerConfig(ae=cfg_ae, gather=GATHER, batch_size=BATCH,
                            lr=1e-3, mesh=mesh, slab_sharded=slab)
    tx = topt.adam(cfg.scaled_lr)
    epoch = ttr.EPOCH_BUILDERS[tier](
        cfg, tae.coords_pyramid(cfg_ae, torch.as_tensor(coords)), tx, spec)
    state = ttr.train_state_from_numpy(params, device="cpu")
    metrics = []
    for d in draws:
        state, m = epoch(table, state, d, torch.as_tensor(mu),
                         torch.as_tensor(sd))
        metrics.append([float(x) for x in m[:3]])
    return state, metrics


@pytest.mark.parametrize("tier", ["sharded_fused", "slab_sharded"])
def test_mesh_epochs_match_reference(reference, tier, record_property):
    ref, seconds, snaps, mu, sd = reference
    record_property("reference_subprocess_s", seconds)
    nvalid = int(ref["nvalid"])
    draws = [ttr.EpochDraws(
        torch.as_tensor(uniforms_for_ranks(ref[f"ranks{e}"], nvalid)),
        torch.as_tensor(ref[f"val_idx{e}"]), torch.as_tensor(ref[f"perm{e}"]))
        for e in range(EPOCHS)]
    jcfg = _jcfg()
    state, metrics = _port_epochs(
        tier, 2, snaps, mu, sd, draws, torch_ae_config(jcfg), _coords(N),
        np_autoencoder_params(jcfg, SEED))
    got = _sorted_leaves(state.params)
    assert len(got) == sum(k.startswith(f"{tier}/param") for k in ref)
    for i, leaf in enumerate(got):
        np.testing.assert_allclose(leaf.numpy(), ref[f"{tier}/param{i}"],
                                   rtol=2e-5, atol=1e-6, err_msg=str(i))
    assert int(state.step) == EPOCHS * 2
    for e, m in enumerate(metrics):
        want = ref[f"{tier}/metrics{e}"]
        np.testing.assert_allclose(m[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(m[1:], want[1:], rtol=1e-4)


def test_session_plan_matches_reference(reference):
    """The port's plan of the reference subprocess's session declaration
    (a slab-sharded trainer on a 2-rank mesh): the same tiers, chunks,
    mesh sizes and predicted dispatches."""
    ref = json.loads(str(reference[0]["plan"]))
    sess = _tiny_session(PLAN_STEPS, PLAN_EPOCHS, slab=True)
    got = [[c.name, c.kind, c.tier, c.chunk, c.mesh_devices,
            [list(d) for d in c.dispatches]] for c in sess.plan().components]
    assert got == ref


# ---------------------------------------------------------------------------
# The port alone: tier equality, collectives, the session
# ---------------------------------------------------------------------------

def _tiny_session(steps, epochs, slab, D=2, tier=None):
    cfg_ae = tae.AEConfig(**_TINY)
    coords = torch.as_tensor(_coords(64))

    def step(carry, rank, t):
        value = torch.arange(256.0).reshape(4, 64) * (t + 1) / 256 + rank
        return carry, TS.make_key(rank, t), value

    cfg = ttr.TrainerConfig(ae=cfg_ae, epochs=epochs, gather=GATHER,
                            batch_size=BATCH, lr=1e-3,
                            mesh=data_mesh(D, devices=["cpu"] * D),
                            slab_sharded=slab)
    return TSession(
        tables=[TS.TableSpec("field", shape=(4, 64), capacity=CAP)],
        components=[TProducer(step, table="field", steps=steps,
                              carry=torch.zeros(()), emit_every=PLAN_EMIT),
                    TTrainer(cfg, coords, tier=tier)],
        device="cpu")


@pytest.mark.parametrize("D", [2, 4])
def test_slab_sharded_equals_sharded_fused(D):
    """Same table contents, same draws: the final TrainState and metrics
    of the two entries are equal (``torch.equal``: the psum turns a -0.0
    row into +0.0)."""
    snaps = np.random.default_rng(D).standard_normal(
        (PUTS, 4, 64)).astype(np.float32)
    mu, sd = _mu_sd(snaps)
    gen = torch.Generator().manual_seed(D)
    draws = [ttr.draw_epoch(ttr.TrainerConfig(ae=tae.AEConfig(**_TINY),
                                              gather=GATHER), gen, "cpu")
             for _ in range(EPOCHS)]
    jcfg = jae.AEConfig(**_TINY)
    params = np_autoencoder_params(jcfg, SEED)
    out = {}
    for tier in ("sharded_fused", "slab_sharded"):
        C.reset_counts()
        out[tier] = _port_epochs(tier, D, snaps, mu, sd, draws,
                                 tae.AEConfig(**_TINY), _coords(64), params)
        assert C.COUNTS["all_gather"] == 0
    (sa, ma), (sb, mb) = out["sharded_fused"], out["slab_sharded"]
    assert ma == mb
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(sa), tree_leaves(sb)))


def test_collective_counts_by_entry():
    """``slab_sharded`` never all-gathers; ``sharded_fused`` on a sharded
    table all-gathers once an epoch.  Each microstep psums the loss and
    the gradients, each slab-sharded gather psums once."""
    spec = TS.TableSpec("field", shape=(4, 64), capacity=CAP)
    mesh = data_mesh(2, devices=["cpu"] * 2)
    table = TS.init_table(spec, slab_sharding(spec, mesh), device="cpu")
    for i in range(PUTS):
        table = TS.put(spec, table, TS.make_key(0, i),
                       torch.full((4, 64), float(i)))
    cfg_ae = tae.AEConfig(**_TINY)
    levels = tae.coords_pyramid(cfg_ae, torch.as_tensor(_coords(64)))
    tx = topt.adam(1e-3)
    state = ttr.init_state(ttr.TrainerConfig(ae=cfg_ae),
                           torch.Generator().manual_seed(0), tx, "cpu")
    gen = torch.Generator().manual_seed(0)
    n_batches = -(-(GATHER - 1) // BATCH)
    for slab, gathers, reduces in ((True, 0, 1 + 2 * n_batches),
                                   (False, 1, 2 * n_batches)):
        cfg = ttr.TrainerConfig(ae=cfg_ae, gather=GATHER, batch_size=BATCH,
                                mesh=mesh, slab_sharded=slab)
        epoch = ttr.make_sharded_fused_epoch(cfg, levels, tx, spec)
        C.reset_counts()
        for _ in range(3):
            state, _ = epoch(table, state, ttr.draw_epoch(cfg, gen, "cpu"),
                             torch.zeros(4), torch.ones(4))
        assert C.COUNTS == {"all_gather": 3 * gathers,
                            "all_reduce": 3 * reduces,
                            "collective_permute": 0}, (slab, C.COUNTS)


def test_slab_sharded_session_runs_as_planned():
    sess = _tiny_session(PLAN_STEPS, PLAN_EPOCHS, slab=True)
    plan = sess.plan()
    entry = plan.component("trainer")
    assert (entry.tier, entry.mesh_devices) == ("slab_sharded", 2)
    assert "mesh=2dev" in plan.describe()
    C.reset_counts()
    res = sess.run(plan=plan, sequential=True, max_wall_s=120)
    assert res.ok, {k: c.error for k, c in res.run.components.items()}
    stats = res.server.stats()
    assert stats["op_count"] == plan.store_dispatches
    for c in plan.components:
        assert res.op_delta(c.name) == c.store_dispatches, c.name
    placement = res.server.placement("field")
    assert placement is not None and placement.local_cap == CAP // 2
    assert stats["slab_bytes"]["field"] == {"cpu": CAP * 4 * 64 * 4}
    # warm-up + epochs, each one gather psum and two per microstep, and
    # the bootstrap's gather
    n_batches = -(-(GATHER - 1) // BATCH)
    assert C.COUNTS == {"all_gather": 0, "all_reduce":
                        (PLAN_EPOCHS + 1) * (1 + 2 * n_batches) + 1,
                        "collective_permute": 0}
    hist = res.output("trainer").history
    assert len(hist) == PLAN_EPOCHS
    assert all(np.isfinite(h.train_loss) for h in hist)


# ---------------------------------------------------------------------------
# Tier resolution and config validation against the reference's
# ---------------------------------------------------------------------------

_CFGS = {"fused": dict(), "per_verb": dict(fused=False),
         "mesh": dict(mesh=True), "mesh_slab": dict(mesh=True,
                                                     slab_sharded=True),
         "mesh_unfused": dict(mesh=True, fused=False),
         "slab_no_mesh": dict(slab_sharded=True)}


def _outcome(fn):
    try:
        return ("tier", fn())
    except (ValueError, NotImplementedError) as exc:
        return ("error", type(exc).__name__)


def _config(pkg, kind):
    kw = dict(_CFGS[kind])
    if pkg == "jax":
        if kw.pop("mesh", False):
            kw["mesh"] = "a mesh"           # the rules only test for None
        return jtr.TrainerConfig(ae=jae.AEConfig(**_TINY), **kw)
    if kw.pop("mesh", False):
        kw["mesh"] = data_mesh(1, devices=["cpu"])
    return ttr.TrainerConfig(ae=tae.AEConfig(**_TINY), **kw)


@pytest.mark.parametrize("kind", sorted(_CFGS))
def test_trainer_tier_matrix_matches_reference(kind):
    """Every config kind × every override (None, each port tier, the
    clustered one among them, an unknown name): the same tier or the same
    error type; without ``db_mesh`` the clustered tier raises the
    reference's ``ValueError``."""
    jcfg = _outcome(lambda: _config("jax", kind))
    tcfg = _outcome(lambda: _config("torch", kind))
    assert (jcfg[0], tcfg[0]) in (("tier", "tier"), ("error", "error"))
    if jcfg[0] == "error":
        assert tcfg == jcfg
        return
    jc, tc = jcfg[1], tcfg[1]
    for override in (None, *tplan.TRAINER_TIERS, "bogus"):
        assert _outcome(lambda: tplan.trainer_tier(tc, override)) \
            == _outcome(lambda: jplan.trainer_tier(jc, override)), override
    with pytest.raises(ValueError):
        tplan.trainer_tier(tc, "slab_sharded_clustered")


def test_mesh_and_ddp_validation():
    """The epoch builder's divisibility errors (the reference's text), the
    ddp modes, a deployment the port does not run, and the entry points
    that default to the card."""
    cfg_ae = tae.AEConfig(**_TINY)
    mesh3 = data_mesh(3, devices=["cpu"] * 3)
    spec = TS.TableSpec("field", shape=(4, 64), capacity=CAP)
    tx = topt.adam(1e-3)
    with pytest.raises(ValueError, match="batch_size 4 must divide by mesh "
                                         "axis 'data' size 3"):
        ttr.make_sharded_fused_epoch(ttr.TrainerConfig(
            ae=cfg_ae, mesh=mesh3), None, tx, spec)
    mesh3b = data_mesh(3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="capacity 16 divisible by mesh "
                                         "axis 'data' size 3"):
        ttr.make_sharded_fused_epoch(ttr.TrainerConfig(
            ae=cfg_ae, batch_size=3, mesh=mesh3b, slab_sharded=True), None,
            tx, spec)
    assert slab_sharding(spec, mesh3) is None
    int8 = ttr.TrainerConfig(ae=cfg_ae, mesh=mesh3, ddp="int8")
    assert int8.ddp_error_feedback
    with pytest.raises(ValueError, match="unknown ddp mode"):
        ttr.TrainerConfig(ae=cfg_ae, mesh=mesh3, ddp="int4")
    clustered = ttr.TrainerConfig(ae=cfg_ae, batch_size=3, mesh=mesh3,
                                  slab_sharded=True, db_mesh=mesh3,
                                  db_axis="data")
    assert tplan.trainer_tier(clustered) == "slab_sharded_clustered"
    with pytest.raises(ValueError, match="needs slab_sharded=True"):
        ttr.TrainerConfig(ae=cfg_ae, mesh=mesh3, db_mesh=mesh3)
    with pytest.raises(NotImplementedError, match="the port runs the local"):
        StoreServer(device="cpu").create_table(spec, deployment="colocated")
    mesh = data_mesh(2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2} and mesh.distinct_devices == \
        (torch.device("cpu"),)
    with pytest.raises(ValueError):
        data_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        for fn in (data_mesh, lambda: data_mesh(2),
                   lambda: data_mesh(2, devices=["cuda:0"] * 2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


def test_mesh_axis_is_the_mesh_axis():
    """The port's mesh is 1-D: ``TrainerConfig.mesh_axis`` must name its
    one axis, and a mesh's placement follows that axis whatever its name."""
    cfg_ae = tae.AEConfig(**_TINY)
    mesh = data_mesh(2, axis="dp", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="mesh_axis 'data' is not the "
                                         "mesh's axis 'dp'"):
        ttr.TrainerConfig(ae=cfg_ae, mesh=mesh)
    cfg = ttr.TrainerConfig(ae=cfg_ae, mesh=mesh, mesh_axis="dp",
                            slab_sharded=True)
    spec = TS.TableSpec("field", shape=(4, 8), capacity=CAP)
    placement = slab_sharding(spec, cfg.mesh)
    assert placement.mesh.shape == {"dp": 2} \
        and placement.local_cap == CAP // 2
    state = TS.init_table(spec, device="cpu")
    with pytest.raises(ValueError, match="not slab-sharded"):
        TS.sample_sharded_impl(spec, state, torch.zeros(GATHER))
