"""Port parity for the slice as a whole: the paper's in-situ workflow.

One ``sequential=True`` session in each package at the smoke config — a
flat-plate producer (16 steps, ``emit_every`` 2, ring capacity 12), the
fused trainer (2 epochs, ``gather`` 6, ``batch_size`` 4, lr 1e-3) and
fused-registry inference on 2 later snapshots.  Both packages start from
the same numpy-seeded weights, see the same snapshot bytes (the
reference's, fed to both producers) and draw the same samples: the
reference's own ``jax.random`` draws are computed here and fed to the
port through ``TrainerConsumer(draws=...)``.  Then:

* the plan's predicted dispatches equal ``stats()`` in each package and
  are EQUAL across the packages, and the two tables are byte-identical;
* every epoch's train loss, val loss and relative Frobenius error agree
  within 1e-3 relative (Adam amplifies fp32 ordering differences;
  ``PERF.md`` records the measured maximum);
* each inference output equals the reference's encoder, with the port's
  trained weights, on the same snapshot within 1e-4;

and ``launch.insitu.run(device="cpu")`` runs the small grid end to end;
with ``producer="spectral"`` (one and two producer ranks) its session
tracks the reference launcher's, fed the reference's solver starts, to
the same limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from repro.configs.quadconv_ae import smoke_config, smoke_grid_config
from repro.core import TableSpec as JTableSpec
from repro.core import store as JS
from repro.insitu import InferenceConsumer as JInference
from repro.insitu import InSituSession as JSession
from repro.insitu import Producer as JProducer
from repro.insitu import TrainerConsumer as JTrainer
from repro.ml import autoencoder as jae
from repro.ml import trainer as jtr
from repro.sim import flatplate as jfp


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TTableSpec, TS, TInference, TSession, TProducer, TTrainer
    global tlaunch, ttr
    import torch
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.core import store as TS
    from repro_torch.insitu import InferenceConsumer as TInference
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import TrainerConsumer as TTrainer
    from repro_torch.launch import insitu as tlaunch
    from repro_torch.ml import trainer as ttr
    # tiny shapes: one core, leaving the rest to the other test workers
    torch.set_num_threads(1)


STEPS, EMIT, CAPACITY, EPOCHS, GATHER, N_INF = 16, 2, 12, 2, 6, 2
LOSS_RTOL, INF_TOL = 1e-3, 1e-4


def _reference_draws(cfg, nvalid: int) -> "ttr.TrainDraws":
    """The draws the reference's ``insitu_train`` makes from its key
    ``seed + 1``: the bootstrap sample's ranks, then per epoch the
    sample ranks, the held-out index and the permutation.  The sample
    ranks reach the port as the uniforms that give them back."""
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


@pytest.fixture(scope="module")
def sessions():
    jcfg = smoke_config()
    fcfg = smoke_grid_config()
    n = fcfg.n_points
    key = jax.random.key(7)
    snap = jax.jit(lambda t: jfp.snapshot(fcfg, key, t))
    snaps = np.stack([np.asarray(snap(t)) for t in range(STEPS + N_INF)])
    params = np_autoencoder_params(jcfg, seed=3)
    coords = np.asarray(jfp.grid_coords(fcfg))
    cfg_j = jtr.TrainerConfig(ae=jcfg, epochs=EPOCHS, gather=GATHER,
                              batch_size=4, lr=1e-3)
    cfg_t = ttr.TrainerConfig(ae=torch_ae_config(jcfg), epochs=EPOCHS,
                              gather=GATHER, batch_size=4, lr=1e-3)
    nvalid = JS.capture_emit_count(STEPS, EMIT)
    assert nvalid <= CAPACITY

    def jstep(carry, rank, t):
        return carry, JS.make_key(rank, t), jnp.asarray(snaps)[t]

    def tstep(carry, rank, t):
        return carry, TS.make_key(rank, t), torch.as_tensor(snaps[t])

    def jfeed(client, step):
        mu, sd = client.get_metadata("norm_stats")
        return (jnp.asarray(snaps[STEPS + step]).T[None] - mu) / sd

    def tfeed(client, step):
        mu, sd = client.get_metadata("norm_stats")
        return (torch.as_tensor(snaps[STEPS + step]).T - mu) / sd

    def jinit(cfg, _key, tx):
        p = jax.tree.map(jnp.asarray, params)
        return jtr.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))

    def tinit(cfg, _gen, tx, device=None):
        return ttr.train_state_from_numpy(params, device=device)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "init_state", jinit)
        mp.setattr(ttr, "init_state", tinit)
        for name, pkg in (("jax", (JSession, JTableSpec, JProducer, JTrainer,
                                   JInference, jstep, jfeed, cfg_j,
                                   jnp.asarray(coords), {})),
                          ("torch", (TSession, TTableSpec, TProducer,
                                     TTrainer, TInference, tstep, tfeed,
                                     cfg_t, torch.as_tensor(coords),
                                     {"device": "cpu"}))):
            (Session, Spec, Producer, Trainer, Inference, step, feed, cfg,
             pcoords, where) = pkg
            extra = {"draws": _reference_draws(cfg_j, nvalid)} \
                if name == "torch" else {}
            sess = Session(
                tables=[Spec("field", shape=(4, n), capacity=CAPACITY)],
                components=[
                    Producer(step, table="field", steps=STEPS,
                             emit_every=EMIT),
                    Trainer(cfg, pcoords, model_key="encoder", **extra),
                    Inference("encoder", feed, steps=N_INF)],
                **where)
            plan = sess.plan()
            res = sess.run(plan=plan, sequential=True, max_wall_s=300)
            assert res.ok, {k: c.error for k, c in
                            res.run.components.items()}
            out[name] = (plan, res)
    return dict(out=out, snaps=snaps, jcfg=jcfg, coords=coords)


def test_dispatches_match_stats_and_each_other(sessions):
    (jplan, jres), (tplan, tres) = (sessions["out"]["jax"],
                                    sessions["out"]["torch"])
    jstats, tstats = jres.server.stats(), tres.server.stats()
    assert jstats["op_count"] == jplan.store_dispatches
    assert tstats["op_count"] == tplan.store_dispatches
    assert tplan.store_dispatches == jplan.store_dispatches \
        == 1 + (EPOCHS + 1)          # one capture + epochs + bootstrap
    for jc, tc in zip(jplan.components, tplan.components):
        assert (tc.name, tc.tier, tc.dispatches) \
            == (jc.name, jc.tier, jc.dispatches)
    for name in ("producer", "trainer", "inference"):
        assert tres.op_delta(name) == jres.op_delta(name)
    assert tstats["watermarks"] == jstats["watermarks"]
    jst, tst = jres.server.checkout("field"), tres.server.checkout("field")
    np.testing.assert_array_equal(tst.slab.numpy(), np.asarray(jst.slab))
    np.testing.assert_array_equal(tst.keys.numpy(),
                                  np.asarray(jst.keys).astype(np.int64))
    np.testing.assert_array_equal(tst.version.numpy(),
                                  np.asarray(jst.version))


def test_epoch_losses_track_the_reference(sessions, record_property):
    """Also records, as junit properties, the largest relative difference
    seen (``max_rel_epoch_deviation``) and the reference trainer's
    compile time (``reference_jit_compile_s``), the bulk of this file's
    cost."""
    jres, tres = sessions["out"]["jax"][1], sessions["out"]["torch"][1]
    jhist = jres.output("trainer").history
    thist = tres.output("trainer").history
    assert len(thist) == len(jhist) == EPOCHS
    worst = 0.0
    for j, t in zip(jhist, thist):
        assert t.watermark == j.watermark
        for field in ("train_loss", "val_loss", "val_rel_error"):
            want, got = getattr(j, field), getattr(t, field)
            assert np.isfinite(got)
            assert abs(got - want) <= LOSS_RTOL * abs(want), \
                (j.epoch, field, got, want)
            worst = max(worst, abs(got - want) / abs(want))
    record_property("max_rel_epoch_deviation", worst)
    record_property("reference_jit_compile_s",
                    jres.run.timers.total("jit_compile"))
    jmu, jsd = jres.output("trainer").norm_stats
    tmu, tsd = tres.output("trainer").norm_stats
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-5)
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), rtol=1e-5)


def test_inference_matches_reference_encoder(sessions):
    """The port's registry path (feed of one [N, C] element, batch axis
    added by ``run_model``) against the reference's encoder run with the
    port's trained weights on the same standardised snapshot."""
    tres = sessions["out"]["torch"][1]
    out = tres.output("inference")
    trainer = tres.output("trainer")
    jcfg = sessions["jcfg"]
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          trainer.state.params)
    levels = jae.coords_pyramid(jcfg, jnp.asarray(sessions["coords"]))
    encode = jax.jit(lambda p, x: jae.encode(p, jcfg, levels, x))
    mu, sd = (np.asarray(t) for t in trainer.norm_stats)
    assert out.steps == len(out.outputs) == N_INF
    for step, z in enumerate(out.outputs):
        x = (sessions["snaps"][STEPS + step].T[None] - mu) / sd
        want = np.asarray(encode(params, jnp.asarray(x)))
        assert z.shape == (jcfg.latent,)
        np.testing.assert_allclose(z.numpy(), want[0], rtol=INF_TOL,
                                   atol=INF_TOL)
    assert torch.equal(out.last, out.outputs[-1])


def test_launcher_runs_on_the_cpu():
    res = tlaunch.run(epochs=1, sim_steps=8, points="small", gather=2,
                      verbose=False, device="cpu")
    stats = res.server.stats()
    assert stats["op_count"] == res.plan.store_dispatches == 1 + 2
    inf = res.output("inference")
    assert inf.steps == 5 and inf.last.shape == (16,)
    assert bool(torch.isfinite(inf.last).all())


def _turbulence_noise(key) -> "torch.Tensor":
    """The reference's draw inside ``spectral.random_turbulence(ncfg,
    key)`` at the launcher's 16³ grid."""
    kr, ki = jax.random.split(key)
    shape = (3, 16, 16, 9)
    return torch.from_numpy(np.asarray(
        jax.random.normal(kr, shape)
        + 1j * jax.random.normal(ki, shape)).astype(np.complex64))


@pytest.mark.parametrize("producers", [1, 2])
def test_make_producer_takes_ncfg(producers):
    """``make_producer(producer="spectral", ncfg=...)`` declares the
    spectral producer (one ``random_turbulence`` start a rank, stacked for
    several); then the launchers' spectral sessions at the smoke grid, in
    both packages from the same weights, solver starts and trainer
    draws: plan == ``stats()`` in each, the predictions equal across
    them, every epoch's losses within 1e-3 relative."""
    from repro.launch import insitu as jlaunch
    ncfg = tlaunch.sp.NSConfig(n=16, nu=0.02, dt=0.01, forcing=True)
    fcfg = tlaunch.fp.FlatPlateConfig(nx=8, ny=8, nz=4)
    prod = tlaunch.make_producer(
        sim_steps=4, producer="spectral", fcfg=fcfg, ncfg=ncfg,
        send_every=2, compute_s=0.0, seed=0, producers=producers,
        device="cpu")
    assert isinstance(prod, TProducer) and prod.ranks == producers
    assert isinstance(prod.carry, tlaunch.sp.NSState)
    assert prod.carry.uhat.shape == ((producers,) if producers > 1
                                     else ()) + (3, 16, 16, 9)
    _, key, snap = prod.step_fn(
        tlaunch.tree_map(lambda x: x[0], prod.carry) if producers > 1
        else prod.carry, 0, 0)
    assert snap.shape == (4, fcfg.n_points)

    epochs, steps, seed = 2, 8, 0
    # the launcher's autoencoder at the small grid
    lcfg = jae.AEConfig(n_points=fcfg.n_points, latent=16, mlp_width=16,
                        mode="ref")
    params = np_autoencoder_params(lcfg, seed=3)
    key = jax.random.key(seed)
    noise = iter([_turbulence_noise(key)] if producers == 1 else
                 [_turbulence_noise(jax.random.fold_in(key, r))
                  for r in range(producers)])
    nvalid = producers * JS.capture_emit_count(steps, 2)
    jcfg = jtr.TrainerConfig(ae=lcfg, epochs=epochs, gather=6)

    def jinit(cfg, _key, tx):
        p = jax.tree.map(jnp.asarray, params)
        return jtr.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))

    def tinit(cfg, _gen, tx, device=None):
        return ttr.train_state_from_numpy(params, device=device)

    kw = dict(epochs=epochs, sim_steps=steps, points="small",
              producer="spectral", producers=producers, latent=16,
              verbose=False, seed=seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "init_state", jinit)
        mp.setattr(ttr, "init_state", tinit)
        mp.setattr(ttr, "default_draws",
                   lambda cfg, device: _reference_draws(jcfg, nvalid))
        mp.setattr(tlaunch.sp, "draw_noise",
                   lambda cfg, gen, device=None: next(noise).to(device))
        jres = jlaunch.run(**kw)
        tres = tlaunch.run(device="cpu", **kw)
    assert jres.ok and tres.ok
    assert jres.server.stats()["op_count"] == jres.plan.store_dispatches
    assert tres.server.stats()["op_count"] == tres.plan.store_dispatches
    for jc, tc in zip(jres.plan.components, tres.plan.components,
                      strict=True):
        assert (tc.name, tc.tier, tc.ranks, tc.dispatches) \
            == (jc.name, jc.tier, jc.ranks, jc.dispatches)
    jhist = jres.output("trainer").history
    thist = tres.output("trainer").history
    assert len(thist) == len(jhist) == epochs
    for j, t in zip(jhist, thist):
        assert t.watermark == j.watermark == nvalid
        for field in ("train_loss", "val_loss", "val_rel_error"):
            want, got = getattr(j, field), getattr(t, field)
            assert abs(got - want) <= LOSS_RTOL * abs(want), \
                (j.epoch, field, got, want)


# ---------------------------------------------------------------------------
# The plan's tiers and predictions across the tier grid (no model runs on
# the reference side: plan() is host logic in both packages)
# ---------------------------------------------------------------------------

_GRID = {
    "fused": dict(ranks=1, traceable=True, fused=True, inf=None, chunk=None),
    "per_verb": dict(ranks=1, traceable=False, fused=False,
                     inf="three_step", chunk=None),
    "multi": dict(ranks=3, traceable=True, fused=True, inf=None, chunk=5),
    "multi_per_verb": dict(ranks=2, traceable=False, fused=True,
                           inf="three_step", chunk=None),
}
_TINY = dict(n_points=64, channels=4, internal=4, latent=4, blocks=2,
             pool=4, mlp_width=8, mlp_depth=2)


def _grid_session(pkg, case, steps=13, epochs=2, n_inf=2):
    """One grid cell's declaration in ``pkg`` ("jax" or "torch")."""
    g = _GRID[case]
    if pkg == "jax":
        from repro.ml.autoencoder import AEConfig
        Session, Spec, Producer, Trainer, Inference, tr_mod = (
            JSession, JTableSpec, JProducer, JTrainer, JInference, jtr)
        zeros, where = jnp.zeros, {}
    else:
        from repro_torch.ml.autoencoder import AEConfig
        Session, Spec, Producer, Trainer, Inference, tr_mod = (
            TSession, TTableSpec, TProducer, TTrainer, TInference, ttr)
        zeros, where = torch.zeros, {"device": "cpu"}
    cfg = tr_mod.TrainerConfig(ae=AEConfig(**_TINY), epochs=epochs,
                               gather=3, batch_size=2, lr=1e-3,
                               fused=g["fused"])
    carry = zeros(()) if g["ranks"] == 1 else zeros((g["ranks"],))
    return Session(
        tables=[Spec("field", shape=(4, 64), capacity=6)],
        components=[
            Producer(_grid_step, table="field", steps=steps,
                     ranks=g["ranks"], carry=carry, emit_every=2,
                     traceable=g["traceable"], chunk=g["chunk"]),
            Trainer(cfg, _grid_coords(pkg), model_key="encoder"),
            Inference("encoder", _grid_feed, steps=n_inf, tier=g["inf"])],
        **where)


def _grid_coords(pkg):
    coords = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    return jnp.asarray(coords) if pkg == "jax" else torch.as_tensor(coords)


def _grid_step(carry, rank, t):
    """Port producer step for the grid runs (the reference's plan never
    calls it)."""
    value = torch.arange(256.0).reshape(4, 64) * (t + 1) / 256 + rank
    return carry, TS.make_key(rank, t), value


def _grid_feed(client, step):
    mu, sd = client.get_metadata("norm_stats")
    return (torch.ones(64, 4) * step - mu) / sd


@pytest.mark.parametrize("case", sorted(_GRID))
def test_plan_grid_matches_reference(case):
    """Tiers, chunks, bucketing and every predicted dispatch, component by
    component, EQUAL across the packages."""
    jplan, tplan = (_grid_session(pkg, case).plan()
                    for pkg in ("jax", "torch"))
    assert tplan.store_dispatches == jplan.store_dispatches
    for jc, tc in zip(jplan.components, tplan.components, strict=True):
        assert (tc.name, tc.kind, tc.tier, tc.ranks, tc.steps, tc.chunk,
                tc.bucketed, tc.dispatches) == \
            (jc.name, jc.kind, jc.tier, jc.ranks, jc.steps, jc.chunk,
             jc.bucketed, jc.dispatches)
    assert tplan.describe().splitlines()[1:] == \
        jplan.describe().splitlines()[1:]


@pytest.mark.parametrize("case", sorted(_GRID))
def test_port_grid_runs_as_planned(case):
    """Each grid cell runs sequentially in the port (a tiny autoencoder):
    ``stats()`` and every component's op delta equal the plan."""
    sess = _grid_session("torch", case)
    plan = sess.plan()
    res = sess.run(plan=plan, sequential=True, max_wall_s=120)
    assert res.ok, {k: c.error for k, c in res.run.components.items()}
    assert res.server.stats()["op_count"] == plan.store_dispatches
    for c in plan.components:
        assert res.op_delta(c.name) == c.store_dispatches, c.name
    inf = res.output("inference")
    assert inf.steps == 2 and inf.last.shape == (4,)
    assert res.output("producer").steps == 13
