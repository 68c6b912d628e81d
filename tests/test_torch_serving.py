"""Port parity for the slice as a whole: the store-backed serving plane.

One serving session on each side — 2 clients × 3 requests of flat-plate
snapshots [4, 256], ``max_batch`` 4, the QuadConv encoder at the smoke
config with the same numpy-seeded weights — on both tiers.  The port's
snapshots are evaluated from the reference's own mode draws.  Responses
must agree within 1e-4 (fp32 encoder, as in ``test_torch_quadconv.py``);
the plan's dispatches, drained batches and swaps must equal ``stats()``
and be EQUAL across the two packages.  Local deployment only.

Then the serving settings on an elementwise model, where both packages
must agree bit for bit: ``order_seed`` (arrival order), ``reload_every``
(hot-swap cadence), ``wait_timeout_s``, the client's retry wrapper, and
the threaded ``run()``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_autoencoder_params, torch_ae_config
from repro.configs.quadconv_ae import smoke_config, smoke_grid_config
from repro.core import Client as JClient
from repro.core import StoreServer as JServer
from repro.core import TableSpec as JTableSpec
from repro.core import faults as jfaults
from repro.insitu import InSituSession as JSession
from repro.insitu import ServingClients as JClients
from repro.insitu import ServingConsumer as JConsumer
from repro.ml import autoencoder as jae
from repro.serve.engine import ServeLoop as JServeLoop
from repro.sim import flatplate as jfp


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TClient, TServer, TTableSpec, tfaults, TS, TSession, TClients
    global TConsumer, tae, TServeLoop, request_key, submitted_meta, tfp
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.core import faults as tfaults
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import ServingClients as TClients
    from repro_torch.insitu import ServingConsumer as TConsumer
    from repro_torch.ml import autoencoder as tae
    from repro_torch.serve.engine import ServeLoop as TServeLoop
    from repro_torch.serve.engine import request_key, submitted_meta
    from repro_torch.sim import flatplate as tfp
    # tiny shapes: one core, leaving the rest to the other test workers
    torch.set_num_threads(1)
    PACKAGES["torch"] = dict(
        session=TSession, spec=TTableSpec, clients=TClients,
        consumer=TConsumer, server=TServer, client=TClient, loop=TServeLoop,
        faults=tfaults, kw={"device": "cpu"},
        full=lambda v: torch.full(SMALL, v), scalar=torch.tensor)


CLIENTS, REQUESTS, MAX_BATCH = 2, 3, 4
TOL = 1e-4


def _jax_modes(fcfg, key) -> "tfp.Modes":
    """The reference's draws inside ``flatplate.snapshot``, as port modes."""
    km = jax.random.split(key, 4)
    kvec = jax.random.normal(km[0], (fcfg.n_modes, 3)) \
        * jnp.array([4.0, 8.0, 4.0])
    phase0 = jax.random.uniform(km[1], (fcfg.n_modes,), maxval=2 * jnp.pi)
    raw = jax.random.normal(km[2], (fcfg.n_modes, 3))
    return tfp.Modes(*(torch.as_tensor(np.array(a)) for a in
                       (kvec, phase0, raw)))


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = smoke_config()
    tcfg = torch_ae_config(jcfg)
    fcfg = smoke_grid_config()
    assert fcfg.n_points == jcfg.n_points
    key = jax.random.key(7)
    modes = _jax_modes(fcfg, key)
    jparams = np_autoencoder_params(jcfg, seed=3)
    jlevels = jae.coords_pyramid(jcfg, jfp.grid_coords(fcfg))
    tcoords = tfp.grid_coords(fcfg, "cpu")
    tlevels = tae.coords_pyramid(tcfg, tcoords)

    def jfeed(c, s):
        return jfp.snapshot(fcfg, key, 10 * c + s)

    def tfeed(c, s):
        return tfp.snapshot(fcfg, modes, 10 * c + s, tcoords)

    def jmodel(p, x):
        return jae.encode(p, jcfg, jlevels, x.T[None])[0]

    def tmodel(p, xs):
        return tae.encode(p, tcfg, tlevels, xs.transpose(1, 2))

    tparams = tae.params_from_numpy(jparams, "cpu")
    return dict(jcfg=jcfg, fcfg=fcfg, jfeed=jfeed, tfeed=tfeed,
                jmodel=jmodel, tmodel=tmodel, jparams=jparams,
                tparams=tparams, tcoords=tcoords)


def _components(pkg_clients, pkg_consumer, feed, tier):
    return [pkg_clients(feed, table="sreq", clients=CLIENTS,
                        requests=REQUESTS, collect=False, name="writers"),
            pkg_consumer("m", table="sreq", results="sres", clients=CLIENTS,
                         requests=REQUESTS, max_batch=MAX_BATCH, tier=tier),
            pkg_clients(feed, table="sreq", clients=CLIENTS,
                        requests=REQUESTS, submit=False, name="readers")]


def _run(session, model, params):
    plan = session.plan()
    res = session.run(plan=plan, sequential=True, max_wall_s=120,
                      preload=lambda srv: srv.set_model("m", model, params))
    assert res.ok, {k: v.error for k, v in res.run.components.items()}
    stats = res.server.stats()
    serving = res.output("serving")
    assert stats["op_count"] == plan.store_dispatches
    assert stats["model_swaps"] == plan.model_swaps == serving.swaps
    assert serving.batches == \
        dict(plan.component("serving").dispatches).get("serve", 0)
    counts = (plan.store_dispatches, plan.model_swaps, serving.batches,
              stats["op_count"], stats["model_swaps"])
    return res.output("readers").responses, counts


def test_flatplate_snapshot_from_reference_draws(slice_setup):
    s = slice_setup
    np.testing.assert_allclose(s["tcoords"].numpy(),
                               np.asarray(jfp.grid_coords(s["fcfg"])),
                               rtol=1e-6, atol=1e-6)
    for c, step in ((0, 0), (1, 12)):
        np.testing.assert_allclose(s["tfeed"](c, step).numpy(),
                                   np.asarray(s["jfeed"](c, step)),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tier", ["continuous_batch", "three_step"])
def test_serving_session_matches_reference(slice_setup, tier):
    s = slice_setup
    j_tables = [JTableSpec("sreq", shape=(4, s["fcfg"].n_points),
                           capacity=8),
                JTableSpec("sres", shape=(s["jcfg"].latent,), capacity=8)]
    t_tables = [TTableSpec("sreq", shape=(4, s["fcfg"].n_points),
                           capacity=8),
                TTableSpec("sres", shape=(s["jcfg"].latent,), capacity=8)]
    j_resp, j_counts = _run(
        JSession(tables=j_tables, components=_components(
            JClients, JConsumer, s["jfeed"], tier)),
        s["jmodel"], s["jparams"])
    t_resp, t_counts = _run(
        TSession(tables=t_tables, device="cpu", components=_components(
            TClients, TConsumer, s["tfeed"], tier)),
        s["tmodel"], s["tparams"])
    assert t_counts == j_counts
    assert sorted(t_resp) == sorted(j_resp) and len(t_resp) == 6
    for k in j_resp:
        assert t_resp[k].shape == (s["jcfg"].latent,)
        np.testing.assert_allclose(t_resp[k].numpy(), np.asarray(j_resp[k]),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the serving settings, on a tiny elementwise model: exact on both sides
# ---------------------------------------------------------------------------

SMALL = (2, 4)
PACKAGES = {
    "jax": dict(session=JSession, spec=JTableSpec, clients=JClients,
                consumer=JConsumer, server=JServer, client=JClient,
                loop=JServeLoop, faults=jfaults, kw={},
                full=lambda v: jnp.full(SMALL, v), scalar=jnp.asarray),
}   # the "torch" entry is added by setup_module


def _affine(p, x):
    # elementwise: the reference's per-request model and the port's
    # batched one are the same function
    return p * x + 1.0


def _small_session(pkg, feed, *, clients, requests, order_seed=None,
                   wait_timeout_s=None, readers=True):
    k = PACKAGES[pkg]
    spec = k["spec"]
    components = [
        k["clients"](feed, table="req", clients=clients, requests=requests,
                     collect=False, order_seed=order_seed, name="writers"),
        k["consumer"]("m", table="req", results="res", clients=clients,
                      requests=requests, max_batch=4,
                      wait_timeout_s=wait_timeout_s)]
    if readers:
        components.append(k["clients"](feed, table="req", clients=clients,
                                       requests=requests, submit=False,
                                       name="readers"))
    return k["session"](tables=[spec("req", shape=SMALL, capacity=12),
                                spec("res", shape=SMALL, capacity=12)],
                        components=components, **k["kw"])


@pytest.mark.parametrize("order_seed", [None, 3])
def test_arrival_order_matches_reference(order_seed):
    """``order_seed`` shuffles which client submits next: both packages
    submit in the same order, drain ceil(12 / 4) batches and answer every
    request with the same bits."""
    got = {}
    for pkg, k in PACKAGES.items():
        arrivals = []

        def feed(c, s, k=k, arrivals=arrivals):
            arrivals.append((c, s))
            return k["full"](float(100 * c + s))

        res = _small_session(pkg, feed, clients=3, requests=4,
                             order_seed=order_seed).run(
            sequential=True, max_wall_s=60,
            preload=lambda srv, k=k: srv.set_model("m", _affine,
                                                   k["scalar"](2.0)))
        assert res.ok, {n: c.error for n, c in res.run.components.items()}
        got[pkg] = (arrivals, res.output("serving").batches,
                    {key: np.asarray(v) for key, v in
                     res.output("readers").responses.items()})
    (j_arr, j_batches, j_resp), (t_arr, t_batches, t_resp) = \
        got["jax"], got["torch"]
    assert t_arr[:12] == j_arr[:12]
    client_major = [(c, s) for s in range(4) for c in range(3)]
    assert (t_arr[:12] == client_major) == (order_seed is None)
    assert t_batches == j_batches == 3
    assert sorted(t_resp) == sorted(j_resp) and len(t_resp) == 12
    for key in j_resp:
        np.testing.assert_array_equal(t_resp[key], j_resp[key])
        np.testing.assert_array_equal(t_resp[key],
                                      2.0 * (100 * key[0] + key[1]) + 1.0)


def test_threaded_session_answers_every_request():
    """``run()`` defaults to one host thread per component: every request
    is answered once; the batches drained depend on arrival timing, every
    other dispatch is the plan's."""
    sess = _small_session(
        "torch", lambda c, s: torch.full(SMALL, float(100 * c + s)),
        clients=3, requests=4)
    plan = sess.plan()
    res = sess.run(plan=plan, max_wall_s=60, preload=lambda srv: srv.set_model(
        "m", _affine, torch.tensor(2.0)))
    assert res.ok, {n: c.error for n, c in res.run.components.items()}
    batches = res.output("serving").batches
    assert 3 <= batches <= 12
    assert res.server.stats()["op_count"] == \
        plan.store_dispatches - 3 + batches
    responses = res.output("readers").responses
    assert sorted(responses) == [(c, s) for c in range(3) for s in range(4)]
    for (c, s), v in responses.items():
        np.testing.assert_array_equal(
            v.numpy(), np.full(SMALL, 2.0 * (100 * c + s) + 1.0))


@pytest.mark.parametrize("reload_every", [1, 4])
def test_hot_swap_cadence_matches_reference(reload_every):
    """One request per batch and a new generation published after each:
    ``reload_every`` decides which generation answers which request, and
    the adoptions counted, in both packages alike."""
    got = {}
    for pkg, k in PACKAGES.items():
        server = k["server"](**k["kw"])
        for name in ("req", "res"):
            server.create_table(k["spec"](name, shape=SMALL, capacity=8))
        client = k["client"](server)
        server.set_model("m", _affine, k["scalar"](2.0))
        loop = k["loop"](client, model_key="m", request_table="req",
                         response_table="res", clients=1, requests=4,
                         max_batch=1, reload_every=reload_every)
        loop.wait_model(timeout=30.0)
        for s in range(4):
            client.put_kv("req", request_key(0, s), k["full"](float(s)))
            server.put_meta(submitted_meta("req", 0), s + 1)
            assert loop.step()
            server.set_model("m", _affine, k["scalar"](float(10 + s)))
        responses = [np.asarray(client.get_kv("res", request_key(0, s))[0])
                     for s in range(4)]
        got[pkg] = (loop.swaps, server.stats()["model_swaps"],
                    server.model_version("m"), responses)
    swaps = {1: 4, 4: 1}[reload_every]
    assert got["torch"][:3] == got["jax"][:3] == (swaps, swaps, 5)
    for s, (t, j) in enumerate(zip(got["torch"][3], got["jax"][3])):
        np.testing.assert_array_equal(t, j)
        scale = 2.0 if reload_every == 4 or s == 0 else 10.0 + s - 1
        np.testing.assert_array_equal(t, np.full(SMALL, scale * s + 1.0))


def test_wait_timeout_bounds_the_model_wait():
    """With no model ever published, ``wait_timeout_s`` — not the
    session's wall budget — ends the consumer's wait, as a typed
    ``StoreTimeout`` in both packages."""
    for pkg, k in PACKAGES.items():
        t0 = time.perf_counter()
        res = _small_session(
            pkg, lambda c, s, k=k: k["full"](float(s)), clients=1,
            requests=2, wait_timeout_s=0.05, readers=False).run(
            sequential=True, max_wall_s=60)
        assert time.perf_counter() - t0 < 30, pkg
        serving = res.run.components["serving"]
        assert serving.error_type == "StoreTimeout", (pkg, serving.error)
        assert "'m' timed out after 0.05s" in serving.error


def test_retry_wrapper_matches_reference():
    """The client's retry wrapper: the same seeded, jittered sleep
    schedule as the reference's; transient failures absorbed up to the
    policy's bound; anything else raised at once."""
    policy = dict(max_attempts=4, interval=1e-4, max_interval=2e-4,
                  jitter=0.5, seed=11)
    assert list(tfaults.RetryPolicy(**policy).sleeps()) == \
        list(jfaults.RetryPolicy(**policy).sleeps())
    for pkg, k in PACKAGES.items():
        f = k["faults"]
        calls, retries = [], []

        def flaky(f=f, calls=calls):
            calls.append(1)
            if len(calls) < 3:
                raise f.TransferDropped("dropped")
            return "served"

        assert f.call_with_retry(flaky, f.RetryPolicy(**policy),
                                 lambda: retries.append(1)) == "served"
        assert (len(calls), len(retries)) == (3, 2), pkg

        def down(f=f):
            raise f.StoreUnavailable("down")

        with pytest.raises(f.StoreUnavailable):
            f.call_with_retry(down, f.RetryPolicy(**policy))

        def timeout(f=f, calls=calls):
            calls.append(1)
            raise f.StoreTimeout("model", "m", 0.1)

        calls.clear()
        with pytest.raises(f.StoreTimeout):
            f.call_with_retry(timeout, f.RetryPolicy(**policy))
        assert len(calls) == 1, pkg


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, an entry point asked for no device raises instead of
    running on the CPU; ``device="cpu"`` is the explicit opt-in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TTableSpec("t", shape=(2,), capacity=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.init_table(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tae.init_autoencoder(tae.AEConfig(n_points=16),
                             torch.Generator().manual_seed(0))
    assert TS.init_table(spec, device="cpu").slab.device.type == "cpu"
