"""Port parity for the spectral producer and the other A8 leftovers.

* ``repro_torch.sim.spectral`` against ``repro.sim.spectral`` at n = 16
  on the same inputs (the reference's own initial states, and its own
  ``jax.random`` noise fed to ``random_turbulence``): ``_rhs`` and one RK4
  ``step`` within 1e-5 of max|·|, ten forced steps within 1e-4, the
  snapshot, energy, enstrophy and divergence after them, both
  Taylor-Green starts and ``partition_snapshot`` (exact).  FFTs round
  differently in pocketfft and XLA's, so the limits are relative to the
  field's largest entry.
* The reference's own spectral tests (``tests/test_sim.py``) applied to
  the port at their own limits, the divergence-free one at 1e-10.
* ``flatplate.snapshot_batch``: exactly ``n`` single snapshots, and
  within 1e-5 of max|·| of the reference's ``snapshot_batch`` on its own
  modes (float32 phases of up to ~150 rad round apart).
* The ``configs/quadconv_ae`` twin, field for field.
* ``store.sample_and_step`` against the reference's
  ``sample_and_step_impl`` with the reference's draws passed in: values,
  carry, aux and ``ok`` exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import uniforms_for_ranks
from repro.configs import quadconv_ae as jqae
from repro.core import store as JS
from repro.sim import flatplate as jfp
from repro.sim import spectral as jsp


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file."""
    global torch, tsp, tfp, tqae, TS
    import torch
    from repro_torch.configs import quadconv_ae as tqae
    from repro_torch.core import store as TS
    from repro_torch.sim import flatplate as tfp
    from repro_torch.sim import spectral as tsp
    torch.set_num_threads(1)


N = 16
FORCED = dict(n=N, nu=0.02, dt=0.01, forcing=True)   # the launcher's
STEP_RTOL, STEPS_RTOL = 1e-5, 1e-4
_jrhs = jax.jit(jsp._rhs, static_argnums=0)


def _close(got, want, rtol: float) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, rtol * scale)
    return err / scale


def _reference_noise(n: int, key) -> np.ndarray:
    """``random_turbulence``'s draw inside the reference."""
    kr, ki = jax.random.split(key)
    shape = (3, n, n, n // 2 + 1)
    return np.asarray(jax.random.normal(kr, shape)
                      + 1j * jax.random.normal(ki, shape)).astype(np.complex64)


def _tstate(cfg, uhat: np.ndarray, t: float = 0.0, step: int = 0):
    return tsp.NSState(torch.from_numpy(np.array(uhat)),
                       torch.tensor(t, dtype=torch.float32),
                       torch.tensor(step, dtype=torch.int32))


def _jstate(uhat: np.ndarray, t: float = 0.0, step: int = 0):
    """A fresh reference state (``jsp.step`` donates its input)."""
    return jsp.NSState(jnp.asarray(np.array(uhat)), jnp.float32(t),
                       jnp.int32(step))


@pytest.fixture(scope="module")
def turbulence():
    """The launcher's forced box from the reference's own start and the
    port's from the same noise, then ten steps in each package."""
    jcfg, tcfg = jsp.NSConfig(**FORCED), tsp.NSConfig(**FORCED)
    key = jax.random.key(0)
    j0 = jsp.random_turbulence(jcfg, key)
    t0 = tsp.random_turbulence(tcfg, torch.from_numpy(
        _reference_noise(N, key)))
    u0 = np.array(j0.uhat)
    js, ts = _jstate(u0), _tstate(tcfg, u0)
    for _ in range(10):
        js = jsp.step(jcfg, js)
        ts = tsp.step(tcfg, ts)
    return dict(jcfg=jcfg, tcfg=tcfg, j0=j0, t0=t0, u0=u0, js=js, ts=ts)


def test_random_turbulence_from_the_reference_noise(turbulence):
    _close(turbulence["t0"].uhat, turbulence["u0"], STEP_RTOL)
    e = float(tsp.energy(turbulence["tcfg"], turbulence["t0"]))
    assert abs(e - 0.5) < 1e-5
    assert turbulence["t0"].uhat.dtype == torch.complex64


def test_rhs_and_one_step(turbulence):
    jcfg, tcfg, u0 = turbulence["jcfg"], turbulence["tcfg"], turbulence["u0"]
    _close(tsp._rhs(tcfg, torch.from_numpy(u0.copy())),
           _jrhs(jcfg, jnp.asarray(u0)), STEP_RTOL)
    state = _tstate(tcfg, u0)
    got = tsp.step(tcfg, state)
    want = jsp.step(jcfg, _jstate(u0))
    _close(got.uhat, want.uhat, STEP_RTOL)
    # a new state: the input is left as it was
    assert torch.equal(state.uhat, torch.from_numpy(u0))
    assert float(got.t) == pytest.approx(float(want.t))
    assert int(got.step) == int(want.step) == 1


def test_ten_forced_steps_and_diagnostics(turbulence):
    jcfg, tcfg, js, ts = (turbulence[k] for k in ("jcfg", "tcfg", "js",
                                                   "ts"))
    _close(ts.uhat, js.uhat, STEPS_RTOL)
    assert int(ts.step) == int(js.step) == 10
    _close(tsp.snapshot(tcfg, ts), jsp.snapshot(jcfg, js), STEPS_RTOL)
    for name in ("energy", "enstrophy"):
        got = float(getattr(tsp, name)(tcfg, ts))
        want = float(getattr(jsp, name)(jcfg, js))
        assert abs(got - want) <= STEPS_RTOL * abs(want), (name, got, want)
    # both at float32's floor for a turbulent field
    assert float(tsp.max_divergence(tcfg, ts)) < 1e-6
    assert float(jsp.max_divergence(jcfg, js)) < 1e-6


@pytest.mark.parametrize("start", ["taylor_green", "taylor_green_2d"])
def test_taylor_green_starts(start):
    jcfg, tcfg = jsp.NSConfig(n=N), tsp.NSConfig(n=N)
    got = getattr(tsp, start)(tcfg, device="cpu")
    want = getattr(jsp, start)(jcfg)
    _close(got.uhat, want.uhat, STEP_RTOL)
    assert float(got.t) == 0.0 and int(got.step) == 0
    _close(tsp.snapshot(tcfg, got), jsp.snapshot(jcfg, want), STEP_RTOL)


def test_partition_snapshot_exact(turbulence):
    snap = tsp.snapshot(turbulence["tcfg"], turbulence["ts"])
    for ranks in (1, 4, 8):
        got = tsp.partition_snapshot(snap, ranks)
        want = jsp.partition_snapshot(jnp.asarray(snap.numpy()), ranks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="divisible"):
        tsp.partition_snapshot(snap, 3)


# -- the reference's own tests (tests/test_sim.py) on the port --------------

REF_CFG = dict(n=16, nu=0.05, dt=0.01)


def test_ref_tgv2d_exact_decay():
    cfg = tsp.NSConfig(**REF_CFG)
    state = tsp.taylor_green_2d(cfg, device="cpu")
    e0 = float(tsp.energy(cfg, state))
    for _ in range(20):
        state = tsp.step(cfg, state)
    e = float(tsp.energy(cfg, state))
    expected = e0 * math.exp(-4 * cfg.nu * float(state.t))
    assert abs(e - expected) / expected < 1e-5


def test_ref_divergence_free():
    cfg = tsp.NSConfig(**REF_CFG)
    state = tsp.taylor_green(cfg, device="cpu")
    for _ in range(10):
        state = tsp.step(cfg, state)
    assert float(tsp.max_divergence(cfg, state)) < 1e-10


def test_ref_energy_monotone_decay_unforced():
    cfg = tsp.NSConfig(**REF_CFG)
    state = tsp.taylor_green(cfg, device="cpu")
    es = [float(tsp.energy(cfg, state))]
    for _ in range(8):
        state = tsp.step(cfg, state)
        es.append(float(tsp.energy(cfg, state)))
    assert all(a >= b for a, b in zip(es, es[1:]))


def test_ref_forcing_sustains_energy():
    cfg = tsp.NSConfig(n=16, nu=0.02, dt=0.01, forcing=True, f_amp=0.15)
    state = tsp.random_turbulence(
        cfg, tsp.draw_noise(cfg, torch.Generator().manual_seed(0), "cpu"),
        e0=0.3)
    e0 = float(tsp.energy(cfg, state))
    for _ in range(30):
        state = tsp.step(cfg, state)
    assert float(tsp.energy(cfg, state)) > 0.2 * e0


def test_ref_snapshot_shape_finite_and_gauge():
    cfg = tsp.NSConfig(**REF_CFG)
    snap = tsp.snapshot(cfg, tsp.taylor_green(cfg, device="cpu"))
    assert snap.shape == (4, cfg.n_points)
    assert bool(torch.isfinite(snap).all())
    assert abs(float(snap[0].mean())) < 1e-6
    parts = tsp.partition_snapshot(snap, 8)
    assert parts.shape == (8, 4, cfg.n_points // 8)
    assert torch.equal(parts.permute(1, 0, 2).reshape(4, -1), snap)


# -- flat-plate batches, the quadconv_ae twin, sample_and_step --------------

FLATPLATE_RTOL = 1e-5


def _jax_modes(fcfg, key):
    """The reference's draws inside ``flatplate.snapshot``, as port
    modes."""
    km = jax.random.split(key, 4)
    kvec = jax.random.normal(km[0], (fcfg.n_modes, 3)) \
        * jnp.array([4.0, 8.0, 4.0])
    phase0 = jax.random.uniform(km[1], (fcfg.n_modes,), maxval=2 * jnp.pi)
    raw = jax.random.normal(km[2], (fcfg.n_modes, 3))
    return tfp.Modes(*(torch.as_tensor(np.array(a)) for a in
                       (kvec, phase0, raw)))


@pytest.mark.parametrize("grid,step0,n", [((4, 4, 2), 0, 3),
                                          ((8, 8, 4), 5, 9)])
def test_flatplate_snapshot_batch(grid, step0, n):
    fcfg = tfp.FlatPlateConfig(*grid)
    key = jax.random.key(2)
    modes = _jax_modes(fcfg, key)
    got = tfp.snapshot_batch(fcfg, modes, step0, n)
    assert got.shape == (n, 4, fcfg.n_points)
    singles = torch.stack([tfp.snapshot(fcfg, modes, step0 + i)
                           for i in range(n)])
    assert torch.equal(got, singles)
    want = jfp.snapshot_batch(jfp.FlatPlateConfig(*grid), key, step0, n)
    # phases k·x reach ~150 rad, where one float32 ulp is 1.5e-5: the two
    # packages' dot products round them apart (measured 1.4e-6 of max)
    _close(got, want, FLATPLATE_RTOL)


@pytest.mark.parametrize("name", ["config", "grid_config", "smoke_config",
                                  "smoke_grid_config"])
def test_quadconv_ae_twin(name):
    got = dataclasses.asdict(getattr(tqae, name)())
    want = dataclasses.asdict(getattr(jqae, name)())
    assert got == want


def _step(carry, values):
    """One exact microstep: a row added to the carry, the last row
    doubled as aux."""
    return carry + values[0], values[-1] * 2


@pytest.mark.parametrize("version", [[0, 3, 0, 5, 1, 0, 2, 0],
                                     [0, 0, 0, 0, 0, 0, 0, 0]])
def test_sample_and_step_matches_reference(version):
    version = np.array(version, np.int32)
    rng = np.random.default_rng(5)
    cap, n = len(version), 6
    slab = rng.standard_normal((cap, 2, 3)).astype(np.float32)
    keys = rng.integers(0, 2**31, cap).astype(np.uint32)
    carry = rng.standard_normal((2, 3)).astype(np.float32)
    jspec = JS.TableSpec("t", shape=(2, 3), capacity=cap)
    tspec = TS.TableSpec("t", shape=(2, 3), capacity=cap)
    jst = JS.TableState(jnp.asarray(slab), jnp.asarray(keys),
                        jnp.asarray(version), jnp.int32(0),
                        jnp.int32(int((version > 0).sum())))
    tst = TS.TableState(torch.as_tensor(slab),
                        torch.as_tensor(keys.astype(np.int64)),
                        torch.as_tensor(version), torch.tensor(0),
                        torch.tensor(int((version > 0).sum())))
    key = jax.random.key(9)
    jc, jaux, jok = JS.sample_and_step(jspec, jst, key, n, _step,
                                       jnp.asarray(carry), "ref")
    nvalid = max(int((version > 0).sum()), 1)
    ranks = jax.random.randint(key, (n,), 0, jnp.int32(nvalid))
    draw = torch.as_tensor(uniforms_for_ranks(ranks, nvalid))
    tc, taux, tok = TS.sample_and_step(tspec, tst, draw, n, _step,
                                       torch.as_tensor(carry))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    assert bool(tok) == bool(jok) == bool(version.any())
    with pytest.raises(ValueError, match="draw"):
        TS.sample_and_step(tspec, tst, draw[:2], n, _step,
                           torch.as_tensor(carry))
