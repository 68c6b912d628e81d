"""Port parity for the domain-decomposed finite-difference solver and its
halo exchange (``repro_torch.sim.distributed``, ``repro_torch.sim.halo``).

* ``pad_reference`` equals the reference's EXACTLY at widths 1 and 2,
  periodic and every wall mode, along either dim; the port's
  ``halo_exchange`` over D = 1, 2 and 4 ranks on ``"cpu"`` gives each rank
  exactly its slice of the reference's padded array (the reference's own
  halo-vs-global parity, ``tests/test_sim.py``); ``halo_exchange_nd`` on
  a 2 x 2 grid fills the corners like two global paddings; both
  packages raise the same errors.
* The 2- and 4-rank port step against the reference's UNSHARDED
  ``make_step(cfg)`` at n = 16 and 32 with 8 sweeps, from the same start:
  1e-6 after 10 steps, 1e-5 after 20 steps at 4 shards (the reference's
  own limits, ``tests/test_sim.py:266-311``), for Taylor-Green and for
  decaying turbulence fed the reference's own noise; the port's sharded
  and unsharded steps are bit-identical.
* ``taylor_green_factor``, ``energy``, ``snapshot`` and
  ``max_divergence`` against the reference's; the discrete Taylor-Green
  decay at the reference's limit; ``validate_shards`` raising on n = 9
  with the reference's message; ``make_producer``'s surface.

Torch runs on one thread; each reference function is jitted once per
shape (the module-scoped ``_ref_step`` cache).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.sim import distributed as jfd
from repro.sim import halo as jhl


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection (every xdist worker collects every test file)."""
    global torch, fd, hl, C, space_mesh, ElemShards
    import torch
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import ElemShards, space_mesh
    from repro_torch.sim import distributed as fd
    from repro_torch.sim import halo as hl
    torch.set_num_threads(1)


_STEPS: dict = {}


def _ref_step(n: int, iters: int):
    """The reference's unsharded step, jitted once per config."""
    key = (n, iters)
    if key not in _STEPS:
        _STEPS[key] = jfd.make_step(jfd.FDConfig(n=n, jacobi_iters=iters))
    return _STEPS[key]


def _mesh(d: int):
    return space_mesh(d, devices=["cpu"] * d)


def _to_port(state) -> "fd.FDState":
    return fd.FDState(torch.from_numpy(np.array(state.u)),
                      torch.from_numpy(np.array(state.v)),
                      torch.tensor(float(state.t)),
                      torch.tensor(int(state.step), dtype=torch.int32))


def _noise(n: int, seed: int = 1) -> np.ndarray:
    """The reference's own decaying-turbulence draw."""
    return np.array(jax.random.normal(jax.random.key(seed), (n, n)))


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

_X = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)


@pytest.mark.parametrize("boundary,wall", [("periodic", "zero")]
                         + [("wall", w) for w in ("zero", "reflect",
                                                  "reflect_neg")])
@pytest.mark.parametrize("width", [1, 2])
def test_pad_reference_and_halo_match_reference(boundary, wall, width):
    for dim in (0, 1):
        want = np.asarray(jhl.pad_reference(
            jnp.asarray(_X), width=width, dim=dim, boundary=boundary,
            wall=wall))
        got = hl.pad_reference(torch.from_numpy(_X.copy()), width=width,
                               dim=dim, boundary=boundary, wall=wall)
        np.testing.assert_array_equal(got.numpy(), want)
        for d in (1, 2, 4):
            blocks = list(torch.from_numpy(_X.copy()).chunk(d, dim=dim))
            C.reset_counts()
            out = hl.halo_exchange(blocks, _mesh(d), width=width, dim=dim,
                                   boundary=boundary, wall=wall)
            assert C.COUNTS["collective_permute"] == 2
            assert C.COUNTS["all_gather"] == C.COUNTS["all_reduce"] == 0
            rows = _X.shape[dim] // d
            for r, o in enumerate(out):
                np.testing.assert_array_equal(
                    o.numpy(), np.take(want, range(r * rows,
                                                   (r + 1) * rows + 2 * width),
                                       axis=dim))


@pytest.mark.parametrize("boundary", ["periodic", "wall"])
def test_halo_exchange_nd_fills_corners(boundary):
    """A 2 x 2 grid of [8, 4] blocks exchanged along dims 0 then 1 equals
    the reference's two global paddings, corners included."""
    kw = dict(width=2, boundary=boundary, wall="reflect")
    want = np.asarray(jhl.pad_reference(jhl.pad_reference(
        jnp.asarray(_X), dim=0, **kw), dim=1, **kw))
    x = torch.from_numpy(_X.copy())
    grid = [list(row.chunk(2, dim=1)) for row in x.chunk(2, dim=0)]
    out = hl.halo_exchange_nd(grid, axes=(("space", 0), ("y", 1)), **kw)
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                out[i][j].numpy(), want[i * 8:i * 8 + 12, j * 4:j * 4 + 8])


@pytest.mark.parametrize("kwargs", [dict(width=0), dict(width=17),
                                    dict(boundary="open"),
                                    dict(boundary="wall", wall="slip")],
                         ids=["width0", "too_wide", "boundary", "wall"])
def test_check_errors_match_reference(kwargs):
    with pytest.raises(ValueError) as ref:
        jhl.pad_reference(jnp.asarray(_X), **kwargs)
    with pytest.raises(ValueError) as got:
        hl.pad_reference(torch.from_numpy(_X.copy()), **kwargs)
    assert str(got.value) == str(ref.value)
    if kwargs.get("width") == 17:
        with pytest.raises(ValueError, match="exceeds the local block"):
            hl.halo_exchange(list(torch.zeros(16, 4).chunk(4)), _mesh(4),
                             width=5)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["taylor_green", "decaying_turbulence"])
@pytest.mark.parametrize("n,shards,steps,atol",
                         [(16, 2, 10, 1e-6), (32, 2, 10, 1e-6),
                          (32, 4, 20, 1e-5)])
def test_sharded_step_matches_unsharded_reference(init, n, shards, steps,
                                                  atol):
    jcfg = jfd.FDConfig(n=n, jacobi_iters=8)
    cfg = fd.FDConfig(n=n, jacobi_iters=8)
    a = jfd.taylor_green(jcfg) if init == "taylor_green" \
        else jfd.decaying_turbulence(jcfg, jax.random.key(1))
    whole = _to_port(a)
    b = fd.shard_state(whole, _mesh(shards))
    step, sharded, ref = fd.make_step(cfg), fd.make_step(cfg, _mesh(shards)), \
        _ref_step(n, 8)
    for _ in range(steps):
        a, b, whole = ref(a), sharded(b), step(whole)
    got = fd.unshard_state(b)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(a.u), atol=atol)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(a.v), atol=atol)
    assert torch.equal(got.u, whole.u) and torch.equal(got.v, whole.v)
    assert int(got.step) == int(a.step) == steps
    assert float(got.t) == pytest.approx(float(a.t), rel=1e-6)


@pytest.mark.parametrize("n", [16, 32])
def test_initial_conditions_match_reference(n):
    jcfg, cfg = jfd.FDConfig(n=n), fd.FDConfig(n=n)
    tg, jtg = fd.taylor_green(cfg, "cpu"), jfd.taylor_green(jcfg)
    np.testing.assert_allclose(tg.u.numpy(), np.asarray(jtg.u), atol=1e-6)
    np.testing.assert_allclose(tg.v.numpy(), np.asarray(jtg.v), atol=1e-6)
    dt = fd.decaying_turbulence(cfg, torch.from_numpy(_noise(n)))
    jdt = jfd.decaying_turbulence(jcfg, jax.random.key(1))
    scale = float(np.abs(np.asarray(jdt.u)).max())
    np.testing.assert_allclose(dt.u.numpy(), np.asarray(jdt.u),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(dt.v.numpy(), np.asarray(jdt.v),
                               atol=1e-5 * scale)
    assert float(fd.energy(dt)) == pytest.approx(0.5, abs=1e-4)
    assert float(fd.max_divergence(cfg, dt)) < 1e-5


def test_diagnostics_match_reference():
    jcfg = jfd.FDConfig(n=32, nu=0.01, dt=2e-3, jacobi_iters=8)
    cfg = fd.FDConfig(n=32, nu=0.01, dt=2e-3, jacobi_iters=8)
    assert fd.taylor_green_factor(cfg) == jfd.taylor_green_factor(jcfg)
    a = jfd.decaying_turbulence(jcfg, jax.random.key(2))
    for _ in range(3):
        a = _ref_step(32, 8)(a)
    mine = fd.shard_state(_to_port(a), _mesh(2))
    assert float(fd.energy(mine)) == pytest.approx(float(jfd.energy(a)),
                                                   rel=1e-6)
    np.testing.assert_array_equal(fd.snapshot(mine).numpy(),
                                  np.asarray(jfd.snapshot(a)))
    assert float(fd.max_divergence(cfg, mine)) == pytest.approx(
        float(jfd.max_divergence(jcfg, a)), rel=1e-4, abs=1e-7)


def test_taylor_green_discrete_decay():
    """The reference's analytic anchor on the port's 2-rank step: the
    energy decays by (1 - 2 nu dt lambda_h)^2 a step within 1e-4."""
    cfg = fd.FDConfig(n=32, nu=0.01, dt=2e-3, jacobi_iters=64)
    step = fd.make_step(cfg, _mesh(2))
    s = fd.shard_state(fd.taylor_green(cfg, "cpu"), _mesh(2))
    e0, g = float(fd.energy(s)), fd.taylor_green_factor(cfg)
    for _ in range(10):
        s = step(s)
    pred = e0 * g ** 20
    assert abs(float(fd.energy(s)) - pred) / pred < 1e-4
    assert float(fd.max_divergence(cfg, s)) < 1e-5


def test_validate_shards_matches_reference():
    with pytest.raises(ValueError) as ref:
        jfd.FDConfig(n=9).validate_shards(2)
    with pytest.raises(ValueError) as got:
        fd.FDConfig(n=9).validate_shards(2)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="do not divide"):
        fd.make_step(fd.FDConfig(n=9), _mesh(2))
    with pytest.raises(ValueError, match="n must be >= 4"):
        fd.FDConfig(n=3)


def test_make_producer_surface():
    cfg = fd.FDConfig(n=16, jacobi_iters=4)
    step_fn, s0, es = fd.make_producer(cfg, device="cpu")
    assert es is None
    s1, key, value = step_fn(s0, 0, 0)
    assert value.shape == (2, 16, 16) and int(s1.step) == 1
    step_fn, s0, es = fd.make_producer(cfg, _mesh(2),
                                       init="decaying_turbulence",
                                       noise=torch.from_numpy(_noise(16)))
    assert es.spec == (None, "space", None) and es.dim == 1
    _, _, value = step_fn(s0, 0, 3)
    assert isinstance(value, ElemShards)
    assert [tuple(b.shape) for b in value.blocks] == [(2, 8, 16)] * 2
    with pytest.raises(ValueError, match="unknown init"):
        fd.make_producer(cfg, init="laminar", device="cpu")
    with pytest.raises(ValueError, match="sharded over its mesh"):
        fd.make_step(cfg, _mesh(2))(fd.taylor_green(cfg, "cpu"))
